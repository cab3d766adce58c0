"""rio_tpu_torch.bench.hier_mesh_ab against bench.py's mesh x chunk A/B, on the CPU.

The port's tier runs at a small N with ``device="cpu"``: 32,768 rows x 64
nodes, 8 groups, 8 shards of 2,048-row cells (2 a shard) against 16,384-row
chunks (2). Beside it, the reference's two solvers
(``mesh_chunked_hierarchical_assign_timed`` on conftest's 8-device CPU mesh
and ``chunked_hierarchical_assign_timed``) run on the reference's own
inputs, drawn from ``PRNGKey(18)`` as ``bench.py``'s child draws them. Each
arm is held to the parity rules of ``tests/test_torch_mesh_hierarchical.py``
(group and node counts and overflow equal, ``coarse_g`` within 1e-3, at
least 99% of rows on the same node), and the key set to the reference's
banked capture (``BENCH_DETAIL.cpu.json["hier_mesh_ab"]``).

Both arms must have no overflow and a transport-cost ratio within 5% of 1,
as the reference's capture at 2,097,152 rows has (1.0122). The ratio
drifts from 1 as cells hold fewer rows a node: at 1,024-row cells over 64
nodes (16 rows a node) both packages read 1.068; here (32 a node) both
read 1.039, and the port's ratio must equal the reference's.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rio_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from rio_tpu.parallel.hierarchical import chunked_hierarchical_assign_timed as jax_chunked  # noqa: E402
from rio_tpu.parallel.hierarchical import (  # noqa: E402
    mesh_chunked_hierarchical_assign_timed as jax_mesh_chunked,
)

from rio_tpu_torch import bench as port  # noqa: E402
from tests.test_torch_mesh_hierarchical import _parity  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
N_OBJ, M, G, D = 32_768, 64, 8, 16
SHARDS, CELL, CHUNK = 8, 2_048, 16_384
RATIO_SLACK = 0.05
TOL_RATIO = 1e-5  # float32 sums over the 32,768 sampled rows, in two orders


@pytest.fixture(scope="module")
def both():
    keep: dict = {}
    got = port.hier_mesh_ab(N_OBJ, device="cpu", n_nodes=M, n_groups=G, cell_rows=CELL,
                            chunk_rows=CHUNK, keep=keep)
    k1, k2 = jax.random.split(jax.random.PRNGKey(18))
    obj = jax.random.normal(k1, (N_OBJ, D), jnp.float32)
    node = jax.random.normal(k2, (D, M), jnp.float32) * 0.2
    cap, alive = jnp.ones((M,), jnp.float32), jnp.ones((M,), jnp.float32)
    mesh = jax_make_mesh(jax.devices()[:SHARDS])
    ref = {
        "mesh_chunk": jax_mesh_chunked(mesh, obj, node, cap, alive, n_groups=G,
                                       n_chunks=N_OBJ // (SHARDS * CELL))[0],
        "chunked_only": jax_chunked(obj, node, cap, alive, n_groups=G, n_chunks=N_OBJ // CHUNK)[0],
    }
    # bench.py's sampled transport cost, on the reference's assignments.
    idx = np.arange(0, N_OBJ, max(1, N_OBJ // 65_536))[:65_536]
    on_s = np.asarray(obj[idx] @ node)
    best = on_s.max(axis=1)
    rows = np.arange(len(idx))
    costs = {arm: float(np.mean(best - on_s[rows, np.asarray(r.assignment)[idx]]))
             for arm, r in ref.items()}
    return got, keep, ref, costs


def _banked():
    return json.loads((ROOT / "BENCH_DETAIL.cpu.json").read_text())["hier_mesh_ab"]


def test_the_key_set_is_the_reference_captures(both):
    got, _, _, _ = both
    want = _banked()
    assert set(got) == set(want)
    for arm in ("mesh_chunk", "chunked_only"):
        assert set(got[arm]) == set(want[arm])
    assert set(got["transport_cost"]) == set(want["transport_cost"])
    assert set(want["host"]) <= set(got["host"])
    assert (got["host"]["platform"], got["host"]["device"]) == ("cpu", "cpu")


def test_the_shape_fields_are_the_arguments(both):
    got, _, _, _ = both
    assert (got["n_obj"], got["n_nodes"], got["n_groups"], got["devices"], got["cell_rows"]) == \
        (N_OBJ, M, G, SHARDS, CELL)
    assert got["mesh_chunk"]["n_chunks"] == N_OBJ // (SHARDS * CELL) == 2
    assert got["chunked_only"]["n_chunks"] == N_OBJ // CHUNK == 2
    for arm in ("mesh_chunk", "chunked_only"):
        stats = got[arm]
        assert len(stats["chunk_ms"]) == stats["n_chunks"]
        assert stats["first_chunk_ms"] == stats["chunk_ms"][0]
        assert stats["steady_chunk_ms"] == float(np.median(stats["chunk_ms"][1:]))
        assert stats["wall_s"] > 0 and stats["rate"] == pytest.approx(N_OBJ / stats["wall_s"])


@pytest.mark.parametrize("arm", ["mesh_chunk", "chunked_only"])
def test_each_arm_matches_the_references_solver(both, arm):
    got, keep, ref, _ = both
    _parity(ref[arm], keep[arm], G, M)
    assert got[arm]["overflow"] == int(ref[arm].overflow) == 0


def test_the_transport_cost_is_the_references_and_near_one(both):
    got, _, _, costs = both
    tc = got["transport_cost"]
    for arm in ("mesh_chunk", "chunked_only"):
        assert tc[arm] == pytest.approx(costs[arm], abs=TOL_RATIO)
    assert tc["ratio"] == pytest.approx(costs["mesh_chunk"] / costs["chunked_only"], abs=TOL_RATIO)
    assert abs(tc["ratio"] - 1.0) <= RATIO_SLACK


def test_sizes_that_do_not_split_raise():
    with pytest.raises(ValueError, match="split"):
        port.hier_mesh_ab(8192 + 1024, device="cpu", n_nodes=M, n_groups=G, cell_rows=1024,
                          chunk_rows=4096)


def test_the_tier_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        port.hier_mesh_ab(8192, n_nodes=M, n_groups=G, cell_rows=1024, chunk_rows=4096)


def test_main_hier_mesh_ab_runs_the_ab_alone(monkeypatch, capsys, tmp_path):
    """``--hier --mesh-ab`` runs only the A/B, prints its line, no headline."""
    small = port.hier_mesh_ab

    def tier(device=None):
        return small(8192, device=device, n_nodes=M, n_groups=G, cell_rows=1024, chunk_rows=4096)

    monkeypatch.setattr(port, "hier_mesh_ab", tier)
    monkeypatch.setattr(port, "resolve_device", lambda device: torch.device("cpu"))
    out = tmp_path / "ab.json"
    result = port.main(["--hier", "--mesh-ab", "--out", str(out)])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert [ln["tier"] for ln in lines] == ["hier_mesh_ab"]
    assert set(result) == set(_banked())
    assert set(json.loads(out.read_text())) == {"hier_mesh_ab"}
