"""TorchObjectPlacement(mesh=...) against JaxObjectPlacement(mesh=make_mesh()).

The mesh scenarios of ``tests/test_jax_placement.py`` and
``tests/test_solver_telemetry.py`` run on both providers through
``run_both``: JAX over conftest's 8 virtual CPU devices, the port over
``make_mesh(["cpu"] * 8)``. Each records ``snap_hier``: mode strings,
``chunks`` and ``devices`` equal, seats agreeing on at least 99% of the
objects (the dense sharded solves reduce in another order than XLA's
collectives, and the two-level cells round from float32 potentials).
"""

import asyncio

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rio_tpu.object_placement import jax_placement  # noqa: E402

from rio_tpu_torch.object_placement import torch_placement  # noqa: E402
from rio_tpu_torch.object_placement.torch_placement import TorchObjectPlacement  # noqa: E402
from rio_tpu_torch.parallel import make_mesh  # noqa: E402

from .torch_placement_parity import TORCH_API, members, run_both, seats, snap_hier  # noqa: E402


def _patch_both(monkeypatch, name, value):
    monkeypatch.setattr(jax_placement, name, value)
    monkeypatch.setattr(torch_placement, name, value)


def _addresses(n, prefix):
    return [f"{prefix}.{i}:70" for i in range(n)]


async def _flat_mesh(api, n_obj, n_nodes, prefix, **kw):
    """A provider on the 8-shard mesh with ``n_obj`` objects, rebalanced once."""
    p = api.make(n_iters=10, mesh=api.mesh(), **kw)
    addrs = _addresses(n_nodes, prefix)
    p.sync_members(addrs)
    ids = [api.ObjectId("MeshT", str(i)) for i in range(n_obj)]
    await p.assign_batch(ids)
    await p.rebalance()
    assert all(a in addrs for a in await p.lookup_batch(ids))
    return p


@pytest.mark.parametrize(
    "threshold,mode", [(64, "sinkhorn+hier_at_scale"), (1024, "sinkhorn")], ids=["routed", "dense"]
)
def test_mesh_flat_rebalance_routes_by_per_shard_rows(monkeypatch, threshold, mode):
    """700 objects pad to 1,024 rows, 128 a shard: above 64 they route to the
    sharded hierarchical solve, under 1,024 they keep the dense sharded one."""
    _patch_both(monkeypatch, "_FLAT_REBALANCE_MAX_ROWS", threshold)

    async def scenario(api):
        p = await _flat_mesh(api, 700, 6, "10.41.0", mode="sinkhorn")
        assert p.stats.mode == mode
        return [snap_hier(p)]

    rec, _ = run_both(scenario)
    assert rec[0]["devices"] == (8 if mode.endswith("hier_at_scale") else 0)


def test_flat_rebalance_at_scale_composes_with_mesh(monkeypatch):
    _patch_both(monkeypatch, "_FLAT_REBALANCE_MAX_ROWS", 256)
    _patch_both(monkeypatch, "_HIER_CHUNK_ROWS", 64)

    async def scenario(api):
        p = await _flat_mesh(api, 3000, 6, "10.35.0", mode="sinkhorn")
        assert p.stats.mode == "sinkhorn+hier_at_scale+mesh_chunk"
        assert p.stats.devices == 8 and p.stats.chunks > 1
        assert len(p.stats.chunk_ms) == p.stats.chunks
        return [snap_hier(p)]

    run_both(scenario)


@pytest.mark.parametrize("mode", ["sinkhorn", "scaling"])
def test_mesh_sharded_solve_records_convergence(mode):
    """The dense sharded solve: no class collapse on a mesh, cold (warm ratio
    0) and no residual (-1), as the reference's sharded solvers report."""

    async def scenario(api):
        p = await _flat_mesh(api, 700, 6, "10.8.1", mode=mode)
        s = p.stats
        assert s.mode == mode and s.solver_iters == 10
        assert s.residual == -1.0 and s.warm_ratio == 0.0
        return [snap_hier(p)]

    run_both(scenario)


def test_mesh_dense_churn_keeps_quotas():
    """Kill a node under the dense sharded solve: both providers empty it and
    seat the survivors at the same integer quotas."""

    async def scenario(api):
        p = api.make(mode="sinkhorn", n_iters=10, node_axis_size=8, mesh=api.mesh())
        p.sync_members(members(8, prefix="10.42.0"))
        await p.assign_batch([api.ObjectId("Churn", str(i)) for i in range(1000)])
        await p.rebalance(delta=False)
        first = snap_hier(p)
        p.sync_members(members(8, dead={5}, prefix="10.42.0"))
        await p.rebalance(delta=False)
        assert "10.42.0.5:5000" not in set(snap_hier(p)["seats"].values())
        return [first, snap_hier(p)]

    run_both(scenario)


async def _seeded_hier(api, n_obj, **kw):
    p = api.make(mode="hierarchical", n_iters=8, mesh=api.mesh(), **kw)
    p.sync_members(members(12, prefix="10.8.0"))
    await p.assign_batch([api.ObjectId("WarmT", str(i)) for i in range(n_obj)])
    await p.rebalance(delta=False)
    return p


def test_mesh_hierarchical_second_solve_warm_starts():
    async def scenario(api):
        p = await _seeded_hier(api, 3000)
        first = p.stats
        assert first.mode == "hierarchical" and first.warm_ratio <= 0.0
        rec = [snap_hier(p)]
        await p.rebalance(delta=False)
        second = p.stats
        assert second.mode == "hierarchical" and second.warm_ratio > 0.0
        assert second.solver_iters == 16
        return rec + [snap_hier(p)]

    run_both(scenario)


def test_mesh_chunked_composed_solve_records_chunk_telemetry(monkeypatch):
    """``+mesh_chunk``, the chunk and device counts, one wall time per slab,
    and the history gauges. The reference also asserts that the first
    chunk is the slowest, because it carries the one-time compile; eager
    PyTorch compiles nothing (``compile_ms`` reads -1), so that ordering
    does not hold here and is not asserted."""
    _patch_both(monkeypatch, "_HIER_CHUNK_ROWS", 64)

    async def scenario(api):
        p = await _seeded_hier(api, 3000)
        s = p.stats
        assert s.mode == "hierarchical+mesh_chunk"
        assert s.chunks > 1 and s.devices == 8
        assert len(s.chunk_ms) == s.chunks and all(ms > 0.0 for ms in s.chunk_ms)
        g = s.history_gauges()
        assert g["rio.placement_solve.history.chunks_last"] == float(s.chunks)
        assert g["rio.placement_solve.history.chunks_max"] >= float(s.chunks)
        assert g["rio.placement_solve.history.devices_last"] == 8.0
        assert g["rio.placement_solve.history.first_chunk_ms_last"] == s.chunk_ms[0]
        assert g["rio.placement_solve.history.first_chunk_ms_max"] >= s.chunk_ms[0]
        return [snap_hier(p)]

    run_both(scenario)


def test_mesh_hierarchical_delta_after_a_death(monkeypatch):
    """A death after a mesh x chunk solve: the delta path (single-device in
    both providers) moves exactly the displaced objects."""
    _patch_both(monkeypatch, "_HIER_CHUNK_ROWS", 64)

    async def scenario(api):
        p = await _seeded_hier(api, 2000)
        rec = [snap_hier(p)]
        p.sync_members(members(12, dead={4}, prefix="10.8.0"))
        await p.rebalance()
        assert p.stats.mode == "hierarchical+delta"
        return rec + [snap_hier(p, delta=True)]

    run_both(scenario)


@pytest.mark.parametrize("obj_axis", [None, 1], ids=["4x2", "1x8"])
def test_mesh_shapes_agree(monkeypatch, obj_axis):
    """Another factorization of the 8 devices: the same rows per shard in
    JAX's row-major order over ("obj", "node"), so the same seats."""
    _patch_both(monkeypatch, "_HIER_CHUNK_ROWS", 128)

    async def scenario(api):
        kw = {} if obj_axis is None else {"obj_axis": obj_axis}
        p = api.make(mode="hierarchical", n_iters=8, mesh=api.mesh(8, **kw))
        p.sync_members(members(16, prefix="10.43.0"))
        await p.assign_batch([api.ObjectId("Shape", str(i)) for i in range(2500)])
        await p.rebalance(delta=False)
        assert p.stats.mode == "hierarchical+mesh_chunk" and p.stats.chunks == 4
        return [snap_hier(p)]

    run_both(scenario)


def test_one_shard_mesh_equals_no_mesh(monkeypatch):
    """A 1-shard mesh runs ``"hierarchical+mesh_chunk"`` in as many chunks as
    the single-device solve, on the same cells: equal seats."""
    monkeypatch.setattr(torch_placement, "_HIER_CHUNK_ROWS", 1024)
    ids = [TORCH_API.ObjectId("One", str(i)) for i in range(1500)]

    async def seated(**kw):
        p = TORCH_API.make(mode="hierarchical", n_iters=8, **kw)
        p.sync_members(members(12, prefix="10.44.0"))
        await p.assign_batch(ids)
        await p.rebalance(delta=False)
        return p

    meshed = asyncio.run(seated(mesh=make_mesh(["cpu"])))
    plain = asyncio.run(seated())
    assert meshed.stats.mode == "hierarchical+mesh_chunk" and meshed.stats.devices == 1
    assert plain.stats.mode == "hierarchical" and plain.stats.devices == 1
    assert meshed.stats.chunks == plain.stats.chunks == 2
    assert seats(meshed) == seats(plain)


def test_provider_device_follows_the_mesh():
    p = TorchObjectPlacement(mesh=make_mesh(["cpu"] * 8))
    assert p.device == torch.device("cpu")
    with pytest.raises(ValueError, match="mesh's type"):
        TorchObjectPlacement(mesh=make_mesh(["cpu"] * 8), device="meta")


def test_make_mesh_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()


def test_mesh_dense_rebalance_seats_integer_quotas():
    """The dense mesh branch rounds from the whole cost: its seats are
    integer quotas of the live capacity."""

    async def scenario():
        p = TORCH_API.make(mode="sinkhorn", n_iters=10, node_axis_size=8, mesh=TORCH_API.mesh())
        p.sync_members(members(8, dead={2}, prefix="10.45.0"))
        await p.assign_batch([TORCH_API.ObjectId("Q", str(i)) for i in range(700)])
        await p.rebalance(delta=False)
        return np.bincount(list(p._placements.values()), minlength=8)

    counts = asyncio.run(scenario())
    assert counts[2] == 0
    assert counts.sum() == 700 and counts.max() - counts[counts > 0].min() <= 1
