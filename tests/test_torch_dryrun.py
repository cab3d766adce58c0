"""rio_tpu_torch.entry.dryrun_multichip against __graft_entry__.dryrun_multichip.

The port's dryrun asserts the reference's bounds itself (f and g within
1e-4 of the single-device solve, row mismatch <= 2%, the hierarchical and
phase-2 bounds, transport-cost ratio <= 1.12); here it runs over 8 and 4
CPU shards. The phase-2 sharded solve is then run by both packages on the
same numpy inputs, JAX's on conftest's virtual CPU devices: seats agree on
at least 99% of the rows.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rio_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from rio_tpu.parallel.hierarchical import sharded_hierarchical_assign as jax_sharded  # noqa: E402

from rio_tpu_torch import entry  # noqa: E402
from rio_tpu_torch.parallel import make_mesh  # noqa: E402
from rio_tpu_torch.parallel.hierarchical import sharded_hierarchical_assign  # noqa: E402

ROW_AGREEMENT = 0.99


@pytest.mark.parametrize("n_devices", [8, 4])
def test_dryrun_multichip_meets_the_reference_bounds(n_devices, capsys):
    out = entry.dryrun_multichip(n_devices, device="cpu")
    rows, cols = (4, 2) if n_devices == 8 else (2, 2)
    assert out["mesh"] == {"obj": rows, "node": cols}
    assert out["f_max_abs"] <= 1e-4 and out["g_max_abs"] <= 1e-4
    assert out["row_mismatch"] <= 0.02
    p2 = out["phase2"]
    assert p2["mech_flips"] <= 0.01 and p2["coarse_mismatch"] <= 0.12
    assert 1.0 <= p2["cost_ratio"] <= 1.12
    assert f"(ratio {p2['cost_ratio']:.4f})" in capsys.readouterr().out


@pytest.mark.parametrize("n_devices", [8, 4])
def test_phase2_sharded_solve_matches_jax(n_devices):
    inp = entry.phase2_inputs(n_devices)
    kw = dict(n_groups=inp["n_groups"], coarse_iters=16, fine_iters=16)
    args = [inp[k] for k in ("obj_feat", "node_feat", "cap", "alive")]
    ours = sharded_hierarchical_assign(
        make_mesh(["cpu"] * n_devices), *(torch.from_numpy(a) for a in args), **kw
    ).assignment.numpy()
    theirs = np.asarray(jax_sharded(jax_make_mesh(jax.devices()[:n_devices]), *args, **kw).assignment)
    assert ours.shape == theirs.shape == (1024 * n_devices,)
    assert np.mean(ours == theirs) >= ROW_AGREEMENT
    assert not np.any(ours == inp["dead"])


def test_dryrun_without_a_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.dryrun_multichip(8)
