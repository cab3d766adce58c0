"""rio_tpu_torch.parallel's flat sharded solves against rio_tpu.parallel's.

The same numpy inputs go through the JAX function on conftest's virtual
CPU devices and through the port on ``make_mesh(["cpu"] * n)``, on the
mesh shapes (4, 2), (2, 4), (8, 1) and (1, 1). Potentials are held to
rtol/atol ``POT_TOL`` (the dryrun's 1e-4, ``__graft_entry__.py:188-193``)
against JAX's sharded solve and the port's single-device solve in float32;
a bfloat16 kernel is held to ``BF16_TOL`` and to the assignment agreement
of ``tests/test_scaling_sinkhorn.py:110-120``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rio_tpu import parallel as jpar  # noqa: E402

from rio_tpu_torch import parallel as tpar  # noqa: E402
from rio_tpu_torch.ops import scaling_sinkhorn, sinkhorn  # noqa: E402
from rio_tpu_torch.ops.sinkhorn import plan_rounded_assign, sinkhorn_assign  # noqa: E402
from rio_tpu_torch.parallel import mesh as M  # noqa: E402

POT_TOL = 1e-4
BF16_TOL = 2e-3
BF16_ROW_AGREEMENT = 0.9

# (n_devices, obj_axis): the mesh shapes (4, 2), (2, 4), (8, 1), (1, 1).
SHAPES = [(8, None), (8, 2), (8, 8), (1, None)]
SHAPE_IDS = ["4x2", "2x4", "8x1", "1x1"]


def _meshes(n, obj_axis):
    kw = {} if obj_axis is None else {"obj_axis": obj_axis}
    return jpar.make_mesh(jax.devices()[:n], **kw), tpar.make_mesh(["cpu"] * n, **kw)


def _problem(seed, n, m, dead_nodes=0, padded_rows=0):
    """tests/test_scaling_sinkhorn.py's problem shape, from a numpy seed."""
    rng = np.random.default_rng(seed)
    cost = rng.random((n, m), dtype=np.float32)
    mass = rng.random(n, dtype=np.float32) + 0.1
    cap = rng.random(m, dtype=np.float32) + 0.5
    if padded_rows:
        mass[-padded_rows:] = 0.0
    cap[:dead_nodes] = 0.0
    return cost, mass, cap


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert np.array_equal(np.isneginf(got), np.isneginf(want)), what
    live = ~np.isneginf(want)
    np.testing.assert_allclose(got[live], want[live], rtol=tol, atol=tol, err_msg=what)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ------------------------------------------------------------------ the mesh


@pytest.mark.parametrize(
    "n,obj_axis,shape",
    [(8, None, (4, 2)), (7, None, (7, 1)), (8, 2, (2, 4)), (8, 8, (8, 1)), (1, None, (1, 1)), (4, None, (2, 2))],
)
def test_make_mesh_factorizations_match_jax(n, obj_axis, shape):
    mj, mt = _meshes(n, obj_axis)
    assert tuple(mj.devices.shape) == tuple(mt.devices.shape) == shape
    assert mt.axis_names == tuple(mj.axis_names) == ("obj", "node")
    assert mt.shape == dict(mj.shape) and mt.devices.size == n
    assert all(d == torch.device("cpu") for d in mt.devices.flat)
    assert not mt.distributed and mt.local_cells == sorted(np.ndindex(shape))


def test_make_mesh_rejects_an_obj_axis_that_does_not_divide():
    with pytest.raises(ValueError, match="does not divide"):
        tpar.make_mesh(["cpu"] * 8, obj_axis=3)


@pytest.mark.parametrize("axis,mesh_axis", [(1, "node"), (0, "obj")])
def test_dist_lse_matches_logsumexp(axis, mesh_axis):
    mesh = tpar.make_mesh(["cpu"] * 8)
    rng = np.random.default_rng(3)
    z = torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32) * 20)
    z[5] = float("-inf")  # a row with every entry -inf (the isfinite guard)
    z[:, 7] = float("-inf")
    parts = tpar._dist_lse(mesh, M.shard(mesh, z, M.COST_SPEC), axis, mesh_axis)
    spec = "obj" if axis == 1 else "node"
    got = M.concat(mesh, parts, spec)
    want = torch.logsumexp(z, dim=axis)
    # An all -inf slice keeps base 0 and a clamped sum: log(1e-30), as in JAX.
    dead = torch.isneginf(want)
    assert dead.any() and torch.equal(got[dead], torch.full_like(got[dead], float(np.log(np.float32(1e-30)))))
    assert torch.allclose(got[~dead], want[~dead], rtol=1e-6, atol=1e-5)


def test_shard_cost_blocks_are_views_of_the_cost():
    mesh = tpar.make_mesh(["cpu"] * 8)
    cost = torch.rand(64, 32)
    sc = tpar.shard_cost(mesh, cost)
    assert sc.shape == (64, 32) and len(sc.blocks) == 8
    assert all(b.untyped_storage().data_ptr() == cost.untyped_storage().data_ptr()
               for b in sc.blocks.values())
    assert torch.equal(sc.blocks[(2, 1)], cost[32:48, 16:32])
    assert torch.equal(sc.gather(), cost)


# ----------------------------------------------------- the sharded solvers


@pytest.mark.parametrize("n,obj_axis", SHAPES, ids=SHAPE_IDS)
def test_sharded_sinkhorn_matches_jax_and_single_device(n, obj_axis):
    mj, mt = _meshes(n, obj_axis)
    cost, mass, cap = _problem(11, 128, 64, dead_nodes=2, padded_rows=8)
    fj, gj = jpar.sharded_sinkhorn(mj, jpar.shard_cost(mj, jnp.asarray(cost)), mass, cap,
                                   eps=0.05, n_iters=40)
    ft, gt = tpar.sharded_sinkhorn(mt, tpar.shard_cost(mt, torch.from_numpy(cost)),
                                   *_t(mass, cap), eps=0.05, n_iters=40)
    single = sinkhorn(*_t(cost, mass, cap), eps=0.05, n_iters=40)
    for got, want, what in ((ft, fj, "f vs jax"), (gt, gj, "g vs jax"),
                            (ft, single.f, "f vs single"), (gt, single.g, "g vs single")):
        _close(got, want, POT_TOL, what)


@pytest.mark.parametrize("n,obj_axis", SHAPES, ids=SHAPE_IDS)
def test_sharded_scaling_float32_matches_jax_and_single_device(n, obj_axis):
    mj, mt = _meshes(n, obj_axis)
    cost, mass, cap = _problem(6, 128, 64, dead_nodes=2)
    fj, gj = jpar.sharded_scaling_sinkhorn(mj, jpar.shard_cost(mj, jnp.asarray(cost)), mass, cap,
                                           eps=0.07, n_iters=25, kernel_dtype=jnp.float32)
    ft, gt = tpar.sharded_scaling_sinkhorn(mt, tpar.shard_cost(mt, torch.from_numpy(cost)),
                                           *_t(mass, cap), eps=0.07, n_iters=25,
                                           kernel_dtype=torch.float32)
    single = scaling_sinkhorn(*_t(cost, mass, cap), eps=0.07, n_iters=25, kernel_dtype=torch.float32)
    for got, want, what in ((ft, fj, "f vs jax"), (gt, gj, "g vs jax"),
                            (ft, single.f, "f vs single"), (gt, single.g, "g vs single")):
        _close(got, want, POT_TOL, what)


@pytest.mark.parametrize("n,obj_axis", SHAPES, ids=SHAPE_IDS)
def test_sharded_scaling_offset_costs_f_parity(n, obj_axis):
    """``tests/test_scaling_sinkhorn.py:72-84``: a cost whose minimum is below
    zero; the row shift must fold back into f. Against the log-domain
    ``sinkhorn`` within that test's 1e-3, and JAX's sharded solve within 1e-4."""
    mj, mt = _meshes(n, obj_axis)
    cost, mass, cap = _problem(8, 64, 96)
    cost = cost - 0.9
    fj, gj = jpar.sharded_scaling_sinkhorn(mj, jnp.asarray(cost), mass, cap, eps=0.08, n_iters=25,
                                           kernel_dtype=jnp.float32)
    ft, gt = tpar.sharded_scaling_sinkhorn(mt, *_t(cost, mass, cap), eps=0.08, n_iters=25,
                                           kernel_dtype=torch.float32)
    ref = sinkhorn(*_t(cost, mass, cap), eps=0.08, n_iters=25)
    _close(ft, fj, POT_TOL, "f vs jax")
    _close(gt, gj, POT_TOL, "g vs jax")
    _close(ft, ref.f, 1e-3, "f vs log-domain")
    _close(gt, ref.g, 1e-3, "g vs log-domain")


@pytest.mark.parametrize("n,obj_axis", SHAPES, ids=SHAPE_IDS)
def test_sharded_scaling_survives_wide_cost_ranges(n, obj_axis):
    """``tests/test_scaling_sinkhorn.py:213``'s heavy-tailed rows, wider: over 40%
    of the rows' minima sit so far above the global one that a GLOBAL shift
    would underflow every kernel entry of those rows. The per-row ``pmin`` shift keeps every
    live row finite and matches JAX's and the single-device solve."""
    mj, mt = _meshes(n, obj_axis)
    rng = np.random.default_rng(11)
    cost = (rng.normal(size=(1024, 64)) + 100.0 * rng.random((1024, 1))).astype(np.float32)
    cost = cost / np.float32(10.0)
    mass, cap = np.ones(1024, np.float32), np.ones(64, np.float32)
    # A global shift would lose these rows: exp(-(row min - global min) / eps)
    # is 0 in float32 past 104.
    assert ((cost.min(axis=1) - cost.min()) / 0.05 > 104).mean() > 0.4
    fj, gj = jpar.sharded_scaling_sinkhorn(mj, jnp.asarray(cost), mass, cap, eps=0.05, n_iters=40,
                                           kernel_dtype=jnp.float32)
    ft, gt = tpar.sharded_scaling_sinkhorn(mt, *_t(cost, mass, cap), eps=0.05, n_iters=40,
                                           kernel_dtype=torch.float32)
    single = scaling_sinkhorn(*_t(cost, mass, cap), eps=0.05, n_iters=40, kernel_dtype=torch.float32)
    assert torch.isfinite(ft).all() and torch.isfinite(gt).all()
    _close(ft, fj, POT_TOL, "f vs jax")
    _close(gt, gj, POT_TOL, "g vs jax")
    _close(ft, single.f, POT_TOL, "f vs single")
    _close(gt, single.g, POT_TOL, "g vs single")


@pytest.mark.parametrize("n,obj_axis", SHAPES, ids=SHAPE_IDS)
def test_sharded_scaling_bf16_close_enough_for_assignment(n, obj_axis):
    """The bfloat16 kernel (the default): potentials within ``BF16_TOL`` of
    JAX's sharded bf16 solve, and rounded assignments agreeing with the
    float32 log-domain solve's on ``BF16_ROW_AGREEMENT`` of the rows."""
    mj, mt = _meshes(n, obj_axis)
    cost, mass, cap = _problem(3, 128, 128)
    fj, gj = jpar.sharded_scaling_sinkhorn(mj, jnp.asarray(cost), mass, cap, eps=0.08, n_iters=25)
    ft, gt = tpar.sharded_scaling_sinkhorn(mt, *_t(cost, mass, cap), eps=0.08, n_iters=25)
    _close(ft, fj, BF16_TOL, "f vs jax (bf16)")
    _close(gt, gj, BF16_TOL, "g vs jax (bf16)")
    ct = torch.from_numpy(cost)
    ref = sinkhorn(ct, *_t(mass, cap), eps=0.08, n_iters=25)
    a1 = plan_rounded_assign(ct, ft, gt, 0.08)
    a2 = plan_rounded_assign(ct, ref.f, ref.g, 0.08)
    assert float((a1 == a2).float().mean()) > BF16_ROW_AGREEMENT


@pytest.mark.parametrize("n,obj_axis", SHAPES, ids=SHAPE_IDS)
def test_sharded_sinkhorn_assign_matches_jax(n, obj_axis):
    """``tests/test_sinkhorn.py:101-113``: the sharded assignment equals the
    single-device one, and JAX's sharded one, row for row."""
    mj, mt = _meshes(n, obj_axis)
    cost = np.random.default_rng(11).random((512, 32), dtype=np.float32)
    mass, cap = np.ones(512, np.float32), np.ones(32, np.float32)
    aj = jpar.sharded_sinkhorn_assign(mj, jpar.shard_cost(mj, jnp.asarray(cost)), mass, cap,
                                      eps=0.05, n_iters=40)
    at = tpar.sharded_sinkhorn_assign(mt, tpar.shard_cost(mt, torch.from_numpy(cost)),
                                      *_t(mass, cap), eps=0.05, n_iters=40)
    single, _ = sinkhorn_assign(*_t(cost, mass, cap), eps=0.05, n_iters=40)
    assert at.dtype == torch.int32
    assert torch.equal(at, single)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
