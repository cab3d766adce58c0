"""Parity: rio_tpu_torch.ops.sinkhorn against rio_tpu.ops.sinkhorn on the same numpy inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import importlib  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rio_tpu.ops import scaling as jscaling  # noqa: E402
from rio_tpu_torch.convert import problem_to_torch, scaling_state_to_torch, to_tensor  # noqa: E402

# The packages export a function named ``sinkhorn``, which shadows the module.
jsk = importlib.import_module("rio_tpu.ops.sinkhorn")
tsk = importlib.import_module("rio_tpu_torch.ops.sinkhorn")


def _problem(seed, n, m, dead_nodes=0, padded_rows=0):
    rng = np.random.default_rng(seed)
    cost = rng.random((n, m), dtype=np.float32)
    mass = (rng.random(n, dtype=np.float32) + 0.1).astype(np.float32)
    if padded_rows:
        mass[-padded_rows:] = 0.0
    cap = (rng.random(m, dtype=np.float32) + 0.5).astype(np.float32)
    if dead_nodes:
        cap[:dead_nodes] = 0.0
    return cost, mass, cap


@pytest.mark.parametrize(
    "n,m,dead,pad,warm",
    [(64, 96, 0, 0, False), (48, 96, 3, 5, False), (64, 130, 2, 0, True)],
)
def test_sinkhorn_potentials_match_jax(n, m, dead, pad, warm):
    cost, mass, cap = _problem(0, n, m, dead, pad)
    g_init = None
    if warm:
        g_init = np.random.default_rng(1).normal(size=m).astype(np.float32) * 0.05
        g_init[0] = -np.inf  # a dead column of the previous solve cold-fills
    ref = jsk.sinkhorn(
        cost, mass, cap, eps=0.08, n_iters=25,
        g_init=None if g_init is None else jnp.asarray(g_init),
    )
    p = problem_to_torch(cost, mass, cap, g_init, device="cpu")
    out = tsk.sinkhorn(p.cost, p.mass, p.cap, eps=0.08, n_iters=25, g_init=p.g_init)
    # float32 log-sum-exp summed in another order: 1e-4.
    np.testing.assert_allclose(out.f.numpy(), np.asarray(ref.f), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.g.numpy(), np.asarray(ref.g), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(out.err), float(ref.err), rtol=1e-3, atol=1e-5)


def test_plan_rounded_assign_matches_jax_on_same_potentials():
    cost, mass, cap = _problem(2, 2048, 64, dead_nodes=2, padded_rows=16)
    ref = jsk.sinkhorn(cost, mass, cap, eps=0.05, n_iters=30)
    want = np.asarray(jsk.plan_rounded_assign(cost, ref.f, ref.g, 0.05))
    f, g = to_tensor(ref.f, "cpu"), to_tensor(ref.g, "cpu")
    got = tsk.plan_rounded_assign(torch.from_numpy(cost), f, g, 0.05).numpy()
    # Same state; only the cumsum's order differs, which can flip a row
    # whose quantile sits exactly on a CDF step.
    assert (got == want).mean() >= 0.999


@pytest.mark.parametrize("kernel_dtype", [jnp.float32, jnp.bfloat16])
def test_plan_rounded_assign_from_scaling_matches_jax_on_same_state(kernel_dtype):
    rng = np.random.default_rng(3)
    n, m = 4096, 128
    cost = rng.random((n, m), dtype=np.float32)
    mass, cap = np.ones(n, np.float32), np.ones(m, np.float32)
    mass[-32:] = 0.0  # padding rows spread over live columns
    cap[:3] = 0.0  # dead columns are never chosen
    u, v, K, shift = jscaling.scaling_core(
        cost, mass, cap, eps=0.05, n_iters=25, kernel_dtype=kernel_dtype
    )
    want = np.asarray(jsk.plan_rounded_assign_from_scaling(K, u, v))
    st = scaling_state_to_torch(u, v, K, shift, device="cpu")
    assert st.K.dtype == (torch.float32 if kernel_dtype == jnp.float32 else torch.bfloat16)
    got = tsk.plan_rounded_assign_from_scaling(st.K, st.u, st.v).numpy()
    # Same state; cumsum order at exact ties is the only difference.
    assert (got == want).mean() >= 0.999
    assert (got >= 3).all()


def _repair_cases():
    rng = np.random.default_rng(4)
    n, m = 1000, 37
    # Skewed seats: a few columns far over quota, several empty.
    skew = rng.zipf(1.6, size=n) % m
    # Tied remainders: two blocks of ten columns share the remainder .5.
    tied = np.full(m, 450 / 17, np.float64)
    tied[:10] = 26.5
    tied[10:20] = 28.5
    dead = np.full(m, n / (m - 5), np.float64)
    dead[[0, 7, 11, 20, 36]] = 0.0
    under = np.full(m, 0.9 * n / m, np.float64)  # sums to 0.9 n
    return [
        (skew.astype(np.int32), tied.astype(np.float32)),
        (skew.astype(np.int32), dead.astype(np.float32)),
        (rng.integers(0, m, n).astype(np.int32), under.astype(np.float32)),
        (np.zeros(n, np.int32), np.full(m, n / m, np.float32)),
    ]


@pytest.mark.parametrize("case", range(4))
@pytest.mark.parametrize("prefer", [False, True])
def test_exact_quota_repair_equals_jax(case, prefer):
    idx, expected = _repair_cases()[case]
    keep = None
    if prefer:
        keep = np.random.default_rng(5 + case).random(idx.shape[0]) < 0.5
    want = np.asarray(
        jsk.exact_quota_repair(
            jnp.asarray(idx), jnp.asarray(expected),
            None if keep is None else jnp.asarray(keep),
        )
    )
    got = tsk.exact_quota_repair(
        torch.from_numpy(idx), torch.from_numpy(expected),
        None if keep is None else torch.from_numpy(keep),
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("prefer", [False, True])
def test_batched_exact_quota_repair_at_the_fine_stage_shape_equals_jax(prefer):
    """32 groups of 25,600 rows over 32 members and the padding sentinel."""
    rng = np.random.default_rng(9)
    G, B, M = 32, 25_600, 32
    n_real = rng.integers(B // 2, B + 1, G)
    real = np.arange(B)[None, :] < n_real[:, None]
    idx = np.where(real, rng.integers(0, M, (G, B)), M).astype(np.int32)
    cap = (rng.random((G, M)) + 0.5).astype(np.float32)
    cap[:4, :5] = 0.0  # dead members
    expected = np.concatenate(
        [cap / cap.sum(-1, keepdims=True) * n_real[:, None], (B - n_real)[:, None]], -1
    ).astype(np.float32)
    keep = rng.random((G, B)) < 0.5 if prefer else None
    args = [jnp.asarray(idx), jnp.asarray(expected)] + ([jnp.asarray(keep)] if prefer else [])
    want = np.asarray(jax.vmap(jsk.exact_quota_repair)(*args))
    got = tsk.exact_quota_repair(
        torch.from_numpy(idx), torch.from_numpy(expected),
        None if keep is None else torch.from_numpy(keep),
    )
    assert got.shape == (G, B) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_route_sentinel_spill_equals_jax():
    rng = np.random.default_rng(6)
    idx = rng.integers(0, 12, 300).astype(np.int32)
    is_real = rng.random(300) < 0.8
    cap = rng.random(10).astype(np.float32)
    cap[4] = cap.max() + 1.0
    want = np.asarray(
        jsk.route_sentinel_spill(jnp.asarray(idx), jnp.asarray(is_real), 10, jnp.asarray(cap))
    )
    got = tsk.route_sentinel_spill(
        torch.from_numpy(idx), torch.from_numpy(is_real), 10, torch.from_numpy(cap)
    )
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[is_real] < 10).all()


def test_sinkhorn_assign_matches_jax():
    cost, mass, cap = _problem(7, 256, 32, dead_nodes=2)
    want, _ = jsk.sinkhorn_assign(cost, mass, cap, eps=0.08, n_iters=30)
    p = problem_to_torch(cost, mass, cap, device="cpu")
    got, _ = tsk.sinkhorn_assign(p.cost, p.mass, p.cap, eps=0.08, n_iters=30)
    assert (got.numpy() == np.asarray(want)).mean() >= 0.99
    assert not np.isin(got.numpy(), [0, 1]).any()


def test_pad_axis_to_and_marginals_match_jax():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    for axis, size in ((0, 5), (1, 6), (1, 4)):
        want = np.asarray(jsk.pad_axis_to(jnp.asarray(x), size, axis, -1.0))
        np.testing.assert_array_equal(tsk.pad_axis_to(torch.from_numpy(x), size, axis, -1.0).numpy(), want)
    mass, cap = np.array([1.0, 0.0, 3.0], np.float32), np.array([2.0, 2.0], np.float32)
    ja, jb = jsk.normalize_marginals(jnp.asarray(mass), jnp.asarray(cap))
    ta, tb = tsk.normalize_marginals(torch.from_numpy(mass), torch.from_numpy(cap))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
