"""Parity: rio_tpu_torch.ops.pallas_sinkhorn against rio_tpu.ops.pallas_sinkhorn.

The same numpy inputs go to both packages. The JAX Pallas kernel runs in
interpret mode, as tests/test_pallas_sinkhorn.py runs it; the port's kernel
wrapper runs its plain twin for CPU tensors. Interpret-mode solves are slow,
so each JAX result that several tests read is computed once per module.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from rio_tpu_torch import entry as tentry  # noqa: E402
from rio_tpu_torch.convert import problem_to_torch  # noqa: E402

jps = importlib.import_module("rio_tpu.ops.pallas_sinkhorn")
jsk = importlib.import_module("rio_tpu.ops.sinkhorn")
tps = importlib.import_module("rio_tpu_torch.ops.pallas_sinkhorn")
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


def _assert_close(got, want, rtol, atol):
    """Identical -inf patterns, then allclose on the rest."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert not np.isnan(got).any()
    live = ~np.isneginf(want)
    np.testing.assert_allclose(got[live], want[live], rtol=rtol, atol=atol)


def _one_step_inputs():
    """n a multiple of block_rows, m of 128; zero-mass rows, dead columns, g = -inf."""
    rng = np.random.default_rng(4)
    n, m = 64, 128
    cost = rng.random((n, m), dtype=np.float32)
    log_a = np.log(np.full(n, 1.0 / n, np.float32))
    log_a[-3:] = -np.inf
    log_b = np.log(np.full(m, 1.0 / m, np.float32))
    log_b[:2] = -np.inf
    g = (rng.normal(size=m) * 0.01).astype(np.float32)
    g[:2] = -np.inf  # dead columns of an earlier iteration
    return cost, log_a, log_b, g


@pytest.fixture(scope="module")
def jax_one_step():
    cost, log_a, log_b, g = _one_step_inputs()
    f, g_new = jps.fused_iteration(
        *(jnp.asarray(x) for x in (cost, log_a, log_b, g)), jnp.float32(0.07),
        block_rows=8, interpret=True,
    )
    return np.asarray(f), np.asarray(g_new)


def test_fused_iteration_ref_matches_pallas_interpret(jax_one_step):
    inputs = [torch.from_numpy(x) for x in _one_step_inputs()]
    f, g_new = tps.fused_iteration_ref(*inputs, 0.07)
    # The bounds of tests/test_pallas_sinkhorn.py's single-step check.
    _assert_close(f.numpy(), jax_one_step[0], rtol=1e-5, atol=1e-5)
    _assert_close(g_new.numpy(), jax_one_step[1], rtol=1e-5, atol=1e-5)
    assert np.isneginf(f.numpy()[-3:]).all() and np.isneginf(g_new.numpy()[:2]).all()


@pytest.mark.parametrize("n,m,block", [(64, 128, 8), (96, 130, 32), (40, 100, 16)])
def test_pallas_sinkhorn_matches_jax_pallas_sinkhorn(n, m, block):
    cost, mass, cap = _problem(0, n, m)
    want = jps.pallas_sinkhorn(
        cost, mass, cap, eps=0.08, n_iters=25, block_rows=block, interpret=True
    )
    p = problem_to_torch(cost, mass, cap, device="cpu")
    got = tps.pallas_sinkhorn(p.cost, p.mass, p.cap, eps=0.08, n_iters=25)
    # The bounds of tests/test_pallas_sinkhorn.py's 25-iteration parity.
    _assert_close(got.f.numpy(), want.f, rtol=1e-4, atol=1e-4)
    _assert_close(got.g.numpy(), want.g, rtol=1e-4, atol=1e-4)
    assert abs(float(got.err) - float(want.err)) <= 1e-3


@pytest.fixture(scope="module")
def dead_and_padded():
    cost, mass, cap = _problem(1, 48, 96, dead_nodes=3, padded_rows=5)
    want = jps.pallas_sinkhorn(cost, mass, cap, eps=0.05, n_iters=30, block_rows=16, interpret=True)
    p = problem_to_torch(cost, mass, cap, device="cpu")
    got = tps.pallas_sinkhorn(p.cost, p.mass, p.cap, eps=0.05, n_iters=30)
    return cost, want, got


def test_pallas_sinkhorn_handles_dead_nodes_and_padding_rows_like_jax(dead_and_padded):
    _, want, got = dead_and_padded
    assert np.isneginf(got.g.numpy()[:3]).all() and np.isneginf(got.f.numpy()[-5:]).all()
    _assert_close(got.f.numpy(), want.f, rtol=1e-4, atol=1e-4)
    _assert_close(got.g.numpy(), want.g, rtol=1e-4, atol=1e-4)


def test_rounding_consumes_both_solves_identically(dead_and_padded):
    cost, want, got = dead_and_padded
    a_jax = np.asarray(jsk.plan_rounded_assign(jnp.asarray(cost), want.f, want.g, 0.05))
    a_port = tsk.plan_rounded_assign(torch.from_numpy(cost), got.f, got.g, 0.05).numpy()
    np.testing.assert_array_equal(a_port, a_jax)
    assert not np.isin(a_port[:-5], [0, 1, 2]).any()  # real rows never land on dead nodes


def test_every_column_dead_gives_the_same_finite_f():
    cost, mass, _ = _problem(2, 32, 128)
    cap = np.zeros(128, np.float32)
    want = jps.pallas_sinkhorn(cost, mass, cap, eps=0.05, n_iters=3, block_rows=8, interpret=True)
    p = problem_to_torch(cost, mass, cap, device="cpu")
    got = tps.pallas_sinkhorn(p.cost, p.mass, p.cap, eps=0.05, n_iters=3)
    assert np.isneginf(got.g.numpy()).all() and np.isneginf(np.asarray(want.g)).all()
    # Every z is -inf: the LSE floor log(1e-30) gives a finite f, not the
    # +inf of a plain logsumexp.
    assert np.isfinite(got.f.numpy()).all()
    _assert_close(got.f.numpy(), want.f, rtol=1e-5, atol=1e-5)
    a = np.asarray(mass / mass.sum(), np.float32)
    np.testing.assert_allclose(got.f.numpy(), 0.05 * (np.log(a) - np.log(np.float32(1e-30))), rtol=1e-5)


@pytest.mark.parametrize("dead,pad", [(0, 0), (4, 6)])
def test_pallas_sinkhorn_matches_the_unfused_sinkhorn(dead, pad):
    cost, mass, cap = _problem(3, 80, 130, dead_nodes=dead, padded_rows=pad)
    p = problem_to_torch(cost, mass, cap, device="cpu")
    want = tsk.sinkhorn(p.cost, p.mass, p.cap, eps=0.06, n_iters=30)
    got = tps.pallas_sinkhorn(p.cost, p.mass, p.cap, eps=0.06, n_iters=30)
    # Every row has a live column, so the two solves differ only in the order of sums.
    _assert_close(got.f.numpy(), want.f.numpy(), rtol=1e-4, atol=1e-4)
    _assert_close(got.g.numpy(), want.g.numpy(), rtol=1e-4, atol=1e-4)
    assert abs(float(got.err) - float(want.err)) <= 1e-3


@pytest.mark.parametrize(
    "case",
    ["cost_dtype", "cost_bf16", "log_a_dtype", "g_shape", "log_b_shape", "noncontiguous",
     "no_columns", "cost_1d", "eps"],
)
def test_fused_iteration_rejects_bad_arguments(case):
    n, m = 8, 16
    cost = torch.rand(n, m)
    log_a, log_b, g = torch.zeros(n), torch.zeros(m), torch.zeros(m)
    eps, expect = 0.05, ValueError
    if case == "cost_dtype":
        cost, expect = cost.double(), TypeError
    elif case == "cost_bf16":
        cost, expect = cost.bfloat16(), TypeError
    elif case == "log_a_dtype":
        log_a, expect = log_a.half(), TypeError
    elif case == "g_shape":
        g = torch.zeros(m + 1)
    elif case == "log_b_shape":
        log_b = torch.zeros(m, 1)
    elif case == "noncontiguous":
        cost = torch.rand(m, n).t()
    elif case == "no_columns":
        cost, log_b, g = torch.rand(n, 0), torch.zeros(0), torch.zeros(0)
    elif case == "cost_1d":
        cost = torch.rand(n)
    else:
        eps = 0.0
    with pytest.raises(expect):
        tps.fused_iteration(cost, log_a, log_b, g, eps)


N_STEP, M_STEP = 2048, 128


@pytest.fixture(scope="module")
def jax_logdomain_step():
    """The JAX composition: pallas_sinkhorn -> plan_rounded_assign -> exact_quota_repair."""
    rng = np.random.default_rng(5)
    cost = rng.random((N_STEP, M_STEP), dtype=np.float32)
    mass, cap = np.ones(N_STEP, np.float32), np.ones(M_STEP, np.float32)
    res = jps.pallas_sinkhorn(cost, mass, cap, eps=0.05, n_iters=30, interpret=True)
    rounded = jsk.plan_rounded_assign(jnp.asarray(cost), res.f, res.g, 0.05)
    expected = jnp.asarray(cap) / jnp.maximum(jnp.sum(cap), 1e-30) * N_STEP
    return cost, mass, cap, np.asarray(jsk.exact_quota_repair(rounded, expected))


def test_logdomain_placement_step_matches_the_jax_composition(jax_logdomain_step):
    cost, mass, cap, want = jax_logdomain_step
    got, mean_cost, err = tentry.logdomain_placement_step(
        *(torch.from_numpy(x) for x in (cost, mass, cap)), eps=0.05, n_iters=30, device="cpu"
    )
    assert got.dtype == torch.int32 and got.shape == (N_STEP,)
    got = got.numpy()
    quota = np.full(M_STEP, N_STEP // M_STEP)
    np.testing.assert_array_equal(np.bincount(got, minlength=M_STEP), quota)
    np.testing.assert_array_equal(np.bincount(want, minlength=M_STEP), quota)
    # Potentials agree to ~1e-5, so only rows on a CDF boundary may differ.
    assert (got == want).mean() >= 0.99
    rows = np.arange(N_STEP)
    assert abs(float(mean_cost) - cost[rows, want].mean()) <= 1e-3
    assert float(mean_cost) == pytest.approx(cost[rows, got].mean(), rel=1e-6)
    assert float(mean_cost) < 0.25  # random placement scores 0.50
    assert np.isfinite(float(err)) and float(err) < 0.05


def test_chunked_logdomain_step_meets_the_quotas(jax_logdomain_step):
    cost, mass, cap, want = jax_logdomain_step
    args = [torch.from_numpy(x) for x in (cost, mass, cap)]
    got, mean_cost, _ = tentry.logdomain_placement_step(*args, chunk=512, device="cpu")
    np.testing.assert_array_equal(np.bincount(got.numpy(), minlength=M_STEP), N_STEP // M_STEP)
    # Per-chunk quantiles spread each chunk over the same marginals: the
    # plan's cost, not its row order, is what carries over.
    assert abs(float(mean_cost) - cost[np.arange(N_STEP), want].mean()) <= 0.01
    with pytest.raises(ValueError):
        tentry.logdomain_placement_step(*args, n_iters=2, chunk=1000, device="cpu")


def test_logdomain_step_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    cost, mass, cap = torch.rand(16, 4), torch.ones(16), torch.ones(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tentry.logdomain_placement_step(cost, mass, cap)
