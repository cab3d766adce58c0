"""Parity: rio_tpu_torch.ops.scaling against rio_tpu.ops.scaling on the same numpy inputs.

The JAX Pallas kernel runs in interpret mode here, as tests/test_scaling_sinkhorn.py
runs it; the port's kernel wrapper takes its plain twin for CPU tensors.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from rio_tpu.ops import scaling as js  # noqa: E402
from rio_tpu_torch.convert import problem_to_torch, to_tensor  # noqa: E402
from rio_tpu_torch.kernels.launch import launches  # noqa: E402
from rio_tpu_torch.ops import scaling as ts  # noqa: E402

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


def _assert_rel(got, want, rtol):
    """Elementwise |got - want| <= rtol * |want|, zeros exact."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(got == 0, want == 0)
    nz = want != 0
    assert np.max(np.abs(got[nz] - want[nz]) / np.abs(want[nz]), initial=0.0) <= rtol


def _warm_seed(m, seed=9):
    g = np.random.default_rng(seed).normal(size=m).astype(np.float32) * 0.3 + 2.0
    g[1] = -np.inf  # a dead column of the previous solve cold-fills
    return g


@pytest.mark.parametrize(
    "n,m,dead,pad,warm,shift",
    [
        (64, 96, 0, 0, False, 0.0),
        (48, 96, 3, 5, False, 0.0),
        (96, 130, 2, 4, True, 0.0),
        (64, 96, 0, 0, True, -1.7),  # negative cost minimum: the row gauge folds back into f
    ],
)
def test_scaling_core_f32_matches_jax(n, m, dead, pad, warm, shift):
    cost, mass, cap = _problem(1, n, m, dead, pad)
    cost = (cost * 2.0 + shift).astype(np.float32) if shift else cost
    g_init = _warm_seed(m) if warm else None
    kw = dict(eps=0.07, n_iters=20)
    ju, jv, jK, jsh = js.scaling_core(
        cost, mass, cap, kernel_dtype=jnp.float32,
        g_init=None if g_init is None else jnp.asarray(g_init), **kw,
    )
    p = problem_to_torch(cost, mass, cap, g_init, device="cpu")
    u, v, K, sh = ts.scaling_core(
        p.cost, p.mass, p.cap, kernel_dtype=torch.float32, g_init=p.g_init, **kw
    )
    # float32 matrix-vector products summed in another order, 20 iterations: 2e-4.
    _assert_rel(u.numpy(), ju, 2e-4)
    _assert_rel(v.numpy(), jv, 2e-4)
    np.testing.assert_allclose(K.numpy(), np.asarray(jK), rtol=2e-6, atol=1e-7)
    np.testing.assert_array_equal(sh.numpy(), np.asarray(jsh))

    want = js.scaling_sinkhorn(
        cost, mass, cap, kernel_dtype=jnp.float32,
        g_init=None if g_init is None else jnp.asarray(g_init), **kw,
    )
    got = ts.scaling_sinkhorn(
        p.cost, p.mass, p.cap, kernel_dtype=torch.float32, g_init=p.g_init, **kw
    )
    np.testing.assert_allclose(got.f.numpy(), np.asarray(want.f), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.g.numpy(), np.asarray(want.g), rtol=2e-4, atol=2e-4)
    if dead:
        assert np.isneginf(got.g.numpy()[:dead]).all()
    if pad:
        assert np.isneginf(got.f.numpy()[-pad:]).all()


def test_scaling_survives_wide_cost_ranges_like_jax():
    """Per-row gauge: rows sitting 20+ sigma above the global min never underflow."""
    rng = np.random.default_rng(11)
    n, m = 4096, 64
    cost = rng.normal(size=(n, m)) + 30.0 * rng.random((n, 1))
    cost = (cost / cost.std()).astype(np.float32)
    mass, cap = np.ones(n, np.float32), np.ones(m, np.float32)
    want = js.scaling_sinkhorn(cost, mass, cap, eps=0.05, n_iters=40, kernel_dtype=jnp.float32)
    p = problem_to_torch(cost, mass, cap, device="cpu")
    got = ts.scaling_sinkhorn(p.cost, p.mass, p.cap, eps=0.05, n_iters=40, kernel_dtype=torch.float32)
    assert np.isfinite(float(got.err)) and float(got.err) < 0.05 * n
    np.testing.assert_allclose(got.g.numpy(), np.asarray(want.g), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.f.numpy(), np.asarray(want.f), rtol=2e-4, atol=2e-4)


def _repaired(round_fn, repair_fn, K, u, v, cap, n):
    idx = round_fn(K, u, v)
    expected = cap / max(float(cap.sum()), 1e-30) * n
    return np.asarray(repair_fn(idx, expected))


def test_scaling_core_bf16_meets_the_assignment_contract_like_jax():
    n, m = 2048, 128
    cost, _, _ = _problem(2, n, m)
    mass, cap = np.ones(n, np.float32), np.ones(m, np.float32)
    cap[:4] = 0.0
    ju, jv, jK, _ = js.scaling_core(cost, mass, cap, eps=0.05, n_iters=25, kernel_dtype=jnp.bfloat16)
    want = _repaired(
        jsk.plan_rounded_assign_from_scaling, jsk.exact_quota_repair, jK, ju, jv,
        jnp.asarray(cap), n,
    )
    p = problem_to_torch(cost, mass, cap, device="cpu")
    u, v, K, _ = ts.scaling_core(p.cost, p.mass, p.cap, eps=0.05, n_iters=25)
    assert K.dtype == torch.bfloat16
    got = _repaired(
        tsk.plan_rounded_assign_from_scaling, tsk.exact_quota_repair, K, u, v, p.cap, n
    )
    loads = np.bincount(got, minlength=m)
    # Largest-remainder quotas of 2048 / 124: 16 or 17 per live node, 0 on dead ones.
    assert loads.sum() == n and (loads[:4] == 0).all()
    assert set(loads[4:].tolist()) <= {n // (m - 4), n // (m - 4) + 1}
    np.testing.assert_array_equal(loads, np.bincount(want, minlength=m))
    # bfloat16 K: rounding of u and v to bf16 differs where they differ in the last bits.
    assert (got == want).mean() >= 0.95


@pytest.mark.parametrize("kernel_dtype", [jnp.float32, jnp.bfloat16])
def test_fused_iteration_ref_matches_pallas_interpret(kernel_dtype):
    rng = np.random.default_rng(4)
    n, m = 64, 128
    K = (rng.random((n, m), dtype=np.float32) + 0.01).astype(np.float32)
    a = np.full(n, 1.0 / n, np.float32)
    a[-3:] = 0.0
    b = np.full(m, 1.0 / m, np.float32)
    b[:2] = 0.0
    v = (rng.random(m, dtype=np.float32) + 0.5).astype(np.float32)
    jK = jnp.asarray(K).astype(kernel_dtype)
    ju, jv = js.fused_scaling_iteration(
        jK, jnp.asarray(a), jnp.asarray(b), jnp.asarray(v), block_rows=8, interpret=True
    )
    tK = to_tensor(jK, "cpu")
    before = launches()["fused_scaling_iteration"]
    u, v_new = ts.fused_scaling_iteration(tK, *(torch.from_numpy(x) for x in (a, b, v)))
    assert launches()["fused_scaling_iteration"] == before  # CPU: the plain twin, no launch
    _assert_rel(u.numpy(), ju, 1e-5)
    _assert_rel(v_new.numpy(), jv, 1e-5)


@pytest.mark.parametrize("n,m,block", [(96, 130, 16), (40, 100, 8)])
def test_fused_scaling_core_matches_pallas_scaling_core(n, m, block):
    cost, mass, cap = _problem(21, n, m, dead_nodes=3, padded_rows=5)
    kw = dict(eps=0.07, n_iters=20)
    ju, jv, jK, jsh = js.pallas_scaling_core(
        cost, mass, cap, kernel_dtype=jnp.float32, block_rows=block, interpret=True, **kw
    )
    p = problem_to_torch(cost, mass, cap, device="cpu")
    u, v, K, sh = ts.fused_scaling_core(p.cost, p.mass, p.cap, kernel_dtype=torch.float32, **kw)
    assert K.shape == (n, m) and K.shape == jK.shape  # unpadded, reusable by rounding
    _assert_rel(u.numpy(), ju, 2e-4)
    _assert_rel(v.numpy(), jv, 2e-4)
    np.testing.assert_allclose(K.numpy(), np.asarray(jK), rtol=2e-6, atol=1e-7)
    np.testing.assert_array_equal(sh.numpy(), np.asarray(jsh))

    want = js.pallas_scaling_sinkhorn(
        cost, mass, cap, kernel_dtype=jnp.float32, block_rows=block, interpret=True, **kw
    )
    got = ts.fused_scaling_sinkhorn(p.cost, p.mass, p.cap, kernel_dtype=torch.float32, **kw)
    np.testing.assert_allclose(got.f.numpy(), np.asarray(want.f), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.g.numpy(), np.asarray(want.g), rtol=2e-4, atol=2e-4)


def test_fused_core_bf16_keeps_bf16_K_unpadded():
    cost, mass, cap = _problem(5, 40, 100)
    p = problem_to_torch(cost, mass, cap, device="cpu")
    u, v, K, sh = ts.fused_scaling_core(p.cost, p.mass, p.cap, eps=0.07, n_iters=5)
    assert K.dtype == torch.bfloat16 and K.shape == (40, 100)
    assert u.shape == (40,) and v.shape == (100,) and sh.shape == (40,)


def test_scaling_core_auto_picks_eager_on_cpu():
    assert ts.scaling_impl_for("cpu") == "eager"
    assert ts.scaling_impl_for(torch.device("cuda")) == "fused"
    cost, mass, cap = _problem(3, 64, 128)
    p = problem_to_torch(cost, mass, cap, device="cpu")
    kw = dict(eps=0.08, n_iters=15, kernel_dtype=torch.float32)
    got = ts.scaling_core_auto(p.cost, p.mass, p.cap, **kw)
    want = ts.scaling_core(p.cost, p.mass, p.cap, **kw)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize(
    "case",
    ["k_dtype", "a_dtype", "v_shape", "noncontiguous", "no_columns"],
)
def test_fused_iteration_rejects_bad_arguments(case):
    n, m = 8, 16
    K = torch.rand(n, m)
    a, b, v = torch.ones(n), torch.ones(m), torch.ones(m)
    expect = ValueError
    if case == "k_dtype":
        K, expect = K.double(), TypeError
    elif case == "a_dtype":
        a, expect = a.half(), TypeError
    elif case == "v_shape":
        v = torch.ones(m + 1)
    elif case == "noncontiguous":
        K = torch.rand(m, n).t()
    else:
        K, b, v = torch.rand(n, 0), torch.ones(0), torch.ones(0)
    with pytest.raises(expect):
        ts.fused_scaling_iteration(K, a, b, v)
