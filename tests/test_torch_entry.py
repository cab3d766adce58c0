"""Parity: the port's placement step against the JAX step of __graft_entry__ and bench.py."""

import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import __graft_entry__ as graft  # noqa: E402
from rio_tpu.ops import (  # noqa: E402
    exact_quota_repair,
    plan_rounded_assign_from_scaling,
    scaling_core_auto,
)
from rio_tpu_torch import entry as tentry  # noqa: E402

N, M = 4096, 256


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    cost = rng.random((N, M), dtype=np.float32)
    return cost, np.ones(N, np.float32), np.ones(M, np.float32)


def _jax_chunked_step(cost, mass, cap, kernel_dtype, chunk):
    """bench.py's ``_solve_rate.step`` assignment, with CHUNK = ``chunk``."""
    n, m = cost.shape
    u, v, K, _ = scaling_core_auto(cost, mass, cap, eps=0.05, n_iters=30, kernel_dtype=kernel_dtype)
    K_c = K.reshape(n // chunk, chunk, m)
    u_c = u.reshape(n // chunk, chunk)
    assignment = lax.map(
        lambda args: plan_rounded_assign_from_scaling(args[0], args[1], v), (K_c, u_c)
    ).reshape(-1)
    expected = cap / jnp.maximum(jnp.sum(cap), 1e-30) * n
    return exact_quota_repair(assignment, expected)


def _check_against(got, want, cost, min_agreement):
    got_loads = np.bincount(got, minlength=M)
    want_loads = np.bincount(want, minlength=M)
    np.testing.assert_array_equal(got_loads, np.full(M, N // M))
    np.testing.assert_array_equal(want_loads, got_loads)
    assert (got == want).mean() >= min_agreement
    rows = np.arange(N)
    got_cost, want_cost = cost[rows, got].mean(), cost[rows, want].mean()
    assert abs(got_cost - want_cost) <= 0.01 * want_cost
    assert got_cost < 0.25  # random placement scores 0.50


def test_placement_step_matches_graft_entry():
    cost, mass, cap = _inputs()
    fn, _ = graft.entry()
    want = np.asarray(jax.jit(fn)(cost, mass, cap))
    got, mean_cost, err = tentry.placement_step(
        *(torch.from_numpy(x) for x in (cost, mass, cap)), device="cpu"
    )
    assert got.dtype == torch.int32 and got.shape == (N,)
    # bfloat16 K: u and v round to bf16 before each product on both sides;
    # where they differ in the last bit the rounding differs.
    _check_against(got.numpy(), want, cost, 0.95)
    assert float(mean_cost) == pytest.approx(cost[np.arange(N), got.numpy()].mean(), rel=1e-6)
    assert 0.0 <= float(err) < 1e-3


@pytest.mark.parametrize(
    "kernel_dtype,min_agreement",
    [(torch.float32, 0.99), (torch.bfloat16, 0.95)],
)
def test_chunked_placement_step_matches_bench_step(kernel_dtype, min_agreement):
    cost, mass, cap = _inputs(1)
    jdtype = jnp.float32 if kernel_dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(
        jax.jit(_jax_chunked_step, static_argnums=(3, 4))(cost, mass, cap, jdtype, 1024)
    )
    got, _, _ = tentry.placement_step(
        *(torch.from_numpy(x) for x in (cost, mass, cap)),
        kernel_dtype=kernel_dtype, chunk=1024, device="cpu",
    )
    _check_against(got.numpy(), want, cost, min_agreement)


def test_chunk_must_divide_rows():
    cost, mass, cap = (torch.from_numpy(x) for x in _inputs())
    with pytest.raises(ValueError):
        tentry.placement_step(cost, mass, cap, n_iters=2, chunk=1000, device="cpu")


def test_entry_returns_the_4096_x_256_step_on_cpu():
    step, (cost, mass, cap) = tentry.entry(device="cpu")
    assert cost.shape == (N, M) and cost.device.type == "cpu"
    assert float(cost.min()) >= 0.0 and float(cost.max()) < 1.0
    again, _, _ = tentry.make_problem(N, M, 0, "cpu")
    torch.testing.assert_close(cost, again, rtol=0, atol=0)  # seeded
    assignment, _, _ = step(cost, mass, cap)
    np.testing.assert_array_equal(np.bincount(assignment.numpy(), minlength=M), N // M)


@pytest.mark.parametrize("call", ["placement_step", "entry", "make_problem"])
def test_entry_points_without_device_raise_without_cuda(call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    cost, mass, cap = (torch.from_numpy(x) for x in _inputs())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if call == "placement_step":
            tentry.placement_step(cost, mass, cap)
        elif call == "entry":
            tentry.entry()
        else:
            tentry.make_problem(8, 4)
