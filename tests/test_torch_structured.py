"""rio_tpu_torch.ops.structured against rio_tpu.ops.structured on the CPU.

The same numpy inputs, made from a seed, go through the JAX functions and
the port's. Tolerances:

- ``class_quotas``: g within 1e-4 + 1e-4 |ref| with the same -inf pattern;
  err within 1e-5 + 1e-2 |ref|; every quota row sums exactly to its class
  count and dead columns get 0; at least 99% of cells equal JAX's and none
  differs by more than 1 (float32 Sinkhorn sums in another order, which can
  flip a largest-remainder tie).
- ``expand_class_quotas``: exactly equal to JAX's, padding rows included,
  and to the host expansion ``_apply_class_quotas`` of both packages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from rio_tpu.object_placement.jax_placement import _apply_class_quotas as jax_apply  # noqa: E402
from rio_tpu.ops import structured as jax_structured  # noqa: E402
from rio_tpu_torch.object_placement.torch_placement import _apply_class_quotas  # noqa: E402
from rio_tpu_torch.ops import class_quotas, expand_class_quotas  # noqa: E402
from rio_tpu_torch.ops.assignment import DEAD_NODE_COST  # noqa: E402

EPS = 0.02  # the provider's class eps: min(eps, move_cost / 25) at move_cost 0.5
N_ITERS = 30


def _class_problem(m: int, dead: bool, seed: int):
    rng = np.random.default_rng(seed)
    cap = rng.uniform(0.5, 2.0, m).astype(np.float32)
    alive = np.ones(m, np.float32)
    if dead:
        alive[rng.choice(m, m // 8, replace=False)] = 0.0
    counts = rng.integers(0, 3000, m).astype(np.float32)
    base = (DEAD_NODE_COST * (1.0 - alive)).astype(np.float32)  # zero load
    return base, counts, (cap * alive).astype(np.float32)


def _jax_quotas(base, counts, cap_alive, g_init):
    q, g, err = jax_structured.class_quotas(
        jnp.asarray(base), jnp.asarray(counts), jnp.asarray(cap_alive),
        move_cost=0.5, eps=EPS, n_iters=N_ITERS,
        g_init=None if g_init is None else jnp.asarray(g_init),
    )
    return np.asarray(q), np.asarray(g), float(err)


@pytest.mark.parametrize("m", [64, 256])
@pytest.mark.parametrize("dead", [False, True], ids=["live", "dead_columns"])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_class_quotas_matches_jax(m, dead, warm):
    base, counts, cap_alive = _class_problem(m, dead, seed=m + 2 * dead)
    g_init = None
    if warm:
        # A previous solve's potentials under a perturbed capacity, with a
        # hole (-inf) where a node had been dead: the delta path's seed.
        cap_prev = cap_alive.copy()
        cap_prev[0] = 0.0
        _, g_prev, _ = _jax_quotas(base, counts, cap_prev, None)
        g_init = g_prev
        assert np.isneginf(g_init[0])
    q_ref, g_ref, err_ref = _jax_quotas(base, counts, cap_alive, g_init)
    q, g, err = class_quotas(
        torch.from_numpy(base), torch.from_numpy(counts), torch.from_numpy(cap_alive),
        move_cost=0.5, eps=EPS, n_iters=N_ITERS,
        g_init=None if g_init is None else torch.tensor(g_init),
    )
    q, g, err = q.numpy(), g.numpy(), float(err)

    assert q.dtype == np.int32 and q.shape == (m, m)
    assert np.array_equal(q.sum(axis=1), counts.astype(np.int64))
    assert (q >= 0).all()
    assert (q[:, cap_alive == 0] == 0).all()
    assert np.array_equal(np.isneginf(g), np.isneginf(g_ref))
    live = ~np.isneginf(g_ref)
    assert np.all(np.abs(g[live] - g_ref[live]) <= 1e-4 + 1e-4 * np.abs(g_ref[live]))
    assert abs(err - err_ref) <= 1e-5 + 1e-2 * abs(err_ref), (err, err_ref)
    diff = np.abs(q.astype(np.int64) - q_ref)
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.99


def _random_quotas(rng, m, cur):
    counts = np.bincount(cur, minlength=m)
    quotas = np.zeros((m, m), np.int32)
    for k in range(m):
        if counts[k]:
            quotas[k] = rng.multinomial(counts[k], np.ones(m) / m)
    return quotas


@pytest.mark.parametrize("m,n", [(3, 8), (17, 900), (64, 4000), (256, 5000)])
def test_expand_class_quotas_matches_jax_exactly(m, n):
    rng = np.random.default_rng(m * 7 + n)
    cur = rng.integers(0, m, n).astype(np.int32)
    cur[: n // 5] = 0  # class 0 populated: the padding rows share it
    cur[cur == m - 1] = m // 2  # and one empty class
    quotas = _random_quotas(rng, m, cur)
    bucket = 1
    while bucket < n:
        bucket *= 2
    cur_pad = np.zeros(bucket, np.int32)
    cur_pad[:n] = cur
    ref = np.asarray(jax_structured.expand_class_quotas(jnp.asarray(quotas), jnp.asarray(cur_pad)))
    got = expand_class_quotas(torch.from_numpy(quotas), torch.from_numpy(cur_pad)).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, ref)  # padding rows included
    host = _apply_class_quotas(quotas, cur)
    assert np.array_equal(got[:n], host)
    assert np.array_equal(host, jax_apply(quotas, cur))


def test_expand_class_quotas_keeps_the_diagonal_in_place():
    quotas = np.array([[2, 1, 0], [0, 3, 0], [1, 0, 1]], np.int32)
    cur = np.array([0, 0, 0, 1, 1, 1, 2, 2], np.int32)
    out = expand_class_quotas(torch.from_numpy(quotas), torch.from_numpy(cur)).numpy()
    assert np.bincount(out, minlength=3).tolist() == [3, 4, 1]
    for k in range(3):
        assert int(((cur == k) & (out == k)).sum()) == quotas[k, k]
