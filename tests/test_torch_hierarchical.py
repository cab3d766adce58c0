"""rio_tpu_torch.parallel.hierarchical against rio_tpu.parallel.hierarchical.

Every single-device scenario of ``tests/test_hierarchical.py`` runs on the
port with the reference's bars, on the reference's own inputs (drawn with
``jax.random`` and passed as numpy). The parity cases run both solves on
the same inputs and hold the port to: per-group and per-node counts and
overflow equal, ``coarse_g`` within 1e-3 relative, and at least 99% of
rows on the same node.

The batched solve-round-repair ops of the fine stage are held against a
per-group loop of the unbatched ops: rounding, quantiles, quota repair
and the sentinel spill exactly; the scaling solve within ``SCALING_TOL``
(a batched matrix product need not round as a matrix-vector product does).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rio_tpu.parallel.hierarchical import chunked_hierarchical_assign as jax_chunked  # noqa: E402
from rio_tpu.parallel.hierarchical import hierarchical_assign as jax_hier  # noqa: E402

from rio_tpu_torch.parallel.hierarchical import (  # noqa: E402
    chunked_hierarchical_assign,
    chunked_hierarchical_assign_timed,
    hierarchical_assign,
)

S = importlib.import_module("rio_tpu_torch.ops.sinkhorn")
C = importlib.import_module("rio_tpu_torch.ops.scaling")

SCALING_TOL = 1e-5
COARSE_G_RTOL = 1e-3
ROW_AGREEMENT = 0.99


def _features(key, n, d, m):
    """tests/test_hierarchical.py's inputs, as numpy."""
    k1, k2 = jax.random.split(key)
    obj = jax.random.normal(k1, (n, d), jnp.float32)
    node = jax.random.normal(k2, (d, m), jnp.float32) * 0.2
    return np.asarray(obj), np.asarray(node)


def _t(*arrays):
    return [torch.from_numpy(np.array(a, dtype=np.float32)) for a in arrays]


def _vec(m, value=1.0, **at):
    v = np.full((m,), value, np.float32)
    for i, x in at.items():
        v[int(i[1:])] = x
    return v


# ------------------------------------- tests/test_hierarchical.py scenarios


def test_hierarchical_balances_and_avoids_dead_nodes():
    n, d, m, g = 2048, 16, 64, 8
    obj, node = _features(jax.random.PRNGKey(0), n, d, m)
    alive = _vec(m, i10=0.0, i37=0.0)
    res = hierarchical_assign(*_t(obj, node, np.ones(m), alive), n_groups=g)
    a = res.assignment.numpy()
    assert res.assignment.dtype == torch.int32 and a.min() >= 0 and a.max() < m
    assert not np.any(np.isin(a, [10, 37]))
    counts = np.bincount(a, minlength=m)
    assert counts[np.setdiff1d(np.arange(m), [10, 37])].max() < 2.2 * (n / 62)
    assert int(res.overflow) == 0


def test_hierarchical_respects_affinity():
    n, d, m, g = 512, 8, 32, 4
    s = m // g
    group_dirs = jax.random.normal(jax.random.PRNGKey(1), (g, d), jnp.float32)
    node = (
        jnp.repeat(group_dirs, s, axis=0) + 0.1 * jax.random.normal(jax.random.PRNGKey(7), (m, d))
    ).T
    owner = jax.random.randint(jax.random.PRNGKey(2), (n,), 0, m)
    obj = node.T[owner] * 3.0
    res = hierarchical_assign(
        *_t(obj, node, np.ones(m), np.ones(m)), n_groups=g, eps=0.05
    )
    assert np.mean(res.group.numpy() == np.asarray(owner) // s) > 0.6
    assert int(res.overflow) == 0


def test_hierarchical_capacity_weighting():
    n, d, m, g = 1024, 8, 16, 4
    obj, node = _features(jax.random.PRNGKey(3), n, d, m)
    cap = np.ones(m, np.float32)
    cap[0:4] = 3.0
    res = hierarchical_assign(*_t(obj, node, cap, np.ones(m)), n_groups=g)
    assert np.bincount(res.group.numpy(), minlength=g)[0] > 0.38 * n


def test_hierarchical_overflow_fallback():
    n, d, m, g = 256, 8, 16, 4
    obj, node = _features(jax.random.PRNGKey(4), n, d, m)
    res = hierarchical_assign(
        *_t(obj, node, np.ones(m), _vec(m, i0=0.0)), n_groups=g, bucket=16
    )
    assert int(res.overflow) > 0
    a = res.assignment.numpy()
    assert a.min() >= 0 and a.max() < m
    assert not np.any(a == 0)


def test_fine_stage_sentinel_spill_routes_to_live_member():
    s = 4
    local = torch.tensor([0, 2, s, s, s], dtype=torch.int32)
    mass = torch.tensor([1.0, 1.0, 1.0, 0.0, 0.0])
    cap = torch.tensor([1.0, 0.0, 1.0, 3.0])
    out = S.route_sentinel_spill(local, mass > 0, s, cap).tolist()
    assert out == [0, 2, 3, s, s]


def test_hierarchical_dead_members_excluded_under_extreme_skew():
    n, d, m, g = 1024, 8, 32, 8
    obj, node = _features(jax.random.PRNGKey(11), n, d, m)
    s = m // g
    alive = np.zeros(m, np.float32)
    alive[::s] = 1.0
    res = hierarchical_assign(*_t(obj, node, np.full(m, 4.0), alive), n_groups=g, bucket=256)
    a = res.assignment.numpy()
    assert not np.any((alive == 0.0)[a]), "object seated on a dead node"
    loads = np.bincount(a, minlength=m)
    assert loads[alive > 0].sum() == n
    live_loads = loads[alive > 0]
    assert live_loads.max() - live_loads.min() <= 2, live_loads


def test_hierarchical_exact_node_quotas():
    n, d, m, g = 8192, 8, 64, 8
    obj, node = _features(jax.random.PRNGKey(9), n, d, m)
    res = hierarchical_assign(*_t(obj, node, np.ones(m), np.ones(m)), n_groups=g)
    assert int(res.overflow) == 0
    loads = np.bincount(res.assignment.numpy(), minlength=m)
    assert loads.max() - loads.min() <= 2


def test_chunked_hierarchical_matches_flat_quality():
    n, d, m, g, chunks = 4096, 16, 64, 8, 4
    obj, node = _features(jax.random.PRNGKey(42), n, d, m)
    args = _t(obj, node, np.ones(m), _vec(m, i5=0.0, i50=0.0))
    flat = hierarchical_assign(*args, n_groups=g)
    chunked = chunked_hierarchical_assign(*args, n_groups=g, n_chunks=chunks)
    a = chunked.assignment.numpy()
    assert a.min() >= 0 and a.max() < m
    assert not np.any(np.isin(a, [5, 50]))
    assert int(chunked.overflow) == 0
    cf = np.bincount(flat.assignment.numpy(), minlength=m)
    assert np.abs(np.bincount(a, minlength=m) - cf).max() <= chunks
    on = obj @ node
    q_flat = on[np.arange(n), flat.assignment.numpy()].mean()
    q_chunk = on[np.arange(n), a].mean()
    assert q_chunk >= q_flat - 0.02 * on.std()


def test_chunked_timed_twin_matches_lax_map_form_exactly():
    """Both forms are one host loop here; the timed one also reports a wall
    time per chunk. (The reference's first-chunk >= rest check measures
    its one-time compile, which eager PyTorch does not have.)"""
    n, d, m, g, chunks = 256, 8, 8, 4, 4
    obj, node = _features(jax.random.PRNGKey(7), n, d, m)
    args = _t(obj, node, np.ones(m), _vec(m, i3=0.0))
    mapped = chunked_hierarchical_assign(*args, n_groups=g, n_chunks=chunks)
    timed, chunk_ms = chunked_hierarchical_assign_timed(*args, n_groups=g, n_chunks=chunks)
    assert torch.equal(mapped.assignment, timed.assignment)
    assert torch.equal(mapped.group, timed.group)
    assert int(mapped.overflow) == int(timed.overflow)
    assert torch.equal(mapped.coarse_g, timed.coarse_g)
    assert len(chunk_ms) == chunks and all(ms > 0.0 for ms in chunk_ms)


# --------------------------------------------------------- parity with JAX


def _parity(jres, tres, n_groups, m):
    ja, ta = np.asarray(jres.assignment), tres.assignment.numpy()
    assert np.array_equal(
        np.bincount(np.asarray(jres.group), minlength=n_groups),
        np.bincount(tres.group.numpy(), minlength=n_groups),
    )
    assert np.array_equal(np.bincount(ja, minlength=m), np.bincount(ta, minlength=m))
    assert int(jres.overflow) == int(tres.overflow)
    jg, tg = np.asarray(jres.coarse_g), tres.coarse_g.numpy()
    assert np.abs(jg - tg).max() <= COARSE_G_RTOL * np.abs(jg).max()
    assert np.mean(ja == ta) >= ROW_AGREEMENT


def test_parity_with_jax_8192_x_64_three_dead():
    n, d, m, g = 8192, 16, 64, 8
    obj, node = _features(jax.random.PRNGKey(0), n, d, m)
    cap, alive = np.ones(m, np.float32), _vec(m, i3=0.0, i20=0.0, i41=0.0)
    jres = jax_hier(jnp.asarray(obj), jnp.asarray(node), jnp.asarray(cap), jnp.asarray(alive), n_groups=g)
    tres = hierarchical_assign(*_t(obj, node, cap, alive), n_groups=g)
    _parity(jres, tres, g, m)


def test_parity_with_jax_chunked_4096_x_64():
    n, d, m, g, chunks = 4096, 16, 64, 8, 4
    obj, node = _features(jax.random.PRNGKey(42), n, d, m)
    cap, alive = np.ones(m, np.float32), _vec(m, i5=0.0, i50=0.0)
    jres = jax_chunked(
        jnp.asarray(obj), jnp.asarray(node), jnp.asarray(cap), jnp.asarray(alive),
        n_groups=g, n_chunks=chunks,
    )
    tres = chunked_hierarchical_assign(*_t(obj, node, cap, alive), n_groups=g, n_chunks=chunks)
    _parity(jres, tres, g, m)


def test_parity_with_jax_warm_coarse_seed():
    n, d, m, g = 2048, 16, 64, 8
    obj, node = _features(jax.random.PRNGKey(5), n, d, m)
    cap, alive = np.ones(m, np.float32), _vec(m, i9=0.0)
    seed = np.linspace(-0.3, 0.2, g).astype(np.float32)
    seed[2] = -np.inf  # a dead column of an earlier solve cold-fills
    jres = jax_hier(
        jnp.asarray(obj), jnp.asarray(node), jnp.asarray(cap), jnp.asarray(alive),
        n_groups=g, coarse_g_init=jnp.asarray(seed),
    )
    tres = hierarchical_assign(*_t(obj, node, cap, alive), n_groups=g, coarse_g_init=torch.from_numpy(seed))
    _parity(jres, tres, g, m)


# ----------------------------------------- the fine stage's batched ops


def _fine_problem(seed=1, G=16, B=300, M=9):
    rng = np.random.default_rng(seed)
    cost = torch.from_numpy(rng.normal(size=(G, B, M)).astype(np.float32))
    mass = torch.from_numpy((rng.random((G, B)) > 0.3).astype(np.float32))
    mass[3] = 0.0  # an empty group
    cap = torch.from_numpy((rng.random((G, M)) * (rng.random((G, M)) > 0.2)).astype(np.float32))
    cap[5] = 0.0  # a dead group
    return cost, mass, cap


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("kernel_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_batched_scaling_sinkhorn_equals_a_loop_of_2d_solves(warm, kernel_dtype):
    cost, mass, cap = _fine_problem()
    G = cost.shape[0]
    g_init = torch.linspace(-0.2, 0.3, cap.shape[-1]).repeat(G, 1) if warm else None
    batched = C.scaling_sinkhorn(cost, mass, cap, eps=0.05, n_iters=30,
                                 kernel_dtype=kernel_dtype, g_init=g_init)
    loop = [
        C.scaling_sinkhorn(cost[i], mass[i], cap[i], eps=0.05, n_iters=30,
                           kernel_dtype=kernel_dtype, g_init=None if g_init is None else g_init[i])
        for i in range(G)
    ]
    for field in ("f", "g", "err"):
        want = torch.stack([getattr(r, field) for r in loop])
        got = getattr(batched, field)
        assert torch.equal(torch.isfinite(got), torch.isfinite(want)), field
        fin = torch.isfinite(want)
        assert torch.allclose(got[fin], want[fin], rtol=SCALING_TOL, atol=SCALING_TOL), field
    # The fixed inputs of the solve are elementwise: equal bits.
    a, b, K, shift = C.scaling_kernel(cost, mass, cap, eps=0.05, kernel_dtype=kernel_dtype)
    for i in (0, 3, 5, G - 1):
        a_i, b_i, K_i, shift_i = C.scaling_kernel(cost[i], mass[i], cap[i], eps=0.05, kernel_dtype=kernel_dtype)
        assert torch.equal(a[i], a_i) and torch.equal(b[i], b_i)
        assert torch.equal(K[i], K_i) and torch.equal(shift[i], shift_i)


def test_batched_rounding_repair_and_spill_equal_a_per_group_loop():
    cost, mass, cap = _fine_problem(seed=2)
    G, B, M = cost.shape
    res = C.scaling_sinkhorn(cost, mass, cap, eps=0.05, n_iters=30)
    real = mass > 0
    assert torch.equal(S._quantiles(real), torch.stack([S._quantiles(real[i]) for i in range(G)]))
    local = S.plan_rounded_assign(cost, res.f, res.g, 0.05)
    assert torch.equal(
        local, torch.stack([S.plan_rounded_assign(cost[i], res.f[i], res.g[i], 0.05) for i in range(G)])
    )
    local = torch.where(real, local, M)
    n_real = mass.sum(-1, keepdim=True)
    expected = torch.cat([cap / cap.sum(-1, keepdim=True).clamp_min(1e-30) * n_real, B - n_real], -1)
    prefer = torch.from_numpy(np.random.default_rng(0).random((G, B)) > 0.5)
    for pk in (None, prefer):
        got = S.exact_quota_repair(local, expected, pk)
        want = torch.stack([
            S.exact_quota_repair(local[i], expected[i], None if pk is None else pk[i]) for i in range(G)
        ])
        assert torch.equal(got, want)
    repaired = S.exact_quota_repair(local, expected)
    # Every group with live capacity seats its padding, and only it, on
    # the sentinel.
    for i in range(G):
        if float(cap[i].sum()) == 0.0:
            continue
        counts = torch.bincount(repaired[i].long(), minlength=M + 1)
        assert int(counts.sum()) == B and int(counts[M]) == B - int(n_real[i])
    spilled = S.route_sentinel_spill(repaired, real, M, cap)
    assert torch.equal(
        spilled, torch.stack([S.route_sentinel_spill(repaired[i], real[i], M, cap[i]) for i in range(G)])
    )


def test_batched_repair_of_an_undershooting_caller_stays_within_its_row():
    """Quotas below n leave objects to the refill clip: each row's excess
    lands on its own last column, never on the next row's columns."""
    idx = torch.tensor([[0, 0, 0, 1, 1, 2], [2, 2, 2, 2, 1, 0]], dtype=torch.int32)
    expected = torch.tensor([[1.0, 1.0, 1.0], [0.5, 0.5, 1.0]])
    got = S.exact_quota_repair(idx, expected)
    want = torch.stack([S.exact_quota_repair(idx[i], expected[i]) for i in range(2)])
    assert torch.equal(got, want)
    assert int(got.max()) <= 2
