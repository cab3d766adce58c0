"""The port's mesh forms of the two-level solve against rio_tpu.parallel.hierarchical.

The mesh scenarios of ``tests/test_hierarchical.py`` run on
``make_mesh(["cpu"] * 8)`` with the reference's bars, on the reference's
own inputs (drawn with ``jax.random`` and passed as numpy), and the parity
cases run the JAX function on conftest's 8-device CPU mesh on the same
inputs: per-group and per-node counts and overflow equal, ``coarse_g``
within 1e-3 relative, at least 99% of rows on the same node (the bars of
``tests/test_torch_hierarchical.py``).

Each (shard, chunk) cell is one ``hierarchical_assign`` call, so the port's
own forms are held to equality: the timed form equals the untimed one, 8
shards x 4 chunks equal the single-device 32-chunk solve, and a 1-shard
mesh equals the single-device solve.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rio_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from rio_tpu.parallel import hierarchical as jh  # noqa: E402

from rio_tpu_torch.parallel import make_mesh  # noqa: E402
from rio_tpu_torch.parallel.hierarchical import (  # noqa: E402
    chunked_hierarchical_assign,
    hierarchical_assign,
    mesh_chunked_hierarchical_assign,
    mesh_chunked_hierarchical_assign_timed,
    sharded_hierarchical_assign,
)

COARSE_G_RTOL = 1e-3
ROW_AGREEMENT = 0.99


def _features(key, n, d, m):
    """tests/test_hierarchical.py's inputs, as numpy."""
    k1, k2 = jax.random.split(key)
    obj = jax.random.normal(k1, (n, d), jnp.float32)
    node = jax.random.normal(k2, (d, m), jnp.float32) * 0.2
    return np.asarray(obj), np.asarray(node)


def _vec(m, value=1.0, dead=()):
    v = np.full((m,), value, np.float32)
    v[list(dead)] = 0.0
    return v


def _t(*arrays):
    return [torch.from_numpy(np.array(a, dtype=np.float32)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _meshes():
    return jax_make_mesh(jax.devices()[:8]), make_mesh(["cpu"] * 8)


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


def _equal(a, b):
    assert torch.equal(a.assignment, b.assignment) and torch.equal(a.group, b.group)
    assert int(a.overflow) == int(b.overflow)
    assert torch.equal(a.coarse_g, b.coarse_g) and torch.equal(a.coarse_err, b.coarse_err)


# ------------------------------------- tests/test_hierarchical.py scenarios


def test_sharded_hierarchical_on_mesh():
    """``tests/test_hierarchical.py:92`` on the port, and against JAX."""
    n, d, m, g = 4096, 16, 64, 8
    obj, node = _features(jax.random.PRNGKey(5), n, d, m)
    cap, alive = np.ones(m, np.float32), _vec(m, dead=[3])
    mj, mt = _meshes()
    res = sharded_hierarchical_assign(mt, *_t(obj, node, cap, alive), n_groups=g)
    a = res.assignment.numpy()
    assert a.shape == (n,) and a.min() >= 0 and a.max() < m
    assert not np.any(a == 3)
    counts = np.bincount(a, minlength=m)
    assert counts[np.setdiff1d(np.arange(m), [3])].max() < 2.5 * (n / 63)
    jres = jh.sharded_hierarchical_assign(mj, *_j(obj, node, cap, alive), n_groups=g)
    _parity(jres, res, g, m)


def test_mesh_chunked_matches_flat_and_chunked_quality():
    """``tests/test_hierarchical.py:314``: per-node loads exact to cell
    granularity, dead nodes empty, no overflow, quality within 2% of a cost
    spread of the flat and the chunked solve; and against JAX."""
    n, d, m, g, chunks = 16384, 16, 64, 8, 2
    obj, node = _features(jax.random.PRNGKey(42), n, d, m)
    cap, alive = np.ones(m, np.float32), _vec(m, dead=[5, 50])
    mj, mt = _meshes()
    args = _t(obj, node, cap, alive)
    flat = hierarchical_assign(*args, n_groups=g)
    chunked = chunked_hierarchical_assign(*args, n_groups=g, n_chunks=chunks)
    composed = mesh_chunked_hierarchical_assign(mt, *args, n_groups=g, n_chunks=chunks)
    a = composed.assignment.numpy()
    assert a.shape == (n,) and a.min() >= 0 and a.max() < m
    assert not np.any(np.isin(a, [5, 50]))
    assert int(composed.overflow) == 0
    cf = np.bincount(flat.assignment.numpy(), minlength=m)
    assert np.abs(np.bincount(a, minlength=m) - cf).max() <= 8 * chunks
    on = obj @ node
    q_flat = on[np.arange(n), flat.assignment.numpy()].mean()
    q_chunk = on[np.arange(n), chunked.assignment.numpy()].mean()
    q_mesh = on[np.arange(n), a].mean()
    assert q_mesh >= q_flat - 0.02 * on.std() and q_mesh >= q_chunk - 0.02 * on.std()
    cg = composed.coarse_g.numpy()
    assert cg.shape == (g,) and np.isfinite(cg).all()
    jres = jh.mesh_chunked_hierarchical_assign(mj, *_j(obj, node, cap, alive), n_groups=g, n_chunks=chunks)
    _parity(jres, composed, g, m)


def test_mesh_chunked_survives_wide_cost_ranges():
    """``tests/test_hierarchical.py:368``: affinities scaled 1000x (range/eps
    >> 88, where a global shift underflows tail rows); and against JAX."""
    n, d, m, g, chunks = 8192, 16, 32, 4, 2
    obj, node = _features(jax.random.PRNGKey(3), n, d, m)
    obj = obj * np.float32(1e3)
    cap, alive = np.ones(m, np.float32), _vec(m, dead=[7])
    mj, mt = _meshes()
    res = mesh_chunked_hierarchical_assign(mt, *_t(obj, node, cap, alive), n_groups=g, n_chunks=chunks)
    a = res.assignment.numpy()
    assert not np.any(a == 7) and int(res.overflow) == 0
    counts = np.bincount(a, minlength=m)
    live = np.setdiff1d(np.arange(m), [7])
    fair = n / len(live)
    assert counts[live].min() >= 0.9 * fair and counts[live].max() <= 1.1 * fair
    flat = hierarchical_assign(*_t(obj, node, cap, alive), n_groups=g)
    on = obj @ node
    q_flat = on[np.arange(n), flat.assignment.numpy()].mean()
    assert on[np.arange(n), a].mean() >= q_flat - 0.02 * on.std()
    assert np.isfinite(res.coarse_g.numpy()).all()
    jres = jh.mesh_chunked_hierarchical_assign(mj, *_j(obj, node, cap, alive), n_groups=g, n_chunks=chunks)
    _parity(jres, res, g, m)


def test_mesh_chunked_timed_twin_matches_untimed_form_exactly():
    """``tests/test_hierarchical.py:402``: the timed form equals the untimed
    one and reports one wall time per slab; a warm re-solve from its
    potentials stays valid. (The reference's first-chunk >= rest checks its
    one-time compile, which eager PyTorch does not have.) And against JAX."""
    n, d, m, g, chunks = 2048, 8, 8, 4, 4
    obj, node = _features(jax.random.PRNGKey(7), n, d, m)
    cap, alive = np.ones(m, np.float32), _vec(m, dead=[3])
    mj, mt = _meshes()
    args = _t(obj, node, cap, alive)
    mapped = mesh_chunked_hierarchical_assign(mt, *args, n_groups=g, n_chunks=chunks)
    timed, chunk_ms = mesh_chunked_hierarchical_assign_timed(mt, *args, n_groups=g, n_chunks=chunks)
    _equal(mapped, timed)
    assert len(chunk_ms) == chunks and all(ms > 0.0 for ms in chunk_ms)
    timed2, _ = mesh_chunked_hierarchical_assign_timed(
        mt, *args, n_groups=g, n_chunks=chunks, coarse_g_init=timed.coarse_g
    )
    assert not np.any(timed2.assignment.numpy() == 3) and int(timed2.overflow) == 0
    jres, _ = jh.mesh_chunked_hierarchical_assign_timed(
        mj, *_j(obj, node, cap, alive), n_groups=g, n_chunks=chunks
    )
    _parity(jres, timed, g, m)


# ---------------------------------------- the cells are hierarchical_assign


def test_eight_shards_by_four_chunks_equal_the_32_chunk_solve():
    """Same rows per cell, same ``cap / 32``: equal row for row, and the
    coarse potentials of the last chunk of each shard average as expected."""
    n, d, m, g = 8192, 16, 64, 8
    obj, node = _features(jax.random.PRNGKey(9), n, d, m)
    args = _t(obj, node, np.ones(m, np.float32), _vec(m, dead=[1, 33]))
    mesh = make_mesh(["cpu"] * 8)
    composed, _ = mesh_chunked_hierarchical_assign_timed(mesh, *args, n_groups=g, n_chunks=4)
    single = chunked_hierarchical_assign(*args, n_groups=g, n_chunks=32)
    assert torch.equal(composed.assignment, single.assignment)
    assert torch.equal(composed.group, single.group)
    assert int(composed.overflow) == int(single.overflow) == 0
    # Each shard's last chunk is global chunk 4k + 3.
    lasts = [
        hierarchical_assign(args[0][q * 256 : (q + 1) * 256], args[1], args[2] / 32, args[3], n_groups=g)
        for q in (3, 7, 11, 15, 19, 23, 27, 31)
    ]
    mean = lasts[0].coarse_g
    for r in lasts[1:]:
        mean = mean + r.coarse_g
    assert torch.equal(composed.coarse_g, mean / 8)


def test_one_shard_mesh_equals_the_single_device_solve():
    n, d, m, g = 2048, 16, 32, 4
    obj, node = _features(jax.random.PRNGKey(12), n, d, m)
    args = _t(obj, node, np.ones(m, np.float32), _vec(m, dead=[6]))
    one = make_mesh(["cpu"])
    _equal(sharded_hierarchical_assign(one, *args, n_groups=g), hierarchical_assign(*args, n_groups=g))
    _equal(
        mesh_chunked_hierarchical_assign(one, *args, n_groups=g, n_chunks=4),
        chunked_hierarchical_assign(*args, n_groups=g, n_chunks=4),
    )


def test_sharded_rows_come_back_in_shard_order():
    """Every shard's rows are its own ``hierarchical_assign`` against
    ``cap / 8``, concatenated in shard order; overflow is their sum."""
    n, d, m, g = 1024, 8, 16, 4
    obj, node = _features(jax.random.PRNGKey(13), n, d, m)
    args = _t(obj, node, np.ones(m, np.float32), _vec(m, dead=[2]))
    mesh = make_mesh(["cpu"] * 8, obj_axis=2)
    res = sharded_hierarchical_assign(mesh, *args, n_groups=g, coarse_iters=8, fine_iters=8)
    parts = [
        hierarchical_assign(args[0][k * 128 : (k + 1) * 128], *args[1:], n_groups=g,
                            coarse_iters=8, fine_iters=8)
        for k in range(8)
    ]
    assert torch.equal(res.assignment, torch.cat([p.assignment for p in parts]))
    assert int(res.overflow) == sum(int(p.overflow) for p in parts)
