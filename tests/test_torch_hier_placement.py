"""TorchObjectPlacement's hierarchical paths against JaxObjectPlacement.

Each scenario runs on both providers through ``torch_placement_parity``'s
``run_both`` (mode strings, chunks, devices, solver_iters, warm ratio,
displaced and a delta's moved equal; seats agreeing on ``ROW_AGREEMENT``
of the objects; the coarse residual within ``RESIDUAL_TOL``):
``mode="hierarchical"`` full and delta solves, ``auto``
with an ``AffinityTracker``, the ``+hier_at_scale`` route of flat modes
(with ``_FLAT_REBALANCE_MAX_ROWS`` and ``_HIER_CHUNK_ROWS`` patched low in
both provider modules), the warm coarse seed across solves, and the
tracker's locality after a kill at 1,024 nodes. A pin keeps the known
waterfill tie at 700 objects in view. Then the two tests of
``tests/test_affinity_payoff.py`` on the port's provider, with the
reference's bars.
"""

import asyncio

import numpy as np
import pytest

pytest.importorskip("torch")

from rio_tpu.object_placement import jax_placement as jp  # noqa: E402

from rio_tpu_torch.object_placement import AffinityTracker  # noqa: E402
from rio_tpu_torch.object_placement import torch_placement as tp  # noqa: E402

from .torch_placement_parity import (  # noqa: E402
    JAX_API,
    TORCH_API,
    Member,
    members,
    run_both,
    snap_hier,
    undisplaced_moves,
)

N_NODES = 24  # three groups of eight


async def _seated(api, n_obj, **kw):
    p = api.make(node_axis_size=32, **kw)
    p.sync_members(members(N_NODES))
    await p.assign_batch([api.ObjectId("H", str(i)) for i in range(n_obj)])
    return p


def _dead_idx(p, dead):
    return {p._nodes[f"10.7.0.{i}:5000"].index for i in dead}


async def hierarchical_full_then_delta(api):
    p = await _seated(api, 900, mode="hierarchical")
    await p.rebalance(delta=False)
    assert p.stats.mode == "hierarchical"
    assert (p.stats.chunks, p.stats.devices, p.stats.solver_iters) == (1, 1, 60)
    assert p.stats.warm_ratio == 0.0 and 0.0 <= p.stats.residual < 0.05
    rec = [snap_hier(p)]
    before = dict(p._placements)
    dead = (4, 13)
    p.sync_members(members(N_NODES, dead=dead))
    await p.rebalance()
    assert p.stats.mode == "hierarchical+delta", p.stats.mode
    assert p.stats.moved == p.stats.displaced > 0
    counts = np.bincount(list(p._placements.values()), minlength=32)
    assert counts[sorted(_dead_idx(p, dead))].sum() == 0
    undisplaced = undisplaced_moves(before, p, _dead_idx(p, dead))
    rec.append(snap_hier(p, delta=True, undisplaced=undisplaced))
    return rec


async def hierarchical_delta_forced_through_the_array_path(api):
    p = await _seated(api, 700, mode="hierarchical")
    await p.rebalance(delta=False)
    # A node over its quota needs rank-based eviction, so the O(displaced)
    # fast path declines and the array delta runs the two-level solve.
    victim = f"10.7.0.{N_NODES - 1}:5000"
    for k in list(p._placements)[:60]:
        t, _, i = k.partition(".")
        await p.update(api.Item(api.ObjectId(t, i), victim))
    p.sync_members(members(N_NODES, dead=(2,)))
    await p.rebalance(delta=True)
    assert p.stats.mode == "hierarchical+delta"
    return [snap_hier(p, delta=True)]


async def auto_with_a_tracker_is_hierarchical(api):
    tracker = api.Tracker()
    p = await _seated(api, 640, affinity_tracker=tracker)
    for k, idx in list(p._placements.items())[::3]:
        for _ in range(4):
            tracker.observe(k, p._node_order[(idx + 5) % N_NODES])
    assert p._solver_mode() == "hierarchical"
    await p.rebalance(delta=False)
    assert p.stats.mode == "hierarchical"
    return [snap_hier(p)]


# The routed scenarios seat 704 objects (bucket 1024: 4 chunks of 256). At
# 700 the greedy waterfill of assign_batch puts a node boundary exactly on
# an object's half-integer position (3 x 700/24 = 87.5), and the port's and
# JAX's float32 cumsums round that tie to different nodes (ROADMAP queue C).


async def waterfill_at_700(api):
    p = api.make(node_axis_size=32, mode="sinkhorn")
    p.sync_members(members(N_NODES))
    await p.assign_batch([api.ObjectId("H", str(i)) for i in range(700)])
    return {k: p._node_order[i] for k, i in p._placements.items()}


def test_waterfill_tie_at_700_objects_is_the_known_divergence():
    """Pins the divergence of ROADMAP queue C: only objects whose waterfill
    position sits exactly on a node boundary (k x 700/24 a half-integer,
    k = 3, 9, 15, 21) may land apart, each one node over. When this fails
    because no seat differs, the tie rounds alike in both packages: drop
    this pin and the queue C entry, and let the routed scenarios seat 700."""
    want = asyncio.run(waterfill_at_700(JAX_API))
    got = asyncio.run(waterfill_at_700(TORCH_API))
    assert want.keys() == got.keys()
    differ = sorted(int(k.split(".")[1]) for k in want if want[k] != got[k])
    ties = {int(k * 700 / N_NODES) for k in (3, 9, 15, 21)}  # objects 87, 262, 437, 612
    assert differ, "the waterfill tie now rounds alike: retire this pin"
    assert set(differ) <= ties, differ
    node = {a.address: i for i, a in enumerate(members(N_NODES))}
    for i in differ:
        a, b = node[want[f"H.{i}"]], node[got[f"H.{i}"]]
        assert abs(a - b) == 1, (i, a, b)


async def routed_flat_rebalance(api):
    p = await _seated(api, 704, mode="sinkhorn", n_iters=20)
    await p.rebalance(delta=False)
    assert p.stats.mode == "sinkhorn+hier_at_scale", p.stats.mode
    assert (p.stats.chunks, p.stats.devices) == (4, 1) and len(p.stats.chunk_ms) == 4
    rec = [snap_hier(p)]
    before = dict(p._placements)
    dead = (1, 9, 17)
    p.sync_members(members(N_NODES, dead=dead))
    await p.rebalance(delta=False)
    assert p.stats.mode == "sinkhorn+hier_at_scale"
    counts = np.bincount(list(p._placements.values()), minlength=32)
    assert counts[sorted(_dead_idx(p, dead))].sum() == 0
    rec.append(snap_hier(p, undisplaced=undisplaced_moves(before, p, _dead_idx(p, dead))))
    return rec


async def routed_priced_rebalance(api):
    rng = np.random.default_rng(5)
    weights = rng.uniform(1.0, 16.0, 704).astype(np.float32)

    def prices(keys):
        return weights[[int(k.split(".")[1]) for k in keys]]

    p = await _seated(api, 704, mode="scaling", n_iters=20, object_costs=prices)
    p.sync_members(members(N_NODES, dead=(3,)))
    await p.rebalance(delta=False)
    assert p.stats.mode == "scaling+hier_at_scale"
    return [snap_hier(p)]


async def warm_coarse_seed_across_solves(api):
    p = await _seated(api, 800, mode="hierarchical")
    await p.rebalance(delta=False)
    first = snap_hier(p)
    seed = p._plan.coarse_g
    assert seed is not None and seed.shape == (N_NODES // 8,) and np.isfinite(seed).all()
    p.sync_members(members(N_NODES, dead=(20,)))
    await p.rebalance(delta=False)
    assert p.stats.mode == "hierarchical" and p.stats.warm_ratio == 1.0
    return [first, snap_hier(p)]


async def locality_at_1024_nodes(api):
    """``chip_smoke.py``'s ``hier_directory`` at 16,384 objects: a full
    solve, 3:1 home:secondary traffic on the objects of 30 nodes spread
    across groups, those nodes killed, and the delta's locality hits."""
    m, kill = 1024, 30
    tracker = api.Tracker()
    p = api.make(node_axis_size=m, affinity_tracker=tracker)
    addrs = [f"10.{i // 256}.{i % 256}.2:5000" for i in range(m)]
    p.sync_members([Member(a) for a in addrs])
    await p.assign_batch([api.ObjectId("HDir", str(i)) for i in range(16_384)])
    await p.rebalance(delta=False)
    homes = {5 + i * (m // kill) for i in range(kill)}
    survivors = [a for i, a in enumerate(addrs) if i not in homes]
    work = [k for k, j in p._placements.items() if j in homes]
    secondary = {k: survivors[(i * 7 + 3) % len(survivors)] for i, k in enumerate(work)}
    for k in work:
        for _ in range(4):
            for _ in range(3):
                tracker.observe(k, addrs[p._placements[k]])
            tracker.observe(k, secondary[k])
    p.sync_members([Member(a, i not in homes) for i, a in enumerate(addrs)])
    await p.rebalance()
    assert p.stats.mode == "hierarchical+delta"
    assert p.stats.moved == p.stats.displaced == len(work)
    hits = sum(p._node_order[p._placements[k]] == secondary[k] for k in work)
    # The card's bar; the 0.5 of the payoff test below holds at 12 survivors.
    assert hits / len(work) >= 10 / len(survivors), hits
    return [snap_hier(p, delta=True, hits=hits)]


def test_locality_at_1024_nodes_matches_the_reference():
    """The tracker's hit rate at 1,024 nodes is the reference's: both
    packages seat the displaced objects alike and hit their secondaries
    equally often (18 of 480 on this input, 37x chance)."""
    run_both(locality_at_1024_nodes)


def test_hierarchical_full_then_delta():
    run_both(hierarchical_full_then_delta)


def test_hierarchical_delta_through_the_array_path():
    run_both(hierarchical_delta_forced_through_the_array_path)


def test_auto_with_a_tracker_is_hierarchical():
    run_both(auto_with_a_tracker_is_hierarchical)


@pytest.fixture
def small_route(monkeypatch):
    for mod in (jp, tp):
        monkeypatch.setattr(mod, "_FLAT_REBALANCE_MAX_ROWS", 256)
        monkeypatch.setattr(mod, "_HIER_CHUNK_ROWS", 256)


def test_routed_flat_rebalance(small_route):
    run_both(routed_flat_rebalance)


def test_routed_priced_rebalance(small_route):
    run_both(routed_priced_rebalance)


def test_warm_coarse_seed_across_solves():
    run_both(warm_coarse_seed_across_solves)


def test_streamed_feature_block_equals_one_hook_call(monkeypatch):
    """Streaming the hook in key-chunks writes the same block, and a hook
    that returns NaN rows is sanitized to zeros."""
    p = TORCH_API.make(mode="hierarchical")
    keys = [f"K.{i}" for i in range(300)]
    whole = p._build_obj_feat(keys, 512, [], None, 0.0, None)
    monkeypatch.setattr(tp, "_OBJ_FEAT_STREAM_ROWS", 64)
    assert np.array_equal(p._build_obj_feat(keys, 512, [], None, 0.0, None).numpy(), whole.numpy())
    assert np.array_equal(whole[:300].numpy(), tp._hash_features(keys).numpy())

    def nan_hook(ks):
        out = np.ones((len(ks), 16), np.float32)
        out[::2] = np.nan
        return out

    q = TORCH_API.make(obj_features=nan_hook)
    block = q._build_obj_feat(keys[:10], 256, [], None, 0.0, None).numpy()
    assert np.isfinite(block).all() and (block[:10:2] == 0).all() and (block[1:10:2] == 1).all()


# ------------------------------- tests/test_affinity_payoff.py on the port

M = 16
PER_NODE = 30
N = M * PER_NODE
DEAD = [0, 1, 2, 3]


def _addr(i: int) -> str:
    return f"10.0.0.{i}:5000"


def _workload():
    survivors = [i for i in range(M) if i not in DEAD]
    out = []
    for i in range(N):
        home = i % M
        sec = survivors[(i * 7 + 3) % len(survivors)]
        if sec == home:
            sec = survivors[(i * 7 + 4) % len(survivors)]
        out.append((f"Obj.{i}", home, sec))
    return out


async def _seed(p, work) -> None:
    for key, home, _sec in work:
        t, _, i = key.partition(".")
        await p.update(TORCH_API.Item(TORCH_API.ObjectId(t, i), _addr(home)))


def _warm(tracker, work) -> None:
    for key, home, sec in work:
        for _ in range(4):
            for _ in range(3):
                tracker.observe(key, _addr(home))
            tracker.observe(key, _addr(sec))


def _kill(p) -> None:
    p.sync_members([f"{_addr(i)}" for i in range(M) if i not in DEAD])


def _metrics(p, work) -> dict:
    hits = cold = 0
    for key, home, sec in work:
        new = p._node_order[p._placements[key]]
        if home in DEAD:
            if new == _addr(sec):
                hits += 1
            elif new != _addr(home):
                cold += 1
        elif new != _addr(home):
            cold += 1
    displaced = sum(1 for _, home, _s in work if home in DEAD)
    return {"displaced": displaced, "hit_rate": hits / displaced, "cold_reloads": cold}


async def test_hierarchical_affinity_beats_flat_greedy_on_churn():
    work = _workload()
    pg = TORCH_API.make(node_axis_size=M, mode="greedy")
    for i in range(M):
        pg.register_node(_addr(i))
    await _seed(pg, work)
    _kill(pg)
    await pg.rebalance()
    mg = _metrics(pg, work)

    tracker = AffinityTracker()
    ph = TORCH_API.make(node_axis_size=M, affinity_tracker=tracker)
    for i in range(M):
        ph.register_node(_addr(i))
    await _seed(ph, work)
    _warm(tracker, work)
    _kill(ph)
    await ph.rebalance()
    mh = _metrics(ph, work)
    assert ph.stats.mode == "hierarchical", ph.stats.mode
    for m in (mg, mh):
        assert m["displaced"] == len(DEAD) * PER_NODE
    assert mh["hit_rate"] >= 3 * max(mg["hit_rate"], 1 / (M - len(DEAD))), (mh, mg)
    assert mh["hit_rate"] >= 0.5, mh
    assert mh["cold_reloads"] <= 0.6 * max(mg["cold_reloads"], 1), (mh, mg)
    keys = [k for k, _h, _s in work]

    def mean_score(p):
        of = tracker.obj_features(keys)
        nf = tracker.node_features([_addr(i) for i in range(M)])
        idx = np.asarray([p._placements[k] for k in keys])
        return float((of * nf[idx]).sum(axis=1).mean())

    assert mean_score(ph) > mean_score(pg) + 0.05, (mean_score(ph), mean_score(pg))
    loads = np.bincount(list(ph._placements.values()), minlength=M)
    assert loads[DEAD].sum() == 0
    assert loads.max() <= 1.5 * (N / (M - len(DEAD)))


async def test_auto_mode_without_signal_is_unchanged():
    p = TORCH_API.make(node_axis_size=M)
    for i in range(4):
        p.register_node(_addr(i))
    for i in range(64):
        await p.update(TORCH_API.Item(TORCH_API.ObjectId("T", str(i)), _addr(i % 4)))
    await p.rebalance()
    assert p.stats.mode == "greedy"
