"""TorchObjectPlacement(device="cpu") against JaxObjectPlacement, call for call.

Each scenario of ``tests/test_jax_placement.py`` on the flat paths runs on
both providers with the same call sequence; ``torch_placement_parity``
states what is compared and with which tolerance (mode strings, per-node
counts, moved and displaced exactly; the residual within 1e-4). The
scenario's own assertions (the JAX tests' contracts) run on both.
"""

import asyncio
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rio_tpu import ObjectId as JaxObjectId  # noqa: E402
from rio_tpu import ObjectPlacementItem as JaxItem  # noqa: E402
from rio_tpu.cluster.storage import Member as RioMember  # noqa: E402
from rio_tpu.object_placement import jax_placement as jp  # noqa: E402

from rio_tpu_torch.object_placement import torch_placement as tp  # noqa: E402
from rio_tpu_torch.object_placement.torch_placement import (  # noqa: E402
    TorchObjectPlacement,
    _least_loaded_spread,
)

from .torch_placement_parity import (  # noqa: E402
    JAX_API,
    TORCH_API,
    Member,
    counts_by_address,
    members,
    run_both,
    seats,
    snap,
    snap_hier,
    undisplaced_moves,
)


def _provider(api, nodes=4, **kw):
    p = api.make(node_axis_size=16, **kw)
    for i in range(nodes):
        p.register_node(f"10.0.0.{i}:5000")
    return p


# --------------------------------------------------------------- scenarios


async def crud(api):
    p = _provider(api)
    oid = api.ObjectId("MetricAggregator", "instance-1")
    rec = [await p.lookup(oid)]
    await p.update(api.Item(oid, "10.0.0.1:5000"))
    rec.append(await p.lookup(oid))
    await p.update(api.Item(oid, "10.0.0.2:5000"))  # upsert
    rec.append(await p.lookup(oid))
    await p.remove(oid)
    rec.append(await p.lookup(oid))
    a, b = api.ObjectId("T", "a"), api.ObjectId("T", "b")
    await p.update(api.Item(a, "10.0.0.1:5000"))
    await p.update(api.Item(b, "10.0.0.2:5000"))
    await p.clean_server("10.0.0.1:5000")
    rec += [await p.lookup(a), await p.lookup(b), p.count()]
    assert rec == [None, "10.0.0.1:5000", "10.0.0.2:5000", None, None, "10.0.0.2:5000", 1]
    # Replica rows: set, read, CAS-promote, stale CAS refused.
    assert await p.set_standbys(b, ["10.0.0.3:5000", "10.0.0.0:5000"]) == 0
    assert await p.standbys(b) == (["10.0.0.3:5000", "10.0.0.0:5000"], 0)
    assert await p.promote_standby(b, "10.0.0.3:5000", 0) == 1
    assert await p.promote_standby(b, "10.0.0.0:5000", 0) is None
    rec += [await p.lookup(b), await p.standbys(b)]
    return [{"lookups": rec}]


async def assign_spread_sticky(api):
    p = _provider(api, nodes=4)
    oids = [api.ObjectId("Game", str(i)) for i in range(400)]
    addrs = await p.assign_batch(oids)
    counts = counts_by_address(p)
    assert len(counts) == 4 and max(counts.values()) <= 200
    assert await p.assign_batch(oids) == addrs  # sticky
    assert p.count() == 400
    return [{"addrs": addrs, "counts": counts}]


async def assign_avoids_dead(api):
    p = _provider(api, nodes=4)
    p.sync_members(members(4, dead={2}, prefix="10.0.0"))
    addrs = await p.assign_batch([api.ObjectId("T", str(i)) for i in range(100)])
    assert "10.0.0.2:5000" not in addrs
    return [{"addrs": addrs}]


async def real_member_objects(api):
    # Member.address is a property of rio_tpu's Member, not a method.
    p = _provider(api, nodes=0)
    p.sync_members([RioMember.from_address(f"10.1.0.{i}:5000", active=(i != 1)) for i in range(3)])
    assert p._nodes["10.1.0.1:5000"].alive is False
    addrs = await p.assign_batch([api.ObjectId("T", str(i)) for i in range(40)])
    assert set(addrs) == {"10.1.0.0:5000", "10.1.0.2:5000"}
    return [{"addrs": addrs}]


@pytest.mark.parametrize("mode,n,node", [("sinkhorn", 200, 0), ("greedy", 128, 3), ("scaling", 200, 1)])
def test_rebalance_levels_skew(mode, n, node):
    async def scenario(api):
        p = _provider(api, nodes=4)
        for i in range(n):
            await p.update(api.Item(api.ObjectId("T", str(i)), f"10.0.0.{node}:5000"))
        moved = await p.rebalance(mode=mode)
        assert moved > 0 and p.stats.n_objects == n and p.stats.solve_ms > 0
        assert max(counts_by_address(p).values()) <= 2 * n / 4
        return [snap(p)]

    run_both(scenario)


async def warm_potentials(api):
    p = _provider(api, nodes=4)
    await p.assign_batch([api.ObjectId("T", str(i)) for i in range(64)])
    await p.rebalance(mode="sinkhorn")
    g = p._g
    assert g is not None
    rec = [snap(p)]
    ms = [Member(f"10.0.0.{i}:5000") for i in range(4)]
    p.sync_members(ms)  # no liveness change
    assert p._g is g
    p.sync_members(ms + [Member("10.0.0.9:5000")])  # additive join
    assert p._g is g
    # New arrivals take the cached-potentials path.
    addrs = await p.assign_batch([api.ObjectId("U", str(i)) for i in range(32)])
    rec.append({"addrs": addrs, "counts": counts_by_address(p)})
    p.sync_members([Member(f"10.0.0.{i}:5000", active=(i != 2)) for i in range(5)])
    assert p._g is None  # a solved-over node left the schedulable set
    await p.rebalance(mode="sinkhorn")
    assert p._g is not None
    rec.append(snap(p))
    p.cordon("10.0.0.1:5000")
    assert p._g is None
    return rec


async def node_axis_grows(api):
    p = api.make(node_axis_size=2)
    for i in range(5):
        p.register_node(f"10.0.1.{i}:5000")
    addrs = await p.assign_batch([api.ObjectId("T", str(i)) for i in range(50)])
    assert len(set(addrs)) == 5 and p._node_axis == 8
    return [{"addrs": addrs}]


async def exact_capacity_minimal_churn(api, delta):
    n_nodes, n_objects = 20, 2000
    p = api.make(mode="sinkhorn")
    for i in range(n_nodes):
        p.register_node(f"10.0.0.{i}:50")
    ids = [api.ObjectId("T", str(i)) for i in range(n_objects)]
    await p.assign_batch(ids)
    await p.rebalance()
    rec = [snap(p)]
    before = seats(p)
    p.sync_members([Member(f"10.0.0.{i}:50", active=i >= 2) for i in range(n_nodes)])
    displaced = sum(1 for v in before.values() if v < 2)
    moved = await p.rebalance(delta=delta)
    assert moved == displaced == p.stats.moved
    assert undisplaced_moves(before, p, {0, 1}) == 0
    loads = np.bincount(list(p._placements.values()), minlength=n_nodes)
    assert loads[:2].sum() == 0 and int(loads[2:].max()) - int(loads[2:].min()) <= 1
    rec.append(snap(p, undisplaced=undisplaced_moves(before, p, {0, 1})))
    return rec


async def second_rebalance_stationary(api):
    p = _provider(api, nodes=8)
    await p.assign_batch([api.ObjectId("T", str(i)) for i in range(800)])
    await p.rebalance()
    first = snap(p)
    moved = await p.rebalance()
    assert moved <= 800 // 50
    return [first, snap(p)]


async def collapsed_solve(api):
    m, n = 64, 20_000
    p = api.make(mode="sinkhorn")
    for i in range(m):
        p.register_node(f"10.0.{i // 16}.{i % 16}:50")
    cur = np.random.default_rng(3).integers(0, m, n)
    for i, idx in enumerate(cur):
        p._set_placement(f"T.{i}", int(idx))
    p._recount_loads()
    before = seats(p)
    p.sync_members([Member(f"10.0.{i // 16}.{i % 16}:50", active=i >= 6) for i in range(m)])
    displaced = int((cur < 6).sum())
    moved = await p.rebalance()
    assert p.stats.mode == "sinkhorn+collapsed"
    assert displaced <= moved <= displaced + m
    loads = np.bincount(list(p._placements.values()), minlength=p._node_axis)
    assert loads[:6].sum() == 0 and int(loads[6:m].max()) - int(loads[6:m].min()) <= 1
    return [snap(p, undisplaced=undisplaced_moves(before, p, set(range(6))))]


async def cordon_drain(api):
    p = api.make(mode="greedy", move_cost=0.5)
    p.sync_members([f"10.6.0.{i}:70" for i in range(4)])
    ids = [api.ObjectId("D", str(i)) for i in range(400)]
    await p.assign_batch(ids)
    victim = await p.lookup(ids[0])
    p.cordon(victim)
    assert p.cordoned == {victim}
    where_new = await p.assign_batch([api.ObjectId("D", f"n{i}") for i in range(60)])
    assert victim not in where_new
    assert await p.lookup(ids[0]) == victim  # keeps serving
    await p.rebalance()
    assert victim not in await p.lookup_batch(ids)
    rec = [snap(p, victim=victim, where_new=where_new)]
    p.uncordon(victim)
    refill = await p.assign_batch([api.ObjectId("D", f"m{i}") for i in range(200)])
    assert victim in refill
    with pytest.raises(KeyError):
        p.cordon("10.6.9.9:70")
    rec.append({"refill": refill, "counts": counts_by_address(p)})
    return rec


async def every_node_dead(api):
    p = api.make(mode="greedy", move_cost=0.5)
    ms = [f"10.9.0.{i}:70" for i in range(6)]
    p.sync_members(ms)
    ids = [api.ObjectId("Dead", str(i)) for i in range(40)]
    await p.assign_batch(ids[:10])
    for a in ms:
        await p.clean_server(a)  # every node dead, loads zeroed
    addrs = await p.assign_batch(ids[10:])
    assert len(set(addrs)) == len(ms)  # spread over real nodes
    await p.rebalance()
    rec = [snap(p, addrs=addrs)]
    p.sync_members(ms)
    await p.rebalance()
    assert all(a in ms for a in await p.lookup_batch(ids[10:]))
    rec.append(snap(p))
    return rec


async def gossip_blip_all_dead(api):
    p = api.make(mode="sinkhorn", n_iters=8, move_cost=0.5)
    ms = [f"10.9.1.{i}:70" for i in range(6)]
    p.sync_members(ms)
    ids = [api.ObjectId("Blip", str(i)) for i in range(36)]
    await p.assign_batch(ids[:12])
    before = seats(p)
    p.sync_members([Member(a, active=False) for a in ms])
    addrs = await p.assign_batch(ids[12:])
    assert len(set(addrs)) == len(ms)
    assert await p.rebalance() == 0
    assert p.stats.mode == "sinkhorn+no_capacity"
    assert all(p._placements[k] == v for k, v in before.items())
    rec = [snap(p, addrs=addrs)]
    p.sync_members(ms)
    await p.rebalance()
    assert not p.stats.mode.endswith("+no_capacity")
    rec.append(snap(p))
    return rec


async def stats_history(api):
    p = api.make(mode="greedy")
    p.sync_members([f"10.2.0.{i}:80" for i in range(4)])
    await p.assign_batch([api.ObjectId("Hist", str(i)) for i in range(200)])
    await p.rebalance()
    first_epoch = p.stats.epoch
    assert p.stats.history == []
    await p.rebalance()
    hist = p.stats.history
    assert [h.epoch for h in hist] == [first_epoch] and hist[0].history == []
    gauges = p.stats.history_gauges()
    return [snap(p, epochs=[h.epoch for h in hist], gauge_names=sorted(g for g in gauges if "compile" not in g))]


async def move_sink_plans(api):
    p = api.make(node_axis_size=8, mode="sinkhorn")
    p.sync_members(members(8))
    await p.assign_batch([api.ObjectId("T", str(i)) for i in range(512)])
    await p.rebalance(delta=False)
    before = seats(p)
    planned_runs = []

    async def sink(planned):
        planned_runs.append(list(planned))
        for key, _src, dst in planned:  # the coordinator's handoff commits
            await p.update(api.Item(api.ObjectId(*key.split(".", 1)), dst))
        return len(planned)

    p.sync_members(members(8, dead={3}))
    moved = await p.rebalance(move_sink=sink)
    (planned,) = planned_runs
    assert moved == len(planned) == sum(1 for v in before.values() if v == 3)
    assert planned == sorted(planned, key=lambda mv: (mv[1], mv[2]))
    assert all(src == "10.7.0.3:5000" for _, src, _ in planned)
    rec = [snap(p, planned=sorted((s, d) for _, s, d in planned))]
    # A full solve plans through the sink too.
    p.sync_members(members(8, dead={3, 5}))
    await p.rebalance(delta=False, move_sink=sink)
    rec.append(snap(p, planned=sorted((s, d) for _, s, d in planned_runs[-1])))
    return rec


async def standby_seats(api):
    """``assign_standbys`` (multi_seat_plan) on the same seating: identical
    rows, none on its primary, every seat on a live node."""
    p = api.make(mode="greedy", node_axis_size=8)
    p.sync_members(members(8, dead={6}))
    ids = [api.ObjectId("R", str(i)) for i in range(300)]
    for i, oid in enumerate(ids):
        await p.update(api.Item(oid, f"10.7.0.{(i * 5) % 8 if (i * 5) % 8 != 6 else 0}:5000"))
    rows = await p.assign_standbys(ids, k=2)
    live = {f"10.7.0.{i}:5000" for i in range(8) if i != 6}
    for oid, row in zip(ids, rows):
        assert len(row) == 2 and len(set(row)) == 2
        assert await p.lookup(oid) not in row and set(row) <= live
    return [{"rows": rows}]


SCENARIOS = {
    "standby_seats": standby_seats,
    "crud": crud,
    "assign_spread_sticky": assign_spread_sticky,
    "assign_avoids_dead": assign_avoids_dead,
    "real_member_objects": real_member_objects,
    "warm_potentials": warm_potentials,
    "node_axis_grows": node_axis_grows,
    "exact_capacity_minimal_churn_delta": lambda api: exact_capacity_minimal_churn(api, None),
    "exact_capacity_minimal_churn_full": lambda api: exact_capacity_minimal_churn(api, False),
    "second_rebalance_stationary": second_rebalance_stationary,
    "collapsed_solve": collapsed_solve,
    "cordon_drain": cordon_drain,
    "every_node_dead": every_node_dead,
    "gossip_blip_all_dead": gossip_blip_all_dead,
    "stats_history": stats_history,
    "move_sink_plans": move_sink_plans,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name):
    run_both(SCENARIOS[name])


# ------------------------------------------------------------ single-sided


@pytest.mark.parametrize("api", [JAX_API, TORCH_API], ids=lambda a: a.name)
async def test_assign_batch_empty_cluster_raises_no_schedulable_capacity(api):
    p = api.make(node_axis_size=16)
    with pytest.raises(api.NoSchedulableCapacity, match="register_node"):
        await p.assign_batch([api.ObjectId("Game", "g0")])
    assert issubclass(api.NoSchedulableCapacity, ValueError)


async def test_rio_tpu_ids_and_items_are_accepted():
    """The Server hands the provider rio_tpu's ObjectId and items."""
    p = _provider(TORCH_API)
    oid = JaxObjectId("T", "x")
    await p.update(JaxItem(oid, "10.0.0.3:5000"))
    assert await p.lookup(oid) == "10.0.0.3:5000"
    assert await p.lookup(TORCH_API.ObjectId("T", "x")) == "10.0.0.3:5000"
    assert (await p.assign_batch([JaxObjectId("T", "y")]))[0].startswith("10.0.0.")


async def test_standbys_never_share_the_primary_and_sit_on_live_nodes():
    p = TORCH_API.make(mode="greedy", node_axis_size=8)
    p.sync_members(members(8, dead={6}))
    ids = [TORCH_API.ObjectId("R", str(i)) for i in range(300)]
    await p.assign_batch(ids)
    rows = await p.assign_standbys(ids, k=2)
    live = {f"10.7.0.{i}:5000" for i in range(8) if i != 6}
    for oid, row in zip(ids, rows):
        primary = await p.lookup(oid)
        assert len(row) == 2 and len(set(row)) == 2
        assert primary not in row and set(row) <= live


@pytest.mark.parametrize("m", [1, 7, 64, 130])
def test_unique_rows_equals_numpy_unique_along_rows(m):
    """multi_seat_plan's packed-row classes: the classes and the inverse of
    ``np.unique(axis=0)``, row order included."""
    rng = np.random.default_rng(m)
    taken = rng.random((500, m)) < 0.02
    taken[::3] = taken[1::3][: taken[::3].shape[0]]  # repeated rows
    classes, inverse = tp._unique_rows(taken)
    ref_classes, ref_inverse = np.unique(taken, axis=0, return_inverse=True)
    assert np.array_equal(classes, ref_classes)
    assert np.array_equal(inverse, ref_inverse.reshape(-1))


def test_least_loaded_spread_prefers_schedulable_prefix():
    load = np.array([5, 0, 3, 1], np.float32)
    alive = np.array([1, 0, 1, 1], np.float32)
    cap = np.ones(4, np.float32)
    out = _least_loaded_spread(load, alive, cap, 4, 7)
    assert 1 not in out.tolist() and out[0] == 3
    cap0 = np.array([1, 1, 1, 0], np.float32)
    out = _least_loaded_spread(load, alive, cap0, 4, 7)
    assert 3 not in out.tolist() and 1 not in out.tolist()
    out = _least_loaded_spread(load, np.zeros(4, np.float32), cap, 4, 8)
    assert sorted(set(out.tolist())) == [0, 1, 2, 3]


async def test_assign_batch_releases_lock_between_chunks(monkeypatch):
    """A locked mutator queued during chunk 0 runs before the batch ends,
    and the final pass re-places the key it removed."""
    p = TORCH_API.make(mode="greedy")
    p.sync_members([f"10.5.0.{i}:70" for i in range(4)])
    chunk0_done = asyncio.Event()
    state = {"batch_done": False, "removed_mid_batch": None}
    orig = TorchObjectPlacement._place_chunk_locked

    async def chunk_and_signal(self, chunk):
        await orig(self, chunk)
        if not chunk0_done.is_set():
            chunk0_done.set()
            for _ in range(5):
                await asyncio.sleep(0)

    ids = [TORCH_API.ObjectId("Big", str(i)) for i in range(4000)]

    async def mutator():
        await chunk0_done.wait()
        await p.remove(ids[3])
        state["removed_mid_batch"] = not state["batch_done"]

    monkeypatch.setattr(TorchObjectPlacement, "_MAX_PLACE_CHUNK", 512)
    monkeypatch.setattr(TorchObjectPlacement, "_place_chunk_locked", chunk_and_signal)
    task = asyncio.create_task(mutator())
    where = await p.assign_batch(ids)
    state["batch_done"] = True
    await asyncio.wait_for(task, 30)
    assert state["removed_mid_batch"] is True
    assert all(w is not None for w in await p.lookup_batch(ids))
    assert len(where) == len(ids)


def test_auto_mode_is_greedy_on_the_cpu():
    p = TORCH_API.make()
    assert p._solver_mode() == "greedy"


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchObjectPlacement()


# ------------------------- options of later slices, and those now ported


def _key_features(keys):
    """A deterministic (n, 16) feature hook, the same for both providers."""
    return np.stack([
        np.random.default_rng(zlib.crc32(k.encode())).normal(size=16).astype(np.float32)
        for k in keys
    ]) if keys else np.zeros((0, 16), np.float32)


async def _option_scenario(api, kw):
    p = api.make(node_axis_size=16, **kw)
    p.sync_members([f"10.33.0.{i}:70" for i in range(16)])
    await p.assign_batch([api.ObjectId("Opt", str(i)) for i in range(320)])
    # Chatty pairs: read only with affinity_weight > 0.
    p.set_edge_graph([[f"Opt.{i}", f"Opt.{i + 160}", 1e6, 10.0, 0.0] for i in range(40)])
    await p.rebalance(delta=False)
    want = "hierarchical+affinity" if kw.get("affinity_weight") else "hierarchical"
    assert p.stats.mode == want, p.stats.mode
    return [snap_hier(p, history=[(h["pass"], h["accepted"]) for h in p._affinity_history])]


@pytest.mark.parametrize(
    "kw",
    [
        lambda api: {"mode": "hierarchical"},
        lambda api: {"obj_features": _key_features},
        lambda api: {"node_features": _key_features},
        lambda api: {"affinity_tracker": api.Tracker()},
        lambda api: {"mode": "hierarchical", "mesh": api.mesh()},
        lambda api: {"mode": "hierarchical", "affinity_weight": 2.0},
    ],
    ids=["hierarchical", "obj_features", "node_features", "affinity_tracker", "mesh", "affinity_weight"],
)
def test_later_slice_options_raise(kw):
    """No option of a later slice raises any more. The hierarchical mode,
    feature hooks and a tracker (A.7, A.9), the affinity refine (A.8) and a
    mesh (A.11: 8 shards, devices 8) each run a full solve in mode
    "hierarchical" (with the refine, "hierarchical+affinity" and its pass
    history) matching JAX."""
    run_both(lambda api: _option_scenario(api, kw(api)))


def test_rebalance_mode_hierarchical_raises():
    """``rebalance(mode="hierarchical")`` on a flat-mode provider now runs
    the two-level solve over hashed-identity features, as JAX's does."""

    async def scenario(api):
        p = _provider(api)
        await p.assign_batch([api.ObjectId("T", str(i)) for i in range(200)])
        await p.rebalance(mode="hierarchical")
        assert p.stats.mode == "hierarchical" and p.stats.chunks == 1
        return [snap_hier(p)]

    run_both(scenario)


def test_flat_rebalance_above_the_row_bound_raises(monkeypatch):
    """Above the row bound both providers route a flat rebalance through
    the hierarchical solve ("sinkhorn+hier_at_scale"); below it, the
    collapsed solve runs."""
    for mod in (jp, tp):
        monkeypatch.setattr(mod, "_FLAT_REBALANCE_MAX_ROWS", 256)

    async def scenario(api):
        p = api.make(mode="sinkhorn", n_iters=10)
        p.sync_members([f"10.32.0.{i}:70" for i in range(5)])
        await p.assign_batch([api.ObjectId("Big", str(i)) for i in range(700)])  # bucket 1024
        await p.rebalance()
        assert p.stats.mode == "sinkhorn+hier_at_scale"
        assert (p.stats.chunks, p.stats.devices) == (1, 1)
        rec = [snap_hier(p)]
        api.module._FLAT_REBALANCE_MAX_ROWS = 1 << 20
        await p.rebalance(delta=False)
        assert p.stats.mode == "sinkhorn+collapsed"
        api.module._FLAT_REBALANCE_MAX_ROWS = 256
        return rec + [snap_hier(p)]

    run_both(scenario)
