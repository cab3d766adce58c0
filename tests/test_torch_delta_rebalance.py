"""Delta rebalances and solver telemetry: TorchObjectPlacement(device="cpu")
against JaxObjectPlacement, call for call.

The scenarios of ``tests/test_delta_rebalance.py`` and
``tests/test_solver_telemetry.py`` on the flat paths, with the comparison
of ``torch_placement_parity`` (mode strings, per-node counts, moved and
displaced exactly; the residual within 1e-4). Each churn step also
records the undisplaced moves (0) and the quadratic congestion against the
integer-quota ideal (``bench.py``'s transport-cost ratio, at most 1.05).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rio_tpu_torch.ops import integer_fair_quotas  # noqa: E402

from .torch_placement_parity import members, run_both, seats, snap, undisplaced_moves  # noqa: E402


async def _seeded(api, n_obj, n_nodes, **kw):
    """Provider with ``n_obj`` seated objects and a committed plan."""
    p = api.make(node_axis_size=n_nodes, **kw)
    p.sync_members(members(n_nodes))
    await p.assign_batch([api.ObjectId("T", str(i)) for i in range(n_obj)])
    await p.rebalance(delta=False)
    return p


def _cost_ratio(p, n_obj) -> float:
    """Quadratic congestion of the seating over the integer-quota ideal."""
    m = p._node_axis
    counts = np.asarray([len(p._by_node.get(i, ())) for i in range(m)], np.float64)
    cap_alive = np.zeros(m)
    for s in p._nodes.values():
        cap_alive[s.index] = s.capacity if (s.alive and not s.cordoned) else 0.0
    quota = integer_fair_quotas(cap_alive, n_obj).astype(np.float64)
    safe = np.maximum(cap_alive, 1e-9)
    return float(np.sum(counts**2 / safe)) / float(np.sum(quota**2 / safe))


def _dead_idx(p, dead):
    return {p._nodes[members(p._node_axis)[i].address].index for i in dead}


async def _churn(p, n_obj, dead, **kw):
    """Kill ``dead``, rebalance, return the record of the step."""
    before = seats(p)
    p.sync_members(members(p._node_axis, dead=dead))
    moved = await p.rebalance(**kw)
    ratio = _cost_ratio(p, n_obj)
    assert ratio <= 1.05
    und = undisplaced_moves(before, p, _dead_idx(p, dead))
    return snap(p, returned=moved, undisplaced=und, ratio=round(ratio, 9))


@pytest.mark.parametrize("mode", ["sinkhorn", "scaling", "greedy"])
def test_delta_moves_exactly_the_displaced_set(mode):
    async def scenario(api):
        p = await _seeded(api, 512, 8, mode=mode)
        rec = [snap(p)]
        pre = seats(p)
        step = await _churn(p, 512, {0})
        assert step["mode"] == f"{mode}+delta"
        assert step["displaced"] == sum(1 for v in pre.values() if v == 0)
        assert step["returned"] == step["displaced"] and step["undisplaced"] == 0
        assert len(p._by_node.get(0, ())) == 0
        return rec + [step]

    run_both(scenario)


async def delta_cost_parity_with_full(api):
    rec = []
    for delta in (True, False):
        p = await _seeded(api, 600, 6, mode="sinkhorn")
        rec.append(await _churn(p, 600, {1}, delta=delta))
    assert rec[0]["counts"] == rec[1]["counts"]  # both land on the integer quotas
    return rec


async def threshold_routes_big_events_to_full(api):
    p = await _seeded(api, 300, 3, mode="sinkhorn", delta_threshold=0.10)
    step = await _churn(p, 300, {0})  # ~33% displaced > 10%
    assert "+delta" not in step["mode"] and p._plan.delta_solves == 0
    return [step]


async def threshold_zero_disables_deltas(api):
    p = await _seeded(api, 256, 8, mode="sinkhorn", delta_threshold=0.0)
    step = await _churn(p, 256, {0})
    assert "+delta" not in step["mode"]
    return [step]


async def delta_true_and_false_override(api):
    p = await _seeded(api, 300, 3, mode="sinkhorn", delta_threshold=0.0)
    forced = await _churn(p, 300, {0}, delta=True)
    assert forced["mode"] == "sinkhorn+delta" and forced["returned"] == forced["displaced"] > 0
    full = await _churn(p, 300, {0, 1}, delta=False)
    assert "+delta" not in full["mode"]
    return [forced, full]


async def max_delta_solves_forces_full(api):
    p = await _seeded(api, 512, 8, mode="sinkhorn", max_delta_solves=1)
    first = await _churn(p, 512, {0})
    assert first["mode"] == "sinkhorn+delta" and p._plan.delta_solves == 1
    second = await _churn(p, 512, {0, 1})
    assert "+delta" not in second["mode"] and p._plan.delta_solves == 0
    return [first, second]


async def tripped_audit_marks_plan_stale(api):
    p = await _seeded(api, 512, 8, mode="sinkhorn", delta_audit_ratio=0.5)
    first = await _churn(p, 512, {0})
    assert first["mode"] == "sinkhorn+delta" and p._plan.stale
    second = await _churn(p, 512, {0, 1})
    assert "+delta" not in second["mode"] and not p._plan.stale
    return [first, second]


async def epoch_discard_mid_delta(api):
    p = await _seeded(api, 512, 8, mode="sinkhorn")
    plan_before = p._plan
    p.sync_members(members(8, dead={0}))
    pre = seats(p)
    real_refresh = p._class_refresh

    def racing_refresh(*a, **kw):
        p._epoch += 1  # churn lands while the solver thread runs
        return real_refresh(*a, **kw)

    p._class_refresh = racing_refresh
    assert await p.rebalance() == 0
    assert p.stats.discarded and p.stats.mode == "sinkhorn+delta"
    assert seats(p) == pre and p._plan is plan_before
    rec = [snap(p)]
    p._class_refresh = real_refresh
    moved = await p.rebalance()
    assert not p.stats.discarded and moved > 0
    return rec + [snap(p)]


async def outage_then_recovery(api):
    p = await _seeded(api, 256, 4, mode="sinkhorn")
    pre = seats(p)
    p.sync_members(members(4, dead={0, 1, 2, 3}))
    assert await p.rebalance() == 0
    assert p.stats.mode.endswith("+no_capacity") and seats(p) == pre
    rec = [snap(p)]
    p.sync_members(members(4))
    await p.rebalance()
    assert not p.stats.mode.endswith("+no_capacity")
    assert _cost_ratio(p, 256) <= 1.05
    return rec + [snap(p)]


async def node_return_rebalances_overflow(api):
    p = await _seeded(api, 400, 4, mode="sinkhorn")
    first = await _churn(p, 400, {0})
    pre = seats(p)
    p.sync_members(members(4))  # node 0 comes back
    moved = await p.rebalance()
    assert "+delta" in p.stats.mode and moved == p.stats.displaced <= 110
    assert len(p._by_node.get(0, ())) > 0
    return [first, snap(p, undisplaced_kept=sum(1 for k, v in pre.items() if p._placements[k] == v))]


async def successive_deltas_stay_quota_exact(api):
    p = await _seeded(api, 2000, 16, mode="sinkhorn")
    rec = []
    dead: set[int] = set()
    for node in (3, 7, 11):
        dead.add(node)
        step = await _churn(p, 2000, set(dead))
        assert step["mode"] == "sinkhorn+delta" and step["undisplaced"] == 0
        assert step["ratio"] == 1.0
        rec.append(step)
    return rec


async def priced_objects_take_the_dense_path(api):
    """Non-uniform ``object_costs`` break the class collapse: the full
    solve is the dense one, and a quota-pressure delta evicts cold objects
    first (hot ones rank first in their node)."""
    weights = np.random.default_rng(5).uniform(1.0, 16.0, 600).astype(np.float32)

    def prices(keys):
        return weights[[int(k.split(".", 1)[1]) for k in keys]]

    rec = []
    for mode in ("sinkhorn", "scaling"):
        p = await _seeded(api, 600, 6, mode=mode, object_costs=prices)
        rec.append(snap(p))
        assert p.stats.mode == mode
        rec.append(await _churn(p, 600, {2}, delta=False))
        assert rec[-1]["mode"] == mode
    return rec


async def telemetry_records_convergence(api):
    rec = []
    for mode in ("sinkhorn", "scaling"):
        p = await _seeded(api, 256, 4, mode=mode, n_iters=12)
        s = p.stats
        assert s.mode == f"{mode}+collapsed" and s.solver_iters == 12
        assert 0.0 <= s.residual < 1e-2 and s.warm_ratio <= 0.0
        rec.append(snap(p))
    p = await _seeded(api, 512, 8, mode="sinkhorn", n_iters=12)
    step = await _churn(p, 512, {0})
    assert step["mode"] == "sinkhorn+delta" and 0.0 <= p.stats.warm_ratio <= 1.0
    assert p.stats.residual >= 0.0
    gauges = p.stats.history_gauges()
    assert gauges["rio.placement_solve.history.residual_max"] >= gauges[
        "rio.placement_solve.history.residual_last"
    ] >= 0.0
    assert gauges["rio.placement_solve.history.delta_fraction"] > 0.0
    rec.append(step)
    g = await _seeded(api, 128, 4, mode="greedy")
    assert g.stats.solver_iters == 0 and g.stats.residual == -1.0
    rec.append(snap(g))
    return rec


SCENARIOS = {
    "delta_cost_parity_with_full": delta_cost_parity_with_full,
    "threshold_routes_big_events_to_full": threshold_routes_big_events_to_full,
    "threshold_zero_disables_deltas": threshold_zero_disables_deltas,
    "delta_true_and_false_override": delta_true_and_false_override,
    "max_delta_solves_forces_full": max_delta_solves_forces_full,
    "tripped_audit_marks_plan_stale": tripped_audit_marks_plan_stale,
    "epoch_discard_mid_delta": epoch_discard_mid_delta,
    "outage_then_recovery": outage_then_recovery,
    "node_return_rebalances_overflow": node_return_rebalances_overflow,
    "successive_deltas_stay_quota_exact": successive_deltas_stay_quota_exact,
    "priced_objects_take_the_dense_path": priced_objects_take_the_dense_path,
    "telemetry_records_convergence": telemetry_records_convergence,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name):
    run_both(SCENARIOS[name])


def test_torch_compile_split_reads_unobserved():
    async def scenario(api):
        p = await _seeded(api, 256, 4, mode="sinkhorn")
        return p.stats

    import asyncio

    from .torch_placement_parity import TORCH_API

    stats = asyncio.run(scenario(TORCH_API))
    assert stats.compile_ms == -1.0 and stats.exec_ms == -1.0
