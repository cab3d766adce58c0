"""The affinity refine of TorchObjectPlacement against JaxObjectPlacement's.

Each scenario runs on both providers through ``torch_placement_parity``
and returns one record per solve it compares, with the refine's pass
history beside the solve's ``snap``:

- the four refine scenarios of ``tests/test_affinity_edges.py`` (toy
  graphs on two nodes): seats, mode strings, moved and accepted flags
  exactly equal, ``cut``/``total`` within ``TOL_TOY``;
- the refine after the hierarchical solve, after a routed
  ``+hier_at_scale`` rebalance, after greedy, after the dense priced solve
  and after the collapsed solve on a 1,024-node graph over 16,384 objects:
  accepted flags equal, ``cut``/``total`` within ``TOL_GRAPH``, seats
  agreeing on ``ROW_AGREEMENT`` of the objects (``snap_hier``).

Then the two pieces the port computes another way than the reference
(the attraction as a matrix product, the mover truncation as one sort),
each against a literal copy of the reference's code, and
``measure_affinity_payoff`` run on the port's provider.
"""

import asyncio

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rio_tpu.object_placement import jax_placement as jp  # noqa: E402
from rio_tpu.utils import affinity_live  # noqa: E402

from rio_tpu_torch.object_placement import TorchObjectPlacement  # noqa: E402
from rio_tpu_torch.object_placement import torch_placement as tp  # noqa: E402

from .torch_placement_parity import (  # noqa: E402
    JAX_API,
    TORCH_API,
    Member,
    assert_same,
    snap,
    snap_hier,
)

TOL_TOY = 1e-6
TOL_GRAPH = 1e-5

N0 = "10.0.0.1:5000"
N1 = "10.0.0.2:5000"


def _record(p, *, hier: bool = False) -> dict:
    """The solve's snap (exact seats, or seats at ROW_AGREEMENT with
    ``hier``) plus the refine's pass history."""
    rec = snap_hier(p) if hier else snap(p, placements=dict(p._placements))
    rec["history"] = [dict(h) for h in p._affinity_history]
    return rec


def run_refines(scenario, tol: float) -> tuple[list[dict], list[dict]]:
    """``run_both`` with the histories compared apart: pass numbers and
    accepted flags equal, ``cut`` and ``total`` within ``tol``."""
    rec_jax = asyncio.run(scenario(JAX_API))
    rec_torch = asyncio.run(scenario(TORCH_API))
    assert len(rec_jax) == len(rec_torch)
    for step, (a, b) in enumerate(zip(rec_jax, rec_torch)):
        ha, hb = a.pop("history"), b.pop("history")
        assert [(h["pass"], h["accepted"]) for h in ha] == [
            (h["pass"], h["accepted"]) for h in hb
        ], (step, ha, hb)
        for x, y in zip(ha, hb):
            assert abs(x["cut"] - y["cut"]) <= tol, (step, ha, hb)
            assert abs(x["total"] - y["total"]) <= tol, (step, ha, hb)
    assert_same(rec_jax, rec_torch)
    return rec_jax, rec_torch


# ------------------------------------- the reference's four toy scenarios


async def _split_pairs(api, pairs=8, **kw):
    """Two nodes on distinct hosts, ``pairs`` chatty producer->consumer
    pairs seated load-balanced but pair-split (test_affinity_edges.py)."""
    p = api.make(node_axis_size=2, mode="greedy", **kw)
    p.register_node(N0)
    p.register_node(N1)
    for i in range(pairs):
        await p.update(api.Item(api.ObjectId("P", str(i)), N0 if i % 2 else N1))
        await p.update(api.Item(api.ObjectId("C", str(i)), N1 if i % 2 else N0))
    return p


async def _lookup_pair(p, api, i):
    return (
        await p.lookup(api.ObjectId("P", str(i))),
        await p.lookup(api.ObjectId("C", str(i))),
    )


async def passes_monotone_and_colocate(api):
    pairs = 8
    p = await _split_pairs(api, pairs, affinity_weight=2.0, affinity_host_factor=0.0)
    n = p.set_edge_graph(
        [[f"P.{i}", f"C.{i}", 1000.0 + 10.0 * i, 10.0, 0.0] for i in range(pairs)]
    )
    assert n == pairs
    moved = await p.rebalance(delta=False)
    assert moved > 0
    accepted = [h for h in p._affinity_history if h["accepted"]]
    assert accepted
    for prev, cur in zip(accepted, accepted[1:]):
        assert cur["cut"] <= prev["cut"] + 1e-6
        assert cur["total"] <= prev["total"] + 1e-6
    assert accepted[-1]["cut"] == pytest.approx(0.0, abs=1e-6)
    assert "+affinity" in str(p.stats.mode)
    for i in range(pairs):
        a, b = await _lookup_pair(p, api, i)
        assert a == b, (i, a, b)
    counts = np.bincount(list(p._placements.values()))
    assert counts.max() <= pairs + 2
    return [_record(p)]


async def survives_wide_cost_ranges(api):
    pairs = 6
    p = await _split_pairs(api, pairs, affinity_weight=5000.0, affinity_host_factor=0.0)
    # Rates over six decades: weighted rows mix O(5000) and O(0.005) entries.
    p.set_edge_graph([[f"P.{i}", f"C.{i}", 10.0 ** (6 - i), 0.0, 0.0] for i in range(pairs)])
    await p.rebalance(delta=False)
    for i in range(pairs):
        a, b = await _lookup_pair(p, api, i)
        assert a in (N0, N1) and b in (N0, N1)
        if i < 3:  # the heaviest pairs are pulled together
            assert a == b, (i, a, b)
    assert p.count() == 2 * pairs
    return [_record(p)]


async def noop_without_matching_edges(api):
    p = await _split_pairs(api, 4, affinity_weight=2.0)
    assert p.set_edge_graph([["client", "P.0", 9e9, 10.0, 0.0]]) == 0
    p.set_edge_graph([["Ghost.a", "Ghost.b", 1000.0, 1.0, 0.0]])
    before = dict(p._placements)
    await p.rebalance(delta=False)
    assert p._placements == before
    assert not p._affinity_history
    assert "+affinity" not in str(p.stats.mode)
    return [_record(p)]


async def weight_zero_disables_refine(api):
    p = await _split_pairs(api, 4)
    p.set_edge_graph([[f"P.{i}", f"C.{i}", 1000.0, 10.0, 0.0] for i in range(4)])
    await p.rebalance(delta=False)
    assert not p._affinity_history
    a, b = await _lookup_pair(p, api, 0)
    assert a != b
    return [_record(p)]


@pytest.mark.parametrize(
    "scenario",
    [
        passes_monotone_and_colocate,
        survives_wide_cost_ranges,
        noop_without_matching_edges,
        weight_zero_disables_refine,
    ],
    ids=lambda f: f.__name__,
)
def test_refine_matches_jax_on_the_reference_scenarios(scenario):
    run_refines(scenario, TOL_TOY)


# ----------------------------------------------- the refine after each solve


def _host_members(hosts: int, workers: int) -> list[Member]:
    """``hosts`` x ``workers`` nodes: one IP per host, one port per worker."""
    return [Member(f"10.40.{h}.1:{5000 + w}") for h in range(hosts) for w in range(workers)]


def _graph_rows(seed: int, n_obj: int, pairs: int, stars: int, leaves: int) -> list[list]:
    """``merge_edges`` rows over objects ``A.<i>``: disjoint producer ->
    consumer pairs at 0.5-1 MB/s and ``leaves``-leaf stars at 1-100 kB/s,
    10 calls/s each, on distinct random objects."""
    rng = np.random.default_rng(seed)
    obj = rng.permutation(n_obj)
    rows, k = [], 0
    for bps in rng.uniform(5e5, 1e6, pairs):
        rows.append([f"A.{obj[k]}", f"A.{obj[k + 1]}", float(bps), 10.0, 0.0])
        k += 2
    for _ in range(stars):
        hub = obj[k]
        for bps in rng.uniform(1e3, 1e5, leaves):
            k += 1
            rows.append([f"A.{hub}", f"A.{obj[k]}", float(bps), 10.0, 0.0])
        k += 1
    assert k <= n_obj
    return rows


async def _seated_graph(api, n_obj, hosts, workers, graph, **kw):
    p = api.make(node_axis_size=hosts * workers, affinity_weight=2.0, **kw)
    p.sync_members(_host_members(hosts, workers))
    await p.assign_batch([api.ObjectId("A", str(i)) for i in range(n_obj)])
    assert p.set_edge_graph(graph) > 0
    return p


def _accepted_a_move(p) -> bool:
    return any(h["accepted"] and h["pass"] > 0 for h in p._affinity_history)


async def after_hierarchical(api):
    p = await _seated_graph(
        api, 2000, 8, 8, _graph_rows(1, 2000, 300, 20, 6), mode="hierarchical"
    )
    await p.rebalance(delta=False)
    assert p.stats.mode == "hierarchical+affinity" and _accepted_a_move(p)
    return [_record(p, hier=True)]


async def after_routed_hier_at_scale(api):
    # The routing bound and chunk rows are patched to 4,096 in both
    # packages: 5,000 objects pad to 8,192 rows, two chunks.
    p = await _seated_graph(
        api, 5000, 8, 8, _graph_rows(2, 5000, 600, 30, 6), mode="sinkhorn", n_iters=10
    )
    await p.rebalance(delta=False)
    assert p.stats.mode == "sinkhorn+hier_at_scale+affinity" and p.stats.chunks == 2
    assert _accepted_a_move(p)
    return [_record(p, hier=True)]


async def after_greedy(api):
    p = await _seated_graph(api, 2000, 8, 8, _graph_rows(3, 2000, 300, 20, 6), mode="greedy")
    await p.rebalance(delta=False)
    assert p.stats.mode == "greedy+affinity" and _accepted_a_move(p)
    return [_record(p, hier=True)]


async def after_dense_priced(api):
    weights = np.random.default_rng(4).uniform(1.0, 4.0, 2000).astype(np.float32)

    def prices(keys):  # keys are "A.<i>"
        return weights[[int(k[2:]) for k in keys]]

    p = await _seated_graph(
        api, 2000, 8, 8, _graph_rows(4, 2000, 300, 20, 6), mode="sinkhorn", object_costs=prices
    )
    await p.rebalance(delta=False)
    assert p.stats.mode == "sinkhorn+affinity" and _accepted_a_move(p)
    return [_record(p, hier=True)]


async def collapsed_at_1024_nodes(api):
    """128 hosts x 8 workers, 16,384 objects, 7,800 edge-touching objects:
    the 4,096-row cap binds."""
    p = await _seated_graph(
        api, 16384, 128, 8, _graph_rows(5, 16384, 3000, 200, 8), mode="sinkhorn"
    )
    await p.rebalance(delta=False)
    assert p.stats.mode == "sinkhorn+collapsed+affinity" and _accepted_a_move(p)
    assert 0 < p.stats.moved <= tp._AFFINITY_MAX_ROWS
    return [_record(p, hier=True)]


@pytest.mark.parametrize(
    "scenario",
    [after_hierarchical, after_routed_hier_at_scale, after_greedy, after_dense_priced,
     collapsed_at_1024_nodes],
    ids=lambda f: f.__name__,
)
def test_refine_after_each_solve_matches_jax(scenario, monkeypatch):
    if scenario is after_routed_hier_at_scale:
        for mod in (jp, tp):
            monkeypatch.setattr(mod, "_FLAT_REBALANCE_MAX_ROWS", 4096)
            monkeypatch.setattr(mod, "_HIER_CHUNK_ROWS", 4096)
    run_refines(scenario, TOL_GRAPH)


async def _moves_and_joins(api, n_obj: int, rows: list) -> dict:
    """Objects the refine moved after the collapsed solve, and how many of
    them landed on a graph neighbour's node and on its host."""
    p = api.make(mode="sinkhorn", node_axis_size=1024, affinity_weight=2.0)
    p.sync_members(_host_members(128, 8))
    await p.assign_batch([api.ObjectId("Aff", str(i)) for i in range(n_obj)])
    p.set_edge_graph(rows)
    before = dict(p._placements)
    await p.rebalance(delta=False)
    seat = p._placements
    nbrs: dict[str, list[str]] = {}
    for a, b in p._edge_graph:
        nbrs.setdefault(a, []).append(b)
        nbrs.setdefault(b, []).append(a)
    moved = sorted(k for k in seat if seat[k] != before[k])
    return {
        "mode": p.stats.mode,
        "moved": moved,
        "joined_node": sum(any(seat[n] == seat[k] for n in nbrs[k]) for k in moved),
        "joined_host": sum(any(seat[n] // 8 == seat[k] // 8 for n in nbrs[k]) for k in moved),
    }


def test_refine_moves_that_join_no_neighbour_match_the_reference():
    """A property of the reference that the port keeps: on the card's graph
    shape (chip_smoke.affinity_edge_rows: pairs and 16-leaf stars, Zipf(1.1)
    rates) most refine moves land on no neighbour's node or host. A flat
    cost row (no attraction beyond the stay-put discount) still spreads a
    few percent of its soft plan over other columns, and the quantile
    rounding seats the rows at the top of that tail there; an unchanged cut
    accepts the pass. Both packages move the same objects."""
    import chip_smoke

    rows = chip_smoke.affinity_edge_rows(16384, 8192, seed=3)
    got = asyncio.run(_moves_and_joins(TORCH_API, 16384, rows))
    want = asyncio.run(_moves_and_joins(JAX_API, 16384, rows))
    assert got == want
    assert got["mode"] == "sinkhorn+collapsed+affinity"
    assert 0 < got["joined_node"] <= got["joined_host"] < len(got["moved"]) / 4, (
        len(got["moved"]), got["joined_node"], got["joined_host"])


# ------------------------------ the pieces computed another way than JAX's


def _attraction_reference(rows, dst_seats, w, hfac, n_rows):
    attract = np.zeros((n_rows, hfac.shape[0]), np.float32)
    np.add.at(attract, rows, w[:, None] * hfac[dst_seats])
    return attract


@pytest.mark.parametrize("seed", [0, 1])
def test_attraction_equals_the_reference_scatter(seed):
    rng = np.random.default_rng(seed)
    m, n_rows, n_edges = 48, 300, 5000
    host = rng.integers(0, 12, m)
    hfac = (0.5 * (host[:, None] == host[None, :])).astype(np.float32)
    np.fill_diagonal(hfac, 1.0)
    rows = rng.integers(0, n_rows, n_edges)
    dst = rng.integers(0, m, n_edges)
    w = rng.uniform(1e-4, 1.0, n_edges).astype(np.float32)
    got = tp._attraction(rows, dst, w, torch.from_numpy(hfac), n_rows).numpy()
    want = _attraction_reference(rows, dst, w, hfac, n_rows)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0.0)


def _truncate_reference(new_seats, old, gain, col_cap, m):
    """The mover loop of jax_placement.py's _affinity_refine, verbatim."""
    new_seats = new_seats.copy()
    stayers = np.bincount(old[new_seats == old], minlength=m)
    for c in np.unique(new_seats[new_seats != old]):
        movers = np.nonzero((new_seats == c) & (old != c))[0]
        allowed = int(max(0.0, np.floor(col_cap[c] - stayers[c])))
        if movers.size > allowed:
            ranked = movers[np.argsort(-gain[movers], kind="stable")]
            new_seats[ranked[allowed:]] = old[ranked[allowed:]]
    return new_seats


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mover_truncation_equals_the_reference_loop(seed):
    rng = np.random.default_rng(seed)
    m, sp = 16, 600
    old = rng.integers(0, m, sp)
    new = np.where(rng.random(sp) < 0.6, rng.integers(0, m, sp), old)
    # Few distinct gains, so ties decide most ranks; some are -0.0.
    gain = rng.choice(np.float32([-1.0, -0.0, 0.0, 0.25, 0.5, 1.0]), sp)
    col_cap = rng.uniform(0.0, 40.0, m) * (rng.random(m) < 0.8)
    got = tp._truncate_movers(
        torch.from_numpy(new), torch.from_numpy(old), torch.from_numpy(gain),
        torch.from_numpy(col_cap),
    ).numpy()
    want = _truncate_reference(new, old, gain, col_cap, m)
    assert (new != want).any() and (want != old).any()  # some moves kept, some cut
    np.testing.assert_array_equal(got, want)


def test_host_ids_equal_the_reference_index():
    hosts = ["b", "a", "b", "\x00pad3", "c", "a", "c", "\x00pad7"]
    want = [list(dict.fromkeys(hosts)).index(h) for h in hosts]
    assert tp._host_ids(hosts).tolist() == want


# ------------------------------------------------------ the live payoff


def test_affinity_payoff_on_the_port(monkeypatch):
    """``measure_affinity_payoff`` (two live servers, blind vs affinity-fed
    placement on identical multi-hop traffic) on the port's provider,
    held to the harness's own bar."""
    monkeypatch.setattr(
        affinity_live, "JaxObjectPlacement",
        lambda **kw: TorchObjectPlacement(device="cpu", **kw),
    )
    out = asyncio.run(
        asyncio.wait_for(affinity_live.measure_affinity_payoff(n_records=64), timeout=120)
    )
    assert "+affinity" in str(out["solved_as"]), out
    assert out["pairs_colocated"] == out["partitions"], out
    assert out["bytes_ratio"] >= 2.0, out
    assert out["delivered"] > 0
