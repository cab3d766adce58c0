"""The device tiers of ``bench.py`` on the port: placements/sec on one CUDA card.

    python -m rio_tpu_torch.bench [--tier N] [--collapsed] [--delta] [--hier] [--out PATH]

Each tier is its ``bench.py`` counterpart, named without the leading
underscore, with the reference's result keys:

* :func:`solve_rate` (``_solve_rate``): the main placement step, scaling
  Sinkhorn (the fused CUDA kernel on the card, one launch an iteration),
  the row-marginal check, CDF rounding in 65,536-row chunks and exact-quota
  repair; ``solve_only`` and ``step`` timed alone, then the chained solve;
* :func:`greedy_rate` (``_greedy_rate``): the greedy waterfill on the same inputs;
* :func:`collapsed_rate` (``_collapsed_rate``): the directory's committed
  full rebalance, per-seat counts, class-collapsed solve, quota expansion
  and repair (:func:`collapsed_decide`);
* :func:`warm_assign_rate` (``_warm_assign_rate``): a warm allocation batch
  against cached potentials;
* :func:`incremental_rate` (``_incremental_rate``): the churn cycle, a warm
  batch and a collapsed re-solve;
* :func:`delta_churn_rate` (``_delta_churn_rate``): the provider's full and
  delta rebalances, A/B, through :class:`TorchObjectPlacement`;
* :func:`hier_rate` (``_hier_rate``): BASELINE row 5, the two-level solve
  in chunks of 655,360 rows.

Timing is the reference's measurement without its relay defences. A single
call ends in ``torch.cuda.synchronize()`` and is the best of 3 after a warm
call (``_time_fn``). A chained time is ``k`` calls issued back to back,
each fed by the one before, with one synchronize at the end, best of 2
(``_time_chained``). Nothing is compiled, so ``compile_s`` and
``chain_compile_s`` read -1.

Every tier runs on CUDA unless it is given ``device="cpu"``, and raises
without a card. Every result names its device (``platform``, ``device``,
``power_limit``). Inputs are drawn from numpy seeds unless the caller hands
them in as arrays, as the tests do with the reference's ``jax.random`` draws.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sqlite3
import subprocess
import time

import numpy as np
import torch

from .device import resolve_device
from .entry import round_and_repair, row_marginal_err
from .object_placement.torch_placement import TorchObjectPlacement
from .ops.assignment import build_cost_matrix, greedy_balanced_assign, integer_fair_quotas
from .ops.scaling import scaling_core_auto, scaling_impl_for
from .ops.sinkhorn import exact_quota_repair
from .ops.structured import class_quotas, expand_class_quotas
from .parallel.hierarchical import chunked_hierarchical_assign, hierarchical_assign
from .registry import ObjectId

N_NODES = 1024
CHUNK = 65536  # rows per rounding chunk (bounds rounding temporaries)
HIER_CHUNK_ROWS = 655_360  # rows per chunk of hier_rate (bench.py:876)
EPS = 0.05
NOT_COMPILED = -1.0  # compile_s / chain_compile_s: eager PyTorch compiles nothing


def sqlite_baseline_rate(n_samples: int = 5000) -> float:
    """Placements/sec for the reference's row-by-row SQL directory.

    A copy of ``bench.py``'s: one SELECT and one upsert per placement, the
    queries of ``rio-rs/src/object_placement/sqlite.rs:68-100``, through
    Python's sqlite3 on an in-memory database.
    """
    db = sqlite3.connect(":memory:")
    try:
        db.execute(
            "CREATE TABLE object_placement ("
            "struct_name TEXT NOT NULL, object_id TEXT NOT NULL,"
            "server_address TEXT, PRIMARY KEY (struct_name, object_id))"
        )
        db.execute("CREATE INDEX idx_addr ON object_placement (server_address)")
        t0 = time.perf_counter()
        for i in range(n_samples):
            # The allocate path: lookup miss then upsert (service.rs:193-254).
            db.execute(
                "SELECT server_address FROM object_placement "
                "WHERE struct_name=? AND object_id=?",
                ("Bench", str(i)),
            ).fetchone()
            db.execute(
                "INSERT INTO object_placement (struct_name, object_id, server_address) "
                "VALUES (?, ?, ?) ON CONFLICT (struct_name, object_id) "
                "DO UPDATE SET server_address=excluded.server_address",
                ("Bench", str(i), f"10.0.0.{i % 64}:5000"),
            )
            db.commit()
        return n_samples / (time.perf_counter() - t0)
    finally:
        db.close()


# ---------------------------------------------------------------------------
# Devices, inputs and timing
# ---------------------------------------------------------------------------


def _power_limit(index: int) -> str | None:
    """The card's power limit as ``nvidia-smi`` reports it, or None without the tool."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", str(index)],
            capture_output=True, text=True, timeout=60, check=True,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip()


def device_fields(dev: torch.device) -> dict:
    """What every result carries about the device it ran on."""
    if dev.type != "cuda":
        return {"platform": dev.type, "device": dev.type, "power_limit": None}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return {
        "platform": "cuda",
        "device": torch.cuda.get_device_name(index),
        "power_limit": _power_limit(index),
    }


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _tensor(x, dtype: torch.dtype, dev: torch.device, shape: tuple) -> torch.Tensor:
    a = np.asarray(x)
    if not a.flags.writeable:  # torch refuses to share a read-only buffer
        a = a.copy()
    t = torch.from_numpy(a).to(device=dev, dtype=dtype)
    if tuple(t.shape) != shape:
        raise ValueError(f"input of shape {tuple(t.shape)}, want {shape}")
    return t


def _time_fn(fn, dev: torch.device):
    """A warm call, then the best of 3, each ending in a device synchronize.

    Returns ``(best_seconds, last_output)``; callers read the output's
    quality instead of paying another run.
    """
    out = fn()
    _sync(dev)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        times.append(time.perf_counter() - t0)
    return min(times), out


def _time_chained(step, state, k: int, dev: torch.device) -> float:
    """Seconds per step of ``k`` data-dependent steps issued back to back.

    ``step(state)`` returns the next state, so each call is fed by the one
    before, as in the reference's ``fori_loop`` chains; one synchronize ends
    each run; best of 2.
    """
    times = []
    for _ in range(2):
        s = state
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(k):
            s = step(s)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    return min(times) / k


def _chain_fields(k: int) -> dict:
    return {"chain_steps": k, "chain_compile_s": NOT_COMPILED}


def tier_inputs(n_obj: int, n_nodes: int, seed: int = 0) -> np.ndarray:
    """The solve tiers' cost: U[0, 1) float32 of shape (n_obj, n_nodes) from ``seed``.

    Masses and capacities are ones (``bench.py``'s ``_tier_inputs``).
    """
    return np.random.default_rng(seed).random((n_obj, n_nodes), dtype=np.float32)


def _alive_pair(m: int, n_dead: int, dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Liveness with nodes ``[0, n_dead)`` dead, and with ``[n_dead, 2 n_dead)`` dead."""
    alive_a = torch.ones(m, dtype=torch.float32, device=dev)
    alive_a[:n_dead] = 0.0
    alive_b = torch.ones(m, dtype=torch.float32, device=dev)
    alive_b[n_dead : 2 * n_dead] = 0.0
    return alive_a, alive_b


# ---------------------------------------------------------------------------
# Tiers
# ---------------------------------------------------------------------------


def solve_rate(
    n_obj: int,
    kernel_dtype: torch.dtype = torch.bfloat16,
    n_nodes: int = N_NODES,
    n_iters: int = 30,
    *,
    cost=None,
    chain_steps: int | None = None,
    device=None,
) -> dict:
    """On-device OT solve throughput (``bench.py`` ``_solve_rate``).

    The scaling-form core builds K = exp(-C/eps) once, and each iteration
    is one read of K (one launch of the fused kernel on the card). The
    rounding pass reuses K. ``sinkhorn_ms`` times the solve with the
    row-marginal check, ``single_shot_ms`` the whole step; with a chain,
    ``full_ms`` is the chained solve plus the rounding share. ``solves``
    counts the scaling solves the tier issued: on the card the kernel
    launched ``n_iters`` times each. ``chain_steps=0`` skips the chain.
    """
    dev = resolve_device(device)
    if cost is None:
        cost = tier_inputs(n_obj, n_nodes)
    cost = _tensor(cost, torch.float32, dev, (n_obj, n_nodes))
    mass = torch.ones(n_obj, dtype=torch.float32, device=dev)
    cap = torch.ones(n_nodes, dtype=torch.float32, device=dev)
    solves = 0

    def solve(row_mass):
        nonlocal solves
        solves += 1
        return scaling_core_auto(
            cost, row_mass, cap, eps=EPS, n_iters=n_iters, kernel_dtype=kernel_dtype
        )

    def solve_only():
        u, v, K, _ = solve(mass)
        return u.sum() + v.sum() + row_marginal_err(K, u, v, mass, cap)

    def step():
        u, v, K, _ = solve(mass)
        # Chunk the rounding pass so its cumsum temporaries stay bounded.
        # NOTE: quantile ranks are per-chunk, which is only equivalent to
        # global ranking because every row here is real with identical mass
        # (each chunk spreads over the same marginals); mixed masses or
        # padding split across chunks would need an explicit rank offset.
        return round_and_repair(cost, mass, cap, u, v, K, chunk=min(CHUNK, n_obj))

    solve_s, _ = _time_fn(solve_only, dev)
    full_s, (assignment, mean_cost, marginal_err) = _time_fn(step, dev)
    result = {
        **device_fields(dev),
        "single_shot_ms": full_s * 1e3,
        "sinkhorn_ms": solve_s * 1e3,
        "compile_s": NOT_COMPILED,
        "n_obj": n_obj,
        "n_nodes": n_nodes,
        "n_iters": n_iters,
        "max_load": int(torch.bincount(assignment.long(), minlength=n_nodes).max()),
        "fair_load": n_obj // n_nodes,
        "mean_cost": float(mean_cost),
        "marginal_err": float(marginal_err),
        "solver_impl": scaling_impl_for(dev),
    }

    # The sustained solve: each step's mass carries 1e-20 * u forward, an
    # identity on these O(1) values that still feeds each solve from the
    # one before (bench.py's chained_solve; eager calls hoist nothing, so
    # its cost perturbation has no counterpart here).
    def chained(mass_c):
        u, _, _, _ = solve(mass_c)
        return mass_c + 1e-20 * u

    k = chain_steps if chain_steps is not None else int(min(8, max(2, round(6.0 / max(solve_s, 0.05)))))
    decision_s = full_s
    if k > 0:
        per_step_s = _time_chained(chained, mass, k, dev)
        decision_s = per_step_s + max(full_s - solve_s, 0.0)
        result.update(solve_chain_ms=per_step_s * 1e3, **_chain_fields(k))
    result.update(rate=n_obj / decision_s, full_ms=decision_s * 1e3, solves=solves)
    return result


def greedy_rate(n_obj: int, n_nodes: int = N_NODES, *, cost=None, device=None) -> dict:
    """Greedy waterfill tier on the solve tier's inputs (``bench.py`` ``_greedy_rate``)."""
    dev = resolve_device(device)
    if cost is None:
        cost = tier_inputs(n_obj, n_nodes)
    cost = _tensor(cost, torch.float32, dev, (n_obj, n_nodes))
    mass = torch.ones(n_obj, dtype=torch.float32, device=dev)
    cap = torch.ones(n_nodes, dtype=torch.float32, device=dev)

    def step():
        a = greedy_balanced_assign(cost, mass, cap)
        return a, cost.gather(1, a[:, None].long()).mean()

    best, (a, mean_cost) = _time_fn(step, dev)
    return {
        **device_fields(dev),
        "rate": n_obj / best,
        "full_ms": best * 1e3,
        "compile_s": NOT_COMPILED,
        "mean_cost": float(mean_cost),
        "max_load": int(torch.bincount(a.long(), minlength=n_nodes).max()),
        "fair_load": n_obj // n_nodes,
    }


def collapsed_decide(
    cur: torch.Tensor,
    cap: torch.Tensor,
    alive: torch.Tensor,
    *,
    move_cost: float = 0.5,
    n_iters: int = 30,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The committed rebalance decision, as the provider runs it: ``(assignment, g)``.

    Per-seat counts, the class-collapsed (M x M) solve
    (:func:`~rio_tpu_torch.ops.structured.class_quotas`, eps
    ``min(0.05, move_cost / 25)``: off-diagonal leakage < 1e-8), quota
    expansion and exact-quota repair that keeps objects in place first.
    ``cur`` is the (N,) int32 current seat of every object.
    """
    m = cap.shape[0]
    base_cost = build_cost_matrix(torch.zeros_like(cap), cap, alive)[0]
    counts = torch.bincount(cur.long(), minlength=m)
    cap_alive = cap * alive
    quotas, g, _ = class_quotas(
        base_cost, counts, cap_alive,
        move_cost=move_cost, eps=min(0.05, move_cost / 25.0), n_iters=n_iters,
    )
    expanded = expand_class_quotas(quotas, cur)
    expected = cap_alive / cap_alive.sum().clamp_min(1e-30) * cur.shape[0]
    return exact_quota_repair(expanded, expected, prefer_keep=expanded == cur), g


def _seat_quality(assignment: torch.Tensor, cur: torch.Tensor, m: int, n_dead: int) -> dict:
    """Moves and loads of a re-seat after nodes ``[0, n_dead)`` died."""
    loads = torch.bincount(assignment.long(), minlength=m)
    return {
        "displaced": int((cur < n_dead).sum()),
        "moved": int((assignment != cur).sum()),
        "max_load": int(loads.max()),
        "dead_load": int(loads[:n_dead].sum()),
        "fair_load": cur.shape[0] // (m - n_dead),
    }


def collapsed_rate(
    n_obj: int,
    n_nodes: int = N_NODES,
    dead_frac: float = 0.03,
    n_iters: int = 30,
    move_cost: float = 0.5,
    *,
    cur=None,
    chain_steps: int | None = None,
    device=None,
) -> dict:
    """The directory's full-rebalance fast path, end to end (``bench.py`` ``_collapsed_rate``).

    ``n_obj`` objects seated on ``n_nodes`` nodes, ``dead_frac`` of the
    nodes just died: :func:`collapsed_decide` re-seats the displaced share.
    ``full_ms`` is the per-decision time over a chain of churn re-solves,
    each starting from the previous step's assignment with an alternating
    set of nodes dead. The host pull of the assignment and the mover-only
    directory update (as ``rebalance()`` applies it) are timed apart.
    """
    dev = resolve_device(device)
    m = n_nodes
    n_dead = max(1, int(m * dead_frac))
    if cur is None:
        cur = np.random.default_rng(2).integers(0, m, n_obj, dtype=np.int32)
    cur_t = _tensor(cur, torch.int32, dev, (n_obj,))
    cap = torch.ones(m, dtype=torch.float32, device=dev)
    alive_a, alive_b = _alive_pair(m, n_dead, dev)

    def decide(c, alive):
        return collapsed_decide(c, cap, alive, move_cost=move_cost, n_iters=n_iters)[0]

    best, assignment = _time_fn(lambda: decide(cur_t, alive_a), dev)
    single_s = max(best, 1e-4)

    def chained(state):
        i, c = state
        return i + 1, decide(c, alive_a if i % 2 == 0 else alive_b)

    k = chain_steps if chain_steps is not None else int(min(64, max(8, round(20.0 / single_s))))
    decision_s = best
    extra: dict = {}
    if k > 0:
        decision_s = _time_chained(chained, (0, cur_t), k, dev)
        extra = {"decision_ms": decision_s * 1e3, **_chain_fields(k)}

    # Host bookkeeping, timed apart: the assignment's pull and the directory
    # update over ONLY the movers, as rebalance() applies it.
    t0 = time.perf_counter()
    a = assignment.cpu().numpy()
    pull_ms = (time.perf_counter() - t0) * 1e3
    cur_np = cur_t.cpu().numpy()
    keys = [str(i) for i in range(n_obj)]
    directory = dict(zip(keys, cur_np.tolist()))
    t0 = time.perf_counter()
    for p in np.nonzero(a != cur_np)[0].tolist():
        directory[keys[p]] = int(a[p])
    host_apply_ms = (time.perf_counter() - t0) * 1e3

    return {
        **device_fields(dev),
        "rate": n_obj / decision_s,
        "full_ms": decision_s * 1e3,
        "single_shot_ms": best * 1e3,
        "compile_s": NOT_COMPILED,
        "n_obj": n_obj,
        "n_nodes": m,
        "n_iters": n_iters,
        "dead_nodes": n_dead,
        **_seat_quality(assignment, cur_t, m, n_dead),
        "pull_ms": pull_ms,
        "host_apply_ms": host_apply_ms,
        **extra,
    }


def warm_assign_rate(
    batch: int,
    n_nodes: int = N_NODES,
    *,
    g=None,
    chain_steps: int = 16,
    device=None,
    keep: dict | None = None,
) -> dict:
    """Warm incremental allocation (``bench.py`` ``_warm_assign_rate``).

    A batch of new objects lands through cached node potentials ``g`` and a
    greedy waterfill over the remaining headroom, with no re-solve. The
    chain carries each batch's load into the next. With ``keep``, the
    single batch's per-node counts are stored under ``keep["counts"]``.
    """
    dev = resolve_device(device)
    m = n_nodes
    if g is None:
        g = np.random.default_rng(3).standard_normal(m, dtype=np.float32) * np.float32(0.1)
    g = _tensor(g, torch.float32, dev, (m,))
    load = torch.full((m,), batch / m, dtype=torch.float32, device=dev)
    cap = torch.ones(m, dtype=torch.float32, device=dev)
    alive = torch.ones(m, dtype=torch.float32, device=dev)
    mass = torch.ones(batch, dtype=torch.float32, device=dev)

    def assign(ld):
        rows = (build_cost_matrix(ld, cap, alive) - g[None, :]).expand(batch, m)
        return greedy_balanced_assign(rows, mass, cap * alive, ld)

    best, a = _time_fn(lambda: assign(load), dev)
    counts = torch.bincount(a.long(), minlength=m)
    if keep is not None:
        keep["counts"] = counts.cpu().numpy()
    decision_s = best
    extra: dict = {}
    if chain_steps > 0:
        decision_s = _time_chained(
            lambda ld: ld + torch.bincount(assign(ld).long(), minlength=m).float(),
            load, chain_steps, dev,
        )
        extra = _chain_fields(chain_steps)
    return {
        **device_fields(dev),
        "rate": batch / decision_s,
        "full_ms": decision_s * 1e3,
        "single_shot_ms": best * 1e3,
        "batch": batch,
        "compile_s": NOT_COMPILED,
        "max_load": int(counts.max()),
        "fair_load": batch // m,
        **extra,
    }


def incremental_rate(
    n_obj: int,
    batch: int = 65_536,
    n_nodes: int = N_NODES,
    dead_frac: float = 0.03,
    n_iters: int = 30,
    move_cost: float = 0.5,
    *,
    cur=None,
    g_warm=None,
    chain_steps: int | None = None,
    device=None,
) -> dict:
    """The full churn cycle, chained (``bench.py`` ``_incremental_rate``).

    One cycle: a warm allocation batch over the current loads, then the
    collapsed re-solve of the seated population after a node-death wave.
    Each batch replaces the previous cycle's (steady-state turnover). The
    quality keys are those of the first cycle.
    """
    dev = resolve_device(device)
    m = n_nodes
    n_dead = max(1, int(m * dead_frac))
    if cur is None:
        cur = np.random.default_rng(5).integers(0, m, n_obj, dtype=np.int32)
    if g_warm is None:
        g_warm = np.random.default_rng(6).standard_normal(m, dtype=np.float32) * np.float32(0.1)
    cur_t = _tensor(cur, torch.int32, dev, (n_obj,))
    g_warm = _tensor(g_warm, torch.float32, dev, (m,))
    cap = torch.ones(m, dtype=torch.float32, device=dev)
    alive_a, alive_b = _alive_pair(m, n_dead, dev)
    mass = torch.ones(batch, dtype=torch.float32, device=dev)

    def cycle(c, extra_load, alive):
        # 1. warm allocation: the batch lands on the current loads.
        seated = torch.bincount(c.long(), minlength=m).float()
        rows = (build_cost_matrix(seated + extra_load, cap, alive) - g_warm[None, :]).expand(batch, m)
        alloc = greedy_balanced_assign(rows, mass, cap * alive, seated + extra_load)
        extra_load = torch.bincount(alloc.long(), minlength=m).float()
        # 2. churn re-solve of the seated population.
        assignment, _ = collapsed_decide(c, cap, alive, move_cost=move_cost, n_iters=n_iters)
        return assignment, extra_load

    zero_extra = torch.zeros(m, dtype=torch.float32, device=dev)
    best, (assignment, _) = _time_fn(lambda: cycle(cur_t, zero_extra, alive_a), dev)
    single_s = max(best, 1e-4)

    def chained(state):
        i, c, e = state
        return (i + 1, *cycle(c, e, alive_a if i % 2 == 0 else alive_b))

    k = chain_steps if chain_steps is not None else int(min(32, max(8, round(15.0 / single_s))))
    cycle_s = best
    extra: dict = {}
    if k > 0:
        cycle_s = _time_chained(chained, (0, cur_t, zero_extra), k, dev)
        extra = _chain_fields(k)
    return {
        **device_fields(dev),
        "cycle_ms": cycle_s * 1e3,
        "cycles_per_sec": 1.0 / cycle_s,
        "single_shot_ms": best * 1e3,
        "n_obj": n_obj,
        "alloc_batch": batch,
        "dead_nodes": n_dead,
        "compile_s": NOT_COMPILED,
        **_seat_quality(assignment, cur_t, m, n_dead),
        **extra,
    }


class _Member:
    """What ``sync_members`` reads of a membership row."""

    def __init__(self, address: str, active: bool = True) -> None:
        self.address = address
        self.active = active


def delta_churn_rate(n_obj: int, n_nodes: int = 64, mode: str = "sinkhorn", *, device=None) -> dict:
    """One churn event's full re-solve A/B the delta path (``bench.py`` ``_delta_churn_rate``).

    Through the provider's public ``rebalance``: seat ``n_obj`` objects on
    ``n_nodes`` nodes, establish a plan, a warm-up churn event (untimed),
    then node 0 dies for a timed ``rebalance(delta=False)`` and node 1 dies
    for a timed ``rebalance()``. After a quota-exact full solve the second
    kill grows every survivor's quota, so the delta must move exactly the
    dead node's population: ``undisplaced_moves`` must be 0 and
    ``cost_ratio`` (quadratic congestion against the integer-quota ideal)
    ~1.0. Each timed call ends in a device synchronize.
    """
    dev = resolve_device(device)
    members = [f"10.99.{i // 256}.{i % 256}:7000" for i in range(n_nodes)]

    def live(*dead: int) -> list:
        return [_Member(a, i not in dead) for i, a in enumerate(members)]

    async def run() -> dict:
        dead_warm = n_nodes - 1
        p = TorchObjectPlacement(mode=mode, node_axis_size=n_nodes, device=dev)
        p.sync_members(live())
        await p.assign_batch([ObjectId("Bench", str(i)) for i in range(n_obj)])
        await p.rebalance(delta=False)  # the plan is established
        p.sync_members(live(dead_warm))
        await p.rebalance()  # the warm-up churn event

        # Event A: node 0 dies -> FULL re-solve, timed.
        p.sync_members(live(dead_warm, 0))
        _sync(dev)
        t0 = time.perf_counter()
        full_moved = await p.rebalance(delta=False)
        _sync(dev)
        full_ms = (time.perf_counter() - t0) * 1e3
        full_mode = p.stats.mode

        # Event B: node 1 dies -> DELTA re-solve, timed; seats snapshotted first.
        pre_seats = dict(p._placements)
        p.sync_members(live(dead_warm, 0, 1))
        _sync(dev)
        t1 = time.perf_counter()
        delta_moved = await p.rebalance()
        _sync(dev)
        delta_ms = (time.perf_counter() - t1) * 1e3

        dead_idx = p._nodes[members[1]].index
        undisplaced_moves = sum(
            1 for k, v in pre_seats.items() if v != dead_idx and p._placements.get(k) != v
        )
        counts_after = np.asarray(
            [len(p._by_node.get(i, ())) for i in range(p._node_axis)], np.float64
        )
        cap_alive = np.zeros((p._node_axis,), np.float64)
        for i, a in enumerate(members):
            cap_alive[p._nodes[a].index] = 0.0 if i in (dead_warm, 0, 1) else 1.0
        quota = integer_fair_quotas(cap_alive, n_obj).astype(np.float64)
        safe = np.maximum(cap_alive, 1e-9)
        cost_ratio = float(np.sum(counts_after**2 / safe) / max(np.sum(quota**2 / safe), 1e-9))
        return {
            **device_fields(dev),
            "n_obj": n_obj,
            "n_nodes": n_nodes,
            "full_mode": full_mode,
            "delta_mode": p.stats.mode,
            "full_ms": full_ms,
            "full_moved": int(full_moved),
            "delta_ms": delta_ms,
            "delta_moved": int(delta_moved),
            "displaced": int(p.stats.displaced),
            "undisplaced_moves": int(undisplaced_moves),
            "speedup": full_ms / max(delta_ms, 1e-6),
            "cost_ratio": cost_ratio,
        }

    return asyncio.run(run())


def hier_rate(
    n_obj: int,
    n_nodes: int = N_NODES,
    n_groups: int = 32,
    d: int = 16,
    *,
    chunk_rows: int = HIER_CHUNK_ROWS,
    obj_feat=None,
    node_feat=None,
    chain_steps: int | None = None,
    device=None,
    keep: dict | None = None,
) -> dict:
    """BASELINE row 5: two-level OT at the scale ceiling (``bench.py`` ``_hier_rate``).

    Above ``chunk_rows`` rows, when they divide ``n_obj``, the solve runs in
    ``n_obj // chunk_rows`` chunks (:func:`chunked_hierarchical_assign`),
    else in one :func:`hierarchical_assign`. The chain adds a 1e-30-scale
    carry of the previous assignment to the features (an identity on O(1)
    values that feeds each solve from the one before). With ``keep``, the
    single call's assignment is stored under ``keep["assignment"]``.
    """
    dev = resolve_device(device)
    n_chunks = n_obj // chunk_rows if n_obj > chunk_rows and n_obj % chunk_rows == 0 else 1
    rng = np.random.default_rng(1)
    if obj_feat is None:
        obj_feat = rng.standard_normal((n_obj, d), dtype=np.float32)
    if node_feat is None:
        node_feat = rng.standard_normal((d, n_nodes), dtype=np.float32)
    obj_feat = _tensor(obj_feat, torch.float32, dev, (n_obj, d))
    node_feat = _tensor(node_feat, torch.float32, dev, (d, n_nodes))
    cap = torch.ones(n_nodes, dtype=torch.float32, device=dev)
    alive = torch.ones(n_nodes, dtype=torch.float32, device=dev)

    def run(feat):
        if n_chunks > 1:
            return chunked_hierarchical_assign(
                feat, node_feat, cap, alive, n_groups=n_groups, n_chunks=n_chunks
            )
        return hierarchical_assign(feat, node_feat, cap, alive, n_groups=n_groups)

    best, res = _time_fn(lambda: run(obj_feat), dev)
    loads = torch.bincount(res.assignment.long(), minlength=n_nodes)
    if keep is not None:
        keep["assignment"] = res.assignment.cpu().numpy()

    def chained(carry):
        out = run(obj_feat + carry)
        return 1e-30 * out.assignment.sum().float()

    k = chain_steps if chain_steps is not None else int(min(8, max(2, round(4.0 / max(best, 0.05)))))
    decision_s = best
    extra: dict = {}
    if k > 0:
        carry = torch.zeros((), dtype=torch.float32, device=dev)
        decision_s = _time_chained(chained, carry, k, dev)
        extra = _chain_fields(k)
    return {
        **device_fields(dev),
        "rate": n_obj / decision_s,
        "full_ms": decision_s * 1e3,
        "single_shot_ms": best * 1e3,
        "n_obj": n_obj,
        "n_nodes": n_nodes,
        "n_groups": n_groups,
        "overflow": int(res.overflow),
        "n_chunks": n_chunks,
        "chunk_rows": n_obj // n_chunks,
        "compile_s": NOT_COMPILED,
        "min_load": int(loads.min()),
        "max_load": int(loads.max()),
        "fair_load": n_obj // n_nodes,
        **extra,
    }


# ---------------------------------------------------------------------------
# Command line
# ---------------------------------------------------------------------------


def headline(detail: dict, baseline: float) -> dict:
    """The reference's last line, ``{"metric", "value", "unit", "vs_baseline"}``.

    The collapsed rebalance leads when it ran, else the dense solve, the
    hierarchical solve, then the delta rebalance (objects re-decided per
    second). Route hops need the actor runtime, so the metric says "hops
    unmeasured".
    """
    first = next(iter(detail.values()))
    card = f"{first['device']}, power limit {first['power_limit']}"
    if "collapsed_tier" in detail:
        c = detail["collapsed_tier"]
        dense = f"; dense OT {detail['solve_tier']['rate']:.0f}/s" if "solve_tier" in detail else ""
        warm = f"; warm assign {detail['warm_assign']['rate']:.0f}/s" if "warm_assign" in detail else ""
        sustain = (
            f" sustained over {c['chain_steps']} chained churn steps "
            f"(single call {c['single_shot_ms']:.2f} ms)" if "chain_steps" in c else ""
        )
        metric = (
            "placements/sec (committed rebalance fast path: class-collapsed "
            f"solve+expand+repair on device, {c['n_obj']} objects x {c['n_nodes']} nodes "
            f"re-seated in {c['full_ms']:.2f} ms{sustain} after {c['dead_nodes']} node "
            f"deaths, moved {c['moved']} (displaced {c['displaced']}), {card}{dense}{warm}; "
            "hops unmeasured)"
        )
        value = c["rate"]
    elif "solve_tier" in detail:
        s = detail["solve_tier"]
        metric = (
            f"placements/sec (OT solve, {s['n_obj']} objects x {s['n_nodes']} nodes, "
            f"{card}; hops unmeasured)"
        )
        value = s["rate"]
    elif "baseline_row5_hier" in detail:
        h = detail["baseline_row5_hier"]
        metric = (
            f"placements/sec (hierarchical OT, {h['n_obj']} objects x {h['n_nodes']} nodes "
            f"in {h['n_chunks']} chunks, {card}; hops unmeasured)"
        )
        value = h["rate"]
    else:
        t = detail["delta_tier"]
        metric = (
            f"placements/sec (delta rebalance of {t['n_obj']} objects x {t['n_nodes']} nodes "
            f"after one node death, {t['delta_moved']} moved, {card}; hops unmeasured)"
        )
        value = t["n_obj"] / (t["delta_ms"] / 1e3)
    return {
        "metric": metric,
        "value": value,
        "unit": "placements/sec",
        "vs_baseline": value / baseline,
    }


def main(argv: list[str] | None = None) -> dict:
    """Run the asked tiers on the card, one JSON line each, then the headline line.

    With no tier flag every tier runs. Raises without a CUDA device.
    """
    parser = argparse.ArgumentParser(
        prog="python -m rio_tpu_torch.bench", description=__doc__.split("\n\n")[0]
    )
    parser.add_argument("--tier", type=int, default=None,
                        help="objects of the dense solve tier (1,048,576 when every tier runs)")
    parser.add_argument("--collapsed", action="store_true",
                        help="the collapsed rebalance, warm-assign and incremental tiers")
    parser.add_argument("--delta", action="store_true", help="the full vs delta rebalance A/B")
    parser.add_argument("--hier", action="store_true", help="BASELINE row 5, hierarchical")
    parser.add_argument("--out", default=None, help="also write every result to this JSON file")
    args = parser.parse_args(argv)
    dev = resolve_device(None)
    every = not (args.tier or args.collapsed or args.delta or args.hier)
    detail: dict = {}

    def emit(name: str, result: dict) -> None:
        detail[name] = result
        print(json.dumps({"tier": name, **result}), flush=True)

    if args.collapsed or every:
        emit("collapsed_tier", collapsed_rate(1_048_576, device=dev))
        emit("warm_assign", warm_assign_rate(65_536, device=dev))
        emit("incremental", incremental_rate(1_048_576, device=dev))
    if args.tier or every:
        n_obj = args.tier or 1_048_576
        cost = tier_inputs(n_obj, N_NODES)
        emit("solve_tier", solve_rate(n_obj, cost=cost, device=dev))
        emit("greedy", greedy_rate(n_obj, cost=cost, device=dev))
        del cost
        if n_obj >= 1_048_576:
            # BASELINE row 3: 1M objects x 256 nodes; 15 iterations (1.5x the
            # reference's measured convergence point for this cost model).
            emit("baseline_row3_1m_x_256", solve_rate(1_048_576, n_nodes=256, n_iters=15, device=dev))
    if args.delta or every:
        emit("delta_tier", delta_churn_rate(1_048_576, device=dev))
    if args.hier or every:
        emit("baseline_row5_hier", hier_rate(10_485_760, device=dev))
    baseline = sqlite_baseline_rate()
    line = headline(detail, baseline)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"sqlite_baseline_rate": baseline, **detail, "headline": line}, fh, indent=1)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
