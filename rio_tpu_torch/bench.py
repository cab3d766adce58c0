"""The tiers of ``bench.py`` on the port: placements/sec on one CUDA card, route hops live, host stages.

    python -m rio_tpu_torch.bench [--tier N] [--collapsed] [--delta] [--hier] [--mesh-ab] [--live]
                                  [--affinity]
                                  [--rpc] [--egress] [--sharded] [--migration] [--hotkey]
                                  [--tracing] [--journal] [--series] [--spans] [--faults]
                                  [--streams] [--autoscale] [--qos] [--out PATH]

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
  in chunks of 655,360 rows;
* :func:`hier_mesh_ab` (``hier_mesh_ab``): the mesh x chunk solve over 8
  shards of the one device against the chunked solve at matched N, with
  a sampled transport-cost ratio;
* the live tiers, on the port's own actor runtime over real loopback TCP:
  :func:`row2_torch_provider_live` (``row2_jax_provider_live``, BASELINE
  row 2: 8 servers x 100,000 objects on :class:`TorchObjectPlacement`),
  :func:`live_route_hops` (8 servers x 2,048 objects) and
  :func:`scaled_route_hops` (64 servers x 50,000 objects and a stale
  directory). They measure route hops, the second half of the headline;
* :func:`affinity_payoff` (``affinity_payoff``): the affinity feedback
  loop on two live servers, blind vs affinity-fed placement on
  :class:`TorchObjectPlacement`, and the edge sampler's cost.
* the runtime tiers, ``bench.py``'s host stages at its sizes, with its
  result keys, on the port's runtime and no device: :func:`rpc_throughput`,
  :func:`rpc_egress`, :func:`rpc_sharded` (worker processes of
  :class:`~rio_tpu_torch.sharded.ShardedServer` driven by
  ``python -m rio_tpu_torch.sharded --loadgen`` children),
  :func:`migration_drain`, :func:`hotkey_scaleout`, :func:`tracing_overhead`,
  :func:`journal_overhead`, :func:`series_overhead`, :func:`spans_overhead`,
  :func:`faults_overhead`, :func:`streams_throughput`,
  :func:`autoscale_stage` and :func:`qos_stage` (:data:`RUNTIME_TIERS`).
  Only their in-session ratios compare across runs.

Timing is the reference's measurement without its relay defences. A single
call ends in ``torch.cuda.synchronize()`` and is the best of 3 after a warm
call (``_time_fn``). A chained time is ``k`` calls issued back to back,
each fed by the one before, with one synchronize at the end, best of 2
(``_time_chained``). Nothing is compiled, so ``compile_s`` and
``chain_compile_s`` read -1.

Every device tier runs on CUDA unless it is given ``device="cpu"``, and
raises without a card; of the live tiers only row 2 has a device (its
directory's). Every result names its device (``platform``, ``device``,
``power_limit``). Inputs are drawn from numpy seeds unless the caller hands
them in as arrays, as the tests do with the reference's ``jax.random`` draws.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sqlite3
import subprocess
import sys
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
from .ops import prng
from .parallel.hierarchical import (
    chunked_hierarchical_assign,
    chunked_hierarchical_assign_timed,
    hierarchical_assign,
    mesh_chunked_hierarchical_assign_timed,
)
from .parallel.mesh import make_mesh
from .registry import ObjectId
from .utils.routing_live import measure_route_hops_live, measure_route_hops_scaled

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


def hier_mesh_ab(
    n_obj: int = 2_097_152,
    *,
    device=None,
    n_nodes: int = N_NODES,
    n_groups: int = 32,
    cell_rows: int = 65_536,
    chunk_rows: int = 524_288,
    keep: dict | None = None,
) -> dict:
    """The mesh x chunk solve against the chunked-only solve at matched N (``bench.py`` ``hier_mesh_ab``).

    Arm ``mesh_chunk`` runs :func:`mesh_chunked_hierarchical_assign_timed`
    over 8 shards of the one device in ``cell_rows``-row cells; arm
    ``chunked_only`` runs :func:`chunked_hierarchical_assign_timed` in
    ``chunk_rows``-row chunks. The inputs are the reference's own draws
    from ``PRNGKey(18)`` (:mod:`~rio_tpu_torch.ops.prng`), 16 features a
    row, made on the device. ``transport_cost`` is each arm's mean
    best-minus-assigned affinity over 65,536 evenly spaced rows (the whole
    N x M affinity would be 8 GiB at the default size), and their ratio.
    With ``keep``, each arm's :class:`HierarchicalResult` is stored under
    its name.
    """
    dev = resolve_device(device)
    d, n_shards, sample_rows = 16, 8, 65_536
    if n_obj % (n_shards * cell_rows) or n_obj % chunk_rows:
        raise ValueError(f"{n_obj} rows split into neither {n_shards} x {cell_rows} cells "
                         f"nor {chunk_rows}-row chunks")
    k1, k2 = prng.split(prng.prng_key(18, dev))
    obj_feat = prng.normal_of(k1, (n_obj, d))
    node_feat = prng.normal_of(k2, (d, n_nodes)) * 0.2
    cap = torch.ones(n_nodes, dtype=torch.float32, device=dev)
    alive = torch.ones(n_nodes, dtype=torch.float32, device=dev)
    mesh = make_mesh([dev] * n_shards)
    _sync(dev)  # the draws finish before either arm's clock starts

    def arm(name, fn, n_chunks):
        t0 = time.perf_counter()
        res, chunk_ms = fn(obj_feat, node_feat, cap, alive, n_groups=n_groups, n_chunks=n_chunks)
        _sync(dev)
        wall = time.perf_counter() - t0
        if keep is not None:
            keep[name] = res
        return res.assignment, {
            "n_chunks": len(chunk_ms),
            "first_chunk_ms": chunk_ms[0],
            "steady_chunk_ms": float(np.median(chunk_ms[1:])) if len(chunk_ms) > 1 else None,
            "wall_s": wall,
            "rate": n_obj / wall,
            "overflow": int(res.overflow),
            "chunk_ms": chunk_ms,
        }

    a_mesh, mesh_stats = arm(
        "mesh_chunk",
        lambda *a, **kw: mesh_chunked_hierarchical_assign_timed(mesh, *a, **kw),
        n_obj // (n_shards * cell_rows),
    )
    a_chunk, chunk_stats = arm("chunked_only", chunked_hierarchical_assign_timed, n_obj // chunk_rows)

    idx = torch.arange(0, n_obj, max(1, n_obj // sample_rows), device=dev)[:sample_rows]
    on_s = obj_feat[idx] @ node_feat
    best = on_s.max(dim=1).values
    rows = torch.arange(idx.numel(), device=dev)
    cost_mesh = float((best - on_s[rows, a_mesh[idx].long()]).mean())
    cost_chunk = float((best - on_s[rows, a_chunk[idx].long()]).mean())
    return {
        "n_obj": n_obj,
        "n_nodes": n_nodes,
        "n_groups": n_groups,
        "devices": n_shards,
        "cell_rows": cell_rows,
        "mesh_chunk": mesh_stats,
        "chunked_only": chunk_stats,
        "transport_cost": {
            "mesh_chunk": cost_mesh,
            "chunked_only": cost_chunk,
            "ratio": cost_mesh / max(cost_chunk, 1e-12),
        },
        "host": {**_host_provenance(), **device_fields(dev)},
    }


# ---------------------------------------------------------------------------
# Live tiers: route hops over real loopback TCP on the port's runtime
# ---------------------------------------------------------------------------


def scaled_route_hops() -> dict:
    """64 servers x 50,000 objects, and a stale directory (``bench.py``'s ``scaled_route_hops``).

    The directory policy's hop win at scale, and its graceful degradation
    (redirects and dial fallback, no failure) when the directory serves a
    poisoned stale snapshot. The cluster's directory is ``LocalObjectPlacement``.
    """
    out = asyncio.run(measure_route_hops_scaled())
    print(
        f"# scaled routing ({out['n_servers']} servers, {out['n_objects']} objects, "
        f"{out['displaced']} displaced on {out['dead_servers']} killed nodes, {out['wrong']} wrong "
        f"pointers): reference mean={out['reference']['mean']} "
        f"p99={out['reference']['p99']:.0f} | directory mean={out['directory']['mean']} "
        f"p99={out['directory']['p99']:.0f} | STALE directory "
        f"mean={out['stale']['mean']} p99={out['stale']['p99']:.0f} "
        f"failures={out['stale_failures']}",
        file=sys.stderr,
    )
    return out


async def _watch_allocation(placement, n_objects: int, marks: dict) -> None:
    """Record when the directory gets its first row and when it holds ``n_objects``."""
    while True:
        n = placement.count()
        if n and "first" not in marks:
            marks["first"] = time.perf_counter()
        if n >= n_objects:
            marks["full"] = time.perf_counter()
            return
        await asyncio.sleep(0.005)


def row2_torch_provider_live(
    device=None, *, n_servers: int = 8, n_objects: int = 100_000, sample_size: int = 4_000
) -> dict:
    """BASELINE row 2: 8 servers x 100,000 objects on ``TorchObjectPlacement``.

    ``bench.py``'s ``row2_jax_provider_live`` with the port's provider on
    ``device`` (CUDA unless the caller asks for the CPU; it raises without
    a card) as the cluster's shared directory. Allocation flows through
    the servers' self-assign into the provider (host only: no kernel runs),
    and the directory-resolver policy then dials owners directly. Hops
    are taken over ``sample_size`` sampled ids under both policies.

    Besides the reference's ``ours`` and ``reference`` keys the result
    holds the device fields, ``directory_device`` (the provider's device),
    ``count`` (directory rows), ``alloc_s`` (the
    directory's first row to its last), ``alloc_rate`` (objects seated a
    second over that span), ``wall_s`` (the whole call: boot, allocation
    and ``2 * sample_size`` hop requests) and ``native`` (whether the C++
    envelope codec served).
    """
    from . import native

    dev = resolve_device(device)
    placement = TorchObjectPlacement(device=dev)
    marks: dict = {}

    async def run():
        watcher = asyncio.create_task(_watch_allocation(placement, n_objects, marks))
        try:
            return await measure_route_hops_live(
                n_servers=n_servers, n_objects=n_objects, placement=placement, sample_size=sample_size
            )
        finally:
            watcher.cancel()

    t0 = time.perf_counter()
    stats = asyncio.run(run())
    wall = time.perf_counter() - t0
    ref, ours = stats["reference"], stats["rio_tpu"]
    alloc_s = marks["full"] - marks["first"] if "full" in marks else float("nan")
    print(
        f"# row-2 live ({n_servers} servers, {n_objects} objects on TorchObjectPlacement, {dev}): "
        f"directory p99={ours.p99:.0f} mean={ours.mean:.2f} | "
        f"reference-policy p99={ref.p99:.0f} mean={ref.mean:.2f}",
        file=sys.stderr,
    )
    return {
        **device_fields(dev),
        "ours": ours.as_dict(),
        "reference": ref.as_dict(),
        "n_servers": n_servers,
        "n_objects": n_objects,
        "directory_device": str(placement.device),
        "count": placement.count(),
        "alloc_s": alloc_s,
        "alloc_rate": n_objects / alloc_s if alloc_s > 0 else float("nan"),
        "wall_s": wall,
        "native": native.get() is not None,
    }


def live_route_hops() -> dict:
    """p99 route hops across real TCP round trips, 8 servers x 2,048 objects.

    ``bench.py``'s ``live_route_hops``: the cluster's directory is
    ``LocalObjectPlacement``, so no device takes part.
    """
    stats = asyncio.run(measure_route_hops_live(n_servers=8, n_objects=2048))
    ref, ours = stats["reference"], stats["rio_tpu"]
    print(
        f"# measured route hops (live 8-server cluster, 2048 objects): "
        f"ours p99={ours.p99:.0f} mean={ours.mean:.2f} | "
        f"reference-policy p99={ref.p99:.0f} mean={ref.mean:.2f}",
        file=sys.stderr,
    )
    return {"ours": ours.as_dict(), "reference": ref.as_dict()}


def _host_provenance() -> dict:
    """``bench.py``'s host conditions: cores the run had and the load average."""
    prov: dict = {"cpu_count": os.cpu_count()}
    try:
        prov["sched_affinity"] = sorted(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        prov["sched_affinity"] = None
    try:
        prov["loadavg"] = [round(x, 2) for x in os.getloadavg()]
    except OSError:
        prov["loadavg"] = None
    return prov


def affinity_payoff(device=None) -> dict:
    """``bench.py``'s ``affinity_payoff`` with the provider on ``device``.

    The payoff: an adversarial multi-hop pipeline (producer and stream
    cursors seated on node 0, consumers on node 1) runs affinity-blind,
    then the merged edge graph is fed back through ``set_edge_graph`` and a
    full ``rebalance`` of :class:`TorchObjectPlacement` (CUDA unless the
    caller asks for the CPU), and the same traffic runs again; the
    transports' TCP byte counters price both phases. The cost: the
    dispatch-path edge sampler off vs on over an echo cluster on
    ``LocalObjectPlacement``, median paired ratio.

    The result has the reference's keys; ``host`` adds the device fields
    of the provider's device to the host's cores and load. Unlike the
    reference, nothing is written to disk.
    """
    from .utils.affinity_live import measure_affinity_payoff, measure_sampler_overhead

    dev = resolve_device(device)
    out = asyncio.run(measure_affinity_payoff(device=dev))
    out["sampler"] = asyncio.run(measure_sampler_overhead())
    out["host"] = {**_host_provenance(), **device_fields(dev)}
    tcp, spans = out["tcp_bytes"], out["delivery_wire_spans"]
    m = out["sampler"]["msgs_per_sec"]
    print(
        f"# affinity payoff ({out['n_records']} records x {out['pad_bytes']}B over "
        f"{out['partitions']} partitions, {out['edges_installed']} edges fed back, "
        f"{out['moves']} moves, solved as {out['solved_as']} on {dev}): TCP bytes blind "
        f"{tcp['blind']:,} -> affinity {tcp['affinity']:,} ({out['bytes_ratio']:.1f}x), "
        f"cross-node delivery wire spans {spans['blind']} -> {spans['affinity']}, "
        f"{out['pairs_colocated']}/{out['partitions']} pairs co-located; sampler off "
        f"{m['off']:,.0f}/s, on {m['on']:,.0f}/s "
        f"({out['sampler']['sampler_overhead_pct']:+}% median paired)",
        file=sys.stderr,
    )
    return out


# ---------------------------------------------------------------------------
# The runtime tiers: live clusters on the card's host, no device
# ---------------------------------------------------------------------------

# ``bench.py``'s sizes. Tests patch them smaller.
RPC_REQUESTS_PER_WORKER = 600  # per sender of the 64 of measure_rpc_throughput
SHARDED_WINDOW = {"n_workers": 32, "requests_per_worker": 300, "n_objects": 128}
SHARDED_LOADGEN = {"n_gens": 2, "n_workers": 16, "requests_per_worker": 200, "n_objects": 128}
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def prepare_node_storage(data_dir: str) -> None:
    """Create a sharded node's SQLite membership and directory before its workers start.

    N workers that open a fresh file at once each switch it to WAL, and
    ``PRAGMA journal_mode=WAL`` fails at once with "database is locked",
    busy timeout or not, while a peer holds a write lock: a worker then
    exits during bring-up (the reference's ``utils/sqlite.py`` and its copy
    alike; ROADMAP C.8). A file already in WAL mode makes the pragma a no-op.
    """
    from .sharded import sqlite_members, sqlite_placement

    async def prepare() -> None:
        for factory in (sqlite_members, sqlite_placement):
            store = factory(data_dir)
            try:
                await store.prepare()
            finally:
                store.close()

    asyncio.run(prepare())


def rpc_throughput(baseline: float | None = None) -> dict:
    """Actor data-plane msgs/sec per transport (2 servers, 64 senders), also on stderr.

    Every rate is anchored to the SQLite baseline measured in the same
    session (``{transport}_vs_sqlite``): a host's absolute rate drifts
    between sessions, the in-session ratio does not.
    """
    from . import native
    from .utils.routing_live import measure_rpc_throughput

    if baseline is None:
        baseline = sqlite_baseline_rate()
    transports = ["asyncio"] + (["native"] if native.get() is not None else [])
    rates: dict = {
        "sqlite_baseline_in_session": round(baseline),
        "host": _host_provenance(),
    }
    for transport in transports:
        rate = asyncio.run(
            measure_rpc_throughput(transport=transport, requests_per_worker=RPC_REQUESTS_PER_WORKER)
        )
        rates[transport] = round(rate)
        rates[f"{transport}_vs_sqlite"] = round(rate / baseline, 3)
        note = ""
        if transport == "native" and not native.engine_profitable():
            note = " (engine demoted: single-core host, thread handoff is pure loss)"
        print(
            f"# rpc throughput ({transport}, 2 servers, 64 workers): {rate:,.0f} msgs/sec = "
            f"{rate / baseline:.2f}x in-session sqlite baseline{note}",
            file=sys.stderr,
        )
    return rates


def rpc_egress(baseline: float | None = None, *, batches: int = 5) -> dict:
    """Egress coalescing on vs off (one write per done-callback wave vs one per frame).

    The load of :func:`rpc_throughput`; the knob gates the same seam in both
    transports, so both are measured when the native library builds.
    ``batches`` interleaved pairs, median per-batch ratio.
    """
    import statistics

    from . import aio, native
    from .utils.routing_live import measure_rpc_throughput

    if baseline is None:
        baseline = sqlite_baseline_rate()
    try:
        from .native import transport as native_transport
    except Exception:  # pragma: no cover - native build unavailable
        native_transport = None

    def set_coalesce(enabled: bool) -> None:
        aio._EGRESS_COALESCE = enabled
        if native_transport is not None:
            native_transport._EGRESS_COALESCE = enabled

    env_default = os.environ.get("RIO_TPU_EGRESS_COALESCE", "1") != "0"
    out: dict = {
        "sqlite_baseline_in_session": round(baseline),
        "host": _host_provenance(),
    }
    transports = ["asyncio"] + (["native"] if native.get() is not None else [])
    try:
        for transport in transports:
            per_frame, coalesced = [], []
            for _ in range(batches):
                set_coalesce(False)
                per_frame.append(asyncio.run(measure_rpc_throughput(
                    transport=transport, requests_per_worker=RPC_REQUESTS_PER_WORKER)))
                set_coalesce(True)
                coalesced.append(asyncio.run(measure_rpc_throughput(
                    transport=transport, requests_per_worker=RPC_REQUESTS_PER_WORKER)))
            ratio = statistics.median(c / p for p, c in zip(per_frame, coalesced))
            out[transport] = {
                "per_frame": [round(r) for r in per_frame],
                "coalesced": [round(r) for r in coalesced],
                "coalesced_vs_per_frame": round(ratio, 3),
                "vs_sqlite": round(coalesced[-1] / baseline, 3),
            }
            print(
                f"# rpc egress ({transport}, coalesced vs per-frame flush, paired): "
                f"{coalesced[-1]:,.0f} vs {per_frame[-1]:,.0f} msgs/sec = {ratio:.3f}x",
                file=sys.stderr,
            )
    finally:
        set_coalesce(env_default)
    return out


def rpc_sharded(
    baseline: float | None = None,
    *,
    ab_batches: int = 3,
    decode_batches: int = 5,
    aware_batches: int = 3,
) -> dict:
    """The sharded data plane's battery: real worker processes on loopback.

    Every pair is interleaved in the same session, and ``host`` records the
    cores the stage had:

    * ``one_worker``: 1 sharded worker (front door, identity port, shard
      router) vs 1 plain server child, ``ab_batches`` pairs;
    * ``batch_decode``: the per-read batch decode on vs off
      (``RIO_TPU_BATCH_DECODE``), ``decode_batches`` pairs;
    * ``n_workers``: the aggregate through N = max(2, min(4, cores)) workers,
      driven by ``python -m rio_tpu_torch.sharded --loadgen`` children;
    * ``shard_aware``: the same N-worker loadgen shape with clients that
      compute the shard themselves vs redirect-following ones,
      ``aware_batches`` pairs, and the audit: shard-aware clients pay no
      redirect for unplaced traffic;
    * ``engine``: N workers on the native transport vs asyncio (identity
      ports only), when the native library builds.

    The native library is built in this process first (``native.get()``),
    so no two children build it at once.
    """
    import shutil
    import statistics
    import tempfile

    from . import native
    from .sharded import ShardedServer, sqlite_members
    from .utils.routing_live import measure_rpc_external

    if baseline is None:
        baseline = sqlite_baseline_rate()
    have_native = native.get() is not None
    base_env = {
        "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
        "HOME": os.environ.get("HOME", "/tmp"),
        "PYTHONPATH": _ROOT,
    }
    echo = "rio_tpu_torch.utils.routing_live:build_echo_registry"
    nodes: list = []
    tmps: list[str] = []

    def boot(workers, *, router=True, front_door=True, env=None, server_kwargs=None):
        tmp = tempfile.mkdtemp(prefix="rio_sharded_bench_")
        tmps.append(tmp)
        prepare_node_storage(tmp)
        node = ShardedServer(
            address="127.0.0.1:0", workers=workers, registry=echo, data_dir=tmp,
            router=router, front_door=front_door, env=env, server_kwargs=server_kwargs,
        )
        node.start()
        nodes.append(node)
        asyncio.run(node.wait_ready(60.0))
        return node

    def window(node):
        members = sqlite_members(node.data_dir)
        try:
            return asyncio.run(measure_rpc_external(members, **SHARDED_WINDOW))
        finally:
            members.close()

    def paired(node_a, node_b, batches):
        """Interleaved A/B windows; median per-batch ratio b/a."""
        ra, rb = [], []
        for _ in range(batches):
            ra.append(window(node_a))
            rb.append(window(node_b))
        ratio = statistics.median(b / a for a, b in zip(ra, rb))
        return [round(r) for r in ra], [round(r) for r in rb], round(ratio, 3)

    def loadgen_aggregate(node, shard_aware=False, tag="lg"):
        """Concurrent measured windows from separate loadgen processes."""
        procs = []
        for g in range(SHARDED_LOADGEN["n_gens"]):
            p = subprocess.Popen(
                [sys.executable, "-m", "rio_tpu_torch.sharded", "--loadgen"],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=base_env, text=True,
            )
            spec = {
                "members": node.members_spec, "data_dir": node.data_dir,
                "n_objects": SHARDED_LOADGEN["n_objects"],
                "n_workers": SHARDED_LOADGEN["n_workers"],
                "requests_per_worker": SHARDED_LOADGEN["requests_per_worker"],
                "prefix": f"{tag}{g}", "shard_aware": shard_aware,
            }
            p.stdin.write(json.dumps(spec) + "\n")
            p.stdin.flush()
            procs.append(p)
        try:
            for p in procs:  # all generators warm before any measures
                assert "WARM" in p.stdout.readline()
            for p in procs:  # GO
                p.stdin.write("\n")
                p.stdin.flush()
            gens = []
            for p in procs:
                for line in p.stdout:
                    if line.startswith("RESULT "):
                        gens.append(json.loads(line[len("RESULT "):]))
                        break
                p.wait(timeout=60)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        return {
            "aggregate_rate": round(sum(g["rate"] for g in gens)),
            "redirects": sum(g.get("redirects", 0) for g in gens),
            "shard_routes": sum(g.get("shard_routes", 0) for g in gens),
            "generators": gens,
        }

    out: dict = {
        "sqlite_baseline_in_session": round(baseline),
        "host": _host_provenance(),
        "engine_profitable": native.engine_profitable(),
    }
    try:
        n = max(2, min(4, os.cpu_count() or 1))
        plain = boot(1, router=False, front_door=False)
        sharded1 = boot(1)
        pr, sr, ratio = paired(plain, sharded1, ab_batches)
        out["one_worker"] = {
            "plain_1proc": pr, "sharded_1worker": sr, "sharded_vs_plain": ratio,
            "vs_sqlite": round(sr[-1] / baseline, 3),
        }
        print(
            f"# rpc sharded (1 worker vs plain child, paired): "
            f"{sr[-1]:,.0f} vs {pr[-1]:,.0f} msgs/sec = {ratio:.3f}x",
            file=sys.stderr,
        )

        decode_off = boot(1, env={**base_env, "RIO_TPU_BATCH_DECODE": "0"})
        offr, onr, on_vs_off = paired(decode_off, sharded1, decode_batches)
        out["batch_decode"] = {"off": offr, "on": onr, "on_vs_off": on_vs_off}
        print(
            f"# rpc sharded (batch decode on vs off, paired): "
            f"{onr[-1]:,.0f} vs {offr[-1]:,.0f} msgs/sec = {on_vs_off:.3f}x",
            file=sys.stderr,
        )

        node_n = boot(n)
        agg = loadgen_aggregate(node_n)
        agg["n_workers"] = n
        agg["vs_sqlite"] = round(agg["aggregate_rate"] / baseline, 3)
        out["n_workers"] = agg
        print(
            f"# rpc sharded ({n} workers, {len(agg['generators'])} loadgen procs): "
            f"{agg['aggregate_rate']:,.0f} msgs/sec aggregate "
            f"({agg['vs_sqlite']:.2f}x in-session sqlite baseline)",
            file=sys.stderr,
        )

        # Fresh object prefixes per batch keep the traffic unplaced, so the
        # audit reads the claim exactly: shard-aware clients pay no redirect.
        rr_rates, sa_rates = [], []
        rr_redirects = sa_redirects = sa_routes = 0
        for b in range(aware_batches):
            a = loadgen_aggregate(node_n, shard_aware=False, tag=f"rd{b}g")
            s = loadgen_aggregate(node_n, shard_aware=True, tag=f"sa{b}g")
            rr_rates.append(a["aggregate_rate"])
            sa_rates.append(s["aggregate_rate"])
            rr_redirects += a["redirects"]
            sa_redirects += s["redirects"]
            sa_routes += s["shard_routes"]
        sa_ratio = statistics.median(s / a for a, s in zip(rr_rates, sa_rates))
        out["shard_aware"] = {
            "n_workers": n,
            "redirect_routed": rr_rates,
            "shard_aware": sa_rates,
            "shard_aware_vs_redirect": round(sa_ratio, 3),
            "redirects": {"redirect_routed": rr_redirects, "shard_aware": sa_redirects},
            "shard_routes": sa_routes,
        }
        print(
            f"# rpc sharded ({n} workers, shard-aware vs redirect-routed clients, paired): "
            f"{sa_rates[-1]:,.0f} vs {rr_rates[-1]:,.0f} msgs/sec aggregate = {sa_ratio:.3f}x; "
            f"redirects {sa_redirects} vs {rr_redirects}, {sa_routes} direct shard dials",
            file=sys.stderr,
        )

        if have_native:
            try:
                node_async = boot(n, front_door=False)
                node_native = boot(n, front_door=False, server_kwargs={"transport": "native"})
                ar, nr, native_vs = paired(node_async, node_native, ab_batches)
                out["engine"] = {"asyncio": ar, "native": nr, "native_vs_asyncio": native_vs}
                print(
                    f"# rpc sharded ({n} workers, native vs asyncio transport, paired): "
                    f"{nr[-1]:,.0f} vs {ar[-1]:,.0f} msgs/sec = {native_vs:.3f}x "
                    f"(engine_profitable={out['engine_profitable']})",
                    file=sys.stderr,
                )
            except Exception as e:
                # The workers' logs go with their temporary directory below.
                dead = {f"worker{i}": nodes[-1].worker_log(i)[-4000:]
                        for i, p in enumerate(nodes[-1].procs) if p.poll() is not None}
                out["engine"] = {"error": repr(e), "dead_worker_logs": dead}
                print(f"# rpc sharded engine A/B failed: {e!r} {dead}", file=sys.stderr)
    finally:
        for node in nodes:
            try:
                node.stop()
            except Exception:
                pass
        for tmp in tmps:
            shutil.rmtree(tmp, ignore_errors=True)
    return out


def migration_drain() -> dict:
    """A 1,000-object drain, batched with prefetch vs per key, in one session."""
    from .utils.migration_live import measure_migration_drain

    out = asyncio.run(measure_migration_drain())
    pk, bt = out["per_key"], out["batched"]
    print(
        f"# migration drain ({out['n_objects']} objects x {out['payload_bytes']} B volatile "
        f"state, 2 servers): batched+prefetch {bt['migrations_per_sec']:,.0f}/s (pinned mean "
        f"{bt['pinned_ms_mean']} ms, {bt['bursts']} bursts, {bt['prefetch_hits']} prefetch hits) "
        f"vs per-key {pk['migrations_per_sec']:,.0f}/s (pinned mean {pk['pinned_ms_mean']} ms) = "
        f"{out.get('speedup', 0):.2f}x, pinned-window ratio {out.get('pinned_window_ratio', 0):.3f}",
        file=sys.stderr,
    )
    return out


def hotkey_scaleout() -> dict:
    """Hot-key read p99, replica reads vs read-through-primary, on one seeded zipf stream."""
    from .utils.hotkey_live import measure_hotkey

    out = asyncio.run(measure_hotkey())
    base, rep = out["baseline"], out["replica_reads"]
    print(
        f"# hot-key read scale-out ({out['n_requests']} reqs @ {out['rate_per_sec']:,.0f}/s "
        f"open loop, hot key {out['hot_fraction']:.0%} of stream, {out['work_ms']:.0f} ms/read, "
        f"3 servers): replica reads hot p99 {rep['hot_p99_ms']:,.1f} ms "
        f"({rep.get('standby_reads', 0)} standby reads, {rep.get('read_sheds', 0)} sheds, "
        f"{rep.get('stale_refusals', 0)} stale refusals) vs read-through-primary "
        f"{base['hot_p99_ms']:,.1f} ms = {out.get('hot_p99_ratio', 0):.3f}x",
        file=sys.stderr,
    )
    return out


def tracing_overhead(**sizes) -> dict:
    """The RPC loop with spans disabled vs record-only vs sampled at 1.0 with a sink.

    ``sizes`` go to the harness (``batches=``); none runs ``bench.py``'s."""
    from .utils.tracing_live import measure_tracing_overhead

    out = asyncio.run(measure_tracing_overhead(**sizes))
    m = out["msgs_per_sec"]
    print(
        f"# tracing overhead ({out['batches']} interleaved batches x "
        f"{out['n_requests_per_batch']} reqs, 2 servers/mode, median paired ratio): disabled "
        f"{m['disabled']:,.0f}/s, record-only {m['record']:,.0f}/s "
        f"({out['record_overhead_pct']:+}%), sampled@1.0+sink {m['sampled']:,.0f}/s "
        f"({out['sampled_overhead_pct']:+}%)",
        file=sys.stderr,
    )
    return out


def journal_overhead(**sizes) -> dict:
    """The RPC loop with ``journal=False`` vs the default journal (bar: <= ~2%); ``sizes`` as above."""
    from .utils.journal_live import measure_journal_overhead

    out = asyncio.run(measure_journal_overhead(**sizes))
    m = out["msgs_per_sec"]
    print(
        f"# journal overhead ({out['batches']} interleaved batches x "
        f"{out['n_requests_per_batch']} reqs, 2 servers/mode, median paired ratio): off "
        f"{m['off']:,.0f}/s, on {m['on']:,.0f}/s ({out['journal_overhead_pct']:+}%, "
        f"{out['events_recorded_on']} control events recorded)",
        file=sys.stderr,
    )
    return out


def faults_overhead(**sizes) -> dict:
    """Bare storages vs the same wrapped around a disabled fault schedule, and the lookup ladder."""
    from .utils.faults_live import measure_faults_overhead

    out = asyncio.run(measure_faults_overhead(**sizes))
    out["host"] = _host_provenance()
    m = out["msgs_per_sec"]
    lk = out["lookup_ops_per_sec"]
    print(
        f"# faults overhead ({out['batches']} interleaved batches x "
        f"{out['n_requests_per_batch']} reqs, 2 servers/mode, median paired ratio): off "
        f"{m['off']:,.0f}/s, on {m['on']:,.0f}/s ({out['faults_overhead_pct']:+}%); trait "
        f"lookup bare {lk['bare']:,.0f}/s, disabled {lk['disabled']:,.0f}/s "
        f"({out['lookup_overhead_disabled_pct']:+}%), armed-idle {lk['armed_idle']:,.0f}/s "
        f"({out['lookup_overhead_armed_idle_pct']:+}%)",
        file=sys.stderr,
    )
    return out


def autoscale_stage(ramp: dict | None = None, **idle_sizes) -> dict:
    """Autoscaling's idle cost (absent vs armed but pinned) and the ramp soak.

    The soak drives offered load up and back down against a supervisor with
    a ``SubprocessProvisioner`` (nodes are ``python -m rio_tpu_torch.autoscale
    --node`` processes) under storage blips and a SIGKILL mid-drain; the
    harness raises on a lost acked write or a broken journal chain.
    ``idle_sizes`` go to the idle A/B (``batches=``); ``ramp`` holds keywords
    of ``measure_autoscale_ramp`` (``high_timeout=``, ``settle_timeout=``).
    """
    from .utils.autoscale_live import measure_autoscale_idle_overhead, measure_autoscale_ramp

    out: dict = {"idle": asyncio.run(measure_autoscale_idle_overhead(**idle_sizes))}
    out["ramp"] = asyncio.run(measure_autoscale_ramp(**(ramp or {})))
    out["host"] = _host_provenance()
    idle, ramp = out["idle"], out["ramp"]
    m = idle["msgs_per_sec"]
    print(
        f"# autoscale idle overhead ({idle['batches']} interleaved batches x "
        f"{idle['n_requests_per_batch']} reqs, median paired ratio): off {m['off']:,.0f}/s, on "
        f"{m['on']:,.0f}/s ({idle['autoscale_overhead_pct']:+}%, {idle['controller_ticks_on']} "
        f"controller ticks); ramp soak {ramp['seconds']:.0f}s: {ramp['scale_outs']} out / "
        f"{ramp['scale_ins']} in, {ramp['acked_writes']} acked writes lost={ramp['lost']} "
        f"(dups {ramp['duplicates']}), p99 {ramp['p99_ms']:.0f} ms, SIGKILL mid-drain "
        f"{ramp['killed_mid_drain'] or 'NONE'}, {ramp['storage_blips']} storage blips",
        file=sys.stderr,
    )
    return out


def streams_throughput() -> dict:
    """Durable streams: the redelivery backstop idle vs ticking every 0.05 s, zero loss in both."""
    from .utils.streams_live import measure_streams_overhead

    out = asyncio.run(measure_streams_overhead())
    out["host"] = _host_provenance()
    pub, e2e = out["publish_acks_per_sec"], out["deliver_msgs_per_sec"]
    print(
        f"# streams throughput ({out['batches']} interleaved batches x "
        f"{out['publishes_per_batch']} publishes, 2 servers/mode, "
        f"{out['partitions_active']['on']} partitions, median paired ratio): publish acks off "
        f"{pub['off']:,.0f}/s, on {pub['on']:,.0f}/s; e2e deliver off {e2e['off']:,.0f}/s, on "
        f"{e2e['on']:,.0f}/s ({out['redelivery_overhead_pct']:+}% redelivery backstop); zero "
        f"loss both modes ({out['delivered']['on']} delivered)",
        file=sys.stderr,
    )
    return out


def qos_stage(fast: bool = False) -> dict:
    """QoS: uniform traffic off vs the default config, and interactive p99 under a bulk flood.

    ``fast`` is the harness's: 16 paired batches and 40 probes, not 48 and 80."""
    from .utils.qos_live import measure_qos

    out = asyncio.run(measure_qos(fast=fast))
    out["host"] = _host_provenance()
    u, f = out["uniform"], out["flood"]
    m = u["msgs_per_sec"]
    print(
        f"# qos ({u['batches']} interleaved batches x {u['n_requests_per_batch']} echoes, "
        f"2 servers/mode): uniform off {m['off']:,.0f}/s, on {m['on']:,.0f}/s "
        f"({u['qos_overhead_pct']:+}% median paired); flood ({f['bulk_workers']} bulk workers "
        f"on one hot object, max_concurrent {f['max_concurrent_on']}): interactive p99 off "
        f"{f['off']['interactive_p99_ms']} ms -> on {f['on']['interactive_p99_ms']} ms "
        f"({f['interactive_p99_improvement']}x), {f['interactive_sheds_on']} interactive sheds",
        file=sys.stderr,
    )
    return out


def series_overhead(**sizes) -> dict:
    """The RPC loop with ``timeseries=False`` vs sampling every 0.05 s (bar: <= ~1%); ``sizes`` as above."""
    from .utils.series_live import measure_series_overhead

    out = asyncio.run(measure_series_overhead(**sizes))
    out["host"] = _host_provenance()
    m = out["msgs_per_sec"]
    print(
        f"# series overhead ({out['batches']} interleaved batches x "
        f"{out['n_requests_per_batch']} reqs, 2 servers/mode, sampling @"
        f"{out['sample_interval_s']}s, median paired ratio): off {m['off']:,.0f}/s, on "
        f"{m['on']:,.0f}/s ({out['series_overhead_pct']:+}%, {out['samples_on']} samples, "
        f"{out['health_alerts_fired_on']} alerts fired)",
        file=sys.stderr,
    )
    return out


def spans_overhead(**sizes) -> dict:
    """``spans=False`` vs retention with tail capture at a 1 ms SLO (bar: <= ~2%); ``sizes`` as above."""
    from .utils.spans_live import measure_spans_overhead

    out = asyncio.run(measure_spans_overhead(**sizes))
    out["host"] = _host_provenance()
    m = out["msgs_per_sec"]
    print(
        f"# spans overhead ({out['batches']} interleaved batches x "
        f"{out['n_requests_per_batch']} reqs, 2 servers/mode, tail SLO {out['slo_ms']}ms, "
        f"median paired ratio): off {m['off']:,.0f}/s, on {m['on']:,.0f}/s "
        f"({out['spans_overhead_pct']:+}%, {out['retained_on']} retained, "
        f"{out['tail_captured_on']} tail-captured)",
        file=sys.stderr,
    )
    return out


# flag -> (detail key, tier), in ``bench.py``'s order of the host stages.
RUNTIME_TIERS = {
    "rpc": ("rpc_msgs_per_sec", rpc_throughput),
    "egress": ("rpc_egress", rpc_egress),
    "sharded": ("rpc_sharded", rpc_sharded),
    "migration": ("migration_drain", migration_drain),
    "hotkey": ("hotkey", hotkey_scaleout),
    "tracing": ("tracing", tracing_overhead),
    "journal": ("journal", journal_overhead),
    "series": ("series", series_overhead),
    "spans": ("spans", spans_overhead),
    "faults": ("faults", faults_overhead),
    "streams": ("streams", streams_throughput),
    "autoscale": ("autoscale", autoscale_stage),
    "qos": ("qos", qos_stage),
}


# ---------------------------------------------------------------------------
# Command line
# ---------------------------------------------------------------------------


def headline(detail: dict, baseline: float) -> dict:
    """The reference's last line, ``{"metric", "value", "unit", "vs_baseline"}``.

    The collapsed rebalance leads when it ran, else the dense solve, the
    hierarchical solve, then the delta rebalance (objects re-decided per
    second). When ``route_hops`` ran, the metric ends in "measured p99 hops
    {ours} vs {reference}", as ``bench.py``'s does; else in "hops
    unmeasured". With only the live tiers run, the value is the directory
    policy's p99 hops, the unit ``hops`` and ``vs_baseline`` its ratio to
    the reference policy's.
    """
    if "route_hops" in detail:
        h = detail["route_hops"]
        hop_str = f"measured p99 hops {h['ours']['p99']:.0f} vs {h['reference']['p99']:.0f}"
    else:
        h, hop_str = None, "hops unmeasured"
    first = next((r for r in detail.values() if "device" in r), None)
    card = f"{first['device']}, power limit {first['power_limit']}" if first else "no device"
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
            f"{hop_str})"
        )
        value = c["rate"]
    elif "solve_tier" in detail:
        s = detail["solve_tier"]
        metric = (
            f"placements/sec (OT solve, {s['n_obj']} objects x {s['n_nodes']} nodes, "
            f"{card}; {hop_str})"
        )
        value = s["rate"]
    elif "baseline_row5_hier" in detail:
        r = detail["baseline_row5_hier"]
        metric = (
            f"placements/sec (hierarchical OT, {r['n_obj']} objects x {r['n_nodes']} nodes "
            f"in {r['n_chunks']} chunks, {card}; {hop_str})"
        )
        value = r["rate"]
    elif "delta_tier" in detail:
        t = detail["delta_tier"]
        metric = (
            f"placements/sec (delta rebalance of {t['n_obj']} objects x {t['n_nodes']} nodes "
            f"after one node death, {t['delta_moved']} moved, {card}; {hop_str})"
        )
        value = t["n_obj"] / (t["delta_ms"] / 1e3)
    else:
        metric = f"p99 route hops (live 8-server cluster, directory policy, {card}; {hop_str})"
        return {
            "metric": metric,
            "value": h["ours"]["p99"],
            "unit": "hops",
            "vs_baseline": h["ours"]["p99"] / h["reference"]["p99"],
        }
    return {
        "metric": metric,
        "value": value,
        "unit": "placements/sec",
        "vs_baseline": value / baseline,
    }


def main(argv: list[str] | None = None) -> dict:
    """Run the asked tiers, one JSON line each, then the headline line.

    With no tier flag every tier runs. The device tiers raise without a
    CUDA device; the runtime tiers (``--rpc`` ... ``--qos``) run on the
    host and need none. ``--affinity`` or ``--mesh-ab`` alone prints its
    line and returns its result (``--hier --mesh-ab`` runs the A/B alone,
    as in the reference); runtime tiers with no device tier return their
    results; in both cases with no headline, which only the other device
    and live tiers feed.
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
    parser.add_argument("--mesh-ab", action="store_true",
                        help="the mesh x chunk vs chunked-only A/B (with --hier: that tier alone)")
    parser.add_argument("--live", action="store_true",
                        help="the live tiers: scaled routing, BASELINE row 2 and route hops")
    parser.add_argument("--affinity", action="store_true",
                        help="the affinity feedback loop's payoff and the edge sampler's cost")
    for flag, (key, tier) in RUNTIME_TIERS.items():
        parser.add_argument(f"--{flag}", action="store_true",
                            help=f"runtime tier {tier.__name__} (detail key {key!r})")
    parser.add_argument("--out", default=None, help="also write every result to this JSON file")
    args = parser.parse_args(argv)
    runtime = [flag for flag in RUNTIME_TIERS if getattr(args, flag)]
    device_asked = bool(args.tier or args.collapsed or args.delta or args.hier or args.mesh_ab
                        or args.live or args.affinity)
    every = not (device_asked or runtime)
    dev = resolve_device(None) if device_asked or every else None
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
    if (args.hier and not args.mesh_ab) or every:
        emit("baseline_row5_hier", hier_rate(10_485_760, device=dev))
    if args.mesh_ab or every:
        emit("hier_mesh_ab", hier_mesh_ab(device=dev))
    baseline = None
    for flag, (key, tier) in RUNTIME_TIERS.items():
        if flag in runtime or every:
            if flag in ("rpc", "egress", "sharded"):
                if baseline is None:
                    baseline = sqlite_baseline_rate()
                result = tier(baseline)
            else:
                result = tier()
            result.setdefault("host", _host_provenance())
            emit(key, result)
    if args.live or every:
        emit("scaled_routing", scaled_route_hops())
        emit("row2_torch_provider", row2_torch_provider_live(dev))
        emit("route_hops", live_route_hops())
    if args.affinity or every:
        emit("affinity", affinity_payoff(dev))
    runtime_keys = {key for key, _tier in RUNTIME_TIERS.values()}
    alone = {"affinity", "hier_mesh_ab"}
    if not set(detail) - runtime_keys - alone:
        # Neither the payoff, the mesh A/B nor a runtime tier has
        # placements/sec or hops to head a line with.
        if args.out:
            with open(args.out, "w") as fh:
                json.dump(detail, fh, indent=1)
        return detail[next(iter(detail))] if len(detail) == 1 and set(detail) <= alone else detail
    baseline = baseline or sqlite_baseline_rate()
    line = headline(detail, baseline)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"sqlite_baseline_rate": baseline, **detail, "headline": line}, fh, indent=1)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
