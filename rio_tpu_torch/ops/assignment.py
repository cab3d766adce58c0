"""Cost-matrix construction and greedy balanced assignment.

Counterpart of ``rio_tpu/ops/assignment.py``. The cost model is

  cost[i, j] = load_penalty * (node_load[j] / capacity[j])
             + affinity_penalty * (1 - affinity[i, j])
             + BIG * (1 - alive[j])

Dead nodes are priced out rather than masked, so the matrix keeps its shape
when the cluster changes size. The two host-numpy helpers are copies of the
JAX module's: importing that module would load jax.
"""

from __future__ import annotations

import numpy as np
import torch

DEAD_NODE_COST = 1e6


def integer_fair_quotas(cap_alive: np.ndarray, n: int) -> np.ndarray:
    """Largest-remainder integer fair shares of ``n`` seats (host numpy).

    Per-node quotas proportional to schedulable capacity: floors plus one
    bonus unit for the ``n - sum(floors)`` largest remainders, summing to
    ``n`` exactly. No global rescale of the raw shares (a floating-point
    rescale flips floor/remainder units on exact-integer columns at large
    scale). Zero-capacity nodes get zero share and zero quota.
    """
    cap = np.maximum(np.asarray(cap_alive, np.float64), 0.0)
    total = cap.sum()
    if n <= 0 or total <= 0.0:
        return np.zeros(cap.shape[0], np.int64)
    target = cap / total * n
    quota = np.floor(target).astype(np.int64)
    short = n - int(quota.sum())
    if short > 0:
        # Remainder ties prefer the higher-capacity column.
        rem_order = np.lexsort((-cap, -(target - quota)))
        quota[rem_order[:short]] += 1
    return quota


def residual_capacity_assign(score: np.ndarray, residual: np.ndarray) -> np.ndarray:
    """Seat D displaced objects into integer residual quotas (host numpy).

    ``residual[j]`` is node j's remaining quota (summing to D); ``score[j]``
    orders the fill, cheapest node first. Displaced objects are
    interchangeable under the flat cost model, so contiguous per-node runs
    are exact, O(D) and deterministic. Returns (D,) int32 node indices.
    """
    residual = np.asarray(residual, np.int64)
    order = np.argsort(np.asarray(score, np.float64), kind="stable")
    return np.repeat(order, residual[order]).astype(np.int32)


def build_cost_matrix(
    node_load: torch.Tensor,
    node_capacity: torch.Tensor,
    alive: torch.Tensor,
    affinity: torch.Tensor | None = None,
    *,
    load_weight: float = 1.0,
    affinity_weight: float = 0.25,
) -> torch.Tensor:
    """(n_objects, n_nodes) cost from liveness and relative load (and affinity).

    Without ``affinity`` the costs are per node only and the result is
    (1, n_nodes).
    """
    cap = node_capacity.float().clamp_min(1e-6)
    per_node = load_weight * (node_load.float() / cap)
    per_node = per_node + DEAD_NODE_COST * (1.0 - alive.float())
    if affinity is None:
        return per_node[None, :]
    aff = affinity_weight * (1.0 - affinity.float())
    return per_node[None, :] + aff


def assign_from_potentials(cost_rows: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Incremental placement: ``argmin_j cost[i, j] - g[j]`` against cached potentials."""
    g = torch.where(torch.isfinite(g), g, float("-inf"))
    return torch.argmin(cost_rows.float() - g[None, :], dim=1).to(torch.int32)


def rank_within_group(
    keys: torch.Tensor, group_keys: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-element rank among equal group keys, via one stable sort.

    Returns ``(order, sorted_group_keys, rank_sorted)``: elements in the
    stable order of ``keys``, and each one's rank within its run of equal
    ``group_keys`` (default: ``keys``). ``group_keys`` must not decrease
    along that order (as ``keys // 2`` of composite keys does), so each
    run's start is a left ``searchsorted`` of the sorted groups: one
    parallel search, in place of the JAX version's ``associative_scan(max)``
    of run starts, which on CUDA is a one-block scan.
    """
    order = torch.argsort(keys, stable=True)
    sorted_groups = (keys if group_keys is None else group_keys)[order]
    pos = torch.arange(keys.shape[0], device=keys.device)
    group_start = torch.searchsorted(sorted_groups, sorted_groups)
    return order, sorted_groups, (pos - group_start).to(torch.int32)


def greedy_balanced_assign(
    cost: torch.Tensor,
    row_mass: torch.Tensor,
    node_capacity: torch.Tensor,
    node_load: torch.Tensor | None = None,
) -> torch.Tensor:
    """Capacity-proportional waterfilling: the cheap balanced-assignment tier.

    Nodes sorted by column-mean cost absorb mass up to their headroom (fair
    share of existing plus incoming load, less current load); objects are
    laid onto that partition by cumulative-mass position. Zero-capacity
    nodes get zero-width intervals and are never chosen.
    """
    cost = cost.float()
    mass = row_mass.float().clamp_min(0.0)
    cap = node_capacity.float().clamp_min(0.0)
    n_nodes = cost.shape[1]
    load = (
        torch.zeros(n_nodes, dtype=torch.float32, device=cost.device)
        if node_load is None
        else node_load.float()
    )

    total_mass = mass.sum()
    cap_share = cap / cap.sum().clamp_min(1e-30)
    fair = (total_mass + load.sum()) * cap_share
    headroom = (fair - load).clamp_min(0.0)
    # At or over fair everywhere: fall back to pure capacity shares.
    total_headroom = headroom.sum()
    width = torch.where(total_headroom > 1e-30, headroom, cap_share * total_mass)
    width = width * (total_mass / width.sum().clamp_min(1e-30))

    score = cost.mean(dim=0) + DEAD_NODE_COST * (cap <= 0)
    order = torch.argsort(score, stable=True)
    boundaries = torch.cumsum(width[order], dim=0)
    pos = torch.cumsum(mass, dim=0) - 0.5 * mass
    idx = torch.searchsorted(boundaries, pos, right=False).clamp(0, n_nodes - 1)
    return order[idx].to(torch.int32)
