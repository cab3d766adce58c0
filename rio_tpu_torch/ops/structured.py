"""Class-collapsed rebalance solve: exact Sinkhorn at O(M^2), not O(N*M).

Counterpart of ``rio_tpu/ops/structured.py``. The directory's full-rebalance
cost model is

    cost[i, j] = base[j] - move_cost * [j == cur_i]

so every object with the same current seat has an IDENTICAL cost row, and
the (N objects x M nodes) Sinkhorn solve collapses exactly to an
(M classes x M nodes) solve with row masses equal to the per-seat object
counts. :func:`class_quotas` solves it and rounds each class's soft row to
integer quotas; :func:`expand_class_quotas` turns the quotas into one
target node per object, keeping ``quota[k, k]`` objects of class k in place.

Where the JAX version relies on ``jnp.argsort`` being stable, these pass
``stable=True``: the order of equal remainders decides which column gets a
unit. Its out-of-range gather in the binary search is clamped explicitly
(JAX clamps gathers; torch raises).
"""

from __future__ import annotations

import torch

from .assignment import rank_within_group
from .sinkhorn import sinkhorn

__all__ = ["class_quotas", "expand_class_quotas"]


def class_quotas(
    base_cost: torch.Tensor,
    counts: torch.Tensor,
    col_capacity: torch.Tensor,
    *,
    move_cost: float = 0.5,
    eps: float = 0.05,
    n_iters: int = 30,
    g_init: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Integer per-class quotas for the collapsed rebalance problem.

    Args:
      base_cost: (M,) per-node cost (load/liveness pricing; dead nodes at
        ``DEAD_NODE_COST``).
      counts: (M,) objects currently seated on each node class (float or
        int; class k = "objects whose current seat is node k").
      col_capacity: (M,) effective capacity (0 for dead nodes).
      move_cost: stay-put discount applied on the diagonal.
      g_init: optional (M,) warm-start node potentials.

    Returns:
      ``(quotas, g, err)``: quotas is (M, M) int32 where ``quotas[k, j]``
      objects of class k should end on node j — every row sums EXACTLY to
      ``counts[k]``; ``g`` is the (M,) node potential of the class solve;
      ``err`` is its scalar final L1 column-marginal violation.
    """
    m = base_cost.shape[0]
    dev = base_cost.device
    counts = counts.float()
    cost = base_cost.float()[None, :].expand(m, m) - move_cost * torch.eye(
        m, dtype=torch.float32, device=dev
    )
    res = sinkhorn(cost, counts, col_capacity, eps=eps, n_iters=n_iters, g_init=g_init)

    # Soft plan row-conditionals: P[k, :] / a_k (finite rows only).
    logit = (res.f[:, None] + res.g[None, :] - cost) / eps
    live_row = torch.isfinite(res.f)
    logit = torch.where(live_row[:, None], logit, float("-inf"))
    frac = torch.softmax(logit, dim=1)
    frac = torch.where(live_row[:, None], frac, 0.0)
    # Zero dead columns (their g is already -inf, but largest-remainder must
    # never hand a stray unit to a dead node) and renormalize live rows.
    frac = torch.where((col_capacity > 0)[None, :], frac, 0.0)
    frac = frac / frac.sum(dim=1, keepdim=True).clamp_min(1e-30)
    frac = torch.where(live_row[:, None], frac, 0.0)

    # Largest-remainder rounding to exact integer row sums.
    target = frac * counts[:, None]
    base = torch.floor(target)
    short = (counts - base.sum(dim=1)).to(torch.int32)  # (M,)
    remainder = target - base
    # rank[k, j] = position of column j in row k's descending-remainder
    # order; the top ``short[k]`` columns of each row get one extra unit.
    order = torch.argsort(-remainder, dim=1, stable=True)
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(m, device=dev)[None, :].expand(m, m))
    quotas = (base + (rank < short[:, None])).to(torch.int32)
    return quotas, res.g, res.err


def expand_class_quotas(quotas: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
    """Expand (M x M) class quotas into a per-object assignment on the device.

    Within class k (objects whose current seat is node k, in their stable
    per-class rank order) the first ``quotas[k, k]`` objects stay put and
    the rest fill the remaining columns in index order: the move-minimal
    application of :func:`class_quotas`, with the semantics of the host
    expansion ``torch_placement._apply_class_quotas``. An O(N log N) sort
    and an O(N log M) binary search of ``ceil(log2(M + 1))`` elementwise
    gathers; nothing of shape (N, M) is built.

    Args:
      quotas: (M, M) int32, rows summing exactly to per-class counts.
      cur: (B,) int32 current seats, padding rows AFTER the real rows (the
        provider pads with zeros; stable ranking keeps real class-0 ranks
        unaffected). Padding rows whose rank exceeds their class count get
        a clamped, meaningless target that callers mask.

    Returns:
      (B,) int32 target node per object.
    """
    m = quotas.shape[0]
    dev = quotas.device
    cols = torch.arange(m, dtype=torch.int32, device=dev)
    # Diag-first column order per row: [k, 0, 1, ..., k-1, k+1, ..., M-1].
    key = torch.where(cols[None, :] == cols[:, None], -1, cols[None, :])
    colorder = torch.argsort(key, dim=1, stable=True)
    cum = torch.cumsum(torch.gather(quotas, 1, colorder), dim=1)  # cum[k, -1] == counts[k]

    order, _, rank_sorted = rank_within_group(cur)
    rank = torch.empty_like(cur)
    rank[order] = rank_sorted.to(cur.dtype)

    # Smallest j with cum[cur_i, j] > rank_i (searchsorted side='right').
    # ``mid`` reaches M only for rows past their class count; the gather
    # clamps it to M - 1 as JAX's does.
    cur_l = cur.long()
    row_base = cur_l * m
    flat_cum = cum.reshape(-1)
    lo = torch.zeros_like(cur_l)
    hi = torch.full_like(cur_l, m)
    for _ in range(max(1, (m + 1).bit_length())):
        mid = (lo + hi) // 2
        go_right = flat_cum[row_base + mid.clamp_max(m - 1)] <= rank
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    jpos = lo.clamp(0, m - 1)
    return colorder.reshape(-1)[row_base + jpos].to(torch.int32)
