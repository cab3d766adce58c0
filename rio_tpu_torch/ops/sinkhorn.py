"""Log-domain Sinkhorn (entropic optimal transport) for object placement.

Counterpart of ``rio_tpu/ops/sinkhorn.py``. Solves
``min_P <C, P> - eps * H(P)`` subject to ``P @ 1 = a`` (each object carries
its mass) and ``P.T @ 1 = b`` (each node absorbs up to its capacity share).
The optimal plan is ``P = exp((f + g - C) / eps)``; the hard assignment of
object ``i`` is ``argmin_j C[i, j] - g[j]``.

Also here: capacity-aware rounding of the soft plan (from potentials or
from the scaling-form state) and the largest-remainder exact-quota repair
that lands every node on its integer quota.

:func:`normalize_marginals`, :func:`marginal_err`, :func:`plan_rounded_assign`,
:func:`exact_quota_repair` and :func:`route_sentinel_spill` also take a
leading batch axis (``(G, n)`` rows, ``(G, n, m)`` costs): each of the ``G``
problems is solved on its own, and row ``g`` of the result equals the
unbatched call on problem ``g`` exactly. The hierarchical solve's fine
stage runs its ``G`` per-group problems that way (the JAX fine stage is a
``jax.vmap``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .assignment import rank_within_group
from .potential_round import potential_round


class SinkhornResult(NamedTuple):
    """Dual potentials and diagnostics from a Sinkhorn solve."""

    f: torch.Tensor  # (n_objects,) object potentials, float32
    g: torch.Tensor  # (n_nodes,) node potentials, float32
    err: torch.Tensor  # scalar: final L1 column-marginal violation


_NEG_INF = float("-inf")


def _safe_log(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x.clamp_min(1e-30))


def normalize_marginals(row_mass: torch.Tensor, col_capacity: torch.Tensor):
    """Scale both marginals to unit total mass (float32), per problem of a batch."""
    a = row_mass.float()
    b = col_capacity.float()
    a = a / a.sum(-1, keepdim=True).clamp_min(1e-30)
    b = b / b.sum(-1, keepdim=True).clamp_min(1e-30)
    return a, b


def log_marginals(a: torch.Tensor, b: torch.Tensor):
    """``(log a, log b)`` of normalized marginals, -inf where a mass is 0."""
    return (
        torch.where(a > 0, _safe_log(a), _NEG_INF),
        torch.where(b > 0, _safe_log(b), _NEG_INF),
    )


def marginal_err(
    cost: torch.Tensor, f: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float
) -> torch.Tensor:
    """L1 column-marginal violation of the implied plan (diagnostic)."""
    log_p = (f[..., :, None] + g[..., None, :] - cost.float()) / eps
    col = torch.exp(torch.where(torch.isfinite(log_p), log_p, _NEG_INF)).sum(dim=-2)
    return (col - b).abs().sum(-1)


def pad_axis_to(x: torch.Tensor, size: int, axis: int, fill: float) -> torch.Tensor:
    """Pad ``x`` along ``axis`` up to ``size`` with ``fill`` (no-op if equal)."""
    pad = size - x.shape[axis]
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_full(shape, fill)], dim=axis)


def sinkhorn(
    cost: torch.Tensor,
    row_mass: torch.Tensor,
    col_capacity: torch.Tensor,
    *,
    eps: float = 0.05,
    n_iters: int = 50,
    g_init: torch.Tensor | None = None,
) -> SinkhornResult:
    """Run ``n_iters`` log-domain Sinkhorn iterations.

    Rows with zero mass are padding (``f = -inf``); columns with zero
    capacity are dead (``g = -inf``). ``g_init`` warm-starts the first
    f-update; its non-finite entries are treated as cold (0).
    """
    cost = cost.float()
    a, b = normalize_marginals(row_mass, col_capacity)
    log_a, log_b = log_marginals(a, b)
    finite_a = torch.isfinite(log_a)
    finite_b = torch.isfinite(log_b)

    f = torch.zeros(cost.shape[0], dtype=torch.float32, device=cost.device)
    if g_init is None:
        g = torch.zeros(cost.shape[1], dtype=torch.float32, device=cost.device)
    else:
        g = torch.where(torch.isfinite(g_init), g_init.float(), 0.0)
    for _ in range(n_iters):
        f = eps * (log_a - torch.logsumexp((g[None, :] - cost) / eps, dim=1))
        f = torch.where(finite_a, f, _NEG_INF)
        g = eps * (log_b - torch.logsumexp((f[:, None] - cost) / eps, dim=0))
        g = torch.where(finite_b, g, _NEG_INF)
    return SinkhornResult(f=f, g=g, err=marginal_err(cost, f, g, b, eps))


def _quantiles(is_real: torch.Tensor) -> torch.Tensor:
    """Each real row's deterministic quantile ``(rank + 0.5) / n_real``; 0.5 for padding."""
    realf = is_real.float()
    n_real = realf.sum(-1, keepdim=True).clamp_min(1.0)
    rank = torch.cumsum(realf, dim=-1) - 1.0
    return torch.where(is_real, (rank + 0.5) / n_real, 0.5)


def block_quantiles(is_real: torch.Tensor, chunk: int | None = None) -> torch.Tensor:
    """Each row's quantile among the real rows of its block of ``chunk`` rows: ``_quantiles`` per block.

    ``chunk=None`` ranks all rows together. The row count must be a
    multiple of ``chunk``. Ranking each block on its own, as ``bench.py``
    does, equals ranking all rows together only where every row is real
    with the same mass (each block then spreads over the same marginals).
    """
    if chunk is None:
        return _quantiles(is_real)
    if is_real.shape[0] % chunk:
        raise ValueError(f"{is_real.shape[0]} rows are not a multiple of chunk={chunk}")
    return _quantiles(is_real.view(-1, chunk)).view(-1)


def plan_rounded_assign(
    cost: torch.Tensor, f: torch.Tensor, g: torch.Tensor, eps: float = 0.05
) -> torch.Tensor:
    """Capacity-aware hard rounding of the soft transport plan.

    Object ``i`` inverts its row's CDF at the deterministic quantile
    ``(rank + 0.5) / n_real`` among real rows, so aggregate node loads
    match the plan's column marginals while identical rows spread
    contiguously. Padding rows (``f = -inf``) fall back to the uniform
    distribution over live columns. The rounding itself is
    :func:`~rio_tpu_torch.ops.potential_round.potential_round`: one kernel
    launch on a CUDA cost of at most 32 columns, the eager chain else.
    """
    q = _quantiles(torch.isfinite(f))
    return potential_round(
        cost.float().contiguous(), f.float().contiguous(), g.float().contiguous(), q, eps
    )


def plan_rounded_assign_from_scaling(
    K: torch.Tensor, u: torch.Tensor, v: torch.Tensor, q: torch.Tensor | None = None
) -> torch.Tensor:
    """:func:`plan_rounded_assign` from the scaling-form state ``P = diag(u) K diag(v)``.

    Reads the (usually bfloat16) ``K`` the solve already built, instead of
    the float32 cost, and takes no transcendental. Padding rows (``u == 0``)
    spread uniformly over live columns (``v > 0``). ``q`` gives each row's
    quantile; by default the rows are ranked among themselves.
    """
    u = u.float()
    v = v.float()
    is_real = u > 0
    alive = (v > 0).float()
    p = u[:, None] * K.float() * v[None, :]
    p = torch.where(is_real[:, None], p, alive[None, :])
    cum = torch.cumsum(p, dim=1)
    total = cum[:, -1:].clamp_min(1e-30)
    if q is None:
        q = _quantiles(is_real)
    idx = (cum < q[:, None] * total).sum(dim=1, dtype=torch.int32)
    return idx.clamp(0, K.shape[1] - 1)


def scaling_row_residuals(
    K: torch.Tensor, u: torch.Tensor, v: torch.Tensor, a: torch.Tensor
) -> torch.Tensor:
    """Each row's marginal residual ``|u_i (K vk)_i - a_i|`` of the scaling-form plan.

    ``vk`` is ``v`` cast to K's dtype, and the product is taken in float32.
    """
    vk = v.to(K.dtype).float()
    return (u * (K.float() @ vk) - a).abs()


def exact_quota_repair(
    idx: torch.Tensor,
    expected_counts: torch.Tensor,
    prefer_keep: torch.Tensor | None = None,
) -> torch.Tensor:
    """Make a rounded assignment match integer column quotas EXACTLY.

    Quotas are the largest-remainder integers of ``expected_counts``; every
    object whose column is within quota keeps its seat, and only the excess
    re-slots into under-quota columns. Zero-expected (dead) columns end up
    empty.

    Args:
      idx: (..., n) int32 initial assignment (e.g. from plan rounding), in
        ``[0, m)``.
      expected_counts: (..., m) float expected objects per column; each
        problem's sums to ~n.
      prefer_keep: optional (..., n) bool — objects to evict LAST from an
        over-quota column.

    A batch of problems is repaired in one pass: each row's column ``j``
    becomes the cell ``g * m + j``, so one stable sort ranks every row's
    objects within their columns, and the refill searches each row's own
    deficit cumsum.
    """
    n = idx.shape[-1]
    m = expected_counts.shape[-1]
    dev = idx.device
    n_rows = math.prod(idx.shape[:-1])
    idx2 = idx.reshape(n_rows, n)
    cell = torch.arange(n_rows, device=dev)[:, None] * m + idx2  # (rows, n) int64
    flat_cell = cell.reshape(-1)
    # scatter_add_ into the known cells: bincount on CUDA waits on the host.
    counts = (
        torch.zeros(n_rows * m, dtype=torch.int64, device=dev)
        .scatter_add_(0, flat_cell, torch.ones_like(flat_cell))
        .view(n_rows, m)
    )
    scaled = expected_counts.reshape(n_rows, m).float().clamp_min(0.0)
    # NO global rescale to sum n here: multiplying every column by
    # n/sum(scaled) perturbs each by the fp32 summation error, and at
    # 2^24-scale totals that flips floor/remainder units on exact-integer
    # columns. Raw marginals keep integer columns' floors exact (remainder
    # 0, so no largest-remainder bonus), and the integer shortfall below
    # absorbs caller drift exactly. The clip guards the "sums to ~n"
    # contract: an undershooting caller underfills instead of being
    # silently renormalized.
    base = torch.floor(scaled).to(torch.int32)
    rem = scaled - base
    short = torch.clamp(n - base.sum(-1, keepdim=True), 0, m)
    # Largest remainders get the leftover units; remainder ties prefer the
    # more-occupied column, then the lower index (jnp.lexsort((-counts,
    # -rem)) as two stable sorts, secondary key first).
    by_count = torch.argsort(-counts, dim=-1, stable=True)
    rem_order = by_count.gather(
        -1, torch.argsort(-rem.gather(-1, by_count), dim=-1, stable=True)
    )
    won = (torch.arange(m, device=dev) < short).to(torch.int32)
    quota = base + torch.zeros_like(base).scatter_(-1, rem_order, won)

    # Within-column rank: keep iff rank < quota[cell]. With prefer_keep,
    # sort by (cell, not-preferred) so preferred objects take low ranks.
    if prefer_keep is None:
        order, sorted_cell, rank = rank_within_group(flat_cell)
    else:
        composite = flat_cell * 2 + (1 - prefer_keep.reshape(-1).long())
        order, sorted_cell, rank = rank_within_group(composite, flat_cell)
    keep = (rank < quota.reshape(-1)[sorted_cell]).view(n_rows, n)

    # Excess objects fill the row's under-quota columns in cumulative
    # order (the sort keeps rows contiguous, n objects each).
    deficit = (quota - counts).clamp_min(0)
    bounds = torch.cumsum(deficit, dim=-1, dtype=torch.int64)
    disp_rank = torch.cumsum((~keep).to(torch.int64), dim=-1) - 1
    refill = torch.searchsorted(bounds, disp_rank, right=True).clamp(0, m - 1)
    col_sorted = torch.where(keep, sorted_cell.view(n_rows, n) % m, refill)
    out = torch.empty_like(idx2).view(-1)
    out[order] = col_sorted.reshape(-1).to(idx.dtype)
    return out.view(idx.shape)


def route_sentinel_spill(
    idx: torch.Tensor, is_real: torch.Tensor, sentinel: int, capacity: torch.Tensor
) -> torch.Tensor:
    """Reseat real rows that quota repair left on the padding sentinel.

    Any real row at ``idx >= sentinel`` moves to its problem's
    highest-capacity column (``capacity`` is (..., m) beside ``idx``'s
    (..., n)); padding rows keep the sentinel for the caller to drop.
    """
    spill = is_real & (idx >= sentinel)
    fallback = torch.argmax(capacity, dim=-1, keepdim=True).to(idx.dtype)
    return torch.where(spill, fallback, idx)


def sinkhorn_assign(
    cost: torch.Tensor,
    row_mass: torch.Tensor,
    col_capacity: torch.Tensor,
    *,
    eps: float = 0.05,
    n_iters: int = 50,
) -> tuple[torch.Tensor, SinkhornResult]:
    """Solve and extract hard assignments ``argmin_j C[i, j] - g[j]``.

    Dead nodes (zero capacity) are never chosen: their ``g`` is -inf.
    """
    res = sinkhorn(cost, row_mass, col_capacity, eps=eps, n_iters=n_iters)
    g = torch.where(torch.isfinite(res.g), res.g, _NEG_INF)
    assignment = torch.argmin(cost.float() - g[None, :], dim=1)
    return assignment.to(torch.int32), res
