"""Log-domain Sinkhorn with one read of the cost matrix per iteration.

Counterpart of ``rio_tpu/ops/pallas_sinkhorn.py``. One entropic-OT iteration
takes two reductions over the (objects x nodes) cost: a row log-sum-exp of
``(g - C)/eps`` (the ``f`` update) and a column log-sum-exp of ``(f - C)/eps``
(the ``g`` update). :func:`fused_iteration` does both in one sweep over C:
on a CUDA tensor it launches the hand-written kernel
``kernels/csrc/logdomain_iteration.cu``; on a CPU tensor it runs the plain
twin :func:`fused_iteration_ref`. :func:`logdomain_iterations` loops it
inside the span ``logdomain.iterations``; :func:`pallas_sinkhorn` runs that
loop and takes the column-marginal error inside ``logdomain.err``
(:mod:`rio_tpu_torch.tracing`).

The semantics are the Pallas kernel's, not ``torch.logsumexp``'s: each LSE
is ``max + log(max(sum, 1e-30))`` with a non-finite max taken as 0, so a row
whose every column is dead gets the finite ``f = eps * (log_a - log(1e-30))``
where the unfused :func:`~rio_tpu_torch.ops.sinkhorn.sinkhorn` gives +inf.
Zero-mass rows get ``f = -inf``, zero-capacity columns ``g = -inf``.
"""

from __future__ import annotations

import torch

from ..kernels.launch import check_operands, impl_for, launch, parts
from ..tracing import span
from .sinkhorn import SinkhornResult, log_marginals, marginal_err, normalize_marginals

_NEG_INF = float("-inf")


def _lse_with_floor(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``xmax + log(max(sum(exp(x - xmax)), 1e-30))``, xmax taken as 0 where not finite.

    Consumes ``x`` (it is overwritten in place: at 1M x 1024 each float32
    temporary is 4 GiB).
    """
    xmax = x.amax(dim=dim, keepdim=True)
    xsafe = torch.where(torch.isfinite(xmax), xmax, 0.0)
    xsum = x.sub_(xsafe).exp_().sum(dim=dim, keepdim=True)
    return (xsafe + torch.log(xsum.clamp_min(1e-30))).squeeze(dim)


def fused_iteration_ref(
    cost: torch.Tensor,
    log_a: torch.Tensor,
    log_b: torch.Tensor,
    g: torch.Tensor,
    eps: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the kernel: one iteration, returns ``(f, g_new)``.

    ``f = eps * (log_a - rowLSE((g - C)/eps))`` (-inf where ``log_a`` is
    not finite), then ``g_new = eps * (log_b - colLSE((f - C)/eps))`` (-inf
    where ``log_b`` is not finite), with the Pallas kernel's guarded LSE.
    """
    z = (g[None, :] - cost).div_(eps)
    f = eps * (log_a - _lse_with_floor(z, 1))
    f = torch.where(torch.isfinite(log_a), f, _NEG_INF)
    del z
    w = (f[:, None] - cost).div_(eps)
    g_new = eps * (log_b - _lse_with_floor(w, 0))
    return f, torch.where(torch.isfinite(log_b), g_new, _NEG_INF)


def _check_iteration_args(cost, log_a, log_b, g, eps) -> None:
    if cost.dim() != 2:
        raise ValueError(f"cost must be 2-D, got shape {tuple(cost.shape)}")
    n, m = cost.shape
    if m == 0:
        raise ValueError("cost needs at least one column")
    if cost.dtype != torch.float32:
        raise TypeError(f"cost must be float32, got {cost.dtype}")
    check_operands("cost", cost, ("log_a", log_a, n), ("log_b", log_b, m), ("g", g, m))
    if not float(eps) > 0.0:
        raise ValueError(f"eps must be positive, got {eps}")


def fused_iteration(
    cost: torch.Tensor,
    log_a: torch.Tensor,
    log_b: torch.Tensor,
    g: torch.Tensor,
    eps: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused log-domain iteration: returns ``(f, g_new)``.

    For CUDA tensors this launches the CUDA kernel (one read of ``cost``) on
    the current stream, or raises; for CPU tensors it runs
    :func:`fused_iteration_ref`. ``cost`` is (n, m) float32; ``log_a`` (n,),
    ``log_b`` (m,) and ``g`` (m,) are float32; all contiguous, on one
    device. Launches are counted under ``"fused_iteration"`` in
    :mod:`rio_tpu_torch.kernels.launch`.
    """
    _check_iteration_args(cost, log_a, log_b, g, eps)
    if impl_for(cost) == "eager":
        return fused_iteration_ref(cost, log_a, log_b, g, eps)
    n, m = cost.shape
    n_parts = parts("fused_iteration", cost, cost.data_ptr(), n, m)
    f = torch.empty(n, dtype=torch.float32, device=cost.device)
    g_new = torch.empty(m, dtype=torch.float32, device=cost.device)
    # (n_parts, m) pairs of (column max, rebased column sum).
    workspace = torch.empty((n_parts, m, 2), dtype=torch.float32, device=cost.device)
    launch(
        "fused_iteration", cost, cost.data_ptr(), log_a.data_ptr(), log_b.data_ptr(), g.data_ptr(),
        f.data_ptr(), g_new.data_ptr(), workspace.data_ptr(), n_parts, float(eps), n, m, rows=n,
    )
    return f, g_new


def logdomain_iterations(
    cost: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *, eps: float, n_iters: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """``n_iters`` :func:`fused_iteration` from ``f = g = 0`` on normalized marginals: ``(f, g)``.

    ``cost`` is float32 and contiguous. The loop is the span
    ``logdomain.iterations`` (attributes ``impl``, ``"kernel"`` or
    ``"eager"``, and ``iterations``).
    """
    n, m = cost.shape
    log_a, log_b = log_marginals(a, b)
    f = torch.zeros(n, dtype=torch.float32, device=cost.device)
    g = torch.zeros(m, dtype=torch.float32, device=cost.device)
    with span("logdomain.iterations", impl=impl_for(cost), iterations=n_iters):
        for _ in range(n_iters):
            f, g = fused_iteration(cost, log_a, log_b, g, eps)
    return f, g


def pallas_sinkhorn(
    cost: torch.Tensor,
    row_mass: torch.Tensor,
    col_capacity: torch.Tensor,
    *,
    eps: float = 0.05,
    n_iters: int = 50,
) -> SinkhornResult:
    """Log-domain Sinkhorn, each iteration one :func:`fused_iteration`.

    The counterpart of the JAX ``pallas_sinkhorn``, a drop-in for
    :func:`~rio_tpu_torch.ops.sinkhorn.sinkhorn` (no warm start). ``g``
    starts at 0 on every column, dead ones included, as in the unfused
    solve. The kernel masks ragged shapes itself, so nothing is padded:
    the JAX version's ``block_rows`` and ``interpret`` are TPU tiling knobs
    and have no counterpart. Its spans (:mod:`rio_tpu_torch.tracing`):
    ``logdomain.iterations`` around the ``n_iters`` iterations
    (:func:`logdomain_iterations`), then ``logdomain.err`` around the
    column-marginal error.
    """
    cost = cost.float().contiguous()
    a, b = normalize_marginals(row_mass, col_capacity)
    f, g = logdomain_iterations(cost, a, b, eps=eps, n_iters=n_iters)
    with span("logdomain.err"):
        err = marginal_err(cost, f, g, b, eps)
    return SinkhornResult(f=f, g=g, err=err)
