"""Plain reference of the log-domain placement step.

The step that ``rio_tpu_torch.entry.logdomain_placement_step`` runs, written
again in plain PyTorch and NumPy from its definition, in row blocks so that
the float32 cost fits beside them on the card. Unit object masses, so
``a = 1/n``; ``b = cap / sum(cap)``:

1. ``n_iters`` log-domain Sinkhorn iterations from ``f = g = 0``, every
   number float32:

   ``f_i = eps * (log a_i - LSE_j((g_j - C_ij) / eps))``, then
   ``g_j = eps * (log b_j - LSE_i((f_i - C_ij) / eps))``,

   each LSE guarded: ``max + log(max(sum exp(x - max), 1e-30))``, with a max
   that is not finite taken as 0; ``g_j = -inf`` where ``b_j`` is 0;
2. rounding: each row's plan ``exp((f_i + g_j - C_ij) / eps)`` normalised
   over its columns, its CDF inverted at the quantile ``(rank + 0.5) / chunk``
   of the row within its chunk of rows: the row takes the first column at
   which the cumulative sum reaches it;
3. the largest-remainder exact-quota repair of :mod:`.flat`.

``store="bfloat16"`` keeps the cost in bfloat16 for all of it: the control,
one precision below the float32 the step states.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .flat import judge, quotas, repair  # noqa: F401 - judge: the judge of this step's answers too

BLOCK = 65_536  # rows per block of every sweep over the cost


def _guard(top: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(top), top, 0.0)


def _floor_log(total: torch.Tensor) -> torch.Tensor:
    return torch.log(total.clamp_min(1e-30))


def solve(C: torch.Tensor, cap: torch.Tensor, eps: float, n_iters: int):
    """``(f, g)`` after ``n_iters`` log-domain iterations on the stored cost ``C``."""
    n, m = C.shape
    log_a = math.log(1.0 / n)
    b = cap.float() / cap.float().sum()
    log_b = torch.where(b > 0, torch.log(b.clamp_min(1e-30)), float("-inf"))
    f = torch.zeros(n, dtype=torch.float32, device=C.device)
    g = torch.zeros(m, dtype=torch.float32, device=C.device)
    blocks = range(0, n, BLOCK)
    for _ in range(n_iters):
        for i in blocks:
            x = (g[None, :] - C[i : i + BLOCK].float()) / eps
            top = _guard(x.amax(dim=1))
            lse = top + _floor_log(torch.exp(x - top[:, None]).sum(dim=1))
            f[i : i + BLOCK] = eps * (log_a - lse)
        top = torch.full((m,), float("-inf"), dtype=torch.float32, device=C.device)
        for i in blocks:
            top = torch.maximum(top, ((f[i : i + BLOCK, None] - C[i : i + BLOCK].float()) / eps).amax(dim=0))
        top = _guard(top)
        total = torch.zeros(m, dtype=torch.float32, device=C.device)
        for i in blocks:
            x = (f[i : i + BLOCK, None] - C[i : i + BLOCK].float()) / eps
            total += torch.exp(x - top[None, :]).sum(dim=0)
        g = torch.where(torch.isfinite(log_b), eps * (log_b - (top + _floor_log(total))), float("-inf"))
    return f, g


def cdf_round(C: torch.Tensor, f, g, eps: float, chunk: int) -> torch.Tensor:
    """Each row's node at its quantile within its chunk of rows, (n,) int64."""
    n, m = C.shape
    q = (torch.arange(chunk, dtype=torch.float32, device=C.device) + 0.5) / chunk
    out = torch.empty(n, dtype=torch.int64, device=C.device)
    for i in range(0, n, chunk):
        logit = (f[i : i + chunk, None] + g[None, :] - C[i : i + chunk].float()) / eps
        plan = torch.exp(logit - logit.amax(dim=1, keepdim=True))
        cum = torch.cumsum(plan, dim=1)
        out[i : i + chunk] = (cum < q[:, None] * cum[:, -1:]).sum(dim=1).clamp(0, m - 1)
    return out


def place(cost: torch.Tensor, cap: torch.Tensor, *, eps: float, n_iters: int, chunk: int,
          store: str = "float32") -> np.ndarray:
    """The reference step's assignment, (n,) int64 on the host."""
    if cost.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    n, m = cost.shape
    if n % chunk:
        raise ValueError(f"{n} rows are not a multiple of chunk={chunk}")
    C = cost.to(getattr(torch, store))
    f, g = solve(C, cap, eps, n_iters)
    idx = cdf_round(C, f, g, eps, chunk).cpu().numpy()
    del C
    capf = cap.float()
    expected = (capf / capf.sum() * n).cpu().numpy()
    return repair(idx, quotas(expected, np.bincount(idx, minlength=m), n))
