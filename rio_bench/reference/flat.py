"""Plain reference of the flat placement step, and the judge of its answers.

The step that ``rio_tpu_torch.entry.placement_step`` runs, written again
in plain PyTorch and NumPy from its definition, in row blocks so that it
fits beside nothing else on the card:

1. ``K = exp(-(C - min_j C) / eps)`` row by row, stored in the kernel dtype;
2. ``n_iters`` scaling iterations with ``u`` and ``v`` in float32 and every
   product in float32: ``u = a / max(K v, 1e-30)``, ``v = b / max(K^T u, 1e-30)``
   with ``a = 1/n`` and ``b = cap / sum(cap)``;
3. CDF rounding of ``diag(u) K diag(v)`` in chunks of rows, each row at the
   quantile ``(rank + 0.5) / chunk`` of its chunk;
4. exact-quota repair: largest-remainder integer quotas of ``cap``'s share
   of the rows; within each node the lowest rows keep their seat, and the
   rest fill the nodes under quota in order of node, then row.

``store="float8_e4m3fn"`` keeps K in fp8 (each row scaled so that its
largest entry, 1, maps to 448): the control, one precision below the
configuration's bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK = 65_536  # rows per block of every product
FP8_MAX = 448.0


def kernel_matrix(cost: torch.Tensor, eps: float, store: str) -> tuple[torch.Tensor, float]:
    """``(K, scale)``: K stored in ``store``, to be widened as ``K.float() * scale``."""
    n, m = cost.shape
    dtype = getattr(torch, store)
    fp8 = dtype == torch.float8_e4m3fn
    K = torch.empty((n, m), dtype=dtype, device=cost.device)
    for i in range(0, n, BLOCK):
        c = cost[i : i + BLOCK].float()
        k = torch.exp((c - c.amin(dim=1, keepdim=True)) / -eps)
        K[i : i + BLOCK] = (k * FP8_MAX).to(dtype) if fp8 else k.to(dtype)
    return K, (1.0 / FP8_MAX if fp8 else 1.0)


def _wide(K: torch.Tensor, i: int, scale: float, rows: int = BLOCK) -> torch.Tensor:
    block = K[i : i + rows].float()
    return block if scale == 1.0 else block * scale


def scaling_solve(K, scale, cap: torch.Tensor, n_iters: int):
    """``(u, v)`` after ``n_iters`` scaling iterations, unit object masses."""
    n, _ = K.shape
    a = torch.full((n,), 1.0 / n, dtype=torch.float32, device=K.device)
    b = cap.float() / cap.float().sum()
    v = torch.ones_like(b)
    u = torch.empty_like(a)
    for _ in range(n_iters):
        for i in range(0, n, BLOCK):
            u[i : i + BLOCK] = a[i : i + BLOCK] / (_wide(K, i, scale) @ v).clamp_min(1e-30)
        ktu = torch.zeros_like(b)
        for i in range(0, n, BLOCK):
            ktu += u[i : i + BLOCK] @ _wide(K, i, scale)
        v = torch.where(b > 0, b / ktu.clamp_min(1e-30), 0.0)
    return u, v


def cdf_round(K, scale, u, v, chunk: int) -> torch.Tensor:
    """Each row's node at its quantile within its chunk of rows, (n,) int64."""
    n, m = K.shape
    q = (torch.arange(chunk, dtype=torch.float32, device=K.device) + 0.5) / chunk
    out = torch.empty(n, dtype=torch.int64, device=K.device)
    for i in range(0, n, chunk):
        p = u[i : i + chunk, None] * _wide(K, i, scale, chunk) * v[None, :]
        cum = torch.cumsum(p, dim=1)
        total = cum[:, -1:].clamp_min(1e-30)
        out[i : i + chunk] = (cum < q[:, None] * total).sum(dim=1).clamp(0, m - 1)
    return out


def quotas(expected: np.ndarray, counts: np.ndarray, n: int) -> np.ndarray:
    """Largest-remainder integer quotas of ``expected`` (float32 shares summing to ~n).

    Remainder ties go to the node holding more rows, then the lower index.
    """
    scaled = np.maximum(expected.astype(np.float32), 0.0)
    base = np.floor(scaled).astype(np.int64)
    rem = scaled - base
    short = int(np.clip(n - base.sum(), 0, len(base)))
    order = np.lexsort((np.arange(len(base)), -counts, -rem))
    base[order[:short]] += 1
    return base


def repair(idx: np.ndarray, quota: np.ndarray) -> np.ndarray:
    """Exact-quota repair of ``idx`` (n,) to ``quota`` (m,)."""
    n, m = idx.shape[0], quota.shape[0]
    order = np.argsort(idx, kind="stable")
    col = idx[order]
    counts = np.bincount(idx, minlength=m)
    rank = np.arange(n) - np.searchsorted(col, np.arange(m))[col]
    keep = rank < quota[col]
    bounds = np.cumsum(np.maximum(quota - counts, 0))
    refill = np.searchsorted(bounds, np.cumsum(~keep) - 1, side="right").clip(0, m - 1)
    out = np.empty(n, np.int64)
    out[order] = np.where(keep, col, refill)
    return out


def place(cost: torch.Tensor, cap: torch.Tensor, *, eps: float, n_iters: int, chunk: int,
          store: str = "bfloat16") -> np.ndarray:
    """The reference step's assignment, (n,) int64 on the host."""
    if cost.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    K, scale = kernel_matrix(cost, eps, store)
    u, v = scaling_solve(K, scale, cap, n_iters)
    idx = cdf_round(K, scale, u, v, chunk).cpu().numpy()
    del K
    n = cost.shape[0]
    capf = cap.float()
    expected = (capf / capf.sum() * n).cpu().numpy()
    return repair(idx, quotas(expected, np.bincount(idx, minlength=cost.shape[1]), n))


def mean_cost(cost: torch.Tensor, assignment: np.ndarray) -> float:
    """Mean of ``cost[i, assignment[i]]`` in float64."""
    seats = torch.from_numpy(np.asarray(assignment, np.int64)).to(cost.device)
    return float(cost.gather(1, seats[:, None]).double().mean())


def judge(cost: torch.Tensor, ref: np.ndarray, answer: np.ndarray) -> dict:
    """The numbers compared for one answer against the reference's assignment.

    ``seat_mismatch``: the share of rows seated elsewhere than the
    reference seats them; ``cost_gap``: the relative gap of the mean cost;
    ``quota_gap``: the largest distance of a node's load from its quota.
    """
    n, m = cost.shape
    answer = np.asarray(answer, np.int64)
    if answer.shape != (n,) or answer.min() < 0 or answer.max() >= m:
        return {"seat_mismatch": 1.0, "cost_gap": float("inf"), "quota_gap": float(n)}
    quota = np.bincount(ref, minlength=m)  # the reference lands on the quotas exactly
    ref_cost = mean_cost(cost, ref)
    return {
        "seat_mismatch": float(np.mean(answer != ref)),
        "cost_gap": abs(mean_cost(cost, answer) - ref_cost) / ref_cost,
        "quota_gap": float(np.abs(np.bincount(answer, minlength=m) - quota).max()),
    }
