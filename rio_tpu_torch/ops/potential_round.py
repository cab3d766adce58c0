"""Rounding of the soft plan from its potentials: each row's seat, in one read of the cost.

:func:`potential_round_ref` is the rounding of
:func:`~rio_tpu_torch.ops.sinkhorn.plan_rounded_assign` with each row's
quantile ``q`` given: the logit ``(f + g - C) / eps`` (padding rows uniform
over the live columns), its softmax, the softmax's cumsum and the count of
columns whose sum lies below ``q``. :func:`potential_round` gives the same
seats: on CUDA tensors with at most 32 columns one launch of a hand-written
kernel (``kernels/csrc/potential_round.cu``) that rounds each row in one
warp's registers, bit for bit the eager chain's on the card; on the CPU, or
with wider rows, :func:`potential_round_ref`. The kernel has no counterpart
among the JAX package's Pallas kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.launch import impl_for, launch

# The widest row the kernel rounds: one lane a column of a warp.
MAX_KERNEL_COLS = 32

_NEG_INF = float("-inf")


def potential_round_ref(
    cost: torch.Tensor, f: torch.Tensor, g: torch.Tensor, q: torch.Tensor, eps: float
) -> torch.Tensor:
    """Plain PyTorch rounding from potentials: (..., n) int32 seats in ``[0, m - 1]``.

    Row ``i`` takes the first column whose CDF under the softmax of
    ``(f_i + g - C_i) / eps`` reaches ``q_i``; a padding row (``f_i`` not
    finite) spreads uniformly over the live columns (finite ``g``).
    """
    cost = cost.float()
    is_real = torch.isfinite(f)
    logit = (f[..., :, None] + g[..., None, :] - cost) / eps
    alive_cols = torch.isfinite(g)
    padding_logit = torch.where(alive_cols, 0.0, _NEG_INF)
    logit = torch.where(is_real[..., :, None], logit, padding_logit[..., None, :])
    p = torch.softmax(logit, dim=-1)
    cum = torch.cumsum(p, dim=-1)
    idx = (cum < q[..., None]).sum(dim=-1, dtype=torch.int32)
    return idx.clamp(0, cost.shape[-1] - 1)


def _check_args(cost, f, g, q) -> None:
    if cost.dim() not in (2, 3):
        raise ValueError(f"cost must be (n, m) or (B, n, m), got shape {tuple(cost.shape)}")
    if cost.shape[-1] == 0:
        raise ValueError("cost needs at least one column")
    if cost.dtype != torch.float32:
        raise TypeError(f"cost must be float32, got {cost.dtype}")
    rows, cols = tuple(cost.shape[:-1]), (*cost.shape[:-2], cost.shape[-1])
    for name, x, shape in (("f", f, rows), ("g", g, cols), ("q", q, rows)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
    for name, x in (("cost", cost), ("f", f), ("g", g), ("q", q)):
        if x.device != cost.device:
            raise ValueError(f"{name} is on {x.device}, cost on {cost.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def potential_round_impl(cost: torch.Tensor) -> str:
    """``"kernel"`` where :func:`potential_round` launches the kernel (a CUDA cost of at most
    32 columns), ``"eager"`` where it runs :func:`potential_round_ref`."""
    if cost.shape[-1] > MAX_KERNEL_COLS:
        return "eager"
    return impl_for(cost)


def potential_round(
    cost: torch.Tensor, f: torch.Tensor, g: torch.Tensor, q: torch.Tensor, eps: float
) -> torch.Tensor:
    """Each row's seat under the soft plan of potentials ``f``, ``g``: (..., n) int32.

    ``cost`` is (n, m) or (B, n, m) float32; ``f`` and ``q`` are (..., n),
    ``g`` (..., m), all float32, contiguous and on one device. For CUDA
    tensors with m <= 32 this launches the CUDA kernel once on the current
    stream, or raises; else it runs :func:`potential_round_ref`. Launches are
    counted under ``"potential_round"`` in :mod:`rio_tpu_torch.kernels.launch`.
    """
    _check_args(cost, f, g, q)
    if potential_round_impl(cost) == "eager":
        return potential_round_ref(cost, f, g, q, eps)
    *batch, n, m = cost.shape
    b = batch[0] if batch else 1
    out = torch.empty(cost.shape[:-1], dtype=torch.int32, device=cost.device)
    # PyTorch's division of a CUDA tensor by a host scalar: times 1 / scalar in float32.
    inv_eps = float(np.float32(1.0) / np.float32(eps))
    launch(
        "potential_round", cost, cost.data_ptr(), f.data_ptr(), g.data_ptr(), q.data_ptr(),
        out.data_ptr(), b, n, m, inv_eps, rows=b * n,
    )
    return out
