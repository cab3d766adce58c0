"""CDF rounding of a scaling-form plan and its row-marginal residual, in one read of K.

The step after a scaling solve rounds the plan ``diag(u) K diag(v)`` row
by row (:func:`~rio_tpu_torch.ops.sinkhorn.plan_rounded_assign_from_scaling`)
and checks the row marginals, the sum of each row's residual
(:func:`~rio_tpu_torch.ops.sinkhorn.scaling_row_residuals`). Both read
all of K. :func:`cdf_round` does both in one pass: on CUDA tensors one
launch of a hand-written kernel (``kernels/csrc/cdf_round.cu``), on CPU
tensors its plain twin :func:`cdf_round_ref`; the step
(:func:`~rio_tpu_torch.entry.round_and_repair`) calls it on either. The
kernel has no counterpart among the JAX package's Pallas kernels; its sums
run in another order than ``torch.cumsum``'s and ``torch.matmul``'s.

Each row's quantile ``q`` comes from
:func:`~rio_tpu_torch.ops.sinkhorn.block_quantiles` on the real rows
(``u > 0``): the ranks that
:func:`~rio_tpu_torch.ops.sinkhorn.plan_rounded_assign_from_scaling` gives
each block of ``chunk`` rows when it is called block by block.
"""

from __future__ import annotations

import torch

from ..kernels.launch import K_DTYPES, check_operands, impl_for, launch
from .sinkhorn import plan_rounded_assign_from_scaling, scaling_row_residuals

# Rows per block of the plain twin (bounds its float32 temporaries).
_REF_BLOCK_ROWS = 65536


def _check_args(K, u, v, a, q) -> None:
    if K.dim() != 2:
        raise ValueError(f"K must be 2-D, got shape {tuple(K.shape)}")
    n, m = K.shape
    if m == 0:
        raise ValueError("K needs at least one column")
    if K.dtype not in K_DTYPES:
        raise TypeError(f"K must be float32 or bfloat16, got {K.dtype}")
    check_operands("K", K, ("u", u, n), ("v", v, m), ("a", a, n), ("q", q, n))


def cdf_round_ref(
    K: torch.Tensor, u: torch.Tensor, v: torch.Tensor, a: torch.Tensor, q: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the kernel: ``(idx, res)``, (n,) int32 and (n,) float32.

    The step's eager functions on blocks of rows:
    :func:`~rio_tpu_torch.ops.sinkhorn.plan_rounded_assign_from_scaling`
    with the quantiles given, and
    :func:`~rio_tpu_torch.ops.sinkhorn.scaling_row_residuals`, the terms
    ``row_marginal_err`` sums.
    """
    n = K.shape[0]
    idx = torch.empty(n, dtype=torch.int32, device=K.device)
    res = torch.empty(n, dtype=torch.float32, device=K.device)
    for i in range(0, n, _REF_BLOCK_ROWS):
        rows = slice(i, i + _REF_BLOCK_ROWS)
        idx[rows] = plan_rounded_assign_from_scaling(K[rows], u[rows], v, q[rows])
        res[rows] = scaling_row_residuals(K[rows], u[rows], v, a[rows])
    return idx, res


def cdf_round(
    K: torch.Tensor, u: torch.Tensor, v: torch.Tensor, a: torch.Tensor, q: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's seat and marginal residual in one read of K: ``(idx, res)``.

    For CUDA tensors this launches the CUDA kernel once on the current
    stream, or raises; for CPU tensors it runs :func:`cdf_round_ref`. K is
    (n, m) float32 or bfloat16; u (n,), v (m,), a (n,) and q (n,) are
    float32; all contiguous, on one device. Launches are counted under
    ``"cdf_round"`` in :mod:`rio_tpu_torch.kernels.launch`.
    """
    _check_args(K, u, v, a, q)
    if impl_for(K) == "eager":
        return cdf_round_ref(K, u, v, a, q)
    n, m = K.shape
    idx = torch.empty(n, dtype=torch.int32, device=K.device)
    res = torch.empty(n, dtype=torch.float32, device=K.device)
    launch(
        "cdf_round", K, K_DTYPES[K.dtype], K.data_ptr(), u.data_ptr(), v.data_ptr(), a.data_ptr(),
        q.data_ptr(), idx.data_ptr(), res.data_ptr(), n, m, rows=n,
    )
    return idx, res
