"""The scaling solve's kernel matrix ``K = exp(-(C - shift) / eps)`` and its row shift, in one read of the cost.

:func:`kbuild_ref` is the K build of the scaling form
(:func:`~rio_tpu_torch.ops.scaling.scaling_kernel`): each row's min as a
gauge, ``(C - shift) / (-eps)``, ``exp``, the cast to the kernel dtype.
:func:`kbuild` does the same in one read of a float32 cost and one write of
K: on CUDA tensors one launch of a hand-written kernel
(``kernels/csrc/kbuild.cu``), on CPU tensors :func:`kbuild_ref`. The kernel
has no counterpart among the JAX package's Pallas kernels; its bits equal
what :func:`kbuild_ref` gives on the card, where PyTorch divides by a host
scalar as a multiply by its float32 reciprocal.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.launch import K_DTYPES, check_operands, impl_for, launch


def kbuild_ref(cost: torch.Tensor, *, eps: float, kernel_dtype: torch.dtype):
    """Plain PyTorch K build: ``(K, shift)``, K in ``kernel_dtype`` and the (..., n) float32 shift.

    ``K = exp(-(C - shift) / eps)`` with a PER-ROW min-shift: pure gauge
    (each row's shift is absorbed into its u), and it keeps every row's
    best entry at exp(0) = 1, so no row underflows to all zeros whatever
    the global cost range (a global shift breaks down once range/eps >>
    88). Rows whose minimum is not finite (a NaN, a -inf, or every entry
    +inf) get shift 0. Takes a leading batch axis.
    """
    cost = cost.float()
    shift = cost.min(dim=-1, keepdim=True).values
    shift = torch.where(torch.isfinite(shift), shift, 0.0)
    # In place on the one float32 temporary: at 1M x 1024 each extra
    # temporary is 4 GiB. x / (-eps) equals -x / eps exactly.
    K = cost - shift
    K.div_(-eps).exp_()
    return K.to(kernel_dtype), shift[..., 0]


def _check_args(cost, kernel_dtype) -> None:
    if cost.dim() != 2:
        raise ValueError(f"cost must be 2-D, got shape {tuple(cost.shape)}")
    if cost.shape[1] == 0:
        raise ValueError("cost needs at least one column")
    if cost.dtype != torch.float32:
        raise TypeError(f"cost must be float32, got {cost.dtype}")
    if kernel_dtype not in K_DTYPES:
        raise TypeError(f"K must be float32 or bfloat16, got {kernel_dtype}")
    check_operands("cost", cost)


def kbuild(cost: torch.Tensor, *, eps: float, kernel_dtype: torch.dtype):
    """K and each row's shift in one read of the cost: ``(K, shift)``.

    For CUDA tensors this launches the CUDA kernel once on the current
    stream, or raises; for CPU tensors it runs :func:`kbuild_ref`. ``cost``
    is (n, m) float32 and contiguous; K is (n, m) in ``kernel_dtype``
    (float32 or bfloat16), ``shift`` (n,) float32. Launches are counted
    under ``"kbuild"`` in :mod:`rio_tpu_torch.kernels.launch`.
    """
    _check_args(cost, kernel_dtype)
    if impl_for(cost) == "eager":
        return kbuild_ref(cost, eps=eps, kernel_dtype=kernel_dtype)
    n, m = cost.shape
    # PyTorch's division of a CUDA tensor by a host scalar: times 1 / scalar in float32.
    scale = float(np.float32(1.0) / np.float32(-eps))
    K = torch.empty((n, m), dtype=kernel_dtype, device=cost.device)
    shift = torch.empty(n, dtype=torch.float32, device=cost.device)
    launch(
        "kbuild", cost, K_DTYPES[kernel_dtype], cost.data_ptr(), K.data_ptr(), shift.data_ptr(),
        n, m, scale, rows=n,
    )
    return K, shift
