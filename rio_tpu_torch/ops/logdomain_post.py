"""After the log-domain solve: each row's seat from the potentials and the column-marginal error, in one read of the cost.

The log-domain step (:func:`~rio_tpu_torch.entry.logdomain_placement_step`)
rounds the plan ``exp((f + g - C)/eps)`` row by row
(:func:`~rio_tpu_torch.ops.potential_round.potential_round_ref`, each row's
quantile given) and takes its L1 column-marginal error
(:func:`~rio_tpu_torch.ops.sinkhorn.marginal_err`). Both read all of C with
the final ``f`` and ``g``. :func:`logdomain_post` does both in one pass: on a
CUDA cost, one launch of a hand-written kernel (``kernels/csrc/logdomain_post.cu``;
rows of at most 1,024 columns in whole 16-byte multiples in registers, any
other row in a slower form of it) that writes the seats and partial column
sums, which :func:`logdomain_post_finalize` reduces to the error in a second,
small launch; on the CPU, the plain twin: the seats block by block, then
``marginal_err``. The kernel has no counterpart among the JAX package's
Pallas kernels; its sums run in another order than the twin's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels.launch import check_operands, finalize, impl_for, launch, parts
from .potential_round import potential_round_ref
from .sinkhorn import marginal_err

# Rows per block of the twin's rounding (bounds its float32 temporaries).
_REF_BLOCK_ROWS = 65536


class PostRows(NamedTuple):
    """The rows pass: each row's seat, and the plan's column sums where the kernel ran."""

    idx: torch.Tensor  # (n,) int32 seats in [0, m - 1]
    col_parts: torch.Tensor | None  # (n_parts, m) float32 partial column sums; None on the CPU


def logdomain_post_round_ref(
    cost: torch.Tensor, f: torch.Tensor, g: torch.Tensor, q: torch.Tensor, eps: float
) -> torch.Tensor:
    """Plain twin of the kernel's seats: :func:`potential_round_ref` on blocks of rows, (n,) int32."""
    idx = torch.empty(cost.shape[0], dtype=torch.int32, device=cost.device)
    for i in range(0, cost.shape[0], _REF_BLOCK_ROWS):
        rows = slice(i, i + _REF_BLOCK_ROWS)
        idx[rows] = potential_round_ref(cost[rows], f[rows], g, q[rows], eps)
    return idx


def _check_args(cost, f, g, q) -> None:
    if cost.dim() != 2:
        raise ValueError(f"cost must be 2-D, got shape {tuple(cost.shape)}")
    n, m = cost.shape
    if m == 0:
        raise ValueError("cost needs at least one column")
    if cost.dtype != torch.float32:
        raise TypeError(f"cost must be float32, got {cost.dtype}")
    check_operands("cost", cost, ("f", f, n), ("g", g, m), ("q", q, n))


def logdomain_post(
    cost: torch.Tensor, f: torch.Tensor, g: torch.Tensor, q: torch.Tensor, eps: float
) -> PostRows:
    """Each row's seat under the plan of potentials ``f``, ``g`` at its quantile ``q``, and the plan's column sums.

    ``cost`` is (n, m) float32; ``f`` and ``q`` (n,), ``g`` (m,), float32;
    all contiguous, on one device. On a CUDA cost this launches the rows
    kernel once on the current stream, or raises; on a CPU cost it runs
    :func:`logdomain_post_round_ref` and leaves the column sums to
    :func:`logdomain_post_finalize`. Launches are counted
    under ``"logdomain_post"`` in :mod:`rio_tpu_torch.kernels.launch`.
    """
    _check_args(cost, f, g, q)
    if impl_for(cost) == "eager":
        return PostRows(logdomain_post_round_ref(cost, f, g, q, eps), None)
    n, m = cost.shape
    n_parts = parts("logdomain_post", cost, cost.data_ptr(), n, m)
    idx = torch.empty(n, dtype=torch.int32, device=cost.device)
    col_parts = torch.empty((n_parts, m), dtype=torch.float32, device=cost.device)
    # PyTorch's division of a CUDA tensor by a host scalar: times 1 / scalar in float32.
    inv_eps = float(np.float32(1.0) / np.float32(eps))
    launch(
        "logdomain_post", cost, cost.data_ptr(), f.data_ptr(), g.data_ptr(), q.data_ptr(),
        idx.data_ptr(), col_parts.data_ptr(), n_parts, inv_eps, n, m, rows=n,
    )
    return PostRows(idx, col_parts)


def logdomain_post_finalize(
    rows: PostRows, cost: torch.Tensor, f: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float
) -> torch.Tensor:
    """The L1 column-marginal error ``sum_j |col_j - b_j|`` of the plan :func:`logdomain_post` rounded: a scalar.

    Where the kernel ran (a CUDA cost), one launch of the finalize kernel
    sums its partial column sums in a fixed order (counted under
    ``"logdomain_post_finalize"``); on the CPU :func:`marginal_err`. ``b`` is
    (m,) float32, contiguous, on the cost's device.
    """
    check_operands("cost", cost, ("b", b, cost.shape[1]))
    if rows.col_parts is None:
        return marginal_err(cost, f, g, b, eps)
    err = torch.empty((), dtype=torch.float32, device=cost.device)
    n_parts, m = rows.col_parts.shape
    finalize("logdomain_post", cost, rows.col_parts.data_ptr(), n_parts, b.data_ptr(), err.data_ptr(), m)
    return err
