"""The two-level solve's coarse scores: each object's best live member in each group, in one pass.

:func:`coarse_scores_ref` is the coarse stage's scoring as
:func:`~rio_tpu_torch.parallel.hierarchical.hierarchical_assign` ran it
eagerly: blocks of groups at a time, a float32 GEMM of the objects against
the block's nodes, ``masked_fill`` of the dead nodes with ``-inf`` and
``amax`` over each group. :func:`coarse_scores` gives the same (n, G)
scores: on CUDA tensors one launch of a hand-written kernel
(``kernels/csrc/coarse_score.cu``) that writes nothing but the result, on
CPU tensors :func:`coarse_scores_ref`. The kernel has no counterpart among
the JAX package's Pallas kernels (its coarse stage maps over single groups
in plain jnp); each of its dot products is one float32 FMA chain in feature
order, as a single-pass FFMA GEMM tile computes it.
"""

from __future__ import annotations

import torch

from ..kernels.launch import impl_for, launch

# The twin scores all objects against one block of groups at a time: an
# (N, groups_in_block * S) product of at most this many float32 elements
# (256 MiB), where JAX maps over single groups.
_COARSE_BLOCK_ELEMS = 1 << 26


def coarse_scores_ref(
    obj_feat: torch.Tensor, node_feat: torch.Tensor, live: torch.Tensor, n_groups: int,
) -> torch.Tensor:
    """Plain PyTorch coarse scores, (n, G) float32.

    Entry ``[i, g]`` is the largest ``obj_feat[i] @ node_feat[:, j]`` over
    the live nodes ``j`` of group ``g`` (nodes ``g * S ... (g + 1) * S - 1``,
    ``S = M / G``), ``-inf`` where the group has no live node; a NaN score
    of a live node makes its group's entry NaN.
    """
    n = obj_feat.shape[0]
    m = node_feat.shape[1]
    s = m // n_groups
    alive_grouped = live.reshape(n_groups, s)
    coarse_aff = torch.empty((n, n_groups), dtype=torch.float32, device=obj_feat.device)
    block = max(1, min(n_groups, _COARSE_BLOCK_ELEMS // max(1, n * s)))
    for g0 in range(0, n_groups, block):
        g1 = min(n_groups, g0 + block)
        scores = (obj_feat @ node_feat[:, g0 * s : g1 * s]).view(n, g1 - g0, s)
        scores = scores.masked_fill(~alive_grouped[g0:g1], float("-inf"))
        coarse_aff[:, g0:g1] = scores.amax(dim=-1)
    return coarse_aff


def _check_args(obj_feat, node_feat, live, n_groups) -> None:
    if obj_feat.dim() != 2 or node_feat.dim() != 2 or live.dim() != 1:
        raise ValueError(
            f"want (n, d), (d, M) and (M,), got {tuple(obj_feat.shape)}, "
            f"{tuple(node_feat.shape)} and {tuple(live.shape)}"
        )
    n, d = obj_feat.shape
    d2, m = node_feat.shape
    if d != d2 or live.shape[0] != m:
        raise ValueError(f"shapes disagree: {tuple(obj_feat.shape)}, {tuple(node_feat.shape)}, {tuple(live.shape)}")
    if n_groups < 1 or m == 0 or m % n_groups:
        raise ValueError(f"{m} nodes do not split into {n_groups} groups")
    if obj_feat.dtype != torch.float32 or node_feat.dtype != torch.float32:
        raise TypeError(f"features must be float32, got {obj_feat.dtype} and {node_feat.dtype}")
    if live.dtype != torch.bool:
        raise TypeError(f"live must be bool, got {live.dtype}")
    if not (obj_feat.device == node_feat.device == live.device):
        raise ValueError(f"devices differ: {obj_feat.device}, {node_feat.device}, {live.device}")
    if not (obj_feat.is_contiguous() and node_feat.is_contiguous() and live.is_contiguous()):
        raise ValueError("obj_feat, node_feat and live must be contiguous")


def coarse_scores(
    obj_feat: torch.Tensor, node_feat: torch.Tensor, live: torch.Tensor, n_groups: int,
) -> torch.Tensor:
    """Each object's best live member in each group: (n, G) float32.

    ``obj_feat`` is (n, d) float32, ``node_feat`` (d, M) float32, ``live``
    (M,) bool, all contiguous and on one device; M splits into ``n_groups``
    groups of consecutive nodes. For CUDA tensors this launches the CUDA
    kernel once on the current stream, or raises; for CPU tensors it runs
    :func:`coarse_scores_ref`. Launches are counted under
    ``"coarse_scores"`` in :mod:`rio_tpu_torch.kernels.launch`.
    """
    _check_args(obj_feat, node_feat, live, n_groups)
    if impl_for(obj_feat) == "eager":
        return coarse_scores_ref(obj_feat, node_feat, live, n_groups)
    n, d = obj_feat.shape
    m = node_feat.shape[1]
    out = torch.empty((n, n_groups), dtype=torch.float32, device=obj_feat.device)
    launch(
        "coarse_scores", obj_feat, obj_feat.data_ptr(), node_feat.data_ptr(), live.data_ptr(),
        out.data_ptr(), n, d, m, n_groups, rows=n,
    )
    return out
