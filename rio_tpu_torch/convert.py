"""Arrays from the JAX side, as numpy, to the port's tensors.

The JAX package and the port share no code, so a comparison passes state
between them as numpy arrays. ``np.asarray`` of a JAX bfloat16 array is an
``ml_dtypes.bfloat16`` array, which torch cannot take: it is widened to
float32 in numpy and cast to ``torch.bfloat16`` on the device. Every
bfloat16 value is exact in float32, so the round trip is exact.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def to_tensor(x, device: str | torch.device) -> torch.Tensor:
    """One array (anything ``np.asarray`` takes) as a tensor on ``device``."""
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(device).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


class Problem(NamedTuple):
    """A placement problem: cost (n, m), row masses (n,), capacities (m,)."""

    cost: torch.Tensor
    mass: torch.Tensor
    cap: torch.Tensor
    g_init: torch.Tensor | None


class ScalingState(NamedTuple):
    """A scaling-form solve's state: ``(u, v, K, shift)`` as ``scaling_core`` returns it."""

    u: torch.Tensor
    v: torch.Tensor
    K: torch.Tensor
    shift: torch.Tensor


def problem_to_torch(cost, mass, cap, g_init=None, *, device) -> Problem:
    """A problem's arrays as tensors on ``device`` (``g_init`` may be None)."""
    return Problem(
        to_tensor(cost, device),
        to_tensor(mass, device),
        to_tensor(cap, device),
        None if g_init is None else to_tensor(g_init, device),
    )


def scaling_state_to_torch(u, v, K, shift, *, device) -> ScalingState:
    """A JAX ``scaling_core`` result as tensors on ``device``; K keeps its dtype."""
    return ScalingState(*(to_tensor(x, device) for x in (u, v, K, shift)))
