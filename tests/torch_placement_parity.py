"""Shared harness: one call sequence on JaxObjectPlacement and TorchObjectPlacement.

A scenario is an async function ``scenario(api)`` that builds its
providers with ``api.make(**kw)`` and returns a list of records, one per
step it wants compared. Each record holds what the contract compares:

- ``stats.mode`` (identical strings);
- per-node object counts by address (exactly equal);
- ``moved`` and ``displaced`` (equal), ``discarded``, ``solver_iters``,
  ``warm_ratio`` (equal);
- ``residual``: within ``RESIDUAL_TOL`` absolute of JAX's (both are float32
  L1 column-marginal violations of unit-mass marginals; sums run in
  another order), or -1 in both;
- whatever scenario-specific values a step adds (equal).
"""

from __future__ import annotations

import asyncio
from collections import Counter
from types import SimpleNamespace

import rio_tpu
import rio_tpu.errors
from rio_tpu.object_placement.jax_placement import JaxObjectPlacement

import rio_tpu_torch.errors
import rio_tpu_torch.object_placement as torch_op
import rio_tpu_torch.registry
from rio_tpu_torch.object_placement.torch_placement import TorchObjectPlacement

RESIDUAL_TOL = 1e-4

JAX_API = SimpleNamespace(
    name="jax",
    cls=JaxObjectPlacement,
    make=lambda **kw: JaxObjectPlacement(**kw),
    ObjectId=rio_tpu.ObjectId,
    Item=rio_tpu.ObjectPlacementItem,
    NoSchedulableCapacity=rio_tpu.errors.NoSchedulableCapacity,
)
TORCH_API = SimpleNamespace(
    name="torch",
    cls=TorchObjectPlacement,
    make=lambda **kw: TorchObjectPlacement(device="cpu", **kw),
    ObjectId=rio_tpu_torch.registry.ObjectId,
    Item=torch_op.ObjectPlacementItem,
    NoSchedulableCapacity=rio_tpu_torch.errors.NoSchedulableCapacity,
)


class Member:
    """The shape of ``rio_tpu.cluster.storage.Member`` the providers read."""

    def __init__(self, address: str, active: bool = True) -> None:
        self.address = address
        self.active = active


def members(n: int, dead=(), prefix: str = "10.7.0") -> list[Member]:
    return [Member(f"{prefix}.{i}:5000", i not in dead) for i in range(n)]


def counts_by_address(p) -> dict[str, int]:
    return dict(Counter(p._node_order[i] for i in p._placements.values()))


def seats(p) -> dict[str, int]:
    return dict(p._placements)


def undisplaced_moves(before: dict[str, int], p, dead_idx) -> int:
    """Objects that moved although their previous node stayed schedulable."""
    return sum(
        1
        for k, v in before.items()
        if v not in dead_idx and p._placements.get(k) not in (None, v)
    )


def snap(p, **extra) -> dict:
    s = p.stats
    return {
        "mode": s.mode,
        "moved": s.moved,
        "displaced": s.displaced,
        "discarded": s.discarded,
        "solver_iters": s.solver_iters,
        "warm_ratio": round(s.warm_ratio, 6),
        "residual": s.residual,
        "counts": counts_by_address(p),
        **extra,
    }


def assert_same(rec_jax: list[dict], rec_torch: list[dict]) -> None:
    assert len(rec_jax) == len(rec_torch)
    for step, (a, b) in enumerate(zip(rec_jax, rec_torch)):
        assert a.keys() == b.keys(), step
        for k in a:
            if k == "residual":
                assert (a[k] < 0) == (b[k] < 0), (step, a[k], b[k])
                assert abs(a[k] - b[k]) <= RESIDUAL_TOL, (step, a[k], b[k])
            else:
                assert a[k] == b[k], (step, k, a[k], b[k])


def run_both(scenario) -> tuple[list[dict], list[dict]]:
    rec_jax = asyncio.run(scenario(JAX_API))
    rec_torch = asyncio.run(scenario(TORCH_API))
    assert_same(rec_jax, rec_torch)
    return rec_jax, rec_torch
