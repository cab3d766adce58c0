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

:func:`snap_hier` records a hierarchical solve: ``chunks`` and ``devices``
(equal) and each object's seat instead of the per-node counts. ``api.mesh(n)``
makes each package's mesh of ``n`` shards: JAX's over conftest's virtual CPU
devices, the port's over ``["cpu"] * n``. The port's
two-level solve rounds from float32 potentials that differ from JAX's in
the last bits, and the padding rows of its power-of-two bucket ride the
solve beside the real ones, so one row that lands elsewhere shifts two
nodes' real counts by one. So seats must agree on at least
``ROW_AGREEMENT`` of the objects; per-node counts must be equal when every
seat agrees and otherwise differ by at most two per differing seat (summed
over nodes). A delta's ``moved`` is compared exactly; a full solve's
(``moved_full``) within the number of seats that disagree.
"""

from __future__ import annotations

import asyncio
from collections import Counter
from types import SimpleNamespace

import jax
import rio_tpu
import rio_tpu.errors
from rio_tpu.object_placement import jax_placement
from rio_tpu.object_placement.jax_placement import JaxObjectPlacement
from rio_tpu.parallel import make_mesh as jax_make_mesh

import rio_tpu_torch.errors
import rio_tpu_torch.object_placement as torch_op
import rio_tpu_torch.registry
from rio_tpu_torch.object_placement import torch_placement
from rio_tpu_torch.object_placement.torch_placement import TorchObjectPlacement
from rio_tpu_torch.parallel import make_mesh as torch_make_mesh

RESIDUAL_TOL = 1e-4
ROW_AGREEMENT = 0.99

JAX_API = SimpleNamespace(
    name="jax",
    cls=JaxObjectPlacement,
    module=jax_placement,
    make=lambda **kw: JaxObjectPlacement(**kw),
    # conftest's 8 virtual CPU devices, (4, 2) unless obj_axis says otherwise.
    mesh=lambda n=8, **kw: jax_make_mesh(jax.devices()[:n], **kw),
    Tracker=jax_placement.AffinityTracker,
    ObjectId=rio_tpu.ObjectId,
    Item=rio_tpu.ObjectPlacementItem,
    NoSchedulableCapacity=rio_tpu.errors.NoSchedulableCapacity,
)
TORCH_API = SimpleNamespace(
    name="torch",
    cls=TorchObjectPlacement,
    module=torch_placement,
    make=lambda **kw: TorchObjectPlacement(device="cpu", **kw),
    mesh=lambda n=8, **kw: torch_make_mesh(["cpu"] * n, **kw),
    Tracker=torch_op.AffinityTracker,
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


def snap_hier(p, *, delta: bool = False, **extra) -> dict:
    rec = snap(p, chunks=p.stats.chunks, devices=p.stats.devices, **extra)
    rec["seats"] = {k: p._node_order[i] for k, i in p._placements.items()}
    if not delta:
        rec["moved_full"] = rec.pop("moved")
    return rec


def assert_same(rec_jax: list[dict], rec_torch: list[dict]) -> None:
    assert len(rec_jax) == len(rec_torch)
    for step, (a, b) in enumerate(zip(rec_jax, rec_torch)):
        assert a.keys() == b.keys(), step
        differ = 0
        if "seats" in a:
            assert a["seats"].keys() == b["seats"].keys(), step
            differ = sum(a["seats"][k] != b["seats"][k] for k in a["seats"])
            assert differ <= (1.0 - ROW_AGREEMENT) * len(a["seats"]), (step, differ)
        for k in a:
            if k == "seats":
                continue
            if k == "counts" and "seats" in a:
                # Equal when every seat agrees; otherwise each differing
                # seat shifts at most two nodes' counts by one.
                nodes = a[k].keys() | b[k].keys()
                shift = sum(abs(a[k].get(j, 0) - b[k].get(j, 0)) for j in nodes)
                assert shift <= 2 * differ, (step, shift, differ)
            elif k == "moved_full":
                assert abs(a[k] - b[k]) <= differ, (step, a[k], b[k], differ)
            elif k == "residual":
                assert (a[k] < 0) == (b[k] < 0), (step, a[k], b[k])
                assert abs(a[k] - b[k]) <= RESIDUAL_TOL, (step, a[k], b[k])
            else:
                assert a[k] == b[k], (step, k, a[k], b[k])


def run_both(scenario) -> tuple[list[dict], list[dict]]:
    rec_jax = asyncio.run(scenario(JAX_API))
    rec_torch = asyncio.run(scenario(TORCH_API))
    assert_same(rec_jax, rec_torch)
    return rec_jax, rec_torch
