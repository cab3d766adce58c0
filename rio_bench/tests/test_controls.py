"""``correct`` comes out false for each cell's controls and for each fault a cell can have.

The controls (:mod:`rio_bench.control`) run here at CPU sizes, and on a
card at the cell's own size (``test_control_fails_at_the_cell_size``).
Each fault breaks the timed path underneath a whole run:

* the state left unchanged: a step that answers with the previous step's
  answer, a rebalance that does nothing;
* half of the batch left out: half of the objects placed, the rest on node 0
  or given no seat;
* an answer altered where it is produced: one seat moved to another node.

A cell runs on one card, so none has an exchange between chips to leave out.
"""

import json
import time
from types import SimpleNamespace

import pytest
import torch

from rio_bench import control, harness
from rio_bench.reference.directory import PlainDirectory

from .tiny import SPEC, run_tiny

CELLS = [w["name"] for w in SPEC["workloads"]]


def _controls(registry, cell) -> dict:
    workload = registry.workload(cell)
    return control.controls_for(workload["driver"], registry.config(workload["config"]))


CONTROLS = [(cell, name) for cell in CELLS for name in _controls(harness.Registry(), cell)]


@pytest.mark.parametrize(("cell", "name"), CONTROLS)
def test_control_is_not_correct(tiny, cell, name):
    res = run_tiny(tiny, cell, program=_controls(tiny[0], cell)[name])
    assert not res["correct"], res["checks"]


def test_plain_directory_that_keeps_the_guarantees_is_correct(tiny):
    res = run_tiny(tiny, "flat-1m-1k.churn", program=lambda: PlainDirectory(max_delta_solves=8))
    assert res["correct"], res["checks"]


# -- faults of the placement entries ------------------------------------------

def _flat(fault):
    from rio_tpu_torch.entry import placement_step

    previous = []

    def step(cost, mass, cap, **kw):
        if fault == "half":
            n = cost.shape[0] // 2
            seats, mean_cost, err = placement_step(cost[:n].contiguous(), mass[:n], cap, **kw)
            return torch.cat([seats, torch.zeros_like(seats)]), mean_cost, err
        seats, mean_cost, err = placement_step(cost, mass, cap, **kw)
        if fault == "unchanged":  # answers with the previous call's state
            previous.append(seats)
            seats = previous[-2] if len(previous) > 1 else seats
        elif fault == "altered":
            seats = seats.clone()
            seats[0] = (seats[0] + 1) % cap.shape[0]
        return seats, mean_cost, err

    return step


def _hier(fault):
    from rio_tpu_torch.parallel.hierarchical import chunked_hierarchical_assign

    previous = []

    def solve(obj_feat, node_feat, cap, alive, *, n_chunks, **kw):
        if fault == "half":
            n = obj_feat.shape[0] // 2
            res = chunked_hierarchical_assign(obj_feat[:n], node_feat, cap, alive, n_chunks=n_chunks // 2, **kw)
            seats = torch.cat([res.assignment, torch.zeros_like(res.assignment)])
            return SimpleNamespace(assignment=seats, overflow=res.overflow)
        res = chunked_hierarchical_assign(obj_feat, node_feat, cap, alive, n_chunks=n_chunks, **kw)
        seats = res.assignment
        if fault == "unchanged":  # answers with the previous call's state
            previous.append(seats)
            seats = previous[-2] if len(previous) > 1 else seats
        elif fault == "altered":
            seats = seats.clone()
            seats[0] = (seats[0] + 1) % cap.shape[0]
        return SimpleNamespace(assignment=seats, overflow=res.overflow)

    return solve


class _FaultyDirectory:
    """The program's directory with one fault where its answers are produced."""

    def __init__(self, inner, fault):
        self._inner, self._fault = inner, fault
        self._last: list = []

    def __getattr__(self, name):
        return getattr(self._inner, name)

    async def assign_batch(self, ids):
        self._last = list(ids)
        if self._fault == "half":
            half = len(ids) // 2
            return [*await self._inner.assign_batch(ids[:half]), *[None] * (len(ids) - half)]
        return await self._inner.assign_batch(ids)

    async def rebalance(self, **kw):
        if self._fault == "unchanged":
            return 0
        moved = await self._inner.rebalance(**kw)
        if self._fault == "altered":
            from rio_tpu_torch.object_placement import ObjectPlacementItem

            oid = self._last[0]
            seat = await self._inner.lookup(oid)
            other = next(a for a in self._inner._node_order if a != seat)
            await self._inner.update(ObjectPlacementItem(oid, other))
        return moved


def _churn(fault, config):
    from rio_tpu_torch.object_placement.torch_placement import TorchObjectPlacement

    return lambda: _FaultyDirectory(TorchObjectPlacement(device="cpu", **config["provider"]), fault)


# The broken program of each driver, built from the fault and the cell's configuration.
FAULTS = {
    "place_flat": lambda fault, config: _flat(fault),
    "place_hier": lambda fault, config: _hier(fault),
    "directory_churn": _churn,
}


def broken_program(registry, cell, fault):
    """``cell``'s timed path with ``fault``, chosen by the driver its workload file names."""
    workload = registry.workload(cell)
    return FAULTS[workload["driver"]](fault, registry.config(workload["config"]))


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(tiny, cell, fault):
    res = run_tiny(tiny, cell, program=broken_program(tiny[0], cell, fault))
    assert not res["correct"], res["checks"]


@pytest.mark.card
@pytest.mark.parametrize(("cell", "name"), CONTROLS)
def test_control_fails_at_the_cell_size(card, cell, name):
    """On the card, at the cell's own size, on three seeds; prints each run's numbers."""
    registry = harness.Registry()
    program = _controls(registry, cell)[name]
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        res = harness.run(cell, seed, 3.0, False, spec=SPEC, registry=registry, device=card,
                          t_start=time.perf_counter(), program=program)
        print(json.dumps({"cell": cell, "control": name, "seed": seed, "attempted": res["attempted"],
                          "correct": res["correct"], "checks": res["checks"]}), flush=True)
        assert not res["correct"], res["checks"]
