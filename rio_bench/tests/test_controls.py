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
Each driver's controls and broken programs are in its test file,
``tests/drivers/<driver>.py`` (``controls(config)``, ``broken(fault, config)``),
found by the driver's name in the benchmark folder under test.
"""

import json
import time

import pytest

from rio_bench import harness
from rio_bench.reference.directory import PlainDirectory

from .tiny import SPEC, run_tiny

CELLS = [w["name"] for w in SPEC["workloads"]]


def _driver_tests(registry, cell):
    """The test file of ``cell``'s driver, and the cell's configuration."""
    workload = registry.workload(cell)
    return registry.driver_tests(workload["driver"]), registry.config(workload["config"])


def controls_for(registry, cell) -> dict:
    """The controls, by name, that take the place of the entry ``cell``'s driver drives."""
    tests, config = _driver_tests(registry, cell)
    return tests.controls(config)


CONTROLS = [(cell, name) for cell in CELLS for name in controls_for(harness.Registry(), cell)]


@pytest.mark.parametrize(("cell", "name"), CONTROLS)
def test_control_is_not_correct(tiny, cell, name):
    res = run_tiny(tiny, cell, program=controls_for(tiny[0], cell)[name])
    assert not res["correct"], res["checks"]


def test_plain_directory_that_keeps_the_guarantees_is_correct(tiny):
    res = run_tiny(tiny, "flat-1m-1k.churn", program=lambda: PlainDirectory(max_delta_solves=8))
    assert res["correct"], res["checks"]


def broken_program(registry, cell, fault):
    """``cell``'s timed path with ``fault``, from the test file of the driver its workload file names."""
    tests, config = _driver_tests(registry, cell)
    return tests.broken(fault, config)


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
    program = controls_for(registry, cell)[name]
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        res = harness.run(cell, seed, 3.0, False, spec=SPEC, registry=registry, device=card,
                          t_start=time.perf_counter(), program=program)
        print(json.dumps({"cell": cell, "control": name, "seed": seed, "attempted": res["attempted"],
                          "correct": res["correct"], "checks": res["checks"]}), flush=True)
        assert not res["correct"], res["checks"]
