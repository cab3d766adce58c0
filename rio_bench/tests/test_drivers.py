"""Each driver runs a tiny cell on the CPU path, and the result line has the contract's shape."""

import json

import pytest

from rio_bench import harness

from .tiny import SPEC, run_tiny

CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_is_correct_and_well_formed(tiny, cell):
    res = run_tiny(tiny, cell)
    assert res["correct"], res["checks"]
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    e2e, _ = harness.cell_metrics(SPEC, cell)
    assert set(res["metrics"]) == {m["name"] for m in e2e}
    for m in e2e:
        got = res["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and isinstance(got["value"], float) and got["value"] > 0
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())
    json.dumps(res)


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_traced_run_reports_only_per_layer_metrics(tiny, cell):
    res = run_tiny(tiny, cell, trace=True, seconds=0.5)
    _, layer = harness.cell_metrics(SPEC, cell)
    assert set(res["metrics"]) <= {m["name"] for m in layer}
    assert list(res)[-1] == "checks"


def test_a_failing_turn_is_counted_and_ends_the_window(tiny):
    from rio_tpu_torch.entry import placement_step

    calls = []

    def broken(*args, **kwargs):  # the warm-up steps pass, the first timed one raises
        calls.append(1)
        if len(calls) > 2:
            raise RuntimeError("broken on purpose")
        return placement_step(*args, **kwargs)

    res = run_tiny(tiny, "flat-1m-1k.place", program=broken)
    assert (res["attempted"], res["failed"], res["correct"]) == (1, 1, False)
