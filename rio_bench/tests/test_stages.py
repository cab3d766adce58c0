"""The stage metrics read the program's own spans in a traced run, and fall silent without them."""

import pytest

from rio_bench import harness, stages
from rio_bench.trace import Span, Traced

from .tiny import SPEC, run_tiny


def stage_path(registry, cell) -> tuple[str, tuple[str, ...]]:
    """The prefix of ``cell``'s stage metrics and the stages every cell of its driver reports.

    Read from the driver's test file, ``tests/drivers/<driver>.py`` (``stages``).
    """
    path = registry.driver_tests(registry.workload(cell)["driver"]).stages
    assert path is not None, f"the driver of {cell!r} names no stages"
    return path


def span_metrics(spec, cell) -> list[str]:
    """The ``program_span`` metrics that ``cell`` reports."""
    _, layer = harness.cell_metrics(spec, cell)
    return [m["name"] for m in layer if m["source"] == "program_span"]


def check_stages(tiny, cell) -> None:
    """A tiny traced run of ``cell`` reads each of its stage metrics, in ms, above 0."""
    registry, spec = tiny
    prefix, path = stage_path(registry, cell)
    names = span_metrics(spec, cell)
    assert all(n.startswith(prefix) for n in names), names
    assert {prefix + stage for stage in path} <= set(names), names
    res = run_tiny(tiny, cell, trace=True, seconds=0.5)
    for name in names:
        got = res["metrics"][name]
        assert got["unit"] == "ms" and isinstance(got["value"], float) and got["value"] > 0, name


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"] if span_metrics(SPEC, w["name"])])
def test_a_tiny_traced_run_reports_each_stage_of_its_path(tiny, cell):
    check_stages(tiny, cell)


def test_a_trace_without_the_span_reads_nothing():
    host = [Span("rio_bench.placement_step", 10.0, 90.0), Span("placement.round", 5.0, 95.0)]
    traced = Traced(device=[], host=host, window=(0.0, 100.0), turns=1, counters={})
    assert stages.stage_ms(traced, "placement.repair") is None
    outside = Traced(device=[], host=host, window=(20.0, 100.0), turns=1, counters={})
    assert stages.stage_ms(outside, "placement.round") is None
