"""The stage metrics read the program's own spans in a traced run, and fall silent without them."""

import pytest

from rio_bench import harness, stages
from rio_bench.trace import Span, Traced

from .tiny import SPEC, run_tiny

STAGE_CELLS = {
    "flat-1m-1k.place": "flat_stage_ms.",
    "hier-10m-1k.place": "hier_stage_ms.",
}


@pytest.mark.parametrize("cell", sorted(STAGE_CELLS))
def test_a_tiny_traced_run_reports_each_stage_of_its_path(tiny, cell):
    res = run_tiny(tiny, cell, trace=True, seconds=0.5)
    _, layer = harness.cell_metrics(SPEC, cell)
    names = [m["name"] for m in layer if m["source"] == "program_span"]
    assert len(names) == 4 and all(n.startswith(STAGE_CELLS[cell]) for n in names)
    for name in names:
        got = res["metrics"][name]
        assert got["unit"] == "ms" and isinstance(got["value"], float) and got["value"] > 0, name


def test_a_trace_without_the_span_reads_nothing():
    host = [Span("rio_bench.placement_step", 10.0, 90.0), Span("placement.round", 5.0, 95.0)]
    traced = Traced(device=[], host=host, window=(0.0, 100.0), turns=1, counters={})
    assert stages.stage_ms(traced, "placement.repair") is None
    outside = Traced(device=[], host=host, window=(20.0, 100.0), turns=1, counters={})
    assert stages.stage_ms(outside, "placement.round") is None
