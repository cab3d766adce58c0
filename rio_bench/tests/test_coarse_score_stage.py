"""The coarse-score stage reader: the ``hier.coarse_score`` span when the trace holds it, nothing when it does not."""

import torch

from rio_bench import harness
from rio_bench.trace import Span, Traced

NAME = "hier_stage_ms.coarse_score"


def _reader():
    return harness.Registry().metric(NAME).read


def test_the_reader_takes_the_newest_entries_of_the_span_per_turn():
    from rio_tpu_torch import tracing

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(4):
            with tracing.span("hier.coarse_score", impl="eager"):
                pass
    newest = tracing.device_stage_ms("hier.coarse_score", 2)
    host = [Span("hier.coarse", 10.0, 40.0), Span("hier.coarse_score", 12.0, 30.0),
            Span("hier.coarse", 50.0, 80.0), Span("hier.coarse_score", 52.0, 70.0),
            Span("hier.coarse_score", 120.0, 130.0)]  # outside the window
    traced = Traced(device=[], host=host, window=(0.0, 100.0), turns=2, counters={})
    got = _reader()(traced)
    assert isinstance(got, float) and got >= 0.0
    assert got == newest / 2


def test_the_reader_gives_none_without_the_span():
    host = [Span("hier.coarse", 10.0, 40.0), Span("hier.fine", 45.0, 90.0)]
    traced = Traced(device=[], host=host, window=(0.0, 100.0), turns=1, counters={})
    assert _reader()(traced) is None
