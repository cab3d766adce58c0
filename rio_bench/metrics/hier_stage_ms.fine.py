"""Device ms a two-level solve spends in its batched fine stages: the ``hier.fine`` span."""

from rio_bench.stages import stage_ms


def read(t):
    return stage_ms(t, "hier.fine")
