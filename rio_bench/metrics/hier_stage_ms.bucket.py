"""Device ms a two-level solve spends bucketing objects by group: the ``hier.bucket`` span."""

from rio_bench.stages import stage_ms


def read(t):
    return stage_ms(t, "hier.bucket")
