"""Device ms a flat step spends in the CDF rounding: the ``placement.round`` span."""

from rio_bench.stages import stage_ms


def read(t):
    return stage_ms(t, "placement.round")
