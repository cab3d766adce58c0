"""Device ms a flat step spends in the row-marginal check: the ``placement.row_check`` span."""

from rio_bench.stages import stage_ms


def read(t):
    return stage_ms(t, "placement.row_check")
