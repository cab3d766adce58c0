"""Device ms a log-domain step spends in the exact-quota repair: the ``placement.repair`` span."""

from rio_bench.stages import stage_ms


def read(t):
    return stage_ms(t, "placement.repair")
