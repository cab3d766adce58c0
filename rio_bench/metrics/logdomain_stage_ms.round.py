"""Device ms a log-domain step spends rounding from the potentials: the ``logdomain.round`` span."""

from rio_bench.stages import stage_ms


def read(t):
    return stage_ms(t, "logdomain.round")
