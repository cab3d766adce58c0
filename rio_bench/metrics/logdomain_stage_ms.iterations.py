"""Device ms a log-domain step spends in its iterations: the ``logdomain.iterations`` span (30 launches of the log-domain kernel on the card)."""

from rio_bench.stages import stage_ms


def read(t):
    return stage_ms(t, "logdomain.iterations")
