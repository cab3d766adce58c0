"""Device ms a log-domain step spends on its column-marginal error: the ``logdomain.err`` span (``marginal_err``)."""

from rio_bench.stages import stage_ms


def read(t):
    return stage_ms(t, "logdomain.err")
