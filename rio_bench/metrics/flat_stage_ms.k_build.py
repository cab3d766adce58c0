"""Device ms a flat step spends building K: the program's ``scaling.k_build`` span."""

from rio_bench.stages import stage_ms


def read(t):
    return stage_ms(t, "scaling.k_build")
