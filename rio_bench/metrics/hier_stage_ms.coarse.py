"""Device ms a two-level solve spends in its coarse stages (16 chunks): the ``hier.coarse`` span."""

from rio_bench.stages import stage_ms


def read(t):
    return stage_ms(t, "hier.coarse")
