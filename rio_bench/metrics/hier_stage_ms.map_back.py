"""Device ms a two-level solve spends mapping seats back to object order: the ``hier.map_back`` span."""

from rio_bench.stages import stage_ms


def read(t):
    return stage_ms(t, "hier.map_back")
