"""Device ms a two-level solve spends scoring each object's best live member per group: the ``hier.coarse_score`` span, inside ``hier.coarse``."""

from rio_bench.stages import stage_ms


def read(t):
    return stage_ms(t, "hier.coarse_score")
