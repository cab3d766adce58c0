"""Device ms a two-level solve spends rounding from the potentials: the ``hier.round`` spans, inside ``hier.coarse`` and ``hier.fine``."""

from rio_bench.stages import stage_ms


def read(t):
    return stage_ms(t, "hier.round")
