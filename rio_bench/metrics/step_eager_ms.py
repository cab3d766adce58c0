"""Device milliseconds a placement step spends outside the scaling kernel.

The K build, the CDF rounding, the row-marginal check, the exact-quota
repair and the copy of the assignment to the host (``entry.placement_step``):
the union of every other device span in the traced window, per step.
"""

from rio_bench.trace import busy_us

KERNELS = ("scaling_rows_kernel", "scaling_finalize_kernel")


def read(t):
    lo, hi = t.window
    others = [s for s in t.device if not any(k in s.name for k in KERNELS)]
    if not others or not t.turns:
        return None
    return busy_us(others, lo, hi) / 1e3 / t.turns
