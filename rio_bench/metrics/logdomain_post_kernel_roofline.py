"""The log-domain step's post-solve kernel's share of its roofline, from the device trace.

One launch of ``logdomain_post`` a step: ``logdomain_post_rows_kernel``, then
its finalize, ``logdomain_post_finalize_kernel``
(``rio_tpu_torch/kernels/csrc/logdomain_post.cu``), which round every row
from the potentials and sum the plan's columns for the error. The time of a
launch is the two kernels' busy time over the launches of the rows kernel. Its
least time is the larger of its bytes over the card's HBM bandwidth and its
exponentials over the card's exponential rate; the share is that time over
the traced time of a launch.

The bytes: the float32 cost once; ``f`` and ``q`` read and ``idx`` written;
``g`` and ``b`` read: ``4nm + 12n + 8m``, 4,307,558,400 B at 1,048,576 x
1,024 (1.286 ms at 3.35 TB/s). The partial column sums that pass from the
rows kernel to the finalize (one row of ``m`` floats a CTA, about 0.5 MB each
way at that size) are left out, so the share errs low.

The exponentials are one a cost element, ``exp(x) = exp(x - max) exp(max)``,
at the rate of ``logdomain_kernel_roofline`` (4.18e12 a second): 0.257 ms at
that size, so the bytes bound it. Without such a kernel in the trace (a
program that rounds eagerly) the metric is absent.
"""

from rio_bench.peaks import H100
from rio_bench.trace import busy_us

KERNELS = ("logdomain_post_rows_kernel", "logdomain_post_finalize_kernel")
EXP_PER_S = 16 * 132 * 1.98e9


def post_bytes(n: int, m: int) -> int:
    """The float32 cost once; f and q read, idx written; g and b read."""
    return 4 * n * m + 12 * n + 8 * m


def post_exps(n: int, m: int) -> int:
    """One exponential a cost element."""
    return n * m


def read(t):
    lo, hi = t.window
    launches = sum(KERNELS[0] in s.name and lo <= s.start < hi for s in t.device)
    if not launches:
        return None
    kernel_us = busy_us([s for s in t.device if any(k in s.name for k in KERNELS)], lo, hi)
    c = t.counters
    bound_s = max(post_bytes(c["n"], c["m"]) / H100["hbm_bytes_per_s"], post_exps(c["n"], c["m"]) / EXP_PER_S)
    return 100.0 * bound_s / (kernel_us / 1e6 / launches)
