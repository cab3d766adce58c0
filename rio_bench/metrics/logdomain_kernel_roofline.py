"""The log-domain iteration kernel's share of its roofline, from the device trace.

One iteration is one launch of ``fused_iteration``: ``logdomain_rows_kernel``
then ``logdomain_finalize_kernel`` (``rio_tpu_torch/kernels/csrc/logdomain_iteration.cu``),
30 a step. The time of an iteration is the two kernels' busy time over the
launches of the rows kernel. Its least time is the larger of its bytes over
the card's HBM bandwidth and its exponentials over the card's exponential
rate; the share is that time over the traced time of an iteration.

The bytes are ``chip_smoke.py``'s count: the float32 cost once, ``log_a``,
``log_b`` and ``g`` read and ``f`` and ``g'`` written once, 4,303,368,192 B
at 1,048,576 x 1,024. The partial column pairs that pass from the rows
kernel to the finalize kernel (at most one row of ``m`` float2 a CTA, about
1 MB each way at that size, under 0.05% of the cost) are left out, so the
share errs low.

The exponentials are two a cost element, one for the row LSE and one for
the column LSE. The rate: an H100 SM's special-function units give 16
``ex2`` results a clock (as ``chip_smoke.py``'s ``EXP_PER_CLOCK_PER_SM``);
16 x 132 SMs x 1.98 GHz, the H100 SXM's highest SM clock, is 4.18e12 a
second, 0.514 ms for the 2 x 2^30 exponentials of an iteration at that
size, against 1.285 ms of bytes: the bytes bound it.
"""

from rio_bench.peaks import H100
from rio_bench.trace import busy_us

KERNELS = ("logdomain_rows_kernel", "logdomain_finalize_kernel")
EXP_PER_S = 16 * 132 * 1.98e9


def iteration_bytes(n: int, m: int) -> int:
    """The float32 cost once; log_a, log_b, g read and f, g' written once, float32."""
    return 4 * n * m + 4 * (n + 2 * m) + 4 * (n + m)


def iteration_exps(n: int, m: int) -> int:
    """Two exponentials a cost element: the row LSE's and the column LSE's."""
    return 2 * n * m


def read(t):
    lo, hi = t.window
    launches = sum(KERNELS[0] in s.name and lo <= s.start < hi for s in t.device)
    if not launches:
        return None
    kernel_us = busy_us([s for s in t.device if any(k in s.name for k in KERNELS)], lo, hi)
    c = t.counters
    bound_s = max(
        iteration_bytes(c["n"], c["m"]) / H100["hbm_bytes_per_s"],
        iteration_exps(c["n"], c["m"]) / EXP_PER_S,
    )
    return 100.0 * bound_s / (kernel_us / 1e6 / launches)
