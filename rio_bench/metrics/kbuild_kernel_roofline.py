"""The K-build kernel's share of its roofline, from the device trace.

One launch a flat step reads the float32 cost once and writes K and each
row's shift (``kbuild_rows_kernel`` or, for rows it cannot hold,
``kbuild_any_kernel``; ``rio_tpu_torch/kernels/csrc/kbuild.cu``). Its least
time is the larger of its bytes over the card's HBM bandwidth and its
operations over the float32 peak; the share is that time over the traced
device time of one launch. A program without the kernel leaves no such
span: the metric is then absent.
"""

from rio_bench.peaks import H100
from rio_bench.trace import busy_us

KERNEL = "kbuild_"


def launch_bytes(n: int, m: int, k_bytes: int) -> int:
    """The float32 cost read once, K written once, the float32 shift written once."""
    return n * m * 4 + n * m * k_bytes + 4 * n


def launch_flops(n: int, m: int) -> int:
    """Per element of the cost: one subtract, one divide and one exponential."""
    return 3 * n * m


def read(t):
    lo, hi = t.window
    spans = [s for s in t.device if KERNEL in s.name and lo <= s.start < hi]
    if not spans:
        return None
    kernel_us = busy_us(spans, lo, hi)
    c = t.counters
    bound_s = max(
        launch_bytes(c["n"], c["m"], c["k_bytes"]) / H100["hbm_bytes_per_s"],
        launch_flops(c["n"], c["m"]) / H100["f32_flops_per_s"],
    )
    return 100.0 * bound_s / (kernel_us / 1e6 / len(spans))
