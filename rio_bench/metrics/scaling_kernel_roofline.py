"""The scaling iteration kernel's share of its roofline, from the device trace.

One iteration is ``scaling_rows_kernel`` then ``scaling_finalize_kernel``
(``rio_tpu_torch/kernels/csrc/scaling_iteration.cu``). Its least time is
the larger of its bytes over the card's HBM bandwidth and its operations
over the float32 peak; the share is that time over the traced device time
per iteration. The byte count is ``chip_smoke.py``'s: K once, and each
vector read or written once.
"""

from rio_bench.peaks import H100
from rio_bench.trace import busy_us

KERNELS = ("scaling_rows_kernel", "scaling_finalize_kernel")


def iteration_bytes(n: int, m: int, k_bytes: int) -> int:
    """K (n x m) once; a, b, v read and u, v' written once, float32."""
    return n * m * k_bytes + 4 * (n + 2 * m) + 4 * (n + m)


def iteration_flops(n: int, m: int) -> int:
    """Two multiply-adds per element of K."""
    return 4 * n * m


def read(t):
    lo, hi = t.window
    launches = sum(KERNELS[0] in s.name and lo <= s.start < hi for s in t.device)
    if not launches:
        return None
    kernel_us = busy_us([s for s in t.device if any(k in s.name for k in KERNELS)], lo, hi)
    c = t.counters
    bound_s = max(
        iteration_bytes(c["n"], c["m"], c["k_bytes"]) / H100["hbm_bytes_per_s"],
        iteration_flops(c["n"], c["m"]) / H100["f32_flops_per_s"],
    )
    return 100.0 * bound_s / (kernel_us / 1e6 / launches)
