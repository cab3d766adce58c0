"""The log-domain kernel's roofline reader: its arithmetic, and it counts its own two kernels only."""

import pytest

from rio_bench import harness
from rio_bench.peaks import H100
from rio_bench.trace import Span, Traced

ROWS = "void (anonymous namespace)::logdomain_rows_kernel<4, 8, false>(float const*, ...)"
FINALIZE = "(anonymous namespace)::logdomain_finalize_kernel(float2 const*, int, ...)"
OTHERS = [
    "void (anonymous namespace)::scaling_rows_kernel<__nv_bfloat16, 8, 4, false>(...)",
    "(anonymous namespace)::scaling_finalize_kernel(...)",
    "void (anonymous namespace)::potential_round_kernel(...)",
    "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>(...)",
]
COUNTERS = {"n": 1_048_576, "m": 1024, "iterations": 30}


def _read(device):
    traced = Traced(device=device, host=[], window=(0.0, 10_000.0), turns=1, counters=COUNTERS)
    return harness.Registry().metric("logdomain_kernel_roofline").read(traced)


def test_the_share_is_the_byte_bound_over_the_time_of_one_iteration():
    # Two iterations inside the window, 1,400 us of rows kernel and 100 of finalize each; one outside.
    device = [Span(ROWS, 100.0, 1_500.0), Span(FINALIZE, 1_500.0, 1_600.0),
              Span(ROWS, 2_000.0, 3_400.0), Span(FINALIZE, 3_400.0, 3_500.0),
              Span(ROWS, 10_500.0, 11_900.0)]
    n, m = COUNTERS["n"], COUNTERS["m"]
    bytes_s = 4_303_368_192 / H100["hbm_bytes_per_s"]  # chip_smoke.py's count at this size
    exps_s = 2 * n * m / (16 * 132 * 1.98e9)
    assert exps_s < bytes_s  # bytes bound it: 1.285 ms against 0.514
    assert exps_s == pytest.approx(0.514e-3, rel=1e-3)
    got = _read(device)
    assert got == pytest.approx(100.0 * bytes_s / 1_500e-6)
    assert 85.0 < got < 86.0


def test_the_reader_counts_no_other_kernel():
    others = [Span(name, 100.0 + 1_000.0 * i, 600.0 + 1_000.0 * i) for i, name in enumerate(OTHERS)]
    assert _read(others) is None
    mine = [Span(ROWS, 5_000.0, 6_400.0), Span(FINALIZE, 6_400.0, 6_500.0)]
    assert _read(mine + others) == pytest.approx(_read(mine))
