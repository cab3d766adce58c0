"""The log-domain post-solve kernel's roofline reader: its arithmetic, and it counts its own two kernels only."""

import pytest

from rio_bench import harness
from rio_bench.peaks import H100
from rio_bench.trace import Span, Traced

ROWS = "void (anonymous namespace)::logdomain_post_rows_kernel<8>(float const*, ...)"
FINALIZE = "(anonymous namespace)::logdomain_post_finalize_kernel(float const*, int, ...)"
ITERATION = [  # kernel 2, 30 launches a step beside one of this kernel
    "void (anonymous namespace)::logdomain_rows_kernel<4, 8, false>(float const*, ...)",
    "(anonymous namespace)::logdomain_finalize_kernel(float2 const*, int, ...)",
]
OTHERS = ITERATION + [
    "void (anonymous namespace)::potential_round_kernel(...)",
    "void (anonymous namespace)::cdf_round_rows_kernel<float, 4, 8>(...)",
    "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>(...)",
]
COUNTERS = {"n": 1_048_576, "m": 1024, "iterations": 30}


def _read(device):
    traced = Traced(device=device, host=[], window=(0.0, 10_000.0), turns=1, counters=COUNTERS)
    return harness.Registry().metric("logdomain_post_kernel_roofline").read(traced)


def test_the_share_is_the_byte_bound_over_the_time_of_one_launch():
    # Two launches inside the window, 1,550 us of rows kernel and 50 of finalize each; one outside.
    device = [Span(ROWS, 100.0, 1_650.0), Span(FINALIZE, 1_650.0, 1_700.0),
              Span(ROWS, 4_000.0, 5_550.0), Span(FINALIZE, 5_550.0, 5_600.0),
              Span(ROWS, 10_500.0, 12_050.0)]
    n, m = COUNTERS["n"], COUNTERS["m"]
    assert 4 * n * m + 12 * n + 8 * m == 4_307_558_400
    bytes_s = 4_307_558_400 / H100["hbm_bytes_per_s"]
    exps_s = n * m / (16 * 132 * 1.98e9)
    assert exps_s < bytes_s  # bytes bound it: 1.286 ms against 0.257
    assert bytes_s == pytest.approx(1.286e-3, rel=1e-3)
    got = _read(device)
    assert got == pytest.approx(100.0 * bytes_s / 1_600e-6)
    assert 80.0 < got < 81.0


def test_without_the_kernel_the_metric_is_absent():
    assert _read([]) is None
    others = [Span(name, 100.0 + 1_000.0 * i, 600.0 + 1_000.0 * i) for i, name in enumerate(OTHERS)]
    assert _read(others) is None


def test_the_iteration_kernels_launches_are_not_counted():
    mine = [Span(ROWS, 5_000.0, 6_300.0), Span(FINALIZE, 6_300.0, 6_320.0)]
    iterations = [Span(ITERATION[i % 2], 100.0 + 150.0 * i, 240.0 + 150.0 * i) for i in range(30)]
    assert _read(mine + iterations) == pytest.approx(_read(mine))
    assert _read(mine) == pytest.approx(100.0 * 4_307_558_400 / H100["hbm_bytes_per_s"] / 1_320e-6)
