"""The K-build kernel's roofline reader: its arithmetic, and each of the three
roofline readers counts its own kernel only."""

import pytest

from rio_bench import harness
from rio_bench.peaks import H100
from rio_bench.trace import Span, Traced

KBUILD = "void (anonymous namespace)::kbuild_rows_kernel<__nv_bfloat16, 8>(...)"
KBUILD_ANY = "void (anonymous namespace)::kbuild_any_kernel<float>(...)"
ROUND = "void (anonymous namespace)::cdf_round_rows_kernel<__nv_bfloat16, 8, 4>(...)"
ROWS = "void (anonymous namespace)::scaling_rows_kernel<__nv_bfloat16, 8, 4, false>(...)"
FINALIZE = "(anonymous namespace)::scaling_finalize_kernel(...)"
COUNTERS = {"n": 1_048_576, "m": 1024, "iterations": 30, "k_bytes": 2}


def _reader(name):
    return harness.Registry().metric(name).read


def _traced(device, counters=COUNTERS):
    return Traced(device=device, host=[], window=(0.0, 10_000.0), turns=1, counters=counters)


def test_kbuild_kernel_roofline_is_the_byte_bound_over_the_time_of_one_launch():
    # Two launches of 2.5 ms each inside the window, one outside it.
    device = [Span(KBUILD, 100.0, 2_600.0), Span(KBUILD, 5_000.0, 7_500.0),
              Span(KBUILD, 10_500.0, 13_000.0)]
    n, m = COUNTERS["n"], COUNTERS["m"]
    bound_s = (n * m * 4 + n * m * 2 + 4 * n) / H100["hbm_bytes_per_s"]
    assert bound_s > 3 * n * m / H100["f32_flops_per_s"]  # bytes bound it
    got = _reader("kbuild_kernel_roofline")(_traced(device))
    assert got == pytest.approx(100.0 * bound_s / 2_500e-6)
    assert 75.0 < got < 80.0


def test_kbuild_kernel_roofline_counts_four_bytes_of_k_for_float32_k():
    device = [Span(KBUILD_ANY, 100.0, 3_100.0)]
    counters = dict(COUNTERS, k_bytes=4)
    n, m = counters["n"], counters["m"]
    bound_s = (n * m * 4 + n * m * 4 + 4 * n) / H100["hbm_bytes_per_s"]
    got = _reader("kbuild_kernel_roofline")(_traced(device, counters))
    assert got == pytest.approx(100.0 * bound_s / 3_000e-6)


def test_kbuild_kernel_roofline_is_absent_without_the_kernel():
    assert _reader("kbuild_kernel_roofline")(_traced([])) is None


@pytest.mark.parametrize(
    "reader,own,other",
    [
        ("round_kernel_roofline", [ROUND], [ROWS, FINALIZE, KBUILD, KBUILD_ANY]),
        ("scaling_kernel_roofline", [ROWS, FINALIZE], [ROUND, KBUILD, KBUILD_ANY]),
        ("kbuild_kernel_roofline", [KBUILD], [ROWS, FINALIZE, ROUND]),
    ],
)
def test_each_roofline_reader_counts_its_own_kernel_only(reader, own, other):
    read = _reader(reader)
    others = [Span(name, 100.0 + 1_000.0 * i, 600.0 + 1_000.0 * i) for i, name in enumerate(other)]
    assert read(_traced(others)) is None
    mine = [Span(name, 5_000.0 + 1_000.0 * i, 5_400.0 + 1_000.0 * i) for i, name in enumerate(own)]
    assert read(_traced(mine + others)) == pytest.approx(read(_traced(mine)))
