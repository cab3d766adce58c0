"""rio_tpu_torch.profiling: the idle-share arithmetic, on synthetic spans and on a CPU trace.

Device spans that overlap, nest, run past the window's edges or lie wholly
outside it must give the exact busy time, idle share and idle gaps; each gap
names the innermost host span open across all of it. A real profiler window
over a CPU step has no device event, and the helper must raise rather than
report an idle share of 1.
"""

import pytest

torch = pytest.importorskip("torch")

from rio_tpu_torch.profiling import DeviceWindow, Span, idle_report  # noqa: E402

WINDOW = (100.0, 200.0)  # microseconds
HOST = [
    Span("window", 100.0, 200.0),
    Span("solve", 105.0, 160.0),
    Span("aten::item", 150.0, 158.0),
]


def test_overlapping_nested_and_outside_spans():
    device = [
        Span("k1", 90.0, 110.0),   # starts before the window: 100..110 counts
        Span("k2", 105.0, 120.0),  # overlaps k1: union 100..120
        Span("k3", 107.0, 112.0),  # nested in k2: adds nothing
        Span("k1", 150.0, 155.0),
        Span("memset", 195.0, 230.0),  # runs past the window: 195..200 counts
        Span("k9", 10.0, 20.0),    # before the window
        Span("k9", 300.0, 400.0),  # after it
    ]
    rep = idle_report(device, HOST, WINDOW, top=2, gaps=3)
    assert rep["window_ms"] == pytest.approx(0.1)
    assert rep["busy_ms"] == pytest.approx((20.0 + 5.0 + 5.0) / 1e3)
    assert rep["idle_share"] == pytest.approx(0.7)
    assert rep["device_events"] == 5
    # Idle: 120..150 (30), 155..195 (40); only 3 gaps exist: the longest first.
    assert [g["ms"] for g in rep["gaps"]] == pytest.approx([0.040, 0.030])
    assert [g["at_ms"] for g in rep["gaps"]] == pytest.approx([0.055, 0.020])
    assert [g["host"] for g in rep["gaps"]] == ["window", "solve"]
    # Time per name is clipped to the window: k1 10 + 5, k2 15, k3 5, memset 5.
    assert [(o["name"], o["count"]) for o in rep["top_ops"]] == [("k1", 2), ("k2", 1)]
    assert rep["top_ops"][0]["ms"] == pytest.approx(0.015)


def test_gap_at_the_window_edges_and_innermost_host_span():
    device = [Span("k", 152.0, 154.0)]
    rep = idle_report(device, HOST, WINDOW, gaps=3)
    assert rep["busy_ms"] == pytest.approx(0.002)
    assert rep["idle_share"] == pytest.approx(0.98)
    assert [g["ms"] for g in rep["gaps"]] == pytest.approx([0.052, 0.046])
    assert [g["at_ms"] for g in rep["gaps"]] == pytest.approx([0.0, 0.054])
    # No host span covers 100..152 but the window; 154..200 likewise.
    assert [g["host"] for g in rep["gaps"]] == ["window", "window"]
    inner = idle_report([Span("k", 100.0, 151.0), Span("k", 157.0, 200.0)], HOST, WINDOW)
    assert inner["gaps"] == [{"ms": pytest.approx(0.006), "at_ms": pytest.approx(0.051), "host": "aten::item"}]


def test_a_fully_busy_window_has_no_gap():
    rep = idle_report([Span("k", 50.0, 250.0)], [], WINDOW)
    assert rep["idle_share"] == 0.0 and rep["gaps"] == []


def test_no_device_event_in_the_window_raises():
    with pytest.raises(RuntimeError, match="no device event"):
        idle_report([Span("k", 10.0, 20.0)], HOST, WINDOW)
    with pytest.raises(ValueError, match="empty window"):
        idle_report([Span("k", 10.0, 20.0)], HOST, (5.0, 5.0))


def test_a_profiled_cpu_step_raises_for_want_of_device_events():
    a = torch.randn(256, 256)
    with pytest.raises(RuntimeError, match="no device event"):
        with DeviceWindow("cpu_step") as window:
            (a @ a).sum()
    assert window.report is None and window.count("kernel") == 0
