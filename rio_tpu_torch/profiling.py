"""The device's idle share over a window, from a ``torch.profiler`` trace.

:class:`DeviceWindow` profiles the code inside it (CPU and CUDA activities)
under a ``record_function`` that marks the window on the host clock, and
synchronises the card before the window closes. On exit it reads the
trace:

* device spans: every kernel, memcpy and memset the card ran (the trace's
  CUDA events, without the ``record_function`` ranges the profiler mirrors
  onto the device timeline);
* host spans: every operator and ``record_function`` range on the CPU.

:func:`idle_report` turns them into the window's length, the device's busy
time (the union of the device spans inside the window), the idle share
``1 - busy / window``, the top device operations by total time and the
longest idle gaps, each with the innermost host span open across all of
it. A window in which the card ran nothing raises: an idle share of 1 from
a trace that holds no device event would say the profiler saw an idle
card, where it saw no card at all.

Times are microseconds on the profiler's clock.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch._C._profiler import _ExperimentalConfig
from torch.autograd import DeviceType

__all__ = ["DeviceWindow", "Span", "idle_report", "trace_spans"]


class Span(NamedTuple):
    name: str
    start: float  # microseconds
    end: float


def _merged(spans: list[Span], lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of ``spans`` clipped to ``[lo, hi]``, as sorted disjoint intervals."""
    out: list[tuple[float, float]] = []
    for s, e in sorted((max(s.start, lo), min(s.end, hi)) for s in spans):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _open_across(host: list[Span], start: float, end: float) -> str | None:
    """The innermost (shortest) host span that covers ``[start, end]``."""
    covering = [h for h in host if h.start <= start and h.end >= end]
    return min(covering, key=lambda h: h.end - h.start).name if covering else None


def idle_report(
    device: list[Span],
    host: list[Span],
    window: tuple[float, float],
    *,
    top: int = 5,
    gaps: int = 3,
) -> dict:
    """Busy and idle time of the device over ``window``.

    Returns ``window_ms``, ``busy_ms``, ``idle_share``, ``device_events``
    (spans overlapping the window), ``top_ops`` (``top`` names by total
    clipped time: ``name``, ``ms``, ``count``) and ``gaps`` (the ``gaps``
    longest idle intervals: ``ms``, ``at_ms`` from the window's start, and
    ``host``, the innermost host span open across it, or None). Raises
    ``RuntimeError`` when no device span overlaps the window.
    """
    lo, hi = window
    if hi <= lo:
        raise ValueError(f"empty window {window}")
    inside = [s for s in device if s.end > lo and s.start < hi]
    if not inside:
        raise RuntimeError(
            "the trace holds no device event inside the window: the profiler did "
            "not trace the device, so there is no idle share to report"
        )
    busy = _merged(inside, lo, hi)
    busy_us = sum(e - s for s, e in busy)

    idle = []
    edge = lo
    for s, e in busy:
        if s > edge:
            idle.append((edge, s))
        edge = e
    if hi > edge:
        idle.append((edge, hi))
    idle.sort(key=lambda g: g[1] - g[0], reverse=True)

    totals: dict[str, list] = {}
    for sp in inside:
        t = totals.setdefault(sp.name, [0.0, 0])
        t[0] += min(sp.end, hi) - max(sp.start, lo)
        t[1] += 1
    ranked = sorted(totals.items(), key=lambda kv: kv[1][0], reverse=True)
    return {
        "window_ms": (hi - lo) / 1e3,
        "busy_ms": busy_us / 1e3,
        "idle_share": 1.0 - busy_us / (hi - lo),
        "device_events": len(inside),
        "top_ops": [{"name": n, "ms": t / 1e3, "count": c} for n, (t, c) in ranked[:top]],
        "gaps": [
            {"ms": (e - s) / 1e3, "at_ms": (s - lo) / 1e3, "host": _open_across(host, s, e)}
            for s, e in idle[:gaps]
        ],
    }


def trace_spans(prof) -> tuple[list[Span], list[Span]]:
    """``(device, host)`` spans of a finished ``torch.profiler.profile``."""
    device, host = [], []
    for ev in prof.events():
        span = Span(ev.name, float(ev.time_range.start), float(ev.time_range.end))
        if ev.device_type == DeviceType.CUDA:
            # Ranges of record_function mirrored onto the device timeline
            # span the gaps between kernels: they are not device work.
            if not getattr(ev, "is_user_annotation", False):
                device.append(span)
        elif ev.device_type == DeviceType.CPU:
            host.append(span)
    return device, host


class DeviceWindow:
    """Profile the code inside the ``with`` block; read ``report`` after it.

    ``report`` is :func:`idle_report` over the block, with the host
    operators of every thread, and ``device`` the trace's device spans (to
    count a kernel's launches by name). The card is synchronised before the
    window closes, so the block's device work lies inside it.
    """

    def __init__(self, label: str = "rio_tpu_torch.window", *, top: int = 5, gaps: int = 3) -> None:
        self.label = label
        self._top, self._gaps = top, gaps
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        # Host operators of every thread: the provider solves in a worker
        # thread (asyncio.to_thread), and its record_function names the solve.
        self._prof = torch.profiler.profile(
            activities=activities,
            experimental_config=_ExperimentalConfig(profile_all_threads=True),
        )
        self._mark = torch.profiler.record_function(label)
        self.report: dict | None = None
        self.device: list[Span] = []

    def __enter__(self) -> "DeviceWindow":
        self._prof.__enter__()
        self._mark.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        try:
            if exc_type is None and torch.cuda.is_available():
                torch.cuda.synchronize()
        finally:
            self._mark.__exit__(exc_type, exc, tb)
            self._prof.__exit__(exc_type, exc, tb)
        if exc_type is None:
            self.device, host = trace_spans(self._prof)
            marks = [h for h in host if h.name == self.label]
            if len(marks) != 1:
                raise RuntimeError(f"{len(marks)} window marks {self.label!r} in the trace, want 1")
            self.report = idle_report(
                self.device, host, (marks[0].start, marks[0].end), top=self._top, gaps=self._gaps
            )
        return False

    def count(self, fragment: str) -> int:
        """Device spans whose name contains ``fragment`` (a kernel's launches)."""
        return sum(fragment in s.name for s in self.device)
