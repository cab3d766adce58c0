"""The device's busy and idle time over a traced stretch of a run.

The arithmetic is a frozen copy of ``rio_tpu_torch/profiling.py``
(``_merged``, ``_open_across``, ``idle_report``, ``trace_spans``), kept here
so that a change to the program cannot move the yardstick. :class:`Tracer`
is ``DeviceWindow`` split into ``start``/``stop`` so that a driver's loop
can profile a bounded run of turns in the middle of its window.

Times are microseconds on the profiler's clock.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Span(NamedTuple):
    name: str
    start: float  # microseconds
    end: float


def merged(spans, lo: float, hi: float) -> list[tuple[float, float]]:
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


def busy_us(spans, lo: float, hi: float) -> float:
    """Microseconds of ``[lo, hi]`` in which at least one of ``spans`` ran."""
    return sum(e - s for s, e in merged(spans, lo, hi))


def open_across(host, start: float, end: float) -> str | None:
    """The innermost (shortest) host span that covers ``[start, end]``."""
    covering = [h for h in host if h.start <= start and h.end >= end]
    return min(covering, key=lambda h: h.end - h.start).name if covering else None


def idle_report(device, host, window: tuple[float, float], *, top: int = 10, gaps: int = 10) -> dict:
    """Busy and idle time of the device over ``window``.

    Returns ``window_us``, ``busy_us``, ``top_ops`` (``[name, us]`` by total
    clipped time) and ``gaps`` (the longest idle intervals as ``[host span
    open across it, us]``). Raises ``RuntimeError`` when no device span
    overlaps the window: an idle share from a trace without device events
    would report an idle card where the profiler saw no card.
    """
    lo, hi = window
    if hi <= lo:
        raise ValueError(f"empty window {window}")
    inside = [s for s in device if s.end > lo and s.start < hi]
    if not inside:
        raise RuntimeError("the trace holds no device event inside the window")
    busy = merged(inside, lo, hi)
    idle, edge = [], lo
    for s, e in busy:
        if s > edge:
            idle.append((edge, s))
        edge = e
    if hi > edge:
        idle.append((edge, hi))
    idle.sort(key=lambda g: g[1] - g[0], reverse=True)
    totals: dict[str, float] = {}
    for sp in inside:
        totals[sp.name] = totals.get(sp.name, 0.0) + min(sp.end, hi) - max(sp.start, lo)
    ranked = sorted(totals.items(), key=lambda kv: kv[1], reverse=True)
    return {
        "window_us": hi - lo,
        "busy_us": sum(e - s for s, e in busy),
        "top_ops": [[n, t] for n, t in ranked[:top]],
        "gaps": [[open_across(host, s, e) or "none", e - s] for s, e in idle[:gaps]],
    }


def trace_spans(prof) -> tuple[list[Span], list[Span]]:
    """``(device, host)`` spans of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

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


class Traced(NamedTuple):
    """What a per-layer metric reads: the traced stretch and the driver's counters."""

    device: list  # Span, every kernel, memcpy and memset
    host: list  # Span, every operator and record_function range, all threads
    window: tuple  # (lo, hi) microseconds
    turns: int  # the driver's turns inside the window
    counters: dict  # the driver's counters (shapes, per-event program stats)


def idle_percent(t: Traced) -> float | None:
    """The share of the traced window in which the card ran nothing, in percent."""
    if not t.device:
        return None
    lo, hi = t.window
    return 100.0 * (1.0 - busy_us(t.device, lo, hi) / (hi - lo))


MARK = "rio_bench.traced"


class Tracer:
    """Profile from :meth:`start` to :meth:`stop`; the card is synchronised at both ends."""

    def __init__(self) -> None:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        kw = {}
        try:
            from torch._C._profiler import _ExperimentalConfig

            # Host operators of every thread: the directory solves in a
            # worker thread (asyncio.to_thread).
            kw["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
        except (ImportError, TypeError):
            pass
        self._prof = torch.profiler.profile(activities=activities, **kw)
        self._mark = torch.profiler.record_function(MARK)
        self.device: list[Span] = []
        self.host: list[Span] = []
        self.window: tuple[float, float] | None = None

    def start(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__enter__()
        self._mark.__enter__()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.device, self.host = trace_spans(self._prof)
        marks = [h for h in self.host if h.name == MARK]
        if len(marks) != 1:
            raise RuntimeError(f"{len(marks)} window marks in the trace, want 1")
        self.window = (marks[0].start, marks[0].end)
