"""Gauge time-series rings: the cluster's trend memory.

Every ``server_gauges`` scrape is a point-in-time snapshot; traces,
histograms and the journal answer "what happened", but nothing answers
"what is *trending*". The lesson of the TPU runs is that
the system degrades measurably before it fails (pull latency 349→747 ms
across "healthy" runs) — catching that requires history, not snapshots.
This module keeps that history per node: a bounded ring of periodic
gauge samples, wire-portable, merged cross-node by ``merge_series``.

Design constraints (mirrors ``journal.py``):

- **Never blocks the loop.** ``sample`` is a seq bump plus one list store
  on the event loop thread (the :class:`~rio_tpu_torch.load.LoadMonitor` tick
  drives it); oldest slot overwritten when full, counted in ``dropped``.
- **Bounded memory.** Ring capacity × one flat ``{name: float}`` dict per
  sample; the default (240 samples at a 1 s cadence) is four minutes of
  history per node.
- **Wire-portable with append-only growth.** Samples round-trip through
  positional rows; decoders accept shorter legacy rows and ignore extra
  trailing fields (same tolerant style as ``JournalEvent.from_row``).

The ring is drained over the wire by ``rio.Admin``'s ``DumpSeries``
message (see ``rio_tpu_torch/admin.py`` for the cluster scrape and the
``watch`` CLI); :class:`~rio_tpu_torch.health.HealthWatch` evaluates trend
rules over it locally. The trend helpers at the bottom (``series_values``,
``rising_streak``, ``falling_streak``, ``trend_arrow``) are shared by
both consumers.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Iterable, Sequence

__all__ = [
    "SeriesSample",
    "GaugeSeries",
    "merge_series",
    "series_values",
    "rising_streak",
    "falling_streak",
    "trend_arrow",
]


@dataclass
class SeriesSample:
    """One periodic gauge snapshot; positional on the wire (``to_row``)."""

    seq: int  # per-node monotonic, gap-free
    wall_ts: float  # time.time() at sample
    mono_ts: float  # time.monotonic() at sample (same-node deltas)
    node: str  # sampling node's address
    gauges: dict[str, float] = field(default_factory=dict)

    def to_row(self) -> list[Any]:
        return [self.seq, self.wall_ts, self.mono_ts, self.node, self.gauges]

    @classmethod
    def from_row(cls, row: Sequence[Any]) -> "SeriesSample":
        # Tolerant decode: short legacy rows get defaults, extra trailing
        # fields from a newer sender are ignored.
        r = list(row[:5]) + [None] * (5 - min(len(row), 5))
        gauges = r[4] if isinstance(r[4], dict) else {}
        return cls(
            seq=int(r[0] or 0),
            wall_ts=float(r[1] or 0.0),
            mono_ts=float(r[2] or 0.0),
            node=str(r[3] or ""),
            gauges={str(k): float(v) for k, v in gauges.items()},
        )


class GaugeSeries:
    """Bounded ring of :class:`SeriesSample`, written from the event loop.

    Single-writer by construction (the LoadMonitor tick samples on the
    server's loop), so there is no lock: ``sample`` is a couple of
    attribute writes and one list store. When the ring is full the oldest
    sample is overwritten and ``dropped`` incremented — sampling NEVER
    blocks or fails.
    """

    def __init__(
        self,
        capacity: int = 240,
        node: str = "",
        interval: float = 1.0,
    ) -> None:
        self.capacity = max(1, int(capacity))
        self.node = node
        self.interval = max(0.01, float(interval))
        self._ring: list[SeriesSample | None] = [None] * self.capacity
        self._head = 0  # next slot to write
        self._seq = 0  # last seq handed out (== total sampled)
        self.dropped = 0  # samples overwritten before anyone read them
        self._last_mono = 0.0  # rate-limits ticks faster than `interval`

    # -- write side (one dict copy per interval) -----------------------------

    def sample(self, gauges: dict[str, float]) -> SeriesSample:
        """Append one snapshot; always succeeds, never blocks."""
        self._seq += 1
        s = SeriesSample(
            seq=self._seq,
            wall_ts=time.time(),
            mono_ts=time.monotonic(),
            node=self.node,
            gauges=dict(gauges),
        )
        i = self._head
        if self._ring[i] is not None:
            self.dropped += 1
        self._ring[i] = s
        self._head = (i + 1) % self.capacity
        return s

    def tick(self, read_gauges) -> SeriesSample | None:
        """Rate-limited sample: call as often as you like (the LoadMonitor
        loop runs every monitor interval); reads ``read_gauges()`` and
        records only when ``interval`` has elapsed since the last sample."""
        now = time.monotonic()
        if now - self._last_mono < self.interval:
            return None
        self._last_mono = now
        return self.sample(read_gauges())

    # -- read side -----------------------------------------------------------

    @property
    def sampled(self) -> int:
        """Total samples ever taken (== the last seq handed out)."""
        return self._seq

    def __len__(self) -> int:
        return min(self._seq, self.capacity)

    def window(
        self,
        *,
        names: Iterable[str] | None = None,
        since_seq: int = 0,
        limit: int | None = None,
    ) -> list[SeriesSample]:
        """Snapshot matching samples, oldest → newest.

        ``names`` projects each sample's gauge dict down to the named
        gauges (prefix match when a name ends with ``.``); ``since_seq``
        returns samples with ``seq > since_seq`` (resumable tailing);
        ``limit`` keeps the NEWEST ``limit`` samples (a tail, not a head).
        """
        want = list(names) if names else None
        out: list[SeriesSample] = []
        n = self.capacity
        for off in range(n):
            s = self._ring[(self._head + off) % n]
            if s is None or s.seq <= since_seq:
                continue
            if want is not None:
                g = {
                    k: v
                    for k, v in s.gauges.items()
                    if any(
                        k == w or (w.endswith(".") and k.startswith(w))
                        for w in want
                    )
                }
                s = SeriesSample(
                    seq=s.seq,
                    wall_ts=s.wall_ts,
                    mono_ts=s.mono_ts,
                    node=s.node,
                    gauges=g,
                )
            out.append(s)
        if limit is not None and limit >= 0 and len(out) > limit:
            out = out[len(out) - limit :]
        return out

    def gauges(self) -> dict[str, float]:
        """Scrape-ready counters (picked up by ``otel.server_gauges``)."""
        return {
            "rio.series.samples": float(self._seq),
            "rio.series.dropped": float(self.dropped),
            "rio.series.ring_occupancy": float(len(self)),
            "rio.series.ring_capacity": float(self.capacity),
        }


def merge_series(
    streams: Iterable[Iterable[SeriesSample]],
) -> list[SeriesSample]:
    """Merge per-node sample streams into one wall-clock-aligned window.

    Same ordering contract as ``journal.merge_events``: within a node,
    ``seq`` is authoritative; across nodes the wall clock orders the merge
    with ``(wall_ts, node, seq)`` keeping per-node order stable under
    wall-clock ties.
    """
    merged = [s for stream in streams for s in stream]
    merged.sort(key=lambda s: (s.wall_ts, s.node, s.seq))
    return merged


# -- trend helpers (shared by HealthWatch and the watch CLI) ------------------


def series_values(
    samples: Sequence[SeriesSample], name: str
) -> list[float]:
    """The gauge's value in each sample that carries it, oldest → newest."""
    return [s.gauges[name] for s in samples if name in s.gauges]


def rising_streak(values: Sequence[float], min_delta: float = 0.0) -> int:
    """Length of the strictly-rising run ending at the newest value.

    ``min_delta`` sets the minimum per-step increase that counts as
    "rising" (trend rules use it to ignore jitter); a streak of K means
    the gauge rose K consecutive windows.
    """
    streak = 0
    for i in range(len(values) - 1, 0, -1):
        if values[i] - values[i - 1] > min_delta:
            streak += 1
        else:
            break
    return streak


def falling_streak(values: Sequence[float], min_delta: float = 0.0) -> int:
    """Length of the strictly-falling run ending at the newest value.

    Mirror of :func:`rising_streak` for scale-in style rules ("load has
    been dropping for K windows"): ``min_delta`` is the minimum per-step
    DECREASE that counts, so a flat or jittering gauge never reads as
    falling.
    """
    streak = 0
    for i in range(len(values) - 1, 0, -1):
        if values[i - 1] - values[i] > min_delta:
            streak += 1
        else:
            break
    return streak


def trend_arrow(values: Sequence[float], rel: float = 0.05) -> str:
    """``↑`` / ``↓`` / ``→`` comparing the newest value to the window mean.

    ``rel`` is the relative dead band (default ±5% of the mean reads as
    flat); fewer than two values reads as flat.
    """
    if len(values) < 2:
        return "→"
    mean = sum(values[:-1]) / (len(values) - 1)
    band = abs(mean) * rel
    last = values[-1]
    if last > mean + band:
        return "↑"
    if last < mean - band:
        return "↓"
    return "→"
