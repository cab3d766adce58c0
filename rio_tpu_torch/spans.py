"""Request waterfalls: per-node span retention + phase-level attribution.

Trace context rides the wire and the journal records the control plane;
this module builds the missing half of the tracing stack — a place where
completed request spans *go*. Three pieces:

* :class:`SpanRing` — a journal-style bounded ring (single-writer on the
  loop, overwrite-oldest with ``dropped`` accounting) retaining completed
  :class:`SpanRecord` hops keyed by trace_id. **Tail-based capture**: a
  request whose total wall time crosses the ring's ``slo_ms`` is retained
  even when the head-unsampled traffic around it is not — the slow outlier
  survives with a fresh trace id and a ``tail=1`` attr.
* :class:`Phases` — the per-request phase clock the transports carry
  beside a decoded :class:`~rio_tpu_torch.protocol.RequestEnvelope`:
  ``perf_counter`` stamps at frame receive, decode, dispatch-queue exit,
  handler start/end, response encode, and flush. Attached only when the
  request is traced or a 1-in-8 stride fires (the same stride the RED
  histograms use), so the untraced hot path pays one integer mask per
  request and nothing else.
* :func:`finish_request` — turns a completed :class:`Phases` into the
  retention decision and (maybe) a ring record; :func:`merge_spans`
  orders records from many nodes into one causal story the same way
  ``journal.merge_events`` does.

The ring is deliberately **not** a :func:`rio_tpu_torch.tracing.add_sink` sink:
registering one flips the tracing layer's global enable and would drag
every request onto the full span ceremony, defeating the null fast path
cluster-wide. The transports feed it explicitly instead.

Client-side hops live in a process-local ring (:func:`arm_client_ring`)
so ``admin trace`` can merge the *calling* process's send/await phases —
including redirect follows — into the same waterfall the servers retain.

Wire access is ``rio.Admin``'s ``DumpSpans`` → ``SpansSnapshot``
(``rio_tpu_torch/admin.py``), merged cluster-wide by ``scrape_spans`` and
rendered by ``python -m rio_tpu_torch.admin trace <trace_id>``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Iterable, Sequence

from . import tracing

__all__ = [
    "SpanRecord",
    "SpanRing",
    "Phases",
    "finish_request",
    "merge_spans",
    "arm_client_ring",
    "disarm_client_ring",
    "client_ring",
    "PHASE_KEYS",
]

# Phase attr keys, waterfall display order (microseconds, integer).
PHASE_KEYS: tuple[str, ...] = (
    "recv_us",
    "decode_us",
    "queue_us",
    "handler_us",
    "encode_us",
    "flush_us",
)


@dataclass
class SpanRecord:
    """One retained hop of a request; positional on the wire (``to_row``)."""

    seq: int  # per-ring monotonic, gap-free
    trace_id: str
    span_id: str
    parent_id: str  # "" for a root hop
    name: str  # "request" (server hop) / "client_request" (client root)
    node: str  # recording node's address ("" for the client ring)
    wall_start: float  # time.time() at phase start (cross-node ordering)
    duration_us: int  # total recv→flush (or send→await) microseconds
    attrs: dict[str, Any] = field(default_factory=dict)

    def to_row(self) -> list[Any]:
        return [
            self.seq,
            self.trace_id,
            self.span_id,
            self.parent_id,
            self.name,
            self.node,
            self.wall_start,
            self.duration_us,
            self.attrs,
        ]

    @classmethod
    def from_row(cls, row: Sequence[Any]) -> "SpanRecord":
        # Tolerant decode: short legacy rows get defaults, extra trailing
        # fields from a newer sender are ignored (append-only wire growth).
        r = list(row[:9]) + [None] * (9 - min(len(row), 9))
        attrs = r[8] if isinstance(r[8], dict) else {}
        return cls(
            seq=int(r[0] or 0),
            trace_id=str(r[1] or ""),
            span_id=str(r[2] or ""),
            parent_id=str(r[3] or ""),
            name=str(r[4] or ""),
            node=str(r[5] or ""),
            wall_start=float(r[6] or 0.0),
            duration_us=int(r[7] or 0),
            attrs=attrs,
        )


class SpanRing:
    """Bounded ring of :class:`SpanRecord`, appended from the event loop.

    Single-writer by construction (both transports record from the
    server's loop thread), so there is no lock: ``record`` is a couple of
    attribute writes and one list store. When the ring is full the oldest
    record is overwritten and ``dropped`` incremented — recording NEVER
    blocks or fails. ``slo_ms`` arms tail-based capture: untraced requests
    slower than it are retained anyway (``tail_captured`` counts them).
    """

    def __init__(
        self, capacity: int = 2048, node: str = "", slo_ms: float = 250.0
    ) -> None:
        self.capacity = max(1, int(capacity))
        self.node = node
        self.slo_ms = float(slo_ms)
        self._ring: list[SpanRecord | None] = [None] * self.capacity
        self._head = 0  # next slot to write
        self._seq = 0  # last seq handed out (== total retained)
        self.dropped = 0  # records overwritten before anyone read them
        self.tail_captured = 0  # untraced-but-over-SLO requests retained

    # -- write side (called from the transports, loop thread only) -----------

    def record(
        self,
        *,
        trace_id: str,
        span_id: str,
        parent_id: str,
        name: str,
        wall_start: float,
        duration_us: int,
        attrs: dict[str, Any],
    ) -> SpanRecord:
        """Append one completed hop; always succeeds, never blocks."""
        self._seq += 1
        rec = SpanRecord(
            seq=self._seq,
            trace_id=trace_id,
            span_id=span_id,
            parent_id=parent_id,
            name=name,
            node=self.node,
            wall_start=wall_start,
            duration_us=duration_us,
            attrs=attrs,
        )
        i = self._head
        if self._ring[i] is not None:
            self.dropped += 1
        self._ring[i] = rec
        self._head = (i + 1) % self.capacity
        return rec

    # -- read side -----------------------------------------------------------

    @property
    def retained(self) -> int:
        """Total records ever retained (== the last seq handed out)."""
        return self._seq

    def __len__(self) -> int:
        return min(self._seq, self.capacity)

    def spans(
        self,
        *,
        trace_id: str | None = None,
        since_seq: int = 0,
        limit: int | None = None,
    ) -> list[SpanRecord]:
        """Snapshot matching records, oldest → newest.

        ``trace_id`` filters exactly; ``since_seq`` returns records with
        ``seq > since_seq`` (resumable tailing); ``limit`` keeps the
        NEWEST ``limit`` matches (a tail, not a head).
        """
        out: list[SpanRecord] = []
        n = self.capacity
        for off in range(n):
            rec = self._ring[(self._head + off) % n]
            if rec is None or rec.seq <= since_seq:
                continue
            if trace_id is not None and rec.trace_id != trace_id:
                continue
            out.append(rec)
        if limit is not None and limit >= 0 and len(out) > limit:
            out = out[len(out) - limit :]
        return out

    def gauges(self) -> dict[str, float]:
        """Scrape-ready counters (picked up by ``otel.server_gauges``)."""
        return {
            "rio.spans.retained": float(self._seq),
            "rio.spans.dropped": float(self.dropped),
            "rio.spans.tail_captured": float(self.tail_captured),
            "rio.spans.ring_occupancy": float(len(self)),
            "rio.spans.ring_capacity": float(self.capacity),
        }


class Phases:
    """Per-request phase clock carried beside a decoded envelope.

    ``perf_counter`` stamps, filled in by the owning transport as the
    request moves through its pipeline. ``__slots__`` keeps the sampled
    path to one small allocation; the object is attached to the envelope
    (``env._phases``) so neither the service call signature nor the wire
    changes.
    """

    __slots__ = (
        "recv",
        "decode",
        "queue",
        "handler_start",
        "handler_end",
        "encode",
        "flush",
        "trace_id",
        "parent_id",
        "attrs",
    )

    def __init__(self, recv: float, trace_ctx: tuple | None = None) -> None:
        self.recv = recv
        self.decode = recv
        self.queue = recv
        self.handler_start = recv
        self.handler_end = recv
        self.encode = recv
        self.flush = recv
        if trace_ctx is not None:
            self.trace_id = trace_ctx[0]
            self.parent_id = trace_ctx[1]
        else:
            self.trace_id = ""
            self.parent_id = ""
        self.attrs: dict[str, Any] | None = None


def finish_request(
    ring: SpanRing,
    ph: Phases,
    env: Any,
    *,
    name: str = "request",
) -> SpanRecord | None:
    """Retention decision + record for one completed request.

    Traced requests (wire ``trace_ctx`` present) are always retained —
    the caller decided. Untraced requests are retained only when their
    total recv→flush time crosses the ring's SLO (tail capture): they get
    a fresh trace id and a ``tail=1`` attr so the outlier is queryable
    even though nothing upstream sampled it.
    """
    total_us = int((ph.flush - ph.recv) * 1e6)
    traced = bool(ph.trace_id)
    if not traced:
        if ring.slo_ms <= 0.0 or total_us < ring.slo_ms * 1000.0:
            return None
        ph.trace_id = tracing.new_trace_id()
        ring.tail_captured += 1
    attrs: dict[str, Any] = {
        "handler": f"{env.handler_type}/{env.handler_id}",
        "msg": env.message_type,
        "recv_us": 0,
        "decode_us": int((ph.decode - ph.recv) * 1e6),
        "queue_us": int((ph.queue - ph.decode) * 1e6),
        "handler_us": int((ph.handler_end - ph.handler_start) * 1e6),
        "encode_us": int((ph.encode - ph.handler_end) * 1e6),
        "flush_us": int((ph.flush - ph.encode) * 1e6),
    }
    if not traced:
        attrs["tail"] = 1
    if ph.attrs:
        attrs.update(ph.attrs)
    return ring.record(
        trace_id=ph.trace_id,
        span_id=tracing.new_span_id(),
        parent_id=ph.parent_id,
        name=name,
        wall_start=time.time() - (ph.flush - ph.recv),
        duration_us=total_us,
        attrs=attrs,
    )


def merge_spans(streams: Iterable[Iterable[SpanRecord]]) -> list[SpanRecord]:
    """Merge per-node span streams into one causally ordered list.

    Same discipline as ``journal.merge_events``: within a node ``seq`` is
    authoritative; across nodes the wall clock orders the merge, with
    ``(wall_start, node, seq)`` keeping per-node order stable under ties.
    """
    merged = [rec for stream in streams for rec in stream]
    merged.sort(key=lambda r: (r.wall_start, r.node, r.seq))
    return merged


# ---------------------------------------------------------------------------
# Process-local client ring — the calling side of the waterfall.
# ---------------------------------------------------------------------------

_CLIENT_RING: SpanRing | None = None


def arm_client_ring(
    capacity: int = 1024, *, slo_ms: float = 0.0
) -> SpanRing:
    """Arm span retention for THIS process's outbound client requests.

    Disabled by default (``client_ring()`` is ``None`` → the client path
    pays one global read per request). The armed ring records one
    ``client_request`` root hop per traced/tail request — send, await and
    redirect-follow phases — which ``admin trace`` merges with the
    server-side scrape so the waterfall starts at the caller.
    """
    global _CLIENT_RING
    _CLIENT_RING = SpanRing(capacity, node="", slo_ms=slo_ms)
    return _CLIENT_RING


def disarm_client_ring() -> None:
    global _CLIENT_RING
    _CLIENT_RING = None


def client_ring() -> SpanRing | None:
    return _CLIENT_RING
