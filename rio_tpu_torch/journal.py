"""Control-plane flight recorder: a bounded, causal cluster event journal.

Wire traces and RED histograms make the *data plane* observable; this
module records the *control plane* — every placement / membership /
migration / replication / read-scale / reminder transition — into a
zero-dependency ring buffer so "why is actor X on node 3 and what happened
to it during the drain?" has an answer.

Design constraints (mirrors ``metrics.py``):

- **Never blocks the hot path.** ``record`` is a plain list write on the
  event loop thread: bump the per-node seq, stamp wall + mono clocks,
  overwrite the oldest slot when full and count it in ``dropped``. No
  locks, no allocation beyond the event itself, no I/O.
- **Causally mergeable.** Every event carries a per-node monotonic ``seq``
  (gap-free within a node) and the node id; ``merge_events`` orders rows
  from many nodes into one history by ``(wall_ts, node, seq)`` — per-node
  order is always preserved, cross-node order leans on the wall clock the
  same way the membership protocol does.
- **Linked to request traces.** ``record`` snapshots
  ``tracing.current_trace_id()``, so a migration driven by an admin
  request, or a promotion triggered inside a traced call, shares the
  trace id of the exported request spans — journal rows and RED
  exemplars join on it.
- **Wire-portable.** Events round-trip through positional rows (same
  tolerant-decode style as ``metrics.hist_to_row``): decoders accept
  shorter legacy rows and ignore extra trailing fields, so the journal
  wire format can grow by appending.

The journal is populated by the subsystems (service, placement daemon,
migration, replication, readscale, reminders) and drained over the wire by
``rio.Admin``'s ``DumpEvents`` message — see ``rio_tpu_torch/admin.py`` for the
cluster-wide ``explain`` merge and the operator CLI.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Iterable, Sequence

from .tracing import current_trace_id

# -- event kinds -------------------------------------------------------------
# Plain strings on the wire (not an enum): old readers can render kinds they
# don't know, and new kinds never need a wire-version bump.

MEMBER_UP = "member_up"  # membership liveness flip → active
MEMBER_DOWN = "member_down"  # membership liveness flip → inactive
MEMBER_CORDON = "member_cordon"  # node cordoned (drain start)

PLACE_ASSIGN = "place_assign"  # directory row written (activation seat)
PLACE_RELEASE = "place_release"  # directory row removed (panic/corrupt/teardown)
ADMIT_SHED = "admit_shed"  # new activation refused with SERVER_BUSY

MIGRATE_PIN = "migrate_pin"  # handoff phase 1: requests parked
MIGRATE_SNAPSHOT = "migrate_snapshot"  # phase 2: deactivated + state captured
MIGRATE_INSTALL = "migrate_install"  # phase 3: state seated on target
MIGRATE_FLIP = "migrate_flip"  # phase 4: directory flipped, fence armed
MIGRATE_ABORT = "migrate_abort"  # handoff failed, object restored locally
MIGRATE_BURST = "migrate_burst"  # batched (source, target) burst dispatched

REPLICA_PROMOTE = "replica_promote"  # standby promoted (epoch bumped)
REPLICA_DEPOSE = "replica_depose"  # deposed primary surrendered the key
REPLICA_RESHIP = "replica_reship"  # anti-entropy full state re-ship
REPLICA_SEAT = "replica_seat"  # standby seats (re)assigned
REPLICA_K = "replica_k"  # dynamic replica_k raised/lowered

READ_SHED = "read_shed"  # hot primary shed a read with standby seat hints
READ_PROXY = "read_proxy"  # stale standby proxied a read to the primary

REMINDER_SEAT = "reminder_seat"  # reminder shard lease claimed
REMINDER_RELEASE = "reminder_release"  # reminder shard lease released
REMINDER_HANDOFF = "reminder_handoff"  # drain handed shards to a peer

SOLVE = "solve"  # placement solve (full or delta) applied/discarded

HEALTH = "health"  # HealthWatch trend rule fired (degradation alarm)

STORAGE = "storage"  # rendezvous storage degraded / recovered (outage story)
FAULT = "fault"  # fault-injection schedule transition (scripted outage edges)

STREAM = "stream"  # durable-stream transition (publish/deliver/commit edges)
SAGA = "saga"  # saga step/compensation transition (workflow story)

SCALE = "scale"  # autoscale decision/actuation edge (resize story)

EVENT_KINDS: tuple[str, ...] = (
    MEMBER_UP,
    MEMBER_DOWN,
    MEMBER_CORDON,
    PLACE_ASSIGN,
    PLACE_RELEASE,
    ADMIT_SHED,
    MIGRATE_PIN,
    MIGRATE_SNAPSHOT,
    MIGRATE_INSTALL,
    MIGRATE_FLIP,
    MIGRATE_ABORT,
    MIGRATE_BURST,
    REPLICA_PROMOTE,
    REPLICA_DEPOSE,
    REPLICA_RESHIP,
    REPLICA_SEAT,
    REPLICA_K,
    READ_SHED,
    READ_PROXY,
    REMINDER_SEAT,
    REMINDER_RELEASE,
    REMINDER_HANDOFF,
    SOLVE,
    HEALTH,
    STORAGE,
    FAULT,
    STREAM,
    SAGA,
    SCALE,
)


@dataclass
class JournalEvent:
    """One control-plane transition; positional on the wire (``to_row``)."""

    seq: int  # per-node monotonic, gap-free
    wall_ts: float  # time.time() at record
    mono_ts: float  # time.monotonic() at record (same-node deltas)
    node: str  # recording node's address
    epoch: int  # subject epoch where meaningful (0 otherwise)
    kind: str  # one of EVENT_KINDS (or a future addition)
    key: str  # subject, usually "type/id" ("" for node-wide events)
    attrs: dict[str, Any] = field(default_factory=dict)
    trace_id: str | None = None  # active request trace at record time

    def to_row(self) -> list[Any]:
        return [
            self.seq,
            self.wall_ts,
            self.mono_ts,
            self.node,
            self.epoch,
            self.kind,
            self.key,
            self.attrs,
            self.trace_id,
        ]

    @classmethod
    def from_row(cls, row: Sequence[Any]) -> "JournalEvent":
        # Tolerant decode: short legacy rows get defaults, extra trailing
        # fields from a newer sender are ignored.
        r = list(row[:9]) + [None] * (9 - min(len(row), 9))
        attrs = r[7] if isinstance(r[7], dict) else {}
        return cls(
            seq=int(r[0] or 0),
            wall_ts=float(r[1] or 0.0),
            mono_ts=float(r[2] or 0.0),
            node=str(r[3] or ""),
            epoch=int(r[4] or 0),
            kind=str(r[5] or ""),
            key=str(r[6] or ""),
            attrs=attrs,
            trace_id=r[8] if isinstance(r[8], str) else None,
        )


def subject_key(type_name: str, object_id: str) -> str:
    """The canonical journal subject for an actor: ``type/id``."""
    return f"{type_name}/{object_id}"


class Journal:
    """Bounded ring of :class:`JournalEvent`, appended from the event loop.

    Single-writer by construction (all control-plane transitions happen on
    the server's loop), so there is no lock: ``record`` is a couple of
    attribute writes and one list store. When the ring is full the oldest
    event is overwritten and ``dropped`` incremented — recording NEVER
    blocks or fails.
    """

    def __init__(self, capacity: int = 4096, node: str = "") -> None:
        self.capacity = max(1, int(capacity))
        self.node = node
        self._ring: list[JournalEvent | None] = [None] * self.capacity
        self._head = 0  # next slot to write
        self._seq = 0  # last seq handed out (== total recorded)
        self.dropped = 0  # events overwritten before anyone read them

    # -- write side (hot-ish path: control transitions only) -----------------

    def record(
        self,
        kind: str,
        key: str = "",
        *,
        epoch: int = 0,
        **attrs: Any,
    ) -> JournalEvent:
        """Append one event; always succeeds, never blocks."""
        self._seq += 1
        ev = JournalEvent(
            seq=self._seq,
            wall_ts=time.time(),
            mono_ts=time.monotonic(),
            node=self.node,
            epoch=epoch,
            kind=kind,
            key=key,
            attrs=attrs,
            trace_id=current_trace_id(),
        )
        i = self._head
        if self._ring[i] is not None:
            self.dropped += 1
        self._ring[i] = ev
        self._head = (i + 1) % self.capacity
        return ev

    # -- read side -----------------------------------------------------------

    @property
    def recorded(self) -> int:
        """Total events ever recorded (== the last seq handed out)."""
        return self._seq

    def __len__(self) -> int:
        return min(self._seq, self.capacity)

    def events(
        self,
        *,
        kinds: Iterable[str] | None = None,
        key: str | None = None,
        since_seq: int = 0,
        limit: int | None = None,
    ) -> list[JournalEvent]:
        """Snapshot matching events, oldest → newest.

        ``kinds``/``key`` filter exactly; ``since_seq`` returns events with
        ``seq > since_seq`` (resumable tailing); ``limit`` keeps the NEWEST
        ``limit`` matches (a tail, not a head).
        """
        want = frozenset(kinds) if kinds else None
        out: list[JournalEvent] = []
        n = self.capacity
        for off in range(n):
            ev = self._ring[(self._head + off) % n]
            if ev is None or ev.seq <= since_seq:
                continue
            if want is not None and ev.kind not in want:
                continue
            if key is not None and ev.key != key:
                continue
            out.append(ev)
        if limit is not None and limit >= 0 and len(out) > limit:
            out = out[len(out) - limit :]
        return out

    def gauges(self) -> dict[str, float]:
        """Scrape-ready counters (picked up by ``otel.server_gauges``)."""
        return {
            "rio.journal.events": float(self._seq),
            "rio.journal.dropped": float(self.dropped),
            "rio.journal.ring_occupancy": float(len(self)),
            "rio.journal.ring_capacity": float(self.capacity),
        }


def merge_events(
    streams: Iterable[Iterable[JournalEvent]],
) -> list[JournalEvent]:
    """Merge per-node event streams into one causally ordered history.

    Within a node, ``seq`` is authoritative (monotonic, gap-free); across
    nodes the wall clock orders the merge — adequate for same-host tests
    and for operators reading a cluster with sane NTP. The sort key
    ``(wall_ts, node, seq)`` keeps per-node order stable under wall-clock
    ties (same node ⇒ seq decides; distinct nodes tie-break by name, which
    is arbitrary but deterministic).
    """
    merged = [ev for stream in streams for ev in stream]
    merged.sort(key=lambda e: (e.wall_ts, e.node, e.seq))
    return merged


def format_event(ev: JournalEvent) -> str:
    """One human line per event (CLI ``tail`` / ``explain`` rendering)."""
    ts = time.strftime("%H:%M:%S", time.localtime(ev.wall_ts))
    frac = f"{ev.wall_ts % 1:.3f}"[1:]
    attrs = " ".join(f"{k}={v!r}" for k, v in sorted(ev.attrs.items()))
    trace = f" trace={ev.trace_id}" if ev.trace_id else ""
    epoch = f" epoch={ev.epoch}" if ev.epoch else ""
    key = f" {ev.key}" if ev.key else ""
    return (
        f"{ts}{frac} {ev.node} #{ev.seq} {ev.kind}{key}{epoch}"
        f"{' ' + attrs if attrs else ''}{trace}"
    )
