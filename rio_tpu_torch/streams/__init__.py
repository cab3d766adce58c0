"""Durable, partitioned streams layered on the actor machinery.

The reference (rio-rs) stops at the transient ``MessageRouter`` pub/sub:
a subscriber that is offline (or lagging) loses items, and nothing about
a publish is durable (SURVEY §5.2). This package supplies the
Orleans-streams-shaped answer, built ON the existing subsystems rather
than beside them:

* **append logs** live behind :class:`StreamStorage` (local/sqlite +
  fakes-backed postgres/redis — the ``ReminderStorage`` backend pattern).
  A publish is acked with its ``(partition, offset)`` only after the
  append is durable; the transient router fan-out is the live tail, not
  the source of truth.
* **consumer cursors** are ordinary placement-seated actors
  (:class:`~rio_tpu_torch.streams.cursor.StreamCursor`): they migrate,
  replicate, and reseat on node death like everything else, and their
  committed offset is just storage state.
* **redelivery** rides the reminder subsystem: each cursor keeps a
  durable reminder armed while it has a subscription, so a cursor whose
  node was SIGKILLed is re-activated by the reminder daemon and resumes
  from its last committed offset — at-least-once, with the existing
  missed-tick catch-up.
* **sagas** (:mod:`rio_tpu_torch.streams.saga`) compose multi-actor operations
  as typed step/compensation chains whose progress is persisted through
  ``StateProvider`` before every send, so a coordinator killed mid-saga
  resumes or compensates deterministically.

Offsets are 0-based and dense per ``(stream, partition)``; a committed
cursor value is the NEXT offset to read (records below it are done).
"""

from __future__ import annotations

import abc
import dataclasses
import zlib

from ..registry import MESSAGE_TYPES, message

__all__ = [
    "NUM_STREAM_PARTITIONS",
    "StreamRecord",
    "Subscription",
    "StreamStorage",
    "LocalStreamStorage",
    "StreamDelivery",
    "StreamWake",
    "SagaStep",
    "partition_for",
]

#: Default partition count per stream. Small enough that one consumer
#: group's cursors stay a handful of directory rows; large enough that the
#: placement solver can spread a hot stream's delivery work across nodes.
NUM_STREAM_PARTITIONS = 8


def partition_for(stream: str, key: str, num_partitions: int) -> int:
    """Stable partition for one publish.

    crc32 like :func:`rio_tpu_torch.reminders.shard_of`: every node must agree
    where a key lives without coordination. A keyless publish hashes the
    stream name alone — all unkeyed traffic shares one partition, which
    preserves publish order for it.
    """
    return zlib.crc32(f"{stream}\x1f{key}".encode()) % num_partitions


@dataclasses.dataclass
class StreamRecord:
    """One appended stream item.

    ``payload`` is the codec-serialized application message (its wire
    type name in ``message_type``) — the log stores bytes, not objects,
    so replay works in processes that never imported the message class.
    ``offset`` is stamped by the backend on append; callers never set it.
    """

    stream: str
    partition: int
    offset: int
    message_type: str
    payload: bytes
    key: str = ""
    ts: float = 0.0


@dataclasses.dataclass
class Subscription:
    """One consumer group on one stream: deliveries go to actors of
    ``target_type`` (keyed by record key). ``redelivery_period`` is the
    group's reminder-backstop cadence in seconds."""

    stream: str
    group: str
    target_type: str
    redelivery_period: float = 2.0


@message(name="rio.StreamDelivery")
class StreamDelivery:
    """One record, delivered to a consumer actor by a group's cursor.

    Rides the ordinary request path (like ``rio.ReminderFired``) — the
    blanket handler on :class:`~rio_tpu_torch.service_object.ServiceObject`
    forwards to ``receive_stream``. ``attempt`` > 1 marks a redelivery
    (the consumer's dedup signal under at-least-once).
    """

    stream: str = ""
    group: str = ""
    partition: int = 0
    offset: int = 0
    message_type: str = ""
    payload: bytes = b""
    key: str = ""
    attempt: int = 1

    def decode(self, ty: type | None = None):
        """The application message this delivery carries."""
        from .. import codec

        if ty is None:
            ty = MESSAGE_TYPES.get(self.message_type)
            if ty is None:
                raise KeyError(f"unregistered message type {self.message_type!r}")
        return codec.deserialize(self.payload, ty)


@message(name="rio.StreamWake")
class StreamWake:
    """Publisher → cursor nudge: new records exist past your committed
    offset. Fire-and-forget — loss is fine, the redelivery reminder is
    the durable backstop."""

    stream: str = ""
    group: str = ""
    partition: int = 0


@message(name="rio.SagaStep")
class SagaStep:
    """One saga action/compensation, sent by the coordinator to a
    participant. The blanket handler dedups on ``(saga_id, step, kind)``
    through a persisted ledger before dispatching the carried message to
    the participant's own handler — so coordinator retries (resume after
    a crash re-sends the in-flight step) apply effects exactly once.
    """

    saga_id: str = ""
    step: int = 0
    kind: str = "action"  # "action" | "compensate"
    message_type: str = ""
    payload: bytes = b""


class StreamStorage(abc.ABC):
    """Durable append log + subscriptions + group cursors.

    Applications register a concrete backend in AppData under this trait::

        app_data.set(SqliteStreamStorage("s.db"), as_type=StreamStorage)

    Contract shared by all backends:

    * ``append`` stamps a dense 0-based ``offset`` per
      ``(stream, partition)`` and is the durability point — the publish
      ack carries its return value;
    * ``read`` returns records with ``offset >= from_offset`` in offset
      order (the cursor's scan unit);
    * ``commit`` is monotone: a stale commit (smaller offset) never moves
      a cursor backwards — redelivery retries may land out of order;
    * ``committed`` defaults to 0 for a never-committed cursor.
    """

    num_partitions: int = NUM_STREAM_PARTITIONS

    async def prepare(self) -> None:
        return None

    def partition_of(self, stream: str, key: str) -> int:
        return partition_for(stream, key, self.num_partitions)

    @abc.abstractmethod
    async def append(self, record: StreamRecord) -> int:
        """Durably append one record; stamps and returns its offset."""

    @abc.abstractmethod
    async def read(
        self, stream: str, partition: int, from_offset: int, limit: int = 256
    ) -> list[StreamRecord]: ...

    @abc.abstractmethod
    async def latest(self, stream: str, partition: int) -> int:
        """The next offset ``append`` would assign (== record count)."""

    @abc.abstractmethod
    async def subscribe(self, sub: Subscription) -> None:
        """Insert or overwrite one group subscription."""

    @abc.abstractmethod
    async def unsubscribe(self, stream: str, group: str) -> None: ...

    @abc.abstractmethod
    async def subscriptions(self, stream: str) -> list[Subscription]:
        """All groups subscribed to ``stream``, ordered by group name."""

    @abc.abstractmethod
    async def commit(
        self, stream: str, group: str, partition: int, offset: int
    ) -> None:
        """Advance a group cursor to ``offset`` (next-to-read; monotone)."""

    @abc.abstractmethod
    async def committed(self, stream: str, group: str, partition: int) -> int: ...

    @abc.abstractmethod
    async def cursors(self, stream: str, group: str) -> dict[int, int]:
        """Committed offset per partition with a cursor row (lag probe)."""


class LocalStreamStorage(StreamStorage):
    """In-memory backend; instances shared across in-process servers alias
    the same data (like ``LocalReminderStorage``) — the multi-node-in-one-
    process harness relies on that."""

    def __init__(self, num_partitions: int = NUM_STREAM_PARTITIONS) -> None:
        self.num_partitions = num_partitions
        self._logs: dict[tuple[str, int], list[StreamRecord]] = {}
        self._subs: dict[tuple[str, str], Subscription] = {}
        self._cursors: dict[tuple[str, str, int], int] = {}

    async def append(self, record: StreamRecord) -> int:
        log = self._logs.setdefault((record.stream, record.partition), [])
        record.offset = len(log)
        log.append(dataclasses.replace(record))
        return record.offset

    async def read(
        self, stream: str, partition: int, from_offset: int, limit: int = 256
    ) -> list[StreamRecord]:
        log = self._logs.get((stream, partition), [])
        return [
            dataclasses.replace(r)
            for r in log[max(0, from_offset) : max(0, from_offset) + limit]
        ]

    async def latest(self, stream: str, partition: int) -> int:
        return len(self._logs.get((stream, partition), []))

    async def subscribe(self, sub: Subscription) -> None:
        self._subs[(sub.stream, sub.group)] = dataclasses.replace(sub)

    async def unsubscribe(self, stream: str, group: str) -> None:
        self._subs.pop((stream, group), None)

    async def subscriptions(self, stream: str) -> list[Subscription]:
        return sorted(
            (dataclasses.replace(s) for (st, _), s in self._subs.items() if st == stream),
            key=lambda s: s.group,
        )

    async def commit(
        self, stream: str, group: str, partition: int, offset: int
    ) -> None:
        key = (stream, group, partition)
        if offset > self._cursors.get(key, 0):
            self._cursors[key] = offset

    async def committed(self, stream: str, group: str, partition: int) -> int:
        return self._cursors.get((stream, group, partition), 0)

    async def cursors(self, stream: str, group: str) -> dict[int, int]:
        return {
            p: off
            for (st, g, p), off in self._cursors.items()
            if st == stream and g == group
        }

    def count(self) -> int:
        return sum(len(v) for v in self._logs.values())
