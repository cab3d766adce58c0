"""Durable reminders: cluster-scheduled actor wakeups.

The reference (rio-rs) ships no timer/reminder subsystem — state saves are
manual and handler-driven, and nothing in the framework can *wake* an actor
(SURVEY §2, §5.4) — so every periodic workload (presence expiry, metric
flush windows, session timeouts, lease renewal) must be faked by clients
polling. This package supplies the Orleans-style answer:

* **volatile timers** live on :class:`~rio_tpu_torch.service_object.ServiceObject`
  (``register_timer``): fire through the normal dispatch queue while the
  actor is activated, cancelled at deactivation. Nothing here persists.
* **durable reminders** (this package) persist
  ``(object_kind, object_id, reminder_name, period, next_due)`` through a
  :class:`ReminderStorage` backend (sqlite/postgres/redis beside
  ``rio_tpu_torch/state/``) so they survive crash, drain, and re-placement.
* **cluster scheduling**: the reminder keyspace is hash-partitioned into
  ``num_shards`` shards (:func:`shard_of`). Shard→node ownership is seated
  through the existing ``ObjectPlacement`` trait — each shard is a
  directory row of type ``rio.ReminderShard``, so
  ``JaxObjectPlacement`` treats shards like any other object population
  (tick-rate flows into the affinity tracker as load signal) and the
  placement daemon reseats them on churn. A per-shard **lease with a
  monotone epoch** (stored beside the reminders) guarantees exactly one
  node ticks a shard at a time; delivery is at-least-once through the
  internal cluster client (see :mod:`rio_tpu_torch.reminders.daemon`).

The tick itself is an ordinary request — a ``rio.ReminderFired`` message
dispatched to the target object through the existing wire protocol — so no
new frame kind exists and the native codec is untouched.
"""

from __future__ import annotations

import abc
import dataclasses
import time
import zlib

__all__ = [
    "NUM_REMINDER_SHARDS",
    "Reminder",
    "Lease",
    "ReminderStorage",
    "LocalReminderStorage",
    "shard_of",
]

#: Default shard count. Sized so a handful of nodes each own a few shards
#: (spread) while the per-poll scan stays a handful of indexed queries.
NUM_REMINDER_SHARDS = 32


def shard_of(object_kind: str, object_id: str, num_shards: int) -> int:
    """Stable shard for one object's reminders.

    crc32 (like the placement solver's hashed identity features) so the
    partition survives process restarts and is identical on every node —
    the whole scheduling scheme depends on all nodes agreeing where a
    reminder lives without coordination.
    """
    return zlib.crc32(f"{object_kind}.{object_id}".encode()) % num_shards


@dataclasses.dataclass
class Reminder:
    """One durable reminder row.

    ``next_due`` is wall-clock epoch seconds (durable schedules must mean
    the same thing after a restart on a different host). ``shard`` is
    derived — storage backends stamp it from their own ``num_shards`` on
    write; callers never set it.
    """

    object_kind: str
    object_id: str
    reminder_name: str
    period: float
    next_due: float
    shard: int = 0


@dataclasses.dataclass
class Lease:
    """Per-shard tick ownership: ``owner`` may tick ``shard`` until
    ``expires_at``; ``epoch`` increments on every change of owner (the
    fencing token — a pre-takeover owner can prove staleness)."""

    shard: int
    owner: str
    epoch: int
    expires_at: float


class ReminderStorage(abc.ABC):
    """Durable reminder + lease store (the ``StateProvider`` of wakeups).

    Applications register a concrete backend in AppData under this trait::

        app_data.set(SqliteReminderStorage("r.db"), as_type=ReminderStorage)

    All backends share one contract:

    * reminders are keyed ``(object_kind, object_id, reminder_name)``;
      ``upsert`` overwrites (re-registering reschedules);
    * ``due(shard, now)`` returns rows with ``next_due <= now`` for ONE
      shard, soonest first — the daemon's scan unit;
    * leases: ``acquire_lease`` returns a :class:`Lease` when ``owner``
      holds the shard after the call (fresh acquisition and takeover of an
      expired lease bump ``epoch``; renewal keeps it), ``None`` when
      another owner's unexpired lease blocks it. ``release_lease`` expires
      the caller's own lease immediately (drain handoff) without touching
      a lease someone else won in the meantime.
    """

    num_shards: int = NUM_REMINDER_SHARDS

    async def prepare(self) -> None:
        return None

    def shard_for(self, object_kind: str, object_id: str) -> int:
        return shard_of(object_kind, object_id, self.num_shards)

    @abc.abstractmethod
    async def upsert(self, reminder: Reminder) -> None:
        """Insert or overwrite one reminder (shard stamped here)."""

    @abc.abstractmethod
    async def remove(self, object_kind: str, object_id: str, reminder_name: str) -> None: ...

    @abc.abstractmethod
    async def remove_object(self, object_kind: str, object_id: str) -> None:
        """Drop every reminder of one object (object deletion path)."""

    @abc.abstractmethod
    async def list_object(self, object_kind: str, object_id: str) -> list[Reminder]: ...

    @abc.abstractmethod
    async def due(self, shard: int, now: float, limit: int = 256) -> list[Reminder]:
        """Due rows of ``shard`` (``next_due <= now``), soonest first."""

    @abc.abstractmethod
    async def reschedule(
        self, object_kind: str, object_id: str, reminder_name: str, next_due: float
    ) -> None:
        """Advance one reminder's ``next_due`` (post-delivery)."""

    @abc.abstractmethod
    async def shard_counts(self) -> dict[int, int]:
        """Reminder count per non-empty shard (the daemon's tick-rate/cost
        signal for the placement solver)."""

    @abc.abstractmethod
    async def acquire_lease(
        self, shard: int, owner: str, ttl: float, now: float | None = None
    ) -> Lease | None: ...

    @abc.abstractmethod
    async def release_lease(self, shard: int, owner: str, epoch: int) -> None: ...

    @abc.abstractmethod
    async def get_lease(self, shard: int) -> Lease | None: ...


class LocalReminderStorage(ReminderStorage):
    """In-memory backend; instances shared across in-process servers alias
    the same data (like ``LocalStorage``/``LocalObjectPlacement``) — the
    multi-node-in-one-process integration harness relies on that."""

    def __init__(self, num_shards: int = NUM_REMINDER_SHARDS) -> None:
        self.num_shards = num_shards
        self._rows: dict[tuple[str, str, str], Reminder] = {}
        self._leases: dict[int, Lease] = {}

    async def upsert(self, reminder: Reminder) -> None:
        reminder.shard = self.shard_for(reminder.object_kind, reminder.object_id)
        self._rows[
            (reminder.object_kind, reminder.object_id, reminder.reminder_name)
        ] = dataclasses.replace(reminder)

    async def remove(self, object_kind: str, object_id: str, reminder_name: str) -> None:
        self._rows.pop((object_kind, object_id, reminder_name), None)

    async def remove_object(self, object_kind: str, object_id: str) -> None:
        for key in [k for k in self._rows if k[0] == object_kind and k[1] == object_id]:
            del self._rows[key]

    async def list_object(self, object_kind: str, object_id: str) -> list[Reminder]:
        return sorted(
            (
                dataclasses.replace(r)
                for (k, i, _), r in self._rows.items()
                if k == object_kind and i == object_id
            ),
            key=lambda r: r.reminder_name,
        )

    async def due(self, shard: int, now: float, limit: int = 256) -> list[Reminder]:
        rows = [
            dataclasses.replace(r)
            for r in self._rows.values()
            if r.shard == shard and r.next_due <= now
        ]
        rows.sort(key=lambda r: r.next_due)
        return rows[:limit]

    async def reschedule(
        self, object_kind: str, object_id: str, reminder_name: str, next_due: float
    ) -> None:
        row = self._rows.get((object_kind, object_id, reminder_name))
        if row is not None:
            row.next_due = next_due

    async def shard_counts(self) -> dict[int, int]:
        counts: dict[int, int] = {}
        for r in self._rows.values():
            counts[r.shard] = counts.get(r.shard, 0) + 1
        return counts

    async def acquire_lease(
        self, shard: int, owner: str, ttl: float, now: float | None = None
    ) -> Lease | None:
        now = time.time() if now is None else now
        cur = self._leases.get(shard)
        if cur is None:
            lease = Lease(shard, owner, 1, now + ttl)
        elif cur.owner == owner:
            # Renewal — even past expiry: the owner never changed, so the
            # fencing token must not move (matches the sqlite protocol).
            lease = dataclasses.replace(cur, expires_at=now + ttl)
        elif cur.expires_at <= now:
            lease = Lease(shard, owner, cur.epoch + 1, now + ttl)  # takeover
        else:
            return None
        self._leases[shard] = lease
        return dataclasses.replace(lease)

    async def release_lease(self, shard: int, owner: str, epoch: int) -> None:
        cur = self._leases.get(shard)
        if cur is not None and cur.owner == owner and cur.epoch == epoch:
            cur.expires_at = 0.0

    async def get_lease(self, shard: int) -> Lease | None:
        cur = self._leases.get(shard)
        return dataclasses.replace(cur) if cur is not None else None

    def count(self) -> int:
        return len(self._rows)
