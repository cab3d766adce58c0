"""SQLite reminder storage.

Table shapes mirror ``rio_tpu_torch/state/sqlite.py``'s conventions; the SQL is
deliberately portable (``ON CONFLICT`` upserts, ``DOUBLE PRECISION``) so
:class:`~rio_tpu_torch.reminders.postgres.PostgresReminderStorage` inherits every
query verbatim and only swaps the connection.

Lease protocol: each ``acquire_lease`` is a short sequence of individually
atomic statements (insert-if-absent → takeover-if-expired → renew-if-mine →
read back); the final read is authoritative, so concurrent acquirers race
to a single winner regardless of interleaving. ``epoch`` only ever moves
through ``epoch+1`` inside the takeover statement — monotone per shard.
"""

from __future__ import annotations

from ..utils.sqlite import SqliteDb
from . import NUM_REMINDER_SHARDS, Lease, Reminder, ReminderStorage

MIGRATIONS = [
    """
    CREATE TABLE IF NOT EXISTS reminders (
        object_kind   TEXT NOT NULL,
        object_id     TEXT NOT NULL,
        reminder_name TEXT NOT NULL,
        period        DOUBLE PRECISION NOT NULL,
        next_due      DOUBLE PRECISION NOT NULL,
        shard         INTEGER NOT NULL,
        PRIMARY KEY (object_kind, object_id, reminder_name)
    );
    CREATE INDEX IF NOT EXISTS reminders_shard_due ON reminders (shard, next_due);
    CREATE TABLE IF NOT EXISTS reminder_leases (
        shard      INTEGER PRIMARY KEY,
        owner      TEXT NOT NULL,
        epoch      INTEGER NOT NULL,
        expires_at DOUBLE PRECISION NOT NULL
    );
    """
]

_COLS = "object_kind, object_id, reminder_name, period, next_due, shard"


class SqliteReminderStorage(ReminderStorage):
    def __init__(self, path: str, num_shards: int = NUM_REMINDER_SHARDS) -> None:
        self.db = SqliteDb(path)
        self.num_shards = num_shards

    async def prepare(self) -> None:
        await self.db.migrate(MIGRATIONS)

    async def upsert(self, reminder: Reminder) -> None:
        reminder.shard = self.shard_for(reminder.object_kind, reminder.object_id)
        await self.db.execute(
            f"INSERT INTO reminders ({_COLS}) VALUES (?,?,?,?,?,?) "
            "ON CONFLICT(object_kind, object_id, reminder_name) DO UPDATE SET "
            "period=excluded.period, next_due=excluded.next_due, shard=excluded.shard",
            reminder.object_kind, reminder.object_id, reminder.reminder_name,
            reminder.period, reminder.next_due, reminder.shard,
        )

    async def remove(self, object_kind: str, object_id: str, reminder_name: str) -> None:
        await self.db.execute(
            "DELETE FROM reminders WHERE object_kind=? AND object_id=? AND reminder_name=?",
            object_kind, object_id, reminder_name,
        )

    async def remove_object(self, object_kind: str, object_id: str) -> None:
        await self.db.execute(
            "DELETE FROM reminders WHERE object_kind=? AND object_id=?",
            object_kind, object_id,
        )

    async def list_object(self, object_kind: str, object_id: str) -> list[Reminder]:
        rows = await self.db.execute(
            f"SELECT {_COLS} FROM reminders WHERE object_kind=? AND object_id=? "
            "ORDER BY reminder_name",
            object_kind, object_id,
        )
        return [Reminder(*row) for row in rows]

    async def due(self, shard: int, now: float, limit: int = 256) -> list[Reminder]:
        rows = await self.db.execute(
            f"SELECT {_COLS} FROM reminders WHERE shard=? AND next_due<=? "
            "ORDER BY next_due LIMIT ?",
            shard, now, limit,
        )
        return [Reminder(*row) for row in rows]

    async def reschedule(
        self, object_kind: str, object_id: str, reminder_name: str, next_due: float
    ) -> None:
        await self.db.execute(
            "UPDATE reminders SET next_due=? "
            "WHERE object_kind=? AND object_id=? AND reminder_name=?",
            next_due, object_kind, object_id, reminder_name,
        )

    async def shard_counts(self) -> dict[int, int]:
        rows = await self.db.execute(
            "SELECT shard, COUNT(*) FROM reminders GROUP BY shard"
        )
        return {int(s): int(c) for s, c in rows}

    # -- leases -------------------------------------------------------------

    async def acquire_lease(
        self, shard: int, owner: str, ttl: float, now: float | None = None
    ) -> Lease | None:
        import time

        now = time.time() if now is None else now
        # 1. Seat an initial lease if the shard has never been leased.
        await self.db.execute(
            "INSERT INTO reminder_leases (shard, owner, epoch, expires_at) "
            "VALUES (?,?,1,?) ON CONFLICT(shard) DO NOTHING",
            shard, owner, now + ttl,
        )
        # 2. Take over an expired lease (epoch bump = fencing token).
        await self.db.execute(
            "UPDATE reminder_leases SET owner=?, epoch=epoch+1, expires_at=? "
            "WHERE shard=? AND owner<>? AND expires_at<=?",
            owner, now + ttl, shard, owner, now,
        )
        # 3. Renew a lease we already hold.
        await self.db.execute(
            "UPDATE reminder_leases SET expires_at=? WHERE shard=? AND owner=?",
            now + ttl, shard, owner,
        )
        # 4. The read decides: whoever the row names after the dust settles
        #    holds the shard.
        lease = await self.get_lease(shard)
        if lease is not None and lease.owner == owner and lease.expires_at > now:
            return lease
        return None

    async def release_lease(self, shard: int, owner: str, epoch: int) -> None:
        await self.db.execute(
            "UPDATE reminder_leases SET expires_at=0 "
            "WHERE shard=? AND owner=? AND epoch=?",
            shard, owner, epoch,
        )

    async def get_lease(self, shard: int) -> Lease | None:
        rows = await self.db.execute(
            "SELECT owner, epoch, expires_at FROM reminder_leases WHERE shard=?",
            shard,
        )
        if not rows:
            return None
        o, e, exp = rows[0]
        return Lease(shard, o, int(e), float(exp))

    def close(self) -> None:
        self.db.close()
