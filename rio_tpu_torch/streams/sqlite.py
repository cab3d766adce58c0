"""SQLite stream storage.

Same portable-SQL discipline as ``rio_tpu_torch/reminders/sqlite.py``: every
query runs verbatim on Postgres, so
:class:`~rio_tpu_torch.streams.postgres.PostgresStreamStorage` only swaps the
connection. Reserved words are dodged in the schema (``offs``/``part``/
``grp``/``mkey`` — OFFSET and GROUP are keywords in both dialects).

Offset assignment is a single ``INSERT … SELECT COALESCE(MAX(offs)+1, 0)``
(atomic per statement in both engines), read back by ``MAX(offs)``. Two
producers racing one partition across processes may read back each
other's offset — harmless under the acked-offset contract (the ack still
names a durable offset >= the caller's own append).
"""

from __future__ import annotations

from ..utils.sqlite import SqliteDb
from . import NUM_STREAM_PARTITIONS, StreamRecord, StreamStorage, Subscription

MIGRATIONS = [
    """
    CREATE TABLE IF NOT EXISTS stream_records (
        stream       TEXT NOT NULL,
        part         INTEGER NOT NULL,
        offs         INTEGER NOT NULL,
        message_type TEXT NOT NULL,
        payload      BLOB NOT NULL,
        mkey         TEXT NOT NULL,
        ts           DOUBLE PRECISION NOT NULL,
        PRIMARY KEY (stream, part, offs)
    );
    CREATE TABLE IF NOT EXISTS stream_subs (
        stream            TEXT NOT NULL,
        grp               TEXT NOT NULL,
        target_type       TEXT NOT NULL,
        redelivery_period DOUBLE PRECISION NOT NULL,
        PRIMARY KEY (stream, grp)
    );
    CREATE TABLE IF NOT EXISTS stream_cursors (
        stream    TEXT NOT NULL,
        grp       TEXT NOT NULL,
        part      INTEGER NOT NULL,
        committed INTEGER NOT NULL,
        PRIMARY KEY (stream, grp, part)
    );
    """
]

_RCOLS = "stream, part, offs, message_type, payload, mkey, ts"


class SqliteStreamStorage(StreamStorage):
    def __init__(self, path: str, num_partitions: int = NUM_STREAM_PARTITIONS) -> None:
        self.db = SqliteDb(path)
        self.num_partitions = num_partitions

    async def prepare(self) -> None:
        await self.db.migrate(MIGRATIONS)

    async def append(self, record: StreamRecord) -> int:
        r = record
        await self.db.execute(
            f"INSERT INTO stream_records ({_RCOLS}) "
            "SELECT ?, ?, COALESCE(MAX(offs)+1, 0), ?, ?, ?, ? "
            "FROM stream_records WHERE stream=? AND part=?",
            r.stream, r.partition, r.message_type, r.payload, r.key, r.ts,
            r.stream, r.partition,
        )
        rows = await self.db.execute(
            "SELECT MAX(offs) FROM stream_records WHERE stream=? AND part=?",
            r.stream, r.partition,
        )
        r.offset = int(rows[0][0])
        return r.offset

    async def read(
        self, stream: str, partition: int, from_offset: int, limit: int = 256
    ) -> list[StreamRecord]:
        rows = await self.db.execute(
            f"SELECT {_RCOLS} FROM stream_records "
            "WHERE stream=? AND part=? AND offs>=? ORDER BY offs LIMIT ?",
            stream, partition, from_offset, limit,
        )
        return [
            StreamRecord(s, int(p), int(o), mt, bytes(pl), k, float(ts))
            for s, p, o, mt, pl, k, ts in rows
        ]

    async def latest(self, stream: str, partition: int) -> int:
        rows = await self.db.execute(
            "SELECT COALESCE(MAX(offs)+1, 0) FROM stream_records "
            "WHERE stream=? AND part=?",
            stream, partition,
        )
        return int(rows[0][0])

    async def subscribe(self, sub: Subscription) -> None:
        await self.db.execute(
            "INSERT INTO stream_subs (stream, grp, target_type, redelivery_period) "
            "VALUES (?,?,?,?) ON CONFLICT(stream, grp) DO UPDATE SET "
            "target_type=excluded.target_type, "
            "redelivery_period=excluded.redelivery_period",
            sub.stream, sub.group, sub.target_type, sub.redelivery_period,
        )

    async def unsubscribe(self, stream: str, group: str) -> None:
        await self.db.execute(
            "DELETE FROM stream_subs WHERE stream=? AND grp=?", stream, group
        )

    async def subscriptions(self, stream: str) -> list[Subscription]:
        rows = await self.db.execute(
            "SELECT stream, grp, target_type, redelivery_period "
            "FROM stream_subs WHERE stream=? ORDER BY grp",
            stream,
        )
        return [Subscription(s, g, t, float(rp)) for s, g, t, rp in rows]

    async def commit(
        self, stream: str, group: str, partition: int, offset: int
    ) -> None:
        # Monotone through the conditional DO UPDATE (portable — two-arg
        # MAX() is sqlite-only, GREATEST() postgres-only).
        await self.db.execute(
            "INSERT INTO stream_cursors (stream, grp, part, committed) "
            "VALUES (?,?,?,?) ON CONFLICT(stream, grp, part) DO UPDATE SET "
            "committed=excluded.committed "
            "WHERE excluded.committed > stream_cursors.committed",
            stream, group, partition, offset,
        )

    async def committed(self, stream: str, group: str, partition: int) -> int:
        rows = await self.db.execute(
            "SELECT committed FROM stream_cursors WHERE stream=? AND grp=? AND part=?",
            stream, group, partition,
        )
        return int(rows[0][0]) if rows else 0

    async def cursors(self, stream: str, group: str) -> dict[int, int]:
        rows = await self.db.execute(
            "SELECT part, committed FROM stream_cursors WHERE stream=? AND grp=?",
            stream, group,
        )
        return {int(p): int(c) for p, c in rows}

    def close(self) -> None:
        self.db.close()
