"""PostgreSQL stream storage.

Same table shape and portable SQL as
:class:`~rio_tpu_torch.streams.sqlite.SqliteStreamStorage`, so all query logic
is inherited; only the connection and migrations differ (the
``reminders/postgres.py`` pattern). Driver-gated through
``rio_tpu_torch/utils/pg.py`` — the default suite exercises it against
``tests/fake_pg.py``.
"""

from __future__ import annotations

from ..utils.pg import PgDb
from . import NUM_STREAM_PARTITIONS
from .sqlite import SqliteStreamStorage

MIGRATIONS = [
    """
    CREATE TABLE IF NOT EXISTS stream_records (
        stream       TEXT NOT NULL,
        part         INTEGER NOT NULL,
        offs         INTEGER NOT NULL,
        message_type TEXT NOT NULL,
        payload      BYTEA NOT NULL,
        mkey         TEXT NOT NULL,
        ts           DOUBLE PRECISION NOT NULL,
        PRIMARY KEY (stream, part, offs)
    )
    """,
    """
    CREATE TABLE IF NOT EXISTS stream_subs (
        stream            TEXT NOT NULL,
        grp               TEXT NOT NULL,
        target_type       TEXT NOT NULL,
        redelivery_period DOUBLE PRECISION NOT NULL,
        PRIMARY KEY (stream, grp)
    )
    """,
    """
    CREATE TABLE IF NOT EXISTS stream_cursors (
        stream    TEXT NOT NULL,
        grp       TEXT NOT NULL,
        part      INTEGER NOT NULL,
        committed INTEGER NOT NULL,
        PRIMARY KEY (stream, grp, part)
    )
    """,
]


class PostgresStreamStorage(SqliteStreamStorage):
    def __init__(self, dsn: str, num_partitions: int = NUM_STREAM_PARTITIONS) -> None:
        self.db = PgDb(dsn)
        self.num_partitions = num_partitions

    async def prepare(self) -> None:
        await self.db.migrate(MIGRATIONS)
