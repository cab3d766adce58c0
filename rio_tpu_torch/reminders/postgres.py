"""PostgreSQL reminder storage.

Same table shape and portable SQL as
:class:`~rio_tpu_torch.reminders.sqlite.SqliteReminderStorage`, so all query
logic is inherited; only the connection and migrations differ (the pattern
``rio_tpu_torch/state/postgres.py`` set). Driver-gated through
``rio_tpu_torch/utils/pg.py`` — the default suite exercises it against
``tests/fake_pg.py``.
"""

from __future__ import annotations

from ..utils.pg import PgDb
from . import NUM_REMINDER_SHARDS
from .sqlite import SqliteReminderStorage

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
    )
    """,
    "CREATE INDEX IF NOT EXISTS reminders_shard_due ON reminders (shard, next_due)",
    """
    CREATE TABLE IF NOT EXISTS reminder_leases (
        shard      INTEGER PRIMARY KEY,
        owner      TEXT NOT NULL,
        epoch      INTEGER NOT NULL,
        expires_at DOUBLE PRECISION NOT NULL
    )
    """,
]


class PostgresReminderStorage(SqliteReminderStorage):
    def __init__(self, dsn: str, num_shards: int = NUM_REMINDER_SHARDS) -> None:
        self.db = PgDb(dsn)
        self.num_shards = num_shards

    async def prepare(self) -> None:
        await self.db.migrate(MIGRATIONS)
