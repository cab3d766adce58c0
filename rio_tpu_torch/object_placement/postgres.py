"""PostgreSQL object-placement directory.

Reference: ``rio-rs/src/object_placement/postgres.rs:25-50`` ff — same table
shape as SQLite, so query logic is inherited from
:class:`~rio_tpu_torch.object_placement.sqlite.SqliteObjectPlacement`; only the
connection and migrations differ. Driver-gated (``rio_tpu_torch/utils/pg.py``).
"""

from __future__ import annotations

from ..utils.pg import PgDb
from .sqlite import SqliteObjectPlacement

MIGRATIONS = [
    """
    CREATE TABLE IF NOT EXISTS object_placement (
        struct_name    TEXT NOT NULL,
        object_id      TEXT NOT NULL,
        server_address TEXT,
        PRIMARY KEY (struct_name, object_id)
    );
    CREATE INDEX IF NOT EXISTS idx_object_placement_server
        ON object_placement (server_address)
    """,
    """
    CREATE TABLE IF NOT EXISTS object_standby (
        struct_name TEXT NOT NULL,
        object_id   TEXT NOT NULL,
        standbys    TEXT NOT NULL DEFAULT '',
        epoch       INTEGER NOT NULL DEFAULT 0,
        PRIMARY KEY (struct_name, object_id)
    )
    """,
]


class PostgresObjectPlacement(SqliteObjectPlacement):
    def __init__(self, dsn: str) -> None:
        self.db = PgDb(dsn)

    async def prepare(self) -> None:
        await self.db.migrate(MIGRATIONS)
