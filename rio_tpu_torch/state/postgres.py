"""PostgreSQL state provider.

Reference: ``rio-rs/src/state/postgres.rs`` — same table shape as SQLite, so
query logic is inherited from :class:`~rio_tpu_torch.state.sqlite.SqliteState`;
only the connection and migrations differ. Driver-gated
(``rio_tpu_torch/utils/pg.py``).
"""

from __future__ import annotations

from ..utils.pg import PgDb
from .sqlite import SqliteState

MIGRATIONS = [
    """
    CREATE TABLE IF NOT EXISTS state_provider_object_state (
        object_kind      TEXT NOT NULL,
        object_id        TEXT NOT NULL,
        state_type       TEXT NOT NULL,
        serialized_state TEXT NOT NULL,
        PRIMARY KEY (object_kind, object_id, state_type)
    )
    """
]


class PostgresState(SqliteState):
    def __init__(self, dsn: str) -> None:
        self.db = PgDb(dsn)

    async def prepare(self) -> None:
        await self.db.migrate(MIGRATIONS)
