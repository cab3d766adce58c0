"""PostgreSQL membership storage.

Reference: ``rio-rs/src/cluster/storage/postgres.rs:28-56`` ff — identical
table shape to the SQLite backend, so the query logic is inherited from
:class:`~rio_tpu_torch.cluster.storage.sqlite.SqliteMembershipStorage`; only the
connection (``PgDb``) and dialect-specific migrations differ. Requires a
PostgreSQL driver at runtime (see ``rio_tpu_torch/utils/pg.py``) — the same
feature-gating the reference does with its ``postgres`` cargo feature.
"""

from __future__ import annotations

from ...utils.pg import PgDb
from .sqlite import SqliteMembershipStorage

MIGRATIONS = [
    """
    CREATE TABLE IF NOT EXISTS cluster_provider_members (
        ip        TEXT NOT NULL,
        port      INTEGER NOT NULL,
        active    INTEGER NOT NULL DEFAULT 0,
        last_seen DOUBLE PRECISION NOT NULL DEFAULT 0,
        load_vec  TEXT NOT NULL DEFAULT '',
        shard_map TEXT NOT NULL DEFAULT '',
        PRIMARY KEY (ip, port)
    );
    CREATE TABLE IF NOT EXISTS cluster_provider_member_failures (
        ip   TEXT NOT NULL,
        port INTEGER NOT NULL,
        ts   DOUBLE PRECISION NOT NULL
    );
    CREATE INDEX IF NOT EXISTS idx_member_failures
        ON cluster_provider_member_failures (ip, port, ts)
    """
]


class PostgresMembershipStorage(SqliteMembershipStorage):
    def __init__(self, dsn: str) -> None:  # noqa: super().__init__ replaced: PgDb, not SqliteDb
        self.db = PgDb(dsn)

    async def prepare(self) -> None:
        await self.db.migrate(MIGRATIONS)
        # Guarded ALTER (inherited) rather than ADD COLUMN IF NOT EXISTS:
        # the DBAPI fake (tests/fake_pg.py) runs these migrations against
        # sqlite, which doesn't parse the PG-only IF NOT EXISTS form.
        await self._ensure_load_column()
