"""SQLite membership storage.

Reference: ``rio-rs/src/cluster/storage/sqlite.rs`` — tables
``cluster_provider_members`` and ``cluster_provider_member_failures``
(migration ``0001-sqlite-init.sql``); upsert push (``:74-92``); failure
query bounded to the most recent 100 (``:165-179``).
"""

from __future__ import annotations

import time

from ...utils.sqlite import SqliteDb
from . import Member, MembershipStorage

MIGRATIONS = [
    """
    CREATE TABLE IF NOT EXISTS cluster_provider_members (
        ip        TEXT NOT NULL,
        port      INTEGER NOT NULL,
        active    INTEGER NOT NULL DEFAULT 0,
        last_seen REAL NOT NULL DEFAULT 0,
        load_vec  TEXT NOT NULL DEFAULT '',
        shard_map TEXT NOT NULL DEFAULT '',
        PRIMARY KEY (ip, port)
    );
    CREATE TABLE IF NOT EXISTS cluster_provider_member_failures (
        ip   TEXT NOT NULL,
        port INTEGER NOT NULL,
        ts   REAL NOT NULL
    );
    CREATE INDEX IF NOT EXISTS idx_member_failures
        ON cluster_provider_member_failures (ip, port, ts);
    """
]


class SqliteMembershipStorage(MembershipStorage):
    def __init__(self, path: str) -> None:
        self.db = SqliteDb(path)

    async def prepare(self) -> None:
        await self.db.migrate(MIGRATIONS)
        await self._ensure_load_column()

    async def _ensure_load_column(self) -> None:
        """Add the appended columns (``load_vec``, ``shard_map``) to member
        tables created before those subsystems existed. ``migrate()`` keeps
        no applied-ledger (it re-runs every statement each call) and sqlite
        has no ``ADD COLUMN IF NOT EXISTS`` — so each upgrade is a guarded
        ALTER: the duplicate-column error on an already-upgraded table is
        the expected no-op."""
        for col in ("load_vec", "shard_map"):
            try:
                await self.db.execute(
                    "ALTER TABLE cluster_provider_members "
                    f"ADD COLUMN {col} TEXT NOT NULL DEFAULT ''"
                )
            except Exception:
                pass

    async def push(self, member: Member) -> None:
        await self.db.execute(
            "INSERT INTO cluster_provider_members "
            "(ip, port, active, last_seen, load_vec, shard_map) "
            "VALUES (?,?,?,?,?,?) ON CONFLICT(ip, port) DO UPDATE SET "
            "active=excluded.active, last_seen=excluded.last_seen, "
            "load_vec=excluded.load_vec, shard_map=excluded.shard_map",
            member.ip, member.port, int(member.active), time.time(), member.load,
            member.shard_map,
        )

    async def remove(self, ip: str, port: int) -> None:
        await self.db.execute(
            "DELETE FROM cluster_provider_members WHERE ip=? AND port=?", ip, port
        )
        await self.db.execute(
            "DELETE FROM cluster_provider_member_failures WHERE ip=? AND port=?", ip, port
        )

    async def set_is_active(self, ip: str, port: int, active: bool) -> None:
        if active:
            await self.db.execute(
                "UPDATE cluster_provider_members SET active=1, last_seen=? "
                "WHERE ip=? AND port=?",
                time.time(), ip, port,
            )
        else:
            await self.db.execute(
                "UPDATE cluster_provider_members SET active=0 WHERE ip=? AND port=?",
                ip, port,
            )

    async def members(self) -> list[Member]:
        rows = await self.db.execute(
            "SELECT ip, port, active, last_seen, load_vec, shard_map "
            "FROM cluster_provider_members"
        )
        return [
            Member(ip=r[0], port=r[1], active=bool(r[2]), last_seen=r[3],
                   load=r[4] or "", shard_map=r[5] or "")
            for r in rows
        ]

    async def notify_failure(self, ip: str, port: int) -> None:
        await self.db.execute(
            "INSERT INTO cluster_provider_member_failures (ip, port, ts) VALUES (?,?,?)",
            ip, port, time.time(),
        )

    async def member_failures(self, ip: str, port: int) -> list[float]:
        rows = await self.db.execute(
            "SELECT ts FROM cluster_provider_member_failures "
            "WHERE ip=? AND port=? ORDER BY ts DESC LIMIT 100",
            ip, port,
        )
        return [r[0] for r in rows]

    def close(self) -> None:
        self.db.close()
