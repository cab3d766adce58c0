"""Shared async SQLite helper for the sql-backed providers.

The reference uses sqlx pools (``rio-rs/src/cluster/storage/sqlite.rs``,
``object_placement/sqlite.rs``, ``state/sqlite.rs``); Python's stdlib
``sqlite3`` is synchronous, so every call runs in the default thread pool
behind one connection + lock (plenty for the control plane, which is exactly
the role these backends play — the hot placement path lives on TPU).
"""

from __future__ import annotations

import asyncio
import sqlite3
import threading
from typing import Any, Iterable


class SqliteDb:
    def __init__(self, path: str) -> None:
        self.path = path
        self._conn: sqlite3.Connection | None = None
        self._lock = threading.Lock()

    def _connect(self) -> sqlite3.Connection:
        if self._conn is None:
            self._conn = sqlite3.connect(self.path, check_same_thread=False)
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute("PRAGMA busy_timeout=5000")
        return self._conn

    def _execute(self, sql: str, params: Iterable[Any]) -> list[tuple]:
        with self._lock:
            conn = self._connect()
            cur = conn.execute(sql, tuple(params))
            rows = cur.fetchall()
            conn.commit()
            return rows

    def _executescript(self, sql: str) -> None:
        with self._lock:
            conn = self._connect()
            conn.executescript(sql)
            conn.commit()

    async def execute(self, sql: str, *params: Any) -> list[tuple]:
        return await asyncio.to_thread(self._execute, sql, params)

    async def migrate(self, queries: list[str]) -> None:
        """Run migration statements (reference ``sql_migration.rs``)."""
        for q in queries:
            await asyncio.to_thread(self._executescript, q)

    def close(self) -> None:
        with self._lock:
            if self._conn is not None:
                self._conn.close()
                self._conn = None
