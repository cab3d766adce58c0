"""Shared async PostgreSQL helper for the sql-backed providers.

Mirrors :class:`rio_tpu_torch.utils.sqlite.SqliteDb` so the Postgres backends can
reuse the SQLite backends' query logic (the reference keeps the same shape
between its sqlx SQLite and Postgres impls, e.g.
``rio-rs/src/cluster/storage/postgres.rs:28-56`` vs ``sqlite.rs:74-92``).

The driver is discovered at runtime — ``psycopg`` (v3) or ``psycopg2`` —
and queries written with ``?`` placeholders are translated to
the DBAPI ``%s`` paramstyle. If no driver is installed, constructing a
:class:`PgDb` raises a clear error; the rest of the framework never imports
this module unless a Postgres backend is requested (the reference gates the
same way with the ``postgres`` cargo feature).
"""

from __future__ import annotations

import asyncio
import threading
from typing import Any, Iterable

# pg8000 is excluded: its connect() takes (user, host, ...) kwargs, not a
# DSN string, so it cannot sit behind this DSN-based interface unmodified.
_DRIVERS = ("psycopg", "psycopg2")


def _find_driver():
    for name in _DRIVERS:
        try:
            module = __import__(name)
        except ImportError:
            continue
        for part in name.split(".")[1:]:
            module = getattr(module, part)
        return module
    return None


def driver_available() -> bool:
    return _find_driver() is not None


def _translate(sql: str) -> str:
    """``?`` placeholders → ``%s`` (outside of string literals)."""
    out: list[str] = []
    in_str = False
    for ch in sql:
        if ch == "'":
            in_str = not in_str
        if ch == "?" and not in_str:
            out.append("%s")
        else:
            out.append(ch)
    return "".join(out)


class PgDb:
    def __init__(self, dsn: str) -> None:
        self._driver = _find_driver()
        if self._driver is None:
            raise RuntimeError(
                "no PostgreSQL driver installed (tried psycopg, psycopg2); "
                "install one to use the Postgres backends"
            )
        self.dsn = dsn
        self._conn: Any = None
        self._lock = threading.Lock()

    def _connect(self) -> Any:
        if self._conn is None:
            self._conn = self._driver.connect(self.dsn)
        return self._conn

    def _recover(self, conn: Any) -> None:
        """A failed statement leaves the transaction aborted (psycopg raises
        InFailedSqlTransaction on every later query); roll it back, and if
        even that fails the socket is gone — drop the connection so the next
        call redials."""
        try:
            conn.rollback()
        except Exception:
            try:
                conn.close()
            except Exception:
                pass
            self._conn = None

    def _execute(self, sql: str, params: Iterable[Any]) -> list[tuple]:
        with self._lock:
            conn = self._connect()
            try:
                with conn.cursor() as cur:
                    cur.execute(_translate(sql), tuple(params))
                    rows = cur.fetchall() if cur.description is not None else []
                conn.commit()
            except Exception:
                self._recover(conn)
                raise
            return [tuple(r) for r in rows]

    def _executescript(self, sql: str) -> None:
        with self._lock:
            conn = self._connect()
            try:
                with conn.cursor() as cur:
                    for stmt in (s.strip() for s in sql.split(";")):
                        if stmt:
                            cur.execute(stmt)
                conn.commit()
            except Exception:
                self._recover(conn)
                raise

    async def execute(self, sql: str, *params: Any) -> list[tuple]:
        return await asyncio.to_thread(self._execute, sql, params)

    async def migrate(self, queries: list[str]) -> None:
        for q in queries:
            await asyncio.to_thread(self._executescript, q)

    def close(self) -> None:
        with self._lock:
            if self._conn is not None:
                self._conn.close()
                self._conn = None
