"""Minimal asyncio RESP2 (Redis protocol) client — no external driver.

The environment has no ``redis-py``; the Redis-backed storage providers
(reference ``rio-rs/src/cluster/storage/redis.rs``,
``object_placement/redis.rs``, ``state/redis.rs``) instead speak the wire
protocol directly through this module. It implements exactly the subset the
backends need: command encoding as arrays of bulk strings and reply parsing
for simple strings, errors, integers, bulk strings, and arrays.

Connection management mirrors the reference's bb8 pool
(``rio-rs/src/client/pool.rs``): a lazily-grown pool of at most
``pool_size`` connections handed out through an ``asyncio`` queue.
"""

from __future__ import annotations

import asyncio
from typing import Any

__all__ = [
    "RespError",
    "RedisClient",
    "Transaction",
    "check_replies",
    "encode_command",
]


class RespError(Exception):
    """Server-side error reply (``-ERR ...``)."""


def check_replies(replies: list) -> list:
    """Raise the first in-place ``RespError`` from a pipelined reply list.

    ``execute_pipeline`` returns server errors in place so callers that can
    tolerate per-command failure see all replies — but a caller that acks a
    WRITE pipeline without checking silently drops the failed command (the
    chaos matrix caught exactly that: an injected -ERR on the SET half of a
    placement upsert acked a write that never landed). Every pipeline whose
    errors must not be swallowed goes through this gate.
    """
    for r in replies:
        if isinstance(r, RespError):
            raise r
    return replies


def encode_command(*args: Any) -> bytes:
    """Encode a command as a RESP array of bulk strings."""
    out = [b"*%d\r\n" % len(args)]
    for a in args:
        if isinstance(a, bytes):
            b = a
        elif isinstance(a, str):
            b = a.encode()
        elif isinstance(a, bool):  # before int: bool is an int subclass
            b = b"1" if a else b"0"
        elif isinstance(a, (int, float)):
            b = repr(a).encode()
        else:
            raise TypeError(f"cannot encode {type(a).__name__} as RESP bulk string")
        out.append(b"$%d\r\n" % len(b))
        out.append(b)
        out.append(b"\r\n")
    return b"".join(out)


async def read_reply(reader: asyncio.StreamReader) -> Any:
    """Parse one RESP2 reply. Bulk strings are returned as ``bytes``."""
    line = await reader.readline()
    if not line.endswith(b"\r\n"):
        raise ConnectionError("redis connection closed mid-reply")
    kind, rest = line[:1], line[1:-2]
    if kind == b"+":
        return rest.decode()
    if kind == b"-":
        raise RespError(rest.decode())
    if kind == b":":
        return int(rest)
    if kind == b"$":
        n = int(rest)
        if n == -1:
            return None
        body = await reader.readexactly(n + 2)
        return body[:-2]
    if kind == b"*":
        n = int(rest)
        if n == -1:
            return None
        return [await read_reply(reader) for _ in range(n)]
    raise ConnectionError(f"unknown RESP reply type {kind!r}")


class _Conn:
    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer

    async def execute(self, *args: Any) -> Any:
        self.writer.write(encode_command(*args))
        await self.writer.drain()
        return await read_reply(self.reader)

    def close(self) -> None:
        try:
            self.writer.close()
        except Exception:
            pass


class Transaction:
    """One pooled connection checked out for a WATCH/MULTI/EXEC sequence.

    Redis transaction state (watched keys, the MULTI queue) lives on the
    *connection*, so an optimistic-locking CAS must run its whole
    WATCH → GET → MULTI → ... → EXEC conversation on a single socket —
    the pool's per-call checkout would scatter it across connections.

    Contract: the caller ends the sequence with ``EXEC`` or ``UNWATCH``
    before leaving the ``async with`` block; exiting on an exception closes
    the connection instead of pooling it, so server-side session state can
    never leak into the next checkout.
    """

    def __init__(self, client: "RedisClient") -> None:
        self._client = client
        self._conn: _Conn | None = None
        self._broken = False

    async def __aenter__(self) -> "Transaction":
        self._conn = await self._client._acquire()
        return self

    async def execute(self, *args: Any) -> Any:
        assert self._conn is not None, "Transaction used outside 'async with'"
        try:
            return await self._conn.execute(*args)
        except RespError:
            raise  # protocol-level error; socket still healthy
        except BaseException:
            self._broken = True
            raise

    async def __aexit__(self, exc_type, exc, tb) -> None:
        if self._conn is not None:
            self._client._release(
                self._conn, broken=self._broken or exc_type is not None
            )
            self._conn = None


class RedisClient:
    """Pooled RESP2 client: ``await client.execute("SET", k, v)``."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6379, *,
                 db: int = 0, password: str | None = None, username: str | None = None,
                 pool_size: int = 4, connect_timeout: float = 5.0):
        self.host = host
        self.port = port
        self.db = db
        self.password = password
        self.username = username
        self.pool_size = pool_size
        self.connect_timeout = connect_timeout
        self._sem = asyncio.Semaphore(pool_size)
        self._idle: list[_Conn] = []
        self._closed = False

    @classmethod
    def from_url(cls, url: str, **kw: Any) -> "RedisClient":
        """``redis://[user:password@]host[:port][/db]`` (the reference's
        connection-string form, credentials included)."""
        from urllib.parse import urlparse

        u = urlparse(url if "://" in url else f"redis://{url}")
        db = int(u.path.lstrip("/") or 0) if u.path.strip("/") else 0
        return cls(
            u.hostname or "127.0.0.1", u.port or 6379, db=db,
            password=u.password,
            # '' (redis://:pw@host) means password-only auth: one-arg AUTH,
            # not a lookup of the '' ACL user.
            username=u.username or None,
            **kw,
        )

    async def _acquire(self) -> _Conn:
        """Check out a connection; the semaphore bounds total checkouts so a
        broken connection (closed, not returned) frees its slot for a fresh
        dial by the next waiter — no waiter can deadlock on a dead socket."""
        await self._sem.acquire()
        try:
            if self._idle:
                return self._idle.pop()
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(self.host, self.port), self.connect_timeout
            )
            conn = _Conn(reader, writer)
            try:
                if self.password is not None:
                    if self.username:
                        await conn.execute("AUTH", self.username, self.password)
                    else:
                        await conn.execute("AUTH", self.password)
                if self.db:
                    await conn.execute("SELECT", self.db)
            except BaseException:
                conn.close()  # handshake failed: don't leak the socket
                raise
            return conn
        except BaseException:
            self._sem.release()
            raise

    def _release(self, conn: _Conn, *, broken: bool = False) -> None:
        if broken or self._closed:
            conn.close()
        else:
            self._idle.append(conn)
        self._sem.release()

    async def execute(self, *args: Any) -> Any:
        if self._closed:
            raise ConnectionError("RedisClient is closed")
        conn = await self._acquire()
        try:
            reply = await conn.execute(*args)
        except RespError:
            self._release(conn)  # protocol-level error; conn still good
            raise
        except BaseException:
            self._release(conn, broken=True)
            raise
        self._release(conn)
        return reply

    async def execute_pipeline(self, commands: list[tuple]) -> list[Any]:
        """Send every command, then read every reply, on one connection —
        N commands in ~1 round trip (the reference's ``redis::pipe()``).
        A server error in any reply is returned in place, not raised."""
        if self._closed:
            raise ConnectionError("RedisClient is closed")
        if not commands:
            return []
        conn = await self._acquire()
        try:
            conn.writer.write(b"".join(encode_command(*c) for c in commands))
            await conn.writer.drain()
            replies: list[Any] = []
            for _ in commands:
                try:
                    replies.append(await read_reply(conn.reader))
                except RespError as e:
                    replies.append(e)
        except BaseException:
            self._release(conn, broken=True)
            raise
        self._release(conn)
        return replies

    def transaction(self) -> Transaction:
        """Check out one connection for a WATCH/MULTI/EXEC sequence."""
        if self._closed:
            raise ConnectionError("RedisClient is closed")
        return Transaction(self)

    async def ping(self) -> bool:
        return await self.execute("PING") == "PONG"

    def close(self) -> None:
        self._closed = True
        while self._idle:
            self._idle.pop().close()
