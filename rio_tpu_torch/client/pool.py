"""Bounded client pool.

The reference exposes a bb8 ``ManageConnection`` so applications can hold a
pool of cluster clients (``rio-rs/src/client/pool.rs:26-67``). Here the
pool is asyncio-native: a bounded set of :class:`rio_tpu_torch.Client` instances
handed out through an async context manager, created lazily up to
``max_size``, with waiters queuing on a semaphore. A client whose checkout
ends with a transport-level failure can be discarded (``discard=True``)
so the pool replaces it on the next acquire — the bb8 broken-connection
recycling behavior.
"""

from __future__ import annotations

import asyncio
import contextlib
from typing import Any, AsyncIterator

from . import Client


class ClientPool:
    """``async with pool.client() as c: await c.send(...)``."""

    def __init__(
        self,
        members_storage: Any,
        *,
        max_size: int = 8,
        **client_kwargs: Any,
    ) -> None:
        if max_size < 1:
            raise ValueError("max_size must be >= 1")
        self._members = members_storage
        self._kwargs = client_kwargs
        self._max = max_size
        self._idle: list[Client] = []
        self._created = 0
        self._sem = asyncio.Semaphore(max_size)
        self._closed = False

    # ------------------------------------------------------------------

    def _make(self) -> Client:
        c = Client(self._members, **self._kwargs)
        self._created += 1  # only after construction succeeds
        return c

    @contextlib.asynccontextmanager
    async def client(self) -> AsyncIterator[Client]:
        """Check a client out; returns it to the pool on exit.

        On exception the client is still returned (Client.send already
        recycles dead sockets internally); call :meth:`discard` inside the
        block to drop a client you believe is poisoned.
        """
        if self._closed:
            raise RuntimeError("pool is closed")
        await self._sem.acquire()
        # Re-check: close() may have run while we were parked on the
        # semaphore — constructing a fresh client now would outlive the pool.
        if self._closed:
            self._sem.release()
            raise RuntimeError("pool is closed")
        try:
            c = self._idle.pop() if self._idle else self._make()
        except BaseException:
            self._sem.release()
            raise
        discarded = False

        def discard() -> None:
            nonlocal discarded
            discarded = True

        c.discard = discard  # type: ignore[attr-defined]
        try:
            yield c
        finally:
            with contextlib.suppress(AttributeError):
                del c.discard  # type: ignore[attr-defined]
            if discarded or self._closed:
                self._created -= 1
                c.close()
            else:
                self._idle.append(c)
            self._sem.release()

    @property
    def size(self) -> int:
        """Clients currently alive (checked out + idle)."""
        return self._created

    @property
    def idle(self) -> int:
        return len(self._idle)

    def close(self) -> None:
        """Close every idle client; checked-out clients close on return."""
        self._closed = True
        while self._idle:
            self._created -= 1
            self._idle.pop().close()
