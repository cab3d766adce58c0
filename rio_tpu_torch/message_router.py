"""Pub/sub fan-out inside one server.

Reference: ``rio-rs/src/message_router.rs:24-43`` — a map of
``(type, id) -> broadcast channel`` (capacity 1000). Handlers publish via
AppData; the per-connection Service bridges a subscription receiver onto TCP
frames (``service.rs:116-148,431-456``).
"""

from __future__ import annotations

import asyncio
from typing import Any

from . import codec
from .protocol import SubscriptionResponse
from .registry import type_id

DEFAULT_CAPACITY = 1000


class _Broadcast:
    """Single-producer multi-consumer ring: each subscriber gets its own
    bounded queue; slow subscribers drop oldest (broadcast-lag semantics)."""

    def __init__(self, capacity: int, router: "MessageRouter | None" = None) -> None:
        self.capacity = capacity
        self.queues: set[asyncio.Queue[SubscriptionResponse]] = set()
        self._router = router

    def subscribe(self) -> asyncio.Queue[SubscriptionResponse]:
        q: asyncio.Queue[SubscriptionResponse] = asyncio.Queue(self.capacity)
        self.queues.add(q)
        return q

    def unsubscribe(self, q: asyncio.Queue) -> None:
        self.queues.discard(q)

    def publish(self, item: SubscriptionResponse) -> int:
        for q in list(self.queues):
            if q.full():
                try:
                    q.get_nowait()  # lagging subscriber loses oldest message
                    # Overflow is survivable (broadcast-lag semantics) but
                    # must be OBSERVABLE: the return value still counts this
                    # subscriber as a receiver, so without the counter a
                    # durable-stream fan-in loses items with no trace
                    # anywhere (rio.router.dropped gauge + journal-free —
                    # this is the data path).
                    if self._router is not None:
                        self._router.dropped += 1
                except asyncio.QueueEmpty:
                    pass
            q.put_nowait(item)
        return len(self.queues)


class MessageRouter:
    """Keyed broadcast registry; injected into AppData by the server."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        self._channels: dict[tuple[str, str], _Broadcast] = {}
        self._capacity = capacity
        #: Items silently displaced from full subscriber queues since boot
        #: (process-wide; surfaced as the ``rio.router.dropped`` gauge).
        self.dropped = 0

    def gauges(self) -> dict[str, float]:
        return {
            "rio.router.dropped": float(self.dropped),
            "rio.router.channels": float(len(self._channels)),
        }

    def _channel(self, type_name: str, object_id: str) -> _Broadcast:
        return self._channels.setdefault(
            (type_name, object_id), _Broadcast(self._capacity, self)
        )

    def create_subscription(self, type_name: str, object_id: str) -> asyncio.Queue:
        """Reference ``message_router.rs:25-35``."""
        return self._channel(type_name, object_id).subscribe()

    def drop_subscription(self, type_name: str, object_id: str, q: asyncio.Queue) -> None:
        ch = self._channels.get((type_name, object_id))
        if ch is not None:
            ch.unsubscribe(q)
            if not ch.queues:
                # Last subscriber gone: drop the channel entry. Without this
                # (and the lookup-only publish below) every object ever
                # published to or subscribed from leaves a permanent
                # _Broadcast in _channels — unbounded growth on a server
                # with actor churn.
                self._channels.pop((type_name, object_id), None)

    def publish(self, type_name: str, object_id: str, msg: Any) -> int:
        """Serialize and fan out ``msg`` to subscribers; returns receiver count.

        Reference ``message_router.rs:37-43`` (handlers call this through
        AppData, e.g. black-jack ``table.rs:72-86``). Publishing to an
        object with no subscribers is a no-op returning 0 — it must not
        materialize a channel (leak path: fire-and-forget publishers).
        """
        ch = self._channels.get((type_name, object_id))
        if ch is None:
            return 0
        resp = SubscriptionResponse(
            body=codec.serialize(msg), message_type=type_id(type(msg))
        )
        return ch.publish(resp)

    def close_subscriptions(self, type_name: str, object_id: str, error) -> int:
        """Terminate every live subscription on one object with ``error``.

        Used by migration handoff: subscribers get a final error item
        (``Redirect`` to the new owner) through the ordinary stream — the
        client's subscribe loop treats it as "resubscribe at detail" — and
        the channel is dropped so no publisher writes into dead queues.
        Returns the number of subscribers notified.
        """
        ch = self._channels.pop((type_name, object_id), None)
        if ch is None:
            return 0
        notified = ch.publish(SubscriptionResponse(error=error))
        ch.queues.clear()
        return notified
