"""Producer publish path + consumer-group cursor actors.

The durable-stream data path, assembled from existing machinery:

* :func:`publish` — append to :class:`~rio_tpu_torch.streams.StreamStorage`
  (the durability point: the returned ``(partition, offset)`` IS the
  ack), fan the record out through :class:`~rio_tpu_torch.message_router.
  MessageRouter` as the live tail (wire subscribers on
  ``("rio.Stream", "<stream>/<partition>")`` see it immediately, with
  broadcast-lag semantics — the log is the source of truth), then nudge
  every subscribed group's cursor with a fire-and-forget
  :class:`~rio_tpu_torch.streams.StreamWake`.
* :class:`StreamCursor` — one ordinary placement-seated actor per
  ``(stream, group, partition)``: it reads from the group's committed
  offset, delivers each record to the target consumer actor through an
  internal cluster client (placement → redirect → retry, like the
  reminder daemon's delivery path), and commits the delivered prefix
  AFTER delivery — at-least-once. A durable reminder stays armed while
  the subscription exists, so a cursor whose node was SIGKILLed is
  re-activated by the reminder daemon and resumes from its committed
  offset (redelivery ticks ARE reminder fires).

Ordering: per partition, deliveries are in offset order and the pump
stops at the first failed delivery (commit covers the delivered prefix
only) — a failing consumer blocks its partition until redelivery
succeeds, the standard poison-pill trade of ordered logs.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import time
from typing import Any

from .. import codec
from ..affinity import EdgeSampler, sending_from
from ..app_data import AppData
from ..cluster.storage import MembershipStorage
from ..errors import HandlerError
from ..journal import STREAM, Journal
from ..message_router import MessageRouter
from ..registry import handler, type_id
from ..reminders import Reminder, ReminderStorage
from ..service_object import ServiceObject
from ..tracing import current_trace_id
from . import StreamDelivery, StreamRecord, StreamStorage, StreamWake, Subscription

log = logging.getLogger("rio_tpu_torch.streams")

#: Wire type of the live-tail subscription anchor and the id separator of
#: cursor actors. Stream and group names must not contain the separator.
TAP_TYPE = "rio.Stream"
CURSOR_TYPE = "rio.StreamCursor"
CURSOR_SEP = "|"
REDELIVERY_REMINDER = "rio.stream.redeliver"

# Strong refs for fire-and-forget wake sends (asyncio keeps only weak ones).
_PENDING: set[asyncio.Task] = set()


def cursor_id(stream: str, group: str, partition: int) -> str:
    return f"{stream}{CURSOR_SEP}{group}{CURSOR_SEP}{partition}"


class StreamTap(ServiceObject):
    """Live-tail subscription anchor: ``client.subscribe("rio.Stream",
    "<stream>/<partition>")`` seats one of these wherever placement wants
    it and rides the ordinary router bridge. No handlers — the publisher
    writes into the channel directly."""

    __type_name__ = TAP_TYPE


async def publish(
    ctx: AppData, stream: str, message: Any, *, key: str = ""
) -> tuple[int, int]:
    """Durably append ``message`` to ``stream``; returns the acked
    ``(partition, offset)``. In-server producer API (handlers/daemons);
    remote producers use ``Client.publish_stream``."""
    return await publish_raw(
        ctx, stream, key, type_id(type(message)), codec.serialize(message)
    )


async def publish_raw(
    ctx: AppData, stream: str, key: str, message_type: str, payload: bytes
) -> tuple[int, int]:
    """The untyped publish path (shared with the wire ``stream.publish``
    command, whose payload is already serialized)."""
    storage = ctx.get(StreamStorage)
    partition = storage.partition_of(stream, key)
    record = StreamRecord(
        stream, partition, 0, message_type, payload, key, time.time()
    )
    # Durability point: the append's offset is the ack. Everything after
    # this line is best-effort acceleration — the log + cursors guarantee
    # delivery without it.
    offset = await storage.append(record)
    router = ctx.try_get(MessageRouter)
    if router is not None:
        router.publish(
            TAP_TYPE,
            f"{stream}/{partition}",
            StreamDelivery(
                stream=stream,
                partition=partition,
                offset=offset,
                message_type=message_type,
                payload=payload,
                key=key,
            ),
        )
    journal = ctx.try_get(Journal)
    if journal is not None and current_trace_id() is not None:
        # Traced publishes only: an untraced hot publish path must not
        # churn the control-plane ring.
        journal.record(
            STREAM, f"{stream}/{partition}", op="publish", offset=offset
        )
    for sub in await storage.subscriptions(stream):
        _wake(ctx, stream, sub.group, partition)
    return partition, offset


def _wake(ctx: AppData, stream: str, group: str, partition: int) -> None:
    """Fire-and-forget cursor nudge. Loss (full queue, redirect, dead
    node) is fine — the redelivery reminder is the durable backstop."""

    async def _send() -> None:
        with contextlib.suppress(Exception):
            await ServiceObject.send(
                ctx,
                CURSOR_TYPE,
                cursor_id(stream, group, partition),
                StreamWake(stream=stream, group=group, partition=partition),
            )

    task = asyncio.ensure_future(_send())
    _PENDING.add(task)
    task.add_done_callback(_PENDING.discard)


async def subscribe_group(
    ctx: AppData,
    stream: str,
    group: str,
    target_type: str | type,
    *,
    redelivery_period: float = 2.0,
) -> None:
    """Attach a consumer group: records of ``stream`` are delivered to
    actors of ``target_type`` (id = record key, or
    ``"<stream>-<partition>"`` for keyless records), starting from the
    group's committed offset (0 for a new group — full replay).

    Persists the subscription and arms one durable redelivery reminder
    per partition, so cursors are (re)activated by the reminder daemon
    even after every node that ever hosted them died.
    """
    storage = ctx.get(StreamStorage)
    tname = target_type if isinstance(target_type, str) else type_id(target_type)
    await storage.subscribe(
        Subscription(stream, group, tname, redelivery_period)
    )
    reminders = ctx.try_get(ReminderStorage)
    if reminders is not None:
        now = time.time()
        for p in range(storage.num_partitions):
            await reminders.upsert(
                Reminder(
                    CURSOR_TYPE,
                    cursor_id(stream, group, p),
                    REDELIVERY_REMINDER,
                    redelivery_period,
                    now + redelivery_period,
                )
            )


async def unsubscribe_group(ctx: AppData, stream: str, group: str) -> None:
    """Detach a group: drops the subscription and its reminders (live
    cursors notice the missing subscription on their next pump and stop)."""
    storage = ctx.get(StreamStorage)
    await storage.unsubscribe(stream, group)
    reminders = ctx.try_get(ReminderStorage)
    if reminders is not None:
        for p in range(storage.num_partitions):
            await reminders.remove(
                CURSOR_TYPE, cursor_id(stream, group, p), REDELIVERY_REMINDER
            )


class StreamCursor(ServiceObject):
    """One consumer group's read position on one partition.

    Ordinary placement-seated actor — it migrates, replicates, and
    reseats on death like everything else; all durable state (the
    committed offset) lives in :class:`StreamStorage`, so the actor
    itself is freely killable.
    """

    __type_name__ = CURSOR_TYPE

    #: Records fetched per storage read inside one pump pass.
    batch = 64

    def __init__(self) -> None:
        self._client = None
        # Volatile delivery high-water: offsets below it on a later pass
        # are re-attempts (stamped into StreamDelivery.attempt — the
        # consumer's dedup hint). Lost on crash, which is exactly when
        # redelivery happens anyway.
        self._attempted = -1
        self.delivered = 0
        # Targets whose seat turned out remote: skip the local-first probe
        # for them until the next pump (seats move between pumps — the
        # affinity solver's whole point — so the cache is pump-scoped).
        self._remote: set[str] = set()

    def _parts(self) -> tuple[str, str, int]:
        s, g, p = self.id.split(CURSOR_SEP)
        return s, g, int(p)

    async def before_shutdown(self, ctx: AppData) -> None:  # noqa: ARG002
        if self._client is not None:
            self._client.close()
            self._client = None

    def _delivery_client(self, ctx: AppData):
        """Cluster client for deliveries (placement → redirect → retry):
        consumer actors may be seated on any node, and the in-server
        internal sender surfaces remote owners as Redirect errors."""
        if self._client is None:
            from ..client import Client

            self._client = Client(ctx.get(MembershipStorage))
        return self._client

    @handler
    async def _handle_wake(self, msg: StreamWake, ctx: AppData) -> int:  # noqa: ARG002
        return await self._pump(ctx)

    async def receive_reminder(self, fired, ctx: AppData) -> None:
        if fired.name == REDELIVERY_REMINDER:
            await self._pump(ctx, backstop=True)

    async def _pump(self, ctx: AppData, *, backstop: bool = False) -> int:
        """Deliver everything past the committed offset; returns the count.

        Commit happens AFTER delivery (per batch, prefix-only on a failed
        delivery) — the at-least-once edge: a crash between delivery and
        commit redelivers, never loses.
        """
        storage = ctx.get(StreamStorage)
        stream, group, partition = self._parts()
        sub = next(
            (s for s in await storage.subscriptions(stream) if s.group == group),
            None,
        )
        if sub is None:
            # Unsubscribed (or a stale reminder outlived the group): stop
            # the backstop so dead cursors don't tick forever.
            await self.unregister_reminder(ctx, REDELIVERY_REMINDER)
            return 0
        committed = await storage.committed(stream, group, partition)
        total = 0
        stalled = False
        self._remote.clear()  # re-probe seats once per pump
        while not stalled:
            records = await storage.read(stream, partition, committed, self.batch)
            if not records:
                break
            done = committed
            try:
                for rec in records:
                    attempt = 2 if rec.offset <= self._attempted else 1
                    self._attempted = max(self._attempted, rec.offset)
                    if not await self._deliver(ctx, sub, rec, attempt):
                        stalled = True
                        break
                    done = rec.offset + 1
                    total += 1
            finally:
                if done > committed:
                    await storage.commit(stream, group, partition, done)
            committed = done
        if total:
            self.delivered += total
            journal = ctx.try_get(Journal)
            if journal is not None:
                journal.record(
                    STREAM,
                    f"{stream}/{group}/{partition}",
                    op="deliver",
                    n=total,
                    committed=committed,
                    backstop=backstop,
                )
        return total

    async def _deliver(
        self, ctx: AppData, sub: Subscription, rec: StreamRecord, attempt: int
    ) -> bool:
        """Send one record; True when it counts as delivered.

        Local-first: consumers seated on THIS node (or not seated at all —
        the internal path self-assigns them beside their cursor) are
        delivered through the in-server dispatch queue, never touching
        TCP; only a Redirect (seated elsewhere) falls back to the cluster
        client. Both paths stamp the cursor→consumer edge into the
        affinity sampler (``sending_from`` on the local leg, an explicit
        remote observation on the client leg) — the traffic the
        graph-aware solver co-locates by.

        A typed application error from the consumer is a REJECTION —
        not delivered, the pump stalls and redelivery retries (ordered
        logs block on a poison record rather than skip it). Transport
        failures likewise. Only a clean handler return commits.
        """
        target_id = rec.key or f"{rec.stream}-{rec.partition}"
        delivery = StreamDelivery(
            stream=rec.stream,
            group=sub.group,
            partition=rec.partition,
            offset=rec.offset,
            message_type=rec.message_type,
            payload=rec.payload,
            key=rec.key,
            attempt=attempt,
        )
        src = f"{CURSOR_TYPE}.{self.id}"
        if target_id not in self._remote:
            try:
                with sending_from(src):
                    await ServiceObject.send(
                        ctx, sub.target_type, target_id, delivery
                    )
                return True
            except HandlerError as e:
                if not str(e).startswith("REDIRECT"):
                    log.warning(
                        "delivery %s/%s@%d -> %s/%s failed: %r",
                        rec.stream, rec.partition, rec.offset,
                        sub.target_type, target_id, e,
                    )
                    return False
                self._remote.add(target_id)  # seated elsewhere; go remote
            except Exception as e:  # noqa: BLE001 — consumer rejected it
                log.warning(
                    "delivery %s/%s@%d -> %s/%s raised: %r",
                    rec.stream, rec.partition, rec.offset,
                    sub.target_type, target_id, e,
                )
                return False
        try:
            await self._delivery_client(ctx).send(
                sub.target_type, target_id, delivery
            )
            sampler = ctx.try_get(EdgeSampler)
            if sampler is not None:
                # Remote leg: the receiving node can't see our identity
                # (source never rides the wire), so the edge is stamped
                # sender-side.
                sampler.observe(
                    src, f"{sub.target_type}.{target_id}",
                    len(rec.payload), False,
                )
            return True
        except (HandlerError, OSError, asyncio.TimeoutError) as e:
            log.warning(
                "delivery %s/%s@%d -> %s/%s failed: %r",
                rec.stream, rec.partition, rec.offset,
                sub.target_type, target_id, e,
            )
            return False
        except Exception as e:  # noqa: BLE001 — consumer raised through the wire
            log.warning(
                "delivery %s/%s@%d -> %s/%s raised: %r",
                rec.stream, rec.partition, rec.offset,
                sub.target_type, target_id, e,
            )
            return False
