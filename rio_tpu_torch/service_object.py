"""ServiceObject: the actor base class.

Reference: ``rio-rs/src/service_object.rs`` — lifecycle hooks
(``:85-116``), the static in-server ``send`` (``:52-83``), ``WithId``
(``:33-36``), and the blanket ``Handler<LifecycleMessage>`` (``:129-164``).

A service object is addressed by ``ObjectId(type_name, id)``; the framework
constructs it on demand on whichever node placement chose, drives its
lifecycle (``before_load`` → state load → ``after_load``; ``before_shutdown``
→ removal), and serializes handler execution per object.
"""

from __future__ import annotations

import asyncio
import logging
from enum import Enum
from typing import Any, TypeVar

from . import codec
from .app_data import AppData
from .commands import AdminCommand, AdminSender, InternalClientSender
from .errors import ServiceObjectLifeCycleError
from .protocol import ErrorKind, ResponseEnvelope
from .registry import decode_error, handler, message, type_id
from .streams import SagaStep, StreamDelivery

T = TypeVar("T")

log = logging.getLogger("rio_tpu_torch.service_object")


class LifecycleKind(Enum):
    LOAD = "load"
    SHUTDOWN = "shutdown"


@message(name="rio.LifecycleMessage")
class LifecycleMessage:
    """Framework-internal activation/deactivation signal.

    Reference ``service_object.rs:129-141``; ``Load`` is sent right after an
    object is constructed and inserted (``service.rs:330-343``).
    """

    kind: LifecycleKind = LifecycleKind.LOAD


@message(name="rio.ReminderFired")
class ReminderFired:
    """One durable-reminder tick, delivered as an ordinary request.

    Riding the existing request path (rather than a new frame kind) keeps
    the wire format untouched: the native codec and both transports see a
    plain message. ``due`` is the tick's scheduled time; ``missed`` counts
    whole periods lost before this fire (0 on a healthy schedule — the
    catch-up signal after an ownership gap).
    """

    name: str = ""
    due: float = 0.0
    missed: int = 0


def cancel_timers(obj: Any) -> None:
    """Cancel every volatile timer of ``obj`` (idempotent).

    Module-level because both deactivation paths need it and one of them
    no longer has a handler context: the SHUTDOWN lifecycle (graceful) and
    the service layer's panic deallocation (the object is already out of
    the registry when its timers must die).
    """
    timers = getattr(obj, "_rio_timers", None)
    if not timers:
        return
    for task in timers.values():
        task.cancel()
    timers.clear()


class ServiceObject:
    """Base class for all actors. Subclasses add ``@handler`` methods.

    The ``id`` attribute plays the reference's ``WithId`` role; it is set by
    the registry right after construction.
    """

    id: str = ""

    # -- lifecycle hooks (reference service_object.rs:85-116) ---------------

    async def before_load(self, ctx: AppData) -> None:  # noqa: ARG002
        return None

    async def after_load(self, ctx: AppData) -> None:  # noqa: ARG002
        return None

    async def before_shutdown(self, ctx: AppData) -> None:  # noqa: ARG002
        return None

    async def load_state(self, ctx: AppData) -> None:
        """Pull persisted state for every ``managed_state`` field.

        The default covers the common case (reference's
        ``#[derive(ManagedState)]`` + ``ServiceObjectStateLoad`` blanket);
        objects with custom persistence override this.
        """
        from .state import load_state as _load_managed

        await _load_managed(self, ctx)

    async def save_state(self, ctx: AppData, field_name: str | None = None) -> None:
        """Persist managed fields (all, or one by name). Handler-driven, as
        in the reference (``ObjectStateManager::save_state``)."""
        from .state import save_state as _save_managed

        await _save_managed(self, ctx, field_name)

    @handler
    async def _handle_lifecycle(self, msg: LifecycleMessage, ctx: AppData) -> None:
        """Blanket lifecycle handler (reference ``service_object.rs:150-163``)."""
        if msg.kind == LifecycleKind.LOAD:
            try:
                await self.before_load(ctx)
                await self.load_state(ctx)
                self._restore_migrated_state(ctx)
                await self.after_load(ctx)
            except Exception as e:
                raise ServiceObjectLifeCycleError(str(e)) from e
        elif msg.kind == LifecycleKind.SHUTDOWN:
            # Timers die first: a tick enqueued mid-shutdown would
            # re-activate the object on this (possibly draining) node.
            cancel_timers(self)
            await self.before_shutdown(ctx)

    def _restore_migrated_state(self, ctx: AppData) -> None:
        """Claim a migrated volatile snapshot, if one awaits this activation.

        Runs between ``load_state`` and ``after_load`` so ``__restore_state__``
        sees warm managed fields and ``after_load`` sees the restored
        volatile state. A migration stash wins over a shipped replica (a
        coordinated handoff is newer than any log-shipped delta); the
        replica covers the path with no handoff at all — activation on a
        promoted standby after the primary died. A no-op without either
        manager or entry.
        """
        from .migration import MigrationManager

        mgr = ctx.try_get(MigrationManager)
        if mgr is not None and mgr.restore_volatile(self):
            return
        from .replication import ReplicationManager

        repl = ctx.try_get(ReplicationManager)
        if repl is not None:
            repl.restore_replica(self)

    @handler
    async def _handle_reminder(self, msg: ReminderFired, ctx: AppData) -> None:
        """Blanket reminder handler: every service object can be woken by
        the reminder daemon; subclasses override :meth:`receive_reminder`."""
        await self.receive_reminder(msg, ctx)

    @handler
    async def _handle_stream_delivery(self, msg: StreamDelivery, ctx: AppData) -> Any:
        """Blanket stream-delivery handler: consumer-group cursors deliver
        records as ordinary requests (like ``rio.ReminderFired``);
        subclasses override :meth:`receive_stream`. A clean return acks
        the record; any raise leaves it undelivered (redelivered later)."""
        return await self.receive_stream(msg, ctx)

    async def receive_stream(self, delivery: "StreamDelivery", ctx: AppData) -> Any:  # noqa: ARG002
        """Called for each stream record delivered to this actor (override
        me). ``delivery.decode()`` yields the application message;
        ``delivery.attempt > 1`` marks a redelivery (dedup hint)."""
        log.debug(
            "%s/%s: unhandled stream delivery %s@%d",
            type_id(type(self)), self.id, delivery.stream, delivery.offset,
        )
        return None

    @handler
    async def _handle_saga_step(self, msg: SagaStep, ctx: AppData) -> Any:
        """Blanket saga-step handler: any actor can participate in a saga.
        Dispatches the carried message to this object's own handler with a
        persisted dedup ledger (see :func:`rio_tpu_torch.streams.saga.
        apply_saga_step`) so re-sent steps apply exactly once."""
        from .streams.saga import apply_saga_step

        return await apply_saga_step(self, msg, ctx)

    async def receive_reminder(self, fired: ReminderFired, ctx: AppData) -> None:  # noqa: ARG002
        """Called on each durable-reminder tick (override me).

        The activation itself is often the point — a reminder to an
        unloaded object runs the full LOAD lifecycle first, so state is
        warm by the time this runs.
        """
        log.debug("%s/%s: unhandled reminder %r", type_id(type(self)), self.id, fired.name)

    # -- volatile timers ----------------------------------------------------

    def register_timer(self, ctx: AppData, name: str, period: float, msg: Any) -> None:
        """Fire ``msg`` at ``self`` every ``period`` seconds while activated.

        The tick goes through the server's normal dispatch queue
        (:meth:`send`), so it honors the per-object lock like any request
        and runs the handler registered for ``type(msg)``. Volatile:
        cancelled at SHUTDOWN/panic deactivation, never persisted — use
        :meth:`register_reminder` to survive deactivation.
        Re-registering ``name`` replaces the previous timer.
        """
        # Lazy dict on the INSTANCE: subclasses routinely skip
        # super().__init__(), and a class-level default would be shared.
        timers: dict[str, asyncio.Task] = self.__dict__.setdefault("_rio_timers", {})
        old = timers.pop(name, None)
        if old is not None:
            old.cancel()
        tname, oid = type_id(type(self)), self.id

        async def _tick_loop() -> None:
            while True:
                await asyncio.sleep(period)
                try:
                    await ServiceObject.send(ctx, tname, oid, msg)
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # noqa: BLE001 — keep ticking
                    log.warning("timer %s/%s/%s tick failed: %r", tname, oid, name, e)

        timers[name] = asyncio.ensure_future(_tick_loop())

    def cancel_timer(self, name: str) -> bool:
        """Cancel one timer; True when it existed."""
        timers = self.__dict__.get("_rio_timers")
        if not timers or name not in timers:
            return False
        timers.pop(name).cancel()
        return True

    # -- durable reminders --------------------------------------------------

    async def register_reminder(
        self, ctx: AppData, name: str, period: float, *, first_due: float | None = None
    ) -> None:
        """Persist a durable reminder: ``receive_reminder`` fires every
        ``period`` seconds from ``first_due`` (default: one period from
        now) — surviving crash, drain, and re-placement; delivered by
        whichever node owns this object's reminder shard. Re-registering
        overwrites (Orleans semantics)."""
        import time

        from .reminders import Reminder, ReminderStorage

        due = time.time() + period if first_due is None else first_due
        await ctx.get(ReminderStorage).upsert(
            Reminder(type_id(type(self)), self.id, name, period, due)
        )

    async def unregister_reminder(self, ctx: AppData, name: str) -> None:
        from .reminders import ReminderStorage

        await ctx.get(ReminderStorage).remove(type_id(type(self)), self.id, name)

    async def list_reminders(self, ctx: AppData) -> list[Any]:
        from .reminders import ReminderStorage

        return await ctx.get(ReminderStorage).list_object(type_id(type(self)), self.id)

    # -- in-server messaging (reference service_object.rs:52-83) ------------

    @staticmethod
    async def send(
        ctx: AppData,
        handler_type: str | type,
        handler_id: str,
        msg: Any,
        returns: Any = Any,
    ) -> Any:
        """Message another object through this node's own dispatch path.

        Goes through the server's internal-client queue — the full placement
        → start → dispatch path — so the target may live anywhere in the
        cluster (a remote owner surfaces as a ``Redirect`` error here, as in
        the reference; use a real Client for cross-node fan-out).
        """
        tname = handler_type if isinstance(handler_type, str) else type_id(handler_type)
        sender = ctx.get(InternalClientSender)
        raw = await sender.send(tname, handler_id, type_id(type(msg)), codec.serialize(msg))
        env = ResponseEnvelope.from_bytes(raw)
        if env.is_ok:
            return codec.deserialize(env.body, returns)
        err = env.error
        assert err is not None
        if err.kind == ErrorKind.APPLICATION:
            raise decode_error(err.payload, err.detail)
        from .errors import HandlerError

        raise HandlerError(f"{err.kind.name}: {err.detail}")

    async def shutdown(self, ctx: AppData) -> None:
        """Request this object's removal from its hosting server.

        Reference ``service_object.rs`` + ``server.rs:338-363`` admin path:
        the server runs ``before_shutdown``, drops the instance from the
        registry, and deletes its placement row.
        """
        ctx.get(AdminSender).send(AdminCommand.shutdown(type_id(type(self)), self.id))
