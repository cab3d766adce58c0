"""Saga workflows: multi-actor operations as step/compensation chains.

A saga is a sequence of typed steps, each an ordinary message to an
ordinary actor, with an optional compensation message per step. The
:class:`SagaCoordinator` (wire type ``rio.Saga``, one instance per saga
id) drives the chain with its progress persisted through
``StateProvider`` BEFORE every send — so a coordinator killed mid-saga
resumes (or compensates) deterministically when the resume reminder
re-activates it anywhere in the cluster:

* a step whose outcome is UNKNOWN (transport failure, coordinator death
  mid-send) is re-sent on resume; the participant-side dedup ledger
  (:func:`apply_saga_step`) absorbs the duplicate, so effects apply
  exactly once;
* a step the participant REJECTED (typed application error) flips the
  saga to compensating: completed steps get their compensation messages
  in reverse order, same persistence + dedup discipline.

One saga = one trace tree: the coordinator captures the StartSaga
request's trace context and re-adopts it on every resume, so the full
workflow — across crashes — assembles under one trace id in
``rio_tpu_torch.admin trace``, joined with its SAGA journal events.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
from typing import Any

from .. import codec
from ..affinity import EdgeSampler, sending_from
from ..app_data import AppData
from ..cluster.storage import MembershipStorage
from ..errors import HandlerError, StateNotFound
from ..journal import SAGA, Journal
from ..registry import MESSAGE_TYPES, handler, message, type_id, wire_error
from ..registry.handler import resolve_handlers
from ..service_object import ServiceObject
from ..state import StateProvider, managed_state
from ..tracing import adopt, outbound_ctx, release
from . import SagaStep

log = logging.getLogger("rio_tpu_torch.saga")

SAGA_TYPE = "rio.Saga"
RESUME_REMINDER = "rio.saga.resume"
LEDGER_TYPE = "rio.SagaLedger"
LEDGER_CAP = 256

# Step rows are positional lists (not nested dataclasses) so they survive
# both the msgpack wire and the JSON state flavor unchanged:
# [handler_type, handler_id, action_type, action_payload,
#  compensation_type, compensation_payload]
_HT, _HID, _ATY, _APL, _CTY, _CPL = range(6)


@wire_error(name="rio.SagaStepUnsupported")
class SagaStepUnsupported(Exception):
    """The participant has no handler for the carried message type —
    a typed rejection (the saga compensates), never a panic (which would
    deallocate a healthy participant)."""


def step(
    handler_type: str | type,
    handler_id: str,
    action: Any,
    compensation: Any | None = None,
) -> list:
    """Declare one saga step: send ``action`` to the participant; if a
    LATER step fails, send ``compensation`` (when given) to undo it."""
    tname = handler_type if isinstance(handler_type, str) else type_id(handler_type)
    row = [tname, handler_id, type_id(type(action)), codec.serialize(action)]
    if compensation is not None:
        row += [type_id(type(compensation)), codec.serialize(compensation)]
    else:
        row += ["", b""]
    return row


@message(name="rio.StartSaga")
class StartSaga:
    """Begin (idempotently) the saga named by the coordinator's id.
    ``steps`` is a list of :func:`step` rows."""

    steps: list = dataclasses.field(default_factory=list)


@message(name="rio.SagaStatus")
class SagaStatus:
    """Query the saga's persisted progress."""


@message(name="rio.SagaStatusReply")
class SagaStatusReply:
    status: str = "idle"
    current: int = 0
    total: int = 0
    error: str = ""
    trace_id: str = ""


@dataclasses.dataclass
class SagaRecord:
    """The persisted saga journal: every transition is saved BEFORE the
    send it authorizes, so resume never guesses."""

    saga_id: str = ""
    steps: list = dataclasses.field(default_factory=list)
    status: str = "idle"  # idle|running|compensating|completed|compensated
    current: int = 0  # running: next step index to dispatch
    compensate_from: int = -1  # compensating: next completed index to undo
    trace_id: str = ""
    span_id: str = ""
    error: str = ""


@dataclasses.dataclass
class SagaLedger:
    """Participant-side applied-steps ledger (``(saga, step, kind)``
    strings, FIFO-capped): the exactly-once gate for coordinator
    re-sends."""

    entries: list = dataclasses.field(default_factory=list)


async def apply_saga_step(obj: ServiceObject, msg: SagaStep, ctx: AppData) -> Any:
    """Participant-side dispatch with persisted dedup (the blanket
    ``rio.SagaStep`` handler lands here).

    Looks up the participant's OWN handler for the carried message and
    calls it directly — we already hold the object's dispatch lock, so a
    ``ServiceObject.send`` to self would deadlock. The ledger entry is
    persisted after the handler returns and before the ack, so a
    re-delivered step (coordinator resume) is answered from the ledger
    without re-running the effect.
    """
    kind_name = type_id(type(obj))
    provider = ctx.try_get(StateProvider)
    ledger = SagaLedger()
    if provider is not None:
        try:
            ledger = await provider.load(kind_name, obj.id, LEDGER_TYPE, SagaLedger)
        except StateNotFound:
            ledger = SagaLedger()
    entry = f"{msg.saga_id}\x1f{msg.step}\x1f{msg.kind}"
    journal = ctx.try_get(Journal)
    if entry in ledger.entries:
        if journal is not None:
            journal.record(
                SAGA, msg.saga_id, op="step_dedup", step=msg.step,
                step_kind=msg.kind, participant=f"{kind_name}/{obj.id}",
            )
        return None
    ty = MESSAGE_TYPES.get(msg.message_type)
    spec = next(
        (
            s
            for s in resolve_handlers(type(obj))
            if s.message_type_name == msg.message_type
        ),
        None,
    )
    if ty is None or spec is None:
        raise SagaStepUnsupported(f"{kind_name} cannot handle {msg.message_type}")
    result = await spec.fn(obj, codec.deserialize(msg.payload, ty), ctx)
    # Effect applied; gate the ack behind the ledger write. (A crash in
    # the gap re-applies on resume — the handler's own state save is the
    # participant's atomicity boundary, same as any at-least-once sink.)
    ledger.entries.append(entry)
    del ledger.entries[:-LEDGER_CAP]
    if provider is not None:
        await provider.save(kind_name, obj.id, LEDGER_TYPE, ledger)
    if journal is not None:
        journal.record(
            SAGA, msg.saga_id, op="step_applied", step=msg.step,
            step_kind=msg.kind, participant=f"{kind_name}/{obj.id}",
        )
    return result


class SagaCoordinator(ServiceObject):
    """The ``rio.Saga`` control actor: object id == saga id.

    Placement-seated like any actor; all progress lives in the persisted
    :class:`SagaRecord`, so the coordinator is freely killable — the
    resume reminder re-activates it (anywhere) and ``_advance`` picks up
    from the last persisted transition.
    """

    __type_name__ = SAGA_TYPE

    record = managed_state(SagaRecord)

    def __init__(self) -> None:
        self._client = None

    async def before_shutdown(self, ctx: AppData) -> None:  # noqa: ARG002
        if self._client is not None:
            self._client.close()
            self._client = None

    def _delivery_client(self, ctx: AppData):
        if self._client is None:
            from ..client import Client

            self._client = Client(ctx.get(MembershipStorage))
        return self._client

    def _journal(self, ctx: AppData, op: str, **attrs) -> None:
        journal = ctx.try_get(Journal)
        if journal is not None:
            journal.record(SAGA, self.id, op=op, **attrs)

    @handler
    async def _handle_start(self, msg: StartSaga, ctx: AppData) -> SagaStatusReply:
        """Idempotent start: a retried StartSaga on a live (or finished)
        saga reports its state instead of restarting it. Runs the chain
        to a terminal state before replying when it can — the resume
        reminder covers every crash in between."""
        rec = self.record
        if rec.status == "idle":
            rec.saga_id = self.id
            rec.steps = list(msg.steps)
            rec.status = "running"
            wire = outbound_ctx()
            if wire is not None:
                # One saga = one trace tree: resumes re-adopt these ids,
                # so post-crash spans join the original waterfall.
                rec.trace_id, rec.span_id = wire[0], wire[1]
            await self.save_state(ctx)
            from ..reminders import ReminderStorage

            if ctx.try_get(ReminderStorage) is not None:
                await self.register_reminder(ctx, RESUME_REMINDER, 2.0)
            self._journal(ctx, "start", steps=len(rec.steps))
            await self._advance(ctx)
        return self._reply()

    @handler
    async def _handle_status(self, msg: SagaStatus, ctx: AppData) -> SagaStatusReply:  # noqa: ARG002
        return self._reply()

    def _reply(self) -> SagaStatusReply:
        rec = self.record
        return SagaStatusReply(
            status=rec.status,
            current=rec.current,
            total=len(rec.steps),
            error=rec.error,
            trace_id=rec.trace_id,
        )

    async def receive_reminder(self, fired, ctx: AppData) -> None:
        if fired.name != RESUME_REMINDER:
            return
        rec = self.record
        if rec.status in ("running", "compensating"):
            self._journal(ctx, "resume", status=rec.status, step=rec.current)
            await self._advance(ctx)
        else:
            # Terminal (or a stale reminder that outlived its saga):
            # stop ticking.
            await self.unregister_reminder(ctx, RESUME_REMINDER)

    # ------------------------------------------------------------------

    async def _advance(self, ctx: AppData) -> None:
        """Drive the chain from the persisted position to a terminal
        state, persisting BEFORE every send. Transport-level step
        failures leave the position unchanged and return — the resume
        reminder retries (participant dedup absorbs the re-send)."""
        rec = self.record
        token = adopt((rec.trace_id, rec.span_id, True)) if rec.trace_id else None
        try:
            while rec.status == "running":
                if rec.current >= len(rec.steps):
                    rec.status = "completed"
                    await self.save_state(ctx)
                    await self._finish(ctx)
                    return
                row = rec.steps[rec.current]
                self._journal(
                    ctx, "step", step=rec.current,
                    target=f"{row[_HT]}/{row[_HID]}", msg=row[_ATY],
                )
                try:
                    await self._send_step(ctx, rec.current, row, "action")
                except Exception as e:  # noqa: BLE001 — triaged below
                    if _is_rejection(e):
                        # The participant ran and said no (typed app error
                        # or NOT_SUPPORTED): undo what completed.
                        rec.error = f"{type(e).__name__}: {e}"
                        rec.compensate_from = rec.current - 1
                        rec.status = "compensating"
                        await self.save_state(ctx)
                        self._journal(
                            ctx, "compensating", step=rec.current,
                            error=rec.error[:120],
                        )
                        continue
                    # Outcome unknown (owner unreachable, timeout): same
                    # step re-sends on the next resume tick.
                    self._journal(
                        ctx, "step_retry", step=rec.current, error=repr(e)[:120]
                    )
                    return
                rec.current += 1
                await self.save_state(ctx)
            while rec.status == "compensating":
                i = rec.compensate_from
                if i < 0:
                    rec.status = "compensated"
                    await self.save_state(ctx)
                    await self._finish(ctx)
                    return
                row = rec.steps[i]
                if row[_CTY]:
                    self._journal(
                        ctx, "compensate", step=i,
                        target=f"{row[_HT]}/{row[_HID]}", msg=row[_CTY],
                    )
                    try:
                        await self._send_step(ctx, i, row, "compensate")
                    except Exception as e:  # noqa: BLE001 — retry until it lands
                        # Compensations must land: park and let the
                        # resume reminder retry until they do.
                        self._journal(
                            ctx, "compensate_retry", step=i, error=repr(e)[:120]
                        )
                        return
                rec.compensate_from -= 1
                await self.save_state(ctx)
        finally:
            release(token)

    async def _send_step(self, ctx: AppData, index: int, row: list, kind: str) -> None:
        """Deliver one step, local-first (same pattern as the stream
        cursor): a participant seated HERE — or unseated, which the
        internal path self-assigns beside its coordinator — never touches
        TCP; a Redirect falls back to the cluster client. Both legs stamp
        the coordinator→participant edge into the affinity sampler. Error
        shapes are identical on both paths (``_is_rejection`` triages
        them), so retry/compensate semantics are unchanged."""
        mtype = row[_ATY] if kind == "action" else row[_CTY]
        payload = row[_APL] if kind == "action" else row[_CPL]
        step = SagaStep(
            saga_id=self.id,
            step=index,
            kind=kind,
            message_type=mtype,
            payload=bytes(payload),
        )
        src = f"{SAGA_TYPE}.{self.id}"
        try:
            with sending_from(src):
                await ServiceObject.send(ctx, row[_HT], row[_HID], step)
            return
        except HandlerError as e:
            if not str(e).startswith("REDIRECT"):
                raise
        await self._delivery_client(ctx).send(row[_HT], row[_HID], step)
        sampler = ctx.try_get(EdgeSampler)
        if sampler is not None:
            # Remote leg: stamped sender-side (source never rides the wire).
            sampler.observe(
                src, f"{row[_HT]}.{row[_HID]}", len(step.payload), False
            )

    async def _finish(self, ctx: AppData) -> None:
        self._journal(ctx, self.record.status, steps=len(self.record.steps))
        from ..reminders import ReminderStorage

        if ctx.try_get(ReminderStorage) is not None:
            await self.unregister_reminder(ctx, RESUME_REMINDER)


def _is_rejection(e: Exception) -> bool:
    """True when the participant RAN and rejected the step (→ compensate);
    False when the outcome is unknown (→ re-send the same step later, the
    dedup ledger absorbs duplicates).

    ``Client.send`` surfaces participant verdicts two ways: registered
    application error classes re-raised directly (always a rejection),
    and :class:`HandlerError` wrapping a wire error kind — where only the
    routing/transport kinds mean "unknown outcome". OSError/timeout are
    pure transport.
    """
    if isinstance(e, (OSError, asyncio.TimeoutError)):
        return False
    if not isinstance(e, HandlerError):
        return True
    text = str(e)
    return not any(
        text.startswith(k) for k in ("REDIRECT", "DEALLOCATE", "SERVER_BUSY", "UNKNOWN")
    )
