"""Request QoS: tenants, priorities, deadlines, weighted-fair dispatch.

Until this subsystem, every request was equal — overload control was one
binary SERVER_BUSY shed (rio_tpu_torch/load) with no notion of *who* is asking or
*how long* the answer is still useful. Orleans-style virtual-actor meshes
put an admission/scheduling layer exactly here, between frame decode and
handler dispatch; this module is that layer for both transports.

Three mechanisms compose (each independently optional via config):

* **Per-tenant token-bucket admission** — a flooding tenant is shed at the
  door with the existing retryable ``SERVER_BUSY`` machinery before its
  requests consume queue slots, let alone handler time.
* **Weighted-fair dispatch** — priority-0 requests queue per tenant; a
  stride scheduler grants handler *starts* across tenants in proportion to
  configured weights, so a bulk tenant's backlog cannot starve anyone.
  Requests with ``priority > 0`` sit in strict tiers ABOVE the fair ring:
  a higher tier always dispatches first (interactive traffic overtakes
  queued bulk work, never the reverse).
* **Deadline shedding** — a request whose remaining ``deadline_ms`` budget
  expired while queued is answered with the retryable ``DEADLINE_EXCEEDED``
  error *without running the handler*: the caller already gave up, so
  burning handler time on it only delays requests that are still wanted.

The scheduler reorders handler STARTS only. Per-connection FIFO response
order — the wire contract both transports implement with done-callback
flushes — is untouched: a delayed start just means that connection's
response future resolves later, exactly like a slow handler.

The whole fast path (uniform traffic, no queuing) is a few dict lookups
and integer compares per request; ``bench.py --qos`` pins the A/B overhead
contract (≤ 2% uniform, ≥ 3x interactive p99 under a bulk flood).
"""

from __future__ import annotations

import time
from collections import deque
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass, field

from ..protocol import RequestEnvelope, ResponseEnvelope, ResponseError

__all__ = [
    "QosConfig",
    "QosScheduler",
    "QosStats",
    "current_scope",
    "detach_scope",
    "remaining_budget_ms",
    "request_scope",
    "scope_budget_ms",
]

# Class labels: strict tiers are "p<priority>"; the weighted-fair ring is
# one class. Interactive == any strict tier (priority >= 1) — the label the
# autoscaler's optional pressure term and the RED rows key on.
FAIR_CLASS = "fair"


def class_of(priority: int) -> str:
    return f"p{priority}" if priority > 0 else FAIR_CLASS


def remaining_budget_ms(deadline_ms: int, elapsed_s: float) -> int:
    """Budget left after ``elapsed_s`` seconds, for hop propagation.

    Returns 0 when the budget is spent (callers answer DEADLINE_EXCEEDED
    instead of forwarding) and never *invents* budget: a positive input
    decrements to at least 1 only while genuinely unexpired.
    """
    if deadline_ms <= 0:
        return deadline_ms
    left = deadline_ms - int(elapsed_s * 1000.0)
    return left if left > 0 else 0


# -- request scope (deadline/classification propagation across hops) ---------
#
# ``QosScheduler.run`` sets the current request's (tenant, priority,
# monotonic deadline expiry) here for the duration of the handler call.
# Internal hops — ``ServiceObject.send`` enqueues, the delivery Client of a
# stream cursor, a saga step's send — read the scope at *their* send point
# and forward the classification plus the REMAINING budget, so every hop
# arrives with a strictly smaller deadline and an expired budget is refused
# at the earliest hop instead of fanning out doomed work.
#
# Contextvars copy into tasks at creation time: a LONG-LIVED task spawned
# from inside a handler (a stream pump loop, a saga executor) would inherit
# that one request's deadline forever — call :func:`detach_scope` at the top
# of such loops.

_SCOPE: ContextVar[tuple[str, int, float]] = ContextVar(
    "rio_qos_scope", default=("", 0, 0.0)
)


def current_scope() -> tuple[str, int, float]:
    """``(tenant, priority, deadline_at)`` of the request being handled.

    ``deadline_at`` is a ``time.monotonic`` expiry; ``0.0`` means no
    deadline. Empty scope is ``("", 0, 0.0)``.
    """
    return _SCOPE.get()


def scope_budget_ms(now: float | None = None) -> int:
    """Remaining deadline budget of the current scope, in milliseconds.

    ``0`` = no deadline in scope; ``-1`` = scope deadline already spent
    (the caller must answer/raise DEADLINE_EXCEEDED, never forward);
    positive = forward this (strictly decremented, floor 1 ms while
    genuinely unexpired).
    """
    deadline_at = _SCOPE.get()[2]
    if deadline_at <= 0.0:
        return 0
    left_s = deadline_at - (time.monotonic() if now is None else now)
    if left_s <= 0.0:
        return -1
    return max(1, int(left_s * 1000.0))


def detach_scope() -> None:
    """Clear the inherited request scope in a long-lived background task."""
    _SCOPE.set(("", 0, 0.0))


@contextmanager
def request_scope(tenant: str, priority: int, deadline_at: float):
    """Install a request scope around a dispatch that bypasses the
    scheduler (the server's internal-send consumer replays commands from
    its own task context, so the sender's scope dies at the queue boundary
    and must be re-installed from the :class:`SendCommand` snapshot)."""
    token = _SCOPE.set((tenant, priority, deadline_at))
    try:
        yield
    finally:
        _SCOPE.reset(token)


@dataclass
class QosConfig:
    """Tuning for one node's :class:`QosScheduler`.

    Defaults are deliberately benign: no tenant rate limits, equal weights,
    a concurrency cap matching the per-connection handler cap of both
    transports, and queues deep enough that uniform traffic never queues.
    """

    # Node-wide concurrent handler starts the scheduler will grant. Beyond
    # it, requests wait in their class queue (the per-connection transports
    # additionally cap at 64 in-flight each, unchanged). Unclassified
    # requests on an otherwise idle node bypass slot accounting entirely
    # (the zero-wrapper fast path); the cap governs classified traffic and
    # any traffic once classified holders or a queue are present.
    max_concurrent: int = 64
    # Bounded per-class queue depth; a full queue sheds with SERVER_BUSY
    # (retryable) rather than growing server memory.
    max_queue: int = 256
    # Weighted-fair ring: dispatch weight per tenant (higher = more starts
    # per unit time under contention). Unlisted tenants get default_weight.
    tenant_weights: dict[str, float] = field(default_factory=dict)
    default_weight: float = 1.0
    # Token-bucket admission, tokens/second + burst, per tenant. A tenant
    # absent from tenant_rates uses (default_rate, default_burst);
    # rate <= 0 disables admission limiting for that tenant.
    tenant_rates: dict[str, tuple[float, float]] = field(default_factory=dict)
    default_rate: float = 0.0
    default_burst: float = 0.0


@dataclass
class QosStats:
    """Cumulative node counters (flattened into ``rio.qos.*`` gauges)."""

    admitted: int = 0
    sheds: int = 0  # token-bucket + queue-full admission sheds
    deadline_drops: int = 0  # expired before handler start (doomed work)
    interactive_admitted: int = 0
    interactive_sheds: int = 0


class _Bucket:
    """Token bucket; refilled lazily on each take."""

    __slots__ = ("rate", "burst", "tokens", "last")

    def __init__(self, rate: float, burst: float, now: float) -> None:
        self.rate = rate
        self.burst = max(burst, 1.0)
        self.tokens = self.burst
        self.last = now

    def take(self, now: float) -> bool:
        if now > self.last:
            self.tokens = min(self.burst, self.tokens + (now - self.last) * self.rate)
            self.last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class _Waiter:
    """One parked request awaiting a handler-start grant."""

    __slots__ = ("fut", "env", "deadline_at", "enq_at")

    def __init__(self, fut, env, deadline_at: float, enq_at: float) -> None:
        self.fut = fut
        self.env = env
        self.deadline_at = deadline_at  # monotonic expiry; 0.0 = none
        self.enq_at = enq_at


class QosScheduler:
    """Admission + handler-start scheduling for one server node.

    Loop-affine like every other per-node subsystem: both transports call
    it only from the server's event loop, so there are no locks. ``admit``
    is the synchronous front door (token bucket, queue caps, deadline
    stamping); ``run`` wraps the handler call with a start grant and the
    per-(tenant, class) RED bookkeeping.
    """

    def __init__(self, config: QosConfig | None = None, *, clock=time.monotonic) -> None:
        self.config = config or QosConfig()
        self._clock = clock
        self._stats = QosStats()
        # Unclassified fast-path requests bump ONLY this accumulator per
        # request; the ``stats`` property folds it into ``admitted`` and
        # the ("", "fair") RED row on read, keeping the hot path at one
        # integer add.
        self._fast_n = 0
        self._running = 0
        self._queued = 0
        # Strict tiers: priority -> FIFO of waiters (descending pick).
        self._tiers: dict[int, deque[_Waiter]] = {}
        # Weighted-fair ring: tenant -> FIFO + stride virtual time.
        self._fair: dict[str, deque[_Waiter]] = {}
        self._vtime: dict[str, float] = {}
        self._vclock = 0.0  # vtime of the last fair grant (re-arrival clamp)
        self._buckets: dict[str, _Bucket] = {}
        # RED rows: (tenant, class) -> [requests, errors, duration_ms_sum,
        # queue_wait_ms_sum, sheds, deadline_drops, timed_samples].
        # duration/queue-wait are averaged over timed_samples: the
        # unclassified fast path times on a 1-in-8 stride (the same
        # discipline as the service layer's RED histograms) while the
        # classified path times every request.
        self._red: dict[tuple[str, str], list[float]] = {}
        self._fast_red: list[float] | None = None  # ("", "fair") row cache
        self._tick = -1  # fast-path timing stride
        # Hoisted per-request constants for the unclassified fast path.
        self._fast_ok = self.config.default_rate <= 0.0
        self._max_concurrent = self.config.max_concurrent

    # -- admission (synchronous, transport dispatch loop) -------------------

    @property
    def stats(self) -> QosStats:
        """Cumulative counters; folds the fast-path accumulator on read."""
        n = self._fast_n
        if n:
            self._fast_n = 0
            self._stats.admitted += n
            row = self._fast_red
            if row is None:
                row = self._fast_red = self._red_row("", FAIR_CLASS)
            row[0] += n
        return self._stats

    def _red_row(self, tenant: str, cls: str) -> list[float]:
        row = self._red.get((tenant, cls))
        if row is None:
            row = [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]
            self._red[(tenant, cls)] = row
        return row

    def _bucket_for(self, tenant: str, now: float) -> _Bucket | None:
        b = self._buckets.get(tenant)
        if b is None:
            rate, burst = self.config.tenant_rates.get(
                tenant, (self.config.default_rate, self.config.default_burst)
            )
            if rate <= 0:
                return None
            b = _Bucket(rate, burst, now)
            self._buckets[tenant] = b
        return b

    def dispatch(self, call, env: RequestEnvelope):
        """Admission + start grant in ONE synchronous step — the transports'
        request entry point. Returns either a :class:`ResponseError` (shed;
        the handler never starts and the transport pushes it through the
        ordinary FIFO response path) or an awaitable resolving to the
        handler's response.

        Folding admission and grant into one call is what makes the
        unclassified fast path nearly free (the bench.py --qos ≤ 2% bar):
        no marker attribute, no second method call, and 7 of 8 dispatches
        hand back the BARE handler coroutine — zero wrapper frames.
        ``admit`` + ``run`` remain as the two-step form of the same
        machine for callers that need a window between verdict and start.
        """
        if (
            self._fast_ok
            and not env.tenant
            and env.priority == 0
            and env.deadline_ms == 0
            and self._queued == 0
            and self._running < self._max_concurrent
        ):
            self._fast_n += 1
            self._tick = tick = (self._tick + 1) & 7
            if tick:
                return call(env)
            row = self._fast_red
            if row is None:
                row = self._fast_red = self._red_row("", FAIR_CLASS)
            return self._run_fast_timed(call, env, row)
        verdict = self._admit_slow(env)
        if verdict is not None:
            return verdict
        return self._run_classified(call, env)

    def admit(self, env: RequestEnvelope) -> ResponseError | None:
        """Admission verdict for one decoded request; ``None`` = admitted.

        A non-None return is the complete response error (retryable): the
        transport pushes it through the ordinary FIFO response path without
        creating a handler task. Admitted envelopes are stamped with their
        monotonic deadline (``_qos_deadline``) so queue wait counts against
        the budget.
        """
        if (
            self._fast_ok
            and not env.tenant
            and env.priority == 0
            and env.deadline_ms == 0
            and self._queued == 0
            and self._running < self._max_concurrent
        ):
            # Unclassified fast path (the uniform-traffic common case): no
            # bucket to charge, no deadline to stamp, no queue that could
            # be full — admission is one counter. ``run`` pairs with this
            # via the ``_qos_fast`` marker.
            self._fast_n += 1
            env._qos_fast = True
            return None
        return self._admit_slow(env)

    def _admit_slow(self, env: RequestEnvelope) -> ResponseError | None:
        now = self._clock()
        tenant = env.tenant
        cls = class_of(env.priority)
        bucket = self._bucket_for(tenant, now)
        if bucket is not None and not bucket.take(now):
            self.stats.sheds += 1
            if cls != FAIR_CLASS:
                self.stats.interactive_sheds += 1
            self._red_row(tenant, cls)[4] += 1
            return ResponseError.server_busy(
                f"qos: tenant {tenant or 'default'!r} over admission rate"
            )
        if self._queue_depth(env.priority, tenant) >= self.config.max_queue:
            self.stats.sheds += 1
            if cls != FAIR_CLASS:
                self.stats.interactive_sheds += 1
            self._red_row(tenant, cls)[4] += 1
            return ResponseError.server_busy(f"qos: {cls} queue full")
        self.stats.admitted += 1
        if cls != FAIR_CLASS:
            self.stats.interactive_admitted += 1
        env._qos_deadline = (
            now + env.deadline_ms / 1000.0 if env.deadline_ms > 0 else 0.0
        )
        env._qos_admitted = now
        return None

    def _queue_depth(self, priority: int, tenant: str) -> int:
        if priority > 0:
            q = self._tiers.get(priority)
        else:
            q = self._fair.get(tenant)
        return len(q) if q is not None else 0

    # -- handler-start scheduling -------------------------------------------

    def run(self, call, env: RequestEnvelope):
        """Run ``call(env)`` under a start grant; returns an awaitable
        resolving to its response.

        The grant may resolve to a DEADLINE_EXCEEDED error instead (budget
        expired while parked) — then the handler never runs. Plain ``def``
        on purpose: the transports both ``await`` the result and hand it
        to ``create_task``, and returning the inner coroutine directly
        keeps the uniform fast path one coroutine deep instead of two.
        """
        if env.__dict__.pop("_qos_fast", False):
            # Unclassified traffic on an uncontended node is invisible to
            # the scheduler BY DESIGN: no slot accounting, no scope (the
            # ambient contextvar default is already the empty scope), and
            # 7 of 8 requests hand back the bare handler coroutine — zero
            # wrapper frames. Its only backpressure is the transports'
            # per-connection in-flight caps; the moment classified holders
            # fill the slots or a queue forms, admit/dispatch demote
            # unclassified requests to the full grant path and every
            # guarantee applies.
            if self._queued == 0:
                self._tick = tick = (self._tick + 1) & 7
                if tick:
                    return call(env)
                row = self._fast_red
                if row is None:
                    row = self._fast_red = self._red_row("", FAIR_CLASS)
                return self._run_fast_timed(call, env, row)
            # A queue appeared between admit and dispatch: re-book the
            # admit as classified so the fast accumulator stays exact,
            # then take the full grant path (park in the fair ring like
            # any other unclassified request).
            self._fast_n -= 1
            self._stats.admitted += 1
        return self._run_classified(call, env)

    async def _run_classified(self, call, env: RequestEnvelope):
        verdict = self._try_start(env)
        if verdict is None and not self._granted(env):
            verdict = await self._park(env)
        if verdict is not None:
            return ResponseEnvelope.err(verdict)
        tenant, cls = env.tenant, class_of(env.priority)
        now = self._clock()
        admitted = getattr(env, "_qos_admitted", now)
        wait_ms = (now - admitted) * 1000.0
        ph = getattr(env, "_phases", None)
        if ph is not None:
            ph.handler_start = time.perf_counter()
            attrs = ph.attrs
            if attrs is None:
                attrs = ph.attrs = {}
            attrs["qos.class"] = cls
            if tenant:
                attrs["qos.tenant"] = tenant
            attrs["qos.queue_ms"] = round(wait_ms, 3)
        row = self._red_row(tenant, cls)
        row[0] += 1
        row[3] += wait_ms
        row[6] += 1  # classified requests are always timed samples
        t0 = now
        # Scope the handler: internal hops it performs (ServiceObject.send,
        # a delivery Client, a proxy forward) read this to decrement and
        # forward the remaining budget plus the tenant/priority class.
        token = _SCOPE.set(
            (tenant, env.priority, getattr(env, "_qos_deadline", 0.0))
        )
        try:
            resp = await call(env)
            if resp.error is not None:
                row[1] += 1
            return resp
        except BaseException:
            row[1] += 1
            raise
        finally:
            _SCOPE.reset(token)
            row[2] += (self._clock() - t0) * 1000.0
            self._release()

    async def _run_fast_timed(self, call, env: RequestEnvelope, row):
        """The 1-in-8 timed sample of the unclassified fast path: the only
        wrapper it ever pays, and the only place its durations and errors
        are recorded (sampled RED, the service layer's stride discipline)."""
        row[6] += 1
        t0 = self._clock()
        try:
            resp = await call(env)
            if resp.error is not None:
                row[1] += 1
            return resp
        except BaseException:
            row[1] += 1
            raise
        finally:
            row[2] += (self._clock() - t0) * 1000.0

    def _granted(self, env: RequestEnvelope) -> bool:
        return getattr(env, "_qos_granted", False)

    def _try_start(self, env: RequestEnvelope) -> ResponseError | None:
        """Fast path: grant immediately when nothing is parked and a slot
        is free; otherwise None with the envelope left ungranted (caller
        parks). An already-expired budget sheds here — before queuing."""
        deadline_at = getattr(env, "_qos_deadline", 0.0)
        if deadline_at and self._clock() >= deadline_at:
            return self._drop_expired(env.tenant, class_of(env.priority))
        if self._queued == 0 and self._running < self.config.max_concurrent:
            self._running += 1
            env._qos_granted = True
        return None

    def _drop_expired(self, tenant: str, cls: str) -> ResponseError:
        self.stats.deadline_drops += 1
        self._red_row(tenant, cls)[5] += 1
        return ResponseError.deadline_exceeded(
            "qos: deadline budget expired before handler start"
        )

    async def _park(self, env: RequestEnvelope) -> ResponseError | None:
        import asyncio

        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        w = _Waiter(fut, env, getattr(env, "_qos_deadline", 0.0), self._clock())
        if env.priority > 0:
            self._tiers.setdefault(env.priority, deque()).append(w)
        else:
            q = self._fair.setdefault(env.tenant, deque())
            if not q:
                # Re-arrival clamp: an idle tenant must not bank vtime while
                # away and then monopolize grants — it rejoins at the ring's
                # current clock (standard stride-scheduler hygiene).
                self._vtime[env.tenant] = max(
                    self._vtime.get(env.tenant, 0.0), self._vclock
                )
            q.append(w)
        self._queued += 1
        self._pump()
        try:
            return await fut
        except asyncio.CancelledError:
            # Transport shutdown cancels pending handler tasks; forget the
            # waiter so the pump never grants a dead future a slot.
            self._forget(w)
            raise

    def _forget(self, w: _Waiter) -> None:
        if w.env.priority > 0:
            q = self._tiers.get(w.env.priority)
        else:
            q = self._fair.get(w.env.tenant)
        if q is not None:
            try:
                q.remove(w)
                self._queued -= 1
            except ValueError:
                pass  # already granted/dropped by the pump

    def _release(self) -> None:
        self._running -= 1
        if self._queued:
            self._pump()

    def _pump(self) -> None:
        """Grant parked waiters while slots are free: strict tiers first
        (highest priority), then the stride-scheduled fair ring. Expired
        waiters resolve to DEADLINE_EXCEEDED without taking a slot."""
        while self._queued and self._running < self.config.max_concurrent:
            w = self._next_waiter()
            if w is None:
                return
            self._queued -= 1
            if w.fut.done():  # cancelled waiter still enqueued
                continue
            if w.deadline_at and self._clock() >= w.deadline_at:
                w.fut.set_result(
                    self._drop_expired(w.env.tenant, class_of(w.env.priority))
                )
                continue
            self._running += 1
            w.env._qos_granted = True
            w.fut.set_result(None)

    def _next_waiter(self) -> _Waiter | None:
        if self._tiers:
            for pri in sorted(self._tiers, reverse=True):
                q = self._tiers[pri]
                if q:
                    return q.popleft()
                del self._tiers[pri]  # fall through to the fair ring
        best_tenant: str | None = None
        best_v = 0.0
        for tenant, q in self._fair.items():
            if not q:
                continue
            v = self._vtime.get(tenant, 0.0)
            if best_tenant is None or v < best_v:
                best_tenant, best_v = tenant, v
        if best_tenant is None:
            return None
        weight = self.config.tenant_weights.get(best_tenant, self.config.default_weight)
        self._vtime[best_tenant] = best_v + 1.0 / max(weight, 1e-9)
        self._vclock = best_v
        return self._fair[best_tenant].popleft()

    # -- observability -------------------------------------------------------

    @property
    def running(self) -> int:
        return self._running

    @property
    def queued(self) -> int:
        return self._queued

    def queue_depths(self) -> dict[str, int]:
        depths: dict[str, int] = {}
        for pri, q in self._tiers.items():
            if q:
                depths[f"p{pri}"] = len(q)
        fair = sum(len(q) for q in self._fair.values())
        if fair:
            depths[FAIR_CLASS] = fair
        return depths

    def gauges(self) -> dict[str, float]:
        s = self.stats
        return {
            "rio.qos.running": float(self._running),
            "rio.qos.queued": float(self._queued),
            "rio.qos.admitted": float(s.admitted),
            "rio.qos.sheds": float(s.sheds),
            "rio.qos.deadline_drops": float(s.deadline_drops),
            "rio.qos.interactive_admitted": float(s.interactive_admitted),
            "rio.qos.interactive_sheds": float(s.interactive_sheds),
        }

    def tenant_rows(self) -> list[list]:
        """Per-(tenant, class) RED rows for DUMP_QOS, stable order:
        ``[tenant, class, requests, errors, avg_ms, avg_queue_ms, sheds,
        deadline_drops]``."""
        _ = self.stats  # fold the fast-path accumulator into its RED row
        rows = []
        for (tenant, cls), r in sorted(self._red.items()):
            # Averages divide by TIMED samples, not raw requests: the
            # unclassified fast path only times a 1-in-8 stride.
            n = r[6] or 1.0
            rows.append(
                [
                    tenant,
                    cls,
                    int(r[0]),
                    int(r[1]),
                    round(r[2] / n, 3),
                    round(r[3] / n, 3),
                    int(r[4]),
                    int(r[5]),
                ]
            )
        return rows
