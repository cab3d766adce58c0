"""Deterministic fault injection for the control plane and the transport.

Every subsystem (gossip, placement daemon, reminders, migration,
replication, read scale-out) leans on the shared rendezvous — the
``MembershipStorage``/``ObjectPlacement``/``ReminderStorage`` traits — and
on the framed TCP transport. This module injects failures at exactly those
two seams, so chaos coverage is *scripted and replayable* instead of
ad-hoc per-test process kills:

* **Storage faults** — :class:`FaultyMembershipStorage`,
  :class:`FaultyObjectPlacement`, :class:`FaultyReminderStorage` and
  :class:`FaultyStreamStorage` wrap
  any concrete backend and consult one :class:`FaultSchedule` before every
  delegated call: seeded error rates, added latency, park-until-heal
  hangs, and scripted total outages (``fail_all()`` / ``heal()`` or
  elapsed-time :class:`OutageWindow` s).
* **Transport faults** — :class:`TransportFaults` drops, delays or resets
  connects and frames per ``(src, dst)`` pair. Rules are directional, so
  asymmetric partitions (A cannot reach B while B reaches A and both reach
  storage) are one ``partition(src, dst)`` call. The client and the gossip
  provider accept a ``transport_faults`` handle and route their dials and
  pings through it.

Determinism: one ``random.Random(seed)`` per schedule; the same seed and
the same call sequence replay the same fault pattern. Nothing here touches
wall clocks for decisions (outage windows run on a monotonic clock started
at first use, or on an injected ``clock`` for tests).

Observability: injections and outage edges journal ``FAULT`` events;
degraded-mode transitions in the hardened subsystems journal ``STORAGE``
events; :class:`StorageHealth` aggregates ``rio.storage.*`` error/latency
gauges picked up by ``otel.server_gauges`` and watched by the
``storage_errors`` HealthWatch default rule.

The wrappers are **pass-through at rest**: with no rules, no windows and
no scripted outage, ``perturb`` is a couple of attribute reads — measured
at parity by ``bench.py --faults`` (paired A/B, see
``rio_tpu_torch/utils/faults_live.py``).

Demo / CI smoke::

    python -m rio_tpu_torch.faults --demo
"""

from __future__ import annotations

import asyncio
import dataclasses
import fnmatch
import inspect
import random
import time
import weakref
from typing import Any, Callable, Iterable

from .errors import RioError
from .journal import FAULT, Journal

__all__ = [
    "InjectedFault",
    "FaultRule",
    "OutageWindow",
    "FaultSchedule",
    "StorageHealth",
    "StorageResilienceConfig",
    "FaultyMembershipStorage",
    "FaultyObjectPlacement",
    "FaultyReminderStorage",
    "LinkRule",
    "TransportFaults",
]


class InjectedFault(RioError):
    """A fault-injection layer refused the operation.

    Subclasses :class:`~rio_tpu_torch.errors.RioError` (not the storage errors)
    on purpose: the hardened code paths must survive *any* exception from
    a storage call, so injected faults deliberately do not match the typed
    backend errors — a handler that only catches ``MembershipError`` is a
    bug this layer exists to expose.
    """

    def __init__(self, op: str, detail: str = "injected fault"):
        super().__init__(f"{detail} [{op}]")
        self.op = op


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """Seeded per-operation perturbation.

    ``op`` is an ``fnmatch`` pattern over dotted operation names
    (``membership.members``, ``placement.lookup``, ``reminders.due`` …) —
    ``"membership.*"`` matches a whole trait, ``"*"`` everything.
    """

    op: str = "*"
    error_rate: float = 0.0  # P(raise InjectedFault) per call
    latency: float = 0.0  # seconds added before the call
    jitter: float = 0.0  # extra uniform(0, jitter) seconds
    hang: bool = False  # park the call until the schedule heals


@dataclasses.dataclass(frozen=True)
class OutageWindow:
    """Total outage for ``op`` between ``start`` and ``end`` seconds on the
    schedule's clock (first ``perturb``/``start()`` is t=0)."""

    start: float
    end: float
    op: str = "*"
    hang: bool = False  # park instead of raising while inside the window


class FaultSchedule:
    """One seeded, scripted source of fault decisions.

    Shared by any number of storage wrappers; ``fail_all()``/``heal()``
    script total outages from tests and soaks, :class:`FaultRule` s add
    seeded noise, :class:`OutageWindow` s script time-based outages.
    ``enabled=False`` (or ``FaultSchedule()`` with nothing configured)
    makes every gate a no-op — the disabled-overhead contract.
    """

    def __init__(
        self,
        seed: int = 0,
        rules: Iterable[FaultRule] = (),
        outages: Iterable[OutageWindow] = (),
        clock: Callable[[], float] = time.monotonic,
        journal: Journal | None = None,
    ) -> None:
        self.seed = seed
        self._rng = random.Random(seed)
        self.rules: list[FaultRule] = list(rules)
        self.outages: list[OutageWindow] = list(outages)
        self._clock = clock
        self._t0: float | None = None
        self._enabled = True
        self.journal = journal
        # Scripted total outages: op pattern -> hang?
        self._down: dict[str, bool] = {}
        self._heal_event: asyncio.Event | None = None
        # Wrappers to re-arm when `enabled` flips (weakrefs: a schedule
        # outliving its wrappers must not pin them).
        self._wrappers: list[weakref.ref] = []
        # Counters (surface through gauges()).
        self.ops = 0
        self.injected_errors = 0
        self.injected_delays = 0
        self.injected_hangs = 0

    @property
    def enabled(self) -> bool:
        return self._enabled

    @enabled.setter
    def enabled(self, value: bool) -> None:
        """Flipping ``enabled`` re-arms every attached wrapper: disabled
        wrappers swap the inner backend's bound methods onto themselves
        (zero-cost passthrough — the disabled-overhead contract that
        ``bench.py --faults`` measures), enabling restores the gates."""
        self._enabled = bool(value)
        alive: list[weakref.ref] = []
        for ref in self._wrappers:
            w = ref()
            if w is not None:
                w._rearm()
                alive.append(ref)
        self._wrappers = alive

    def _register(self, wrapper: Any) -> None:
        self._wrappers.append(weakref.ref(wrapper))

    # -- scripting -----------------------------------------------------------

    def start(self) -> None:
        """Pin t=0 for :class:`OutageWindow` matching (idempotent)."""
        if self._t0 is None:
            self._t0 = self._clock()

    @property
    def elapsed(self) -> float:
        if self._t0 is None:
            return 0.0
        return self._clock() - self._t0

    def fail_all(self, op: str = "*", *, hang: bool = False) -> None:
        """Scripted total outage for every operation matching ``op``."""
        self._down[op] = hang
        self._journal_edge("fail_all", op, hang=hang)

    def heal(self, op: str | None = None) -> None:
        """End scripted outages (all of them, or just pattern ``op``) and
        wake every parked hang."""
        if op is None:
            self._down.clear()
        else:
            self._down.pop(op, None)
        ev = self._heal_event
        if ev is not None:
            self._heal_event = None
            ev.set()
        self._journal_edge("heal", op or "*")

    def is_down(self, op: str) -> bool:
        if self._down and any(fnmatch.fnmatch(op, p) for p in self._down):
            return True
        if self.outages:
            t = self.elapsed
            return any(
                w.start <= t < w.end and fnmatch.fnmatch(op, w.op)
                for w in self.outages
            )
        return False

    def _journal_edge(self, action: str, op: str, **attrs: Any) -> None:
        if self.journal is not None:
            self.journal.record(FAULT, op, action=action, **attrs)

    # -- decisions -----------------------------------------------------------

    @property
    def idle(self) -> bool:
        """True when no rule, outage, or scripted failure could possibly
        fire — the wrappers skip the whole ``perturb`` coroutine then, so
        an installed-but-unconfigured schedule stays off the hot path (the
        service layer reads the directory per request; ``bench.py
        --faults`` prices this gate)."""
        return not self.enabled or not (self.rules or self.outages or self._down)

    def decide(self, op: str) -> tuple[float, bool, bool]:
        """``(delay_seconds, fail, hang)`` for one call — sync and seeded,
        so wire-level fakes (``tests/fake_pg.py``) share the decisions."""
        if not self.enabled:
            return (0.0, False, False)
        self.ops += 1
        if self._t0 is None and self.outages:
            self._t0 = self._clock()
        for pattern, hang in self._down.items():
            if fnmatch.fnmatch(op, pattern):
                return (0.0, not hang, hang)
        if self.outages:
            t = self.elapsed
            for w in self.outages:
                if w.start <= t < w.end and fnmatch.fnmatch(op, w.op):
                    return (0.0, not w.hang, w.hang)
        delay = 0.0
        fail = False
        hang = False
        for rule in self.rules:
            if not fnmatch.fnmatch(op, rule.op):
                continue
            if rule.latency or rule.jitter:
                delay += rule.latency
                if rule.jitter:
                    delay += self._rng.uniform(0.0, rule.jitter)
            if rule.error_rate and self._rng.random() < rule.error_rate:
                fail = True
            if rule.hang:
                hang = True
        return (delay, fail, hang)

    async def perturb(self, op: str) -> None:
        """Async gate: sleep injected latency, park on hang (until
        :meth:`heal`), raise :class:`InjectedFault` on an injected error."""
        delay, fail, hang = self.decide(op)
        if delay > 0.0:
            self.injected_delays += 1
            await asyncio.sleep(delay)
        if hang:
            self.injected_hangs += 1
            if self._heal_event is None:
                self._heal_event = asyncio.Event()
            await self._heal_event.wait()
            return
        if fail:
            self.injected_errors += 1
            if self.injected_errors == 1:
                self._journal_edge("inject", op)
            raise InjectedFault(op)

    def apply_sync(self, op: str) -> None:
        """Sync gate for DBAPI-level fakes running in executor threads:
        ``time.sleep`` the latency; a hang verdict degrades to an error
        (threads cannot park on the loop's heal event)."""
        delay, fail, hang = self.decide(op)
        if delay > 0.0:
            self.injected_delays += 1
            time.sleep(delay)
        if fail or hang:
            self.injected_errors += 1
            raise InjectedFault(op)

    def gauges(self) -> dict[str, float]:
        return {
            "rio.faults.ops": float(self.ops),
            "rio.faults.errors": float(self.injected_errors),
            "rio.faults.delays": float(self.injected_delays),
            "rio.faults.hangs": float(self.injected_hangs),
            "rio.faults.down_patterns": float(len(self._down)),
        }


@dataclasses.dataclass
class StorageResilienceConfig:
    """Knobs for the storage-outage degraded modes (AppData-resident).

    ``route_timeout`` bounds the request path's directory awaits — with a
    hung (not erroring) rendezvous the routing block times out and sheds
    with the retryable SERVER_BUSY instead of hanging the request.
    ``None`` keeps the pre-fault unbounded behavior (real backends carry
    their own socket timeouts). The backoff pair seeds the gossip/daemon
    :class:`~rio_tpu_torch.utils.backoff.DecorrelatedJitter` retry sleeps.
    """

    route_timeout: float | None = None
    backoff_base: float = 0.05
    backoff_cap: float = 2.0


class StorageHealth:
    """Node-wide storage health: error/latency counters + degraded flags.

    One instance per server (AppData-resident, like the journal): the
    storage wrappers feed op latency and real backend errors; the hardened
    loops (gossip, service routing, daemons) feed per-source degraded
    transitions — ``note_error``/``note_ok`` return ``True`` exactly on
    the edge, so callers journal one STORAGE event per outage, not one
    per failed call.
    """

    def __init__(self) -> None:
        self.ops = 0
        self.errors = 0
        self.injected = 0
        self.degraded_serves = 0  # seated actors served during an outage
        self.sheds = 0  # unseated requests shed retryably during an outage
        self.last_error = ""
        self.last_error_op = ""
        self._down: set[str] = set()  # sources currently degraded
        self._lat_samples = 0
        self._lat_sum_ms = 0.0
        self._lat_max_ms = 0.0

    # -- wrapper feed --------------------------------------------------------

    def note_op(self, seconds: float | None) -> None:
        """Count one successful op; ``seconds`` feeds the latency gauges
        when the caller timed it (the idle-schedule fast path samples
        1-in-N — see ``_FaultyBase._call`` — so request-path delegation
        doesn't pay two clock reads per call)."""
        self.ops += 1
        if seconds is None:
            return
        self._lat_samples += 1
        ms = seconds * 1e3
        self._lat_sum_ms += ms
        if ms > self._lat_max_ms:
            self._lat_max_ms = ms

    # -- degraded-transition tracking ---------------------------------------

    def note_error(
        self, op: str, exc: BaseException, *, source: str = "", injected: bool = False
    ) -> bool:
        """Count one failed storage call; ``True`` when this flips
        ``source`` from healthy to degraded (the journal-once edge)."""
        self.errors += 1
        if injected:
            self.injected += 1
        self.last_error = repr(exc)[:160]
        self.last_error_op = op
        if not source or source in self._down:
            return False
        self._down.add(source)
        return True

    def note_ok(self, source: str) -> bool:
        """``True`` when ``source`` just recovered from degraded."""
        if source in self._down:
            self._down.discard(source)
            return True
        return False

    @property
    def degraded(self) -> bool:
        return bool(self._down)

    def note_degraded_serve(self) -> None:
        self.degraded_serves += 1

    def note_shed(self) -> None:
        self.sheds += 1

    def gauges(self) -> dict[str, float]:
        avg = self._lat_sum_ms / self._lat_samples if self._lat_samples else 0.0
        return {
            "rio.storage.ops": float(self.ops),
            "rio.storage.errors": float(self.errors),
            "rio.storage.injected": float(self.injected),
            "rio.storage.degraded_serves": float(self.degraded_serves),
            "rio.storage.sheds": float(self.sheds),
            "rio.storage.degraded_sources": float(len(self._down)),
            "rio.storage.op_latency_avg_ms": avg,
            "rio.storage.op_latency_max_ms": self._lat_max_ms,
        }


# ---------------------------------------------------------------------------
# Storage trait wrappers
# ---------------------------------------------------------------------------


class _FaultyBase:
    """Delegating wrapper core: gate → time → delegate → count.

    ``__getattr__`` forwards everything not explicitly wrapped (provider
    extensions like ``sync_members``/``rebalance``/``count`` on concrete
    backends), so a wrapped backend keeps its full duck-typed surface —
    ``hasattr`` probes in the service layer see exactly what the inner
    object offers.
    """

    def __init__(self, inner: Any, schedule: FaultSchedule, health: StorageHealth | None = None) -> None:
        self._inner = inner
        self._schedule = schedule
        self._health = health
        schedule._register(self)
        self._rearm()

    def __getattr__(self, name: str) -> Any:
        return getattr(self._inner, name)

    @classmethod
    def _gated_methods(cls) -> tuple[str, ...]:
        """The trait coroutines this wrapper gates — every public async def
        declared on the Faulty classes themselves (inherited ABC helpers
        like ``set_active`` route through these, so they stay un-swapped)."""
        cached = cls.__dict__.get("_gated_cache")
        if cached is None:
            names: list[str] = []
            for klass in cls.__mro__:
                if klass is _FaultyBase:
                    break
                for name, fn in vars(klass).items():
                    if not name.startswith("_") and inspect.iscoroutinefunction(fn):
                        names.append(name)
            cached = tuple(dict.fromkeys(names))
            cls._gated_cache = cached
        return cached

    def _rearm(self) -> None:
        """Sync the passthrough swap with ``schedule.enabled``.

        Disabled: the inner backend's bound methods are written straight
        onto the instance, shadowing the gated class methods — a disabled
        wrapper costs literally nothing per call (no extra coroutine, no
        counter), which is the parity contract ``bench.py --faults``
        measures. Enabled: the shadows are removed and every call gates
        through ``_call`` again (idle schedules still count ops/health
        there via the inlined fast path).
        """
        if self._schedule.enabled:
            for name in self._gated_methods():
                self.__dict__.pop(name, None)
        else:
            for name in self._gated_methods():
                inner_fn = getattr(self._inner, name, None)
                if inner_fn is not None:
                    self.__dict__[name] = inner_fn

    async def _call(self, op: str, fn: Callable[..., Any], *args: Any, **kw: Any) -> Any:
        s = self._schedule
        if s.enabled and (s.rules or s.outages or s._down):
            # Gated path: something could fire — full perturb + timing.
            try:
                await s.perturb(op)
            except InjectedFault as e:
                if self._health is not None:
                    self._health.note_error(op, e, injected=True)
                raise
            t0 = time.perf_counter()
            try:
                out = await fn(*args, **kw)
            except asyncio.CancelledError:
                raise
            except NotImplementedError:
                raise  # optional trait surface, not a storage failure
            except Exception as e:
                if self._health is not None:
                    self._health.note_error(op, e)
                raise
            if self._health is not None:
                self._health.note_op(time.perf_counter() - t0)
            return out
        # Idle/disabled fast path (the ``decide`` checks inlined — attribute
        # reads, no property or coroutine): real backend errors still feed
        # health, latency is sampled 1-in-16 so the per-request directory
        # lookup doesn't pay two clock reads (``bench.py --faults`` holds
        # this path to parity with unwrapped backends).
        h = self._health
        if h is None:
            return await fn(*args, **kw)
        t0 = time.perf_counter() if (h.ops & 0xF) == 0 else None
        try:
            out = await fn(*args, **kw)
        except asyncio.CancelledError:
            raise
        except NotImplementedError:
            raise  # optional trait surface, not a storage failure
        except Exception as e:
            h.note_error(op, e)
            raise
        h.note_op(None if t0 is None else time.perf_counter() - t0)
        return out


# The wrappers implement the full abstract surface explicitly (so the ABCs
# instantiate) and inherit each trait's default helpers, which route back
# through the gated methods.

from .cluster.storage import Member, MembershipStorage  # noqa: E402
from .object_placement import ObjectPlacement, ObjectPlacementItem  # noqa: E402
from .registry import ObjectId  # noqa: E402
from .reminders import Lease, Reminder, ReminderStorage  # noqa: E402
from .streams import StreamRecord, StreamStorage, Subscription  # noqa: E402


class FaultyMembershipStorage(_FaultyBase, MembershipStorage):
    """``MembershipStorage`` with a :class:`FaultSchedule` at every call."""

    async def prepare(self) -> None:
        return await self._call("membership.prepare", self._inner.prepare)

    async def push(self, member: Member) -> None:
        return await self._call("membership.push", self._inner.push, member)

    async def remove(self, ip: str, port: int) -> None:
        return await self._call("membership.remove", self._inner.remove, ip, port)

    async def set_is_active(self, ip: str, port: int, active: bool) -> None:
        return await self._call(
            "membership.set_is_active", self._inner.set_is_active, ip, port, active
        )

    async def members(self) -> list[Member]:
        return await self._call("membership.members", self._inner.members)

    async def notify_failure(self, ip: str, port: int) -> None:
        return await self._call(
            "membership.notify_failure", self._inner.notify_failure, ip, port
        )

    async def member_failures(self, ip: str, port: int) -> list[float]:
        return await self._call(
            "membership.member_failures", self._inner.member_failures, ip, port
        )


class FaultyObjectPlacement(_FaultyBase, ObjectPlacement):
    """``ObjectPlacement`` with a :class:`FaultSchedule` at every call."""

    async def prepare(self) -> None:
        return await self._call("placement.prepare", self._inner.prepare)

    async def update(self, item: ObjectPlacementItem) -> None:
        return await self._call("placement.update", self._inner.update, item)

    async def lookup(self, object_id: ObjectId) -> str | None:
        return await self._call("placement.lookup", self._inner.lookup, object_id)

    async def clean_server(self, address: str) -> None:
        return await self._call(
            "placement.clean_server", self._inner.clean_server, address
        )

    async def remove(self, object_id: ObjectId) -> None:
        return await self._call("placement.remove", self._inner.remove, object_id)

    async def lookup_batch(self, object_ids: list[ObjectId]) -> list[str | None]:
        return await self._call(
            "placement.lookup_batch", self._inner.lookup_batch, object_ids
        )

    async def update_batch(self, items: list[ObjectPlacementItem]) -> None:
        return await self._call(
            "placement.update_batch", self._inner.update_batch, items
        )

    async def items(self) -> list[ObjectPlacementItem]:
        return await self._call("placement.items", self._inner.items)

    async def set_standbys(self, object_id: ObjectId, addresses: list[str]) -> int:
        return await self._call(
            "placement.set_standbys", self._inner.set_standbys, object_id, addresses
        )

    async def standbys(self, object_id: ObjectId) -> tuple[list[str], int]:
        return await self._call("placement.standbys", self._inner.standbys, object_id)

    async def promote_standby(
        self, object_id: ObjectId, address: str, expected_epoch: int
    ) -> int | None:
        return await self._call(
            "placement.promote_standby",
            self._inner.promote_standby,
            object_id,
            address,
            expected_epoch,
        )


class FaultyReminderStorage(_FaultyBase, ReminderStorage):
    """``ReminderStorage`` with a :class:`FaultSchedule` at every call."""

    def __init__(self, inner: Any, schedule: FaultSchedule, health: StorageHealth | None = None) -> None:
        super().__init__(inner, schedule, health)
        self.num_shards = inner.num_shards

    async def prepare(self) -> None:
        return await self._call("reminders.prepare", self._inner.prepare)

    async def upsert(self, reminder: Reminder) -> None:
        return await self._call("reminders.upsert", self._inner.upsert, reminder)

    async def remove(self, object_kind: str, object_id: str, reminder_name: str) -> None:
        return await self._call(
            "reminders.remove", self._inner.remove, object_kind, object_id, reminder_name
        )

    async def remove_object(self, object_kind: str, object_id: str) -> None:
        return await self._call(
            "reminders.remove_object", self._inner.remove_object, object_kind, object_id
        )

    async def list_object(self, object_kind: str, object_id: str) -> list[Reminder]:
        return await self._call(
            "reminders.list_object", self._inner.list_object, object_kind, object_id
        )

    async def due(self, shard: int, now: float, limit: int = 256) -> list[Reminder]:
        return await self._call("reminders.due", self._inner.due, shard, now, limit)

    async def reschedule(
        self, object_kind: str, object_id: str, reminder_name: str, next_due: float
    ) -> None:
        return await self._call(
            "reminders.reschedule",
            self._inner.reschedule,
            object_kind,
            object_id,
            reminder_name,
            next_due,
        )

    async def shard_counts(self) -> dict[int, int]:
        return await self._call("reminders.shard_counts", self._inner.shard_counts)

    async def acquire_lease(
        self, shard: int, owner: str, ttl: float, now: float | None = None
    ) -> Lease | None:
        return await self._call(
            "reminders.acquire_lease", self._inner.acquire_lease, shard, owner, ttl, now
        )

    async def release_lease(self, shard: int, owner: str, epoch: int) -> None:
        return await self._call(
            "reminders.release_lease", self._inner.release_lease, shard, owner, epoch
        )

    async def get_lease(self, shard: int) -> Lease | None:
        return await self._call("reminders.get_lease", self._inner.get_lease, shard)


class FaultyStreamStorage(_FaultyBase, StreamStorage):
    """``StreamStorage`` with a :class:`FaultSchedule` at every call.

    The interesting chaos surface for streams is the *durability seam*:
    an ``append`` that fails BEFORE the ack means the publisher retries
    (no loss); a ``commit`` that fails leaves the cursor behind, so the
    redelivery backstop re-reads — at-least-once, never lost-acked.
    """

    def __init__(self, inner: Any, schedule: FaultSchedule, health: StorageHealth | None = None) -> None:
        super().__init__(inner, schedule, health)
        self.num_partitions = inner.num_partitions

    async def prepare(self) -> None:
        return await self._call("streams.prepare", self._inner.prepare)

    async def append(self, record: StreamRecord) -> int:
        return await self._call("streams.append", self._inner.append, record)

    async def read(
        self, stream: str, partition: int, from_offset: int, limit: int = 256
    ) -> list[StreamRecord]:
        return await self._call(
            "streams.read", self._inner.read, stream, partition, from_offset, limit
        )

    async def latest(self, stream: str, partition: int) -> int:
        return await self._call("streams.latest", self._inner.latest, stream, partition)

    async def subscribe(self, sub: Subscription) -> None:
        return await self._call("streams.subscribe", self._inner.subscribe, sub)

    async def unsubscribe(self, stream: str, group: str) -> None:
        return await self._call(
            "streams.unsubscribe", self._inner.unsubscribe, stream, group
        )

    async def subscriptions(self, stream: str) -> list[Subscription]:
        return await self._call(
            "streams.subscriptions", self._inner.subscriptions, stream
        )

    async def commit(
        self, stream: str, group: str, partition: int, offset: int
    ) -> None:
        return await self._call(
            "streams.commit", self._inner.commit, stream, group, partition, offset
        )

    async def committed(self, stream: str, group: str, partition: int) -> int:
        return await self._call(
            "streams.committed", self._inner.committed, stream, group, partition
        )

    async def cursors(self, stream: str, group: str) -> dict[int, int]:
        return await self._call("streams.cursors", self._inner.cursors, stream, group)


# ---------------------------------------------------------------------------
# Transport faults
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LinkRule:
    """Directional perturbation of the ``src -> dst`` link.

    ``src``/``dst`` are ``fnmatch`` patterns over addresses (``"*"`` =
    any). Probabilities are per connect/frame; ``drop=1.0`` is a full
    one-way partition. Rules are directional on purpose — an asymmetric
    partition is two different answers for ``(A, B)`` and ``(B, A)``.
    """

    src: str = "*"
    dst: str = "*"
    drop: float = 0.0
    delay: float = 0.0
    reset: float = 0.0


class TransportFaults:
    """Seeded per-link fault decisions for dials and frames.

    The client (and through it the gossip prober) consults
    :meth:`connect_gate` before dialing and wraps established connections
    via :meth:`wrap_conn`, so both connection-level partitions and
    frame-level drop/delay/reset are injectable without touching the
    transports themselves.
    """

    def __init__(self, seed: int = 0) -> None:
        self._rng = random.Random(seed)
        self.rules: list[LinkRule] = []
        self.connects_blocked = 0
        self.frames_dropped = 0
        self.frames_delayed = 0
        self.resets = 0

    # -- scripting -----------------------------------------------------------

    def add_rule(self, rule: LinkRule) -> None:
        self.rules.append(rule)

    def partition(self, src: str = "*", dst: str = "*", *, symmetric: bool = False) -> None:
        """Full drop of ``src -> dst`` (and the reverse when symmetric)."""
        self.rules.append(LinkRule(src=src, dst=dst, drop=1.0))
        if symmetric:
            self.rules.append(LinkRule(src=dst, dst=src, drop=1.0))

    def heal(self, src: str | None = None, dst: str | None = None) -> None:
        """Remove all rules, or only those matching the given endpoints."""
        if src is None and dst is None:
            self.rules.clear()
            return
        self.rules = [
            r
            for r in self.rules
            if not (
                (src is None or r.src == src) and (dst is None or r.dst == dst)
            )
        ]

    def _verdict(self, src: str, dst: str) -> tuple[bool, float, bool]:
        """``(drop, delay, reset)`` across every matching rule."""
        drop = False
        delay = 0.0
        reset = False
        for r in self.rules:
            if not (fnmatch.fnmatch(src, r.src) and fnmatch.fnmatch(dst, r.dst)):
                continue
            if r.drop and (r.drop >= 1.0 or self._rng.random() < r.drop):
                drop = True
            if r.delay:
                delay += r.delay
            if r.reset and (r.reset >= 1.0 or self._rng.random() < r.reset):
                reset = True
        return drop, delay, reset

    # -- gates ---------------------------------------------------------------

    async def connect_gate(self, src: str, dst: str) -> None:
        """Raise ``ConnectionRefusedError`` (an ``OSError`` — the shape a
        refused dial really has) when the link is down; apply link delay."""
        drop, delay, reset = self._verdict(src, dst)
        if delay > 0.0:
            await asyncio.sleep(delay)
        if drop or reset:
            self.connects_blocked += 1
            raise ConnectionRefusedError(f"injected partition {src or '?'} -> {dst}")

    def wrap_conn(self, conn: Any, src: str, dst: str) -> "FaultyConn":
        return FaultyConn(conn, self, src, dst)

    def gauges(self) -> dict[str, float]:
        return {
            "rio.transport_faults.connects_blocked": float(self.connects_blocked),
            "rio.transport_faults.frames_dropped": float(self.frames_dropped),
            "rio.transport_faults.frames_delayed": float(self.frames_delayed),
            "rio.transport_faults.resets": float(self.resets),
            "rio.transport_faults.rules": float(len(self.rules)),
        }


class FaultyConn:
    """Framed-connection wrapper applying per-frame link verdicts.

    Surface-compatible with both transports' client connections
    (``roundtrip``/``read_frame``/``write``/``close``/``closed``/
    ``pending``/``delivered``) so the pool treats it as any socket. A
    dropped or reset frame closes the underlying connection and raises
    ``Disconnect`` — the client's existing dial-failure retry path takes
    over, exactly as with a real mid-flight cable pull.
    """

    def __init__(self, inner: Any, faults: TransportFaults, src: str, dst: str) -> None:
        self._inner = inner
        self._faults = faults
        self._src = src
        self._dst = dst

    def __getattr__(self, name: str) -> Any:
        return getattr(self._inner, name)

    @property
    def closed(self) -> bool:
        return self._inner.closed

    @property
    def pending(self) -> int:
        return self._inner.pending

    @property
    def delivered(self) -> int:
        return self._inner.delivered

    async def _gate(self) -> None:
        from .errors import Disconnect

        drop, delay, reset = self._faults._verdict(self._src, self._dst)
        if delay > 0.0:
            self._faults.frames_delayed += 1
            await asyncio.sleep(delay)
        if drop:
            self._faults.frames_dropped += 1
            self._inner.close()
            raise Disconnect(f"injected frame drop {self._src or '?'} -> {self._dst}")
        if reset:
            self._faults.resets += 1
            self._inner.close()
            raise Disconnect(f"injected reset {self._src or '?'} -> {self._dst}")

    async def roundtrip(self, frame_bytes: bytes) -> bytes:
        await self._gate()
        return await self._inner.roundtrip(frame_bytes)

    async def read_frame(self) -> bytes | None:
        return await self._inner.read_frame()

    def write(self, frame_bytes: bytes) -> None:
        self._inner.write(frame_bytes)

    def close(self) -> None:
        self._inner.close()


# ---------------------------------------------------------------------------
# Demo / CI smoke
# ---------------------------------------------------------------------------


async def _demo() -> dict[str, float]:
    """Deterministic end-to-end smoke: wrap the in-memory backends, script
    an outage, verify injections and recovery. Returns the gauge snapshot
    (printed by ``--demo``); raises on any contract violation."""
    from .cluster.storage import LocalStorage
    from .object_placement import LocalObjectPlacement

    journal = Journal(capacity=64, node="demo")
    schedule = FaultSchedule(
        seed=7,
        rules=[FaultRule(op="placement.lookup", error_rate=0.5)],
        journal=journal,
    )
    health = StorageHealth()
    members = FaultyMembershipStorage(LocalStorage(), schedule, health)
    placement = FaultyObjectPlacement(LocalObjectPlacement(), schedule, health)

    await members.push(Member.from_address("10.0.0.1:5000", active=True))
    assert [m.address for m in await members.active_members()] == ["10.0.0.1:5000"]

    # Seeded error rate on lookups: some calls fail, some succeed.
    oid = ObjectId("Demo", "x")
    await placement.update(ObjectPlacementItem(object_id=oid, server_address="10.0.0.1:5000"))
    outcomes = []
    for _ in range(16):
        try:
            outcomes.append(await placement.lookup(oid))
        except InjectedFault:
            outcomes.append(None)
    assert any(o is not None for o in outcomes), "every lookup failed at 0.5 rate"
    assert any(o is None for o in outcomes), "no lookup failed at 0.5 rate"

    # Scripted total outage, then recovery.
    schedule.fail_all("membership.*")
    try:
        await members.members()
        raise AssertionError("outage did not fail membership.members")
    except InjectedFault:
        pass
    assert (await placement.lookup(oid) or True), "outage leaked across traits"
    schedule.heal()
    assert [m.address for m in await members.members()] == ["10.0.0.1:5000"]

    # Transport: asymmetric partition blocks A->B only.
    tf = TransportFaults(seed=7)
    tf.partition("10.0.0.1:*", "10.0.0.2:*")
    blocked = False
    try:
        await tf.connect_gate("10.0.0.1:5000", "10.0.0.2:5000")
    except OSError:
        blocked = True
    assert blocked, "partition did not block the forward link"
    await tf.connect_gate("10.0.0.2:5000", "10.0.0.1:5000")  # reverse flows
    tf.heal()
    await tf.connect_gate("10.0.0.1:5000", "10.0.0.2:5000")

    kinds = [ev.kind for ev in journal.events()]
    assert FAULT in kinds, "schedule transitions did not journal FAULT events"
    out = dict(schedule.gauges())
    out.update(health.gauges())
    out.update(tf.gauges())
    return out


def main(argv: list[str] | None = None) -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser(prog="python -m rio_tpu_torch.faults")
    parser.add_argument(
        "--demo",
        action="store_true",
        help="run the deterministic fault-injection smoke and print gauges",
    )
    args = parser.parse_args(argv)
    if not args.demo:
        parser.print_help()
        return 2
    gauges = asyncio.run(_demo())
    print(json.dumps({k: gauges[k] for k in sorted(gauges)}))
    print("faults demo: OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
