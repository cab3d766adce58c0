"""Live object migration: coordinated state handoff behind the OT rebalancer.

A solver re-seat used to be a raw directory write: the old node's in-memory
activation was stranded, volatile state was lost, and a request racing the
move could double-activate the object. This package turns every move into a
coordinated handoff:

1. **Pin** — the source marks the object migrating; the service layer
   refuses new requests with a retryable ``DeallocateServiceObject``
   (mirroring ``Service._refuse_if_draining``), and a synchronous
   activation barrier in ``start_service_object`` closes the
   passed-checks-before-the-pin race.
2. **Deactivate + snapshot** — :meth:`~rio_tpu_torch.registry.Registry.deactivate`
   runs the SHUTDOWN lifecycle under the object's dispatch lock, persists
   every ``managed_state`` field through the state backend, and serializes
   opt-in volatile state (``__migrate_state__``) through the codec. The
   lock plus ``send_raw``'s entry-identity recheck guarantee no handler
   runs between snapshot and removal.
3. **Transfer** — the volatile snapshot travels inline as an admin-style
   actor message (:class:`InstallState`) to the target's node-scoped
   :class:`MigrationInbox`, so clusters with no shared state backend still
   migrate volatile state. The target stashes it and hands it to the fresh
   activation's ``__restore_state__`` during the LOAD lifecycle.
4. **Flip + fence** — the directory row is rewritten through the
   ``ObjectPlacement`` trait (all four backends unchanged) only if it still
   points at the source, and the source keeps a *fence*: any straggler
   request is answered with a ``Redirect`` to the new owner, so a stale
   source can never serve after the flip.

Actuation is a **pipelined, batched engine** (the VM live-migration
"warm-up then flip" shape — the unavailable window covers only the final
delta, not the state copy):

* **Batched bursts** — :meth:`MigrationManager.apply_moves` groups a
  rebalance plan by ``(source, target)`` pair and ships one
  :class:`MigrateBatch` per pair (chunked at
  :attr:`MigrationConfig.batch_size`), amortizing framing and dispatch
  over many keys; the transport's write-cork batches the state payloads.
* **Target-initiated prefetch** — before any pin, the coordinator asks the
  *target* (:class:`PrefetchPull`) to pull volatile snapshots straight
  from the source's inbox (:class:`FetchStates`, served under each
  object's dispatch lock via ``Registry.peek`` — consistent, object stays
  live). At pin time the source re-snapshots; when the bytes are unchanged
  the transfer inside the pinned window is **skipped entirely** (a
  *prefetch hit*) and the window shrinks to deactivate + directory flip.
* **Bounded in-flight** — a global burst budget plus a per-source-node
  semaphore (:attr:`MigrationConfig.global_inflight` /
  :attr:`~MigrationConfig.per_node_inflight`) so a 30k-displacement plan
  cannot stampede a source's event loop or starve foreground traffic;
  within a burst, handoffs overlap up to
  :attr:`MigrationConfig.handoff_concurrency`.

All three entry points converge on the same primitives: the placement
daemon's rebalance (``move_sink`` → :meth:`~MigrationManager.apply_moves`),
the admin command ``AdminCommand.migrate(...)`` and ``Server._drain_and_exit``
(→ :meth:`~MigrationManager.migrate_out`). Moves whose source is dead — or
whose type has no live activation anywhere, like ``rio.ReminderShard`` seat
rows — degrade to a bare directory flip, which for those rows *is* the
migration.

Cross-node control traffic rides two **node-scoped** actors
(``__node_scoped__ = True``: the object id is a node address; the service
layer routes them without the directory, so the solver never re-seats
them). :class:`MigrationControl` runs the long handoffs; :class:`MigrationInbox`
answers purely locally (stash an inbound snapshot, serve a prefetch read).
The split is the deadlock argument: control handlers make cross-node calls
only to inboxes, and inbox handlers never make cross-node calls at all, so
the cross-node wait-for graph (coordinator → control → inbox → local
object locks) is acyclic however symmetric the plan.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field
from typing import Any

from .. import codec
from ..app_data import AppData
from ..cluster.storage import MembershipStorage
from ..errors import ObjectNotFound
from ..journal import (
    MIGRATE_ABORT,
    MIGRATE_BURST,
    MIGRATE_FLIP,
    MIGRATE_INSTALL,
    MIGRATE_PIN,
    MIGRATE_SNAPSHOT,
    Journal,
)
from ..message_router import MessageRouter
from ..object_placement import ObjectPlacement, ObjectPlacementItem
from ..protocol import ResponseError
from ..registry import ObjectId, Registry, handler, message, type_id, type_name
from ..reminders.daemon import SHARD_TYPE
from ..service_object import ServiceObject

log = logging.getLogger("rio_tpu_torch.migration")

__all__ = [
    "CONTROL_TYPE",
    "INBOX_TYPE",
    "FetchStates",
    "InstallState",
    "MigrateBatch",
    "MigrateBatchAck",
    "MigrateObject",
    "MigrationAck",
    "MigrationConfig",
    "MigrationControl",
    "MigrationInbox",
    "MigrationManager",
    "MigrationStats",
    "PrefetchPull",
    "ReplicaAck",
    "ReplicaAppend",
    "StateBatch",
]

#: Wire type-names of the node-scoped control actors.
CONTROL_TYPE = "rio.Migration"
INBOX_TYPE = "rio.MigrationInbox"

#: Inbound volatile snapshots are dropped after this long un-consumed (a
#: handoff that aborted after its install must not leak stash entries).
STASH_TTL = 120.0
#: Fences outlive the flip long enough for every straggler to re-resolve;
#: after this the directory alone is authoritative again.
FENCE_TTL = 300.0
#: A prefetched snapshot only counts as a pin-time hit while comfortably
#: inside the target's stash TTL — past this, install fresh rather than
#: trust a stash entry the target may be about to prune.
_PREFETCH_HIT_MAX_AGE = 30.0


@dataclass
class MigrationConfig:
    """Knobs for the batched actuation pipeline (documented in MIGRATING.md)."""

    batch_size: int = 128  # keys per MigrateBatch burst
    per_node_inflight: int = 2  # concurrent bursts per source node
    global_inflight: int = 8  # concurrent bursts across the whole plan
    handoff_concurrency: int = 16  # overlapping pinned handoffs inside a burst
    prefetch: bool = True  # pre-pin volatile-state warm-up pulls


@dataclass
class MigrationStats:
    """Counters exported through :func:`rio_tpu_torch.otel.stats_gauges`."""

    started: int = 0
    completed: int = 0
    aborted: int = 0
    state_bytes: int = 0  # serialized volatile state transferred out
    seat_flips: int = 0  # moves with no live activation: directory-only
    refusals: int = 0  # requests bounced off a pin or fence
    installs: int = 0  # inbound volatile snapshots stashed at pin time
    batches: int = 0  # MigrateBatch bursts run with this node as source
    batch_keys: int = 0  # keys carried by those bursts
    prefetch_served: int = 0  # snapshots served to a pulling target
    prefetch_hits: int = 0  # pin-time snapshot unchanged: transfer skipped
    prefetch_misses: int = 0  # state moved under the prefetch: fresh install
    pinned_windows: int = 0  # completed pin→unpin windows
    pinned_ms_total: float = 0.0  # sum of window durations (mean = total/windows)
    pinned_ms_max: float = 0.0
    pinned_le_1ms: int = 0  # histogram buckets over the window duration
    pinned_le_10ms: int = 0
    pinned_le_100ms: int = 0
    pinned_gt_100ms: int = 0


@message(name="rio.MigrateObject")
class MigrateObject:
    """Ask a source node to hand one of its objects to ``target``."""

    type_name: str = ""
    object_id: str = ""
    target: str = ""


@message(name="rio.MigrateBatch")
class MigrateBatch:
    """One (source, target) burst of a rebalance plan: many keys, one RPC."""

    target: str = ""
    items: list = field(default_factory=list)  # [type_name, object_id] pairs


@message(name="rio.MigrateBatchAck")
class MigrateBatchAck:
    done: int = 0
    attempted: int = 0
    detail: str = ""


@message(name="rio.PrefetchPull")
class PrefetchPull:
    """Coordinator → target: pull state for ``items`` from ``source`` now,
    ahead of the pins, so the pinned window carries no payload."""

    source: str = ""
    items: list = field(default_factory=list)  # [type_name, object_id] pairs


@message(name="rio.FetchStates")
class FetchStates:
    """Target → source inbox: read volatile snapshots of live objects."""

    items: list = field(default_factory=list)  # [type_name, object_id] pairs
    requester: str = ""  # the pulling target's address


@message(name="rio.StateBatch")
class StateBatch:
    """Prefetch response: ``[type_name, object_id, payload]`` triples."""

    items: list = field(default_factory=list)


@message(name="rio.InstallState")
class InstallState:
    """Inline volatile-state transfer, sent to the target before the flip."""

    type_name: str = ""
    object_id: str = ""
    payload: bytes = b""


@message(name="rio.MigrationAck")
class MigrationAck:
    ok: bool = False
    detail: str = ""


@message(name="rio.ReplicaAppend")
class ReplicaAppend:
    """Primary → standby inbox: one log-shipped state delta for a
    replicated object. ``epoch`` is the directory fence the primary read
    from its standby row — a standby that has seen a newer epoch nacks the
    append, so a deposed primary can never overwrite post-failover state."""

    type_name: str = ""
    object_id: str = ""
    epoch: int = 0
    seq: int = 0
    payload: bytes = b""
    # Appended fields (wire-compatible: shorter legacy frames decode with the
    # defaults, codec.py schema-evolution contract). Read-scale staleness
    # metadata: ``head_seq`` is the primary's latest sequence for the key at
    # ship time, ``ship_ts`` the primary's wall clock. ``refresh=True`` marks
    # a payload-less freshness ping — the standby updates its lag/age
    # bookkeeping and acks, or nacks if it holds no replica (forcing a full
    # re-ship).
    head_seq: int = 0
    ship_ts: float = 0.0
    refresh: bool = False


@message(name="rio.ReplicaAck")
class ReplicaAck:
    ok: bool = False
    epoch: int = 0  # the standby's current epoch for the key (on nack)
    detail: str = ""


class MigrationManager:
    """Per-node migration coordinator; injected into AppData by the Server.

    One instance per server: the *source* role (pin → deactivate → snapshot
    → transfer → flip → fence) lives in :meth:`migrate_out` and its batched
    wrapper :meth:`migrate_batch`; the *target* role (prefetch-pull → stash
    → restore) in :meth:`prefetch_pull`/:meth:`install`/
    :meth:`restore_volatile`; the *coordinator* role (actuating a whole
    rebalance plan with bounded in-flight) in :meth:`apply_moves`.
    """

    def __init__(
        self,
        *,
        address: str,
        registry: Registry,
        placement: ObjectPlacement,
        members_storage: MembershipStorage,
        app_data: AppData,
        router: MessageRouter | None = None,
        client: Any | None = None,
        config: MigrationConfig | None = None,
    ) -> None:
        self.address = address
        self.registry = registry
        self.placement = placement
        self.members_storage = members_storage
        self.app_data = app_data
        self.router = router
        self.config = config or MigrationConfig()
        self.stats = MigrationStats()
        self._pinned: dict[tuple[str, str], str] = {}  # key -> target
        self._fenced: dict[tuple[str, str], tuple[str, float]] = {}
        self._stash: dict[tuple[str, str], tuple[bytes, float]] = {}
        # Source-side record of what each target already pulled:
        # key -> (payload, requester, monotonic ts). Consulted at pin time
        # to skip the in-window transfer when the snapshot is unchanged.
        self._served_prefetch: dict[tuple[str, str], tuple[bytes, str, float]] = {}
        self._node_sems: dict[str, asyncio.Semaphore] = {}
        self._global_sem = asyncio.Semaphore(max(1, self.config.global_inflight))
        self._client = client
        # Control-plane flight recorder (None when journaling is off): each
        # handoff phase — pin, snapshot, install, flip, abort — lands one
        # event, carrying the driving request's trace id across nodes.
        self._journal = app_data.try_get(Journal)

    def _jrecord(self, kind: str, object_id: ObjectId, **attrs: Any) -> None:
        if self._journal is not None:
            self._journal.record(
                kind, f"{object_id.type_name}/{object_id.id}", **attrs
            )

    @property
    def active(self) -> bool:
        """True while any pin or fence exists — the service layer's cheap
        sync guard before awaiting the full directory-aware refusal check."""
        return bool(self._pinned or self._fenced)

    def _note_state_bytes(self, key: str, nbytes: int) -> None:
        """Feed an observed snapshot size into the placement provider's
        affinity tracker (when it carries one): the solver's per-object
        move price then reflects how many bytes this actor actually costs
        to relocate. Telemetry only — never allowed to fail a handoff."""
        tracker = getattr(self.placement, "affinity_tracker", None)
        if tracker is None or not hasattr(tracker, "note_state_bytes"):
            return
        try:
            tracker.note_state_bytes(key, nbytes)
        except Exception:  # noqa: BLE001
            log.exception("state-bytes note failed for %s", key)

    # ------------------------------------------------------------------
    # Request-path refusals (single-activation fencing)
    # ------------------------------------------------------------------

    async def refusal_for(self, object_id: ObjectId) -> ResponseError | None:
        """Directory-aware refusal at the top of the request path.

        Pinned (handoff in flight) → ``DeallocateServiceObject``: the client
        drops its cache, backs off, and re-resolves — a pre-flip redirect to
        the target would just ping-pong back here. Fenced (flip done) →
        ``Redirect`` to the directory's answer (falling back to the
        remembered target); the fence clears itself when the directory
        seats the object back on this node.
        """
        key = (object_id.type_name, object_id.id)
        if key in self._pinned:
            self.stats.refusals += 1
            return ResponseError.deallocate()
        fence = self._fenced.get(key)
        if fence is None:
            return None
        addr = await self.placement.lookup(object_id)
        if addr == self.address:
            self._fenced.pop(key, None)  # solver seated it back here
            return None
        self.stats.refusals += 1
        return ResponseError.redirect(addr if addr is not None else fence[0])

    def activation_refusal(self, object_id: ObjectId) -> ResponseError | None:
        """SYNChronous single-activation barrier.

        Called by ``Service.start_service_object`` in the same event-loop
        tick as the registry insert: a request that passed the async checks
        *before* the pin went up, and resumed after the flip, must still be
        refused here or the source would re-activate a migrated object.
        """
        key = (object_id.type_name, object_id.id)
        if key in self._pinned:
            self.stats.refusals += 1
            return ResponseError.deallocate()
        fence = self._fenced.get(key)
        if fence is not None:
            target, ts = fence
            if time.monotonic() - ts > FENCE_TTL:
                self._fenced.pop(key, None)
                return None
            self.stats.refusals += 1
            return ResponseError.redirect(target)
        return None

    # ------------------------------------------------------------------
    # Source role
    # ------------------------------------------------------------------

    async def migrate_out(
        self, object_id: ObjectId, target: str, *, target_checked: bool = False
    ) -> bool:
        """Hand ``object_id`` (seated here) to ``target``; True on success.

        Safe orderings, in sequence: the pin goes up before anything else
        (and the has-check shares its event-loop tick, so an activation
        either precedes the pin — and is deactivated below — or hits the
        barrier); managed state is persisted and volatile state serialized
        under the object's dispatch lock; the volatile snapshot is installed
        on the target *before* the flip (so the target's first activation
        finds it) — unless a prefetch already parked the identical bytes
        there, in which case the window carries no transfer at all; the
        fence is armed before the pin drops. Any failure before the flip
        aborts with the directory untouched — the object re-activates here
        (or wherever the lazy path seats it) from its last persisted state.

        ``target_checked=True`` skips the per-key liveness probe — the
        batched path (:meth:`migrate_batch`) checks once per burst.
        """
        key = (object_id.type_name, object_id.id)
        if not target or target == self.address or key in self._pinned:
            return False
        if not target_checked and not await self.members_storage.is_active(target):
            log.warning("migration of %s refused: target %s not active", object_id, target)
            return False
        self.stats.started += 1
        self._pinned[key] = target
        self._jrecord(MIGRATE_PIN, object_id, target=target)
        pinned_at = time.perf_counter()
        fenced = False
        try:
            volatile: list[bytes] = []
            live = self.registry.has(object_id.type_name, object_id.id)
            if live:

                async def _snapshot(obj: Any) -> None:
                    from ..state import managed_fields, save_state

                    if managed_fields(type(obj)):
                        await save_state(obj, self.app_data)
                    snap = getattr(obj, "__migrate_state__", None)
                    if snap is not None:
                        value = snap()
                        if asyncio.iscoroutine(value):
                            value = await value
                        volatile.append(codec.serialize(value))

                live = await self.registry.deactivate(
                    object_id.type_name,
                    object_id.id,
                    self.app_data,
                    before_remove=_snapshot,
                )
                if live:
                    self._jrecord(
                        MIGRATE_SNAPSHOT,
                        object_id,
                        bytes=len(volatile[0]) if volatile else 0,
                    )
            if volatile:
                payload = volatile[0]
                served = self._served_prefetch.pop(key, None)
                if (
                    served is not None
                    and served[0] == payload
                    and served[1] == target
                    and time.monotonic() - served[2] <= _PREFETCH_HIT_MAX_AGE
                ):
                    # The target already stashed these exact bytes during
                    # the pre-pin prefetch: nothing to move in-window.
                    self.stats.prefetch_hits += 1
                    self._jrecord(
                        MIGRATE_INSTALL, object_id, target=target, prefetch_hit=True
                    )
                else:
                    if served is not None:
                        self.stats.prefetch_misses += 1
                    self.stats.state_bytes += len(payload)
                    self._note_state_bytes(str(object_id), len(payload))
                    await self._install_on(target, object_id, payload)
                    self._jrecord(
                        MIGRATE_INSTALL,
                        object_id,
                        target=target,
                        bytes=len(payload),
                    )
            if await self.placement.lookup(object_id) == self.address:
                await self.placement.update(
                    ObjectPlacementItem(object_id=object_id, server_address=target)
                )
                self._jrecord(MIGRATE_FLIP, object_id, target=target)
            elif live:
                # Someone re-seated the row mid-handoff; their row wins and
                # our deactivation degrades to an ordinary cold stop.
                log.info("migration of %s lost the directory race", object_id)
            self._fenced[key] = (target, time.monotonic())
            fenced = True
            if not live:
                self.stats.seat_flips += 1
            self.stats.completed += 1
            if live and self.router is not None:
                # Subscribers follow the object: terminate their streams
                # with a Redirect so the client resubscribes at the target.
                self.router.close_subscriptions(
                    object_id.type_name,
                    object_id.id,
                    ResponseError.redirect(target),
                )
            return True
        except Exception as e:
            self.stats.aborted += 1
            self._jrecord(
                MIGRATE_ABORT, object_id, target=target, error=repr(e)[:120]
            )
            log.warning("migration of %s -> %s aborted: %r", object_id, target, e)
            return False
        finally:
            self._pinned.pop(key, None)
            self._record_pinned_window((time.perf_counter() - pinned_at) * 1e3)
            if fenced:
                self._prune_fences()

    async def migrate_batch(self, target: str, items: list) -> tuple[int, int]:
        """Run one burst of handoffs from this node; ``(done, attempted)``.

        The target's liveness is probed once for the whole burst; handoffs
        then overlap up to ``config.handoff_concurrency`` — enough to hide
        the install round-trip latency without monopolizing the event loop.
        A failed key only loses that key (its row stands for the lazy
        re-seat); the burst keeps going.
        """
        attempted = len(items)
        if not attempted:
            return 0, 0
        if (
            not target
            or target == self.address
            or not await self.members_storage.is_active(target)
        ):
            log.warning(
                "burst of %d keys refused: bad or inactive target %r", attempted, target
            )
            return 0, attempted
        self.stats.batches += 1
        self.stats.batch_keys += attempted
        if self._journal is not None:
            self._journal.record(MIGRATE_BURST, target=target, keys=attempted)
        sem = asyncio.Semaphore(max(1, self.config.handoff_concurrency))

        async def one(tname: str, oid: str) -> bool:
            async with sem:
                return await self.migrate_out(
                    ObjectId(tname, oid), target, target_checked=True
                )

        results = await asyncio.gather(
            *(one(tname, oid) for tname, oid in items), return_exceptions=True
        )
        return sum(1 for r in results if r is True), attempted

    async def _install_on(
        self, target: str, object_id: ObjectId, payload: bytes
    ) -> None:
        ack = await self._get_client().send(
            INBOX_TYPE,
            target,
            InstallState(
                type_name=object_id.type_name,
                object_id=object_id.id,
                payload=payload,
            ),
            returns=MigrationAck,
        )
        if not ack.ok:
            raise RuntimeError(f"target {target} refused state install: {ack.detail}")

    def _prune_fences(self) -> None:
        now = time.monotonic()
        for key, (_, ts) in list(self._fenced.items()):
            if now - ts > FENCE_TTL:
                self._fenced.pop(key, None)

    def _record_pinned_window(self, ms: float) -> None:
        s = self.stats
        s.pinned_windows += 1
        s.pinned_ms_total += ms
        if ms > s.pinned_ms_max:
            s.pinned_ms_max = ms
        if ms <= 1.0:
            s.pinned_le_1ms += 1
        elif ms <= 10.0:
            s.pinned_le_10ms += 1
        elif ms <= 100.0:
            s.pinned_le_100ms += 1
        else:
            s.pinned_gt_100ms += 1

    # ------------------------------------------------------------------
    # Prefetch (source serves, target pulls — both before any pin)
    # ------------------------------------------------------------------

    async def prefetch_serve(self, items: list, requester: str) -> list:
        """Source side: snapshot live objects' volatile state *without*
        deactivating them (``Registry.peek`` holds each object's dispatch
        lock, so the snapshot is handler-consistent) and remember exactly
        what ``requester`` received. Objects that are gone, already pinned,
        or export no ``__migrate_state__`` are simply omitted — the
        pin-time install covers them.
        """
        out: list = []
        now = time.monotonic()
        for key, (_, _, ts) in list(self._served_prefetch.items()):
            if now - ts > STASH_TTL:
                self._served_prefetch.pop(key, None)
        for tname, oid in items:
            if (tname, oid) in self._pinned:
                continue  # handoff already running; its install wins
            try:
                payload = await self.registry.peek(tname, oid, self._volatile_snapshot)
            except ObjectNotFound:
                continue
            if payload is None:
                continue
            self._served_prefetch[(tname, oid)] = (payload, requester, now)
            self.stats.prefetch_served += 1
            self.stats.state_bytes += len(payload)
            self._note_state_bytes(f"{tname}.{oid}", len(payload))
            out.append([tname, oid, payload])
        return out

    async def prefetch_pull(self, source: str, items: list) -> int:
        """Target side: pull snapshots for ``items`` from ``source``'s inbox
        and park them in the stash the LOAD lifecycle reads. Returns the
        number of snapshots stashed."""
        batch = await self._get_client().send(
            INBOX_TYPE,
            source,
            FetchStates(items=items, requester=self.address),
            returns=StateBatch,
        )
        now = time.monotonic()
        for tname, oid, payload in batch.items:
            self._stash[(tname, oid)] = (payload, now)
        return len(batch.items)

    @staticmethod
    async def _volatile_snapshot(obj: Any) -> bytes | None:
        snap = getattr(obj, "__migrate_state__", None)
        if snap is None:
            return None
        value = snap()
        if asyncio.iscoroutine(value):
            value = await value
        return codec.serialize(value)

    # ------------------------------------------------------------------
    # Target role
    # ------------------------------------------------------------------

    def install(self, tname: str, object_id: str, payload: bytes) -> None:
        """Stash an inbound volatile snapshot until the activation claims it."""
        now = time.monotonic()
        for key, (_, ts) in list(self._stash.items()):
            if now - ts > STASH_TTL:
                self._stash.pop(key, None)
        self._stash[(tname, object_id)] = (payload, now)
        self.stats.installs += 1
        if self._journal is not None:
            # Target-side half of the transfer: the cross-node causal link —
            # the source's MIGRATE_INSTALL and this event share the driving
            # request's trace id when the handoff rode a traced request.
            self._journal.record(
                MIGRATE_INSTALL,
                f"{tname}/{object_id}",
                side="target",
                bytes=len(payload),
            )

    def restore_volatile(self, obj: Any) -> bool:
        """LOAD-lifecycle hook: hand a stashed snapshot to the fresh
        activation's ``__restore_state__`` (runs after ``load_state``, so
        managed fields are already warm). Returns True when a snapshot was
        applied — the replication fallback restore yields to it (a
        coordinated-handoff stash is newer than any shipped replica)."""
        key = (type_id(type(obj)), obj.id)
        stashed = self._stash.pop(key, None)
        if stashed is None:
            return False
        payload, ts = stashed
        restore = getattr(obj, "__restore_state__", None)
        if restore is None or time.monotonic() - ts > STASH_TTL:
            return False
        restore(codec.deserialize(payload, Any))
        return True

    # ------------------------------------------------------------------
    # Coordinator role (the rebalancer's move sink)
    # ------------------------------------------------------------------

    async def apply_moves(self, moves: list[tuple[str, str, str]]) -> int:
        """Actuate one rebalance plan: ``(directory_key, from, to)`` each.

        Moves with a live source are grouped by ``(source, target)`` and
        shipped as :class:`MigrateBatch` bursts — prefetch first, then the
        pinned handoffs — with burst concurrency bounded by the global
        budget and a per-source semaphore. Dead sources and
        activation-less framework rows (reminder-shard seats) get the bare
        directory flip, which for them *is* the migration. A failed move
        (or a whole failed burst — e.g. the source died mid-batch) leaves
        its rows standing: the lazy request-path re-seat and the next
        churn solve both cover them, and any pins die with the source.
        """
        groups: dict[tuple[str, str], list] = {}
        flips: list[tuple[str, ObjectId, str, str]] = []
        active: dict[str, bool] = {}
        for key, src, dst in moves:
            oid = self._split_key(key)
            if oid is None or src == dst:
                if oid is None:
                    log.warning("unroutable directory key %r; row left in place", key)
                continue
            if src != self.address and src not in active and self.registry.has_type(
                oid.type_name
            ):
                active[src] = await self.members_storage.is_active(src)
            if src == self.address or (
                self.registry.has_type(oid.type_name) and active.get(src, False)
            ):
                groups.setdefault((src, dst), []).append([oid.type_name, oid.id])
            else:
                flips.append((key, oid, src, dst))

        done = 0
        size = max(1, self.config.batch_size)
        bursts = [
            (src, dst, items[i : i + size])
            for (src, dst), items in sorted(groups.items())
            for i in range(0, len(items), size)
        ]

        async def run(src: str, dst: str, items: list) -> int:
            try:
                async with self._global_sem, self._node_sem(src):
                    return await self._run_burst(src, dst, items)
            except Exception as e:
                self.stats.aborted += 1
                log.warning(
                    "burst %s -> %s (%d keys) failed: %r", src, dst, len(items), e
                )
                return 0

        if bursts:
            done += sum(await asyncio.gather(*(run(*b) for b in bursts)))

        for key, oid, src, dst in flips:
            try:
                if await self.placement.lookup(oid) == src:
                    await self.placement.update(
                        ObjectPlacementItem(object_id=oid, server_address=dst)
                    )
                    self.stats.seat_flips += 1
                    done += 1
            except Exception as e:
                self.stats.aborted += 1
                log.warning("move %s %s->%s failed: %r", key, src, dst, e)
        return done

    async def _run_burst(self, src: str, dst: str, items: list) -> int:
        """One (source, target) chunk: warm the target, then fire the burst."""
        if self.config.prefetch:
            try:
                await self._get_client().send(
                    CONTROL_TYPE,
                    dst,
                    PrefetchPull(source=src, items=items),
                    returns=MigrateBatchAck,
                )
            except Exception as e:  # noqa: BLE001 - prefetch is best-effort
                log.debug("prefetch pull %s <- %s failed: %r", dst, src, e)
        if src == self.address:
            burst_done, _ = await self.migrate_batch(dst, items)
            return burst_done
        ack = await self._get_client().send(
            CONTROL_TYPE,
            src,
            MigrateBatch(target=dst, items=items),
            returns=MigrateBatchAck,
        )
        return ack.done

    def _node_sem(self, addr: str) -> asyncio.Semaphore:
        sem = self._node_sems.get(addr)
        if sem is None:
            sem = self._node_sems[addr] = asyncio.Semaphore(
                max(1, self.config.per_node_inflight)
            )
        return sem

    def _split_key(self, key: str) -> ObjectId | None:
        """Invert ``ObjectId.__str__`` (``f"{type_name}.{id}"``).

        Both halves may contain dots, so a blind split is ambiguous; the
        registered type names (plus framework row kinds) disambiguate by
        longest matching prefix, with a first-dot split as the fallback
        for foreign rows.
        """
        best: str | None = None
        for tname in [*self.registry.registered_types(), SHARD_TYPE]:
            if key.startswith(tname + ".") and (best is None or len(tname) > len(best)):
                best = tname
        if best is not None:
            return ObjectId(best, key[len(best) + 1 :])
        head, sep, tail = key.partition(".")
        return ObjectId(head, tail) if sep else None

    # ------------------------------------------------------------------

    def _get_client(self):
        if self._client is None:
            from ..client import Client

            self._client = Client(
                self.members_storage, placement_resolver=self._resolve
            )
        return self._client

    async def _resolve(self, handler_type: str, handler_id: str) -> str | None:
        if handler_type in (CONTROL_TYPE, INBOX_TYPE):
            return handler_id  # node-scoped: the id IS the address
        return await self.placement.lookup(ObjectId(handler_type, handler_id))

    def close(self) -> None:
        if self._client is not None:
            self._client.close()
            self._client = None


@type_name(CONTROL_TYPE)
class MigrationControl(ServiceObject):
    """Node-scoped handoff orchestrator (one per server; id = address)."""

    __node_scoped__ = True

    @handler
    async def migrate_object(self, msg: MigrateObject, ctx: AppData) -> MigrationAck:
        mgr = ctx.try_get(MigrationManager)
        if mgr is None:
            return MigrationAck(ok=False, detail="migration disabled on this node")
        ok = await mgr.migrate_out(ObjectId(msg.type_name, msg.object_id), msg.target)
        return MigrationAck(ok=ok)

    @handler
    async def migrate_batch(self, msg: MigrateBatch, ctx: AppData) -> MigrateBatchAck:
        mgr = ctx.try_get(MigrationManager)
        if mgr is None:
            return MigrateBatchAck(detail="migration disabled on this node")
        done, attempted = await mgr.migrate_batch(msg.target, msg.items)
        return MigrateBatchAck(done=done, attempted=attempted)

    @handler
    async def prefetch_pull(self, msg: PrefetchPull, ctx: AppData) -> MigrateBatchAck:
        mgr = ctx.try_get(MigrationManager)
        if mgr is None:
            return MigrateBatchAck(detail="migration disabled on this node")
        stashed = await mgr.prefetch_pull(msg.source, msg.items)
        return MigrateBatchAck(done=stashed, attempted=len(msg.items))


@type_name(INBOX_TYPE)
class MigrationInbox(ServiceObject):
    """Node-scoped snapshot receiver, deliberately separate from
    :class:`MigrationControl`: installs must never queue behind a handoff
    this node is running (symmetric migrations would deadlock), and its
    handlers never make cross-node calls — that keeps the migration
    wait-for graph acyclic."""

    __node_scoped__ = True

    @handler
    async def install_state(self, msg: InstallState, ctx: AppData) -> MigrationAck:
        mgr = ctx.try_get(MigrationManager)
        if mgr is None:
            return MigrationAck(ok=False, detail="migration disabled on this node")
        mgr.install(msg.type_name, msg.object_id, msg.payload)
        return MigrationAck(ok=True)

    @handler
    async def fetch_states(self, msg: FetchStates, ctx: AppData) -> StateBatch:
        mgr = ctx.try_get(MigrationManager)
        if mgr is None:
            return StateBatch()
        return StateBatch(items=await mgr.prefetch_serve(msg.items, msg.requester))

    @handler
    async def replica_append(self, msg: ReplicaAppend, ctx: AppData) -> ReplicaAck:
        # Replication rides the same node-scoped inbox as migration installs
        # (same acyclic wait-for-graph argument: apply_append is purely
        # local). Lazy import — rio_tpu_torch.replication imports this module for
        # the wire types.
        from ..replication import ReplicationManager

        mgr = ctx.try_get(ReplicationManager)
        if mgr is None:
            return ReplicaAck(ok=False, detail="replication disabled on this node")
        return mgr.apply_append(msg)
