"""Per-connection request engine.

Reference: ``rio-rs/src/service.rs`` — the tower ``Service`` that every
accepted TCP connection runs through:

* ``call(RequestEnvelope)`` (``:54-110``): placement check → local start →
  registry dispatch → panic isolation (deallocate on panic).
* ``get_or_create_placement`` (``:193-254``): directory lookup; prune
  malformed rows and rows owned by dead nodes; self-assign unplaced objects.
* ``check_address_mismatch`` (``:261-298``): redirect to a live owner,
  deallocate when the owner is dead.
* ``start_service_object`` (``:304-359``): construct + insert + lifecycle
  ``Load`` with full rollback on failure.
* ``run(stream)`` (``:370-459``): the length-delimited frame loop, carrying
  both request/response and subscription streaming.
"""

from __future__ import annotations

import asyncio
import logging
import time

from .affinity import _SOURCE as _AFFINITY_SOURCE
from .app_data import AppData
from .cluster.storage import MembershipStorage
from .commands import DispatchObserver, ServerDraining, ShardRouter
from .errors import HandlerNotFound, ObjectNotFound, SerializationError, TypeNotFound
from .journal import ADMIT_SHED, PLACE_ASSIGN, PLACE_RELEASE, STORAGE, Journal
from .message_router import MessageRouter
from .object_placement import ObjectPlacement, ObjectPlacementItem
from .protocol import (
    CommandEnvelope,
    ErrorKind,
    RequestEnvelope,
    ResponseEnvelope,
    ResponseError,
    SubscriptionRequest,
)
from .registry import ApplicationRaised, ObjectId, Registry
from .service_object import LifecycleMessage
from .tracing import adopt, current_trace_id, release, span
from .tracing import enabled as tracing_enabled

log = logging.getLogger("rio_tpu_torch.service")


def _address_well_formed(addr: str) -> bool:
    host, sep, port = addr.rpartition(":")
    return bool(sep) and bool(host) and port.isdigit()


class Service:
    """Stateless-per-connection request engine; shares node-wide structures."""

    def __init__(
        self,
        address: str,
        registry: Registry,
        object_placement: ObjectPlacement,
        members_storage: MembershipStorage,
        app_data: AppData,
    ) -> None:
        self.address = address
        self.registry = registry
        self.object_placement = object_placement
        self.members_storage = members_storage
        self.app_data = app_data
        # Resolved once per connection, not per request: the affinity
        # observation hook (None for deployments without a tracker).
        observer = app_data.try_get(DispatchObserver)
        self._observe = observer.fn if observer is not None else None
        from .affinity import EdgeSampler

        # Communication-edge sampler (None when the sampler is off): the
        # dispatch path records (source → served object) edges through it,
        # and both transports read it off the service for their TCP byte
        # counters — same resolve-once pattern as ``spans``.
        self.affinity = app_data.try_get(EdgeSampler)
        from .migration import MigrationManager

        self._migrator = app_data.try_get(MigrationManager)
        from .replication import ReplicationManager

        # Hot-standby engine (None unless the server was built with a
        # replication_config): ships replicated actors' state on ack and
        # drives epoch-fenced failover from the dead-owner branch.
        self._replication = app_data.try_get(ReplicationManager)
        from .readscale import ReadScaleManager

        # Bounded-staleness replica reads (None unless the server was built
        # with a read_scale_config): standby-side serve/forward of @readonly
        # requests, primary-side shed toward the standby seats under load.
        self._readscale = app_data.try_get(ReadScaleManager)
        from .load import LoadMonitor

        # Admission control + telemetry (None when the server runs without
        # a monitor): every dispatch is counted, and over-threshold load
        # sheds with the retryable SERVER_BUSY wire error.
        self._load = app_data.try_get(LoadMonitor)
        from .metrics import MetricsRegistry

        # Per-handler RED histograms (None when metrics are disabled):
        # every dispatch records (duration, error kind, exemplar trace id).
        self._metrics = app_data.try_get(MetricsRegistry)
        # Control-plane flight recorder (None when journaling is off).
        # Recorded on TRANSITIONS only — assign/release/shed — never on the
        # per-request fast path.
        self._journal = app_data.try_get(Journal)
        from .spans import SpanRing

        # Request-waterfall span ring (None when span retention is off).
        # Resolved here once so both transports share the same handle per
        # connection; the transports own all phase stamping — the service
        # request path is untouched (null fast path byte-identical).
        self.spans = app_data.try_get(SpanRing)
        from .qos import QosScheduler

        # Request QoS scheduler (None when the server was built without a
        # qos_config): both transports read it off the service and run
        # admission + handler-start grants between decode and dispatch —
        # the service request path itself is untouched.
        self.qos = app_data.try_get(QosScheduler)
        # Shard map of a multi-process sharded node (None on plain servers):
        # consulted only when seating an UNPLACED object — see the seam in
        # get_or_create_placement.
        self._shard = app_data.try_get(ShardRouter)
        # Storage-outage degraded mode: node-wide health counters plus the
        # optional bound on the routing block's directory awaits. Both None
        # on servers that predate the fault subsystem (bare Service uses in
        # tests) — the request path is then byte-identical to before.
        # Import deferred: a module-level one loads rio_tpu_torch.faults during
        # ``import rio_tpu_torch``, and ``python -m rio_tpu_torch.faults`` then
        # double-executes it (runpy's sys.modules warning).
        from .faults import StorageHealth, StorageResilienceConfig

        self._storage_health = app_data.try_get(StorageHealth)
        resilience = app_data.try_get(StorageResilienceConfig)
        self._route_timeout = resilience.route_timeout if resilience else None

    # ------------------------------------------------------------------
    # Placement (reference service.rs:193-298)
    # ------------------------------------------------------------------

    async def _refuse_if_draining(self, object_id: ObjectId) -> ResponseError | None:
        """Refuse NEW activations while this node drains.

        Objects already activated here keep being served until the drain's
        lifecycle pass tears them down; anything else is bounced with
        ``DeallocateServiceObject`` (the client's retry path re-resolves
        and a healthy server re-seats it). A directory row still pointing
        HERE is removed first, or the retry would redirect straight back
        into the draining node forever.
        """
        drain = self.app_data.try_get(ServerDraining)
        if drain is None or not drain.active:
            return None
        if self.registry.has(object_id.type_name, object_id.id):
            return None
        addr = await self.object_placement.lookup(object_id)
        if addr == self.address:
            await self.object_placement.remove(object_id)
        return ResponseError.deallocate()

    async def _route_node_scoped(self, object_id: ObjectId) -> ResponseError | None:
        """Directory-less routing for node-scoped actors (id == an address).

        These actors (migration control plane) exist once per server with
        the node's own address as object id: serve locally when the id is
        this node, redirect when it names a live peer, deallocate when it
        names a dead one. The placement directory is never consulted or
        written — the solver can't re-seat what has no row.
        """
        if object_id.id == self.address:
            return None
        if await self.members_storage.is_active(object_id.id):
            return ResponseError.redirect(object_id.id)
        return ResponseError.deallocate()

    async def _shed_if_overloaded(self, object_id: ObjectId) -> ResponseError | None:
        """Admission control: refuse work an overloaded node can DIVERT.

        Sheds only requests that would activate a new object here — objects
        already activated keep being served (bouncing them would only
        redirect-ping-pong: their state lives here until a migration moves
        it). Node-scoped control-plane actors are exempt one level up: a
        saturated node must still answer MigrateObject/InstallState, which
        are exactly how load LEAVES it. A not-yet-activated directory row
        pointing here is un-seated (the drain-refusal pattern) so the
        client's retry self-assigns on a healthy member instead of being
        redirected straight back.
        """
        if self._load is None or self.registry.has(object_id.type_name, object_id.id):
            return None
        reason = self._load.shed_reason()
        if reason is None:
            return None
        addr = await self.object_placement.lookup(object_id)
        if addr == self.address:
            await self.object_placement.remove(object_id)
        self._load.stats.sheds += 1
        if self._journal is not None:
            self._journal.record(
                ADMIT_SHED, f"{object_id.type_name}/{object_id.id}", reason=reason
            )
        return ResponseError.server_busy(reason)

    async def _refuse_if_migrating(self, object_id: ObjectId) -> ResponseError | None:
        if self._migrator is None or not self._migrator.active:
            # Sync fast path: no pin or fence exists anywhere on this node,
            # so the directory-aware refusal check (which may await a
            # placement lookup) cannot refuse — skip it. `active` flips
            # before any pin goes up, in the same tick.
            return None
        return await self._migrator.refusal_for(object_id)

    async def get_or_create_placement(self, object_id: ObjectId) -> str:
        """Resolve the owning server for ``object_id``, self-assigning if free."""
        # ObjectId is passed raw: attrs must cost nothing to build when no
        # sink is registered (sinks str() it themselves).
        with span("placement_lookup", object=object_id):
            addr = await self.object_placement.lookup(object_id)
        if addr is not None:
            if not _address_well_formed(addr):
                # Corrupt row: drop it and fall through to self-assign
                # (reference service.rs:213-221).
                await self.object_placement.remove(object_id)
                if self._journal is not None:
                    self._journal.record(
                        PLACE_RELEASE,
                        f"{object_id.type_name}/{object_id.id}",
                        reason="corrupt_row",
                    )
                addr = None
            elif addr != self.address and not await self.members_storage.is_active(addr):
                # Owner is dead. A replicated object fails over FIRST: the
                # epoch CAS flips the primary row to a live standby, and that
                # row — no longer pointing at the dead node — survives the
                # clean_server sweep below. Everything else falls through to
                # the lazy self-assign, as before.
                promoted = None
                if self._replication is not None and self.registry.is_replicated(
                    object_id.type_name
                ):
                    # Unreplicated types skip the promotion probe: after a
                    # node death it costs a directory standbys() read per
                    # first-touch lookup on everything the dead node held.
                    promoted = await self._replication.maybe_promote(object_id, addr)
                # Bulk-unassign everything the dead node held
                # (reference service.rs:227-238).
                await self.object_placement.clean_server(addr)
                addr = promoted
        if (
            addr is None
            and self._replication is not None
            and self.registry.is_replicated(object_id.type_name)
        ):
            # Unplaced but replicated: a standby row may outlive the primary
            # row (clean_server after a failover wipes every row the dead
            # node held). Adopt a live standby — it holds the shipped
            # replica — instead of self-assigning a fresh instance.
            addr = await self._replication.maybe_promote(object_id)
        if (
            addr is None
            and self._shard is not None
            and not self.registry.is_node_scoped(object_id.type_name)
        ):
            # Sharded worker seating an unplaced object: only the preferred
            # owner (crc32 slice over the sibling slots) self-assigns; every
            # other worker answers the standard Redirect WITHOUT writing a
            # directory row — the owner writes its own row when the
            # redirected request arrives, so rows are only ever written by
            # the worker that owns them (no cross-worker write races). A
            # dead preferred owner falls through to the lazy local
            # self-assign below: deterministic slicing degrades, seating
            # never hinges on the hash map.
            owner = self._shard.owner(object_id.type_name, object_id.id)
            if owner != self.address and await self.members_storage.is_active(owner):
                return owner
        if addr is None:
            addr = self.address
            await self.object_placement.update(
                ObjectPlacementItem(object_id=object_id, server_address=addr)
            )
            if self._journal is not None and not self.registry.is_node_scoped(
                object_id.type_name
            ):
                # One event per activation seat (not per request: the fast
                # path above returns long before this branch).
                self._journal.record(
                    PLACE_ASSIGN, f"{object_id.type_name}/{object_id.id}"
                )
        return addr

    async def check_address_mismatch(self, addr: str) -> ResponseError | None:
        """``None`` when this node owns the object; an error to return otherwise."""
        if addr == self.address:
            return None
        if await self.members_storage.is_active(addr):
            return ResponseError.redirect(addr)
        await self.object_placement.clean_server(addr)
        return ResponseError.deallocate()

    # ------------------------------------------------------------------
    # Activation (reference service.rs:304-359)
    # ------------------------------------------------------------------

    async def start_service_object(self, object_id: ObjectId) -> ResponseError | None:
        if self.registry.has(object_id.type_name, object_id.id):
            return None
        if self._migrator is not None and not self.registry.is_node_scoped(
            object_id.type_name
        ):
            # Synchronous single-activation barrier: a request that passed
            # the async refusal checks BEFORE the migration pin went up must
            # not re-activate the object here after the handoff. This check
            # and the insert below share one event-loop tick, so the pin
            # cannot appear between them.
            barred = self._migrator.activation_refusal(object_id)
            if barred is not None:
                return barred
        with span("object_activate", object=object_id):
            try:
                obj = self.registry.new_from_type(object_id.type_name, object_id.id)
            except TypeNotFound:
                return ResponseError.not_supported(object_id.type_name)
            self.registry.insert(object_id.type_name, object_id.id, obj)
            try:
                await self.registry.send(
                    object_id.type_name, object_id.id, LifecycleMessage(), self.app_data
                )
            except Exception as e:  # lifecycle failure → full rollback
                self.registry.remove(object_id.type_name, object_id.id)
                try:
                    await self.object_placement.remove(object_id)
                except Exception:  # noqa: BLE001 — directory down mid-rollback
                    # The stale row self-heals: the next lookup prunes rows
                    # owned by this node once the object is gone locally.
                    log.warning("rollback row removal failed for %s", object_id)
                log.warning("activation of %s failed: %r", object_id, e)
                return ResponseError.allocate(str(e))
        return None

    # ------------------------------------------------------------------
    # Request dispatch (reference service.rs:54-110)
    # ------------------------------------------------------------------

    # Per-connection duration-sampling stride: counts and errors are exact
    # on EVERY dispatch, but clock reads + bucket recording happen 1-in-8
    # on the untraced path (-1 start so a fresh connection's first request
    # is timed). Traced requests always take the timed path — exemplars
    # must never miss the request that carried the trace.
    _tick = -1
    # Inline cache of the last (handler_type, message_type) histogram:
    # connections are overwhelmingly monomorphic, so the exact-count bump
    # is two string compares + an int add instead of a registry lookup.
    _memo_ht: str | None = None
    _memo_mt: str | None = None
    _memo_h = None

    async def call(self, req: RequestEnvelope) -> ResponseEnvelope:
        """One request end-to-end; adopts (or roots) the trace its child
        spans join, and records the RED histogram sample."""
        if req.trace_ctx is None and not tracing_enabled():
            # Null path: nothing to adopt and no sink a span could reach —
            # skip the contextvar/span ceremony entirely. This is the
            # pre-observability hot path plus these two checks.
            if self._load is not None:
                self._load.request_started()
            try:
                m = self._metrics
                if m is None:
                    return await self._call(req)
                tick = self._tick = (self._tick + 1) & 7
                if tick:
                    resp = await self._call(req)
                    ht = req.handler_type
                    mt = req.message_type
                    if ht == self._memo_ht and mt == self._memo_mt:
                        h = self._memo_h
                    else:
                        h = m.resolve(ht, mt)
                        self._memo_ht = ht
                        self._memo_mt = mt
                        self._memo_h = h
                    h.count += 1
                    err = resp.error
                    if err is not None:
                        h.error_count += 1
                        kind = int(err.kind)
                        h.errors[kind] = h.errors.get(kind, 0) + 1
                    return resp
                return await self._call_timed(req, None)
            finally:
                if self._load is not None:
                    self._load.request_finished()
        # Adopt the caller's wire trace context BEFORE opening any span:
        # placement_lookup→object_activate→handler_dispatch then join the
        # client's trace instead of rooting an orphan, and every nested
        # outbound send (replication ship, readscale forward, internal
        # client) inherits it through the contextvar. adopt(None) is free.
        token = adopt(req.trace_ctx)
        try:
            with span("request", object=req.handler_type, id=req.handler_id):
                if self._load is not None:
                    self._load.request_started()
                try:
                    if self._metrics is None:
                        return await self._call(req)
                    return await self._call_timed(req, current_trace_id())
                finally:
                    if self._load is not None:
                        self._load.request_finished()
        finally:
            release(token)

    async def call_command(self, env: CommandEnvelope) -> ResponseEnvelope:
        """One control-plane command (KIND_COMMAND frame) end-to-end.

        Saga commands are sugar over the ordinary request path (the
        coordinator is a seated actor — placement, redirects, and tracing
        all apply unchanged). Stream commands talk to the node-wide
        ``StreamStorage`` directly: a publish is legal on ANY member (the
        append log has no owner), which is what lets remote producers
        publish without learning the cluster's seating first.
        """
        from typing import Any as _Any

        from . import codec
        from .streams import StreamStorage

        cmd = env.command
        if cmd == "saga.start" or cmd == "saga.status":
            mt = "rio.StartSaga" if cmd == "saga.start" else "rio.SagaStatus"
            return await self.call(
                RequestEnvelope("rio.Saga", env.subject, mt, env.payload, env.trace_ctx)
            )
        if cmd.startswith("stream.") and self.app_data.try_get(StreamStorage) is None:
            return ResponseEnvelope.err(
                ResponseError.not_supported(
                    f"command {cmd!r} needs a StreamStorage backend"
                )
            )
        if cmd == "stream.publish":
            from .streams.cursor import publish_raw

            try:
                stream_key_mt_body = codec.deserialize(env.payload, _Any)
                stream, key, message_type, body = stream_key_mt_body
            except Exception as e:  # noqa: BLE001 — malformed payload
                return ResponseEnvelope.err(
                    ResponseError.unknown(f"bad stream.publish payload: {e}")
                )
            token = adopt(env.trace_ctx)
            try:
                partition, offset = await publish_raw(
                    self.app_data, env.subject or stream, key, message_type, body
                )
            except Exception as e:  # noqa: BLE001 — backend failure
                log.exception("stream.publish failed")
                return ResponseEnvelope.err(
                    ResponseError.unknown(f"publish failed: {e}")
                )
            finally:
                release(token)
            return ResponseEnvelope.ok(codec.serialize([partition, offset]))
        if cmd == "stream.subscribe":
            from .streams.cursor import subscribe_group

            try:
                group, target_type, period = codec.deserialize(env.payload, _Any)
                await subscribe_group(
                    self.app_data,
                    env.subject,
                    group,
                    target_type,
                    redelivery_period=float(period),
                )
            except Exception as e:  # noqa: BLE001 — malformed payload/backend
                return ResponseEnvelope.err(
                    ResponseError.unknown(f"stream.subscribe failed: {e}")
                )
            return ResponseEnvelope.ok(b"")
        if cmd == "stream.unsubscribe":
            from .streams.cursor import unsubscribe_group

            try:
                (group,) = codec.deserialize(env.payload, _Any)
                await unsubscribe_group(self.app_data, env.subject, group)
            except Exception as e:  # noqa: BLE001 — malformed payload/backend
                return ResponseEnvelope.err(
                    ResponseError.unknown(f"stream.unsubscribe failed: {e}")
                )
            return ResponseEnvelope.ok(b"")
        if cmd == "stream.cursors":
            storage = self.app_data.get(StreamStorage)
            try:
                (group,) = codec.deserialize(env.payload, _Any)
                cursors = await storage.cursors(env.subject, group)
            except Exception as e:  # noqa: BLE001 — malformed payload/backend
                return ResponseEnvelope.err(
                    ResponseError.unknown(f"stream.cursors failed: {e}")
                )
            return ResponseEnvelope.ok(
                codec.serialize(sorted(cursors.items()))
            )
        return ResponseEnvelope.err(
            ResponseError.not_supported(f"unknown command {cmd!r}")
        )

    async def _route(
        self, req: RequestEnvelope, object_id: ObjectId
    ) -> ResponseEnvelope | ResponseError | None:
        """The non-node-scoped routing block: readscale standby serve,
        overload shed, drain/migration refusals, directory resolution.
        ``None`` means "this node owns the object — dispatch locally"."""
        if self._readscale is not None:
            # Standby serve-or-forward runs BEFORE the overload shed: a
            # replica read never activates anything here, so shedding it
            # (or redirecting to the primary we exist to offload) would
            # defeat the read scale-out exactly when it matters.
            served = await self._readscale.try_serve_standby(req, object_id)
            if served is not None:
                return served
        shed = await self._shed_if_overloaded(object_id)
        if shed is not None:
            return shed
        refusal = await self._refuse_if_draining(object_id)
        if refusal is None:
            refusal = await self._refuse_if_migrating(object_id)
        if refusal is not None:
            return refusal
        addr = await self.get_or_create_placement(object_id)
        mismatch = await self.check_address_mismatch(addr)
        if mismatch is not None:
            return mismatch
        if self._readscale is not None:
            # This node IS the primary. Under load, divert @readonly
            # requests to the standby seats (named in the SERVER_BUSY
            # payload) instead of queueing them on the object's dispatch
            # lock — the activated-objects-always-served rule above only
            # holds for writes once reads have somewhere else to go.
            busy = self._readscale.shed_read(req, object_id, self._load)
            if busy is not None:
                return busy
        if self._storage_health is not None and self._storage_health.degraded:
            # Routing succeeded end to end: mark the request path recovered
            # (journal one STORAGE event per outage edge, not per request).
            if self._storage_health.note_ok("service") and self._journal is not None:
                self._journal.record(STORAGE, source="service", mode="recovered")
        return None

    def _placement_degraded(
        self, object_id: ObjectId, exc: Exception
    ) -> ResponseError | None:
        """Storage-down fallback for the routing block.

        Seated actors keep serving from the local registry cache — their
        directory row cannot have moved without a migration, and migrations
        need the same storage that just failed. Everything else sheds with
        the retryable SERVER_BUSY path: the client backs off with
        decorrelated jitter and re-routes, so new placements degrade to
        bounded retries instead of errors or hangs.
        """
        health = self._storage_health
        first = False
        if health is not None:
            first = health.note_error("placement.route", exc, source="service")
        seated = self.registry.has(object_id.type_name, object_id.id)
        key = f"{object_id.type_name}/{object_id.id}"
        if first:
            log.warning("storage degraded on request path (%s): %r", key, exc)
            if self._journal is not None:
                self._journal.record(
                    STORAGE,
                    key,
                    source="service",
                    mode="degraded",
                    seated=seated,
                    error=repr(exc)[:120],
                )
        if seated:
            if health is not None:
                health.note_degraded_serve()
            return None
        if health is not None:
            health.note_shed()
        return ResponseError.server_busy(
            f"storage unavailable: {type(exc).__name__}"
        )

    async def _call_timed(
        self, req: RequestEnvelope, trace_id: str | None
    ) -> ResponseEnvelope:
        perf = time.perf_counter
        start = perf()
        resp = await self._call(req)
        err = resp.error
        self._metrics.record(
            req.handler_type,
            req.message_type,
            perf() - start,
            None if err is None else int(err.kind),
            trace_id,
        )
        return resp

    async def _call(self, req: RequestEnvelope) -> ResponseEnvelope:
        object_id = ObjectId(req.handler_type, req.handler_id)
        if not self.registry.has_type(req.handler_type):
            return ResponseEnvelope.err(ResponseError.not_supported(req.handler_type))

        if self.registry.is_node_scoped(req.handler_type):
            # Control-plane actors bypass drain/migration refusals too: a
            # draining node must still answer MigrateObject — drain IS a
            # migration storm.
            routing = await self._route_node_scoped(object_id)
            if routing is not None:
                return ResponseEnvelope.err(routing)
        else:
            try:
                t = self._route_timeout
                if t is None:
                    routed = await self._route(req, object_id)
                else:
                    # Bounded directory awaits: a HUNG (not erroring)
                    # rendezvous times the routing block out into the same
                    # degraded path an exception takes.
                    routed = await asyncio.wait_for(self._route(req, object_id), t)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — rendezvous down
                routed = self._placement_degraded(object_id, e)
            if routed is not None:
                if isinstance(routed, ResponseEnvelope):
                    return routed
                return ResponseEnvelope.err(routed)

        start_err = await self.start_service_object(object_id)
        if start_err is not None:
            return ResponseEnvelope.err(start_err)

        try:
            source_token = None
            obj_key = None
            if self.affinity is not None:
                # Bind this actor's identity as the affinity source for any
                # internal sends its handler issues (InternalClientSender
                # snapshots it at enqueue, like trace_ctx) — so the edge
                # graph sees actor→actor, not client→everything. The key
                # string is built ONCE per request and shared with the edge
                # observation and the tracker hook below — string churn on
                # the skip path was the sampler's measurable overhead.
                obj_key = f"{req.handler_type}.{req.handler_id}"
                source_token = _AFFINITY_SOURCE.set(obj_key)
            try:
                with span("handler_dispatch", object=object_id, msg=req.message_type):
                    body = await self.registry.send_raw(
                        req.handler_type,
                        req.handler_id,
                        req.message_type,
                        req.payload,
                        self.app_data,
                    )
            finally:
                if source_token is not None:
                    _AFFINITY_SOURCE.reset(source_token)
            if obj_key is not None and not self.registry.is_node_scoped(
                req.handler_type
            ):
                # Record the (source → this object) edge (node-scoped
                # control-plane actors are skipped — the solver can't move
                # them, so their edges would only pollute the graph).
                # Internal sends carry their source in-process
                # (req.source); anything that arrived over TCP has none
                # and is attributed to "client". The stride gate is
                # INLINED (see EdgeSampler.observe_sampled): the skipped
                # 7-in-8 path is one int add + mask + compare, with the
                # exception guard and argument construction paid only on
                # a sampling hit.
                aff = self.affinity
                aff._tick = tick = (aff._tick + 1) & aff._mask
                if not tick:
                    try:
                        aff.observe_sampled(
                            req.source or "client",
                            obj_key,
                            len(req.payload),
                            bool(req.source),
                        )
                    except Exception:
                        log.exception("affinity sampler failed")
            if self._observe is not None:
                # Feed the affinity tracker: this node served this object
                # (reference has no counterpart — placement there is random).
                # Guarded like trace sinks: an observer bug must not be
                # mistaken for a handler panic (which would deallocate a
                # healthy object and fail an already-served request).
                try:
                    self._observe(
                        obj_key
                        if obj_key is not None
                        else f"{req.handler_type}.{req.handler_id}",
                        self.address,
                    )
                except Exception:
                    log.exception("dispatch observer failed")
            if self._replication is not None and self.registry.is_replicated(
                req.handler_type
            ):
                # Ship-on-ack: the state delta reaches every standby BEFORE
                # the client sees this response, so a primary death cannot
                # lose an acknowledged write. Never raises — a failed ship
                # degrades to the anti-entropy retry, not a failed request.
                await self._replication.ship_on_ack(object_id)
            return ResponseEnvelope.ok(body)
        except ApplicationRaised as e:
            # Typed user error: object stays alive (reference Err path).
            return ResponseEnvelope.err(ResponseError.application(e.payload, e.type_name))
        except HandlerNotFound as e:
            return ResponseEnvelope.err(ResponseError.not_supported(str(e)))
        except ObjectNotFound:
            # Lost a race with shutdown; tell the client to retry/allocate.
            return ResponseEnvelope.err(ResponseError.allocate("object disappeared"))
        except SerializationError as e:
            # Malformed payload / unserializable result: the actor never ran
            # (or ran fine); a bad byte blob must not deallocate a healthy
            # object.
            return ResponseEnvelope.err(
                ResponseError(kind=ErrorKind.SERIALIZATION, detail=str(e))
            )
        except Exception as e:  # noqa: BLE001 — "panic" isolation
            # Reference service.rs:92-107: catch_unwind → deallocate → Unknown.
            panicked = self.registry.remove(req.handler_type, req.handler_id)
            if panicked is not None:
                # Orphaned volatile timers would keep re-activating the
                # deallocated object through the dispatch queue.
                from .service_object import cancel_timers

                cancel_timers(panicked)
            await self.object_placement.remove(object_id)
            if self._journal is not None:
                self._journal.record(
                    PLACE_RELEASE,
                    f"{object_id.type_name}/{object_id.id}",
                    reason="panic",
                    error=repr(e)[:120],
                )
            log.exception("handler panic for %s", object_id)
            return ResponseEnvelope.err(ResponseError.unknown(f"Panic: {e!r}"))

    # ------------------------------------------------------------------
    # Subscription dispatch (reference service.rs:151-185)
    # ------------------------------------------------------------------

    async def subscribe(self, req: SubscriptionRequest) -> ResponseError | asyncio.Queue:
        object_id = ObjectId(req.handler_type, req.handler_id)
        if not self.registry.has_type(req.handler_type):
            return ResponseError.not_supported(req.handler_type)
        if self.registry.is_node_scoped(req.handler_type):
            routing = await self._route_node_scoped(object_id)
            if routing is not None:
                return routing
        else:
            refusal = await self._refuse_if_draining(object_id)
            if refusal is None:
                refusal = await self._refuse_if_migrating(object_id)
            if refusal is not None:
                return refusal
            addr = await self.get_or_create_placement(object_id)
            mismatch = await self.check_address_mismatch(addr)
            if mismatch is not None:
                return mismatch
        start_err = await self.start_service_object(object_id)
        if start_err is not None:
            return start_err
        router = self.app_data.get(MessageRouter)
        return router.create_subscription(req.handler_type, req.handler_id)

    # The per-connection frame loop (reference service.rs:370-459) lives in
    # the transports: rio_tpu_torch/aio.py (asyncio Protocol) and
    # rio_tpu_torch/native/transport.py (C++ epoll engine). Both dispatch through
    # this class, so semantics are defined once here.
