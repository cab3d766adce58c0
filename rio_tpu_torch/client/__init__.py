"""Cluster-transparent client.

Reference: ``rio-rs/src/client/mod.rs`` — holds a membership view, a
per-address connection cache, and a bounded LRU placement cache
(``:48-65,137-147``); requests flow through a retry/redirect middleware
(``client/tower_services.rs``) that follows ``Redirect`` responses, backs
off on transport errors (1 µs → 2 s, ×20), and invalidates caches.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import random
import time
from dataclasses import dataclass
from time import perf_counter as _perf
from typing import Any, AsyncIterator, Awaitable, Callable

from .. import codec
from ..cluster.storage import MembershipStorage
from ..errors import (
    ClientBuilderError,
    ClientError,
    DeadlineExceeded,
    Disconnect,
    RetryExhausted,
    ServerBusy,
    ServerNotAvailable,
)
from ..protocol import (
    CommandEnvelope,
    ErrorKind,
    RequestEnvelope,
    SubscriptionRequest,
    decode_response,
    decode_subresponse,
    encode_command_frame,
    encode_request_frame,
    encode_subscribe_frame,
)
from ..registry import MESSAGE_TYPES, decode_error, is_readonly_message, type_id
from ..spans import client_ring
from ..tracing import (
    head_sampled,
    new_span_id,
    new_trace_id,
    outbound_ctx,
    span,
)
from ..utils import DecorrelatedJitter, ExponentialBackoff, LruCache

log = logging.getLogger("rio_tpu_torch.client")

DEFAULT_PING_TIMEOUT = 0.5  # reference client/mod.rs:42
DEFAULT_PLACEMENT_LRU = 1000  # reference client/mod.rs:137
DEFAULT_POOL_PER_SERVER = 8


class _ServerConns:
    """Multiplexed bundle of framed connections to one server address.

    Both transports (:class:`rio_tpu_torch.aio.ClientConnProtocol` and the native
    :class:`rio_tpu_torch.native.transport.NativeClientConn`) support pipelining —
    several in-flight requests per socket, responses matched FIFO (the
    server answers each connection in order). The pool therefore keeps up to
    ``limit`` sockets and up to ``PIPELINE_DEPTH`` in-flight requests per
    socket; ``acquire`` prefers an idle socket, dials a new one while under
    ``limit``, and only then stacks requests onto the least-loaded socket.

    ``acquire``/``release`` are explicit methods, not a context manager —
    the request path runs tens of thousands of times a second and an
    ``@asynccontextmanager`` generator per request was measurable.
    """

    # In-flight requests per socket. Measured on the single-core rpc bench
    # (64 workers, 2 servers): 16 -> 25.3k msgs/s, 32 -> 26.6k, 64 -> 24k
    # (deeper stacks grow head-of-line batches past the cork's sweet spot).
    PIPELINE_DEPTH = 32

    def __init__(
        self, address: str, limit: int, timeout: float, engine=None,
        faults=None, identity: str = "",
    ) -> None:
        self.address = address
        self.limit = max(1, limit)
        self.timeout = timeout
        self.engine = engine
        # Fault-injection handle (rio_tpu_torch.faults.TransportFaults) + this
        # client's source identity for (src, dst) link rules; None in every
        # production path — the gates below are then never consulted.
        self.faults = faults
        self.identity = identity
        self.conns: list = []
        self.sem = asyncio.Semaphore(self.limit * self.PIPELINE_DEPTH)
        self._dialing = 0
        self._rr = 0

    async def _connect(self):
        host, _, port = self.address.rpartition(":")
        if self.faults is not None:
            try:
                await self.faults.connect_gate(self.identity, self.address)
            except OSError as e:
                raise ServerNotAvailable(f"{self.address}: {e}") from e
        if self.engine is not None:
            conn = await self.engine.connect(host, int(port), self.timeout)
        else:
            from .. import aio

            try:
                conn = await aio.connect(host, int(port), self.timeout)
            except (OSError, asyncio.TimeoutError) as e:
                raise ServerNotAvailable(f"{self.address}: {e}") from e
        if self.faults is not None:
            conn = self.faults.wrap_conn(conn, self.identity, self.address)
        return conn

    async def acquire(self):
        await self.sem.acquire()
        try:
            conns = self.conns
            n = len(conns)
            if n:
                # Round-robin over open sockets (cheaper than a least-loaded
                # scan at tens of thousands of acquires/sec); dial a fresh
                # socket only while under ``limit`` and the pick is busy.
                self._rr += 1
                conn = conns[self._rr % n]
                if conn.closed:
                    self.conns = conns = [c for c in conns if not c.closed]
                    n = len(conns)
                    conn = conns[self._rr % n] if n else None
                if conn is not None and (
                    conn.pending == 0 or n + self._dialing >= self.limit
                ):
                    return conn
            self._dialing += 1
            try:
                conn = await self._connect()
            finally:
                self._dialing -= 1
            self.conns.append(conn)
            return conn
        except BaseException:
            self.sem.release()
            raise

    def release(self, conn, *, reuse: bool) -> None:
        if not reuse:
            conn.close()
            with contextlib.suppress(ValueError):
                self.conns.remove(conn)
        self.sem.release()

    def close(self) -> None:
        for c in self.conns:
            c.close()
        self.conns.clear()


@dataclass
class ClientStats:
    """Network-level counters (feeds the measured route-hop metric).

    ``roundtrips`` counts completed request/response exchanges with a
    server — the "hops" of BASELINE.md's p99-route-hops headline; a
    redirect costs one extra roundtrip, exactly as in the reference's
    retry middleware (``client/tower_services.rs:158-209``).
    """

    requests: int = 0
    roundtrips: int = 0
    redirects: int = 0
    dial_failures: int = 0  # attempts that died before a response (dead addr)
    busy_retries: int = 0  # SERVER_BUSY sheds answered with backoff + re-route
    standby_routes: int = 0  # read attempts sent to a standby seat (readscale)
    shard_routes: int = 0  # attempts direct-dialed via the adopted shard map
    deadline_exceeded: int = 0  # DEADLINE_EXCEEDED verdicts (server or client)
    qos_sheds: int = 0  # SERVER_BUSY sheds issued by a server's QoS scheduler


class Client:
    """Send requests to any object in the cluster, from anywhere.

    Usually built via :class:`ClientBuilder` or ``Client(members_storage)``.

    ``placement_resolver`` is the rio-tpu routing policy: an async
    ``(handler_type, handler_id) -> address | None`` consulted on a
    placement-cache miss *before* falling back to the reference's
    random-server pick (``client/mod.rs:255-262``). Point it at a shared
    directory (e.g. ``JaxObjectPlacement.lookup``) and cache-miss requests
    dial the owner directly — 1 hop instead of a redirect round trip.
    """

    def __init__(
        self,
        members_storage: MembershipStorage,
        *,
        placement_cache_size: int = DEFAULT_PLACEMENT_LRU,
        pool_per_server: int = DEFAULT_POOL_PER_SERVER,
        connect_timeout: float = DEFAULT_PING_TIMEOUT,
        backoff: ExponentialBackoff | None = None,
        transport: str = "asyncio",
        placement_resolver: Callable[[str, str], Awaitable[str | None]] | None = None,
        membership_view_ttl: float = 1.0,
        read_scale: Any | None = None,
        standby_resolver: Callable[[str, str], Awaitable[list[str]]] | None = None,
        transport_faults: Any | None = None,
        identity: str = "",
        shard_aware: bool = False,
        tenant: str = "",
        priority: int = 0,
        deadline_ms: int = 0,
    ) -> None:
        if transport not in ("asyncio", "native", "auto"):
            raise ValueError(f"unknown transport {transport!r}")
        self.members_storage = members_storage
        self.stats = ClientStats()
        # QoS defaults stamped on every send unless the call overrides them.
        # All-default (""/0/0) keeps frames byte-identical to the pre-QoS
        # wire — safe against servers that predate the QoS fields.
        self.tenant = tenant
        self.priority = priority
        self.deadline_ms = deadline_ms
        # Shard-aware routing: adopt the ShardMap a sharded node publishes
        # through its membership rows (rio_tpu_torch/sharded.py) and compute
        # crc32 % N locally on a cache miss — the owning worker's identity
        # address is dialed directly, zero redirects for unplaced traffic.
        # Cached placements / seat hints still override the hash map,
        # mirroring the server-side ShardRouter precedence.
        self._shard_aware = shard_aware
        self._shard_map: Any | None = None  # rio_tpu_torch.commands.ShardMap
        self._ph_tick = -1  # 1-in-8 client-hop stride for untraced traffic
        # Fault-injection handle + source identity for (src, dst) link
        # rules (rio_tpu_torch.faults.TransportFaults); None in production.
        self._transport_faults = transport_faults
        self._identity = identity
        self._placement_resolver = placement_resolver
        self._view_ttl = membership_view_ttl
        self._view_ts = float("-inf")
        self._placement: LruCache[tuple[str, str], str] = LruCache(placement_cache_size)
        # Read scale-out (rio_tpu_torch/readscale): a ReadScaleConfig enables
        # routing @readonly requests to standby seats — reactively when a
        # SERVER_BUSY shed names them (cached here with a TTL), proactively
        # via ``standby_resolver`` when the primary's cluster-load entry is
        # hot. ``None`` keeps every request on the primary, bit-for-bit the
        # pre-readscale behavior.
        self._read_scale = read_scale
        self._standby_resolver = standby_resolver
        self._read_seats: LruCache[tuple[str, str], tuple[list[str], float]] = (
            LruCache(placement_cache_size)
        )
        self._load_view: Any | None = None
        self._load_view_ts = float("-inf")
        self._conns: dict[str, _ServerConns] = {}
        self._active_servers: list[str] = []
        self._pool_per_server = pool_per_server
        self._connect_timeout = connect_timeout
        self._backoff = backoff or ExponentialBackoff()
        # Resolve the native codec eagerly (may compile once) so the first
        # send() doesn't do it inside the event loop.
        from .. import native as _native

        lib = _native.get()
        self._client_engine = None
        if transport == "native" or (transport == "auto" and _native.engine_profitable()):
            from ..native.transport import ClientEngine

            # Request and subscription connections ride the engine's IO
            # thread; pings keep asyncio streams (cold path, gossip-rate).
            self._client_engine = ClientEngine()

    # -- server/membership view (reference client/mod.rs:153-220) -----------

    async def fetch_active_servers(self, refresh: bool = False) -> list[str]:
        # TTL'd view: the reference refetches per request and relies on
        # storage-side caching (client/mod.rs:153-172); we refetch when the
        # view is older than the TTL so a client that only ever hits one
        # healthy server still learns about new nodes.
        loop = asyncio.get_event_loop()
        stale = (loop.time() - self._view_ts) > self._view_ttl
        if refresh or stale or not self._active_servers:
            try:
                members = await self.members_storage.active_members()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — rendezvous outage
                if self._active_servers:
                    # Serve the stale view: the servers in it are (probably)
                    # still up even though the membership store is not.
                    # Re-stamp the TTL so a long outage costs one failed
                    # refresh per TTL, not one per request.
                    self._view_ts = loop.time()
                    return self._active_servers
                raise ServerNotAvailable(
                    f"membership view unavailable: {e!r}"
                ) from e
            self._active_servers = [m.address for m in members]
            self._view_ts = loop.time()
            if self._shard_aware:
                self._adopt_shard_map(members)
        return self._active_servers

    def _adopt_shard_map(self, members: list) -> None:
        """Adopt the freshest published shard map from the active view.

        Highest epoch wins across rows (every worker of one node publishes
        the same map, but mid-reseat rows can mix epochs). On an epoch/slot
        change the previous map's derived state — seat hints and cached
        placements — is dropped: a SIGKILLed worker's reseated slice must
        not keep being direct-dialed off the stale map (the client falls
        back to redirect-follow until the new rows converge, then re-adopts).
        """
        from ..commands import ShardMap

        best: Any | None = None
        for m in members:
            decoded = ShardMap.decode(getattr(m, "shard_map", ""))
            if decoded is not None and (best is None or decoded.epoch > best.epoch):
                best = decoded
        if best is None or best == self._shard_map:
            return
        if self._shard_map is not None:
            # Map CHANGED (not first adoption): everything derived under
            # the old map is suspect.
            self._read_seats.clear()
            self._placement.clear()
        self._shard_map = best

    def _pool(self, address: str) -> _ServerConns:
        pool = self._conns.get(address)
        if pool is None:
            pool = _ServerConns(
                address, self._pool_per_server, self._connect_timeout,
                engine=self._client_engine,
                faults=self._transport_faults, identity=self._identity,
            )
            self._conns[address] = pool
        return pool

    def _invalidate(self, address: str | None = None) -> None:
        self._active_servers = []
        if address is not None:
            pool = self._conns.pop(address, None)
            if pool:
                pool.close()

    async def _pick_address(
        self, handler_type: str, handler_id: str, avoid: set[str] | None = None
    ) -> str:
        """Routing decision for one attempt.

        ``avoid`` carries addresses that already failed *for this request*
        (dial failure / disconnect): a cached or resolver answer in that set
        is ignored — a directory serving a stale snapshot that points at a
        dead node must degrade to the reference's random-pick policy, not
        pin the request to the dead answer until retries exhaust.
        """
        cached = self._placement.get((handler_type, handler_id))
        if cached is not None and (avoid is None or cached not in avoid):
            return cached
        if self._placement_resolver is not None:
            # Directory policy: ask the shared placement directory for the
            # owner before dialing anyone. A stale/None answer falls through
            # to the reference policy below; a wrong one costs one redirect.
            resolved = await self._placement_resolver(handler_type, handler_id)
            if resolved is not None and (avoid is None or resolved not in avoid):
                return resolved
        servers = await self.fetch_active_servers()
        if not servers:
            servers = await self.fetch_active_servers(refresh=True)
        if not servers:
            raise ServerNotAvailable("no active servers in membership view")
        if self._shard_map is not None:
            # Shard-aware direct dial: crc32 % N against the adopted map
            # (refreshed by the fetch above), but ONLY while the owner is an
            # active member that hasn't already failed this request — a dead
            # worker's slice degrades to the redirect-follow path below,
            # exactly like the server-side ShardRouter's dead-owner branch.
            owner = self._shard_map.owner(handler_type, handler_id)
            if owner in servers and (avoid is None or owner not in avoid):
                self.stats.shard_routes += 1
                return owner
        if avoid:
            alive = [s for s in servers if s not in avoid]
            if alive:
                servers = alive
        # Random pick on cache miss (reference client/mod.rs:255-262); the
        # receiving server self-assigns or redirects us to the owner.
        return random.choice(servers)

    # -- read scale-out routing (rio_tpu_torch/readscale) --------------------------

    def _seat_hint(self, key: tuple[str, str]) -> list[str]:
        """Fresh cached standby seats for a key, else ``[]``."""
        hint = self._read_seats.get(key)
        if hint is None:
            return []
        ttl = getattr(self._read_scale, "seat_hint_ttl", 2.0)
        if asyncio.get_event_loop().time() - hint[1] > ttl:
            return []
        return list(hint[0])

    def _cache_seats(self, key: tuple[str, str], seats: list[str]) -> None:
        self._read_seats.put(key, (seats, asyncio.get_event_loop().time()))

    async def _primary_hot(self, key: tuple[str, str]) -> bool:
        """Does the cluster-load view call the cached primary hot?

        Proactive half of read routing: before the primary has to shed, a
        derate under ``hot_derate`` on its heartbeat vector diverts reads.
        Built from the same ``members()`` read the servers use — no new
        RPC kinds, and the view is TTL'd like the active-servers list.
        """
        addr = self._placement.get(key)
        if addr is None:
            return False
        loop = asyncio.get_event_loop()
        if (
            self._load_view is None
            or loop.time() - self._load_view_ts > self._view_ttl
        ):
            from ..load import ClusterLoadView

            self._load_view = ClusterLoadView.from_members(
                await self.members_storage.members()
            )
            self._load_view_ts = loop.time()
        entry = self._load_view.get(addr)
        if entry is None or entry.stale:
            return False
        return entry.derate < getattr(self._read_scale, "hot_derate", 0.7)

    async def _read_route_seats(
        self, handler_type: str, handler_id: str, key: tuple[str, str]
    ) -> list[str]:
        """Standby seats worth routing this readonly request to (maybe [])."""
        seats = self._seat_hint(key)
        if seats:
            return seats
        if self._standby_resolver is None or not await self._primary_hot(key):
            return []
        try:
            seats = [s for s in await self._standby_resolver(handler_type, handler_id) if s]
        except Exception:  # noqa: BLE001 — discovery is best-effort
            return []
        if seats:
            self._cache_seats(key, seats)
        return seats

    # -- request path (reference tower_services.rs:96-226) -------------------

    async def send_raw(
        self,
        handler_type: str,
        handler_id: str,
        message_type: str,
        payload: bytes,
        *,
        tenant: str | None = None,
        priority: int | None = None,
        deadline_ms: int | None = None,
    ) -> bytes:
        # Per-call QoS classification falls back to the client defaults;
        # the resolved triple rides the envelope (omitted from the wire
        # when all-default, so legacy frames stay byte-identical).
        qos = (
            self.tenant if tenant is None else tenant,
            self.priority if priority is None else priority,
            self.deadline_ms if deadline_ms is None else deadline_ms,
        )
        # Trace-context resolution, cheapest case first: with no active
        # trace and sampling off this is two function calls, then straight
        # into the untraced (legacy-wire-identical) path.
        ctx = outbound_ctx()
        if ctx is not None:
            # Already inside a trace (a server-side forward, or application
            # code under a span): forward it — never re-sample.
            return await self._send_raw(
                handler_type, handler_id, message_type, payload, ctx, qos
            )
        if not head_sampled():
            return await self._send_raw(
                handler_type, handler_id, message_type, payload, None, qos
            )
        from .. import tracing

        if tracing._ENABLED:
            # A sink is registered: root a real client span so the trace
            # has its client-side timing, and propagate its ids.
            with span("client_request", object=handler_type, id=handler_id):
                return await self._send_raw(
                    handler_type, handler_id, message_type, payload,
                    outbound_ctx(), qos,
                )
        # Sampled but unsinked locally (e.g. only servers export): ship
        # fresh ids without allocating a Span.
        return await self._send_raw(
            handler_type,
            handler_id,
            message_type,
            payload,
            (new_trace_id(), new_span_id(), True),
            qos,
        )

    async def _send_raw(
        self,
        handler_type: str,
        handler_id: str,
        message_type: str,
        payload: bytes,
        trace_ctx: tuple[str, str, bool] | None,
        qos: tuple[str, int, int] = ("", 0, 0),
    ) -> bytes:
        ring = client_ring()
        if ring is None:
            # Retention disarmed (the default): one module-global read, then
            # the pre-waterfall request path unchanged.
            return await self._send_attempts(
                handler_type, handler_id, message_type, payload, trace_ctx,
                qos=qos,
            )
        if trace_ctx is None:
            # Untraced: sample the phase clock on the 1-in-8 stride so the
            # ring's tail capture can still see slow outliers.
            self._ph_tick = tick = (self._ph_tick + 1) & 7
            if tick:
                return await self._send_attempts(
                    handler_type, handler_id, message_type, payload, trace_ctx,
                    qos=qos,
                )
        hop = {"await_us": 0}
        t0 = _perf()
        rt0, rd0 = self.stats.roundtrips, self.stats.redirects
        status = ""
        try:
            return await self._send_attempts(
                handler_type, handler_id, message_type, payload, trace_ctx, hop,
                qos=qos,
            )
        except BaseException as e:
            status = type(e).__name__
            raise
        finally:
            total_us = int((_perf() - t0) * 1e6)
            traced = trace_ctx is not None
            if traced or (ring.slo_ms > 0.0 and total_us >= ring.slo_ms * 1000.0):
                if traced:
                    trace_id, span_id = trace_ctx[0], trace_ctx[1]
                else:
                    trace_id, span_id = new_trace_id(), new_span_id()
                    ring.tail_captured += 1
                attrs: dict[str, Any] = {
                    "handler": f"{handler_type}/{handler_id}",
                    "msg": message_type,
                    # send/route time (pick + acquire + encode + backoff)
                    # vs time spent awaiting server roundtrips.
                    "send_us": max(0, total_us - hop["await_us"]),
                    "await_us": hop["await_us"],
                    "roundtrips": self.stats.roundtrips - rt0,
                    "redirects": self.stats.redirects - rd0,
                }
                if status:
                    attrs["error"] = status
                if not traced:
                    attrs["tail"] = 1
                # The client hop's span id IS the wire parent id, so the
                # server hops it fans out to nest under it in the waterfall.
                ring.record(
                    trace_id=trace_id,
                    span_id=span_id,
                    parent_id="",
                    name="client_request",
                    wall_start=time.time() - total_us / 1e6,
                    duration_us=total_us,
                    attrs=attrs,
                )

    async def _send_attempts(
        self,
        handler_type: str,
        handler_id: str,
        message_type: str,
        payload: bytes,
        trace_ctx: tuple[str, str, bool] | None,
        hop: dict | None = None,
        qos: tuple[str, int, int] = ("", 0, 0),
    ) -> bytes:
        tenant, priority, deadline_ms = qos
        if not tenant or priority == 0 or deadline_ms <= 0:
            # Hop propagation: a Client used INSIDE a handler (stream-cursor
            # remote delivery, saga fan-out) inherits the request's QoS scope
            # for whatever wasn't set explicitly — the deadline forwards as
            # the strictly-decremented remaining budget, and a spent budget
            # refuses the send instead of fanning out doomed work. Outside a
            # handler the scope is empty and nothing changes.
            from ..qos import current_scope, scope_budget_ms

            s_tenant, s_priority, _ = current_scope()
            if not tenant:
                tenant = s_tenant
            if priority == 0:
                priority = s_priority
            if deadline_ms <= 0:
                budget = scope_budget_ms()
                if budget < 0:
                    self.stats.deadline_exceeded += 1
                    raise DeadlineExceeded("", "inherited deadline budget spent")
                deadline_ms = budget
        env = RequestEnvelope(
            handler_type, handler_id, message_type, payload, trace_ctx,
            tenant=tenant, priority=priority, deadline_ms=deadline_ms,
        )
        # Encoded ONCE before the retry loop: redirect-follow and busy
        # retries reuse the same frame, so one trace_ctx spans every hop
        # this request takes. A deadline changes that — each attempt
        # re-encodes with the REMAINING budget (time already burned on
        # earlier attempts and backoff sleeps must not be granted again
        # server-side), and the loop stops once the budget is spent.
        frame_bytes = encode_request_frame(env)
        deadline_t0 = time.monotonic() if deadline_ms > 0 else 0.0
        key = (handler_type, handler_id)
        self.stats.requests += 1
        last: BaseException | None = None
        attempts = 0
        avoid: set[str] = set()  # addresses that failed for THIS request
        # Read scale-out: a @readonly request with known standby seats fans
        # out across them instead of queueing on the hot primary.
        is_read = self._read_scale is not None and is_readonly_message(
            handler_type, message_type
        )
        read_seats: list[str] = []
        if is_read:
            read_seats = await self._read_route_seats(handler_type, handler_id, key)
        jitter: DecorrelatedJitter | None = None
        for delay in self._backoff.delays():
            attempts += 1
            if deadline_ms > 0:
                from ..qos import remaining_budget_ms

                remaining = remaining_budget_ms(
                    deadline_ms, time.monotonic() - deadline_t0
                )
                if remaining <= 0:
                    # Budget spent client-side (backoff sleeps + earlier
                    # attempts): retrying is doomed work — every further
                    # hop would shed it anyway.
                    self.stats.deadline_exceeded += 1
                    raise DeadlineExceeded(
                        "", f"budget spent after {attempts - 1} attempts"
                    )
                if remaining != env.deadline_ms:
                    env.deadline_ms = remaining
                    frame_bytes = encode_request_frame(env)
            address = None
            via_seat = False
            try:
                if read_seats:
                    cand = [s for s in read_seats if s not in avoid]
                    if cand:
                        address = random.choice(cand)
                        via_seat = True
                        self.stats.standby_routes += 1
                if address is None:
                    address = await self._pick_address(handler_type, handler_id, avoid)
                pool = self._pool(address)
                conn = await pool.acquire()
                seen = conn.delivered
                if hop is not None:
                    t_send = _perf()
                try:
                    raw = await conn.roundtrip(frame_bytes)
                except asyncio.CancelledError:
                    # Caller timeout/cancel: both transports discard the
                    # orphaned response, so the shared pipelined socket stays
                    # usable — closing it would kill every sibling in-flight
                    # request for no reason.  But only while the connection
                    # is making progress: if NO frame arrived since this
                    # send, the server side is likely head-of-line hung and
                    # reusing the conn would zombie the pool (every later
                    # request round-robins onto a socket that never answers).
                    pool.release(conn, reuse=conn.delivered > seen)
                    raise
                except BaseException:
                    pool.release(conn, reuse=False)
                    raise
                pool.release(conn, reuse=True)
                if hop is not None:
                    hop["await_us"] += int((_perf() - t_send) * 1e6)
                self.stats.roundtrips += 1
            except (ServerNotAvailable, Disconnect, OSError) as e:
                last = e
                if address is not None:  # a real network attempt died
                    self.stats.dial_failures += 1
                    avoid.add(address)
                self._placement.pop(key)
                self._invalidate(None)
                await asyncio.sleep(delay)
                continue
            resp = decode_response(raw)
            if resp.is_ok:
                if not via_seat:
                    # A standby-served read must NOT feed the placement
                    # cache: the next WRITE would land on the standby and
                    # bounce (or worse, self-assign a second primary row).
                    self._placement.put(key, address)
                return resp.body or b""
            err = resp.error
            assert err is not None
            if err.kind == ErrorKind.REDIRECT:
                # Authoritative owner elsewhere: note it and retry there
                # immediately (no backoff — reference tower_services.rs:158-167).
                # A redirect target overrides an earlier dial failure to the
                # same address (one dropped pooled connection must not ban a
                # healthy owner for the request's remaining attempts).
                self.stats.redirects += 1
                avoid.discard(err.detail)
                self._placement.put(key, err.detail)
                continue
            if err.kind == ErrorKind.SERVER_BUSY:
                # Overload shed: back off and retry AGAINST ANOTHER MEMBER —
                # the busy node joins this request's avoid set and its
                # placement-cache entry is dropped, so the next pick lands
                # elsewhere and self-assigns. Unlike a dial failure the
                # connection is healthy (the server answered), so the pool
                # is NOT invalidated.
                last = ServerBusy(address or "", err.detail)
                self.stats.busy_retries += 1
                if err.detail.startswith("qos:"):
                    # Shed by the server's QoS admission layer (token
                    # bucket / full class queue), not the load monitor.
                    self.stats.qos_sheds += 1
                if address is not None:
                    avoid.add(address)
                seats = []
                if err.payload:
                    from ..readscale import decode_seat_hint

                    seats = [s for s in decode_seat_hint(err.payload) if s not in avoid]
                if seats:
                    # The shed names read-capable standby seats: cache them
                    # for later requests and — for a readonly request —
                    # retry against one immediately (the redirect pattern:
                    # the server told us where the capacity is, sleeping
                    # first would only stretch the hot key's p99). The
                    # primary row stays cached: it is still the correct
                    # write target.
                    self._cache_seats(key, seats)
                    if is_read:
                        read_seats = seats
                        continue
                self._placement.pop(key)
                # Decorrelated jitter, one sequence per request: a shed
                # synchronizes every rejected client on the same clock
                # tick, and deterministic exponential delays would march
                # them back in lockstep to collide again.
                if jitter is None:
                    jitter = DecorrelatedJitter(
                        base=self._backoff.initial, cap=self._backoff.cap
                    )
                await asyncio.sleep(jitter.next())
                continue
            if err.kind == ErrorKind.DEADLINE_EXCEEDED:
                # A server dropped the request as doomed (budget expired
                # before its handler started). Retryable exactly like
                # SERVER_BUSY — but only while budget remains: the
                # top-of-loop check raises once it is spent.
                last = DeadlineExceeded(address or "", err.detail)
                self.stats.deadline_exceeded += 1
                if address is not None:
                    avoid.add(address)
                self._placement.pop(key)
                if jitter is None:
                    jitter = DecorrelatedJitter(
                        base=self._backoff.initial, cap=self._backoff.cap
                    )
                await asyncio.sleep(jitter.next())
                continue
            if err.kind in (ErrorKind.DEALLOCATE, ErrorKind.ALLOCATE):
                last = ClientError(f"{err.kind.name}: {err.detail}")
                self._placement.pop(key)
                self._invalidate(address)
                await asyncio.sleep(delay)
                continue
            if err.kind == ErrorKind.APPLICATION:
                raise decode_error(err.payload, err.detail)
            raise ClientError(f"{err.kind.name}: {err.detail}")
        raise RetryExhausted(attempts, last)

    async def send(
        self,
        handler_type: str | type,
        handler_id: str,
        msg: Any,
        returns: Any = Any,
        *,
        tenant: str | None = None,
        priority: int | None = None,
        deadline_ms: int | None = None,
    ) -> Any:
        """Typed request: serialize ``msg``, await and decode the response.

        ``tenant``/``priority``/``deadline_ms`` classify the request for
        QoS-enabled servers (``None`` = the client's configured defaults):
        ``priority > 0`` dispatches in strict tiers above the fair ring,
        ``deadline_ms`` is the remaining time budget — the server sheds
        the request (retryable ``DEADLINE_EXCEEDED``) rather than run a
        handler whose caller already gave up.
        """
        tname = handler_type if isinstance(handler_type, str) else type_id(handler_type)
        raw = await self.send_raw(
            tname, handler_id, type_id(type(msg)), codec.serialize(msg),
            tenant=tenant, priority=priority, deadline_ms=deadline_ms,
        )
        return codec.deserialize(raw, returns)

    # -- control-plane commands (streams/sagas, KIND_COMMAND frames) ---------

    async def send_command(
        self, command: str, subject: str, payload: bytes = b""
    ) -> bytes:
        """One control-plane command against any cluster member.

        Saga commands route like requests to the coordinator actor
        (placement cache + redirect-follow); stream commands are legal on
        any member (the append log has no owner) and just cache whichever
        address answered. An old server that predates KIND_COMMAND answers
        NOT_SUPPORTED — surfaced as :class:`ClientError` with that prefix,
        never a connection reset.
        """
        ctx = outbound_ctx()
        if ctx is None and head_sampled():
            from .. import tracing

            if tracing._ENABLED:
                with span("client_command", object=command, id=subject):
                    return await self._command_attempts(
                        command, subject, payload, outbound_ctx()
                    )
            ctx = (new_trace_id(), new_span_id(), True)
        return await self._command_attempts(command, subject, payload, ctx)

    async def _command_attempts(
        self,
        command: str,
        subject: str,
        payload: bytes,
        trace_ctx: tuple[str, str, bool] | None,
    ) -> bytes:
        frame_bytes = encode_command_frame(
            CommandEnvelope(command, subject, payload, trace_ctx)
        )
        # Saga commands share the coordinator's real placement key so the
        # cache and redirects line up with ordinary requests to it; stream
        # commands key on a synthetic type that no server ever redirects.
        if command.startswith("saga."):
            key = ("rio.Saga", subject)
        else:
            key = ("rio.stream.cmd", subject)
        self.stats.requests += 1
        last: BaseException | None = None
        attempts = 0
        avoid: set[str] = set()
        jitter: DecorrelatedJitter | None = None
        for delay in self._backoff.delays():
            attempts += 1
            address = None
            try:
                address = await self._pick_address(key[0], key[1], avoid)
                pool = self._pool(address)
                conn = await pool.acquire()
                seen = conn.delivered
                try:
                    raw = await conn.roundtrip(frame_bytes)
                except asyncio.CancelledError:
                    pool.release(conn, reuse=conn.delivered > seen)
                    raise
                except BaseException:
                    pool.release(conn, reuse=False)
                    raise
                pool.release(conn, reuse=True)
                self.stats.roundtrips += 1
            except (ServerNotAvailable, Disconnect, OSError) as e:
                last = e
                if address is not None:
                    self.stats.dial_failures += 1
                    avoid.add(address)
                self._placement.pop(key)
                self._invalidate(None)
                await asyncio.sleep(delay)
                continue
            resp = decode_response(raw)
            if resp.is_ok:
                self._placement.put(key, address)
                return resp.body or b""
            err = resp.error
            assert err is not None
            if err.kind == ErrorKind.REDIRECT:
                self.stats.redirects += 1
                avoid.discard(err.detail)
                self._placement.put(key, err.detail)
                continue
            if err.kind == ErrorKind.SERVER_BUSY:
                last = ServerBusy(address or "", err.detail)
                self.stats.busy_retries += 1
                if address is not None:
                    avoid.add(address)
                self._placement.pop(key)
                if jitter is None:
                    jitter = DecorrelatedJitter(
                        base=self._backoff.initial, cap=self._backoff.cap
                    )
                await asyncio.sleep(jitter.next())
                continue
            if err.kind in (ErrorKind.DEALLOCATE, ErrorKind.ALLOCATE):
                last = ClientError(f"{err.kind.name}: {err.detail}")
                self._placement.pop(key)
                self._invalidate(address)
                await asyncio.sleep(delay)
                continue
            if err.kind == ErrorKind.APPLICATION:
                raise decode_error(err.payload, err.detail)
            raise ClientError(f"{err.kind.name}: {err.detail}")
        raise RetryExhausted(attempts, last)

    async def publish_stream(
        self, stream: str, message: Any, *, key: str = ""
    ) -> tuple[int, int]:
        """Durably publish ``message``; returns the acked
        ``(partition, offset)`` — the remote face of
        :func:`rio_tpu_torch.streams.cursor.publish`."""
        payload = codec.serialize(
            [stream, key, type_id(type(message)), codec.serialize(message)]
        )
        raw = await self.send_command("stream.publish", stream, payload)
        partition, offset = codec.deserialize(raw, Any)
        return int(partition), int(offset)

    async def subscribe_stream(
        self,
        stream: str,
        group: str,
        target_type: str | type,
        *,
        redelivery_period: float = 2.0,
    ) -> None:
        """Attach a consumer group remotely (see
        :func:`rio_tpu_torch.streams.cursor.subscribe_group`)."""
        tname = target_type if isinstance(target_type, str) else type_id(target_type)
        await self.send_command(
            "stream.subscribe",
            stream,
            codec.serialize([group, tname, float(redelivery_period)]),
        )

    async def unsubscribe_stream(self, stream: str, group: str) -> None:
        await self.send_command(
            "stream.unsubscribe", stream, codec.serialize([group])
        )

    async def stream_cursors(self, stream: str, group: str) -> dict[int, int]:
        """Committed offset per partition (consumer-lag probe)."""
        raw = await self.send_command(
            "stream.cursors", stream, codec.serialize([group])
        )
        return {int(p): int(o) for p, o in codec.deserialize(raw, Any)}

    async def start_saga(self, saga_id: str, steps: list) -> Any:
        """Start (or idempotently re-observe) a saga; returns its
        :class:`~rio_tpu_torch.streams.saga.SagaStatusReply`. Build ``steps``
        with :func:`rio_tpu_torch.streams.saga.step`."""
        from ..streams.saga import SagaStatusReply, StartSaga

        raw = await self.send_command(
            "saga.start", saga_id, codec.serialize(StartSaga(steps=steps))
        )
        return codec.deserialize(raw, SagaStatusReply)

    async def saga_status(self, saga_id: str) -> Any:
        from ..streams.saga import SagaStatus, SagaStatusReply

        raw = await self.send_command(
            "saga.status", saga_id, codec.serialize(SagaStatus())
        )
        return codec.deserialize(raw, SagaStatusReply)

    # -- pub/sub (reference client/mod.rs:341-401) ---------------------------

    async def subscribe(
        self, handler_type: str | type, handler_id: str, decode: bool = True
    ) -> AsyncIterator[Any]:
        """Async-iterate an object's published messages.

        Follows redirects by reconnecting to the owner; transport drops
        trigger a resubscribe with backoff.
        """
        tname = handler_type if isinstance(handler_type, str) else type_id(handler_type)
        frame_bytes = encode_subscribe_frame(SubscriptionRequest(tname, handler_id))

        async def iterate() -> AsyncIterator[Any]:
            attempt = 0
            while True:
                try:
                    address = await self._pick_address(tname, handler_id)
                    host, _, port = address.rpartition(":")
                    if self._client_engine is not None:
                        conn = await self._client_engine.connect(
                            host, int(port), self._connect_timeout
                        )
                    else:
                        from .. import aio

                        conn = await aio.connect(
                            host, int(port), self._connect_timeout
                        )
                    write_frame = conn.write
                    next_frame = conn.read_frame
                    close = conn.close
                except (OSError, asyncio.TimeoutError, ServerNotAvailable) as e:
                    attempt += 1
                    if attempt > self._backoff.max_retries:
                        raise RetryExhausted(attempt, e)
                    self._placement.pop((tname, handler_id))
                    self._invalidate(None)
                    await self._backoff.sleep(attempt)
                    continue
                try:
                    write_frame(frame_bytes)
                    while True:
                        payload = await next_frame()
                        if payload is None:
                            break  # server went away: resubscribe
                        resp = decode_subresponse(payload)
                        if resp.error is not None:
                            if resp.error.kind == ErrorKind.REDIRECT:
                                self._placement.put((tname, handler_id), resp.error.detail)
                                break
                            raise ClientError(
                                f"{resp.error.kind.name}: {resp.error.detail}"
                            )
                        attempt = 0
                        self._placement.put((tname, handler_id), address)
                        if decode:
                            cls = MESSAGE_TYPES.get(resp.message_type)
                            yield codec.deserialize(resp.body, cls or Any)
                        else:
                            yield resp
                finally:
                    with contextlib.suppress(Exception):
                        close()
                attempt += 1
                if attempt > self._backoff.max_retries:
                    raise RetryExhausted(attempt, Disconnect("subscription dropped"))
                await self._backoff.sleep(min(attempt, 10))

        return iterate()

    # -- health probe (reference client/mod.rs:407-431) ----------------------

    async def ping(self, address: str) -> bool:
        """TCP reachability probe with the gossip timeout (500 ms default)."""
        host, _, port = address.rpartition(":")
        if self._transport_faults is not None:
            try:
                await self._transport_faults.connect_gate(self._identity, address)
            except OSError:
                return False
        try:
            _, writer = await asyncio.wait_for(
                asyncio.open_connection(host, int(port)), self._connect_timeout
            )
        except (OSError, asyncio.TimeoutError, ValueError):
            return False
        writer.close()
        with contextlib.suppress(Exception):
            await writer.wait_closed()
        return True

    def close(self) -> None:
        for pool in self._conns.values():
            pool.close()
        self._conns.clear()
        if self._client_engine is not None:
            self._client_engine.close()


class ClientBuilder:
    """Fluent builder (reference ``client/builder.rs:15-68``)."""

    def __init__(self) -> None:
        self._storage: MembershipStorage | None = None
        self._lru = DEFAULT_PLACEMENT_LRU
        self._pool = DEFAULT_POOL_PER_SERVER
        self._timeout = DEFAULT_PING_TIMEOUT

    def members_storage(self, storage: MembershipStorage) -> "ClientBuilder":
        self._storage = storage
        return self

    def placement_cache_size(self, n: int) -> "ClientBuilder":
        self._lru = n
        return self

    def pool_per_server(self, n: int) -> "ClientBuilder":
        self._pool = n
        return self

    def connect_timeout(self, seconds: float) -> "ClientBuilder":
        self._timeout = seconds
        return self

    def backoff(self, policy: ExponentialBackoff) -> "ClientBuilder":
        """Retry/backoff policy for request sends (see
        :class:`~rio_tpu_torch.utils.backoff.ExponentialBackoff`)."""
        self._backoff_policy = policy
        return self

    def membership_view_ttl(self, seconds: float) -> "ClientBuilder":
        """How long the cached active-servers view is trusted before a
        storage refetch."""
        self._view_ttl_value = seconds
        return self

    def transport(self, transport: str) -> "ClientBuilder":
        """Socket/framing backend: "asyncio" (default), "native", or "auto"."""
        if transport not in ("asyncio", "native", "auto"):
            raise ClientBuilderError(f"unknown transport {transport!r}")
        self._transport = transport
        return self

    def placement_resolver(
        self, resolver: Callable[[str, str], Awaitable[str | None]]
    ) -> "ClientBuilder":
        """Directory routing policy (see :class:`Client`)."""
        self._resolver = resolver
        return self

    def read_scale(self, config: Any) -> "ClientBuilder":
        """Enable standby read routing (a
        :class:`~rio_tpu_torch.readscale.ReadScaleConfig`; see :class:`Client`)."""
        self._read_scale_config = config
        return self

    def standby_resolver(
        self, resolver: Callable[[str, str], Awaitable[list[str]]]
    ) -> "ClientBuilder":
        """Directory standby-seat discovery for proactive read routing."""
        self._standby_resolver_fn = resolver
        return self

    def shard_aware(self, enabled: bool = True) -> "ClientBuilder":
        """Adopt published shard maps and direct-dial the owning worker
        (see :class:`Client`)."""
        self._shard_aware_flag = enabled
        return self

    def qos(
        self, *, tenant: str = "", priority: int = 0, deadline_ms: int = 0
    ) -> "ClientBuilder":
        """Default QoS classification for every request this client sends
        (per-call ``send(..., tenant=, priority=, deadline_ms=)`` overrides).
        All-default keeps the wire byte-identical to a pre-QoS client."""
        self._qos_defaults = (tenant, priority, deadline_ms)
        return self

    def build(self) -> Client:
        if self._storage is None:
            raise ClientBuilderError("members_storage is required")
        tenant, priority, deadline_ms = getattr(self, "_qos_defaults", ("", 0, 0))
        return Client(
            self._storage,
            placement_cache_size=self._lru,
            pool_per_server=self._pool,
            connect_timeout=self._timeout,
            backoff=getattr(self, "_backoff_policy", None),
            transport=getattr(self, "_transport", "asyncio"),
            placement_resolver=getattr(self, "_resolver", None),
            membership_view_ttl=getattr(self, "_view_ttl_value", 1.0),
            read_scale=getattr(self, "_read_scale_config", None),
            standby_resolver=getattr(self, "_standby_resolver_fn", None),
            shard_aware=getattr(self, "_shard_aware_flag", False),
            tenant=tenant,
            priority=priority,
            deadline_ms=deadline_ms,
        )
