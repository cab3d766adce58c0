"""Server: one cluster node.

Reference: ``rio-rs/src/server.rs`` — builder (``:85-110``), storage
migrations in ``prepare`` (``:120-125``), ``bind`` (``:135-140``), and a
``run`` loop that drives the TCP acceptor, the cluster provider, the
internal-client consumer, the admin consumer, and the optional HTTP
membership endpoint concurrently (``:178-283``).
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import time

from .app_data import AppData
from .cluster.membership_protocol import ClusterProvider
from .cluster.storage import MembershipStorage
from .commands import (
    AdminCommand,
    AdminCommandKind,
    AdminSender,
    DispatchObserver,
    InternalClientSender,
    SendCommand,
    ServerDraining,
    ServerInfo,
)
from .errors import ServerError
from .journal import (
    MEMBER_CORDON,
    PLACE_RELEASE,
    Journal,
    format_event,
)
from .message_router import MessageRouter
from .object_placement import ObjectPlacement
from .registry import ObjectId, Registry
from .service import Service
from .service_object import LifecycleKind, LifecycleMessage

log = logging.getLogger("rio_tpu_torch.server")


def _routable_host() -> str:
    """Discover the host's outbound-routable IPv4 address.

    The UDP-connect trick (the reference resolves its advertised address via
    netwatch, ``server.rs:155-168``): ``connect`` on a datagram socket makes
    the kernel pick the egress interface without sending a packet, and
    ``getsockname`` reads the chosen source address. Falls back to loopback
    when the host has no route at all.
    """
    import socket

    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect(("10.255.255.255", 1))
        return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"
    finally:
        s.close()


class Server:
    """A node hosting service objects.

    Construct with keyword args (the Python stand-in for the reference's
    ``bon``-derived builder)::

        server = Server(
            address="0.0.0.0:0",
            registry=registry,
            cluster_provider=provider,
            object_placement_provider=placement,
            app_data=app_data,          # optional
            http_members_address=None,  # optional read-only members API
        )
        await server.prepare()
        await server.bind()
        await server.run()
    """

    def __init__(
        self,
        *,
        address: str,
        registry: Registry,
        cluster_provider: ClusterProvider,
        object_placement_provider: ObjectPlacement,
        app_data: AppData | None = None,
        http_members_address: str | None = None,
        transport: str = "asyncio",
        advertise_address: str | None = None,
        reuse_port: bool = False,
        extra_listen_socks=None,
        placement_daemon: bool = False,
        placement_daemon_config=None,
        reminder_daemon: bool = False,
        reminder_daemon_config=None,
        migration_config=None,
        replication_config=None,
        read_scale_config=None,
        load_monitor: bool = True,
        load_thresholds=None,
        load_interval: float = 1.0,
        metrics: bool = True,
        journal: bool = True,
        journal_capacity: int = 4096,
        timeseries: bool = True,
        timeseries_capacity: int = 240,
        timeseries_interval: float = 1.0,
        health_watch: bool = True,
        health_rules=None,
        spans: bool = True,
        spans_capacity: int = 2048,
        spans_slo_ms: float = 250.0,
        affinity_sampler: bool = True,
        affinity_stride: int = 8,
        affinity_top_k: int = 512,
        autoscale_config=None,
        qos_config=None,
    ) -> None:
        if transport not in ("asyncio", "native", "auto"):
            raise ValueError(f"unknown transport {transport!r}")
        self.requested_address = address
        # Explicit override for what goes into membership storage —
        # "host" or "host:port" (port 0/absent keeps the bound port). NAT'd
        # and multi-homed deployments set this; everyone else gets the
        # discovered routable address (reference server.rs:155-168).
        self.advertise_address = advertise_address
        self.registry = registry
        self.cluster_provider = cluster_provider
        self.object_placement = object_placement_provider
        self.app_data = app_data or AppData()
        self.http_members_address = http_members_address
        self.transport = transport
        # SO_REUSEPORT on the main listener: a sharded worker binds its
        # identity port against the supervisor's port reservation (and, on
        # kernels that distribute accepts, sibling workers can share one
        # front-door port).
        self.reuse_port = reuse_port
        # Pre-bound (unlistened or listening) sockets served with the SAME
        # protocol/service as the main listener — the sharded front door.
        # The server takes ownership: they are closed with the listener.
        self.extra_listen_socks = list(extra_listen_socks or [])
        self._extra_listeners: list[asyncio.Server] = []
        # Opt-in proactive churn→re-solve loop (SURVEY §7.3); a no-op for
        # placement providers without the solver surface.
        self.placement_daemon_enabled = placement_daemon
        self.placement_daemon_config = placement_daemon_config
        self.placement_daemon = None  # set by run() when enabled
        # Opt-in durable-reminder scheduler; requires a ReminderStorage in
        # app_data (checked at run(), where failure is loud).
        self.reminder_daemon_enabled = reminder_daemon
        self.reminder_daemon_config = reminder_daemon_config
        self.reminder_daemon = None  # set by run() when enabled

        self._listener: asyncio.Server | None = None
        self._native_transport = None
        self._local_addr: str | None = None
        # Batching/prefetch/in-flight knobs for the migration engine
        # (a rio_tpu_torch.migration.MigrationConfig; None → defaults).
        self.migration_config = migration_config
        self.migration_manager = None  # created at bind() (needs the address)
        # Hot-standby replication for ``__replicated__`` actor types
        # (a rio_tpu_torch.replication.ReplicationConfig; None → disabled).
        self.replication_config = replication_config
        self.replication_manager = None  # created at bind() (needs the address)
        # Bounded-staleness replica reads for ``@readonly`` handlers
        # (a rio_tpu_torch.readscale.ReadScaleConfig; None → disabled; requires
        # replication_config — the replicas ARE the read capacity).
        self.read_scale_config = read_scale_config
        self.read_scale_manager = None  # created at bind() (needs the address)
        # Elastic autoscaling (rio_tpu_torch/autoscale): opt-in via an
        # AutoscaleConfig (policy + NodeProvisioner). Disabled is FREE —
        # no runtime, no poke task, no controller actor; only the
        # getattr-None checks in otel/run remain.
        self.autoscale_config = autoscale_config
        self.autoscale = None  # created at bind() (needs the address)
        self._admin = AdminSender()
        self._internal = InternalClientSender()
        self._draining = ServerDraining()
        self._stopped = asyncio.Event()
        self._conn_tasks: set[asyncio.Task] = set()

        # Resolve (building if stale) the native codec now, off the request
        # path: the first encode otherwise triggers a synchronous compile
        # inside the event loop.
        from . import native as _native

        _native.get()

        # Inject framework handles (reference server.rs wiring of AppData).
        self.app_data.set(self._admin)
        self.app_data.set(self._internal)
        self.app_data.set(self._draining)
        self.app_data.get_or_default(MessageRouter)
        self.app_data.set(self.members_storage, as_type=MembershipStorage)
        self.app_data.set(self.object_placement, as_type=ObjectPlacement)
        # Auto-wire dispatch→affinity observation: if the placement provider
        # carries an AffinityTracker, every served request records which node
        # served which object (the signal hierarchical OT mode solves over).
        tracker = getattr(self.object_placement, "affinity_tracker", None)
        if tracker is not None and DispatchObserver not in self.app_data:
            self.app_data.set(DispatchObserver(tracker.observe))
        # Control-plane flight recorder (rio_tpu_torch/journal): on by default —
        # a bounded ring appended only on control transitions (placement,
        # migration, promotion, sheds...), never per request. Subsystems
        # resolve it from AppData; the node id is stamped at bind().
        self.journal = Journal(capacity=journal_capacity) if journal else None
        if self.journal is not None:
            self.app_data.set(self.journal)
        # Storage-outage health ledger (rio_tpu_torch/faults.StorageHealth): the
        # service layer, gossip loop, and daemons all report degraded /
        # recovered edges into the same instance, so rio.storage.* gauges
        # and the HealthWatch storage rule see one coherent picture.
        from .faults import StorageHealth

        self.storage_health = StorageHealth()
        self.app_data.set(self.storage_health)
        self.cluster_provider.set_observability(
            journal=self.journal, storage_health=self.storage_health
        )
        # Per-handler RED histograms (rio_tpu_torch/metrics): on by default — an
        # O(1) unlocked record per dispatch; ``metrics=False`` removes even
        # that (the service layer sees no registry and skips the timing).
        self.metrics_registry = None
        if metrics:
            from .metrics import MetricsRegistry

            self.metrics_registry = MetricsRegistry()
            self.app_data.set(self.metrics_registry)
        # Load telemetry + admission control (rio_tpu_torch/load): on by default
        # — with no thresholds configured it only samples and publishes the
        # node's load vector on the membership heartbeat; thresholds turn
        # on ServerBusy shedding. The migration-stats getter is lazy: the
        # manager is created at bind().
        self.load_monitor = None
        if load_monitor:
            from .load import LoadMonitor

            self.load_monitor = LoadMonitor(
                registry=self.registry,
                affinity_tracker=tracker,
                migration_stats=lambda: getattr(
                    self.migration_manager, "stats", None
                ),
                members_storage=self.members_storage,
                placement=self.object_placement,
                thresholds=load_thresholds,
                interval=load_interval,
                # Stall-watchdog captures become HEALTH journal events.
                journal=self.journal,
            )
            self.app_data.set(self.load_monitor)
            # Heartbeat pushes carry this node's encoded vector from now on.
            self.cluster_provider.set_load_source(
                self.load_monitor.encoded_snapshot
            )
        # Gauge time-series ring + trend alarms (rio_tpu_torch/timeseries,
        # rio_tpu_torch/health): on by default — the sampler and HealthWatch tick
        # ride the LoadMonitor loop (no new task, off without it), one
        # bounded gauge-dict copy per ``timeseries_interval``. The node id
        # is stamped at bind(); the alarm set defaults to
        # ``health.default_rules()`` (``health_rules`` overrides).
        # Request-waterfall span ring (rio_tpu_torch/spans): on by default — the
        # transports feed it only for traced requests plus a 1-in-8 stride
        # of untraced ones (tail capture over ``spans_slo_ms``), so the
        # null fast path stays untouched. ``spans=False`` removes even the
        # per-request stride check (the transports see no ring). The node
        # id is stamped at bind(); scraped via rio.Admin DumpSpans.
        self.spans = None
        if spans:
            from .spans import SpanRing

            self.spans = SpanRing(capacity=spans_capacity, slo_ms=spans_slo_ms)
            self.app_data.set(self.spans)
        # Communication-edge sampler (rio_tpu_torch/affinity): on by default —
        # the dispatch path pays one stride-masked integer check per
        # request (1-in-``affinity_stride`` sampled); the EMA fold rides
        # the LoadMonitor loop. ``affinity_sampler=False`` removes even the
        # check (the service resolves no sampler). Scraped cluster-wide via
        # rio.Admin DumpEdges and fed to graph-aware placement.
        self.affinity = None
        if affinity_sampler:
            from .affinity import EdgeSampler

            self.affinity = EdgeSampler(
                stride=affinity_stride, top_k=affinity_top_k
            )
            self.app_data.set(self.affinity)
        # Request QoS (rio_tpu_torch/qos): opt-in via a QosConfig — tenants,
        # priorities, deadline budgets, weighted-fair dispatch. Disabled is
        # FREE: both transports resolve None and dispatch exactly as before
        # (no admit call, no wrapper). ``qos_config=True`` means defaults.
        self.qos = None
        if qos_config is not None:
            from .qos import QosConfig, QosScheduler

            self.qos = QosScheduler(
                qos_config if isinstance(qos_config, QosConfig) else None
            )
            self.app_data.set(self.qos)
            if self.load_monitor is not None:
                # Interactive-class shed/drop counters ride the heartbeat
                # vector (LoadVector.qos_interactive) so the autoscale
                # policy's opt-in interactive term sees the whole cluster.
                self.load_monitor.qos = self.qos
        self.timeseries = None
        self.health_watch = None
        if timeseries and self.load_monitor is not None:
            from .timeseries import GaugeSeries

            self.timeseries = GaugeSeries(
                capacity=timeseries_capacity, interval=timeseries_interval
            )
            if health_watch:
                from .health import HealthWatch

                self.health_watch = HealthWatch(
                    self.timeseries,
                    journal=self.journal,
                    exemplars=(
                        self.metrics_registry.exemplars
                        if self.metrics_registry is not None
                        else None
                    ),
                    rules=health_rules,
                )

    # ------------------------------------------------------------------

    @property
    def members_storage(self) -> MembershipStorage:
        return self.cluster_provider.members_storage()

    @property
    def local_address(self) -> str:
        """The actually-bound address (resolves ``0.0.0.0:0`` ephemeral bind).

        Reference ``server.rs:155-168`` (``try_local_addr``).
        """
        if self._local_addr is None:
            raise ServerError("server is not bound yet")
        return self._local_addr

    async def prepare(self) -> None:
        """Run storage migrations (reference ``server.rs:120-125``)."""
        await self.members_storage.prepare()
        await self.object_placement.prepare()
        from .reminders import ReminderStorage

        if ReminderStorage in self.app_data:
            await self.app_data.get(ReminderStorage).prepare()
        from .streams import StreamStorage

        if StreamStorage in self.app_data:
            await self.app_data.get(StreamStorage).prepare()

    def _resolve_transport(self) -> str:
        if self.transport == "auto":
            from . import native

            return "native" if native.engine_profitable() else "asyncio"
        return self.transport

    async def bind(self) -> str:
        host, _, port = self.requested_address.rpartition(":")
        host = host or "0.0.0.0"
        if self._resolve_transport() == "native":
            import socket as _socket

            from .native.transport import NativeServerTransport

            if self.extra_listen_socks:
                raise ServerError(
                    "extra_listen_socks (the sharded front door) requires the "
                    "asyncio transport — the native engine owns its one "
                    "listener"
                )
            if host not in ("", "::", "0.0.0.0"):
                # The engine takes dotted quads only; resolve names here,
                # asynchronously — a blocking gethostbyname inside the
                # transport ctor would stall every coroutine on a slow
                # resolver (the asyncio path resolves async in start_server).
                try:
                    _socket.inet_aton(host)
                except OSError:
                    infos = await asyncio.get_running_loop().getaddrinfo(
                        host, None, family=_socket.AF_INET, type=_socket.SOCK_STREAM
                    )
                    host = infos[0][4][0]
            self._native_transport = NativeServerTransport(
                self._service, host, int(port), reuse_port=self.reuse_port
            )
            bound_host, bound_port = host, self._native_transport.port
        else:
            from .aio import ServerConnProtocol

            def _track(task: asyncio.Task) -> None:
                # Track per-connection workers so shutdown severs live
                # connections (a stopped node must not keep serving).
                self._conn_tasks.add(task)
                task.add_done_callback(self._conn_tasks.discard)

            loop = asyncio.get_running_loop()
            factory = lambda: ServerConnProtocol(self._service, _track)  # noqa: E731
            self._listener = await loop.create_server(
                factory, host, int(port),
                reuse_port=True if self.reuse_port else None,
            )
            for esock in self.extra_listen_socks:
                # Same service, same protocol: a connection accepted on the
                # front door is indistinguishable from one on the identity
                # listener (redirects carry the identity address either way).
                self._extra_listeners.append(
                    await loop.create_server(factory, sock=esock)
                )
            sock = self._listener.sockets[0]
            bound_host, bound_port = sock.getsockname()[:2]
        self._local_addr = self._advertised(bound_host, bound_port)
        self.app_data.set(ServerInfo(self._local_addr))
        if self.journal is not None:
            # Events recorded before bind (none today) would carry "";
            # everything from here on names this node in merged histories.
            self.journal.node = self._local_addr
        if self.timeseries is not None:
            self.timeseries.node = self._local_addr
        if self.spans is not None:
            # Retained spans merged across nodes need the recorder's name.
            self.spans.node = self._local_addr
        if self.migration_manager is None:
            # Wire the migration control plane: the coordinator in AppData
            # (service layer refusals + lifecycle restore find it there) and
            # the two node-scoped actors every node must answer for.
            from .migration import MigrationControl, MigrationInbox, MigrationManager

            self.migration_manager = MigrationManager(
                address=self._local_addr,
                registry=self.registry,
                placement=self.object_placement,
                members_storage=self.members_storage,
                app_data=self.app_data,
                router=self.app_data.get(MessageRouter),
                config=self.migration_config,
            )
            self.app_data.set(self.migration_manager)
            self.registry.add_type(MigrationControl)
            self.registry.add_type(MigrationInbox)
        from .admin import AdminControl, SeriesSource, StatsSource

        if self.timeseries is not None and SeriesSource not in self.app_data:

            def _series_meta() -> dict:
                meta: dict = {}
                stats = getattr(self.object_placement, "stats", None)
                mode = getattr(stats, "mode", "")
                if mode:
                    meta["solver_mode"] = str(mode)
                if self.health_watch is not None:
                    meta.update(self.health_watch.meta())
                return meta

            self.app_data.set(
                SeriesSource(series=self.timeseries, meta=_series_meta)
            )
        if StatsSource not in self.app_data:
            # The wire ops/observability endpoint every node answers for
            # (rio.Admin, node-scoped like the migration control plane).
            # The gauge source closes over self: subsystems created later
            # in bind()/run() appear in the snapshot automatically.
            from .otel import server_gauges

            self.app_data.set(
                StatsSource(
                    gauges=lambda: server_gauges(self),
                    histogram_rows=lambda: (
                        self.metrics_registry.snapshot_rows()
                        if self.metrics_registry is not None
                        else []
                    ),
                )
            )
            self.registry.add_type(AdminControl)
        if self.autoscale_config is not None and self.autoscale is None:
            # Elastic-autoscale control plane: the per-node runtime (in
            # AppData — the singleton actor resolves it on whichever
            # enabled node the directory seats it) plus the actor type.
            from .autoscale import AutoscaleControl, AutoscaleRuntime

            self.autoscale = AutoscaleRuntime(
                address=self._local_addr,
                members_storage=self.members_storage,
                config=self.autoscale_config,
                app_data=self.app_data,
                journal=self.journal,
            )
            self.app_data.set(self.autoscale)
            self.registry.add_type(AutoscaleControl)
        from .streams import StreamStorage

        if StreamStorage in self.app_data:
            # Durable-streams control plane: the live-tail anchor, the
            # consumer-group cursors, and the saga coordinator are ordinary
            # placement-seated actors — registered only when the node has a
            # stream log to serve.
            from .streams.cursor import StreamCursor, StreamTap
            from .streams.saga import SagaCoordinator

            self.registry.add_type(StreamTap)
            self.registry.add_type(StreamCursor)
            self.registry.add_type(SagaCoordinator)
        if self.replication_manager is None and self.replication_config is not None:
            # Rides the MigrationInbox registered above — no extra actor.
            from .replication import ReplicationManager

            self.replication_manager = ReplicationManager(
                address=self._local_addr,
                registry=self.registry,
                placement=self.object_placement,
                members_storage=self.members_storage,
                app_data=self.app_data,
                config=self.replication_config,
            )
            self.app_data.set(self.replication_manager)
        if self.read_scale_manager is None and self.read_scale_config is not None:
            if self.replication_manager is None:
                raise ServerError(
                    "read_scale_config requires replication_config — standby "
                    "replicas are the read capacity"
                )
            from .readscale import ReadScaleManager

            self.read_scale_manager = ReadScaleManager(
                address=self._local_addr,
                registry=self.registry,
                replication=self.replication_manager,
                placement=self.object_placement,
                members_storage=self.members_storage,
                app_data=self.app_data,
                config=self.read_scale_config,
            )
            self.app_data.set(self.read_scale_manager)
            if self.load_monitor is not None:
                # The load loop ticks the hotness detector right after each
                # sample — dynamic k rides the existing cadence, no new task.
                self.load_monitor.hotness_detector = self.read_scale_manager
        return self._local_addr

    def _advertised(self, bound_host: str, bound_port: int) -> str:
        """The address written to membership storage and used for redirects.

        A wildcard bind advertises the discovered routable address — never
        ``0.0.0.0`` (unconnectable) and never a blind ``127.0.0.1`` rewrite
        (which would advertise loopback into a multi-host cluster).
        """
        if self.advertise_address:
            h, sep, p = self.advertise_address.rpartition(":")
            if not sep:
                h, p = self.advertise_address, "0"
            return f"{h}:{int(p) or bound_port}"
        if bound_host in ("0.0.0.0", "::", ""):
            bound_host = _routable_host()
        return f"{bound_host}:{bound_port}"

    def _service(self) -> Service:
        return Service(
            address=self.local_address,
            registry=self.registry,
            object_placement=self.object_placement,
            members_storage=self.members_storage,
            app_data=self.app_data,
        )

    # ------------------------------------------------------------------
    # Internal client + admin consumers (reference server.rs:309-363)
    # ------------------------------------------------------------------

    async def _consume_internal_commands(self) -> None:
        from .protocol import RequestEnvelope

        pending: set[asyncio.Task] = set()
        while True:
            cmd: SendCommand = await self._internal.queue.get()

            async def dispatch(c: SendCommand) -> None:
                try:
                    tenant, priority, deadline_at = c.qos_scope
                    deadline_ms = 0
                    if deadline_at > 0.0:
                        # Decrement the sender's remaining budget across the
                        # queue hop; a spent budget is refused here, before
                        # the handler runs (doomed-work shedding applies to
                        # internal sends too).
                        left_s = deadline_at - time.monotonic()
                        if left_s <= 0.0:
                            from .protocol import ResponseEnvelope, ResponseError

                            if not c.response.done():
                                c.response.set_result(
                                    ResponseEnvelope.err(
                                        ResponseError.deadline_exceeded(
                                            "qos: budget spent before internal dispatch"
                                        )
                                    ).to_bytes()
                                )
                            return
                        deadline_ms = max(1, int(left_s * 1000.0))
                    env = RequestEnvelope(
                        c.handler_type, c.handler_id, c.message_type, c.payload,
                        c.trace_ctx,
                        tenant=tenant,
                        priority=priority,
                        deadline_ms=deadline_ms,
                        source=c.source,
                    )
                    if deadline_at > 0.0 or tenant or priority:
                        # Re-install the sender's scope so hops the nested
                        # handler performs keep decrementing the same budget
                        # (internal dispatch bypasses QosScheduler.run — a
                        # parked internal send behind a full concurrency gate
                        # could deadlock a handler awaiting its own send).
                        from .qos import request_scope

                        with request_scope(tenant, priority, deadline_at):
                            resp = await self._service().call(env)
                    else:
                        resp = await self._service().call(env)
                    if not c.response.done():
                        c.response.set_result(resp.to_bytes())
                except Exception as e:  # noqa: BLE001 — must never hang the sender
                    if not c.response.done():
                        c.response.set_exception(e)

            # Spawned, never inline: an actor awaiting this send may hold its
            # own lock (reference server.rs:309-332 + test_proxy_deadlock).
            # Strong refs keep tasks alive (asyncio holds only weak ones).
            task = asyncio.ensure_future(dispatch(cmd))
            pending.add(task)
            task.add_done_callback(pending.discard)

    async def _consume_admin_commands(self) -> None:
        while True:
            cmd = await self._admin.queue.get()
            if cmd.kind == AdminCommandKind.SERVER_EXIT:
                log.info("%s: AdminCommand::ServerExit", self._local_addr)
                self._stopped.set()
                return
            if cmd.kind == AdminCommandKind.DRAIN_SERVER:
                log.info("%s: AdminCommand::DrainServer", self._local_addr)
                await self._drain_and_exit()
                return
            if cmd.kind == AdminCommandKind.SHUTDOWN_OBJECT:
                await self.shutdown_object(cmd.type_name, cmd.object_id)
            if cmd.kind == AdminCommandKind.DUMP_STATS:
                # In-process twin of the rio.Admin wire scrape: dump the
                # node's gauge snapshot to the log for ops spelunking.
                from .otel import server_gauges

                log.info(
                    "%s: AdminCommand::DumpStats %s", self._local_addr,
                    server_gauges(self),
                )
            if cmd.kind == AdminCommandKind.DUMP_EVENTS:
                # In-process twin of the rio.Admin DumpEvents wire scrape:
                # dump the journal tail to the log for ops spelunking.
                if self.journal is None:
                    log.info("%s: AdminCommand::DumpEvents (journal off)",
                             self._local_addr)
                else:
                    tail = self.journal.events(limit=64)
                    log.info(
                        "%s: AdminCommand::DumpEvents (%d recorded, %d dropped)\n%s",
                        self._local_addr, self.journal.recorded,
                        self.journal.dropped,
                        "\n".join(format_event(e) for e in tail),
                    )
            if cmd.kind == AdminCommandKind.DUMP_SERIES:
                # In-process twin of the rio.Admin DumpSeries wire scrape:
                # dump the newest slice of the gauge ring to the log.
                if self.timeseries is None:
                    log.info("%s: AdminCommand::DumpSeries (timeseries off)",
                             self._local_addr)
                else:
                    window = self.timeseries.window(limit=8)
                    log.info(
                        "%s: AdminCommand::DumpSeries (%d sampled, %d dropped)\n%s",
                        self._local_addr, self.timeseries.sampled,
                        self.timeseries.dropped,
                        "\n".join(
                            f"#{s.seq} @{s.wall_ts:.3f} {len(s.gauges)} gauges"
                            for s in window
                        ),
                    )
            if cmd.kind == AdminCommandKind.DUMP_SPANS:
                # In-process twin of the rio.Admin DumpSpans wire scrape:
                # dump the newest retained request spans to the log.
                if self.spans is None:
                    log.info("%s: AdminCommand::DumpSpans (spans off)",
                             self._local_addr)
                else:
                    tail = self.spans.spans(limit=16)
                    log.info(
                        "%s: AdminCommand::DumpSpans (%d retained, %d dropped, "
                        "%d tail-captured)\n%s",
                        self._local_addr, self.spans.retained,
                        self.spans.dropped, self.spans.tail_captured,
                        "\n".join(
                            f"#{r.seq} {r.trace_id[:8]} {r.name} "
                            f"{r.attrs.get('handler', '?')} {r.duration_us}us"
                            for r in tail
                        ),
                    )
            if cmd.kind == AdminCommandKind.DUMP_EDGES:
                # In-process twin of the rio.Admin DumpEdges wire scrape:
                # dump the hottest sampled communication edges to the log.
                if self.affinity is None:
                    log.info("%s: AdminCommand::DumpEdges (sampler off)",
                             self._local_addr)
                else:
                    rows = self.affinity.edges(limit=16)
                    log.info(
                        "%s: AdminCommand::DumpEdges (%d tracked, %d sampled, "
                        "%d evicted)\n%s",
                        self._local_addr, len(self.affinity._edges),
                        self.affinity.sampled, self.affinity.evictions,
                        "\n".join(
                            f"{src} -> {dst} {b:.0f} B/s {c:.1f} call/s "
                            f"local={lf:.2f}"
                            for src, dst, b, c, lf in rows
                        ),
                    )
            if cmd.kind == AdminCommandKind.MIGRATE_OBJECT:
                if self.migration_manager is not None:
                    await self.migration_manager.migrate_out(
                        ObjectId(cmd.type_name, cmd.object_id), cmd.target
                    )

    async def _drain_and_exit(self) -> None:
        """The graceful exit flow behind ``AdminCommand.drain()``.

        1. Raise the shared :class:`~rio_tpu_torch.commands.ServerDraining` flag:
           the service layer refuses NEW activations from here on (seated
           objects keep being served), so the lifecycle pass below cannot
           race fresh self-assignments.
        2. Cordon this address in the placement provider (solver providers
           only) and trigger one re-solve — the stay-put discount moves
           exactly our population onto the survivors.
        3. Run the SHUTDOWN lifecycle for every locally activated instance
           (``before_shutdown`` hooks get their chance to persist state),
           looping until the registry is empty — an in-flight request may
           still be mid-activation from before the flag went up. Only
           directory rows still pointing HERE are removed (a re-seated
           row belongs to its new owner).
        4. Flush a write-behind placement provider: drain IS the planned
           shutdown its ``flush()`` contract names — exiting with dirty
           marks would lose the re-seats from durable storage.
        5. Exit the serve loop — guaranteed by the ``finally`` even if a
           provider surprises us with an exception (a failed drain must
           degrade to an exit, never to a wedged server).
        """
        placement = self.object_placement
        try:
            self._draining.active = True
            if self.reminder_daemon is not None:
                # Hand shard ownership to the survivors BEFORE the object
                # population moves: released leases + freed directory seats
                # are claimable on the next peer poll, so reminder ticks
                # resume within one lease interval of a graceful exit.
                with contextlib.suppress(Exception):
                    await self.reminder_daemon.handoff()
            if hasattr(placement, "cordon"):
                try:
                    placement.cordon(self._local_addr)
                except Exception as e:
                    # Last schedulable node / never registered / provider
                    # quirk: nowhere to drain to — lifecycle + exit.
                    log.warning(
                        "%s: drain degraded to exit (%r)", self._local_addr, e
                    )
                else:
                    if self.journal is not None:
                        self.journal.record(MEMBER_CORDON, reason="drain")
                    if hasattr(placement, "rebalance"):
                        with contextlib.suppress(Exception):
                            await self._drain_rebalance(placement)
            for _pass in range(10):
                remaining = self.registry.object_ids()
                if not remaining:
                    break
                for oid in remaining:
                    await self._teardown_local(oid, only_if_local_row=True)
            else:
                log.warning(
                    "%s: registry not empty after drain passes (%d left)",
                    self._local_addr,
                    len(self.registry.object_ids()),
                )
            if hasattr(placement, "flush"):
                with contextlib.suppress(Exception):
                    await placement.flush()
        except Exception:
            log.exception("%s: drain failed; exiting anyway", self._local_addr)
        finally:
            self._stopped.set()

    async def _drain_rebalance(self, placement) -> None:
        """The drain's cordon re-solve, as coordinated handoffs when the
        provider supports planned moves: survivors receive our population's
        volatile state instead of finding bare re-seated rows. Bare
        ``rebalance()`` remains the fallback — the lifecycle pass below
        still persists managed state either way."""
        import inspect

        if (
            self.migration_manager is not None
            and "move_sink" in inspect.signature(placement.rebalance).parameters
        ):
            await placement.rebalance(move_sink=self.migration_manager.apply_moves)
        else:
            await placement.rebalance()

    async def shutdown_object(self, type_name: str, object_id: str) -> None:
        """Run ``before_shutdown``, drop the instance, delete its placement.

        Reference ``server.rs:338-363``.
        """
        await self._teardown_local(
            ObjectId(type_name, object_id), only_if_local_row=False
        )

    async def _teardown_local(
        self, oid: ObjectId, *, only_if_local_row: bool
    ) -> None:
        """ONE lifecycle-teardown sequence for both the admin shutdown and
        the drain pass: SHUTDOWN hook (suppressed), registry drop, then the
        placement row. ``only_if_local_row`` (the drain pass) removes the
        row only when it still points HERE — a re-seated row belongs to
        its new owner and must survive."""
        if self.registry.has(oid.type_name, oid.id):
            with contextlib.suppress(Exception):
                await self.registry.send(
                    oid.type_name,
                    oid.id,
                    LifecycleMessage(kind=LifecycleKind.SHUTDOWN),
                    self.app_data,
                )
        self.registry.remove(oid.type_name, oid.id)
        removed = False
        if only_if_local_row:
            with contextlib.suppress(Exception):
                if await self.object_placement.lookup(oid) == self._local_addr:
                    await self.object_placement.remove(oid)
                    removed = True
        else:
            await self.object_placement.remove(oid)
            removed = True
        if removed and self.journal is not None:
            self.journal.record(
                PLACE_RELEASE,
                f"{oid.type_name}/{oid.id}",
                reason="drain" if only_if_local_row else "shutdown",
            )

    # ------------------------------------------------------------------

    async def run(self) -> None:
        """Serve until an admin ``ServerExit`` or cancellation.

        Reference ``server.rs:178-283``: all loops race under one select;
        any loop finishing tears the node down.
        """
        if self._listener is None and self._native_transport is None:
            await self.bind()
        if self._native_transport is not None:
            self._native_transport.start()
        tasks = [
            asyncio.ensure_future(self.cluster_provider.serve(self.local_address)),
            asyncio.ensure_future(self._consume_internal_commands()),
            asyncio.ensure_future(self._consume_admin_commands()),
            asyncio.ensure_future(self._stopped.wait()),
        ]
        if self.load_monitor is not None:
            if self.timeseries is not None:
                # The series sampler (and HealthWatch, evaluating the window
                # the sample just extended) ride the load loop's cadence —
                # rate-limited inside GaugeSeries.tick, no new task.
                from .otel import server_gauges

                def _series_tick() -> None:
                    if self.timeseries.tick(lambda: server_gauges(self)) is None:
                        return
                    if self.health_watch is not None:
                        self.health_watch.tick()

                self.load_monitor.tickers.append(_series_tick)
            if self.affinity is not None:
                # EMA fold rides the load loop — no new task; same
                # isolation contract as every ticker (a failure is logged,
                # sampling continues).
                self.load_monitor.tickers.append(self.affinity.fold)
            tasks.append(asyncio.ensure_future(self.load_monitor.run()))
        if self.replication_manager is not None:
            tasks.append(asyncio.ensure_future(self.replication_manager.run()))
        if self.autoscale is not None:
            # Every enabled node pokes the rio.Autoscale singleton each
            # interval; only the current owner's poke ticks the policy.
            tasks.append(asyncio.ensure_future(self.autoscale.poke_loop()))
        if self.placement_daemon_enabled:
            from .placement_daemon import PlacementDaemon

            daemon = PlacementDaemon(
                self.members_storage, self.object_placement,
                self.placement_daemon_config,
                migrator=self.migration_manager,
                journal=self.journal,
                storage_health=self.storage_health,
            )
            self.placement_daemon = daemon
            tasks.append(asyncio.ensure_future(daemon.run()))
        if self.reminder_daemon_enabled:
            from .reminders import ReminderStorage
            from .reminders.daemon import ReminderDaemon

            if ReminderStorage not in self.app_data:
                raise ServerError(
                    "reminder_daemon=True requires a ReminderStorage in app_data "
                    "(app_data.set(storage, as_type=ReminderStorage))"
                )
            rdaemon = ReminderDaemon(
                address=self.local_address,
                members_storage=self.members_storage,
                placement=self.object_placement,
                storage=self.app_data.get(ReminderStorage),
                config=self.reminder_daemon_config,
                journal=self.journal,
                storage_health=self.storage_health,
            )
            self.reminder_daemon = rdaemon
            tasks.append(asyncio.ensure_future(rdaemon.run()))
        if self.http_members_address:
            from .cluster.storage.http import serve_members_http

            tasks.append(
                asyncio.ensure_future(
                    serve_members_http(self.http_members_address, self.members_storage)
                )
            )
        try:
            await asyncio.wait(tasks, return_when=asyncio.FIRST_COMPLETED)
        finally:
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            if self._native_transport is not None:
                self._native_transport.close()
                await self._native_transport.wait_closed()
            if self._listener is not None:
                self._listener.close()
            for extra in self._extra_listeners:
                extra.close()
            for t in list(self._conn_tasks):
                t.cancel()
            await asyncio.gather(*self._conn_tasks, return_exceptions=True)
            if self._listener is not None:
                await self._listener.wait_closed()
            for extra in self._extra_listeners:
                await extra.wait_closed()
            if self.migration_manager is not None:
                self.migration_manager.close()
            if self.replication_manager is not None:
                self.replication_manager.close()
            if self.read_scale_manager is not None:
                self.read_scale_manager.close()
            if self.autoscale is not None:
                with contextlib.suppress(Exception):
                    await self.autoscale.close()
            # Leaving the cluster: mark self inactive so peers stop routing here.
            with contextlib.suppress(Exception):
                host, _, port = self.local_address.rpartition(":")
                await self.members_storage.set_inactive(host, int(port))

    def admin_sender(self) -> AdminSender:
        return self._admin

    async def serve(self) -> None:
        """Convenience: ``prepare`` + ``bind`` + ``run``."""
        await self.prepare()
        await self.bind()
        await self.run()
