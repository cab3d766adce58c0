"""Optional OpenTelemetry bridge for :mod:`rio_tpu_torch.tracing` + metrics gauges.

Reference: the observability example exports `tracing` spans via OTLP to
Jaeger (``examples/observability/src/bin/observability_server.rs:37-63`` +
``compose.yaml``).  rio-tpu's equivalent: ``add_sink(otlp_sink(...))``
forwards every finished :class:`~rio_tpu_torch.tracing.Span` — with its
trace/span/parent correlation ids — through the ``opentelemetry`` SDK.

Metrics ride the same split: :func:`stats_gauges`/:func:`server_gauges`
flatten the framework's stats dataclasses (placement daemon, migration,
reminders, client) into a ``name -> value`` gauge snapshot with **no SDK
dependency** — scrape loops, tests, and debug dumps read it directly —
while :func:`otlp_metrics_exporter` is the optional SDK-backed periodic
push for deployments that have the packages.

The OTel dependency is optional (``pip install rio-tpu[otel]`` style);
the SDK-requiring entry points raise a clear error without it, and nothing
else in the framework touches it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from .tracing import Span


def stats_gauges(**sources: Any) -> dict[str, float]:
    """Flatten stats dataclasses into ``{"rio.<source>.<field>": value}``.

    Each keyword names one stats object (``placement_daemon=daemon.stats,
    migration=mgr.stats, ...``); every numeric dataclass field becomes one
    gauge. ``None`` sources are skipped so callers can pass optional
    subsystems unconditionally. Non-dataclass objects contribute their
    numeric public attributes — duck-typed stats from tests/fakes work too.
    """
    gauges: dict[str, float] = {}
    for source_name, stats in sources.items():
        if stats is None:
            continue
        if dataclasses.is_dataclass(stats):
            pairs = [
                (f.name, getattr(stats, f.name))
                for f in dataclasses.fields(stats)
            ]
        else:
            pairs = [
                (k, v) for k, v in vars(stats).items() if not k.startswith("_")
            ]
        for field_name, value in pairs:
            if isinstance(value, bool) or not isinstance(value, (int, float)):
                continue
            gauges[f"rio.{source_name}.{field_name}"] = float(value)
    return gauges


def server_gauges(server: Any) -> dict[str, float]:
    """One node's full gauge snapshot: every wired subsystem's counters.

    Works on a partially-wired :class:`~rio_tpu_torch.server.Server` (daemons or
    the migration manager absent → their gauges simply missing), so a
    scrape loop can poll any node uniformly::

        while True:
            push(server_gauges(server))
            await asyncio.sleep(15)
    """
    daemon = getattr(server, "placement_daemon", None)
    rdaemon = getattr(server, "reminder_daemon", None)
    migrator = getattr(server, "migration_manager", None)
    replicator = getattr(server, "replication_manager", None)
    readscale = getattr(server, "read_scale_manager", None)
    placement = getattr(server, "object_placement", None)
    monitor = getattr(server, "load_monitor", None)
    gauges = stats_gauges(
        placement_daemon=getattr(daemon, "stats", None),
        reminder_daemon=getattr(rdaemon, "stats", None),
        migration=getattr(migrator, "stats", None),
        replication=getattr(replicator, "stats", None),
        read_scale=getattr(readscale, "stats", None),
        placement_solve=getattr(placement, "stats", None),
        load=getattr(monitor, "stats", None),
    )
    registry = getattr(server, "registry", None)
    if registry is not None:
        gauges["rio.registry.objects"] = float(registry.count_objects())
    view = getattr(monitor, "cluster_view", None)
    if view is not None:
        gauges.update(view.gauges())
    if readscale is not None:
        gauges.update(readscale.gauges())
    metrics_registry = getattr(server, "metrics_registry", None)
    if metrics_registry is not None:
        # Per-handler RED quantiles (rio.handler.<type>.<msg>.p50_ms/p99_ms
        # etc.), derived from the log-bucketed histograms at scrape time.
        gauges.update(metrics_registry.gauges())
    journal = getattr(server, "journal", None)
    if journal is not None:
        # Control-plane flight recorder counters (rio.journal.*).
        gauges.update(journal.gauges())
    spans = getattr(server, "spans", None)
    if spans is not None:
        # Request-waterfall span ring counters (rio.spans.*).
        gauges.update(spans.gauges())
    affinity = getattr(server, "affinity", None)
    if affinity is not None:
        # Communication-edge sampler counters (rio.affinity.*): tracked
        # edges, evictions, cross-node byte rate, raw TCP byte totals.
        gauges.update(affinity.gauges())
    solve_stats = getattr(placement, "stats", None)
    history_gauges = getattr(solve_stats, "history_gauges", None)
    if history_gauges is not None:
        # Rolling solve-history summary (rio.placement_solve.history.*) —
        # stats_gauges above only sees the LAST solve's scalar fields.
        gauges.update(history_gauges())
    series = getattr(server, "timeseries", None)
    if series is not None:
        # Gauge time-series ring counters (rio.series.*).
        gauges.update(series.gauges())
    health = getattr(server, "health_watch", None)
    if health is not None:
        # Trend-alarm state (rio.health.*): active/total alert counts plus
        # one 0/1 gauge per configured rule.
        gauges.update(health.gauges())
    autoscale = getattr(server, "autoscale", None)
    if autoscale is not None:
        # Autoscale controller state (rio.autoscale.*): pressure EMA,
        # band counters, decision totals, cooldown remaining.
        gauges.update(autoscale.gauges())
    qos = getattr(server, "qos", None)
    if qos is not None:
        # Request-QoS scheduler state (rio.qos.*): running/queued depth,
        # admission + shed counters, deadline drops, interactive split.
        gauges.update(qos.gauges())
    storage = getattr(server, "storage_health", None)
    if storage is not None:
        # Rendezvous-storage outage ledger (rio.storage.*): error/degraded
        # counters shared by the service layer, gossip loop, and daemons.
        gauges.update(storage.gauges())
    app_data = getattr(server, "app_data", None)
    if app_data is not None:
        from .message_router import MessageRouter

        router = app_data.try_get(MessageRouter)
        if router is not None:
            # Pub/sub fan-out counters (rio.router.*): dropped counts items
            # displaced from full subscriber queues — durable-stream fan-in
            # loss that the publish return value alone cannot show.
            gauges.update(router.gauges())
    provider = getattr(server, "cluster_provider", None)
    gossip_stats = getattr(provider, "stats", None)
    if gossip_stats is not None:
        # Gossip tick/outage counters (rio.gossip.*), including verdicts
        # suppressed by the heartbeat-freshness anti-flap rule.
        gauges.update(stats_gauges(gossip=gossip_stats))
    return gauges


def otlp_metrics_exporter(
    read_gauges: Callable[[], dict[str, float]],
    endpoint: str = "http://127.0.0.1:4317",
    service_name: str = "rio-tpu",
    interval: float = 15.0,
):
    """Periodically export a gauge snapshot over OTLP/gRPC.

    ``read_gauges`` is any zero-arg callable returning the
    :func:`stats_gauges` shape (pass ``lambda: server_gauges(server)``).
    Returns the SDK ``MeterProvider`` (call ``.shutdown()`` to stop).
    Raises ``ImportError`` with install guidance when the optional
    OpenTelemetry packages are absent — the SDK-free :func:`stats_gauges`
    path needs nothing.
    """
    try:
        from opentelemetry.exporter.otlp.proto.grpc.metric_exporter import (
            OTLPMetricExporter,
        )
        from opentelemetry.sdk.metrics import MeterProvider
        from opentelemetry.sdk.metrics.export import PeriodicExportingMetricReader
        from opentelemetry.sdk.resources import Resource
    except ImportError as e:  # pragma: no cover - env without otel
        raise ImportError(
            "otlp_metrics_exporter requires the optional OpenTelemetry "
            "packages: pip install opentelemetry-sdk opentelemetry-exporter-otlp"
        ) from e

    reader = PeriodicExportingMetricReader(
        OTLPMetricExporter(endpoint=endpoint),
        export_interval_millis=interval * 1000.0,
    )
    provider = MeterProvider(
        resource=Resource.create({"service.name": service_name}),
        metric_readers=[reader],
    )
    meter = provider.get_meter("rio_tpu_torch")
    registered: set[str] = set()

    # Observable gauges bind one callback per instrument name, but new
    # gauge names appear as subsystems come online (first rebalance, first
    # migration, first request of a handler type). Every callback therefore
    # re-scans the snapshot it already read and registers any unseen names
    # — they export from the next cycle on, with no one needing to call a
    # private hook.

    def _register_new(vals: dict[str, float]) -> None:
        for name in vals:
            if name not in registered:
                registered.add(name)
                meter.create_observable_gauge(name, callbacks=[_make_cb(name)])

    def _make_cb(name: str):
        def _cb(options):  # noqa: ARG001 - SDK signature
            from opentelemetry.metrics import Observation

            vals = read_gauges()
            _register_new(vals)
            value = vals.get(name)
            return [] if value is None else [Observation(value)]

        return _cb

    def _register_all() -> None:
        _register_new(read_gauges())

    _register_all()
    # Kept for older scrape loops that still call it; registration is
    # automatic now.
    provider._rio_register_new_gauges = _register_all
    return provider


def otlp_sink(
    endpoint: str = "http://127.0.0.1:4317",
    service_name: str = "rio-tpu",
) -> Callable[[Span], None]:
    """Build a span sink that exports over OTLP/gRPC.

    Usage::

        from rio_tpu_torch import tracing
        from rio_tpu_torch.otel import otlp_sink
        tracing.add_sink(otlp_sink("http://jaeger:4317"))

    Raises ``ImportError`` with install guidance when the optional
    ``opentelemetry-sdk``/``opentelemetry-exporter-otlp`` packages are
    absent.
    """
    try:
        from opentelemetry.exporter.otlp.proto.grpc.trace_exporter import (
            OTLPSpanExporter,
        )
        from opentelemetry.sdk.resources import Resource
        from opentelemetry.sdk.trace import TracerProvider
        from opentelemetry.sdk.trace.export import BatchSpanProcessor
    except ImportError as e:  # pragma: no cover - env without otel
        raise ImportError(
            "otlp_sink requires the optional OpenTelemetry packages: "
            "pip install opentelemetry-sdk opentelemetry-exporter-otlp"
        ) from e

    provider = TracerProvider(
        resource=Resource.create({"service.name": service_name})
    )
    provider.add_span_processor(BatchSpanProcessor(OTLPSpanExporter(endpoint=endpoint)))
    tracer = provider.get_tracer("rio_tpu_torch")

    return _SdkSink(tracer)


class _SdkSink:
    """Replays finished rio-tpu spans into an OTel tracer.

    rio-tpu spans arrive at the sink *after* they finish (children before
    parents), so the bridge recreates each as an explicit-timestamp OTel
    span carrying the original correlation ids as attributes — Jaeger/Tempo
    then group and order them by ``rio.trace_id``/``rio.parent_id``. (The
    SDK's own ids can't be forced from outside its context API; attributes
    keep the correlation exact.)
    """

    def __init__(self, tracer) -> None:
        self._tracer = tracer

    def __call__(self, span: Span) -> None:
        start_ns = int(span.wall_start * 1e9)
        otel_span = self._tracer.start_span(span.name, start_time=start_ns)
        otel_span.set_attribute("rio.trace_id", span.trace_id)
        otel_span.set_attribute("rio.span_id", span.span_id)
        if span.parent_id:
            otel_span.set_attribute("rio.parent_id", span.parent_id)
        for key, value in span.attrs.items():
            if not isinstance(value, (str, bool, int, float)):
                value = str(value)
            otel_span.set_attribute(key, value)
        otel_span.end(end_time=start_ns + int(span.duration * 1e9))
