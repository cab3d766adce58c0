"""observability: exporting request-path trace spans.

Parity with the reference's observability example
(``rio-rs/examples/observability/src/bin/observability_server.rs:37-63``),
which wires ``tracing_subscriber`` + an OpenTelemetry OTLP layer into
Jaeger. rio-tpu's span taxonomy mirrors the reference's
(``frame_receive``, ``placement_lookup``, ``handler_handle``, …, see
``rio_tpu_torch/tracing.py``); sinks are pluggable the same way the reference's
subscriber layers are. This demo registers two sinks:

* the built-in ``logging_sink`` (the reference's fmt layer), and
* an in-process aggregator standing where an OTLP exporter would go —
  any callable ``Span -> None`` can forward to a collector.

Spans cover the request path; the *counter* side of observability is
``rio_tpu_torch.otel.server_gauges``: one flat snapshot of every wired
subsystem's stats (placement daemon, reminder daemon, migration manager,
solver, and — since servers run a ``LoadMonitor`` by default — the local
load sample and admission-control shed counter (``rio.load.*``) plus the
gossip-derived ``rio.cluster_load.<addr>.*`` view of every peer's
lag/inflight/staleness; no extra wiring needed). This demo runs a :func:`gauge_reader` task alongside the servers
— the in-process analogue of a Prometheus scrape loop — logging only the
gauges that CHANGED since the previous tick, so a quiet cluster logs
nothing and a busy one shows exactly which counters are moving.

Spans carry contextvar-propagated ``trace_id``/``span_id``/``parent_id``:
one request's ``request`` → ``placement_lookup`` → ``object_activate`` →
``handler_dispatch`` spans share a trace, exactly like the reference's
nested ``tracing`` spans. With the optional OpenTelemetry packages
installed, the real exporter is one line::

    from rio_tpu_torch.otel import otlp_sink
    tracing.add_sink(otlp_sink("http://jaeger:4317"))

The OTLP metrics push is ImportError-gated the same way; this demo TRIES
it and, without the SDK, falls back to :class:`InMemoryMetricExporter` —
the same collect-cycle shape as ``tests/fake_otel.py``'s exporter, fed
from ``server_gauges`` directly — so the example runs end-to-end in a
bare environment (and tier-1 smoke-tests it doing so).

The third plane is the control-plane journal (``rio_tpu_torch/journal.py``):
the demo drives one real migration, then scrapes every node's
``DumpEvents`` tail and prints the merged causal history plus
``explain`` for the migrated actor — "why is w0 on node 2" answered from
the cluster's own flight recorder.

The fourth plane is the gauge time-series ring (``rio_tpu_torch/timeseries.py``)
plus the HealthWatch trend alarms (``rio_tpu_torch/health.py``): servers here
sample at an aggressive cadence so the final ``DumpSeries`` scrape has a
real window, and the demo prints the same per-node trend table the
operator CLI renders live (``python -m rio_tpu_torch.admin watch --demo``).

Run::

    python -m rio_tpu_torch.examples.observability
"""

import asyncio
import logging
import statistics
from collections import defaultdict


from rio_tpu_torch import (
    AppData,
    Client,
    LocalObjectPlacement,
    LocalStorage,
    Registry,
    Server,
    ServiceObject,
    handler,
    message,
)
from rio_tpu_torch import tracing
from rio_tpu_torch.admin import (
    ADMIN_TYPE,
    AdminAck,
    AdminRequest,
    DumpStats,
    StatsSnapshot,
    cluster_events,
    explain,
)
from rio_tpu_torch.cluster.membership_protocol import LocalClusterProvider
from rio_tpu_torch.journal import format_event
from rio_tpu_torch.metrics import merge_rows
from rio_tpu_torch.otel import server_gauges

gauge_log = logging.getLogger("rio_tpu_torch.examples.gauges")


class InMemoryMetricExporter:
    """No-SDK stand-in for the OTLP metrics push (``fake_otel`` style).

    The real path (``otlp_metrics_exporter``) registers observable gauges
    whose callbacks read ``server_gauges`` on the SDK's timer; this
    fallback runs the same collect cycle explicitly — each
    :meth:`collect` reads every node's gauge snapshot and appends one
    ``{name: value}`` dict per node to ``exported``, exactly what the
    fake exporter in ``tests/fake_otel.py`` would have received over
    gRPC.
    """

    def __init__(self) -> None:
        self.exported: list[dict[str, float]] = []

    def collect(self, servers: list) -> None:
        for server in servers:
            self.exported.append(dict(server_gauges(server)))


def start_metrics_export(servers: list):
    """OTLP metrics push when the SDK is present, in-memory otherwise.

    Returns ``(mode, exporter_or_provider)``: ``("otlp", provider)`` with
    the real SDK (call ``provider.shutdown()``), or
    ``("in-memory", InMemoryMetricExporter)`` without it — the gated path
    the ROADMAP left open, now always runnable.
    """
    from rio_tpu_torch.otel import otlp_metrics_exporter

    try:
        provider = otlp_metrics_exporter(
            lambda: server_gauges(servers[0]), interval=0.5
        )
        return "otlp", provider
    except ImportError:
        return "in-memory", InMemoryMetricExporter()


async def cluster_scrape(client: "Client", members) -> None:
    """Scrape every node over the wire and merge the RED histograms.

    The cluster-wide analogue of :func:`gauge_reader`: walk the membership
    view, ask each node's ``rio.Admin`` actor for its
    :class:`~rio_tpu_torch.admin.StatsSnapshot` (one round trip per node), then
    :func:`~rio_tpu_torch.metrics.merge_rows` the histogram rows so the printed
    p50/p99 are CLUSTER quantiles, not per-node ones. Exemplar trace ids
    ride each top bucket — paste one into the span table/Jaeger to jump
    from "p99 is slow" to the exact request that was.
    """
    snapshots: list[StatsSnapshot] = []
    for member in await members.active_members():
        snap = await client.send(
            ADMIN_TYPE, member.address, DumpStats(), returns=StatsSnapshot
        )
        snapshots.append(snap)
        print(
            f"[scrape] {snap.address}: {len(snap.gauges)} gauges, "
            f"{len(snap.histograms)} handler histograms"
        )
    merged = merge_rows([s.histograms for s in snapshots])
    print(f"\n[scrape] cluster-wide RED quantiles ({len(snapshots)} nodes):")
    print(f"{'handler.message':<34}{'count':>6}{'err':>5}{'p50 ms':>9}{'p99 ms':>9}")
    for (ht, mt), h in sorted(merged.items()):
        print(
            f"{ht + '.' + mt:<34}{h.count:>6}{h.error_count:>5}"
            f"{h.quantile(0.5) * 1e3:>9.3f}{h.quantile(0.99) * 1e3:>9.3f}"
        )
        if h.exemplar_trace:
            print(
                f"    exemplar: trace {h.exemplar_trace[:16]}… "
                f"({h.exemplar_s * 1e3:.3f} ms)"
            )


async def gauge_reader(servers: list, interval: float = 0.5) -> None:
    """Periodically log ``server_gauges`` DELTAS for every node.

    The in-process stand-in for a metrics scrape loop (the exporter version
    is ``rio_tpu_torch.otel.otlp_metrics_exporter``): snapshot each node's flat
    gauge dict every ``interval`` seconds and log the counters that moved,
    as ``name +delta=now``. Runs until cancelled, like the server tasks.
    """
    previous: dict[int, dict[str, float]] = {}
    while True:
        await asyncio.sleep(interval)
        for i, server in enumerate(servers):
            now = server_gauges(server)
            before = previous.get(i, {})
            moved = {
                k: (v - before.get(k, 0.0), v)
                for k, v in now.items()
                if v != before.get(k, 0.0)
            }
            previous[i] = now
            if moved:
                gauge_log.info(
                    "node[%d] %s",
                    i,
                    " ".join(
                        f"{k} {d:+g}={v:g}" for k, (d, v) in sorted(moved.items())
                    ),
                )


@message
class Work:
    item: str = ""


@message
class Ack:
    item: str = ""


class Worker(ServiceObject):
    def __init__(self) -> None:
        super().__init__()
        self.handled = 0

    # Volatile state riding the migration/replication snapshot protocol —
    # gives the demo's migration a real payload, so the journal shows the
    # install phase on BOTH nodes instead of an empty snapshot.
    def __migrate_state__(self) -> int:
        return self.handled

    def __restore_state__(self, state: int) -> None:
        self.handled = int(state)

    @handler
    async def work(self, msg: Work, ctx: AppData) -> Ack:
        self.handled += 1
        await asyncio.sleep(0.002)  # pretend to do something
        return Ack(item=msg.item)


class SpanAggregator:
    """Collects spans like an OTLP exporter would; prints a summary table."""

    def __init__(self) -> None:
        self.durations: dict[str, list[float]] = defaultdict(list)
        self.traces: dict[str, list[tracing.Span]] = defaultdict(list)

    def __call__(self, span: tracing.Span) -> None:
        self.durations[span.name].append(span.duration * 1e3)
        self.traces[span.trace_id].append(span)

    def report(self) -> None:
        print(f"{'span':<28}{'count':>6}{'mean ms':>10}{'p99 ms':>10}")
        for name in sorted(self.durations):
            d = self.durations[name]
            p99 = statistics.quantiles(d, n=100)[98] if len(d) >= 2 else d[0]
            print(f"{name:<28}{len(d):>6}{statistics.fmean(d):>10.3f}{p99:>10.3f}")

    def show_one_trace(self) -> None:
        """Render one request's correlated span tree (what Jaeger shows)."""
        trace_id, spans = max(self.traces.items(), key=lambda kv: len(kv[1]))
        by_id = {s.span_id: s for s in spans}
        print(f"\n[trace] one correlated request (trace {trace_id[:16]}…):")

        def walk(span: tracing.Span, depth: int) -> None:
            print(f"  {'  ' * depth}{span.name:<26} {span.duration * 1e3:8.3f} ms")
            for child in sorted(spans, key=lambda s: s.start):
                if child.parent_id == span.span_id:
                    walk(child, depth + 1)

        for root in [s for s in spans if s.parent_id not in by_id]:
            walk(root, 0)


async def series_scrape(client: "Client", members) -> dict:
    """Scrape every node's gauge time-series ring and render the trend view.

    One ``DumpSeries`` round trip per live node (``scrape_series`` skips
    nodes predating the ring), then the same pure ``_watch_rows`` →
    ``_format_watch`` pipeline the ``watch`` CLI loops on: per-node
    request rate / worst-handler p99 / inflight / sheds, each with a
    trend arrow over the scraped window, plus the node's solver mode and
    any active HealthWatch alerts from the snapshot meta.
    """
    from rio_tpu_torch.admin import _format_watch, _watch_rows, scrape_series
    from rio_tpu_torch.timeseries import merge_series

    snapshots = await scrape_series(client, members, limit=64)
    merged = merge_series(s.samples() for s in snapshots)
    print(
        f"\n[series] {len(snapshots)} nodes, {len(merged)} samples in the "
        "merged window; live trend view (admin `watch` renders this):"
    )
    print(_format_watch(_watch_rows(snapshots)))
    alerts = sum(len(s.meta.get("alerts", ())) for s in snapshots)
    return {
        "series_nodes": len(snapshots),
        "series_samples": len(merged),
        "series_alerts": alerts,
    }


async def journal_scrape(client: "Client", members, subject: tuple) -> dict:
    """Scrape every node's control-plane journal and explain one actor.

    The journal-side twin of :func:`cluster_scrape`: one ``DumpEvents``
    round trip per live node, merged into a causally ordered cluster tail
    (``merge_events`` inside :func:`rio_tpu_torch.admin.cluster_events`), then
    :func:`rio_tpu_torch.admin.explain` narrows to the migrated actor — its
    activation seat, each migration phase on BOTH nodes, and the trace id
    linking those rows to the request spans above.
    """
    tail = await cluster_events(client, members, limit=256)
    print(f"\n[journal] merged cluster tail ({len(tail)} control events):")
    for ev in tail[-12:]:
        print(f"  {format_event(ev)}")
    tname, oid = subject
    history = await explain(client, members, tname, oid)
    traces = {e.trace_id for e in history if e.trace_id}
    print(f"\n[journal] explain {tname}/{oid} ({len(history)} events):")
    for ev in history:
        print(f"  {format_event(ev)}")
    print(f"[journal] {len(traces)} linked trace(s)")
    return {"tail": len(tail), "explain": len(history), "traces": len(traces)}


async def main(n_requests: int = 50) -> dict:
    logging.basicConfig(level=logging.INFO)  # DEBUG to see per-span log lines
    aggregator = SpanAggregator()
    tracing.add_sink(tracing.logging_sink)
    tracing.add_sink(aggregator)
    # Head-based sampling: every client request roots a trace_ctx that the
    # wire then propagates server-side (1.0 here so the demo traces all).
    tracing.set_sample_rate(1.0)

    members = LocalStorage()
    placement = LocalObjectPlacement()
    servers = []
    for _ in range(2):
        s = Server(
            address="127.0.0.1:0",
            registry=Registry().add_type(Worker),
            cluster_provider=LocalClusterProvider(members),
            object_placement_provider=placement,
            # Demo-speed sampling so the one-shot DumpSeries scrape at the
            # end sees a real trend window (shipping default is 1 s).
            load_interval=0.05,
            timeseries_interval=0.05,
        )
        await s.prepare()
        print(f"[server] traced node on {await s.bind()}")
        servers.append(s)
    tasks = [asyncio.create_task(s.run()) for s in servers]
    tasks.append(asyncio.create_task(gauge_reader(servers, interval=0.05)))
    await asyncio.sleep(0.1)

    # Metrics push: real OTLP when the SDK is installed, the in-memory
    # collect-cycle fallback otherwise — always runnable.
    otlp_mode, exporter = start_metrics_export(servers)
    print(f"[metrics] export path: {otlp_mode}")

    client = Client(members)
    for i in range(n_requests):
        await client.send(Worker, f"w{i % 5}", Work(item=f"job-{i}"), returns=Ack)

    # Drive one real migration so the journal has a full phase chain to
    # show: pin → snapshot → install (both sides) → directory flip.
    from rio_tpu_torch.registry import ObjectId, type_id

    tname = type_id(Worker)
    owner = await placement.lookup(ObjectId(tname, "w0"))
    target = next(s.local_address for s in servers if s.local_address != owner)
    await client.send(
        ADMIN_TYPE,
        owner,
        AdminRequest(
            kind="migrate_object", type_name=tname, object_id="w0", target=target
        ),
        returns=AdminAck,
    )
    await asyncio.sleep(0.3)  # the admin queue runs the migration async
    await client.send(Worker, "w0", Work(item="post-migration"), returns=Ack)
    await asyncio.sleep(0.1)  # let the gauge reader log the final deltas

    # Wire scrape: DUMP_STATS every node via its rio.Admin actor and merge
    # the per-handler histograms into cluster-wide quantiles + exemplars.
    await cluster_scrape(client, members)

    # Flight-recorder scrape: DUMP_EVENTS every node, merge, and explain
    # the actor the demo just migrated.
    journal_summary = await journal_scrape(client, members, (tname, "w0"))

    # Trend scrape: DUMP_SERIES every node and render the per-node trend
    # table the `watch` CLI shows live.
    series_summary = await series_scrape(client, members)
    client.close()

    if otlp_mode == "in-memory":
        exporter.collect(servers)  # one explicit collect cycle, per node
        names = set().union(*(snap.keys() for snap in exporter.exported))
        print(
            f"[metrics] in-memory exporter: {len(exporter.exported)} node "
            f"snapshots, {len(names)} distinct gauges "
            f"({sum(1 for n in names if n.startswith('rio.journal.'))} journal)"
        )
    else:  # pragma: no cover - requires the optional SDK
        exporter.shutdown()

    for t in tasks:
        t.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)

    print("\n[trace] span summary (what an OTLP exporter would ship):")
    aggregator.report()
    aggregator.show_one_trace()
    tracing.clear_sinks()
    tracing.set_sample_rate(0.0)
    print("[demo] done")
    return {
        "otlp_mode": otlp_mode,
        "snapshots": len(exporter.exported) if otlp_mode == "in-memory" else 0,
        "spans": sum(len(d) for d in aggregator.durations.values()),
        **journal_summary,
        **series_summary,
    }


if __name__ == "__main__":
    asyncio.run(main())
