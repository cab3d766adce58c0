"""Node-scoped admin/observability actor: the wire face of the ops plane.

Two services behind one ``rio.Admin`` actor per node (``__node_scoped__``,
id = the node's address, routed without the directory exactly like the
migration control plane):

* :class:`DumpStats` → :class:`StatsSnapshot` — the cluster scrape. One
  round trip returns the node's full :func:`rio_tpu_torch.otel.server_gauges`
  snapshot plus its raw RED histogram rows
  (:meth:`rio_tpu_torch.metrics.MetricsRegistry.snapshot_rows`), which are
  mergeable across nodes — a scraper walks the membership view, asks every
  node, and :func:`rio_tpu_torch.metrics.merge_rows` yields cluster-wide
  p50/p99 (see ``examples/observability.py``).
* :class:`AdminRequest` → :class:`AdminAck` — a remote bridge onto the
  in-process :class:`~rio_tpu_torch.commands.AdminSender` queue (drain this
  node, migrate an object, shut an object down) so ops tooling needs only
  a :class:`~rio_tpu_torch.client.Client`.
* :class:`DumpEvents` → :class:`EventsSnapshot` — the control-plane
  flight recorder scrape (``rio_tpu_torch/journal.py``): a filtered tail of the
  node's journal ring as wire rows, resumable by ``since_seq``.
  :func:`explain` walks every live node and merges the per-node streams
  into one causally ordered placement history for a single actor.

The gauge/histogram sources are injected at ``Server.bind()`` as a
:class:`StatsSource` — the actor itself stays free of server imports.

Operator CLI (see ``_cli_main``)::

    python -m rio_tpu_torch.admin tail    --nodes host:p,host:p [--kind K] [--key K]
    python -m rio_tpu_torch.admin explain --nodes host:p,host:p TYPE ID
    python -m rio_tpu_torch.admin stats   --nodes host:p,host:p
    python -m rio_tpu_torch.admin trace   --nodes host:p,host:p TRACE_ID
    python -m rio_tpu_torch.admin edges   --nodes host:p,host:p [--limit K]
    python -m rio_tpu_torch.admin qos     --nodes host:p,host:p [--limit K]
    python -m rio_tpu_torch.admin --demo {tail|explain|stats|watch|trace|edges|qos}

A fourth wire pair serves the request-waterfall plane: :class:`DumpSpans`
→ :class:`SpansSnapshot` returns the node's retained request spans
(``rio_tpu_torch/spans.py``); :func:`scrape_spans` + :func:`assemble_waterfall`
merge every ring — servers and the calling process's client ring — into
causally ordered per-trace hop trees rendered by the ``trace`` subcommand.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Sequence

from .app_data import AppData
from .commands import AdminCommand, AdminCommandKind, AdminSender
from .journal import Journal, JournalEvent, format_event, merge_events, subject_key
from .registry import handler, message, type_name
from .service_object import ServiceObject

#: Wire type-name of the node-scoped admin actor.
ADMIN_TYPE = "rio.Admin"


@message(name="rio.DumpStats")
@dataclass
class DumpStats:
    """Ask a node for its gauge + RED-histogram snapshot."""

    # Histograms dominate the payload on wide deployments; a pure-gauge
    # scrape can skip them.
    include_histograms: bool = True


@message(name="rio.StatsSnapshot")
@dataclass
class StatsSnapshot:
    """One node's observability snapshot (mergeable across nodes)."""

    address: str = ""
    gauges: dict[str, float] = field(default_factory=dict)
    # rio_tpu_torch.metrics wire rows: [handler_type, message_type, count,
    # error_count, errors{kind:int}, buckets[], sum_s, max_s,
    # exemplar_trace, exemplar_s] — merge with metrics.merge_rows.
    histograms: list = field(default_factory=list)


@message(name="rio.DumpEvents")
@dataclass
class DumpEvents:
    """Ask a node for a filtered tail of its control-plane journal.

    Empty ``kinds``/``key`` mean "no filter"; ``since_seq`` resumes a tail
    (only events with ``seq > since_seq`` return); ``limit`` bounds the
    response to the NEWEST matches (0 = journal capacity).
    """

    kinds: list = field(default_factory=list)  # journal kind strings
    key: str = ""  # exact subject match, e.g. "Worker/w3"
    since_seq: int = 0
    limit: int = 512


@message(name="rio.EventsSnapshot")
@dataclass
class EventsSnapshot:
    """One node's journal tail (mergeable across nodes: ``merge_events``)."""

    address: str = ""
    node_seq: int = 0  # the node's latest journal seq (tail resume point)
    dropped: int = 0  # ring-overflow drop counter at scrape time
    # JournalEvent wire rows: [seq, wall_ts, mono_ts, node, epoch, kind,
    # key, attrs, trace_id] — decode with JournalEvent.from_row.
    rows: list = field(default_factory=list)

    def events(self) -> list[JournalEvent]:
        return [JournalEvent.from_row(r) for r in self.rows]


@message(name="rio.DumpSeries")
@dataclass
class DumpSeries:
    """Ask a node for a window of its gauge time-series ring.

    ``names`` projects each sample down to the named gauges (a trailing
    ``.`` makes a name a prefix filter, e.g. ``rio.handler.``); empty
    means every gauge. ``since_seq`` resumes a tail (only samples with
    ``seq > since_seq`` return); ``limit`` bounds the response to the
    NEWEST samples (0 = ring capacity).
    """

    names: list = field(default_factory=list)
    since_seq: int = 0
    limit: int = 240


@message(name="rio.SeriesSnapshot")
@dataclass
class SeriesSnapshot:
    """One node's gauge time-series window (merge with ``merge_series``)."""

    address: str = ""
    node_seq: int = 0  # the node's latest sample seq (tail resume point)
    dropped: int = 0  # ring-overwrite counter at scrape time
    # SeriesSample wire rows: [seq, wall_ts, mono_ts, node, gauges] —
    # decode with SeriesSample.from_row.
    rows: list = field(default_factory=list)
    # Node-side context that isn't a time series: solver mode, active
    # health alerts. String-keyed, append-only growth.
    meta: dict = field(default_factory=dict)

    def samples(self) -> list:
        from .timeseries import SeriesSample

        return [SeriesSample.from_row(r) for r in self.rows]


@message(name="rio.DumpSpans")
@dataclass
class DumpSpans:
    """Ask a node for retained request spans from its waterfall ring.

    ``trace_id`` filters to one trace (empty = every retained span);
    ``since_seq`` resumes a tail (only spans with ``seq > since_seq``
    return); ``limit`` bounds the response to the NEWEST matches
    (0 = ring capacity).
    """

    trace_id: str = ""
    since_seq: int = 0
    limit: int = 256


@message(name="rio.SpansSnapshot")
@dataclass
class SpansSnapshot:
    """One node's retained spans (merge with ``spans.merge_spans``)."""

    address: str = ""
    node_seq: int = 0  # the node's latest span seq (tail resume point)
    dropped: int = 0  # ring-overwrite counter at scrape time
    # SpanRecord wire rows: [seq, trace_id, span_id, parent_id, name,
    # node, wall_start, duration_us, attrs] — decode with
    # SpanRecord.from_row.
    rows: list = field(default_factory=list)

    def spans(self) -> list:
        from .spans import SpanRecord

        return [SpanRecord.from_row(r) for r in self.rows]


@message(name="rio.DumpEdges")
@dataclass
class DumpEdges:
    """Ask a node for its communication-edge graph (``rio_tpu_torch/affinity``).

    ``limit`` bounds the response to the HEAVIEST edges by byte rate
    (0 = everything the sampler retained, itself top-K bounded).
    """

    limit: int = 256


@message(name="rio.EdgesSnapshot")
@dataclass
class EdgesSnapshot:
    """One node's sampled edge graph (merge with ``affinity.merge_edges``)."""

    address: str = ""
    # EdgeSampler wire rows: [src, dst, bytes_per_s, calls_per_s,
    # local_frac] — src/dst are "{type}.{id}" object keys ("client" for
    # external callers). Rows may only ever GROW by appending trailing
    # fields.
    rows: list = field(default_factory=list)
    sampled: int = 0  # dispatches observed (stride-scaled source count)
    evictions: int = 0  # cold edges dropped by the top-K bound
    cross_bytes_per_s: float = 0.0  # EMA byte rate of non-local traffic


@message(name="rio.DumpQos")
@dataclass
class DumpQos:
    """Ask a node for its request-QoS scheduler state (``rio_tpu_torch/qos``).

    ``limit`` bounds the per-(tenant, class) RED rows to the busiest
    tenants by request count (0 = every row the scheduler retained).
    """

    limit: int = 64


@message(name="rio.QosSnapshot")
@dataclass
class QosSnapshot:
    """One node's QoS scheduler state. ``enabled`` is False (and every
    counter zero) on nodes built without a ``qos_config`` — a mixed
    cluster scrapes uniformly."""

    address: str = ""
    enabled: bool = False
    running: int = 0
    queued: int = 0
    admitted: int = 0
    sheds: int = 0
    deadline_drops: int = 0
    interactive_admitted: int = 0
    interactive_sheds: int = 0
    # Class label -> parked depth right now ("p2", "fair", ...).
    queue_depths: dict = field(default_factory=dict)
    # Per-(tenant, class) RED rows: [tenant, class, requests, errors,
    # avg_ms, avg_queue_ms, sheds, deadline_drops]. Rows may only ever
    # GROW by appending trailing fields.
    tenants: list = field(default_factory=list)


@message(name="rio.AdminRequest")
@dataclass
class AdminRequest:
    """Enqueue one :class:`~rio_tpu_torch.commands.AdminCommand` on the node."""

    kind: str = ""  # an AdminCommandKind value, e.g. "drain_server"
    type_name: str = ""
    object_id: str = ""
    target: str = ""


@message(name="rio.AdminAck")
@dataclass
class AdminAck:
    ok: bool = False
    detail: str = ""


@dataclass
class StatsSource:
    """AppData-injectable snapshot providers (wired at ``Server.bind()``).

    ``gauges`` returns the :func:`~rio_tpu_torch.otel.server_gauges` dict;
    ``histogram_rows`` returns the mergeable RED rows (empty when metrics
    are disabled). A dataclass wrapper — not bare callables — so AppData's
    type-keyed map can hold it.
    """

    gauges: Callable[[], dict[str, float]]
    histogram_rows: Callable[[], list[Any]]


@dataclass
class SeriesSource:
    """AppData-injectable time-series ring handle (wired at ``Server.bind()``).

    ``series`` is the node's :class:`~rio_tpu_torch.timeseries.GaugeSeries`;
    ``meta`` returns scrape-time context that isn't a series (solver mode,
    active health alerts) for :class:`SeriesSnapshot.meta`.
    """

    series: Any  # rio_tpu_torch.timeseries.GaugeSeries
    meta: Callable[[], dict] = dict


@type_name(ADMIN_TYPE)
class AdminControl(ServiceObject):
    """Node-scoped observability/ops endpoint (one per server; id = address)."""

    __node_scoped__ = True

    @handler
    async def dump_stats(self, msg: DumpStats, ctx: AppData) -> StatsSnapshot:
        from .commands import ServerInfo

        info = ctx.try_get(ServerInfo)
        source = ctx.try_get(StatsSource)
        if source is None:
            return StatsSnapshot(address=info.address if info else "")
        rows = source.histogram_rows() if msg.include_histograms else []
        return StatsSnapshot(
            address=info.address if info else "",
            gauges=source.gauges(),
            histograms=rows,
        )

    @handler
    async def dump_events(self, msg: DumpEvents, ctx: AppData) -> EventsSnapshot:
        from .commands import ServerInfo

        info = ctx.try_get(ServerInfo)
        address = info.address if info else ""
        journal = ctx.try_get(Journal)
        if journal is None:
            return EventsSnapshot(address=address)
        events = journal.events(
            kinds=msg.kinds or None,
            key=msg.key or None,
            since_seq=msg.since_seq,
            limit=msg.limit if msg.limit > 0 else None,
        )
        return EventsSnapshot(
            address=address,
            node_seq=journal.recorded,
            dropped=journal.dropped,
            rows=[e.to_row() for e in events],
        )

    @handler
    async def dump_series(self, msg: DumpSeries, ctx: AppData) -> SeriesSnapshot:
        from .commands import ServerInfo

        info = ctx.try_get(ServerInfo)
        address = info.address if info else ""
        source = ctx.try_get(SeriesSource)
        if source is None or source.series is None:
            return SeriesSnapshot(address=address)
        series = source.series
        samples = series.window(
            names=msg.names or None,
            since_seq=msg.since_seq,
            limit=msg.limit if msg.limit > 0 else None,
        )
        return SeriesSnapshot(
            address=address,
            node_seq=series.sampled,
            dropped=series.dropped,
            rows=[s.to_row() for s in samples],
            meta=dict(source.meta() or {}),
        )

    @handler
    async def dump_spans(self, msg: DumpSpans, ctx: AppData) -> SpansSnapshot:
        from .commands import ServerInfo
        from .spans import SpanRing

        info = ctx.try_get(ServerInfo)
        address = info.address if info else ""
        ring = ctx.try_get(SpanRing)
        if ring is None:
            return SpansSnapshot(address=address)
        records = ring.spans(
            trace_id=msg.trace_id or None,
            since_seq=msg.since_seq,
            limit=msg.limit if msg.limit > 0 else None,
        )
        return SpansSnapshot(
            address=address,
            node_seq=ring.retained,
            dropped=ring.dropped,
            rows=[r.to_row() for r in records],
        )

    @handler
    async def dump_edges(self, msg: DumpEdges, ctx: AppData) -> EdgesSnapshot:
        from .affinity import EdgeSampler
        from .commands import ServerInfo

        info = ctx.try_get(ServerInfo)
        address = info.address if info else ""
        sampler = ctx.try_get(EdgeSampler)
        if sampler is None:
            return EdgesSnapshot(address=address)
        sampler.fold(force=True)  # rows reflect traffic up to this scrape
        return EdgesSnapshot(
            address=address,
            rows=sampler.edges(limit=msg.limit),
            sampled=sampler.sampled,
            evictions=sampler.evictions,
            cross_bytes_per_s=round(sampler.cross_bytes_per_s, 3),
        )

    @handler
    async def dump_qos(self, msg: DumpQos, ctx: AppData) -> QosSnapshot:
        from .commands import ServerInfo
        from .qos import QosScheduler

        info = ctx.try_get(ServerInfo)
        address = info.address if info else ""
        qos = ctx.try_get(QosScheduler)
        if qos is None:
            return QosSnapshot(address=address)
        rows = qos.tenant_rows()
        if msg.limit > 0 and len(rows) > msg.limit:
            rows = sorted(rows, key=lambda r: -r[2])[: msg.limit]
        s = qos.stats
        return QosSnapshot(
            address=address,
            enabled=True,
            running=qos.running,
            queued=qos.queued,
            admitted=s.admitted,
            sheds=s.sheds,
            deadline_drops=s.deadline_drops,
            interactive_admitted=s.interactive_admitted,
            interactive_sheds=s.interactive_sheds,
            queue_depths=qos.queue_depths(),
            tenants=rows,
        )

    @handler
    async def admin(self, msg: AdminRequest, ctx: AppData) -> AdminAck:
        sender = ctx.try_get(AdminSender)
        if sender is None:
            return AdminAck(ok=False, detail="no admin queue on this node")
        try:
            kind = AdminCommandKind(msg.kind)
        except ValueError:
            return AdminAck(ok=False, detail=f"unknown admin kind {msg.kind!r}")
        sender.send(
            AdminCommand(kind, msg.type_name, msg.object_id, msg.target)
        )
        return AdminAck(ok=True)


# -- cluster-wide journal queries (the explain plane) ------------------------


async def _node_addresses(nodes: Any) -> list[str]:
    """Accept a MembershipStorage (live view) or an explicit address list."""
    if hasattr(nodes, "active_members"):
        return [m.address for m in await nodes.active_members()]
    return list(nodes)


async def scrape_events(
    client: Any,
    nodes: Any,
    *,
    kinds: Iterable[str] | None = None,
    key: str | None = None,
    since_seq: int = 0,
    limit: int = 512,
) -> list[EventsSnapshot]:
    """One :class:`DumpEvents` round trip per live node; dead nodes skipped.

    ``nodes`` is either a membership storage (scrape whoever is active,
    like ``cluster_scrape``) or an explicit iterable of addresses.
    """
    msg = DumpEvents(
        kinds=list(kinds or []), key=key or "", since_seq=since_seq, limit=limit
    )
    snapshots: list[EventsSnapshot] = []
    for address in await _node_addresses(nodes):
        try:
            snap = await client.send(ADMIN_TYPE, address, msg, returns=EventsSnapshot)
        except Exception:
            continue  # unreachable/draining node: explain over the survivors
        snapshots.append(snap)
    return snapshots


async def scrape_series(
    client: Any,
    nodes: Any,
    *,
    names: Iterable[str] | None = None,
    since_seq: int = 0,
    limit: int = 240,
) -> list[SeriesSnapshot]:
    """One :class:`DumpSeries` round trip per live node; dead nodes skipped.

    Nodes predating the series ring answer the admin envelope with an
    error (unknown message) — they are skipped like unreachable nodes, so
    a mixed-version cluster still yields the survivors' windows.
    """
    msg = DumpSeries(names=list(names or []), since_seq=since_seq, limit=limit)
    snapshots: list[SeriesSnapshot] = []
    for address in await _node_addresses(nodes):
        try:
            snap = await client.send(ADMIN_TYPE, address, msg, returns=SeriesSnapshot)
        except Exception:
            continue
        snapshots.append(snap)
    return snapshots


async def scrape_spans(
    client: Any,
    nodes: Any,
    *,
    trace_id: str = "",
    since_seq: int = 0,
    limit: int = 256,
) -> list[SpansSnapshot]:
    """One :class:`DumpSpans` round trip per live node; dead nodes skipped.

    Nodes predating span retention answer the admin envelope with an
    error (unknown message) — they are skipped like unreachable nodes, so
    a mixed-version cluster still yields the survivors' spans.
    """
    msg = DumpSpans(trace_id=trace_id, since_seq=since_seq, limit=limit)
    snapshots: list[SpansSnapshot] = []
    for address in await _node_addresses(nodes):
        try:
            snap = await client.send(ADMIN_TYPE, address, msg, returns=SpansSnapshot)
        except Exception:
            continue
        snapshots.append(snap)
    return snapshots


async def scrape_edges(
    client: Any,
    nodes: Any,
    *,
    limit: int = 256,
) -> list[EdgesSnapshot]:
    """One :class:`DumpEdges` round trip per live node; dead nodes skipped.

    Nodes predating the edge sampler answer the admin envelope with an
    error (unknown message) — they are skipped like unreachable nodes, so
    a mixed-version cluster still yields the survivors' graphs.
    """
    msg = DumpEdges(limit=limit)
    snapshots: list[EdgesSnapshot] = []
    for address in await _node_addresses(nodes):
        try:
            snap = await client.send(ADMIN_TYPE, address, msg, returns=EdgesSnapshot)
        except Exception:
            continue
        snapshots.append(snap)
    return snapshots


async def scrape_qos(
    client: Any,
    nodes: Any,
    *,
    limit: int = 64,
) -> list[QosSnapshot]:
    """One :class:`DumpQos` round trip per live node; dead nodes skipped.

    Nodes predating the QoS subsystem answer the admin envelope with an
    error (unknown message) — they are skipped like unreachable nodes, so
    a mixed-version cluster still yields the survivors' snapshots.
    """
    msg = DumpQos(limit=limit)
    snapshots: list[QosSnapshot] = []
    for address in await _node_addresses(nodes):
        try:
            snap = await client.send(ADMIN_TYPE, address, msg, returns=QosSnapshot)
        except Exception:
            continue
        snapshots.append(snap)
    return snapshots


async def cluster_edges(
    client: Any,
    nodes: Any,
    *,
    limit: int = 256,
) -> list[list]:
    """The cluster-merged communication graph, heaviest pairs first.

    Each node observes its own side of the traffic (dst-side for local
    sends, sender-side for remote ones), so the merge sums per-node rates
    into cluster-wide edge weights — the rows
    :meth:`JaxObjectPlacement.set_edge_graph` consumes directly.
    """
    from .affinity import merge_edges

    snapshots = await scrape_edges(client, nodes, limit=limit)
    return merge_edges([s.rows for s in snapshots])


async def cluster_events(
    client: Any,
    nodes: Any,
    *,
    kinds: Iterable[str] | None = None,
    key: str | None = None,
    since_seq: int = 0,
    limit: int = 512,
) -> list[JournalEvent]:
    """The merged, causally ordered cluster journal tail."""
    snapshots = await scrape_events(
        client, nodes, kinds=kinds, key=key, since_seq=since_seq, limit=limit
    )
    return merge_events(s.events() for s in snapshots)


async def explain(
    client: Any,
    nodes: Any,
    type_name: str,
    object_id: str,
    *,
    limit: int = 512,
) -> list[JournalEvent]:
    """One actor's causally ordered placement history, cluster-wide.

    Merges every live node's journal rows for subject ``type/id`` into a
    single timeline: activation seat, admission sheds, each migration
    phase (source AND target side), promotion/depose, replica churn —
    whatever the cluster recorded about this actor, in order, each row
    carrying the trace id of the request that drove it.
    """
    return await cluster_events(
        client, nodes, key=subject_key(type_name, object_id), limit=limit
    )


# -- request waterfalls (the trace plane) ------------------------------------


def assemble_waterfall(
    records: Iterable[Any], events: Iterable[JournalEvent] = ()
) -> dict[str, dict]:
    """Group merged span records into per-trace waterfall trees.

    Returns ``{trace_id: {"roots": [hop...], "hops": n, "events": [...]}}``
    where each hop is ``{"record": SpanRecord, "children": [hop...]}``.
    Roots are records whose ``parent_id`` is empty or names a span no ring
    retained (e.g. a caller that never armed its client ring); siblings
    order by wall-clock start, so a redirect hop on node A prints before
    the re-dispatched hop on node B it caused. Journal events carrying the
    trace id ride along, joining placement history to request timing.
    """
    from .spans import merge_spans

    merged = merge_spans([records])
    by_trace: dict[str, list] = {}
    for rec in merged:
        by_trace.setdefault(rec.trace_id, []).append(rec)
    ev_by_trace: dict[str, list[JournalEvent]] = {}
    for ev in events:
        if ev.trace_id:
            ev_by_trace.setdefault(ev.trace_id, []).append(ev)
    out: dict[str, dict] = {}
    for trace_id, recs in by_trace.items():
        span_ids = {r.span_id for r in recs}
        hops = [{"record": r, "children": []} for r in recs]
        by_span = {h["record"].span_id: h for h in hops}
        roots: list[dict] = []
        for h in hops:  # recs are merge-ordered, so children/roots stay sorted
            pid = h["record"].parent_id
            if pid and pid in span_ids and pid != h["record"].span_id:
                by_span[pid]["children"].append(h)
            else:
                roots.append(h)
        out[trace_id] = {
            "roots": roots,
            "hops": len(recs),
            "events": ev_by_trace.get(trace_id, []),
        }
    return out


def _phase_str(attrs: dict) -> str:
    """One-line phase decomposition for a hop (display order = pipeline)."""
    from .spans import PHASE_KEYS

    parts = [
        f"{k[:-3]}={attrs[k]}us" for k in PHASE_KEYS if k in attrs
    ]
    for k in ("send_us", "await_us"):  # client-hop phases
        if k in attrs:
            parts.append(f"{k[:-3]}={attrs[k]}us")
    return " ".join(parts)


def format_waterfall(trace_id: str, tree: dict) -> str:
    """Render one assembled trace as an indented per-hop waterfall."""
    lines = [f"trace {trace_id}  ({tree['hops']} hop(s))"]

    def walk(hop: dict, depth: int) -> None:
        r = hop["record"]
        attrs = r.attrs
        flags = []
        if attrs.get("status"):
            flags.append(f"status={attrs['status']}")
        if attrs.get("redirects"):
            flags.append(f"redirects={attrs['redirects']}")
        if attrs.get("error"):
            flags.append(f"error={attrs['error']}")
        if attrs.get("tail"):
            flags.append("tail")
        lines.append(
            "  " * (depth + 1)
            + f"{r.name} {attrs.get('handler', '?')} @{r.node or 'client'}"
            + f"  {r.duration_us / 1000.0:.2f} ms"
            + (f"  [{' '.join(flags)}]" if flags else "")
        )
        ph = _phase_str(attrs)
        if ph:
            lines.append("  " * (depth + 2) + ph)
        for child in hop["children"]:
            walk(child, depth + 1)

    for root in tree["roots"]:
        walk(root, 0)
    for ev in tree["events"]:
        lines.append("  * " + format_event(ev))
    return "\n".join(lines)


def _span_dict(r: Any) -> dict:
    return {
        "seq": r.seq,
        "trace_id": r.trace_id,
        "span_id": r.span_id,
        "parent_id": r.parent_id,
        "name": r.name,
        "node": r.node,
        "wall_start": r.wall_start,
        "duration_us": r.duration_us,
        "attrs": r.attrs,
    }


# -- operator CLI: python -m rio_tpu_torch.admin {tail|explain|stats|watch|trace} --


def _watch_rows(snapshots: Sequence[SeriesSnapshot]) -> list[dict]:
    """Per-node ``watch`` table rows from DumpSeries scrapes.

    Each row carries the newest value and a trend arrow (over the scraped
    window) for rate/p99/inflight/sheds, plus the node's solver mode and
    active alerts from the snapshot meta. Pure function — the table the
    operator sees is exactly what the CLI test asserts on.
    """
    from .timeseries import series_values, trend_arrow

    rows: list[dict] = []
    for snap in sorted(snapshots, key=lambda s: s.address):
        samples = snap.samples()
        # Per-sample max over the per-handler p99 gauges: the node's worst
        # handler latency, trended like any scalar gauge.
        p99s = [
            max(v for k, v in s.gauges.items() if k.endswith(".p99_ms"))
            for s in samples
            if any(k.endswith(".p99_ms") for k in s.gauges)
        ]
        row: dict = {
            "address": snap.address,
            "samples": len(samples),
            "dropped": snap.dropped,
            "solver_mode": str(snap.meta.get("solver_mode", "") or "-"),
            "alerts": list(snap.meta.get("alerts", ())),
            # Exemplar trace id per firing alert ("rule:gauge" -> trace_id):
            # the slow request that tripped the rule, ready for
            # `admin trace <id>`. Absent on pre-waterfall nodes.
            "alert_traces": dict(snap.meta.get("alert_traces", {})),
            "p99_ms": p99s[-1] if p99s else 0.0,
            "p99_trend": trend_arrow(p99s),
        }
        for col, gauge in (
            ("rate", "rio.load.req_rate"),
            ("inflight", "rio.load.inflight"),
            ("sheds", "rio.load.sheds"),
        ):
            vals = series_values(samples, gauge)
            row[col] = vals[-1] if vals else 0.0
            row[f"{col}_trend"] = trend_arrow(vals)
        rows.append(row)
    return rows


def _format_watch(rows: Sequence[dict]) -> str:
    header = (
        f"{'node':<22} {'rate':>9}  {'p99_ms':>9}  {'inflight':>9} "
        f"{'sheds':>7}  {'mode':<12} alerts"
    )
    lines = [header, "-" * len(header)]
    for r in rows:
        lines.append(
            f"{r['address']:<22} "
            f"{r['rate']:>7.1f} {r['rate_trend']}  "
            f"{r['p99_ms']:>7.2f} {r['p99_trend']}  "
            f"{r['inflight']:>7.0f} {r['inflight_trend']} "
            f"{r['sheds']:>5.0f} {r['sheds_trend']}  "
            f"{r['solver_mode']:<12} "
            + (
                ",".join(
                    a
                    + (
                        f"[{r['alert_traces'][a][:8]}]"
                        if r.get("alert_traces", {}).get(a)
                        else ""
                    )
                    for a in r["alerts"]
                )
                or "-"
            )
        )
    return "\n".join(lines)


def _event_dict(ev: JournalEvent) -> dict:
    return {
        "seq": ev.seq,
        "wall_ts": ev.wall_ts,
        "node": ev.node,
        "epoch": ev.epoch,
        "kind": ev.kind,
        "key": ev.key,
        "attrs": ev.attrs,
        "trace_id": ev.trace_id,
    }


async def _cli_cluster(args: Any):
    """Resolve (client, nodes, cleanup) for the CLI: --nodes or --demo."""
    from .client import Client
    from .cluster.storage import LocalStorage, Member

    if args.demo and getattr(args, "cmd", "") == "scale":
        # The scale demo needs an autoscale-enabled cluster: one supervisor
        # with an in-process provisioner, pushed over its high band until
        # the controller has a real decision to show.
        import asyncio
        import time as _time

        from .autoscale import AutoscaleConfig, ScalePolicy
        from .autoscale.provision import InProcessProvisioner
        from .cluster.membership_protocol import LocalClusterProvider
        from .object_placement import LocalObjectPlacement
        from .server import Server
        from .utils.routing_live import Echo, EchoActor, build_echo_registry

        members = LocalStorage()
        placement = LocalObjectPlacement()
        provisioner = InProcessProvisioner(
            members,
            placement,
            registry_builder=build_echo_registry,
            server_kwargs={"load_interval": 0.1},
        )
        policy = ScalePolicy(
            min_nodes=1, max_nodes=2, high_pressure=50.0, low_pressure=8.0,
            sustain=2, inflight_weight=0.0, lag_weight=0.0, rate_weight=1.0,
            shed_weight=0.0, out_cooldown_s=5.0,
        )
        supervisor = Server(
            address="127.0.0.1:0",
            registry=build_echo_registry(),
            cluster_provider=LocalClusterProvider(members),
            object_placement_provider=placement,
            load_interval=0.1,
            autoscale_config=AutoscaleConfig(
                provisioner=provisioner, policy=policy, interval=0.1
            ),
        )
        await supervisor.prepare()
        await supervisor.bind()
        serve = asyncio.ensure_future(supervisor.run())
        client = Client(members)
        deadline = _time.monotonic() + 30.0
        i = 0
        while (
            supervisor.autoscale.scale_outs < 1
            and _time.monotonic() < deadline
        ):
            i += 1
            try:
                await client.send(
                    EchoActor, f"w{i % 8}", Echo(value=i), returns=Echo
                )
            except Exception:  # noqa: BLE001 — demo load, keep pushing
                await asyncio.sleep(0.01)

        async def cleanup() -> None:
            client.close()
            serve.cancel()
            await asyncio.gather(serve, return_exceptions=True)
            await provisioner.close()

        return client, members, cleanup

    if args.demo and getattr(args, "cmd", "") == "qos":
        # The qos demo needs a scheduler-enabled cluster: a weighted
        # interactive tenant plus a rate-limited bulk tenant driven past
        # its admission bucket, so the scrape has sheds and RED rows to
        # render.
        import asyncio

        from .errors import ClientError
        from .qos import QosConfig
        from .utils.routing_live import Echo, EchoActor, boot_echo_cluster

        members, placement, tasks, servers = await boot_echo_cluster(
            2,
            server_kwargs=dict(
                qos_config=QosConfig(
                    tenant_weights={"frontend": 4.0},
                    tenant_rates={"bulk": (200.0, 8.0)},
                )
            ),
        )
        client = Client(members)
        for i in range(40):
            try:
                # A short budget caps each shed's retry ladder so the
                # flood finishes promptly; spent budgets surface here as
                # DeadlineExceeded and simply count.
                await client.send(
                    EchoActor, f"b{i % 8}", Echo(value=i), returns=Echo,
                    tenant="bulk", deadline_ms=250,
                )
            except ClientError:
                pass
        for i in range(10):
            await client.send(
                EchoActor, f"f{i % 4}", Echo(value=i), returns=Echo,
                tenant="frontend", priority=2, deadline_ms=2000,
            )

        async def cleanup() -> None:
            client.close()
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

        return client, members, cleanup

    if args.demo:
        import asyncio

        from . import tracing
        from .utils.routing_live import Echo, EchoActor, boot_echo_cluster
        from .registry import type_id

        tracing.set_sample_rate(1.0)  # demo journal rows carry trace ids
        if getattr(args, "cmd", "") == "trace":
            # Record the demo driver's own client hops so the waterfall
            # starts at the caller (send/await + redirect follows).
            from .spans import arm_client_ring

            arm_client_ring()
        members, placement, tasks, servers = await boot_echo_cluster(
            2,
            # Aggressive sampling so a one-shot demo scrape has a window.
            server_kwargs=dict(load_interval=0.05, timeseries_interval=0.05),
        )
        client = Client(members)
        tname = type_id(EchoActor)
        for i in range(20):
            await client.send(EchoActor, f"w{i % 4}", Echo(value=i), returns=Echo)
        # Drive one real migration so the tail shows the full phase chain.
        from .registry import ObjectId

        owner = await placement.lookup(ObjectId(tname, "w0"))
        target = next(s.local_address for s in servers if s.local_address != owner)
        if owner:
            await client.send(
                ADMIN_TYPE,
                owner,
                AdminRequest(
                    kind="migrate_object",
                    type_name=tname,
                    object_id="w0",
                    target=target,
                ),
                returns=AdminAck,
            )
            await asyncio.sleep(0.4)  # let the queued migration run
            await client.send(EchoActor, "w0", Echo(value=99), returns=Echo)
        if getattr(args, "cmd", "") == "watch":
            await asyncio.sleep(0.5)  # several sampler ticks → a trend window
        if not getattr(args, "subject", None):
            args.subject = (tname, "w0")
        if getattr(args, "cmd", "") == "trace" and not getattr(args, "trace_id", ""):
            # No trace id given: pick a demo request that crossed nodes
            # (a redirect follow) so the waterfall shows several hops.
            from .spans import client_ring

            recs = client_ring().spans()
            pick = next(
                (r for r in recs if r.attrs.get("redirects")),
                recs[-1] if recs else None,
            )
            args.trace_id = pick.trace_id if pick else ""

        async def cleanup() -> None:
            client.close()
            tracing.set_sample_rate(0.0)
            if getattr(args, "cmd", "") == "trace":
                from .spans import disarm_client_ring

                disarm_client_ring()
            for t in tasks:
                t.cancel()
            import asyncio

            await asyncio.gather(*tasks, return_exceptions=True)

        return client, members, cleanup

    members = LocalStorage()
    for address in (args.nodes or "").split(","):
        if address.strip():
            await members.push(Member.from_address(address.strip(), active=True))

    client = Client(members)

    async def cleanup() -> None:
        client.close()

    return client, members, cleanup


async def _cli_main(argv: Sequence[str] | None = None) -> int:
    """Operator CLI. Exit codes (scriptable, see the CLI test):

    * 0 — scrape succeeded (at least one node answered).
    * 1 — empty scrape: no node in the target set answered (unreachable /
      pre-series cluster).
    * 2 — usage (missing explain subject; argparse errors also exit 2).
    """
    import argparse
    import asyncio
    import json
    import time

    parser = argparse.ArgumentParser(
        prog="python -m rio_tpu_torch.admin",
        description="Operator view of the control-plane flight recorder.",
    )
    parser.add_argument(
        "--nodes", default="", help="comma-separated node addresses (host:port,...)"
    )
    parser.add_argument(
        "--demo",
        action="store_true",
        help="boot a 2-node in-process cluster, drive traffic + one migration, "
        "then run the subcommand against it",
    )
    parser.add_argument(
        "--json",
        action="store_true",
        help="machine-readable output (one JSON document on stdout)",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    def _common(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
        # The shared flags are accepted on either side of the subcommand
        # (`--demo tail` and `watch --demo --once` both work); SUPPRESS
        # defaults keep a pre-subcommand value from being clobbered.
        p.add_argument("--nodes", default=argparse.SUPPRESS)
        p.add_argument("--demo", action="store_true", default=argparse.SUPPRESS)
        p.add_argument("--json", action="store_true", default=argparse.SUPPRESS)
        return p

    tail = _common(sub.add_parser("tail", help="merged cluster journal tail"))
    tail.add_argument("--kind", action="append", default=[], help="filter by kind")
    tail.add_argument("--key", default="", help="filter by subject key (type/id)")
    tail.add_argument("--since-seq", type=int, default=0)
    tail.add_argument("--limit", type=int, default=64)

    exp = _common(
        sub.add_parser("explain", help="one actor's causal placement history")
    )
    exp.add_argument("type_name", nargs="?", default="")
    exp.add_argument("object_id", nargs="?", default="")

    _common(
        sub.add_parser(
            "stats", help="per-node gauge snapshot (journal counters incl.)"
        )
    )

    watch = _common(
        sub.add_parser(
            "watch", help="live per-node trend table over the gauge time-series"
        )
    )
    watch.add_argument(
        "--once", action="store_true", help="print one table and exit"
    )
    watch.add_argument(
        "--interval", type=float, default=2.0, help="refresh period (seconds)"
    )
    watch.add_argument(
        "--window", type=int, default=64, help="samples scraped per node"
    )

    edges_p = _common(
        sub.add_parser(
            "edges",
            help="top chatty actor pairs from the communication-edge samplers",
        )
    )
    edges_p.add_argument(
        "--limit", type=int, default=16, help="pairs shown (heaviest first)"
    )

    trace_p = _common(
        sub.add_parser(
            "trace", help="assemble one request's cross-node waterfall"
        )
    )
    trace_p.add_argument(
        "trace_id", nargs="?", default="", help="128-bit hex trace id "
        "(empty = every retained trace; demo picks a redirect-follow)"
    )
    trace_p.add_argument(
        "--limit", type=int, default=256, help="spans scraped per node"
    )

    qos_p = _common(
        sub.add_parser(
            "qos",
            help="request-QoS scheduler state: queue depths, per-tenant "
            "RED rows, shed and deadline-drop counters",
        )
    )
    qos_p.add_argument(
        "--limit", type=int, default=64,
        help="per-(tenant, class) rows shown per node (busiest first)",
    )

    scale_p = _common(
        sub.add_parser(
            "scale",
            help="autoscale controller state: policy bands, cooldowns, "
            "recent decisions",
        )
    )
    scale_p.add_argument(
        "--limit", type=int, default=16, help="decision rows shown (newest)"
    )

    args = parser.parse_args(argv)
    args.subject = (
        (args.type_name, args.object_id)
        if args.cmd == "explain" and args.type_name and args.object_id
        else None
    )
    if not args.demo and not args.nodes:
        parser.error("--nodes is required without --demo")

    client, nodes, cleanup = await _cli_cluster(args)
    try:
        if args.cmd == "tail":
            snapshots = await scrape_events(
                client,
                nodes,
                kinds=args.kind or None,
                key=args.key or None,
                since_seq=args.since_seq,
                limit=args.limit,
            )
            events = merge_events(s.events() for s in snapshots)
            if args.json:
                print(json.dumps([_event_dict(e) for e in events]))
            else:
                for ev in events:
                    print(format_event(ev))
                print(f"[tail] {len(events)} events")
            return 0 if snapshots else 1
        if args.cmd == "explain":
            if not args.subject:
                print("explain: missing TYPE ID (demo picks its migrated actor)")
                return 2
            tname, oid = args.subject
            snapshots = await scrape_events(
                client, nodes, key=subject_key(tname, oid), limit=512
            )
            events = merge_events(s.events() for s in snapshots)
            traces = {e.trace_id for e in events if e.trace_id}
            if args.json:
                print(json.dumps({
                    "subject": subject_key(tname, oid),
                    "events": [_event_dict(e) for e in events],
                    "traces": sorted(traces),
                }))
            else:
                for ev in events:
                    print(format_event(ev))
                print(
                    f"[explain] {subject_key(tname, oid)}: {len(events)} events, "
                    f"{len(traces)} linked trace(s)"
                )
            return 0 if snapshots else 1
        if args.cmd == "stats":
            reached = 0
            out: dict[str, Any] = {}
            for address in await _node_addresses(nodes):
                try:
                    snap = await client.send(
                        ADMIN_TYPE, address, DumpStats(), returns=StatsSnapshot
                    )
                except Exception as e:
                    if not args.json:
                        print(f"{address}: unreachable ({e.__class__.__name__})")
                    continue
                reached += 1
                if args.json:
                    out[snap.address] = {
                        "gauges": snap.gauges,
                        "histograms": len(snap.histograms),
                    }
                    continue
                journal = {
                    k: v for k, v in snap.gauges.items() if k.startswith("rio.journal.")
                }
                print(
                    f"{snap.address}: {len(snap.gauges)} gauges, "
                    f"{len(snap.histograms)} histograms, journal="
                    + (
                        " ".join(f"{k.split('.')[-1]}={v:g}" for k, v in sorted(journal.items()))
                        or "off"
                    )
                )
            if args.json:
                print(json.dumps(out))
            return 0 if reached else 1
        if args.cmd == "edges":
            from .affinity import merge_edges

            snapshots = await scrape_edges(
                client, nodes, limit=max(args.limit * 4, 64)
            )
            merged = merge_edges([s.rows for s in snapshots])
            top = merged[: args.limit]
            total_bps = sum(r[2] for r in merged)
            local_bps = sum(r[2] * r[4] for r in merged)
            cross_bps = total_bps - local_bps
            if args.json:
                print(json.dumps({
                    "nodes": {
                        s.address: {
                            "sampled": s.sampled,
                            "evictions": s.evictions,
                            "cross_bytes_per_s": s.cross_bytes_per_s,
                        }
                        for s in snapshots
                    },
                    "edges": [
                        {
                            "src": r[0],
                            "dst": r[1],
                            "bytes_per_s": r[2],
                            "calls_per_s": r[3],
                            "local_frac": r[4],
                        }
                        for r in top
                    ],
                    "total_bytes_per_s": total_bps,
                    "local_bytes_per_s": local_bps,
                    "cross_bytes_per_s": cross_bps,
                }))
            else:
                header = (
                    f"{'src':<28} {'dst':<28} {'bytes/s':>12} "
                    f"{'calls/s':>10} {'local%':>7}"
                )
                print(header)
                print("-" * len(header))
                for r in top:
                    print(
                        f"{r[0]:<28} {r[1]:<28} {r[2]:>12.0f} "
                        f"{r[3]:>10.1f} {r[4] * 100:>6.1f}%"
                    )
                print(
                    f"[edges] {len(merged)} pair(s) from {len(snapshots)} "
                    f"node(s); bytes/s local={local_bps:.0f} "
                    f"cross={cross_bps:.0f}"
                )
            return 0 if snapshots else 1
        if args.cmd == "trace":
            from .spans import client_ring

            snapshots = await scrape_spans(
                client, nodes, trace_id=args.trace_id, limit=args.limit
            )
            records = [r for s in snapshots for r in s.spans()]
            ring = client_ring()
            if ring is not None:
                # Merge THIS process's client hops: the waterfall roots at
                # the caller when it armed retention before sending.
                records.extend(ring.spans(trace_id=args.trace_id or None))
            if args.trace_id:
                records = [r for r in records if r.trace_id == args.trace_id]
            ev_snaps = await scrape_events(client, nodes, limit=512)
            events = [
                e
                for e in merge_events(s.events() for s in ev_snaps)
                if e.trace_id
                and (not args.trace_id or e.trace_id == args.trace_id)
            ]
            trees = assemble_waterfall(records, events)
            if args.json:
                doc: dict[str, Any] = {}
                for tid, tree in trees.items():
                    flat: list[dict] = []

                    def _flatten(hop: dict, depth: int) -> None:
                        d = _span_dict(hop["record"])
                        d["depth"] = depth
                        flat.append(d)
                        for c in hop["children"]:
                            _flatten(c, depth + 1)

                    for root in tree["roots"]:
                        _flatten(root, 0)
                    doc[tid] = {
                        "hops": tree["hops"],
                        "spans": flat,
                        "events": [_event_dict(e) for e in tree["events"]],
                    }
                print(json.dumps(doc))
            else:
                for tid, tree in trees.items():
                    print(format_waterfall(tid, tree))
                print(f"[trace] {len(trees)} trace(s), {len(records)} span(s)")
            return 0 if (snapshots or records) else 1
        if args.cmd == "qos":
            snapshots = await scrape_qos(client, nodes, limit=args.limit)
            if args.json:
                print(json.dumps({
                    s.address: {
                        "enabled": s.enabled,
                        "running": s.running,
                        "queued": s.queued,
                        "admitted": s.admitted,
                        "sheds": s.sheds,
                        "deadline_drops": s.deadline_drops,
                        "interactive_admitted": s.interactive_admitted,
                        "interactive_sheds": s.interactive_sheds,
                        "queue_depths": s.queue_depths,
                        "tenants": [
                            {
                                "tenant": r[0],
                                "class": r[1],
                                "requests": r[2],
                                "errors": r[3],
                                "avg_ms": r[4],
                                "avg_queue_ms": r[5],
                                "sheds": r[6],
                                "deadline_drops": r[7],
                            }
                            for r in s.tenants
                        ],
                    }
                    for s in sorted(snapshots, key=lambda s: s.address)
                }))
                return 0 if snapshots else 1
            header = (
                f"{'tenant':<14} {'class':<6} {'reqs':>7} {'errs':>6} "
                f"{'avg_ms':>8} {'queue_ms':>9} {'sheds':>6} {'ddrops':>7}"
            )
            for snap in sorted(snapshots, key=lambda s: s.address):
                if not snap.enabled:
                    print(f"{snap.address}: qos off")
                    continue
                depths = (
                    " ".join(f"{k}={v}" for k, v in sorted(snap.queue_depths.items()))
                    or "-"
                )
                print(
                    f"{snap.address}: admitted={snap.admitted} "
                    f"sheds={snap.sheds} deadline_drops={snap.deadline_drops} "
                    f"running={snap.running} queued={snap.queued} [{depths}]"
                )
                if snap.tenants:
                    print(header)
                    print("-" * len(header))
                    for r in snap.tenants:
                        print(
                            f"{(r[0] or 'default'):<14} {r[1]:<6} {r[2]:>7} "
                            f"{r[3]:>6} {r[4]:>8.2f} {r[5]:>9.2f} "
                            f"{r[6]:>6} {r[7]:>7}"
                        )
            print(f"[qos] {len(snapshots)} node(s)")
            return 0 if snapshots else 1
        if args.cmd == "scale":
            from .autoscale import (
                AUTOSCALE_ID,
                AUTOSCALE_TYPE,
                ScaleSnapshot,
                ScaleStatus,
            )

            try:
                snap = await client.send(
                    AUTOSCALE_TYPE,
                    AUTOSCALE_ID,
                    ScaleStatus(limit=args.limit),
                    returns=ScaleSnapshot,
                )
            except Exception as e:
                print(f"scale: controller unreachable ({e.__class__.__name__})")
                return 1
            if not snap.address:
                # The singleton answered from a node with autoscaling off —
                # no runtime means no policy state worth rendering.
                print("scale: no autoscale runtime on the controller's node")
                return 1
            if args.json:
                print(json.dumps({
                    "controller": snap.address,
                    "pressure": snap.pressure,
                    "nodes": snap.nodes,
                    "over_streak": snap.over_streak,
                    "under_streak": snap.under_streak,
                    "cooldown_s": snap.cooldown_s,
                    "pending": snap.pending,
                    "scale_outs": snap.scale_outs,
                    "scale_ins": snap.scale_ins,
                    "ticks": snap.ticks,
                    "alerts": snap.alerts,
                    "policy": snap.policy,
                    "decisions": [
                        {
                            "wall_ts": d[0],
                            "action": d[1],
                            "node": d[2],
                            "rule": d[3],
                            "pressure": d[4],
                            "nodes": d[5],
                            "detail": d[6],
                        }
                        for d in snap.decisions
                    ],
                }))
                return 0
            pol = snap.policy
            print(
                f"controller {snap.address}: pressure={snap.pressure:.2f} "
                f"nodes={snap.nodes} over={snap.over_streak} "
                f"under={snap.under_streak} ticks={snap.ticks}"
            )
            print(
                f"policy: band=[{pol.get('low_pressure', 0):g}, "
                f"{pol.get('high_pressure', 0):g}] "
                f"sustain={pol.get('sustain', 0):g} "
                f"nodes=[{pol.get('min_nodes', 0):g}, "
                f"{pol.get('max_nodes', 0):g}] "
                f"cooldowns out/in={pol.get('out_cooldown_s', 0):g}/"
                f"{pol.get('in_cooldown_s', 0):g}s "
                f"drain_timeout={pol.get('drain_timeout_s', 0):g}s"
            )
            print(
                f"now: cooldown={snap.cooldown_s:.1f}s "
                f"pending={snap.pending or '-'} "
                f"alerts={','.join(snap.alerts) or '-'} "
                f"outs={snap.scale_outs} ins={snap.scale_ins}"
            )
            if snap.decisions:
                print("decisions (newest last):")
                for d in snap.decisions:
                    ts = time.strftime(
                        "%H:%M:%S", time.localtime(float(d[0]))
                    )
                    print(
                        f"  {ts} {d[1]:<10} {d[2]:<22} rule={d[3]} "
                        f"pressure={d[4]:.2f} nodes={d[5]}"
                        + (f" ({d[6]})" if d[6] else "")
                    )
            print(
                f"[scale] controller={snap.address} "
                f"{len(snap.decisions)} decision(s)"
            )
            return 0
        # watch: the trend table (one shot with --once/--json, else looped).
        while True:
            snapshots = await scrape_series(client, nodes, limit=args.window)
            rows = _watch_rows(snapshots)
            if args.json:
                print(json.dumps(rows))
            else:
                print(_format_watch(rows))
            if args.once or args.json or not snapshots:
                return 0 if snapshots else 1
            await asyncio.sleep(max(0.1, args.interval))
            print()
    finally:
        await cleanup()


if __name__ == "__main__":  # pragma: no cover - exercised via CLI smoke test
    import asyncio as _asyncio
    import sys as _sys

    _sys.exit(_asyncio.run(_cli_main()))
