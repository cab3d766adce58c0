"""Measured payoff of communication-aware placement on a live cluster.

The affinity subsystem (``rio_tpu_torch/affinity`` + the graph term in
:class:`~rio_tpu_torch.object_placement.torch_placement.TorchObjectPlacement`)
promises one operational headline: feeding the sampled edge graph back
into the solver moves chatty actor pairs onto the same node, so the bytes
those pairs used to push over TCP disappear from the sockets. This module
*measures* that claim end to end — no simulation, every byte counted
crossed a real loopback socket:

* **multi-hop workload** — a producer actor publishes padded records into
  a durable stream; one cursor per partition delivers to one consumer per
  partition. The placement directory is pre-seated ADVERSARIALLY before
  the first request: every cursor on node 0, every consumer on node 1, so
  each delivery is a cross-node hop (the cursor's local-first send
  redirects and falls back to the cluster client).
* **blind phase** — traffic runs with the placement exactly as seated;
  the per-server ``EdgeSampler`` TCP byte counters (fed by both
  transports) price the phase.
* **feedback** — the per-node edge graphs are scraped OVER THE WIRE with
  the admin ``DumpEdges`` command, merged cluster-wide
  (:func:`rio_tpu_torch.admin.cluster_edges`), installed via
  ``set_edge_graph``, and a full re-solve runs. The alternating
  linearized-OT refine co-locates each cursor with its consumer.
* **affinity phase** — identical traffic again; deliveries now resolve
  local-first in-process. The bytes-over-TCP ratio (blind / affinity) is
  the headline; the acceptance bar is >= 2x.

The waterfall proof rides along: servers boot with an aggressive span
tail SLO, so strided delivery requests are retained by the span rings.
In the blind phase the consumer-side delivery hops show up as wire
``request`` spans; in the affinity phase the same logical hops run
through the in-server dispatch queue and VANISH from the wire span
rings — the "formerly cross-node hop now served process-locally"
evidence, counted per phase.

``measure_sampler_overhead`` prices the other acceptance bar: the
dispatch-path cost of the sampler itself (`affinity_sampler` off vs on),
with the ``series_live`` discipline — coexisting clusters, interleaved
gc-disabled batches, MEDIAN of per-batch paired ratios.
"""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import time

from .. import (
    AppData,
    Client,
    LocalReminderStorage,
    LocalStorage,
    ObjectId,
    ObjectPlacementItem,
    ReminderDaemonConfig,
    ReminderStorage,
    Registry,
    Server,
    ServiceObject,
    handler,
    message,
)
from ..cluster.membership_protocol import LocalClusterProvider
from ..object_placement.torch_placement import TorchObjectPlacement
from ..registry import type_id
from ..reminders.daemon import SHARD_TYPE as REMINDER_SHARD_TYPE
from ..state import LocalState, StateProvider
from ..streams import LocalStreamStorage, StreamStorage, partition_for
from ..streams.cursor import CURSOR_TYPE, cursor_id, publish
from .routing_live import Echo, EchoActor, boot_echo_cluster

STREAM = "affinity-orders"
GROUP = "affinity-sink"


@message(name="affinity_live.Fill")
class Fill:
    """One padded stream record — the payload whose bytes the A/B counts."""

    value: int = 0
    pad: bytes = b""


@message(name="affinity_live.Produce")
class Produce:
    """Trigger: publish ``n`` records in-server (client sends ONE small
    frame; the append path is in-process, so delivery hops dominate the
    measured TCP traffic)."""

    n: int = 0
    pad_bytes: int = 0
    keys: list = dataclasses.field(default_factory=list)


class ProducerActor(ServiceObject):
    """In-cluster record source: publishes through the ctx-based producer
    API, so the publish leg never touches TCP and the wake → cursor →
    consumer chain is the traffic under test."""

    @handler
    async def produce(self, msg: Produce, ctx: AppData) -> Echo:
        pad = b"\x00" * msg.pad_bytes
        for i in range(msg.n):
            await publish(
                ctx, STREAM, Fill(value=i, pad=pad), key=msg.keys[i % len(msg.keys)]
            )
        return Echo(value=msg.n)


def _build_registry() -> Registry:
    return Registry().add_type(EchoActor).add_type(ProducerActor)


def _partition_keys(stream: str, n_partitions: int) -> list[str]:
    """One key per partition (crc32 search), so the workload is exactly
    ``n_partitions`` disjoint cursor→consumer pairs — the cleanest
    possible co-location target for the refine."""
    found: dict[int, str] = {}
    i = 0
    while len(found) < n_partitions:
        key = f"k{i}"
        found.setdefault(partition_for(stream, key, n_partitions), key)
        i += 1
    return [found[p] for p in range(n_partitions)]


async def measure_affinity_payoff(
    *,
    n_records: int = 256,
    pad_bytes: int = 4096,
    redelivery_period: float = 0.25,
    transport: str = "asyncio",
    affinity_weight: float = 2.0,
    affinity_host_factor: float = 0.05,
    drain_timeout: float = 60.0,
    device=None,
) -> dict:
    """Blind vs affinity-fed placement on identical multi-hop traffic.

    Returns the per-phase TCP byte deltas, their ratio (the >= 2x
    acceptance headline), the per-phase count of consumer-side delivery
    spans on the wire rings (the waterfall proof: the cross-node hop
    disappears), the merged-edge/move counts of the feedback step, and
    the refine's per-pass history. Raises ``RuntimeError`` on delivery
    loss — the byte win must never come from dropped records.

    The provider runs on ``device``: CUDA unless the caller asks for the
    CPU.
    """
    # Both "nodes" share this host, but the loopback sockets between them
    # still carry every byte the A/B counts — so the same-host discount is
    # nearly zeroed here (the shipping 0.5 default is for real multi-host
    # topologies where same-host means shared memory, not TCP). With the
    # heaviest edge normalized to 1.0, the attraction differential must
    # clear the stay-put move_cost (0.5) for a pair to co-locate at all:
    # at host_factor 0.5 the differential TIES it and the refine strands
    # most pairs; at 0.05 it is ~2x with affinity_weight 2.0 giving margin.
    placement = TorchObjectPlacement(
        node_axis_size=4,
        mode="greedy",
        affinity_weight=affinity_weight,
        affinity_host_factor=affinity_host_factor,
        device=device,
    )
    storage = LocalStreamStorage()
    state = LocalState()
    members = LocalStorage()
    reminders = LocalReminderStorage()
    servers: list[Server] = []
    tasks: list[asyncio.Task] = []
    client: Client | None = None
    try:
        for _ in range(2):
            ad = AppData().set(storage, as_type=StreamStorage)
            ad.set(state, as_type=StateProvider)
            ad.set(reminders, as_type=ReminderStorage)
            s = Server(
                address="127.0.0.1:0",
                registry=_build_registry(),
                cluster_provider=LocalClusterProvider(members),
                object_placement_provider=placement,
                transport=transport,
                app_data=ad,
                reminder_daemon=True,
                reminder_daemon_config=ReminderDaemonConfig(
                    poll_interval=0.05, lease_ttl=2.0
                ),
                # Full-fidelity edge capture: the shipping 1-in-8 stride
                # needs thousands of dispatches per edge to stabilize; a
                # short A/B phase leaves most pairs unsampled and the
                # refine can only co-locate edges it can see. Overhead is
                # measure_sampler_overhead's problem, not this harness's.
                affinity_stride=1,
                # Tail-capture everything the span stride clocks: delivery
                # requests are fast, and only an aggressive SLO keeps the
                # wire hops visible on the rings for the waterfall proof.
                spans_slo_ms=0.001,
            )
            await s.prepare()
            await s.bind()
            servers.append(s)
        tasks = [asyncio.create_task(s.run()) for s in servers]
        deadline = asyncio.get_event_loop().time() + 10.0
        while asyncio.get_event_loop().time() < deadline:
            if len(await members.active_members()) >= 2:
                break
            await asyncio.sleep(0.02)
        client = Client(members, transport=transport)

        n_parts = storage.num_partitions
        keys = _partition_keys(STREAM, n_parts)
        node0, node1 = servers[0].local_address, servers[1].local_address
        for addr in (node0, node1):
            placement.register_node(addr)

        # Adversarial pre-seat BEFORE any traffic (activation follows the
        # directory): every cursor on node 0, every consumer on node 1 —
        # a balanced seating a load-only solver has no reason to change,
        # and the worst one for bytes-over-TCP.
        echo_t, prod_t = type_id(EchoActor), type_id(ProducerActor)
        await placement.update(ObjectPlacementItem(ObjectId(prod_t, "prod"), node0))
        for p in range(n_parts):
            await placement.update(
                ObjectPlacementItem(
                    ObjectId(CURSOR_TYPE, cursor_id(STREAM, GROUP, p)), node0
                )
            )
        for key in keys:
            await placement.update(ObjectPlacementItem(ObjectId(echo_t, key), node1))
        # Seat the reminder shards evenly too. The daemons auto-place all
        # of them on whichever node looks them up first, which skews the
        # directory so hard that a plain LOAD re-solve evicts the cursors
        # off node 0 — and with only two nodes, any eviction lands them
        # beside their consumers "for free". Balancing the bystanders
        # keeps the blind seating load-optimal, so the greedy keep-phase
        # is a no-op and only the affinity refine can justify the moves:
        # the measured byte drop is attributable to the edge graph, not
        # to load-balancing luck.
        for i in range(reminders.num_shards):
            await placement.update(
                ObjectPlacementItem(
                    ObjectId(REMINDER_SHARD_TYPE, str(i)),
                    node0 if i % 2 == 0 else node1,
                )
            )
        await client.subscribe_stream(
            STREAM, GROUP, EchoActor, redelivery_period=redelivery_period
        )

        published = 0

        async def produce_and_drain(n: int) -> None:
            nonlocal published
            await client.send(
                ProducerActor,
                "prod",
                Produce(n=n, pad_bytes=pad_bytes, keys=keys),
                returns=Echo,
            )
            published += n
            deadline = time.monotonic() + drain_timeout
            while sum((await storage.cursors(STREAM, GROUP)).values()) < published:
                if time.monotonic() > deadline:
                    done = sum((await storage.cursors(STREAM, GROUP)).values())
                    raise RuntimeError(
                        f"delivery stalled: {done}/{published} committed"
                    )
                await asyncio.sleep(0.005)

        def tcp_total() -> int:
            return sum(
                s.affinity.tcp_in_bytes + s.affinity.tcp_out_bytes for s in servers
            )

        from ..admin import cluster_edges, scrape_spans

        async def span_marks() -> dict[str, int]:
            snaps = await scrape_spans(client, members, limit=1)
            return {s.address: s.node_seq for s in snaps}

        delivery_prefix = f"{echo_t}/"

        async def delivery_spans_since(marks: dict[str, int]) -> int:
            """Wire ``request`` spans for consumer-side delivery hops
            retained after ``marks`` — each one is a delivery that
            crossed TCP (local-first in-process sends never hit the
            transport span path)."""
            snaps = await scrape_spans(client, members, limit=4096)
            count = 0
            for snap in snaps:
                base = marks.get(snap.address, 0)
                for rec in snap.spans():
                    if rec.seq <= base or rec.name != "request":
                        continue
                    if str(rec.attrs.get("handler", "")).startswith(delivery_prefix):
                        count += 1
            return count

        # Warm phase: activate the whole chain (and the span stride) so
        # neither measured phase pays first-touch costs.
        await produce_and_drain(max(16, n_records // 8))

        # -- blind phase --------------------------------------------------
        marks = await span_marks()
        t0 = tcp_total()
        await produce_and_drain(n_records)
        blind_bytes = tcp_total() - t0
        blind_spans = await delivery_spans_since(marks)

        # -- feedback: scrape (over the wire) → merge → solve -------------
        rows = await cluster_edges(client, members)
        installed = placement.set_edge_graph(rows)
        moves = await placement.rebalance(delta=False)
        # Capture the refine trajectory NOW: later daemon full solves
        # re-run the refine against the already-co-located directory
        # (cut 0 at pass 0, nothing to accept) and overwrite it.
        refine_history = list(placement._affinity_history)
        # `stats` races with concurrent daemon-driven solves two ways: a
        # sibling attempt discarded by OUR epoch bump records itself as
        # the latest event, and a sibling that snapshotted `prior` before
        # our solve published drops our entry from the archive entirely.
        # Scan the archive first, then fall back to the refine history —
        # an accepted pass > 0 is the refine hook's own record that this
        # feedback cycle's solve took the affinity term.
        solved_as = placement.stats.mode
        if "+affinity" not in str(solved_as):
            for s in reversed(placement.stats.history):
                if "+affinity" in str(s.mode):
                    solved_as = s.mode
                    break
        if "+affinity" not in str(solved_as) and any(
            h["accepted"] and h["pass"] > 0 for h in refine_history
        ):
            solved_as = f"{solved_as}+affinity"

        # Settle: let cursors re-pump once against the new directory so
        # the affinity phase measures steady state, not the cutover.
        await produce_and_drain(max(16, n_records // 8))

        # -- affinity phase -----------------------------------------------
        marks = await span_marks()
        t0 = tcp_total()
        await produce_and_drain(n_records)
        affinity_bytes = tcp_total() - t0
        affinity_spans = await delivery_spans_since(marks)

        done = sum((await storage.cursors(STREAM, GROUP)).values())
        if done != published:
            raise RuntimeError(f"record loss: {done}/{published} committed")

        pairs_local = 0
        for p, key in enumerate(keys):
            c = await placement.lookup(
                ObjectId(CURSOR_TYPE, cursor_id(STREAM, GROUP, p))
            )
            e = await placement.lookup(ObjectId(echo_t, key))
            pairs_local += int(c == e)
        return {
            "n_records": n_records,
            "pad_bytes": pad_bytes,
            "partitions": n_parts,
            "edges_scraped": len(rows),
            "edges_installed": installed,
            "moves": moves,
            "solved_as": solved_as,
            "pairs_colocated": pairs_local,
            "tcp_bytes": {"blind": blind_bytes, "affinity": affinity_bytes},
            "bytes_ratio": round(blind_bytes / max(affinity_bytes, 1), 2),
            "delivery_wire_spans": {
                "blind": blind_spans,
                "affinity": affinity_spans,
            },
            "refine_history": refine_history,
            "delivered": published,
        }
    finally:
        if client is not None:
            client.close()
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)


async def measure_sampler_overhead(
    *,
    n_servers: int = 2,
    n_workers: int = 32,
    requests_per_batch: int = 128,
    n_objects: int = 256,
    cycles: int = 16,
    transport: str = "asyncio",
) -> dict:
    """A/B the RPC loop with the edge sampler off vs on (stride 8).

    Batches are deliberately longer than the other ``*_live`` overhead
    A/Bs (4096 requests each): per-batch paired ratios on this workload
    swing far wider than the effect under test, and the median only
    resolves a percent-level overhead once each batch spans a few
    hundred milliseconds of box weather. Two symmetries cancel the two
    biases this harness actually exhibited:

    * **measurement order** — each cycle runs off→on→on→off and averages
      the two ratios (ABBA), so within-pair speed drift cancels;
    * **boot order** — the whole measurement runs twice, once with the
      off cluster booted first and once with the on cluster booted
      first, and the per-order medians are averaged. The SECOND-booted
      pair of servers on a shared loop is consistently a few percent
      slower (an off-vs-off control under ABBA read +4.5% on a quiet
      box — pure boot-order artifact), which a fixed boot order aliases
      straight into the "overhead".

    Returns best-of msgs/sec per mode plus ``sampler_overhead_pct``
    (positive = sampler slower) and the on-clusters' sample counters —
    asserted > 0 so the priced clusters actually observed edges, with
    the off clusters asserted sampler-free.
    """
    import statistics

    rates: dict[str, list[float]] = {"off": [], "on": []}
    sampled_total = 0
    edges_total = 0
    order_medians: list[float] = []
    for boot_order in (("off", "on"), ("on", "off")):
        clusters: dict[str, tuple] = {}  # name -> (client, tasks, servers)
        try:
            for name in boot_order:
                members, placement, tasks, servers = await boot_echo_cluster(
                    n_servers,
                    transport=transport,
                    server_kwargs={"affinity_sampler": name == "on"},
                )
                tname = type_id(EchoActor)
                for i in range(n_objects):
                    await placement.update(
                        ObjectPlacementItem(
                            ObjectId(tname, f"w{i}"),
                            servers[i % n_servers].local_address,
                        )
                    )
                client = Client(members, transport=transport)
                clusters[name] = (client, tasks, servers)
                for i in range(n_objects):
                    await client.send(
                        EchoActor, f"w{i}", Echo(value=i), returns=Echo
                    )

            async def batch(name: str) -> float:
                client = clusters[name][0]
                total = n_workers * requests_per_batch

                async def worker(w: int) -> None:
                    for r in range(requests_per_batch):
                        oid = f"w{(w * requests_per_batch + r) % n_objects}"
                        await client.send(
                            EchoActor, oid, Echo(value=r), returns=Echo
                        )

                gc.collect()
                gc.disable()
                try:
                    t0 = time.perf_counter()
                    await asyncio.gather(*[worker(w) for w in range(n_workers)])
                    elapsed = time.perf_counter() - t0
                finally:
                    gc.enable()
                return total / elapsed

            for name in clusters:  # discarded warm batch per mode
                await batch(name)
            ratios: list[float] = []
            for _ in range(max(1, cycles // 2)):
                off_a = await batch("off")
                on_a = await batch("on")
                on_b = await batch("on")
                off_b = await batch("off")
                rates["off"] += [off_a, off_b]
                rates["on"] += [on_a, on_b]
                ratios.append((off_a / on_a + off_b / on_b) / 2.0 - 1.0)
            order_medians.append(statistics.median(ratios))

            on_servers = clusters["on"][2]
            sampled = sum(s.affinity.sampled for s in on_servers)
            assert sampled > 0, "on-cluster sampler observed nothing"
            sampled_total += sampled
            edges_total += sum(len(s.affinity._edges) for s in on_servers)
            for s in clusters["off"][2]:
                assert s.affinity is None, "off-cluster is not a real control"
        finally:
            for client, tasks, _servers in clusters.values():
                client.close()
                for t in tasks:
                    t.cancel()
            for _client, tasks, _servers in clusters.values():
                await asyncio.gather(*tasks, return_exceptions=True)

    overhead = sum(order_medians) / len(order_medians)
    return {
        "msgs_per_sec": {m: round(max(rates[m]), 1) for m in rates},
        "sampler_overhead_pct": round(overhead * 100.0, 2),
        "overhead_pct_by_boot_order": [
            round(m * 100.0, 2) for m in order_medians
        ],
        "sampled_on": sampled_total,
        "edges_on": edges_total,
        "batches": max(1, cycles // 2) * 4 * 2,
        "n_requests_per_batch": n_workers * requests_per_batch,
    }
