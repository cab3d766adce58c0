"""metric-aggregator: managed state + actor fan-out + a load generator.

Parity with the reference example (``rio-rs/examples/metric-aggregator``):
a ``MetricAggregator`` actor per metric name keeps running stats in a
``managed_state`` field (persisted via SQLite), fans each sample out to a
per-tag aggregator through the internal client, and a ``loadall`` client
sends 20k sequential requests (the reference's de-facto load benchmark,
``metric_aggregator_loadall.rs:26-37``).

Cross-process: every process (server or client) shares the cluster through
the same SQLite file — membership, placement, and state.

    python -m rio_tpu_torch.examples.metric_aggregator server --db ma.db --port 7701
    python -m rio_tpu_torch.examples.metric_aggregator server --db ma.db --port 7702
    python -m rio_tpu_torch.examples.metric_aggregator loadall --db ma.db -n 20000
    python -m rio_tpu_torch.examples.metric_aggregator show --db ma.db --name requests
"""

import argparse
import asyncio
import time


from rio_tpu_torch import (
    AppData,
    Client,
    Registry,
    Server,
    ServiceObject,
    handler,
    make_registry,
    message,
)
from rio_tpu_torch.cluster.membership_protocol.peer_to_peer import (
    PeerToPeerClusterConfig,
    PeerToPeerClusterProvider,
)
from rio_tpu_torch.cluster.storage.sqlite import SqliteMembershipStorage
from rio_tpu_torch.object_placement.sqlite import SqliteObjectPlacement
from rio_tpu_torch.state import StateProvider, managed_state
from rio_tpu_torch.state.sqlite import SqliteState


@message
class Metric:
    tag: str = ""
    value: float = 0.0


@message
class Stats:
    count: int = 0
    total: float = 0.0
    vmin: float = 0.0
    vmax: float = 0.0


@message
class GetStats:
    pass


class MetricAggregator(ServiceObject):
    """One per metric name; fans out to one per (name, tag)."""

    stats = managed_state(Stats)

    @handler
    async def record(self, msg: Metric, ctx: AppData) -> Stats:
        s = self.stats
        s.vmin = msg.value if s.count == 0 else min(s.vmin, msg.value)
        s.vmax = msg.value if s.count == 0 else max(s.vmax, msg.value)
        s.count += 1
        s.total += msg.value
        await self.save_state(ctx)
        # Fan out to the per-tag aggregator (reference services.rs:30-49).
        # The forwarded copy carries tag="" so the child never re-fans-out,
        # regardless of what characters the metric name contains.
        if msg.tag:
            await ServiceObject.send(
                ctx, MetricAggregator, f"{self.id}.{msg.tag}",
                Metric(tag="", value=msg.value), returns=Stats,
            )
        return s

    @handler
    async def get(self, msg: GetStats, ctx: AppData) -> Stats:
        return self.stats


# Declarative registry + typed client stubs — the reference builds this
# example with `make_registry!` (metric-aggregator/src/lib.rs); `decl.client`
# carries `metric_aggregator.send_metric/send_get_stats` typed wrappers.
decl = make_registry({
    MetricAggregator: [
        (Metric, Stats),
        (GetStats, Stats),
    ],
})


def build_registry() -> Registry:
    return decl.registry()


def sqlite_cluster(db: str):
    members = SqliteMembershipStorage(db)
    placement = SqliteObjectPlacement(db)
    state = SqliteState(db)
    return members, placement, state


async def run_server(db: str, port: int) -> None:
    members, placement, state = sqlite_cluster(db)
    await state.prepare()
    app_data = AppData()
    app_data.set(state, as_type=StateProvider)
    server = Server(
        address=f"0.0.0.0:{port}",
        registry=build_registry(),
        cluster_provider=PeerToPeerClusterProvider(
            members, PeerToPeerClusterConfig(interval_secs=2.0, num_failures_threshold=2,
                                             interval_secs_threshold=10.0)
        ),
        object_placement_provider=placement,
        app_data=app_data,
    )
    await server.prepare()
    addr = await server.bind()
    print(f"[server] metric-aggregator node on {addr}", flush=True)
    await server.run()


async def run_loadall(db: str, n: int, name: str) -> None:
    members, _, _ = sqlite_cluster(db)
    client = Client(members)
    send_metric = decl.client.metric_aggregator.send_metric
    t0 = time.perf_counter()
    for i in range(n):
        await send_metric(
            client, name, Metric(tag=f"tag{i % 10}", value=float(i % 100))
        )
    dt = time.perf_counter() - t0
    print(f"[loadall] {n} requests in {dt:.2f}s = {n / dt:.0f} req/s", flush=True)
    client.close()


async def run_show(db: str, name: str) -> None:
    members, _, _ = sqlite_cluster(db)
    client = Client(members)
    stats = await client.send(MetricAggregator, name, GetStats(), returns=Stats)
    print(f"[show] {name}: {stats}", flush=True)
    for tag in range(10):
        s = await client.send(MetricAggregator, f"{name}.tag{tag}", GetStats(), returns=Stats)
        print(f"[show] {name}.tag{tag}: count={s.count} total={s.total}", flush=True)
    client.close()


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("server")
    s.add_argument("--db", required=True)
    s.add_argument("--port", type=int, default=0)
    l = sub.add_parser("loadall")
    l.add_argument("--db", required=True)
    l.add_argument("-n", type=int, default=20000)
    l.add_argument("--name", default="requests")
    g = sub.add_parser("show")
    g.add_argument("--db", required=True)
    g.add_argument("--name", default="requests")
    args = p.parse_args()
    if args.cmd == "server":
        asyncio.run(run_server(args.db, args.port))
    elif args.cmd == "loadall":
        asyncio.run(run_loadall(args.db, args.n, args.name))
    else:
        asyncio.run(run_show(args.db, args.name))


if __name__ == "__main__":
    main()
