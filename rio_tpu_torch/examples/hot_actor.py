"""hot_actor: scale a celebrity actor's reads across its replicas.

A virtual actor executes serially — one object, one queue — so a single
hot key tops out at ``1/handler_time`` requests per second no matter how
many nodes the cluster has. This example turns the replication standbys
into bounded-staleness read replicas and walks the whole read-scale path:

1. **`@readonly` serving** — a standby answers marked read messages from
   its shipped replica while the replica is inside the staleness bound
   (`max_staleness_s` / `max_lag_seq`); outside the bound it transparently
   proxies to the primary — never an error, never a stale answer beyond
   the contract.
2. **Shed + divert** — when the primary is overloaded it refuses marked
   reads with a ``SERVER_BUSY`` that *names the standby seats*; the client
   caches the hint and fans reads across the seats with no backoff.
3. **Dynamic replication factor** — the hotness detector watches the
   per-object request-rate EMAs and raises the celebrity's replica count
   toward ``k_max`` while it is hot, then decays it one seat at a time
   (with hysteresis) as it cools — every transition through the normal
   epoch-preserving seat path.

Runs a 3-node cluster in one process::

    python -m rio_tpu_torch.examples.hot_actor
"""

import asyncio


from rio_tpu_torch import (
    AppData,
    Client,
    LocalStorage,
    ReadScaleConfig,
    Registry,
    Server,
    ServiceObject,
    handler,
    message,
    readonly,
)
from rio_tpu_torch.cluster.membership_protocol import LocalClusterProvider
from rio_tpu_torch.commands import ServerInfo
from rio_tpu_torch.load import LoadThresholds
from rio_tpu_torch.object_placement import LocalObjectPlacement, ObjectId
from rio_tpu_torch.replication import ReplicationConfig


@message
class Post:
    text: str = ""


@message
class ReadTimeline:
    pass


@message
class Timeline:
    posts: int = 0
    served_by: str = ""


class Celebrity(ServiceObject):
    __replicated__ = True  # standbys double as read replicas

    def __init__(self):
        self.posts = 0

    def __migrate_state__(self):
        return {"posts": self.posts}

    def __restore_state__(self, value):
        self.posts = int(value["posts"])

    @handler
    async def post(self, msg: Post, ctx: AppData) -> Timeline:
        self.posts += 1
        return Timeline(posts=self.posts, served_by=ctx.get(ServerInfo).address)

    @readonly
    @handler
    async def timeline(self, msg: ReadTimeline, ctx: AppData) -> Timeline:
        return Timeline(posts=self.posts, served_by=ctx.get(ServerInfo).address)


def build_registry() -> Registry:
    return Registry().add_type(Celebrity)


async def main() -> None:
    members = LocalStorage()
    placement = LocalObjectPlacement()

    read_cfg = ReadScaleConfig(
        max_staleness_s=2.0,  # replica age bound for serving reads
        max_lag_seq=2,        # acked-sequence lag bound
        k_min=1,
        k_max=2,              # 3 nodes: primary + up to 2 read replicas
        hot_rate=50.0,        # req/s that earns each extra replica
    )
    servers, tasks = [], []
    for _ in range(3):
        server = Server(
            address="127.0.0.1:0",
            registry=build_registry(),
            cluster_provider=LocalClusterProvider(members),
            object_placement_provider=placement,
            replication_config=ReplicationConfig(
                k=1, anti_entropy_interval=0.3
            ),
            read_scale_config=read_cfg,
        )
        await server.prepare()
        await server.bind()
        servers.append(server)
        tasks.append(asyncio.create_task(server.run()))
    while len(await members.active_members()) < 3:
        await asyncio.sleep(0.05)

    client = Client(members, read_scale=read_cfg)
    try:
        # One write activates the actor, seats its standby, and ships the
        # first replica before the ack (ship-on-ack).
        tl = await client.send(Celebrity, "star", Post(text="hi"), returns=Timeline)
        primary = tl.served_by
        held, epoch = await placement.standbys(ObjectId("Celebrity", "star"))
        print(f"primary {primary}; standby seats {held} (epoch {epoch})")

        # 1) A standby serves the read from its replica — ask it directly
        # by making the primary shed: drop its admission ceiling so every
        # readonly request is refused with a seat hint.
        primary_srv = next(s for s in servers if s.local_address == primary)
        primary_srv.load_monitor.thresholds = LoadThresholds(max_inflight=-1)

        served_by: dict[str, int] = {}
        for _ in range(40):
            tl = await client.send(
                Celebrity, "star", ReadTimeline(), returns=Timeline
            )
            assert tl.posts == 1  # inside the staleness bound, never behind
            served_by[tl.served_by] = served_by.get(tl.served_by, 0) + 1
        print(f"hot primary: 40 reads served by {served_by}")
        mgr = next(
            s.read_scale_manager for s in servers if s.local_address == held[0]
        )
        print(
            f"standby counters: reads={mgr.stats.standby_reads} "
            f"forwards={mgr.stats.standby_forwards}"
        )

        # Writes are never diverted: the primary still owns them.
        primary_srv.load_monitor.thresholds = LoadThresholds()
        tl = await client.send(Celebrity, "star", Post(text="again"), returns=Timeline)
        assert tl.served_by == primary and tl.posts == 2

        # 2) Dynamic k: feed the detector a hot rate and watch the replica
        # count climb to k_max — then decay as the key cools. (In
        # production the LoadMonitor tick feeds real per-object EMAs.)
        rs = primary_srv.read_scale_manager
        await rs.hotness_tick({"Celebrity.star": 150.0})
        held, epoch2 = await placement.standbys(ObjectId("Celebrity", "star"))
        print(f"hot: replica_k -> {len(held)} seats {held} (epoch {epoch2})")
        assert len(held) == 2 and epoch2 == epoch  # fence never moved

        await rs.hotness_tick({"Celebrity.star": 5.0})
        held, _ = await placement.standbys(ObjectId("Celebrity", "star"))
        print(f"cooled: replica_k -> {len(held)} seats {held}")
    finally:
        client.close()
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)


if __name__ == "__main__":
    asyncio.run(main())
