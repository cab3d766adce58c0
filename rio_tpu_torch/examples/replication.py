"""replication: kill the primary, the promoted standby keeps every write.

A migration is a *planned* handoff — source and target cooperate. This
example shows the unplanned case: the node holding a replicated actor dies
hard (no shutdown lifecycle, nothing flushed), and the actor's hot standby
takes over with every acknowledged write intact — including the volatile
``streak`` that only ever lived in the dead node's memory.

Three mechanisms, visible in order:

1. **Anti-affinity seats** — the directory stores ``k`` standby rows per
   replicated actor next to the primary row; the solver (or the hashed
   fallback) never co-locates a standby with its primary.
2. **Ship-on-ack** — after each handled request, before the response goes
   out, the primary ships the actor's ``__migrate_state__`` snapshot to
   every standby's ``MigrationInbox`` (byte-identical snapshots skipped).
3. **Epoch-fenced promotion** — on the first request after the death, a
   survivor promotes the standby through a directory CAS that bumps the
   row's epoch; the deposed primary's stale ships bounce off the fence.

Runs a 3-node cluster in one process::

    python -m rio_tpu_torch.examples.replication
"""

import asyncio


from rio_tpu_torch import (
    AdminCommand,
    AppData,
    Client,
    LocalStorage,
    Registry,
    Server,
    ServiceObject,
    handler,
    message,
)
from rio_tpu_torch.cluster.membership_protocol import LocalClusterProvider
from rio_tpu_torch.object_placement import LocalObjectPlacement, ObjectId
from rio_tpu_torch.replication import ReplicationConfig
from rio_tpu_torch.state import LocalState, StateProvider, managed_state


@message
class Visit:
    pass


@message
class Report:
    total: int = 0      # persisted (managed state)
    streak: int = 0     # volatile: survives ONLY through the replica
    server: str = ""


@message
class VisitsState:
    total: int = 0


class Visits(ServiceObject):
    __replicated__ = True  # opt in: seats + ship-on-ack + failover

    state = managed_state(VisitsState)

    def __init__(self):
        self.streak = 0

    def __migrate_state__(self):
        return {"streak": self.streak}

    def __restore_state__(self, value):
        self.streak = int(value["streak"])

    @handler
    async def visit(self, msg: Visit, ctx: AppData) -> Report:
        from rio_tpu_torch.commands import ServerInfo

        self.state.total += 1
        self.streak += 1
        await self.save_state(ctx)
        return Report(
            total=self.state.total,
            streak=self.streak,
            server=ctx.get(ServerInfo).address,
        )


def build_registry() -> Registry:
    return Registry().add_type(Visits)


async def main() -> None:
    members = LocalStorage()
    placement = LocalObjectPlacement()
    state = LocalState()

    servers = []
    tasks = []
    for _ in range(3):
        server = Server(
            address="127.0.0.1:0",
            registry=build_registry(),
            cluster_provider=LocalClusterProvider(members),
            object_placement_provider=placement,
            app_data=AppData().set(state, as_type=StateProvider),
            replication_config=ReplicationConfig(
                k=1,                       # hot standbys per actor
                ship_on_ack=True,          # delta ships before each ack
                anti_entropy_interval=0.5, # repair loop period (seconds)
            ),
        )
        await server.prepare()
        await server.bind()
        servers.append(server)
        tasks.append(asyncio.create_task(server.run()))
    while len(await members.active_members()) < 3:
        await asyncio.sleep(0.05)

    client = Client(members)
    try:
        for _ in range(5):
            report = await client.send(Visits, "alice", Visit(), returns=Report)
        print(
            f"primary {report.server}: total={report.total} "
            f"streak={report.streak}"
        )

        # The directory now holds an anti-affinity standby row with an
        # epoch fence, and the standby already has the latest delta.
        held, epoch = await placement.standbys(ObjectId("Visits", "alice"))
        assert held and report.server not in held
        print(f"standby seats {held} (epoch {epoch}) — never the primary")

        # Kill the primary HARD: no shutdown lifecycle, no flush. The
        # volatile streak now exists only in the shipped replica.
        primary = next(s for s in servers if s.local_address == report.server)
        primary.admin_sender().send(AdminCommand.server_exit())
        while await members.is_active(primary.local_address):
            await asyncio.sleep(0.02)
        print(f"killed {primary.local_address}")

        # First request after the death: a survivor promotes the standby
        # through the epoch CAS and the client's redirect lands there.
        report = await client.send(Visits, "alice", Visit(), returns=Report)
        print(
            f"failover -> {report.server}: total={report.total} "
            f"streak={report.streak}  (no acknowledged write lost)"
        )
        assert report.server == held[0]
        assert (report.total, report.streak) == (6, 6)
        _, epoch2 = await placement.standbys(ObjectId("Visits", "alice"))
        assert epoch2 == epoch + 1  # the fence moved exactly once

        for s in servers:
            mgr = s.replication_manager
            if s is primary or mgr is None:
                continue
            st = mgr.stats
            print(
                f"{s.local_address}: shipped={st.shipped} appends={st.appends} "
                f"promotions={st.promotions} restores={st.replica_restores}"
            )
    finally:
        client.close()
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)


if __name__ == "__main__":
    asyncio.run(main())
