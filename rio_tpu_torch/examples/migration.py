"""migration: a forced rebalance with state surviving the move.

A directory re-seat alone would strand the old node's in-memory activation
and lose everything not yet persisted. This example shows the coordinated
handoff behind every solver move: a stateful ``Visits`` actor — persisted
total via ``managed_state``, in-memory streak via ``__migrate_state__`` —
is seated on node A, loaded with traffic, then migrated twice:

1. **Admin command** (``AdminCommand.migrate``): the ops/debug entry to the
   handoff — pin, deactivate, snapshot, inline volatile transfer, directory
   flip, fence.
2. **Solver rebalance** (``TorchObjectPlacement.rebalance(move_sink=...)``):
   node A is cordoned (a drain, in miniature) and the OT re-solve's planned
   moves are actuated through the same :class:`MigrationManager` path the
   placement daemon uses.

After each move the next request activates the actor on its new node with
BOTH kinds of state intact — the streak counter proves the volatile
snapshot traveled, because a cold activation would reset it to zero.

The twin of ``examples/migration.py`` on the port's runtime, with
:class:`~rio_tpu_torch.object_placement.torch_placement.TorchObjectPlacement`
as the provider, on CUDA unless the caller asks for another device. Runs a
2-node cluster in one process::

    python -m rio_tpu_torch.examples.migration [DEVICE]

Nothing runs at import.
"""

import asyncio
import sys

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
from rio_tpu_torch.object_placement.torch_placement import TorchObjectPlacement
from rio_tpu_torch.state import LocalState, StateProvider, managed_state


@message
class Visit:
    pass


@message
class Report:
    total: int = 0      # persisted (managed state)
    streak: int = 0     # volatile (travels only via migration)
    server: str = ""


@message
class VisitsState:
    total: int = 0


class Visits(ServiceObject):
    state = managed_state(VisitsState)

    def __init__(self):
        self.streak = 0  # in-memory only: lost on a plain deactivation

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


async def main(device=None) -> None:
    members = LocalStorage()
    placement = TorchObjectPlacement(mode="greedy", move_cost=0.5, device=device)
    state = LocalState()

    servers = []
    tasks = []
    for _ in range(2):
        server = Server(
            address="127.0.0.1:0",
            registry=build_registry(),
            cluster_provider=LocalClusterProvider(members),
            object_placement_provider=placement,
            app_data=AppData().set(state, as_type=StateProvider),
        )
        await server.prepare()
        await server.bind()
        servers.append(server)
        tasks.append(asyncio.create_task(server.run()))
    while len(await members.active_members()) < 2:
        await asyncio.sleep(0.05)
    placement.sync_members(await members.members())

    client = Client(members)
    try:
        for _ in range(3):
            report = await client.send(Visits, "alice", Visit(), returns=Report)
        print(f"seated on {report.server}: total={report.total} streak={report.streak}")
        source = next(s for s in servers if s.local_address == report.server)
        target = next(s for s in servers if s.local_address != report.server)

        # --- Move 1: explicit admin command --------------------------------
        source.admin_sender().send(
            AdminCommand.migrate("Visits", "alice", target.local_address)
        )
        while not source.migration_manager.stats.completed:
            await asyncio.sleep(0.02)
        report = await client.send(Visits, "alice", Visit(), returns=Report)
        print(
            f"after admin migrate -> {report.server}: "
            f"total={report.total} streak={report.streak}  (nothing lost)"
        )
        assert report.server == target.local_address
        assert (report.total, report.streak) == (4, 4)

        # --- Move 2: the solver decides ------------------------------------
        # Cordon the current host and re-solve with the migration manager as
        # the move sink — exactly what the placement daemon does on churn,
        # and what a DRAIN_SERVER does before exiting.
        placement.cordon(target.local_address)
        moved = await placement.rebalance(
            move_sink=target.migration_manager.apply_moves
        )
        report = await client.send(Visits, "alice", Visit(), returns=Report)
        print(
            f"after cordon+rebalance ({moved} move) -> {report.server}: "
            f"total={report.total} streak={report.streak}"
        )
        assert report.server == source.local_address
        assert (report.total, report.streak) == (5, 5)

        stats = target.migration_manager.stats
        print(
            f"coordinator stats: started={stats.started} "
            f"completed={stats.completed} state_bytes={stats.state_bytes}"
        )
    finally:
        client.close()
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)


if __name__ == "__main__":
    asyncio.run(main(sys.argv[1] if len(sys.argv) > 1 else None))
