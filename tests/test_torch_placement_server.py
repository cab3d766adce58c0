"""A live cluster of unchanged rio_tpu Servers on TorchObjectPlacement(device="cpu").

Mirrors ``tests/test_placement_daemon.py``'s
``test_daemon_reseats_displaced_objects_without_app_solver_calls`` with the
port's provider: three servers serve durable counters, a node dies, the
``PlacementDaemon`` alone re-seats its objects on live nodes (moving about
the displaced share), and every write the client saw acknowledged is still
in the counter when the object answers again from a survivor.
"""

import asyncio

import pytest

pytest.importorskip("torch")

from rio_tpu import AppData  # noqa: E402
from rio_tpu.commands import AdminCommand  # noqa: E402
from rio_tpu.placement_daemon import PlacementDaemonConfig  # noqa: E402
from rio_tpu.state import LocalState, StateProvider  # noqa: E402
from rio_tpu.utils.autoscale_live import Add, Get, SoakCounter, Total, build_soak_registry  # noqa: E402

from rio_tpu_torch.object_placement.torch_placement import TorchObjectPlacement  # noqa: E402

from .server_utils import Cluster, run_integration_test  # noqa: E402

N_OBJECTS = 96
TYPE = SoakCounter.__name__


def test_daemon_reseats_a_dead_nodes_objects_on_the_torch_provider():
    placement = TorchObjectPlacement(move_cost=0.5, device="cpu")  # auto: greedy on the CPU
    state = LocalState()

    def make_app_data() -> AppData:
        ad = AppData()
        ad.set(state, as_type=StateProvider)
        return ad

    async def body(cluster: Cluster):
        client = cluster.client()
        try:
            acked: dict[str, int] = {}
            for _ in range(2):
                for i in range(N_OBJECTS):
                    out = await client.send(SoakCounter, f"o{i}", Add(n=1), returns=Total)
                    acked[f"o{i}"] = out.value
            assert set(acked.values()) == {2}
            assert placement.count() == N_OBJECTS
            assert placement._solver_mode() == "greedy"

            seated = {k: await cluster.allocation_address(TYPE, k) for k in acked}
            victim = max(cluster.addresses, key=lambda a: sum(v == a for v in seated.values()))
            displaced = [k for k, v in seated.items() if v == victim]
            assert displaced
            next(s for s in cluster.servers if s.local_address == victim).admin_sender().send(
                AdminCommand.server_exit()
            )

            daemons = [s.placement_daemon for s in cluster.servers if s.placement_daemon is not None]
            assert daemons
            loop = asyncio.get_event_loop()
            deadline = loop.time() + 15.0
            while not any(d.stats.rebalances > 0 for d in daemons):
                assert loop.time() < deadline, "daemon never rebalanced after node death"
                await asyncio.sleep(0.05)

            live = set(cluster.addresses) - {victim}
            deadline = loop.time() + 10.0
            while True:
                addrs = [await cluster.allocation_address(TYPE, k) for k in displaced]
                if all(a in live for a in addrs):
                    break
                assert loop.time() < deadline, "displaced objects still point at the dead node"
                await asyncio.sleep(0.05)

            moved = sum(d.stats.moves for d in daemons)
            assert len(displaced) <= moved <= len(displaced) + N_OBJECTS // 4
            assert placement.stats.mode.startswith("greedy")

            # Served from live nodes, and no acknowledged write was lost.
            for k in acked:
                out = await client.send(SoakCounter, k, Get(), returns=Total)
                assert out.address in live
                assert out.value == acked[k], (k, out.value, acked[k])
        finally:
            client.close()

    asyncio.run(
        run_integration_test(
            body,
            registry_builder=build_soak_registry,
            num_servers=3,
            placement=placement,
            gossip=True,
            timeout=60.0,
            app_data_builder=make_app_data,
            server_kwargs={
                "placement_daemon": True,
                "placement_daemon_config": PlacementDaemonConfig(
                    poll_interval=0.1, debounce=0.05, min_rebalance_interval=0.1
                ),
            },
        )
    )


def test_server_auto_wires_the_ports_affinity_tracker():
    """An unchanged Server wires ``AffinityTracker.observe`` of the port's
    provider into its dispatch path: after traffic the tracker holds every
    served key, and a rebalance of the provider runs in mode hierarchical
    (``auto`` with a tracker)."""
    from rio_tpu_torch.object_placement import AffinityTracker

    tracker = AffinityTracker()
    placement = TorchObjectPlacement(affinity_tracker=tracker, device="cpu")
    state = LocalState()

    def make_app_data() -> AppData:
        ad = AppData()
        ad.set(state, as_type=StateProvider)
        return ad

    async def body(cluster: Cluster):
        client = cluster.client()
        try:
            for _ in range(3):
                for i in range(24):
                    await client.send(SoakCounter, f"t{i}", Add(n=1), returns=Total)
            keys = {f"{TYPE}.t{i}" for i in range(24)}
            assert keys <= set(tracker._obj)
            assert placement.count() == 24
            await placement.rebalance(delta=False)
            assert placement.stats.mode == "hierarchical"
            assert placement.stats.chunks == 1 and placement.stats.devices == 1
            assert placement.count() == 24
            for i in range(24):
                out = await client.send(SoakCounter, f"t{i}", Get(), returns=Total)
                assert out.value == 3
        finally:
            client.close()

    asyncio.run(
        run_integration_test(
            body,
            registry_builder=build_soak_registry,
            num_servers=2,
            placement=placement,
            timeout=60.0,
            app_data_builder=make_app_data,
        )
    )
