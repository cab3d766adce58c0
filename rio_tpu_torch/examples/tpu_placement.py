"""tpu-placement on the port: ``TorchObjectPlacement`` under a live cluster.

The twin of ``examples/tpu_placement.py``, on the port's own runtime and
provider. Five servers share a hierarchical ``TorchObjectPlacement``
carrying an ``AffinityTracker``, and show the three behaviours that replace
the reference's random pick plus row-by-row SQL:

1. **Directory routing**: the client resolves the owner from the
   host-mirrored directory before dialing: one network hop, no redirect.
2. **Server-owned churn response**: a node is killed; the opt-in
   ``placement_daemon`` sees the liveness change and triggers a
   warm-started re-solve, with no solver call from the application.
3. **Affinity**: each ``Server`` auto-wires the provider's
   ``tracker.observe`` into its dispatch path; the first request to each
   object draws its features on the provider's device.

Runs on CUDA unless asked for the CPU::

    python -m rio_tpu_torch.examples.tpu_placement [--device cpu]

Nothing runs at import.
"""

from __future__ import annotations

import argparse
import asyncio

from .. import (
    AppData,
    Client,
    LocalStorage,
    ObjectId,
    Registry,
    Server,
    ServerInfo,
    ServiceObject,
    handler,
    message,
)
from ..cluster.membership_protocol import LocalClusterProvider
from ..commands import AdminCommand
from ..device import resolve_device
from ..object_placement import AffinityTracker, TorchObjectPlacement
from ..placement_daemon import PlacementDaemonConfig

N_SERVERS = 5
N_OBJECTS = 200


@message(name="tpu_placement.Hit")
class Hit:
    n: int = 0


@message(name="tpu_placement.HitCount")
class HitCount:
    n: int = 0
    server: str = ""


class CounterActor(ServiceObject):
    def __init__(self):
        self.hits = 0

    @handler
    async def hit(self, msg: Hit, ctx: AppData) -> HitCount:
        self.hits += msg.n
        return HitCount(n=self.hits, server=ctx.get(ServerInfo).address)


async def run_demo(device=None, *, verbose: bool = True) -> dict:
    """Boot the cluster, drive it, kill a node, wait for the daemon; return what happened.

    The result holds ``device``, ``requests``, ``hops`` and ``redirects``
    of the first pass, ``observed`` (objects in the tracker), ``mode``,
    ``solve_ms``, ``moved``, ``n_objects`` and ``discarded`` of the
    daemon's re-solve, and ``reachable`` and ``kept_state`` after it.
    """
    say = print if verbose else (lambda *a, **k: None)
    dev = resolve_device(device)
    members = LocalStorage()
    tracker = AffinityTracker(dim=32)
    # Hierarchical mode reads the tracker's features; carrying the tracker
    # on the provider makes each Server auto-wire observation into its
    # dispatch path (commands.DispatchObserver).
    placement = TorchObjectPlacement(
        mode="hierarchical", n_iters=20, affinity_tracker=tracker, device=dev
    )

    servers: list[Server] = []
    for _ in range(N_SERVERS):
        s = Server(
            address="127.0.0.1:0",
            registry=Registry().add_type(CounterActor),
            cluster_provider=LocalClusterProvider(members),
            object_placement_provider=placement,
            placement_daemon=True,
            placement_daemon_config=PlacementDaemonConfig(
                poll_interval=0.1, debounce=0.05, min_rebalance_interval=0.1
            ),
        )
        await s.prepare()
        await s.bind()
        servers.append(s)
    tasks = [asyncio.create_task(s.run()) for s in servers]
    client = None
    try:
        await asyncio.sleep(0.3)
        placement.sync_members(await members.active_members())

        client = Client(members, placement_resolver=lambda t, i: placement.lookup(ObjectId(t, i)))
        say(f"[demo] driving {N_OBJECTS} actors over {N_SERVERS} servers on {dev}")
        for i in range(N_OBJECTS):
            # No tracker.observe here: the serving node records it.
            await client.send(CounterActor, f"c{i}", Hit(n=1), returns=HitCount)
        first_pass = (client.stats.requests, client.stats.roundtrips, client.stats.redirects)
        say(f"[demo] {first_pass[0]} requests took {first_pass[1]} hops ({first_pass[2]} redirects)")
        observed = len(tracker._obj)

        # A cleanly exiting server deregisters itself from membership; the
        # placement daemon does the rest.
        victim = servers[0]
        epoch0 = placement.stats.epoch
        say(f"[demo] killing {victim.local_address}")
        victim.admin_sender().queue.put_nowait(AdminCommand.server_exit())
        for _ in range(600):
            # Wait for a completed solve: a discarded attempt is a stats
            # event too, and the daemon retries after it.
            st = placement.stats
            if st.epoch != epoch0 and st.n_objects and not st.discarded:
                break
            await asyncio.sleep(0.05)
        else:
            raise RuntimeError("the placement daemon never re-solved")
        st = placement.stats
        say(
            f"[demo] daemon re-solve ({st.mode}) in {st.solve_ms:.1f} ms: moved "
            f"{st.moved} of {st.n_objects} objects, no app-level solver call"
        )

        reachable = kept = 0
        for i in range(N_OBJECTS):
            out = await client.send(CounterActor, f"c{i}", Hit(n=1), returns=HitCount)
            reachable += 1
            kept += out.n == 2
        say(f"[demo] all {reachable} actors reachable after churn; {kept} kept in-memory state")
        say("[demo] done")
        return {
            "device": str(dev),
            "requests": first_pass[0],
            "hops": first_pass[1],
            "redirects": first_pass[2],
            "observed": observed,
            "mode": st.mode,
            "solve_ms": st.solve_ms,
            "moved": st.moved,
            "n_objects": st.n_objects,
            "discarded": st.discarded,
            "reachable": reachable,
            "kept_state": kept,
        }
    finally:
        if client is not None:
            client.close()
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(
        prog="python -m rio_tpu_torch.examples.tpu_placement", description=__doc__.split("\n\n")[0]
    )
    parser.add_argument("--device", default=None, help="the provider's device (CUDA when not given)")
    args = parser.parse_args(argv)
    return asyncio.run(run_demo(args.device))


if __name__ == "__main__":
    main()
