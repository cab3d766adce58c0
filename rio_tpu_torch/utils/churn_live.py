"""A node dies under a live cluster, and the ``PlacementDaemon`` alone re-seats its objects.

:func:`measure_daemon_churn` boots ``n_servers`` port :class:`Server` s on
loopback over one shared directory, with gossip membership and
``placement_daemon=True`` on every node. It allocates ``n_echo``
:class:`~rio_tpu_torch.utils.routing_live.EchoActor` s and ``n_counters``
:class:`DurableCounter` s (one acknowledged ``Add`` each; the state lives in
one :class:`~rio_tpu_torch.state.LocalState` behind ``StateProvider``, so
it outlives its node), kills the server that holds the most rows with an
admin ``server_exit``, and waits until a daemon completes a rebalance and
the dead node holds no row. Then it reads every counter back through a
client and takes the hops of ``sample_size`` echo ids through the
directory resolver.

The bounds of the scenario (``tests/test_torch_runtime_live.py`` and
``chip_smoke.py``'s ``live_churn`` hold them): no row on the dead node,
``displaced <= moved <= displaced + n/4``, every counter at its
acknowledged value from a live node, and 1.0 hop through the directory.
"""

from __future__ import annotations

import asyncio
import random as _random
import time

from .. import AppData, Client, LocalStorage, Registry, Server, ServiceObject, handler, message
from ..commands import AdminCommand, ServerInfo
from ..cluster.membership_protocol.peer_to_peer import (
    PeerToPeerClusterConfig,
    PeerToPeerClusterProvider,
)
from ..placement_daemon import PlacementDaemonConfig
from ..registry import ObjectId, type_id
from ..state import LocalState, StateProvider, managed_state
from .routing_live import Echo, EchoActor, _stats

ALLOC_BATCH = 512  # concurrent sends per allocation wave, as routing_live's


@message(name="churn_live.Add")
class Add:
    n: int = 1


@message(name="churn_live.Get")
class Get:
    pass


@message(name="churn_live.Total")
class Total:
    value: int = 0
    address: str = ""


@message(name="churn_live.CounterState")
class CounterState:
    value: int = 0


class DurableCounter(ServiceObject):
    """A counter whose acknowledgement follows the saved state: a node
    death at any point loses nothing that the client counted."""

    state = managed_state(CounterState)

    @handler
    async def add(self, msg: Add, ctx: AppData) -> Total:
        self.state.value += msg.n
        await self.save_state(ctx)
        info = ctx.try_get(ServerInfo)
        return Total(value=self.state.value, address=info.address if info else "")

    @handler
    async def get(self, msg: Get, ctx: AppData) -> Total:
        info = ctx.try_get(ServerInfo)
        return Total(value=self.state.value, address=info.address if info else "")


def build_churn_registry() -> Registry:
    return Registry().add_type(EchoActor).add_type(DurableCounter)


def gossip_config() -> PeerToPeerClusterConfig:
    """Gossip for many servers on one event loop.

    A member is declared dead after 3 failed probes within 10 s, each
    allowed 2 s: the servers share one loop, and its stalls under a
    100,000-object allocation must not read as deaths. A clean exit
    deregisters at once, so the killed node is seen without waiting.
    """
    return PeerToPeerClusterConfig(
        interval_secs=0.5,
        num_failures_threshold=3,
        interval_secs_threshold=10.0,
        drop_inactive_after_secs=60.0,
        ping_timeout=2.0,
    )


def fast_daemon_config() -> PlacementDaemonConfig:
    return PlacementDaemonConfig(poll_interval=0.1, debounce=0.05, min_rebalance_interval=0.1)


async def _in_waves(fn, keys: list[str]) -> list:
    out: list = []
    for base in range(0, len(keys), ALLOC_BATCH):
        out += await asyncio.gather(*[fn(k) for k in keys[base : base + ALLOC_BATCH]])
    return out


async def measure_daemon_churn(
    placement,
    *,
    n_servers: int = 8,
    n_echo: int = 100_000,
    n_counters: int = 8_192,
    sample_size: int = 4_000,
    seed: int = 0,
    daemon_config: PlacementDaemonConfig | None = None,
    gossip: PeerToPeerClusterConfig | None = None,
    rebalance_timeout: float = 60.0,
    reseat_timeout: float = 30.0,
    load_monitor: bool = False,
) -> dict:
    """Kill the fullest node of a live cluster on ``placement``; return what happened.

    ``load_monitor`` is off by default, unlike a ``Server``'s: the servers
    share one event loop, so each monitor would read the allocation's loop
    lag into its node's load vector, and the solver would derate the nodes'
    capacities unevenly (``sync_load``) and move objects between live
    nodes. Servers in separate processes would each read their own lag.

    Keys of the result:

    * ``n_servers``, ``load_monitor`` (whether each server ran its load
      monitor), ``n_objects``, ``alloc_s`` (the allocation's wall),
      ``victim``, ``displaced`` (rows on the victim at the kill);
    * ``moved`` (objects whose seat differs from before the kill) and
      ``live_moved`` (of those, objects that sat on a live node);
      ``planned_moves`` (the moves the daemons' committed solves planned,
      summed: with several daemons planning against one directory it can
      differ from ``moved`` either way);
    * ``dead_rows`` (rows on the victim once re-seated),
      ``kill_to_rebalance_s`` (the kill to the first rebalance that
      completed, not discarded), ``kill_to_reseated_s`` (the kill to no
      row on the victim; None if that never came);
    * ``rebalances``, ``solves`` (completed and discarded solves seen since
      the kill) and ``solve_log`` (each one's mode, moved, displaced,
      discarded flag and ``solve_ms``); ``daemons`` and ``migration`` (the
      daemons' and the migration coordinators' counters since the kill,
      summed; ``daemons`` adds the gossip's suppressed death verdicts);
    * ``stats``: ``mode``, ``solve_ms``, ``apply_ms``, ``moved``,
      ``displaced`` and ``discarded`` of the provider's ``SolveStats`` for
      the completed solve that moved the most rows;
    * ``counters`` (how many read back), ``lost`` (at most ten counters that
      read back wrong or from a dead node), ``hops`` (the directory
      resolver's hop stats as a dict) and ``live`` (the surviving
      addresses).
    """
    members = LocalStorage()
    state = LocalState()
    servers: list[Server] = []
    tasks: list[asyncio.Task] = []
    loop = asyncio.get_event_loop()
    try:
        for _ in range(n_servers):
            app_data = AppData()
            app_data.set(state, as_type=StateProvider)
            s = Server(
                address="127.0.0.1:0",
                registry=build_churn_registry(),
                cluster_provider=PeerToPeerClusterProvider(members, gossip or gossip_config()),
                object_placement_provider=placement,
                app_data=app_data,
                placement_daemon=True,
                placement_daemon_config=daemon_config or fast_daemon_config(),
                load_monitor=load_monitor,
            )
            await s.prepare()
            await s.bind()
            servers.append(s)
        tasks = [asyncio.create_task(s.run()) for s in servers]
        deadline = loop.time() + 15.0
        while len(await members.active_members()) < n_servers:
            if loop.time() > deadline:
                raise TimeoutError(f"never saw {n_servers} active members")
            await asyncio.sleep(0.02)

        echo_ids = [f"obj-{i}" for i in range(n_echo)]
        counter_ids = [f"ctr-{i}" for i in range(n_counters)]
        setup = Client(members)
        t0 = time.perf_counter()
        await _in_waves(lambda k: setup.send(EchoActor, k, Echo(value=1), returns=Echo), echo_ids)
        totals = await _in_waves(lambda k: setup.send(DurableCounter, k, Add(n=1), returns=Total), counter_ids)
        alloc_s = time.perf_counter() - t0
        setup.close()
        acked = {k: t.value for k, t in zip(counter_ids, totals)}

        keys = [ObjectId(type_id(EchoActor), k) for k in echo_ids]
        keys += [ObjectId(type_id(DurableCounter), k) for k in counter_ids]

        async def seats() -> list:
            return [await placement.lookup(key) for key in keys]

        before = await seats()
        addresses = [s.local_address for s in servers]
        victim = max(addresses, key=before.count)
        displaced = before.count(victim)
        daemons = [s.placement_daemon for s in servers if s.placement_daemon is not None]
        daemon_fields = ("liveness_changes", "rebalances", "delta_rebalances", "rebalances_skipped",
                         "rebalances_discarded", "moves", "bursts", "burst_keys")
        migration_fields = ("started", "completed", "aborted", "seat_flips", "batches", "batch_keys")

        def counters() -> tuple[dict, dict]:
            managers = [s.migration_manager for s in servers if s.migration_manager is not None]
            daemon = {f: sum(getattr(d.stats, f) for d in daemons) for f in daemon_fields}
            daemon["suppressed_verdicts"] = sum(s.cluster_provider.stats.suppressed_verdicts for s in servers)
            return daemon, {f: sum(getattr(m.stats, f) for m in managers) for f in migration_fields}

        daemons_before, migration_before = counters()

        epoch0 = placement.stats.epoch
        solves: dict[tuple, object] = {}  # every solve since the kill, discarded ones too

        def note_solves() -> bool:
            """Gather the provider's recent solves; True once one completed."""
            st = placement.stats
            for rec in [*st.history, st]:
                if rec.epoch > epoch0 and rec.mode != "none":
                    solves.setdefault((rec.epoch, rec.mode, rec.solve_ms, rec.moved), rec)
            return any(not rec.discarded for rec in solves.values())

        t_kill = time.perf_counter()
        next(s for s in servers if s.local_address == victim).admin_sender().send(AdminCommand.server_exit())
        # Several daemons share the provider, so one solve re-seats the rows
        # and the others find nothing to move; a discarded attempt (the
        # epoch moved under it) is retried by its daemon.
        completed_at = reseated_at = None
        deadline = loop.time() + rebalance_timeout
        while completed_at is None:
            if loop.time() > deadline:
                raise TimeoutError("no daemon completed a rebalance after the node died")
            if note_solves():
                completed_at = time.perf_counter()
            await asyncio.sleep(0.01)
        deadline = loop.time() + reseat_timeout
        while True:
            note_solves()
            dead_rows = (await seats()).count(victim)
            if dead_rows == 0:
                reseated_at = time.perf_counter()
                break
            if loop.time() > deadline:
                break
            await asyncio.sleep(0.05)
        note_solves()
        first = max((r for r in solves.values() if not r.discarded), key=lambda r: r.moved)
        live = [a for a in addresses if a != victim]
        # A daemon counts its moves once its move sink returns, which may be
        # after the last row left the dead node: wait for the counters to rest.
        daemons_after, migration_after = counters()
        deadline = loop.time() + reseat_timeout
        while loop.time() < deadline:
            await asyncio.sleep(0.25)
            now = counters()
            if now == (daemons_after, migration_after):
                break
            daemons_after, migration_after = now
        after = await seats()
        moved = sum(b != a for b, a in zip(before, after))
        live_moved = sum(b != a and b != victim for b, a in zip(before, after))

        client = Client(members)
        readback = await _in_waves(lambda k: client.send(DurableCounter, k, Get(), returns=Total), counter_ids)
        client.close()
        lost = [
            (k, t.value, acked[k], t.address)
            for k, t in zip(counter_ids, readback)
            if t.value != acked[k] or t.address not in live
        ]

        async def directory_resolver(handler_type: str, handler_id: str) -> str | None:
            return await placement.lookup(ObjectId(handler_type, handler_id))

        sample = list(echo_ids)
        _random.Random(seed).shuffle(sample)
        hopper = Client(members, placement_resolver=directory_resolver)
        hops: list[int] = []
        for oid in sample[:sample_size]:
            n_before = hopper.stats.roundtrips
            await hopper.send(EchoActor, oid, Echo(value=2), returns=Echo)
            hops.append(hopper.stats.roundtrips - n_before)
        hopper.close()

        return {
            "n_servers": n_servers,
            "load_monitor": load_monitor,
            "n_objects": len(keys),
            "alloc_s": alloc_s,
            "victim": victim,
            "displaced": displaced,
            "moved": moved,
            "planned_moves": daemons_after["moves"] - daemons_before["moves"],
            "dead_rows": dead_rows,
            "kill_to_rebalance_s": completed_at - t_kill,
            "kill_to_reseated_s": None if reseated_at is None else reseated_at - t_kill,
            "live_moved": live_moved,
            "rebalances": daemons_after["rebalances"] - daemons_before["rebalances"],
            "solves": len(solves),
            "solve_log": [
                [r.mode, r.moved, r.displaced, r.discarded, r.solve_ms]
                for r in sorted(solves.values(), key=lambda r: r.epoch)
            ],
            "daemons": {f: daemons_after[f] - daemons_before[f] for f in daemons_after},
            "migration": {f: migration_after[f] - migration_before[f] for f in migration_fields},
            "stats": {
                "mode": first.mode,
                "solve_ms": first.solve_ms,
                "apply_ms": first.apply_ms,
                "moved": first.moved,
                "displaced": first.displaced,
                "discarded": first.discarded,
            },
            "counters": len(readback),
            "lost": lost[:10],
            "hops": _stats(hops).as_dict(),
            "live": live,
        }
    finally:
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)


def main(argv: list[str] | None = None) -> list[dict]:
    """``python -m rio_tpu_torch.utils.churn_live [--trials N] [--device cpu]``.

    Runs :func:`measure_daemon_churn` at BASELINE row 2's size on a fresh
    ``TorchObjectPlacement`` a trial (CUDA unless ``--device`` names
    another) and prints one JSON line a trial, with the card's name and
    power limit.
    """
    import argparse
    import json
    import subprocess

    from ..device import resolve_device
    from ..object_placement.torch_placement import TorchObjectPlacement

    parser = argparse.ArgumentParser(
        prog="python -m rio_tpu_torch.utils.churn_live", description=main.__doc__.split("\n\n")[0]
    )
    parser.add_argument("--trials", type=int, default=1)
    parser.add_argument("--device", default=None, help="the directory's device (CUDA when not given)")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    card = None
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    results = []
    for trial in range(args.trials):
        placement = TorchObjectPlacement(move_cost=0.5, device=dev)
        t0 = time.perf_counter()
        out = asyncio.run(measure_daemon_churn(placement))
        out = {"trial": trial, "card": card, "wall_s": time.perf_counter() - t0, **out}
        print(json.dumps(out), flush=True)
        results.append(out)
    return results


if __name__ == "__main__":
    main()
