"""Measured elastic autoscaling on live clusters: idle cost + the ramp soak.

Two artifacts back the autoscale subsystem (``python -m rio_tpu_torch.bench --autoscale``):

* :func:`measure_autoscale_idle_overhead` — the faults_live pricing
  discipline applied to the controller: two in-process clusters serving
  identical echo traffic, one with autoscaling absent (``autoscale_config
  =None`` — the server holds literally no controller object) and one with
  the controller armed but pinned (``min_nodes == max_nodes``: it ticks,
  samples gauges, evaluates trend rules, and can never act). The headline
  is the MEDIAN of per-batch paired ratios where batch k's off/on share
  the same seconds of box weather; the disabled side is additionally
  asserted to be structurally free (``server.autoscale is None``).

* :func:`measure_autoscale_ramp` — the deliverable soak: a supervisor
  with a :class:`~rio_tpu_torch.autoscale.provision.SubprocessProvisioner`
  ramps offered load ~10x up and back down while a ``faults.py`` schedule
  blips the supervisor's membership+placement view and one managed node
  takes a real SIGKILL mid-scale-in drain. Writes go through a durable
  shared-sqlite state provider and are counted ONLY when acked, so the
  zero-lost bar is exact: every acked increment must be in the final
  counter values (duplicates — an applied write whose ack died with the
  node — are tolerated and reported, lost ones fail the soak). The
  supervisor's journal must show the full causal chain for every
  decision: a HEALTH alarm for the trigger rule strictly before the SCALE
  decision, and scale-ins completing through drain-request → retire.
"""

from __future__ import annotations

import asyncio
import contextlib
import gc
import os
import shutil
import statistics
import tempfile
import time

from .. import AppData, Client, Registry, ServiceObject, handler, message
from ..commands import ServerInfo
from ..errors import (
    Disconnect,
    RetryExhausted,
    ServerBusy,
    ServerNotAvailable,
)
from ..state import StateProvider, managed_state
from ..state.sqlite import SqliteState
from .backoff import ExponentialBackoff

RETRYABLE = (RetryExhausted, ServerBusy, ServerNotAvailable, Disconnect, OSError)


# -- the soak actor -----------------------------------------------------------
# Module-level on purpose: SubprocessProvisioner workers import it through
# the "rio_tpu_torch.utils.autoscale_live:build_soak_registry" factory spec.


@message(name="autoscale_live.Add")
class Add:
    n: int = 1


@message(name="autoscale_live.Get")
class Get:
    pass


@message(name="autoscale_live.Total")
class Total:
    value: int = 0
    address: str = ""


@message(name="autoscale_live.CounterState")
class CounterState:
    value: int = 0


class SoakCounter(ServiceObject):
    """Durable counter: the ack is sent only after the state saved, so a
    node death at ANY point loses nothing the client counted."""

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


def build_soak_registry() -> Registry:
    return Registry().add_type(SoakCounter)


def sqlite_state(data_dir: str) -> SqliteState:
    """Shared durable state factory (``--node`` spec: "state" key)."""
    return SqliteState(os.path.join(data_dir, "autoscale-state.db"))


# -- idle controller overhead (the disabled-must-stay-free A/B) ---------------


async def measure_autoscale_idle_overhead(
    *,
    n_servers: int = 2,
    n_workers: int = 32,
    requests_per_batch: int = 64,
    n_objects: int = 256,
    batches: int = 24,
    transport: str = "asyncio",
) -> dict:
    """A/B the RPC loop with autoscaling absent vs armed-but-pinned.

    Returns best-of msgs/sec per mode plus ``autoscale_overhead_pct``
    (median per-batch paired ratio of off/on, positive = slower). The
    "on" controller genuinely runs — its tick count is asserted > 0 —
    but ``min_nodes == max_nodes`` pins it so no decision can fire.
    """
    from ..autoscale import AutoscaleConfig, ScalePolicy
    from ..autoscale.provision import InProcessProvisioner
    from ..cluster.storage import LocalStorage
    from ..object_placement import LocalObjectPlacement
    from .routing_live import Echo, EchoActor, boot_echo_cluster

    on_members = LocalStorage()
    on_placement = LocalObjectPlacement()
    provisioner = InProcessProvisioner(
        on_members,
        on_placement,
        registry_builder=build_soak_registry,
    )
    modes: dict[str, dict] = {
        "off": dict(members=LocalStorage(), placement=LocalObjectPlacement()),
        "on": dict(
            members=on_members,
            placement=on_placement,
            server_kwargs=dict(
                load_interval=0.1,
                autoscale_config=AutoscaleConfig(
                    provisioner=provisioner,
                    # Pinned: nodes can neither grow nor shrink, so the
                    # controller pays its full observation cost (gauge
                    # aggregation, EMA, trend rules) and never acts.
                    policy=ScalePolicy(
                        min_nodes=n_servers, max_nodes=n_servers
                    ),
                    interval=0.25,
                ),
            ),
        ),
    }
    clusters: dict[str, tuple] = {}  # name -> (client, tasks, servers)
    rates: dict[str, list[float]] = {name: [] for name in modes}
    try:
        for name, cfg in modes.items():
            members, placement, tasks, servers = await boot_echo_cluster(
                n_servers,
                transport=transport,
                members=cfg["members"],
                placement=cfg["placement"],
                server_kwargs=cfg.get("server_kwargs"),
            )
            from ..object_placement import ObjectPlacementItem
            from ..registry import ObjectId, type_id

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
                await client.send(EchoActor, f"w{i}", Echo(value=i), returns=Echo)

        # Disabled is structurally free: no controller object exists.
        assert all(s.autoscale is None for s in clusters["off"][2])
        assert any(s.autoscale is not None for s in clusters["on"][2])

        async def batch(name: str) -> float:
            client = clusters[name][0]
            total = n_workers * requests_per_batch

            async def worker(w: int) -> None:
                for r in range(requests_per_batch):
                    oid = f"w{(w * requests_per_batch + r) % n_objects}"
                    await client.send(EchoActor, oid, Echo(value=r), returns=Echo)

            gc.collect()
            gc.disable()
            try:
                t0 = time.perf_counter()
                await asyncio.gather(*[worker(w) for w in range(n_workers)])
                elapsed = time.perf_counter() - t0
            finally:
                gc.enable()
            return total / elapsed

        for name in modes:  # discarded warm batch per mode
            await batch(name)
        ratios: list[float] = []
        for k in range(batches):
            if k % 2 == 0:
                o = await batch("off")
                r = await batch("on")
            else:
                r = await batch("on")
                o = await batch("off")
            rates["off"].append(o)
            rates["on"].append(r)
            ratios.append(o / r - 1.0)

        ticks = sum(
            s.autoscale.ticks for s in clusters["on"][2] if s.autoscale
        )
        if ticks <= 0:
            raise RuntimeError("pinned controller never ticked during the A/B")
        decisions = sum(
            s.autoscale.scale_outs + s.autoscale.scale_ins
            for s in clusters["on"][2]
            if s.autoscale
        )
        if decisions:
            raise RuntimeError("pinned controller acted during the idle A/B")
    finally:
        for client, tasks, _ in clusters.values():
            client.close()
            for t in tasks:
                t.cancel()
        await asyncio.gather(
            *[t for _, tasks, _ in clusters.values() for t in tasks],
            return_exceptions=True,
        )
        await provisioner.close()

    return {
        "msgs_per_sec": {k: round(max(v), 1) for k, v in rates.items()},
        "autoscale_overhead_pct": round(statistics.median(ratios) * 100.0, 2),
        "controller_ticks_on": ticks,
        "n_requests_per_batch": n_workers * requests_per_batch,
        "batches": batches,
    }


# -- the ramp soak ------------------------------------------------------------


async def measure_autoscale_ramp(
    *,
    data_dir: str | None = None,
    n_keys: int = 16,
    writers_low: int = 2,
    writers_high: int = 20,
    low_sleep_s: float = 0.02,
    high_sleep_s: float = 0.002,
    warm_secs: float = 3.0,
    high_timeout: float = 90.0,
    settle_timeout: float = 150.0,
    p99_bound_s: float = 5.0,
    blip_period_s: float = 2.0,
    blip_secs: float = 0.3,
    max_nodes: int = 3,
) -> dict:
    """Ramp offered load ~10x up and back down against a self-sizing
    cluster under fault weather; return the full evidence bundle.

    Asserted inline (a failure raises): scale-out AND scale-in each fire,
    a managed node takes a SIGKILL mid-scale-in, zero acked writes are
    lost, request p99 stays under ``p99_bound_s`` through every resize,
    the final node count returns to the floor, and every SCALE decision
    in the journal is preceded by a HEALTH alarm for its trigger rule.
    """
    from ..autoscale import AutoscaleConfig, ScalePolicy
    from ..autoscale.provision import SubprocessProvisioner
    from ..cluster.membership_protocol import LocalClusterProvider
    from ..commands import AdminCommand
    from ..faults import (
        FaultSchedule,
        FaultyMembershipStorage,
        FaultyObjectPlacement,
        StorageHealth,
    )
    from ..journal import HEALTH, SCALE
    from ..server import Server
    from ..sharded import sqlite_members, sqlite_placement

    own_dir = data_dir is None
    if own_dir:
        data_dir = tempfile.mkdtemp(prefix="rio-autoscale-soak-")

    schedule = FaultSchedule(seed=2024)
    storage_health = StorageHealth()
    members = FaultyMembershipStorage(
        sqlite_members(data_dir), schedule, storage_health
    )
    placement = FaultyObjectPlacement(
        sqlite_placement(data_dir), schedule, storage_health
    )
    state = sqlite_state(data_dir)
    await state.prepare()
    app_data = AppData()
    app_data.set(state, as_type=StateProvider)

    provisioner = SubprocessProvisioner(
        data_dir,
        registry="rio_tpu_torch.utils.autoscale_live:build_soak_registry",
        state="rio_tpu_torch.utils.autoscale_live:sqlite_state",
        server_kwargs={"load_interval": 0.1},
    )
    # Rate-band policy: the writer phases differ ~10x in offered req/s,
    # and per-node rate is what the bands cut. The low band sits far above
    # the controller's own poke/heartbeat floor (~3 req/s).
    policy = ScalePolicy(
        min_nodes=1,
        max_nodes=max_nodes,
        high_pressure=600.0,
        low_pressure=150.0,
        sustain=2,
        ema_alpha=0.6,
        inflight_weight=0.0,
        lag_weight=0.0,
        rate_weight=1.0,
        shed_weight=0.0,
        out_cooldown_s=1.0,
        in_cooldown_s=1.0,
        cooldown_max_s=4.0,
        drain_timeout_s=15.0,
    )
    supervisor = Server(
        address="127.0.0.1:0",
        registry=build_soak_registry(),
        cluster_provider=LocalClusterProvider(members),
        object_placement_provider=placement,
        app_data=app_data,
        load_interval=0.1,
        placement_daemon=True,  # churn-kicked rebalance spreads the keys
        autoscale_config=AutoscaleConfig(
            provisioner=provisioner, policy=policy, interval=0.25
        ),
    )
    await supervisor.prepare()
    await supervisor.bind()
    serve = asyncio.ensure_future(supervisor.run())
    runtime = supervisor.autoscale
    assert runtime is not None
    client = Client(
        members, backoff=ExponentialBackoff(initial=0.01, cap=0.1, max_retries=6)
    )

    acked: dict[str, int] = {f"soak-{i}": 0 for i in range(n_keys)}
    latencies: list[float] = []
    failures = 0
    writer_sleep = low_sleep_s
    stop_load = asyncio.Event()
    stop_blips = asyncio.Event()
    blips = 0
    killed = ""
    t_start = time.monotonic()

    async def writer(w: int) -> None:
        nonlocal failures
        i = 0
        while not stop_load.is_set():
            # Round-robin over the key space so every counter sees traffic
            # in every phase regardless of how many writers are live.
            key = f"soak-{(w + i) % n_keys}"
            i += 1
            t0 = time.perf_counter()
            try:
                await client.send(SoakCounter, key, Add(n=1), returns=Total)
            except RETRYABLE:
                failures += 1
            else:
                acked[key] += 1
                latencies.append(time.perf_counter() - t0)
            await asyncio.sleep(writer_sleep)

    async def blipper() -> None:
        # Storage weather: short scripted full outages of the
        # supervisor's membership+placement view, healed each time.
        nonlocal blips
        while not stop_blips.is_set():
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(stop_blips.wait(), blip_period_s)
                return
            schedule.fail_all("membership.*")
            schedule.fail_all("placement.*")
            blips += 1
            await asyncio.sleep(blip_secs)
            schedule.heal()

    async def killer() -> None:
        # The chaos centerpiece: the moment a scale-in drain is in
        # flight, SIGKILL the victim process mid-drain.
        nonlocal killed
        while not killed and not stop_load.is_set():
            victim = runtime.pending
            if victim and victim in provisioner.managed():
                provisioner.terminate(victim)
                killed = victim
                return
            await asyncio.sleep(0.01)

    async def wait_for(pred, timeout: float, what: str) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if pred():
                return
            await asyncio.sleep(0.1)
        raise TimeoutError(f"soak: no {what} within {timeout:.0f}s")

    writers: list[asyncio.Task] = []
    chaos: list[asyncio.Task] = []
    try:
        # Phase 1 — low offered load: seat every key, bank clean writes.
        writers = [asyncio.ensure_future(writer(w)) for w in range(writers_low)]
        await asyncio.sleep(warm_secs)
        if not all(acked.values()):
            raise RuntimeError("soak: not every key served during warm-up")

        # Phase 2 — ~10x offered load under storage blips: the sustained
        # overload trend must grow the cluster.
        writer_sleep = high_sleep_s
        writers += [
            asyncio.ensure_future(writer(w))
            for w in range(writers_low, writers_high)
        ]
        chaos.append(asyncio.ensure_future(blipper()))
        await wait_for(
            lambda: runtime.scale_outs >= 1 and runtime.last_nodes >= 2,
            high_timeout,
            "scale-out under load",
        )

        # Phase 3 — back to 1x: the falling trend must shrink it; the
        # killer SIGKILLs the first drain victim mid-scale-in.
        chaos.append(asyncio.ensure_future(killer()))
        writer_sleep = low_sleep_s
        for w in writers[writers_low:]:
            w.cancel()
        await asyncio.gather(*writers[writers_low:], return_exceptions=True)
        writers = writers[:writers_low]
        await wait_for(
            lambda: runtime.scale_ins >= 1,
            settle_timeout,
            "completed scale-in",
        )
        await wait_for(
            lambda: runtime.last_nodes <= policy.min_nodes
            and not provisioner.managed(),
            settle_timeout,
            "node count back at the floor",
        )
        if not killed:
            raise RuntimeError("soak: no victim was SIGKILLed mid-scale-in")
    finally:
        stop_load.set()
        stop_blips.set()
        for t in writers + chaos:
            t.cancel()
        await asyncio.gather(*writers, *chaos, return_exceptions=True)
        schedule.heal()

    soak_secs = time.monotonic() - t_start

    # Zero lost acked writes: every increment the client saw acked is in
    # the durable counter. An applied-but-unacked write (its ack died with
    # the killed node) may legitimately over-count; it is reported, never
    # silently absorbed into the loss check.
    lost_keys: list[str] = []
    final_total = 0
    for key, want in acked.items():
        got = await client.send(SoakCounter, key, Get(), returns=Total)
        final_total += got.value
        if got.value < want:
            lost_keys.append(f"{key}: acked {want}, found {got.value}")
    if lost_keys:
        raise AssertionError(f"soak: LOST acked writes: {lost_keys}")
    acked_total = sum(acked.values())

    # Bounded p99 through every resize.
    lat = sorted(latencies)
    p50 = lat[len(lat) // 2] if lat else 0.0
    p99 = lat[int(len(lat) * 0.99)] if lat else 0.0
    if p99 > p99_bound_s:
        raise AssertionError(f"soak: p99 {p99:.2f}s exceeds {p99_bound_s}s")

    # Causality: every SCALE decision has a journaled trigger alarm of its
    # rule strictly before it, and every scale-in completes through
    # drain-request → retired.
    assert supervisor.journal is not None
    events = supervisor.journal.events(kinds=[HEALTH, SCALE])
    chain: list[str] = []
    alarm_rules_seen: set[str] = set()
    in_flight: dict[str, int] = {}
    retired: set[str] = set()
    drain_requested: set[str] = set()
    for ev in events:
        if ev.kind == HEALTH:
            alarm_rules_seen.add(ev.attrs.get("rule", "") or ev.key)
            continue
        action = ev.attrs.get("action", "")
        chain.append(f"{action}:{ev.key}")
        if action in ("scale_out", "scale_in"):
            rule = ev.attrs.get("rule", "")
            if rule not in alarm_rules_seen:
                raise AssertionError(
                    f"soak: SCALE {action} fired without a prior HEALTH "
                    f"alarm for rule {rule!r}: {chain}"
                )
        if action == "scale_in":
            in_flight[ev.key] = 1
        elif action in ("drain_requested", "drain_request_failed"):
            # A failed request is still the drain EDGE of the causal chain:
            # under storage/victim chaos the wire request can exhaust its
            # retries (the victim may already be SIGKILLed), and the
            # deadline branch is the designed path to the retire.
            drain_requested.add(ev.key)
        elif action == "retired":
            retired.add(ev.key)
    for victim in in_flight:
        if victim not in retired:
            raise AssertionError(f"soak: scale-in of {victim} never retired")
        if victim not in drain_requested:
            raise AssertionError(f"soak: {victim} retired without a drain attempt")

    result = {
        "scale_outs": runtime.scale_outs,
        "scale_ins": runtime.scale_ins,
        "final_nodes": runtime.last_nodes,
        "killed_mid_drain": killed,
        "acked_writes": acked_total,
        "final_counter_total": final_total,
        "duplicates": final_total - acked_total,
        "lost": 0,
        "retryable_failures": failures,
        "p50_ms": round(p50 * 1000.0, 2),
        "p99_ms": round(p99 * 1000.0, 2),
        "offered_ratio": round(
            (writers_high / max(1, writers_low)) * (low_sleep_s / high_sleep_s), 1
        ),
        "storage_blips": blips,
        "seconds": round(soak_secs, 1),
        "chain": chain,
    }

    client.close()
    supervisor.admin_sender().send(AdminCommand.server_exit())
    with contextlib.suppress(Exception):
        await asyncio.wait_for(serve, timeout=15.0)
    serve.cancel()
    await asyncio.gather(serve, return_exceptions=True)
    await provisioner.close()
    await runtime.close()
    with contextlib.suppress(Exception):
        members.close()
    with contextlib.suppress(Exception):
        placement.close()
    if own_dir:
        shutil.rmtree(data_dir, ignore_errors=True)
    return result
