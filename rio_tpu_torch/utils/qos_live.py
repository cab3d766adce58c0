"""Measured QoS scheduler cost and benefit on live clusters.

The QoS subsystem (``rio_tpu_torch/qos``) makes two promises that only a paired
A/B on real sockets can price:

* **Uniform traffic is ~free** — unclassified requests ride a
  zero-wrapper fast path (admission is one branch chain; 7 of 8
  dispatches hand the transport the bare handler coroutine);
  ``qos_overhead_pct`` is the median per-batch paired off/on ratio
  under identical echo traffic (the ``journal_live`` discipline: both
  clusters coexist in one process, batch k's two runs alternate order
  and share the same seconds of box weather). Bar: ≤ 2%.
* **Overload protection is real** — a bulk tenant floods one hot object
  while an interactive tenant sends strict-priority probes at it.
  Per-object serialized execution is the contention: every request to
  the hot object queues FIFO at the object's lock for its service time.
  OFF, all bulk requests become ready handler tasks instantly and the
  probe parks behind the whole flood at the lock; ON, concurrent starts
  are capped and the probe's tier overtakes every parked bulk request —
  it waits behind at most the in-flight few. Bars: interactive p99 ≥ 3x
  better with QoS on, and ZERO interactive sheds (the flood never
  causes the scheduler to refuse the tenant it exists to protect).

Both halves are a host stage (``python -m rio_tpu_torch.bench --qos``):
absolute rates drift with box weather between sessions, only the paired
ratios mean anything.
"""

from __future__ import annotations

import asyncio
import gc
import statistics
import time

from .. import (
    AppData,
    Client,
    LocalObjectPlacement,
    LocalStorage,
    Registry,
    Server,
    ServiceObject,
    handler,
    message,
)
from ..cluster.membership_protocol import LocalClusterProvider
from ..qos import QosConfig
from .routing_live import Echo, EchoActor, boot_echo_cluster


@message(name="qos_live.Burn")
class Burn:
    """One request worth ``spin_s`` seconds of actor service time."""

    spin_s: float = 0.0005


class BurnActor(ServiceObject):
    """Overload-model actor: each request holds the object's serialized-
    execution lock for ``spin_s``, so a flood of them at one object is a
    FIFO queue every later arrival waits through. An ``asyncio.sleep``
    models the hold (I/O-bound service time) without burning loop CPU —
    in a one-process A/B, CPU burn would slow OFF and ON clusters alike
    and measure nothing."""

    @handler
    async def burn(self, msg: Burn, ctx: AppData) -> Burn:
        if msg.spin_s > 0:
            await asyncio.sleep(msg.spin_s)
        return msg


def build_burn_registry() -> Registry:
    return Registry().add_type(BurnActor)


async def _boot_burn_cluster(
    n_servers: int,
    *,
    transport: str = "asyncio",
    server_kwargs: dict | None = None,
):
    """``boot_echo_cluster`` with the burn registry (same teardown shape)."""
    members = LocalStorage()
    placement = LocalObjectPlacement()
    servers: list[Server] = []
    tasks: list[asyncio.Task] = []
    try:
        for _ in range(n_servers):
            s = Server(
                address="127.0.0.1:0",
                registry=build_burn_registry(),
                cluster_provider=LocalClusterProvider(members),
                object_placement_provider=placement,
                transport=transport,
                **(server_kwargs or {}),
            )
            await s.prepare()
            await s.bind()
            servers.append(s)
        tasks = [asyncio.create_task(s.run()) for s in servers]
        deadline = asyncio.get_event_loop().time() + 10.0
        while asyncio.get_event_loop().time() < deadline:
            if len(await members.active_members()) >= n_servers:
                break
            await asyncio.sleep(0.02)
    except BaseException:
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        raise
    return members, placement, tasks, servers


async def measure_qos_overhead(
    *,
    n_servers: int = 2,
    n_workers: int = 32,
    requests_per_batch: int = 16,
    n_objects: int = 256,
    batches: int = 48,
    transport: str = "asyncio",
) -> dict:
    """A/B the RPC loop with the QoS scheduler off vs on, uniform traffic.

    The ON cluster runs the DEFAULT :class:`QosConfig` — the shipping
    configuration every request crosses once a node opts in. Uniform
    unclassified traffic stays on the zero-wrapper fast path (no queuing,
    no token buckets, no slot accounting), so the measured delta is the
    per-request cost of the admission branch chain plus the 1-in-8 timed
    RED sample. Batches are SHORT (~50 ms) and alternate off/on order:
    box weather is autocorrelated over seconds, so fine-grained pairs
    cancel it far better than a few long batches, and the median over
    many pairs shrugs off the bursts that straddle one.
    """
    modes = {"off": None, "on": QosConfig()}
    clusters: dict[str, tuple] = {}
    rates: dict[str, list[float]] = {name: [] for name in modes}
    try:
        for name, qos_config in modes.items():
            members, placement, tasks, servers = await boot_echo_cluster(
                n_servers,
                transport=transport,
                server_kwargs=(
                    {"qos_config": qos_config} if qos_config is not None else {}
                ),
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
        on_servers = clusters["on"][2]
        admitted = sum(s.qos.stats.admitted for s in on_servers)
        if admitted <= 0:
            raise RuntimeError(
                "qos_config cluster admitted nothing — the A/B measured "
                "a scheduler that never saw the traffic"
            )
        if any(s.qos is not None for s in clusters["off"][2]):
            raise RuntimeError("qos-off cluster still built a scheduler")
    finally:
        for client, tasks, _ in clusters.values():
            client.close()
            for t in tasks:
                t.cancel()
        await asyncio.gather(
            *[t for _, tasks, _ in clusters.values() for t in tasks],
            return_exceptions=True,
        )

    return {
        "msgs_per_sec": {k: round(max(v), 1) for k, v in rates.items()},
        "qos_overhead_pct": round(statistics.median(ratios) * 100.0, 2),
        "admitted_on": int(admitted),
        "n_requests_per_batch": n_workers * requests_per_batch,
        "batches": batches,
    }


async def measure_qos_flood(
    *,
    n_servers: int = 2,
    bulk_workers: int = 48,
    interactive_probes: int = 80,
    spin_s: float = 0.002,
    max_concurrent: int = 4,
    transport: str = "asyncio",
) -> dict:
    """A/B interactive latency under a bulk flood of one hot object.

    Everything targets the SAME object, so per-object serialized
    execution is the contention: each request holds the object lock for
    ``spin_s``. OFF, every one of ``bulk_workers`` pipelined bulk
    requests becomes a handler task parked at that lock, and the probe
    joins the FIFO at position ~``bulk_workers`` (≈ ``bulk_workers *
    spin_s`` of wait). ON, the scheduler caps handler starts at
    ``max_concurrent`` — the rest of the flood parks in the fair ring —
    and the probe's strict-priority tier takes the next grant, so it
    waits behind at most the in-flight few. Returns per-mode interactive
    p50/p99 (ms), the paired p99 ratio, and the ON cluster's interactive
    shed count (contract: 0).
    """
    modes = {
        "off": None,
        "on": QosConfig(max_concurrent=max_concurrent),
    }
    out: dict[str, dict] = {}
    interactive_sheds = 0
    for name, qos_config in modes.items():
        members, placement, tasks, servers = await _boot_burn_cluster(
            n_servers,
            transport=transport,
            server_kwargs=(
                {"qos_config": qos_config} if qos_config is not None else {}
            ),
        )
        bulk_client = Client(members, transport=transport, tenant="bulk")
        inter_client = Client(
            members, transport=transport, tenant="frontend", priority=2
        )
        stop = asyncio.Event()
        bulk_done = 0
        try:
            # Seat the hot object before the flood: placement is not the
            # contention under test.
            await inter_client.send(
                BurnActor, "hot", Burn(spin_s=0.0), returns=Burn
            )

            async def flood(w: int) -> None:
                nonlocal bulk_done
                while not stop.is_set():
                    try:
                        await bulk_client.send(
                            BurnActor, "hot", Burn(spin_s=spin_s),
                            returns=Burn,
                        )
                        bulk_done += 1
                    except Exception:
                        if stop.is_set():
                            return
                        # A shed (retry exhausted) is legal under flood;
                        # keep the pressure on.
                        await asyncio.sleep(spin_s)

            flood_tasks = [
                asyncio.create_task(flood(w)) for w in range(bulk_workers)
            ]
            # Let the flood reach steady state before measuring.
            await asyncio.sleep(0.3)
            lat_ms: list[float] = []
            for _ in range(interactive_probes):
                t0 = time.perf_counter()
                await inter_client.send(
                    BurnActor, "hot", Burn(spin_s=spin_s), returns=Burn
                )
                lat_ms.append((time.perf_counter() - t0) * 1000.0)
            stop.set()
            await asyncio.gather(*flood_tasks, return_exceptions=True)
            lat_ms.sort()
            n = len(lat_ms)
            out[name] = {
                "interactive_p50_ms": round(lat_ms[n // 2], 3),
                "interactive_p99_ms": round(lat_ms[min(n - 1, (n * 99) // 100)], 3),
                "bulk_requests": int(bulk_done),
            }
            if name == "on":
                interactive_sheds = sum(
                    s.qos.stats.interactive_sheds for s in servers
                )
        finally:
            stop.set()
            bulk_client.close()
            inter_client.close()
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

    off_p99 = out["off"]["interactive_p99_ms"]
    on_p99 = out["on"]["interactive_p99_ms"]
    return {
        "off": out["off"],
        "on": out["on"],
        "interactive_p99_improvement": round(off_p99 / max(on_p99, 1e-9), 2),
        "interactive_sheds_on": int(interactive_sheds),
        "bulk_workers": bulk_workers,
        "spin_s": spin_s,
        "max_concurrent_on": max_concurrent,
    }


async def measure_qos(*, transport: str = "asyncio", fast: bool = False) -> dict:
    """Both halves of the ``rio_tpu_torch.bench --qos`` stage, paired in-session."""
    overhead = await measure_qos_overhead(
        transport=transport, batches=16 if fast else 48
    )
    flood = await measure_qos_flood(
        transport=transport,
        interactive_probes=40 if fast else 80,
    )
    return {"uniform": overhead, "flood": flood}
