"""Measured disabled-overhead of the fault-injection layer on the live loop.

The fault subsystem (``rio_tpu_torch/faults.py``) promises that a DISABLED
schedule prices the data path at exactly zero: flipping
``schedule.enabled = False`` re-arms every attached wrapper into a pure
passthrough (the inner backend's bound methods are swapped onto the
wrapper instance — no extra coroutine, no counters), so the per-request
directory lookup the service layer does is byte-for-byte the bare
backend's call. This module *measures* that promise the same way
``journal_live`` prices the flight recorder: two cluster configurations,
identical traffic, one process —

* **off** — servers booted over bare ``LocalStorage``/``LocalObjectPlacement``;
* **on** — the same backends wrapped in ``FaultyMembershipStorage`` /
  ``FaultyObjectPlacement`` around a DISABLED :class:`~rio_tpu_torch.faults.FaultSchedule`
  (the production posture if the chaos layer ships installed).

The measurement discipline is inherited wholesale from ``tracing_live``:
both clusters boot once and coexist, placement is pre-seated identically,
GC is collected before and disabled during each timed batch, and the
artifact is the MEDIAN of per-batch paired ratios where batch k's off/on
share the same seconds of box weather. A direct-trait lookup micro prices
all three wrapper states — bare, disabled (swap active), and armed-idle
(enabled, zero rules: the gated delegation path with health accounting) —
so the cost ladder is explicit rather than implied.
"""

from __future__ import annotations

import asyncio
import gc
import time

from .. import Client
from ..cluster.storage import LocalStorage
from ..faults import (
    FaultSchedule,
    FaultyMembershipStorage,
    FaultyObjectPlacement,
    StorageHealth,
)
from ..object_placement import LocalObjectPlacement
from .routing_live import Echo, EchoActor, boot_echo_cluster


async def _lookup_rate(placement, n_ops: int) -> float:
    from ..registry import ObjectId, type_id

    oid = ObjectId(type_id(EchoActor), "w0")
    gc.collect()
    gc.disable()
    try:
        t0 = time.perf_counter()
        for _ in range(n_ops):
            await placement.lookup(oid)
        elapsed = time.perf_counter() - t0
    finally:
        gc.enable()
    return n_ops / elapsed


async def measure_faults_overhead(
    *,
    n_servers: int = 2,
    n_workers: int = 32,
    requests_per_batch: int = 64,
    n_objects: int = 256,
    batches: int = 24,
    lookup_ops: int = 20_000,
    transport: str = "asyncio",
) -> dict:
    """A/B the RPC loop with the fault wrappers absent vs installed-but-disabled.

    Returns best-of msgs/sec per mode plus ``faults_overhead_pct`` (the
    median per-batch paired ratio of off/on, positive = slower) and the
    direct-trait ``lookup_ops_per_sec`` ladder for bare / disabled /
    armed-idle wrappers. The disabled wrapper is asserted to be in
    passthrough (swap active), and the schedule to have injected NOTHING —
    so the headline number is a pure parity measurement.
    """
    import statistics

    schedule = FaultSchedule(seed=0)
    schedule.enabled = False
    health = StorageHealth()
    storages = {
        "off": (LocalStorage(), LocalObjectPlacement()),
        "on": (
            FaultyMembershipStorage(LocalStorage(), schedule, health),
            FaultyObjectPlacement(LocalObjectPlacement(), schedule, health),
        ),
    }
    clusters: dict[str, tuple] = {}  # name -> (client, tasks, servers)
    rates: dict[str, list[float]] = {name: [] for name in storages}
    lookup_rates: dict[str, float] = {}
    try:
        for name, (members, placement) in storages.items():
            members, placement, tasks, servers = await boot_echo_cluster(
                n_servers,
                transport=transport,
                members=members,
                placement=placement,
            )
            # Identical pre-seating in both clusters (see tracing_live: a
            # skewed provider split reads as a durable throughput delta).
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

        on_placement = storages["on"][1]
        if "lookup" not in on_placement.__dict__:
            raise RuntimeError("disabled wrapper is not in passthrough mode")

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

        for name in storages:  # discarded warm batch per mode
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

        if schedule.injected_errors or schedule.injected_hangs:
            raise RuntimeError("disabled schedule injected faults during the A/B")

        # Cost ladder at the trait: bare dict-get, disabled passthrough,
        # armed-idle gated delegation (this is what a chaos soak pays while
        # no fault is actually firing).
        bare = storages["off"][1]
        lookup_rates["bare"] = await _lookup_rate(bare, lookup_ops)
        lookup_rates["disabled"] = await _lookup_rate(on_placement, lookup_ops)
        armed = FaultyObjectPlacement(
            LocalObjectPlacement(), FaultSchedule(seed=0), StorageHealth()
        )
        from ..object_placement import ObjectPlacementItem
        from ..registry import ObjectId, type_id

        await armed.update(
            ObjectPlacementItem(ObjectId(type_id(EchoActor), "w0"), "127.0.0.1:1")
        )
        lookup_rates["armed_idle"] = await _lookup_rate(armed, lookup_ops)
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
        "faults_overhead_pct": round(statistics.median(ratios) * 100.0, 2),
        "lookup_ops_per_sec": {k: round(v, 1) for k, v in lookup_rates.items()},
        "lookup_overhead_disabled_pct": round(
            (lookup_rates["bare"] / lookup_rates["disabled"] - 1.0) * 100.0, 2
        ),
        "lookup_overhead_armed_idle_pct": round(
            (lookup_rates["bare"] / lookup_rates["armed_idle"] - 1.0) * 100.0, 2
        ),
        "n_requests_per_batch": n_workers * requests_per_batch,
        "batches": batches,
    }
