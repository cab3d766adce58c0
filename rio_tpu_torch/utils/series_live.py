"""Measured gauge time-series sampling overhead on the live RPC loop.

The series ring (``rio_tpu_torch/timeseries.py``) promises the data path pays
~nothing for trend history: sampling rides the LoadMonitor's existing
cadence (no new task), each tick is one ``server_gauges`` scrape plus a
dict copy, and the request path itself is untouched. This module
*measures* that promise with the ``journal_live`` discipline — two
cluster configurations, identical traffic, one process:

* **off** — servers booted with ``timeseries=False``: no ring, no
  sampler tick, no HealthWatch.
* **on** — sampling at an AGGRESSIVE cadence (default 0.05 s — 20x the
  shipping 1 s default) plus HealthWatch rule evaluation per sample, so
  the measured bar (≤ ~1% at the shipping cadence) is priced
  under far more sampling pressure than production ever sees.

Both clusters boot once and coexist, placement is pre-seated identically,
GC is collected before and disabled during each timed batch, and the
artifact is the MEDIAN of per-batch paired off/on ratios (batch k's two
runs share the same seconds of box weather).
"""

from __future__ import annotations

import asyncio
import gc
import time

from .. import Client
from .routing_live import Echo, EchoActor, boot_echo_cluster


async def measure_series_overhead(
    *,
    n_servers: int = 2,
    n_workers: int = 32,
    requests_per_batch: int = 64,
    n_objects: int = 256,
    batches: int = 24,
    sample_interval: float = 0.05,
    transport: str = "asyncio",
) -> dict:
    """A/B the RPC loop with gauge time-series sampling off vs on.

    Returns best-of msgs/sec per mode plus ``series_overhead_pct`` (the
    median per-batch paired ratio of off/on, positive = slower) and the
    on-cluster's total sample count — asserted > 0 so the A/B measured a
    cluster that was actually sampling, and the off-cluster is asserted
    ring-free so it is a real control.
    """
    import statistics

    modes = {"off": False, "on": True}
    clusters: dict[str, tuple] = {}  # name -> (client, tasks, servers)
    rates: dict[str, list[float]] = {name: [] for name in modes}
    try:
        for name, series_on in modes.items():
            members, placement, tasks, servers = await boot_echo_cluster(
                n_servers,
                transport=transport,
                server_kwargs={
                    "timeseries": series_on,
                    # The sampler rides the load loop: tick the loop at the
                    # sampling cadence so "on" really samples this fast.
                    "load_interval": sample_interval,
                    "timeseries_interval": sample_interval,
                },
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
        sampled = sum(s.timeseries.sampled for s in on_servers)
        if sampled <= 0:
            raise RuntimeError(
                "timeseries=True cluster took no samples — the A/B measured "
                "nothing (load loop not ticking?)"
            )
        alerts_fired = sum(
            s.health_watch.fired_total
            for s in on_servers
            if s.health_watch is not None
        )
        off_servers = clusters["off"][2]
        if any(s.timeseries is not None for s in off_servers):
            raise RuntimeError("timeseries=False cluster still built a ring")
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
        "series_overhead_pct": round(statistics.median(ratios) * 100.0, 2),
        "samples_on": int(sampled),
        "health_alerts_fired_on": int(alerts_fired),
        "sample_interval_s": sample_interval,
        "n_requests_per_batch": n_workers * requests_per_batch,
        "batches": batches,
    }
