"""Measured control-plane journal overhead on the live RPC loop.

The flight recorder (``rio_tpu_torch/journal.py``) promises the data path pays
nothing for it: events are recorded on control-plane TRANSITIONS only
(assign, shed, migrate phases, solve, ...) — never per request — and the
request path's only journal touch is the ``app_data.try_get`` each manager
does once at construction. This module *measures* that promise the same
way ``tracing_live`` prices the metrics layer: two cluster configurations,
identical traffic, one process —

* **off** — servers booted with ``journal=False``: no Journal in AppData,
  every subsystem's journal reference is ``None``.
* **on** — the shipping default (``journal=True``, capacity 4096): the
  acceptance bar (≤ ~2%) is ``on`` vs ``off`` on the echo loop.

The measurement discipline is inherited wholesale from ``tracing_live``
(it exists because the naive one-cluster-per-mode cut read -1%..+8% under
box drift): both clusters boot once and coexist, placement is pre-seated
identically, GC is collected before and disabled during each timed batch,
and the artifact is the MEDIAN of per-batch paired ratios where batch k's
off/on share the same seconds of box weather.
"""

from __future__ import annotations

import asyncio
import gc
import time

from .. import Client
from .routing_live import Echo, EchoActor, boot_echo_cluster


async def measure_journal_overhead(
    *,
    n_servers: int = 2,
    n_workers: int = 32,
    requests_per_batch: int = 64,
    n_objects: int = 256,
    batches: int = 24,
    transport: str = "asyncio",
) -> dict:
    """A/B the RPC loop with the control-plane journal off vs on.

    Returns best-of msgs/sec per mode plus ``journal_overhead_pct`` (the
    median per-batch paired ratio of off/on, positive = slower), and the
    on-cluster's recorded-event count. With pre-seated placement and no
    daemons the echo loop makes NO control transitions, so that count is
    typically 0 — the whole point: journal on, data path untouched. The
    off-cluster is asserted journal-free so the A/B is real.
    """
    import statistics

    modes = {"off": False, "on": True}
    clusters: dict[str, tuple] = {}  # name -> (client, tasks, servers)
    rates: dict[str, list[float]] = {name: [] for name in modes}
    try:
        for name, journal_on in modes.items():
            members, placement, tasks, servers = await boot_echo_cluster(
                n_servers,
                transport=transport,
                server_kwargs={"journal": journal_on},
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
        recorded = sum(s.journal.recorded for s in on_servers)
        off_servers = clusters["off"][2]
        if any(s.journal is not None for s in off_servers):
            raise RuntimeError("journal=False cluster still built a Journal")
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
        "journal_overhead_pct": round(statistics.median(ratios) * 100.0, 2),
        "events_recorded_on": int(recorded),
        "n_requests_per_batch": n_workers * requests_per_batch,
        "batches": batches,
    }
