"""Measured tracing/metrics overhead on the live RPC loop.

The observability layer promises a near-free default: with sampling at 0
the only per-request additions are one histogram record (O(1), no locks,
no allocations on the steady state) and a contextvar check. This module
*measures* that promise on the same real-TCP echo loop as
``measure_rpc_throughput``: three cluster configurations, identical
traffic, one process —

* **disabled** — servers booted with ``metrics=False``, sample rate 0:
  the spans-disabled null path (no registry in AppData, the null trace
  object on every request) — this is the pre-observability hot path.
* **record** — the shipping default: per-handler RED histograms on,
  sampling still 0 (counts exact every request, durations stride-sampled
  1-in-8). The acceptance bar lives here: ``record`` vs ``disabled`` is
  the overhead every deployment pays.
* **sampled** — sample rate 1.0 with a live (counting) sink: every
  request roots a span, carries trace_ctx on the wire, adopts it
  server-side and stashes exemplars. The worst case, priced explicitly.

Measuring a 1-2% effect under ±10% box drift takes design, not repeats
(the first cut — one cluster per mode per round — read anywhere from -1%
to +8% across invocations):

* all three clusters boot ONCE and coexist; the benchmark alternates
  sub-second timed batches between them, so each paired ratio compares
  the same seconds of box weather;
* tracing globals (sample rate, sinks) are switched per batch — a sink
  registered for the sampled cluster would otherwise turn every span in
  the process live and contaminate the disabled/record batches;
* GC is collected before and disabled during each timed batch: cyclic
  collections over the live three-cluster heap land as multi-ms pauses on
  whichever batch they hit;
* the artifact is the MEDIAN of per-batch paired ratios (batch k's
  disabled/record share a time window), with best-of throughput reported
  only for eyeballing absolute rates.
"""

from __future__ import annotations

import asyncio
import gc
import time

from .. import Client, tracing
from .routing_live import Echo, EchoActor, boot_echo_cluster


async def measure_tracing_overhead(
    *,
    n_servers: int = 2,
    n_workers: int = 32,
    requests_per_batch: int = 64,
    n_objects: int = 256,
    batches: int = 24,
    transport: str = "asyncio",
) -> dict:
    """A/B/C the RPC loop across the three observability configurations.

    Returns best-of msgs/sec per mode plus overheads vs ``disabled``
    (positive = slower) as median per-batch paired ratios, in percent.
    """
    import statistics

    modes = {
        "disabled": dict(metrics=False, sample_rate=0.0, sink=False),
        "record": dict(metrics=True, sample_rate=0.0, sink=False),
        "sampled": dict(metrics=True, sample_rate=1.0, sink=True),
    }
    sunk = [0]
    sink_fn = lambda s: sunk.__setitem__(0, sunk[0] + 1)  # noqa: E731

    tracing.clear_sinks()
    tracing.set_sample_rate(0.0)
    clusters: dict[str, tuple] = {}  # name -> (client, tasks)
    rates: dict[str, list[float]] = {name: [] for name in modes}
    try:
        for name, cfg in modes.items():
            members, placement, tasks, servers = await boot_echo_cluster(
                n_servers,
                transport=transport,
                server_kwargs={"metrics": cfg["metrics"]},
            )
            # Seat object i on server i%N in EVERY cluster before first
            # touch: the provider's own (random) choice gives each boot a
            # different split across servers, and a skewed split shifts
            # per-connection pipelining enough to read as a durable
            # few-percent throughput difference between the clusters.
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
            clusters[name] = (client, tasks)
            # Warm untimed: placement, activation, connection pools, codec
            # caches — and one full-traffic pass per tracing config so
            # first-touch costs (span plumbing, histogram seating) never
            # land inside a timed batch.
            for i in range(n_objects):
                await client.send(EchoActor, f"w{i}", Echo(value=i), returns=Echo)

        async def batch(name: str) -> float:
            cfg = modes[name]
            client = clusters[name][0]
            tracing.set_sample_rate(cfg["sample_rate"])
            tracing.clear_sinks()
            if cfg["sink"]:
                tracing.add_sink(sink_fn)
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
                tracing.clear_sinks()
                tracing.set_sample_rate(0.0)
            return total / elapsed

        for name in modes:  # discarded warm batch per mode
            await batch(name)
        # Each enabled mode is paired against its OWN immediately-adjacent
        # disabled batch (sub-second apart, order alternating): box regimes
        # drift on a seconds timescale, so a ratio across two back-to-back
        # batches cancels what a round-robin over all modes would not.
        ratios: dict[str, list[float]] = {"record": [], "sampled": []}
        for k in range(batches):
            for name in ("record", "sampled"):
                if k % 2 == 0:
                    o = await batch("disabled")
                    r = await batch(name)
                else:
                    r = await batch(name)
                    o = await batch("disabled")
                rates["disabled"].append(o)
                rates[name].append(r)
                ratios[name].append(o / r - 1.0)
        if sunk[0] < batches * n_workers * requests_per_batch:
            raise RuntimeError(
                f"sink saw {sunk[0]} spans for "
                f"{batches * n_workers * requests_per_batch} sampled requests"
            )
    finally:
        tracing.clear_sinks()
        tracing.set_sample_rate(0.0)
        for client, tasks in clusters.values():
            client.close()
            for t in tasks:
                t.cancel()
        await asyncio.gather(
            *[t for _, tasks in clusters.values() for t in tasks],
            return_exceptions=True,
        )

    def overhead_pct(mode: str) -> float:
        return round(statistics.median(ratios[mode]) * 100.0, 2)

    return {
        "msgs_per_sec": {k: round(max(v), 1) for k, v in rates.items()},
        "record_overhead_pct": overhead_pct("record"),
        "sampled_overhead_pct": overhead_pct("sampled"),
        "n_requests_per_batch": n_workers * requests_per_batch,
        "batches": batches,
    }
