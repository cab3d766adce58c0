"""Measured request-waterfall span-retention overhead on the live RPC loop.

The span ring (``rio_tpu_torch/spans.py``) promises the request path pays
~nothing for waterfall retention when nothing upstream traces: the null
fast path is untouched, phase clocks attach only on a 1-in-8 stride of
untraced requests (plus every traced one), and retention itself is a few
attribute stores into a preallocated ring. This module *measures* that
promise with the ``series_live`` discipline — two cluster configurations,
identical traffic, one process:

* **off** — servers booted with ``spans=False``: no ring, no phase
  stamping, the transports' pre-waterfall paths byte-for-byte.
* **on** — retention enabled with head sampling OFF and tail capture
  ARMED at an aggressive SLO (default 1 ms — far below the shipping
  250 ms default), so the priced configuration actually exercises the
  stride, the phase stamps, AND the retention write, not just the
  disabled check.

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


async def measure_spans_overhead(
    *,
    n_servers: int = 2,
    n_workers: int = 32,
    requests_per_batch: int = 64,
    n_objects: int = 256,
    batches: int = 24,
    slo_ms: float = 1.0,
    transport: str = "asyncio",
) -> dict:
    """A/B the RPC loop with span retention off vs on (tail capture armed).

    Returns best-of msgs/sec per mode plus ``spans_overhead_pct`` (the
    median per-batch paired ratio of off/on, positive = slower) and the
    on-cluster's retention counters — ``tail_captured_on`` asserted > 0 so
    the A/B priced a cluster whose stride/SLO path actually retained
    spans, and the off-cluster is asserted ring-free so it is a real
    control.
    """
    import statistics

    modes = {"off": False, "on": True}
    clusters: dict[str, tuple] = {}  # name -> (client, tasks, servers)
    rates: dict[str, list[float]] = {name: [] for name in modes}
    try:
        for name, spans_on in modes.items():
            members, placement, tasks, servers = await boot_echo_cluster(
                n_servers,
                transport=transport,
                server_kwargs={
                    "spans": spans_on,
                    # A tight SLO keeps tail capture genuinely firing under
                    # batch concurrency (queueing alone crosses 1 ms), so
                    # the measured bar includes real retention writes.
                    "spans_slo_ms": slo_ms,
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
        retained = sum(s.spans.retained for s in on_servers)
        tail_captured = sum(s.spans.tail_captured for s in on_servers)
        if tail_captured <= 0:
            raise RuntimeError(
                "spans=True cluster tail-captured nothing — the A/B priced "
                "only the disabled check (SLO too high for this box?)"
            )
        off_servers = clusters["off"][2]
        if any(s.spans is not None for s in off_servers):
            raise RuntimeError("spans=False cluster still built a ring")
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
        "spans_overhead_pct": round(statistics.median(ratios) * 100.0, 2),
        "retained_on": int(retained),
        "tail_captured_on": int(tail_captured),
        "slo_ms": slo_ms,
        "n_requests_per_batch": n_workers * requests_per_batch,
        "batches": batches,
    }
