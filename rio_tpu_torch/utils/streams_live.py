"""Measured throughput of the durable-stream data path on the live loop.

The streams subsystem (``rio_tpu_torch/streams/``) promises two things worth
pricing on a real cluster: a publish is acked only after the append hit
:class:`~rio_tpu_torch.streams.StreamStorage` (durability is on the request
path), and delivery is at-least-once with the reminder subsystem as the
redelivery backstop (missed wakes are caught by reminder fires). This
module measures both the same way ``faults_live`` prices its wrappers:
two cluster configurations, identical traffic, one process —

* **off** — the backstop idle: no :class:`ReminderStorage` in AppData, no
  reminder daemon; delivery rides the publish-time cursor wake alone;
* **on** — the backstop ticking hard: the reminder daemon polls at
  0.05 s and every partition's redelivery reminder fires at 0.05 s (a
  40x harder cadence than the shipping 2 s default), so each timed batch
  pays the full at-least-once machinery while the same publishes flow.

The measurement discipline is inherited from ``tracing_live``: both
clusters boot once and coexist, GC is collected before and disabled
during each timed batch, batches interleave in alternating order, and
the headline is the MEDIAN of per-batch paired off/on ratios on the
end-to-end (publish → every record committed-after-delivery) rate. The
acked-publish rate is reported per mode too — that is the producer-facing
durability cost, independent of consumption.
"""

from __future__ import annotations

import asyncio
import gc
import time

from .. import (
    AppData,
    Client,
    LocalObjectPlacement,
    LocalReminderStorage,
    LocalStorage,
    ReminderDaemonConfig,
    ReminderStorage,
    Server,
)
from ..cluster.membership_protocol import LocalClusterProvider
from ..state import LocalState, StateProvider
from ..streams import LocalStreamStorage, StreamStorage
from .routing_live import Echo, EchoActor, build_echo_registry

STREAM = "bench-orders"
GROUP = "bench-sink"


async def measure_streams_overhead(
    *,
    n_servers: int = 2,
    publishes_per_batch: int = 96,
    batches: int = 12,
    n_keys: int = 16,
    transport: str = "asyncio",
) -> dict:
    """A/B the stream data path with the redelivery backstop idle vs ticking.

    Returns best-of acked-publish and end-to-end deliver rates per mode
    plus ``redelivery_overhead_pct`` (median per-batch paired off/on
    ratio on the end-to-end rate, positive = the ticking backstop is
    slower). Both modes must deliver every acked publish — the zero-loss
    check rides along with the throughput number.
    """
    import statistics

    modes = {
        "off": {"daemon": False, "period": 3600.0},
        "on": {"daemon": True, "period": 0.05},
    }
    # name -> (client, tasks, storage)
    clusters: dict[str, tuple] = {}
    pub_rates: dict[str, list[float]] = {m: [] for m in modes}
    e2e_rates: dict[str, list[float]] = {m: [] for m in modes}
    published: dict[str, int] = {m: 0 for m in modes}
    all_tasks: list[asyncio.Task] = []
    try:
        for name, cfg in modes.items():
            storage = LocalStreamStorage()
            state = LocalState()
            members = LocalStorage()
            placement = LocalObjectPlacement()
            reminders = LocalReminderStorage() if cfg["daemon"] else None
            tasks: list[asyncio.Task] = []
            for _ in range(n_servers):
                ad = AppData().set(storage, as_type=StreamStorage)
                ad.set(state, as_type=StateProvider)
                server_kwargs: dict = {}
                if reminders is not None:
                    ad.set(reminders, as_type=ReminderStorage)
                    server_kwargs = {
                        "reminder_daemon": True,
                        "reminder_daemon_config": ReminderDaemonConfig(
                            poll_interval=0.05, lease_ttl=2.0
                        ),
                    }
                s = Server(
                    address="127.0.0.1:0",
                    registry=build_echo_registry(),
                    cluster_provider=LocalClusterProvider(members),
                    object_placement_provider=placement,
                    transport=transport,
                    app_data=ad,
                    **server_kwargs,
                )
                await s.prepare()
                await s.bind()
                tasks.append(asyncio.create_task(s.run()))
            all_tasks.extend(tasks)
            deadline = asyncio.get_event_loop().time() + 10.0
            while asyncio.get_event_loop().time() < deadline:
                if len(await members.active_members()) >= n_servers:
                    break
                await asyncio.sleep(0.02)
            client = Client(members, transport=transport)
            await client.subscribe_stream(
                STREAM, GROUP, EchoActor, redelivery_period=cfg["period"]
            )
            clusters[name] = (client, tasks, storage)

        async def batch(name: str) -> tuple[float, float]:
            client, _, storage = clusters[name]
            n = publishes_per_batch
            target = published[name] + n
            gc.collect()
            gc.disable()
            try:
                t0 = time.perf_counter()
                for i in range(n):
                    await client.publish_stream(
                        STREAM, Echo(value=i), key=f"k{i % n_keys}"
                    )
                t_acked = time.perf_counter()
                while sum((await storage.cursors(STREAM, GROUP)).values()) < target:
                    await asyncio.sleep(0.001)
                t_done = time.perf_counter()
            finally:
                gc.enable()
            published[name] = target
            return n / (t_acked - t0), n / (t_done - t0)

        for name in modes:  # discarded warm batch per mode
            await batch(name)
        ratios: list[float] = []
        for k in range(batches):
            if k % 2 == 0:
                po, eo = await batch("off")
                pr, er = await batch("on")
            else:
                pr, er = await batch("on")
                po, eo = await batch("off")
            pub_rates["off"].append(po)
            pub_rates["on"].append(pr)
            e2e_rates["off"].append(eo)
            e2e_rates["on"].append(er)
            ratios.append(eo / er - 1.0)

        # Zero-loss contract per mode: every acked publish is committed
        # behind a delivery (cursor sums count delivered-then-committed
        # records only).
        delivered: dict[str, int] = {}
        partitions: dict[str, int] = {}
        for name, (_, _, storage) in clusters.items():
            cur = await storage.cursors(STREAM, GROUP)
            delivered[name] = sum(cur.values())
            partitions[name] = len(cur)
            if delivered[name] != published[name]:
                raise RuntimeError(
                    f"{name}: {published[name]} acked publishes but only "
                    f"{delivered[name]} delivered+committed"
                )
    finally:
        for client, _, _ in clusters.values():
            client.close()
        for t in all_tasks:
            t.cancel()
        await asyncio.gather(*all_tasks, return_exceptions=True)

    return {
        "publish_acks_per_sec": {k: round(max(v), 1) for k, v in pub_rates.items()},
        "deliver_msgs_per_sec": {k: round(max(v), 1) for k, v in e2e_rates.items()},
        "redelivery_overhead_pct": round(statistics.median(ratios) * 100.0, 2),
        "delivered": delivered,
        "partitions_active": partitions,
        "publishes_per_batch": publishes_per_batch,
        "batches": batches,
    }
