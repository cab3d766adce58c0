"""qos: tenants, priorities, deadlines, and weighted-fair dispatch.

The QoS scheduler (``rio_tpu_torch/qos``, opt-in via ``Server(qos_config=...)``)
sits between frame decode and handler dispatch. This demo prices its
promise on a live 2-node cluster:

1. **the flood** — a ``bulk`` tenant hammers ONE hot actor from 24
   workers. Per-object serialized execution is the contention: each
   request holds the object's lock for its service time, so without QoS
   every arrival becomes a ready handler task parked FIFO at the lock.
2. **the probe** — a ``frontend`` tenant sends strict-priority
   (``priority=2``) requests at the same hot object. OFF, each probe
   joins the FIFO behind the whole flood; ON
   (``QosConfig(max_concurrent=4)``), the scheduler caps concurrent
   starts, parks the rest of the flood in the weighted-fair ring, and
   the probe's tier takes the next grant — it waits behind at most the
   in-flight few. The demo asserts a >= 2x interactive p99 win and ZERO
   interactive sheds (the flood never costs the protected tenant a
   request).
3. **deadlines** — a ``bulk``-tenant request with a 5 ms budget parks at
   the tail of its own tenant's deep queue (the weighted-fair ring would
   grant any OTHER tenant quickly — that's the point of the ring),
   expires, and is dropped WITHOUT running the handler; the client's
   retry loop sees the spent budget and raises :class:`DeadlineExceeded`
   instead of fanning out doomed work.
4. **the operator view** — the ``DumpQos`` admin round trip (what
   ``python -m rio_tpu_torch.admin qos`` renders) scrapes per-(tenant, class)
   RED rows, shed/deadline-drop counters, and live queue depths from
   every node over the wire.

Run::

    python -m rio_tpu_torch.examples.qos
"""

import asyncio
import time


from rio_tpu_torch import (
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
from rio_tpu_torch.admin import scrape_qos
from rio_tpu_torch.cluster.membership_protocol import LocalClusterProvider
from rio_tpu_torch.errors import DeadlineExceeded
from rio_tpu_torch.qos import QosConfig

BULK_WORKERS = 24
PROBES = 40
SPIN_S = 0.002  # per-request hold on the hot object's lock


@message
class Burn:
    spin_s: float = 0.0


class BurnActor(ServiceObject):
    """Each request holds this object's serialized-execution lock for
    ``spin_s`` — a flood at one id is a FIFO queue every later arrival
    waits through."""

    @handler
    async def burn(self, msg: Burn, ctx: AppData) -> Burn:
        if msg.spin_s > 0:
            await asyncio.sleep(msg.spin_s)
        return msg


async def boot(qos_config: QosConfig | None):
    members = LocalStorage()
    placement = LocalObjectPlacement()
    servers: list[Server] = []
    for _ in range(2):
        s = Server(
            address="127.0.0.1:0",
            registry=Registry().add_type(BurnActor),
            cluster_provider=LocalClusterProvider(members),
            object_placement_provider=placement,
            **({"qos_config": qos_config} if qos_config is not None else {}),
        )
        await s.prepare()
        await s.bind()
        servers.append(s)
    tasks = [asyncio.create_task(s.run()) for s in servers]
    deadline = asyncio.get_event_loop().time() + 10.0
    while asyncio.get_event_loop().time() < deadline:
        if len(await members.active_members()) >= len(servers):
            break
        await asyncio.sleep(0.02)
    return members, tasks, servers


async def run_mode(name: str, qos_config: QosConfig | None) -> dict:
    """Flood the hot object, measure interactive probe latency."""
    members, tasks, servers = await boot(qos_config)
    bulk = Client(members, tenant="bulk")
    inter = Client(members, tenant="frontend", priority=2)
    stop = asyncio.Event()
    out: dict = {"name": name}
    try:
        # Seat the hot object first: placement is not the contention.
        await inter.send(BurnActor, "hot", Burn(spin_s=0.0), returns=Burn)

        async def flood(w: int) -> None:
            while not stop.is_set():
                try:
                    await bulk.send(
                        BurnActor, "hot", Burn(spin_s=SPIN_S), returns=Burn
                    )
                except Exception:
                    if stop.is_set():
                        return
                    await asyncio.sleep(SPIN_S)  # shed under flood is legal

        flood_tasks = [
            asyncio.create_task(flood(w)) for w in range(BULK_WORKERS)
        ]
        await asyncio.sleep(0.3)  # flood reaches steady state

        lat_ms: list[float] = []
        for _ in range(PROBES):
            t0 = time.perf_counter()
            await inter.send(BurnActor, "hot", Burn(spin_s=SPIN_S), returns=Burn)
            lat_ms.append((time.perf_counter() - t0) * 1000.0)
        lat_ms.sort()
        out["p50_ms"] = lat_ms[len(lat_ms) // 2]
        out["p99_ms"] = lat_ms[min(len(lat_ms) - 1, (len(lat_ms) * 99) // 100)]

        if qos_config is not None:
            # Deadline: 5 ms of budget can't clear the bulk tenant's own
            # ~50 ms queue backlog (any OTHER tenant would be granted
            # quickly by the fair ring — so the doomed request must ride
            # the flooding tenant). The server drops it parked, without
            # running the handler; the client refuses to retry on a
            # spent budget.
            try:
                await bulk.send(
                    BurnActor, "hot", Burn(spin_s=SPIN_S), returns=Burn,
                    deadline_ms=5,
                )
                out["deadline_raised"] = False
            except DeadlineExceeded:
                out["deadline_raised"] = True

            # The operator view: one DumpQos round trip per node — the
            # same table `python -m rio_tpu_torch.admin qos --nodes ...` prints.
            snapshots = await scrape_qos(inter, members)
            out["interactive_sheds"] = sum(
                s.interactive_sheds for s in snapshots
            )
            print(f"[admin] qos table ({len(snapshots)} nodes):")
            header = (
                f"  {'tenant':<10} {'class':<6} {'reqs':>6} {'sheds':>6} "
                f"{'ddrops':>7} {'avg_ms':>8} {'queue_ms':>9}"
            )
            for snap in sorted(snapshots, key=lambda s: s.address):
                print(
                    f"  {snap.address}: admitted={snap.admitted} "
                    f"sheds={snap.sheds} deadline_drops={snap.deadline_drops} "
                    f"queued={snap.queued}"
                )
                print(header)
                for r in snap.tenants:
                    print(
                        f"  {(r[0] or 'default'):<10} {r[1]:<6} {r[2]:>6} "
                        f"{r[6]:>6} {r[7]:>7} {r[4]:>8.2f} {r[5]:>9.2f}"
                    )
        stop.set()
        await asyncio.gather(*flood_tasks, return_exceptions=True)
    finally:
        stop.set()
        for c in (bulk, inter):
            c.close()
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
    return out


async def main() -> dict:
    off = await run_mode("off", None)
    print(
        f"[off]  interactive p50 {off['p50_ms']:.1f} ms, "
        f"p99 {off['p99_ms']:.1f} ms (probe parks behind the whole flood)"
    )
    on = await run_mode("on", QosConfig(max_concurrent=4))
    print(
        f"[on]   interactive p50 {on['p50_ms']:.1f} ms, "
        f"p99 {on['p99_ms']:.1f} ms (strict-priority tier overtakes the ring)"
    )
    ratio = off["p99_ms"] / max(on["p99_ms"], 1e-9)
    print(
        f"[qos]  p99 {ratio:.1f}x better with QoS on; "
        f"{on['interactive_sheds']} interactive sheds; "
        f"deadline raised={on['deadline_raised']}"
    )

    assert ratio >= 2.0, f"interactive p99 ratio {ratio:.2f} < 2x"
    assert on["interactive_sheds"] == 0, (
        f"{on['interactive_sheds']} interactive sheds under flood"
    )
    assert on["deadline_raised"], "5 ms deadline survived a ~48 ms queue"
    print("[demo] done")
    return {"off": off, "on": on, "ratio": ratio}


if __name__ == "__main__":
    asyncio.run(main())
