"""Measured migration drain on a live in-process cluster.

The A/B evidence for the batched actuation pipeline (``rio_tpu_torch.bench`` host
stage): boot two real servers on loopback — the :mod:`.routing_live`
harness shape — seat N stateful actors on one of them, each carrying a
volatile payload, then drain every seat to the other node through
``MigrationManager.apply_moves`` and report migrations/sec plus the
pinned-window distribution.

``measure_migration_drain`` runs the drain twice in the same process —
once with per-key actuation (burst size 1, no prefetch, no overlap: the
shape of the engine before batching) and once with the batched+prefetch
defaults — so the speedup ratio is anchored to one session's clock, the
same anchoring discipline as the rpc stage's in-session sqlite baseline.
A small throwaway drain warms codecs and the transport first so neither
measured mode pays first-use costs.

Every handoff here crossed a real TCP socket: pin, snapshot, install RPC,
directory flip — no simulation.
"""

from __future__ import annotations

import asyncio
import time

from .. import AppData, Client, LocalObjectPlacement, LocalStorage, Registry, Server
from .. import ServiceObject, handler, message
from ..cluster.membership_protocol import LocalClusterProvider
from ..commands import ServerInfo
from ..migration import MigrationConfig
from ..object_placement import ObjectPlacementItem
from ..registry import ObjectId, type_id


@message(name="migration_live.Warm")
class Warm:
    size: int = 0


@message(name="migration_live.Seen")
class Seen:
    address: str = ""


class DrainActor(ServiceObject):
    """Stateful actor whose volatile payload is the thing being moved."""

    def __init__(self):
        self.blob = b""

    def __migrate_state__(self):
        return {"blob": self.blob}

    def __restore_state__(self, value):
        self.blob = value["blob"]

    @handler
    async def warm(self, msg: Warm, ctx: AppData) -> Seen:
        # Per-object payload bytes: a cross-wired install would not
        # byte-compare equal against another object's snapshot.
        seed = self.id.encode() + b"\xa5"
        self.blob = (seed * (-(-msg.size // len(seed))))[: msg.size]
        return Seen(address=ctx.get(ServerInfo).address)


def per_key_config() -> MigrationConfig:
    """The pre-batching engine's shape: one key at a time, no prefetch."""
    return MigrationConfig(
        batch_size=1,
        per_node_inflight=1,
        global_inflight=1,
        handoff_concurrency=1,
        prefetch=False,
    )


async def _drain_once(
    n_objects: int,
    payload_bytes: int,
    config: MigrationConfig,
    *,
    transport: str = "asyncio",
) -> dict:
    """Boot a fresh 2-server cluster, seat+warm N actors on node 0, drain
    them all to node 1 under ``config``, and return the measured numbers.

    A fresh cluster per mode keeps the stats deltas and the directory
    state of the two measured drains independent.
    """
    members = LocalStorage()
    placement = LocalObjectPlacement()
    servers: list[Server] = []
    tasks: list[asyncio.Task] = []
    try:
        for _ in range(2):
            s = Server(
                address="127.0.0.1:0",
                registry=Registry().add_type(DrainActor),
                cluster_provider=LocalClusterProvider(members),
                object_placement_provider=placement,
                transport=transport,
                migration_config=config,
            )
            await s.prepare()
            await s.bind()
            servers.append(s)
        tasks = [asyncio.create_task(s.run()) for s in servers]
        deadline = asyncio.get_event_loop().time() + 10.0
        while asyncio.get_event_loop().time() < deadline:
            if len(await members.active_members()) >= 2:
                break
            await asyncio.sleep(0.02)
        src, dst = servers[0], servers[1]
        tname = type_id(DrainActor)
        keys = [f"d{i}" for i in range(n_objects)]
        # Seat every key on the source up front (the directory is
        # authoritative: first touch activates there), then warm them all
        # so each carries a live volatile payload worth migrating.
        for k in keys:
            await placement.update(
                ObjectPlacementItem(ObjectId(tname, k), src.local_address)
            )
        client = Client(members)
        try:
            gate = asyncio.Semaphore(64)

            async def warm(k: str) -> None:
                async with gate:
                    out = await client.send(
                        DrainActor, k, Warm(size=payload_bytes), returns=Seen
                    )
                    assert out.address == src.local_address, (k, out.address)

            await asyncio.gather(*(warm(k) for k in keys))

            stats = src.migration_manager.stats
            before_ms, before_windows = stats.pinned_ms_total, stats.pinned_windows
            moves = [(f"{tname}.{k}", src.local_address, dst.local_address) for k in keys]
            t0 = time.perf_counter()
            moved = await src.migration_manager.apply_moves(moves)
            dt = time.perf_counter() - t0
            windows = stats.pinned_windows - before_windows
            pinned_ms = stats.pinned_ms_total - before_ms
            return {
                "moved": moved,
                "seconds": round(dt, 3),
                "migrations_per_sec": round(moved / dt, 1) if dt > 0 else 0.0,
                "pinned_ms_mean": round(pinned_ms / windows, 4) if windows else None,
                "pinned_ms_max": round(stats.pinned_ms_max, 3),
                "bursts": stats.batches,
                "prefetch_hits": stats.prefetch_hits,
                "prefetch_misses": stats.prefetch_misses,
                "state_bytes": stats.state_bytes,
            }
        finally:
            client.close()
    finally:
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)


async def measure_migration_drain(
    n_objects: int = 1000,
    payload_bytes: int = 1024,
    *,
    transport: str = "asyncio",
) -> dict:
    """Per-key vs batched+prefetch drain of ``n_objects``, same session."""
    # Throwaway warm-up: codec schema caches, transport pools, first-GC.
    await _drain_once(16, payload_bytes, MigrationConfig(), transport=transport)
    per_key = await _drain_once(
        n_objects, payload_bytes, per_key_config(), transport=transport
    )
    batched = await _drain_once(
        n_objects, payload_bytes, MigrationConfig(), transport=transport
    )
    out: dict = {
        "n_objects": n_objects,
        "payload_bytes": payload_bytes,
        "per_key": per_key,
        "batched": batched,
    }
    if per_key["migrations_per_sec"]:
        out["speedup"] = round(
            batched["migrations_per_sec"] / per_key["migrations_per_sec"], 2
        )
    if per_key["pinned_ms_mean"] and batched["pinned_ms_mean"]:
        out["pinned_window_ratio"] = round(
            batched["pinned_ms_mean"] / per_key["pinned_ms_mean"], 3
        )
    return out
