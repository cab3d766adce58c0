"""Measured hot-key read scale-out on a live in-process cluster.

The A/B evidence for the read-scale subsystem (``rio_tpu_torch.bench --hotkey`` host
stage): boot three real servers on loopback, seat a zipf-skewed keyspace
where ONE celebrity key draws ~30% of an open-loop request stream, and
drive the same workload twice in the same process — once reading through
the primary (the shape of the framework before ``@readonly`` routing) and
once with bounded-staleness replica reads enabled — so the hot-key p99
ratio is anchored to one session's clock, the same in-session anchoring
discipline as the rpc and migration stages.

Open loop on purpose: request launches follow the arrival clock, not the
completion of earlier requests, so queueing at the hot primary shows up as
latency (a closed loop would throttle itself and hide the very tail the
subsystem exists to bound). Per-object serialized execution is the
bottleneck being demonstrated — every read of the hot key runs on its
actor lock, so the primary's ceiling is ``1/work_s`` reads/sec while the
replica-read run fans the same stream across the standby seats.
"""

from __future__ import annotations

import asyncio
import random
import time

from .. import (
    AppData,
    Client,
    LocalObjectPlacement,
    LocalStorage,
    ReadScaleConfig,
    Registry,
    Server,
    ServiceObject,
    handler,
    message,
    readonly,
)
from ..cluster.membership_protocol import LocalClusterProvider
from ..commands import ServerInfo
from ..load import LoadThresholds
from ..replication import ReplicationConfig


@message(name="hotkey_live.Bump")
class Bump:
    amount: int = 1


@message(name="hotkey_live.ReadProfile")
class ReadProfile:
    work_s: float = 0.0


@message(name="hotkey_live.Snap")
class Snap:
    version: int = 0
    address: str = ""


class Profile(ServiceObject):
    """Replicated celebrity actor: one version counter, read-heavy."""

    __replicated__ = True

    def __init__(self):
        self.version = 0

    def __migrate_state__(self):
        return {"version": self.version}

    def __restore_state__(self, value):
        self.version = int(value["version"])

    @handler
    async def bump(self, msg: Bump, ctx: AppData) -> Snap:
        self.version += msg.amount
        return Snap(version=self.version, address=ctx.get(ServerInfo).address)

    @readonly
    @handler
    async def read(self, msg: ReadProfile, ctx: AppData) -> Snap:
        # Emulated per-read work (feature extraction, render, ...): the
        # sleep yields the shared loop, so three in-process "nodes" really
        # do overlap — exactly what makes fan-out measurable here.
        if msg.work_s > 0:
            await asyncio.sleep(msg.work_s)
        return Snap(version=self.version, address=ctx.get(ServerInfo).address)


def _percentile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[idx]


def zipf_keys(
    n_keys: int, n_requests: int, hot_fraction: float, seed: int
) -> list[int]:
    """Key index per request: key 0 draws ``hot_fraction`` of the stream,
    the rest follow a 1/rank zipf tail — deterministic under ``seed`` so
    both measured modes replay the identical arrival sequence."""
    rng = random.Random(seed)
    tail = [1.0 / rank for rank in range(1, n_keys)]
    tail_total = sum(tail) or 1.0
    weights = [hot_fraction] + [
        (1.0 - hot_fraction) * w / tail_total for w in tail
    ]
    return rng.choices(range(n_keys), weights=weights, k=n_requests)


async def _run_once(
    *,
    replica_reads: bool,
    n_keys: int,
    n_requests: int,
    rate: float,
    hot_fraction: float,
    work_s: float,
    write_fraction: float,
    seed: int,
    max_inflight: int = 12,
    transport: str = "asyncio",
) -> dict:
    """Boot a fresh 3-node cluster, replay the seeded zipf stream open-loop,
    and return the latency distribution plus the subsystem counters."""
    members = LocalStorage()
    placement = LocalObjectPlacement()
    servers: list[Server] = []
    tasks: list[asyncio.Task] = []
    read_cfg = ReadScaleConfig(max_staleness_s=2.0, max_lag_seq=4)
    try:
        for _ in range(3):
            s = Server(
                address="127.0.0.1:0",
                registry=Registry().add_type(Profile),
                cluster_provider=LocalClusterProvider(members),
                object_placement_provider=placement,
                transport=transport,
                replication_config=ReplicationConfig(
                    k=2, anti_entropy_interval=0.2
                ),
                read_scale_config=read_cfg if replica_reads else None,
                load_thresholds=LoadThresholds(max_inflight=max_inflight),
            )
            await s.prepare()
            await s.bind()
            servers.append(s)
        tasks = [asyncio.create_task(s.run()) for s in servers]
        deadline = asyncio.get_event_loop().time() + 10.0
        while asyncio.get_event_loop().time() < deadline:
            if len(await members.active_members()) >= 3:
                break
            await asyncio.sleep(0.02)

        client = Client(members, read_scale=read_cfg if replica_reads else None)
        try:
            keys = [f"p{i}" for i in range(n_keys)]
            # Every acked write to the hot key, timestamped: the staleness
            # audit's ground truth for which version a later read MUST see.
            hot_acks: list[tuple[float, int]] = []
            hot_read_log: list[tuple[float, int]] = []
            # Warm every key with one write: activates it somewhere, seats
            # its standbys (ship-on-ack + ensure_seats), fills codec caches.
            for k in keys:
                warm = await client.send(Profile, k, Bump(amount=1), returns=Snap)
                if k == keys[0]:
                    hot_acks.append((time.perf_counter(), warm.version))
            # Let one anti-entropy/refresh round land so standby freshness
            # is inside the bound before the measured stream starts.
            await asyncio.sleep(0.3)

            sequence = zipf_keys(n_keys, n_requests, hot_fraction, seed)
            write_rng = random.Random(seed + 1)
            writes = [write_rng.random() < write_fraction for _ in sequence]
            lat: list[tuple[int, bool, float]] = []  # (key, is_read, seconds)
            served_by: dict[str, int] = {}

            async def one(i: int, key_idx: int, is_write: bool) -> None:
                t0 = time.perf_counter()
                if is_write:
                    out = await client.send(
                        Profile, keys[key_idx], Bump(amount=1), returns=Snap
                    )
                    if key_idx == 0:
                        hot_acks.append((time.perf_counter(), out.version))
                else:
                    out = await client.send(
                        Profile,
                        keys[key_idx],
                        ReadProfile(work_s=work_s),
                        returns=Snap,
                    )
                    if key_idx == 0:
                        served_by[out.address] = served_by.get(out.address, 0) + 1
                        hot_read_log.append((t0, out.version))
                lat.append((key_idx, not is_write, time.perf_counter() - t0))

            interarrival = 1.0 / rate
            start = time.perf_counter()
            inflight: list[asyncio.Task] = []
            for i, (key_idx, is_write) in enumerate(zip(sequence, writes)):
                delay = start + i * interarrival - time.perf_counter()
                if delay > 0:
                    await asyncio.sleep(delay)
                inflight.append(asyncio.create_task(one(i, key_idx, is_write)))
            await asyncio.gather(*inflight)
            wall = time.perf_counter() - start

            reads = sorted(s for _, is_read, s in lat if is_read)
            hot_reads = sorted(s for k, is_read, s in lat if is_read and k == 0)

            # Staleness audit against the contract: a read LAUNCHED at t may
            # return a version no smaller than (newest version acked at
            # least `bound` earlier) - max_lag_seq. `bound` grants the full
            # staleness budget plus one refresh period plus scheduling
            # slack — ship-on-ack keeps replicas far inside it, so any
            # violation here is a broken freshness gate, not bad luck.
            refresh = read_cfg.refresh_interval or read_cfg.max_staleness_s / 3.0
            bound = read_cfg.max_staleness_s + refresh + 0.5
            hot_acks.sort()
            violations = 0
            for t_read, version in hot_read_log:
                floor = 0
                for t_ack, acked_version in hot_acks:
                    if t_ack > t_read - bound:
                        break
                    floor = acked_version
                if version < floor - read_cfg.max_lag_seq:
                    violations += 1
            rs_stats: dict[str, int] = {}
            for s in servers:
                mgr = s.read_scale_manager
                if mgr is None:
                    continue
                for name in (
                    "standby_reads",
                    "standby_forwards",
                    "read_sheds",
                    "stale_refusals",
                ):
                    rs_stats[name] = rs_stats.get(name, 0) + getattr(
                        mgr.stats, name
                    )
            return {
                "requests": len(lat),
                "seconds": round(wall, 3),
                "read_p50_ms": round(_percentile(reads, 0.50) * 1e3, 3),
                "read_p99_ms": round(_percentile(reads, 0.99) * 1e3, 3),
                "hot_p50_ms": round(_percentile(hot_reads, 0.50) * 1e3, 3),
                "hot_p99_ms": round(_percentile(hot_reads, 0.99) * 1e3, 3),
                "hot_reads": len(hot_reads),
                "hot_writes": len(hot_acks),
                "staleness_violations": violations,
                "hot_served_by": dict(sorted(served_by.items())),
                "client_standby_routes": client.stats.standby_routes,
                "client_busy_retries": client.stats.busy_retries,
                **rs_stats,
            }
        finally:
            client.close()
    finally:
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)


async def measure_hotkey(
    n_keys: int = 48,
    n_requests: int = 1500,
    rate: float = 900.0,
    hot_fraction: float = 0.30,
    work_s: float = 0.005,
    write_fraction: float = 0.06,
    seed: int = 7,
    *,
    transport: str = "asyncio",
) -> dict:
    """Read-through-primary vs replica-reads under the SAME zipf stream.

    The hot key's arrival rate (``rate * hot_fraction``) is chosen above
    the primary's serialized read ceiling (``1/work_s``), so the baseline
    run queues on the actor lock and its tail grows with the run — the
    replica-read run bounds it by fanning across the standby seats.
    """
    # Throwaway warm-up cluster: codec schema caches, transport, first-GC.
    await _run_once(
        replica_reads=False,
        n_keys=8,
        n_requests=60,
        rate=rate,
        hot_fraction=hot_fraction,
        work_s=0.0,
        write_fraction=write_fraction,
        seed=seed,
        transport=transport,
    )
    common = dict(
        n_keys=n_keys,
        n_requests=n_requests,
        rate=rate,
        hot_fraction=hot_fraction,
        work_s=work_s,
        write_fraction=write_fraction,
        seed=seed,
        transport=transport,
    )
    baseline = await _run_once(replica_reads=False, **common)
    replica = await _run_once(replica_reads=True, **common)
    out: dict = {
        "n_keys": n_keys,
        "n_requests": n_requests,
        "rate_per_sec": rate,
        "hot_fraction": hot_fraction,
        "work_ms": work_s * 1e3,
        "baseline": baseline,
        "replica_reads": replica,
    }
    if baseline["hot_p99_ms"]:
        out["hot_p99_ratio"] = round(
            replica["hot_p99_ms"] / baseline["hot_p99_ms"], 3
        )
    return out
