"""Measured route hops on a live in-process cluster.

The numpy model in :mod:`rio_tpu_torch.utils.routing_sim` *estimates* the
BASELINE route-hop headline; this module *measures* it: boot N real
servers on ephemeral loopback ports inside one event loop (the reference's
integration harness shape, ``rio-rs/tests/client_server_integration_test.rs:
153-180`` / ``tests/server_utils.rs:49-139``), pre-allocate a population of
objects, then drive one cold-cache request per object under each routing
policy and count actual network round trips via :class:`rio_tpu_torch.client.
ClientStats`:

* **reference policy** — random active server on placement-cache miss
  (``client/mod.rs:255-262``); a wrong pick costs a real ``Redirect``
  response plus a second round trip.
* **rio-tpu policy** — ``placement_resolver`` pointed at the shared
  placement directory (the :class:`JaxObjectPlacement` host mirror in
  production); the owner is dialed directly.

Every hop counted here crossed a real TCP socket and the full
encode/dispatch/decode path — no simulation.
"""

from __future__ import annotations

import asyncio
import random as _random
from dataclasses import dataclass

from .. import AppData, Client, LocalObjectPlacement, LocalStorage, Registry, Server
from .. import ServiceObject, handler, message
from ..cluster.membership_protocol import LocalClusterProvider
from ..registry import ObjectId, type_id


@message(name="routing_live.Echo")
class Echo:
    value: int = 0


class EchoActor(ServiceObject):
    """Minimal actor: the request path is the thing under test."""

    @handler
    async def echo(self, msg: Echo, ctx: AppData) -> Echo:
        return msg


def build_echo_registry() -> Registry:
    """Factory spec target for sharded workers / bench children
    (``rio_tpu_torch.utils.routing_live:build_echo_registry``)."""
    return Registry().add_type(EchoActor)


@dataclass
class LiveHopStats:
    mean: float
    p50: float
    p99: float
    n_requests: int

    def as_dict(self) -> dict:
        return {
            "mean": round(self.mean, 3),
            "p50": self.p50,
            "p99": self.p99,
            "n": self.n_requests,
        }


def _stats(hops: list[int]) -> LiveHopStats:
    s = sorted(hops)
    n = len(s)
    return LiveHopStats(
        mean=sum(s) / n,
        p50=float(s[n // 2]),
        p99=float(s[min(n - 1, (n * 99) // 100)]),
        n_requests=n,
    )


async def boot_echo_cluster(
    n_servers: int,
    *,
    transport: str = "asyncio",
    members=None,
    placement=None,
    server_kwargs: dict | None = None,
):
    """Boot N echo servers on loopback.

    Returns ``(members, placement, tasks, servers)``. Shared helper for the
    measured benchmarks (route hops, RPC throughput). Callers cancel the
    returned tasks to tear the cluster down. ``server_kwargs`` are forwarded
    to every :class:`Server` (the tracing A/B boots with ``metrics=False``
    to reconstruct the pre-metrics hot path); ``members``/``placement``
    substitute the storage backends (the faults A/B boots over idle
    fault-injection wrappers).
    """
    members = members if members is not None else LocalStorage()
    placement = placement if placement is not None else LocalObjectPlacement()
    servers: list[Server] = []
    tasks: list[asyncio.Task] = []
    try:
        for _ in range(n_servers):
            s = Server(
                address="127.0.0.1:0",
                registry=build_echo_registry(),
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
        # Boot failed or was cancelled mid-wait: never leak running
        # server tasks (the caller's finally hasn't been entered yet).
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        raise
    return members, placement, tasks, servers


async def measure_route_hops_live(
    *,
    n_servers: int = 8,
    n_objects: int = 1024,
    seed: int = 0,
    transport: str = "asyncio",
    placement=None,
    sample_size: int | None = None,
) -> dict[str, LiveHopStats]:
    """Boot a cluster, measure per-request hops under both client policies.

    Returns ``{"reference": LiveHopStats, "rio_tpu": LiveHopStats}``. Each
    sampled object is requested once per policy with a cold placement LRU,
    so every request exercises the cache-miss routing decision — the case
    the policies differ on. Pass ``placement`` (e.g. a TorchObjectPlacement)
    to run the cluster on a specific provider; allocation is concurrent,
    hop measurement sequential over ``sample_size`` (default: all) ids.
    """
    members, placement, tasks, _servers = await boot_echo_cluster(
        n_servers, transport=transport, placement=placement
    )
    try:
        ids = [f"obj-{i}" for i in range(n_objects)]
        # Warm-up pass: allocate every object somewhere (random landing →
        # near-uniform spread, like organic traffic would produce).
        setup = Client(members)
        for base in range(0, n_objects, 512):
            await asyncio.gather(
                *[
                    setup.send(EchoActor, oid, Echo(value=1), returns=Echo)
                    for oid in ids[base : base + 512]
                ]
            )
        setup.close()

        async def directory_resolver(handler_type: str, handler_id: str) -> str | None:
            return await placement.lookup(ObjectId(handler_type, handler_id))

        sample = list(ids)
        _random.Random(seed).shuffle(sample)
        if sample_size is not None:
            sample = sample[:sample_size]

        async def run_policy(resolver) -> LiveHopStats:
            client = Client(members, placement_resolver=resolver)
            hops: list[int] = []
            for oid in sample:
                before = client.stats.roundtrips
                await client.send(EchoActor, oid, Echo(value=2), returns=Echo)
                hops.append(client.stats.roundtrips - before)
            client.close()
            return _stats(hops)

        reference = await run_policy(None)
        ours = await run_policy(directory_resolver)
        return {"reference": reference, "rio_tpu": ours}
    finally:
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)


async def measure_route_hops_scaled(
    *,
    n_servers: int = 64,
    n_objects: int = 50_000,
    wrong_fraction: float = 0.08,
    dead_servers: int = 4,
    seed: int = 0,
    sample_size: int = 8_000,
) -> dict:
    """Large-scale live routing evidence, including graceful degradation.

    Boots ``n_servers`` real servers, allocates ``n_objects`` actors, then
    measures per-request roundtrips (exact, sequential, over a shuffled
    ``sample_size`` sample of the live population) under three policies:

    * ``reference`` — random pick on cache miss (the reference policy,
      ``client/mod.rs:255-262``);
    * ``directory`` — fresh shared-directory resolver (rio-tpu policy);
    * ``stale``     — the SAME directory policy fed a frozen snapshot
      poisoned two ways: ``wrong_fraction`` of entries point at the wrong
      (live) node, and every object owned by ``dead_servers`` killed nodes
      still points at its dead address. This is the claim BASELINE rows
      1-2 actually make: a stale directory must degrade to redirects and
      dial-failure fallback (bounded extra hops), never to failed requests.

    Returns ``{"reference"|"directory"|"stale": LiveHopStats-as-dict,
    "stale_failures": int, "n_servers": int, "n_objects": int,
    "displaced": int, "wrong": int}``.
    """
    members, placement, tasks, servers = await boot_echo_cluster(n_servers)
    rng = _random.Random(seed)
    try:
        ids = [f"obj-{i}" for i in range(n_objects)]
        setup = Client(members)
        # Allocate the population concurrently (placement + activation out
        # of the measured region).
        for base in range(0, n_objects, 512):
            await asyncio.gather(
                *[
                    setup.send(EchoActor, oid, Echo(value=1), returns=Echo)
                    for oid in ids[base : base + 512]
                ]
            )
        setup.close()

        tname = type_id(EchoActor)
        addresses = [await placement.lookup(ObjectId(tname, oid)) for oid in ids]
        snapshot = {o: a for o, a in zip(ids, addresses) if a is not None}

        async def measure_seq(resolver, sample: list[str]) -> tuple[LiveHopStats, int]:
            client = Client(members, placement_resolver=resolver)
            hops: list[int] = []
            failures = 0
            for oid in sample:
                # A "hop" is any network attempt: completed roundtrips plus
                # dials that died on a dead address (the stale-directory
                # cost would be invisible without them).
                before = client.stats.roundtrips + client.stats.dial_failures
                try:
                    await client.send(EchoActor, oid, Echo(value=2), returns=Echo)
                    hops.append(
                        client.stats.roundtrips + client.stats.dial_failures - before
                    )
                except Exception:
                    failures += 1
            client.close()
            return _stats(hops) if hops else _stats([0]), failures

        sample = list(ids)
        rng.shuffle(sample)
        sample = sample[: min(n_objects, sample_size)]

        reference, _ = await measure_seq(None, sample)

        async def fresh_resolver(handler_type: str, handler_id: str) -> str | None:
            return await placement.lookup(ObjectId(handler_type, handler_id))

        directory, _ = await measure_seq(fresh_resolver, sample)

        # ---- staleness: kill nodes + poison the frozen snapshot ---------
        live_addrs = sorted(snapshot.values())
        victims = {s.local_address for s in servers[:dead_servers]}
        displaced = [o for o, a in snapshot.items() if a in victims]
        pool = sorted(set(live_addrs) - victims)
        n_wrong = int(len(snapshot) * wrong_fraction)
        wrong = 0
        for oid in rng.sample(ids, n_wrong):
            cur = snapshot.get(oid)
            others = [a for a in pool if a != cur]
            if cur is not None and cur not in victims and others:
                snapshot[oid] = rng.choice(others)
                wrong += 1

        # Kill the victims for real; mark them dead in membership (the
        # LocalClusterProvider has no failure detector) and let the REACTIVE
        # path re-materialize their objects on first touch — the stale run
        # below is that first touch for most of them.
        for srv, task in zip(servers, tasks):
            if srv.local_address in victims:
                task.cancel()
        await asyncio.gather(
            *[t for s, t in zip(servers, tasks) if s.local_address in victims],
            return_exceptions=True,
        )
        for v in victims:
            host, _, port = v.rpartition(":")
            await members.set_inactive(host, int(port))

        async def stale_resolver(handler_type: str, handler_id: str) -> str | None:
            return snapshot.get(handler_id)

        stale, stale_failures = await measure_seq(stale_resolver, sample)

        return {
            "reference": reference.as_dict(),
            "directory": directory.as_dict(),
            "stale": stale.as_dict(),
            "stale_failures": stale_failures,
            "n_servers": n_servers,
            "n_objects": n_objects,
            "dead_servers": dead_servers,
            "displaced": len(displaced),
            "wrong": wrong,
        }
    finally:
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)


async def measure_rpc_throughput(
    *,
    n_servers: int = 2,
    n_workers: int = 64,
    requests_per_worker: int = 400,
    n_objects: int = 1024,
    transport: str = "asyncio",
) -> float:
    """Messages/sec through the full actor data plane (real TCP loopback).

    ``n_workers`` concurrent senders share one client (per-address
    connection pool) and round-robin over ``n_objects`` actors — the shape
    of the reference's only load artifact, the metric-aggregator 20k-send
    driver (``metric_aggregator_loadall.rs:26-37``), but concurrent.
    ``transport`` selects the asyncio or the native (C++ epoll) data plane
    on both servers and client.
    """
    members, _placement, tasks, _servers = await boot_echo_cluster(
        n_servers, transport=transport
    )
    client = Client(members, transport=transport)
    try:
        return await _drive_echo_load(
            client, n_workers, requests_per_worker, n_objects
        )
    finally:
        client.close()
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)


async def _drive_echo_load(
    client, n_workers: int, requests_per_worker: int, n_objects: int
) -> float:
    """Warm the echo population, then one timed concurrent window."""
    import time

    for i in range(n_objects):
        await client.send(EchoActor, f"w{i}", Echo(value=i), returns=Echo)
    total = n_workers * requests_per_worker

    async def worker(w: int) -> None:
        for r in range(requests_per_worker):
            oid = f"w{(w * requests_per_worker + r) % n_objects}"
            await client.send(EchoActor, oid, Echo(value=r), returns=Echo)

    t0 = time.perf_counter()
    await asyncio.gather(*[worker(w) for w in range(n_workers)])
    return total / (time.perf_counter() - t0)


async def measure_rpc_external(
    members,
    *,
    n_workers: int = 64,
    requests_per_worker: int = 400,
    n_objects: int = 512,
    transport: str = "asyncio",
) -> float:
    """Messages/sec against an EXTERNAL cluster (servers in other
    processes, e.g. a :class:`rio_tpu_torch.sharded.ShardedServer`): same load
    shape as :func:`measure_rpc_throughput`, but this process runs only
    the client side. ``members`` is the shared membership view (e.g. the
    sharded node's sqlite storage)."""
    client = Client(members, transport=transport)
    try:
        return await _drive_echo_load(
            client, n_workers, requests_per_worker, n_objects
        )
    finally:
        client.close()
