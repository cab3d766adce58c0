"""A live cluster persists to SQLite, stops, and boots again on the same files.

The restart story of a deployment on durable backends, measured end to end
on loopback. Three SQLite files in one directory hold what outlives a
node: ``members.db`` (:class:`SqliteMembershipStorage`), ``directory.db``
(the write-behind backing of a persistent device-solved directory,
:class:`SqliteObjectPlacement`) and ``state.db`` (:class:`SqliteState`, the
:class:`~rio_tpu_torch.utils.churn_live.DurableCounter` s' state).

* :func:`first_life` boots ``n_servers`` servers on the three files,
  allocates ``n_objects`` echo objects and ``n_counters`` durable counters
  (one acknowledged ``Add`` each) through a client, waits until the
  write-behind has written the whole directory, reads the file back through
  a second :class:`SqliteObjectPlacement`, then flushes once more and stops
  every server with an admin ``server_exit``.
* :func:`second_life` builds a fresh provider over the same files, times its
  ``prepare()`` (the whole directory restored from the file), boots
  ``n_servers`` fresh servers on ports the first life did not use, and
  checks the restart contract of ``tests/test_persistent_restart_e2e.py``:
  the restored count equals the flushed count before any traffic; the
  restored rows name only ghost addresses (the first life's); new ids seat
  on live servers only; sampled restored ids answer through the reactive
  re-seat (the owner is dead: clean its rows, self-assign); every counter
  reads back its acknowledged value.

Both take a :class:`Runtime`, the classes the scenario is built from: the
port's (:func:`port_runtime`) unless the caller hands in another with the
same surface, as the tests do with the reference's runtime.

The backing writes one row per ``update`` and commits each
(``ObjectPlacement.update_batch``'s default); the write tally times those
writes, so the result carries the seconds and microseconds a row.
"""

from __future__ import annotations

import asyncio
import dataclasses
import os
import random as _random
import socket
import time
from typing import Any, Callable

ALLOC_WAVE = 512  # concurrent sends per allocation wave, as routing_live's
SAMPLE_SEED = 0  # shuffles the restored ids the second life samples
EXIT_TIMEOUT_S = 30.0


@dataclasses.dataclass(frozen=True)
class Runtime:
    """The classes one run of the scenario is built from."""

    Server: type
    Client: type
    AppData: type
    LocalClusterProvider: type
    StateProvider: type
    ObjectId: type
    AdminCommand: type
    type_id: Callable[[type], str]
    SqliteMembershipStorage: type
    SqliteObjectPlacement: type
    SqliteState: type
    make_placement: Callable[[Any], Any]  # backing -> the persistent provider
    build_registry: Callable[[], Any]
    EchoActor: type
    Echo: type
    Counter: type
    Add: type
    Get: type
    Total: type


def port_runtime(device=None) -> Runtime:
    """The port's runtime over ``PersistentTorchObjectPlacement`` on ``device``
    (CUDA unless the caller asks for the CPU), with the provider's defaults."""
    from .. import AppData, Client, Server
    from ..cluster.membership_protocol import LocalClusterProvider
    from ..cluster.storage.sqlite import SqliteMembershipStorage
    from ..commands import AdminCommand
    from ..device import resolve_device
    from ..object_placement.persistent import PersistentTorchObjectPlacement
    from ..object_placement.sqlite import SqliteObjectPlacement
    from ..registry import ObjectId, type_id
    from ..state import StateProvider
    from ..state.sqlite import SqliteState
    from .churn_live import Add, DurableCounter, Get, Total, build_churn_registry
    from .routing_live import Echo, EchoActor

    dev = resolve_device(device)
    return Runtime(
        Server=Server, Client=Client, AppData=AppData, LocalClusterProvider=LocalClusterProvider,
        StateProvider=StateProvider, ObjectId=ObjectId, AdminCommand=AdminCommand, type_id=type_id,
        SqliteMembershipStorage=SqliteMembershipStorage,
        SqliteObjectPlacement=SqliteObjectPlacement, SqliteState=SqliteState,
        make_placement=lambda backing: PersistentTorchObjectPlacement(backing, device=dev),
        build_registry=build_churn_registry, EchoActor=EchoActor, Echo=Echo,
        Counter=DurableCounter, Add=Add, Get=Get, Total=Total,
    )


def paths(data_dir: str) -> dict[str, str]:
    return {name: os.path.join(data_dir, f"{name}.db") for name in ("members", "directory", "state")}


def file_bytes(path: str) -> int:
    """The database file and its write-ahead log, in bytes."""
    return sum(os.path.getsize(p) for p in (path, path + "-wal") if os.path.exists(p))


def _tally_writes(backing) -> dict:
    """Time every ``update_batch`` of ``backing``: rows, batches, seconds."""
    tally = {"rows": 0, "batches": 0, "s": 0.0}
    inner = backing.update_batch

    async def update_batch(items):
        t0 = time.perf_counter()
        try:
            await inner(items)
        finally:
            tally["s"] += time.perf_counter() - t0
        tally["rows"] += len(items)
        tally["batches"] += 1

    backing.update_batch = update_batch
    return tally


async def _in_waves(fn, keys: list[str]) -> list:
    out: list = []
    for base in range(0, len(keys), ALLOC_WAVE):
        out += await asyncio.gather(*[fn(k) for k in keys[base : base + ALLOC_WAVE]])
    return out


async def _drain(placement) -> int:
    """Flush until the write-behind holds nothing; the rows written."""
    rows = 0
    while True:
        rows += await placement.flush()
        if not placement._dirty:
            return rows


def _free_ports(n: int, exclude: set[int]) -> list[int]:
    """``n`` loopback ports free now and not in ``exclude``."""
    ports: list[int] = []
    while len(ports) < n:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        if port not in exclude and port not in ports:
            ports.append(port)
    return ports


async def _boot(rt: Runtime, n_servers: int, members, placement, state, exclude: set[str]):
    """Boot the servers on ports outside ``exclude``; (servers, run tasks)."""
    exclude_ports = {int(a.rpartition(":")[2]) for a in exclude}
    servers = []
    for port in _free_ports(n_servers, exclude_ports):
        app_data = rt.AppData()
        app_data.set(state, as_type=rt.StateProvider)
        s = rt.Server(
            address=f"127.0.0.1:{port}",
            registry=rt.build_registry(),
            cluster_provider=rt.LocalClusterProvider(members),
            object_placement_provider=placement,
            app_data=app_data,
        )
        await s.prepare()
        await s.bind()
        servers.append(s)
    tasks = [asyncio.create_task(s.run()) for s in servers]
    loop = asyncio.get_running_loop()
    deadline = loop.time() + 15.0
    while len(await members.active_members()) < n_servers:
        if loop.time() > deadline:
            raise TimeoutError(f"never saw {n_servers} active members")
        await asyncio.sleep(0.02)
    return servers, tasks


async def _stop(rt: Runtime, servers, tasks, placement, tally: dict) -> dict:
    """Flush, then stop every server with ``server_exit`` and wait for it.

    Returns the rows the pre-exit flush wrote, the rows the provider's
    closing flush wrote after the exit, the exit's seconds and whether
    every server exited before ``EXIT_TIMEOUT_S`` (the rest are cancelled)."""
    pre_exit_rows = await _drain(placement)
    t0 = time.perf_counter()
    for s in servers:
        s.admin_sender().send(rt.AdminCommand.server_exit())
    done, pending = await asyncio.wait(tasks, timeout=EXIT_TIMEOUT_S)
    exit_s = time.perf_counter() - t0
    for t in pending:
        t.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)
    for t in done:
        if not t.cancelled() and t.exception() is not None:
            raise t.exception()
    rows_before = tally["rows"]
    await placement.aclose()
    return {
        "pre_exit_flush_rows": pre_exit_rows,
        "closing_flush_rows": tally["rows"] - rows_before,
        "exit_s": exit_s,
        "exited_cleanly": not pending,
    }


async def _seats(rt: Runtime, placement, echo_ids: list[str], counter_ids: list[str]) -> dict:
    """Directory key -> the provider's address for every echo id and counter."""
    seats = {}
    for t, ids in ((rt.type_id(rt.EchoActor), echo_ids), (rt.type_id(rt.Counter), counter_ids)):
        for key in ids:
            seats[f"{t}.{key}"] = await placement.lookup(rt.ObjectId(t, key))
    return seats


def _hop_stats(hops: list[int]) -> dict:
    s = sorted(hops)
    n = len(s)
    return {"mean": sum(s) / n, "p99": float(s[min(n - 1, (n * 99) // 100)]), "max": s[-1], "n": n}


async def first_life(
    rt: Runtime, data_dir: str, *, n_servers: int = 8, n_objects: int = 100_000,
    n_counters: int = 8_192,
) -> dict:
    """Allocate, persist and stop; see the module docstring.

    Keys: ``n_servers``, ``addresses``, ``n_echo``, ``n_objects`` (echo and counters),
    ``alloc_s``, ``acked`` (counter id -> acknowledged value),
    ``flush_wait_s`` (the allocation's end to the write-behind drained),
    ``rows_written``, ``write_batches``, ``write_s`` and ``us_per_row`` (the
    backing's writes over the whole life up to the read-back),
    ``directory_rows``, ``file_rows``, ``rows_equal`` (the file's rows equal
    the directory, key for key), ``file_bytes``, ``directory_device`` (the
    provider's device, where it has one), then :func:`_stop`'s keys.
    """
    files = paths(data_dir)
    members = rt.SqliteMembershipStorage(files["members"])
    backing = rt.SqliteObjectPlacement(files["directory"])
    tally = _tally_writes(backing)
    placement = rt.make_placement(backing)
    state = rt.SqliteState(files["state"])
    await state.prepare()
    servers, tasks = await _boot(rt, n_servers, members, placement, state, exclude=set())
    try:
        echo_ids = [f"obj-{i}" for i in range(n_objects)]
        counter_ids = [f"ctr-{i}" for i in range(n_counters)]
        client = rt.Client(members)
        t0 = time.perf_counter()
        await _in_waves(lambda k: client.send(rt.EchoActor, k, rt.Echo(value=1), returns=rt.Echo), echo_ids)
        totals = await _in_waves(
            lambda k: client.send(rt.Counter, k, rt.Add(n=1), returns=rt.Total), counter_ids
        )
        t1 = time.perf_counter()
        client.close()
        await _drain(placement)
        flush_wait_s = time.perf_counter() - t1
        written = dict(tally)

        directory = await _seats(rt, placement, echo_ids, counter_ids)
        reader = rt.SqliteObjectPlacement(files["directory"])
        await reader.prepare()
        rows = {str(i.object_id): i.server_address for i in await reader.items()}
        reader.close()
        stop = await _stop(rt, servers, tasks, placement, tally)
    finally:
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        for store in (members, backing, state):
            store.close()
    return {
        "n_servers": n_servers,
        "addresses": [s.local_address for s in servers],
        "n_echo": n_objects,
        "n_objects": len(directory),
        "alloc_s": t1 - t0,
        "acked": {k: t.value for k, t in zip(counter_ids, totals)},
        "flush_wait_s": flush_wait_s,
        "rows_written": written["rows"],
        "write_batches": written["batches"],
        "write_s": written["s"],
        "us_per_row": written["s"] / written["rows"] * 1e6 if written["rows"] else float("nan"),
        "directory_device": str(getattr(placement, "device", None)),
        "directory_rows": placement.count(),
        "file_rows": len(rows),
        "rows_equal": rows == directory,
        "file_bytes": file_bytes(files["directory"]),
        **stop,
    }


async def second_life(
    rt: Runtime, data_dir: str, first: dict, *, n_servers: int = 8, n_new: int = 1_000,
    sample_size: int = 4_000,
) -> dict:
    """Restore, boot fresh servers and check the restart contract.

    ``first`` is :func:`first_life`'s result: its ``addresses`` are the
    ghosts, ``n_echo`` names the echo ids and ``acked`` the counters.

    Keys: ``n_servers``, ``restored``, ``restore_ms`` and
    ``restore_us_per_row`` (the first ``prepare()``), ``boot_s`` (the
    servers' boot; each ``Server.prepare`` runs the provider's ``prepare``
    again), ``restored_on_ghosts`` (restored rows whose address is a ghost)
    and ``restored_on_live``, ``new`` and ``new_on_ghosts``, ``hops``
    (mean, p99, max and n of the sampled restored ids; a hop is a completed
    round trip or a dial that failed), ``answered``, ``reseat_rows``,
    ``reseat_write_s`` and ``reseat_us_per_row`` (the rows this life wrote
    back, up to the drain after its traffic: the ghosts' rows the re-seat
    cleaned, the re-seated and the new; the backing's seconds in those
    writes), ``reseat_flush_wait_s`` (the traffic's end to the drain),
    ``counters`` (read back), ``lost`` (at most ten counters that read back
    wrong or from a ghost), ``live``, then :func:`_stop`'s keys.
    """
    acked, ghosts = first["acked"], first["addresses"]
    files = paths(data_dir)
    members = rt.SqliteMembershipStorage(files["members"])
    backing = rt.SqliteObjectPlacement(files["directory"])
    tally = _tally_writes(backing)
    placement = rt.make_placement(backing)
    state = rt.SqliteState(files["state"])
    await state.prepare()
    t0 = time.perf_counter()
    await placement.prepare()
    restore_s = time.perf_counter() - t0
    restored = placement.count()
    t0 = time.perf_counter()
    servers, tasks = await _boot(rt, n_servers, members, placement, state, exclude=set(ghosts))
    boot_s = time.perf_counter() - t0
    live = [s.local_address for s in servers]
    try:
        echo_t = rt.type_id(rt.EchoActor)
        echo_ids = [f"obj-{i}" for i in range(first["n_echo"])]
        seats = await _seats(rt, placement, echo_ids, list(acked))
        restored_on_ghosts = sum(a in ghosts for a in seats.values())
        restored_on_live = sum(a in live for a in seats.values())

        client = rt.Client(members)
        new_ids = [f"new-{i}" for i in range(n_new)]
        await _in_waves(lambda k: client.send(rt.EchoActor, k, rt.Echo(value=3), returns=rt.Echo), new_ids)
        new_seats = [await placement.lookup(rt.ObjectId(echo_t, k)) for k in new_ids]

        async def directory_resolver(handler_type: str, handler_id: str) -> str | None:
            return await placement.lookup(rt.ObjectId(handler_type, handler_id))

        sample = list(echo_ids)
        _random.Random(SAMPLE_SEED).shuffle(sample)
        sample = sample[:sample_size]
        hopper = rt.Client(members, placement_resolver=directory_resolver)
        hops, answered = [], 0
        for oid in sample:
            before = hopper.stats.roundtrips + hopper.stats.dial_failures
            out = await hopper.send(rt.EchoActor, oid, rt.Echo(value=2), returns=rt.Echo)
            hops.append(hopper.stats.roundtrips + hopper.stats.dial_failures - before)
            answered += int(out.value == 2)
        hopper.close()

        counter_ids = list(acked)
        readback = await _in_waves(
            lambda k: client.send(rt.Counter, k, rt.Get(), returns=rt.Total), counter_ids
        )
        client.close()
        lost = [
            (k, t.value, acked[k], t.address)
            for k, t in zip(counter_ids, readback)
            if t.value != acked[k] or t.address not in live
        ]
        t1 = time.perf_counter()
        await _drain(placement)
        reseat_s = time.perf_counter() - t1
        written = dict(tally)
        stop = await _stop(rt, servers, tasks, placement, tally)
    finally:
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        for store in (members, backing, state):
            store.close()
    return {
        "n_servers": n_servers,
        "restored": restored,
        "restore_ms": restore_s * 1e3,
        "restore_us_per_row": restore_s / restored * 1e6 if restored else float("nan"),
        "boot_s": boot_s,
        "restored_on_ghosts": restored_on_ghosts,
        "restored_on_live": restored_on_live,
        "new": len(new_ids),
        "new_on_ghosts": sum(a in ghosts for a in new_seats),
        "new_on_live": sum(a in live for a in new_seats),
        "hops": _hop_stats(hops),
        "answered": answered,
        "reseat_rows": written["rows"],
        "reseat_flush_wait_s": reseat_s,
        "reseat_write_s": written["s"],
        "reseat_us_per_row": written["s"] / written["rows"] * 1e6 if written["rows"] else float("nan"),
        "counters": len(readback),
        "lost": lost[:10],
        "live": live,
        **stop,
    }

