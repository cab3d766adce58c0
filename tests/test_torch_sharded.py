"""The port's sharded data plane, held to the reference's scenarios.

Every scenario of ``tests/test_sharded.py`` but its slow chaos run, on
``rio_tpu_torch``: crc32 slicing, the router seam and its dead-owner
degrade, shard-aware clients, and real multi-process runs of the port's
:class:`rio_tpu_torch.sharded.ShardedServer` (worker OS processes, the
SO_REUSEPORT front door where available, shared sqlite membership and
placement) driven by the port's client. The golden-wire Redirect is also
held byte for byte against the reference's encoder, and each package's
client and load generator drive the other's sharded node through its
sqlite members file. The native library is built once in this process
before any worker boots, so no two workers build it at once.
"""

import asyncio
import contextlib
import socket
import sys
import zlib

import pytest

from rio_tpu_torch import (
    Client,
    LocalClusterProvider,
    LocalObjectPlacement,
    LocalStorage,
    Member,
    ObjectId,
    Server,
    ShardMap,
    ShardRouter,
    shard_of,
)
from rio_tpu_torch import codec
from rio_tpu_torch.admin import ADMIN_TYPE, DumpEvents, EventsSnapshot
from rio_tpu_torch.journal import merge_events
from rio_tpu_torch.migration import CONTROL_TYPE, MigrateObject, MigrationAck
from rio_tpu_torch.protocol import (
    ErrorKind,
    RequestEnvelope,
    ResponseEnvelope,
    ResponseError,
    encode_request_frame,
    encode_response_frame,
)
from rio_tpu_torch.registry import type_id
from rio_tpu_torch.sharded import ShardedServer, sqlite_members, sqlite_placement
from rio_tpu_torch.bench import prepare_node_storage
from rio_tpu_torch.utils.routing_live import Echo, EchoActor, build_echo_registry

from .torch_sharded_actors import Bump, Get, ShardCounter, Val

HAS_REUSEPORT = hasattr(socket, "SO_REUSEPORT")
COUNTER_REGISTRY = "tests.torch_sharded_actors:build_registry"


@pytest.fixture(scope="module", autouse=True)
def _native_built_once():
    # Workers and load generators each load the native library; build it
    # here first (both packages', for the cross-package cases).
    import rio_tpu.native
    import rio_tpu_torch.native

    rio_tpu_torch.native.get()
    rio_tpu.native.get()


# ----------------------------------------------------------------------
# Unit: the shard map
# ----------------------------------------------------------------------


def test_shard_of_is_pinned_and_stable():
    # Pinned values: the map is persisted implicitly in every directory row
    # a sharded node writes, so it must never drift across releases.
    assert shard_of("EchoActor", "a", 3) == 1
    assert shard_of("EchoActor", "b", 3) == 2
    assert shard_of("ShardCounter", "c-0", 3) == 0
    assert shard_of("T", "x", 7) == zlib.crc32(b"T/x") % 7
    # Deterministic, in range, and non-degenerate across a small population.
    for oid in ("a", "b", "zzz"):
        assert shard_of("EchoActor", oid, 4) == shard_of("EchoActor", oid, 4)
        assert 0 <= shard_of("EchoActor", oid, 4) < 4
    assert {shard_of("EchoActor", f"o{i}", 4) for i in range(64)} == {0, 1, 2, 3}


def test_shard_router_owner_follows_the_map():
    slots = ("h:1", "h:2", "h:3")
    router = ShardRouter(self_address="h:1", slots=slots)
    for oid in ("a", "b", "c", "zzz"):
        assert router.owner("EchoActor", oid) == slots[shard_of("EchoActor", oid, 3)]


# ----------------------------------------------------------------------
# In-process: the service-layer seam
# ----------------------------------------------------------------------


async def _boot_router_servers(addrs, slots, members, placement, advertise_map=""):
    """Boot one echo server per address with a ShardRouter installed."""
    servers, tasks = [], []
    try:
        for addr in addrs:
            provider = LocalClusterProvider(members)
            if advertise_map:
                provider.set_shard_map(advertise_map)
            s = Server(
                address=addr,
                registry=build_echo_registry(),
                cluster_provider=provider,
                object_placement_provider=placement,
            )
            # Before bind(): the Service snapshot of app_data happens there.
            s.app_data.set(ShardRouter(self_address=addr, slots=tuple(slots)))
            await s.prepare()
            await s.bind()
            servers.append(s)
        tasks = [asyncio.create_task(s.run()) for s in servers]
        deadline = asyncio.get_event_loop().time() + 10.0
        while asyncio.get_event_loop().time() < deadline:
            if len(await members.active_members()) >= len(addrs):
                break
            await asyncio.sleep(0.02)
    except BaseException:
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        raise
    return tasks


def _free_ports(n):
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def test_router_seam_seats_unplaced_objects_on_their_shard():
    async def drive():
        addrs = [f"127.0.0.1:{p}" for p in _free_ports(2)]
        members, placement = LocalStorage(), LocalObjectPlacement()
        tasks = await _boot_router_servers(addrs, addrs, members, placement)
        client = Client(members)
        try:
            tname = type_id(EchoActor)
            for i in range(24):
                out = await client.send(EchoActor, f"rt-{i}", Echo(value=i), returns=Echo)
                assert out.value == i
            for i in range(24):
                row = await placement.lookup(ObjectId(tname, f"rt-{i}"))
                assert row == addrs[shard_of(tname, f"rt-{i}", 2)], (i, row)
        finally:
            client.close()
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

    asyncio.run(drive())


def test_router_seam_degrades_when_preferred_owner_is_dead():
    """A slot that is not an active member must NOT black-hole its slice:
    the receiving worker falls through to lazy self-assign."""

    async def drive():
        addrs = [f"127.0.0.1:{p}" for p in _free_ports(1)]
        slots = (addrs[0], "127.0.0.1:1")  # slot 1 is nobody
        members, placement = LocalStorage(), LocalObjectPlacement()
        tasks = await _boot_router_servers(addrs, slots, members, placement)
        client = Client(members)
        try:
            tname = type_id(EchoActor)
            dead_oid = next(
                f"d-{i}" for i in range(100) if shard_of(tname, f"d-{i}", 2) == 1
            )
            out = await client.send(EchoActor, dead_oid, Echo(value=9), returns=Echo)
            assert out.value == 9
            assert await placement.lookup(ObjectId(tname, dead_oid)) == addrs[0]
        finally:
            client.close()
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

    asyncio.run(drive())


# ----------------------------------------------------------------------
# In-process: shard-aware clients
# ----------------------------------------------------------------------


def test_shard_aware_client_direct_dials_with_zero_redirects():
    """A shard-aware client adopts the map from the membership view and
    computes crc32 % N locally: every unplaced send dials the owning
    worker's identity address directly — zero redirects, and the directory
    rows land exactly where the server-side router would seat them."""

    async def drive():
        addrs = [f"127.0.0.1:{p}" for p in _free_ports(2)]
        members, placement = LocalStorage(), LocalObjectPlacement()
        encoded = ShardMap(epoch=1, slots=tuple(addrs)).encode()
        tasks = await _boot_router_servers(
            addrs, addrs, members, placement, advertise_map=encoded
        )
        client = Client(members, shard_aware=True)
        try:
            tname = type_id(EchoActor)
            for i in range(24):
                out = await client.send(EchoActor, f"sa-{i}", Echo(value=i), returns=Echo)
                assert out.value == i
            assert client.stats.redirects == 0
            assert client.stats.shard_routes == 24
            assert client._shard_map is not None and client._shard_map.epoch == 1
            for i in range(24):
                row = await placement.lookup(ObjectId(tname, f"sa-{i}"))
                assert row == addrs[shard_of(tname, f"sa-{i}", 2)], (i, row)
        finally:
            client.close()
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

    asyncio.run(drive())


def test_shard_aware_client_dead_owner_falls_back_to_redirect_follow():
    """A map slot that is not an active member must not black-hole its
    slice client-side either: the direct dial is skipped and the send
    degrades to the reference random-pick + redirect-follow path (the
    mirror of the server router's dead-owner lazy self-assign)."""

    async def drive():
        addrs = [f"127.0.0.1:{p}" for p in _free_ports(1)]
        slots = (addrs[0], "127.0.0.1:1")  # slot 1 is nobody
        members, placement = LocalStorage(), LocalObjectPlacement()
        encoded = ShardMap(epoch=1, slots=slots).encode()
        tasks = await _boot_router_servers(
            addrs, slots, members, placement, advertise_map=encoded
        )
        client = Client(members, shard_aware=True)
        try:
            tname = type_id(EchoActor)
            dead_oid = next(
                f"d-{i}" for i in range(100) if shard_of(tname, f"d-{i}", 2) == 1
            )
            out = await client.send(EchoActor, dead_oid, Echo(value=9), returns=Echo)
            assert out.value == 9
            assert await placement.lookup(ObjectId(tname, dead_oid)) == addrs[0]
            # The dead owner was never direct-dialed (it is not in the
            # active view), so the attempt cost zero dial failures.
            assert client.stats.dial_failures == 0
        finally:
            client.close()
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

    asyncio.run(drive())


def test_shard_aware_epoch_change_invalidates_client_caches():
    """Map-epoch change drops everything the client derived under the old
    map (placement cache, seat hints); an unchanged map re-adopted from a
    refresh clears nothing; the highest epoch wins across mixed rows."""
    client = Client(LocalStorage(), shard_aware=True)
    try:
        row = lambda mp: Member(ip="10.0.0.1", port=5000, active=True,  # noqa: E731
                                shard_map=mp)
        m1 = row(ShardMap(epoch=1, slots=("a:1", "b:2")).encode())
        client._adopt_shard_map([m1])
        assert client._shard_map is not None and client._shard_map.epoch == 1
        client._placement.put(("T", "x"), "a:1")
        client._read_seats.put(("T", "x"), (["s:1"], 0.0))
        # Same map seen again (every refresh re-reads it): caches survive.
        client._adopt_shard_map([m1, row("")])
        assert client._placement.get(("T", "x")) == "a:1"
        # Epoch bump (worker died, slice reseated, supervisor restarted):
        # stale derived state goes, the new map is adopted — highest epoch
        # wins even when old rows are still mixed into the view.
        m2 = row(ShardMap(epoch=2, slots=("a:1", "c:3")).encode())
        client._adopt_shard_map([m1, m2])
        assert client._shard_map.epoch == 2
        assert client._shard_map.slots == ("a:1", "c:3")
        assert client._placement.get(("T", "x")) is None
        assert client._read_seats.get(("T", "x")) is None
    finally:
        client.close()


def test_shard_map_epoch_bumps_per_start(tmp_path):
    """The supervisor persists the map epoch in its data_dir: every start()
    advertises a HIGHER epoch than the previous incarnation, so clients
    holding the old map drop their caches instead of direct-dialing a
    reseated slice."""
    node = ShardedServer(
        address="127.0.0.1:0",
        workers=2,
        registry=COUNTER_REGISTRY,
        data_dir=str(tmp_path),
    )
    assert node._next_epoch() == 1
    assert node._next_epoch() == 2
    other = ShardedServer(
        address="127.0.0.1:0",
        workers=2,
        registry=COUNTER_REGISTRY,
        data_dir=str(tmp_path),
    )
    assert other._next_epoch() == 3  # survives across supervisor objects


# ----------------------------------------------------------------------
# In-process: inbound decode paths (batch and non-batch)
# ----------------------------------------------------------------------


async def _raw_roundtrip(host, port, frame_bytes):
    """One framed request over a bare socket; returns the full reply frame."""
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write(frame_bytes)
        await writer.drain()
        header = await reader.readexactly(4)
        n = int.from_bytes(header, "big")
        return header + await reader.readexactly(n)
    finally:
        writer.close()
        with contextlib.suppress(Exception):
            await writer.wait_closed()


@pytest.mark.parametrize("batch", [True, False])
def test_inbound_decode_bad_frame_keeps_order_and_connection(batch):
    """Garbage frame → in-order NOT_SUPPORTED error response (the
    unknown-frame-kind compat contract: a newer client's command frame
    must degrade cleanly, see MIGRATING.md); the connection and the
    requests behind it keep working — on BOTH decode paths (the
    batch-decode fast path and the legacy per-frame fallback)."""
    from rio_tpu_torch import aio

    async def drive():
        addrs = [f"127.0.0.1:{p}" for p in _free_ports(1)]
        members, placement = LocalStorage(), LocalObjectPlacement()
        tasks = await _boot_router_servers(addrs, addrs, members, placement)
        try:
            host, _, port = addrs[0].rpartition(":")
            reader, writer = await asyncio.open_connection(host, int(port))
            try:
                good = encode_request_frame(
                    RequestEnvelope(
                        type_id(EchoActor), "bf-1", type_id(Echo),
                        codec.serialize(Echo(value=3)),
                    )
                )
                # Bad frame first, good frame right behind it — one write.
                writer.write(codec.frame(b"\x07junk") + good)
                await writer.drain()
                frames = []
                for _ in range(2):
                    header = await asyncio.wait_for(reader.readexactly(4), 10)
                    n = int.from_bytes(header, "big")
                    frames.append(await asyncio.wait_for(reader.readexactly(n), 10))
                bad = ResponseEnvelope.from_bytes(frames[0])
                assert bad.error is not None
                assert bad.error.kind == ErrorKind.NOT_SUPPORTED
                assert "unknown frame kind" in bad.error.detail
                ok = ResponseEnvelope.from_bytes(frames[1])
                assert ok.is_ok
                assert codec.deserialize(ok.body, Echo).value == 3
            finally:
                writer.close()
                with contextlib.suppress(Exception):
                    await writer.wait_closed()
        finally:
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

    old = aio._BATCH_DECODE
    aio._BATCH_DECODE = batch
    try:
        asyncio.run(drive())
    finally:
        aio._BATCH_DECODE = old


# ----------------------------------------------------------------------
# Real multi-process runs
# ----------------------------------------------------------------------


def _drive_sharded(node, coro_factory):
    """start → drive → stop, dumping worker logs on any failure.

    The node's SQLite files are made first: workers opening a fresh file at
    once can fail its switch to WAL (ROADMAP C.8, pinned below)."""
    prepare_node_storage(node.data_dir)
    node.start()
    try:
        return asyncio.run(coro_factory())
    except BaseException:
        for i in range(node.workers):
            sys.stderr.write(f"--- worker{i}.log ---\n{node.worker_log(i)}\n")
        raise
    finally:
        node.stop()


def test_sharded_routing_goldenwire_migration_journal_serialized(tmp_path):
    """The full 3-worker contract in one boot: directory rows land exactly
    on the crc32 slice and the client converges; the wrong worker's answer
    is the stock Redirect, byte-for-byte; per-object execution stays
    serialized under cross-shard concurrent load; MigrationManager moves an
    object OFF its hash shard (volatile state intact) and the router honors
    the seated row; per-worker journals merge into one causal stream."""
    node = ShardedServer(
        address="127.0.0.1:0",
        workers=3,
        registry=COUNTER_REGISTRY,
        data_dir=str(tmp_path),
    )

    async def drive():
        await node.wait_ready(60.0)
        members = sqlite_members(node.data_dir)
        placement = sqlite_placement(node.data_dir)
        client = Client(members)
        try:
            tname = type_id(ShardCounter)
            ids = [f"c-{i}" for i in range(18)]
            for i, oid in enumerate(ids):
                out = await client.send(ShardCounter, oid, Bump(amount=i), returns=Val)
                assert out.value == i and out.address in node.worker_addresses

            # Every directory row is exactly the crc32 slice's worker.
            for oid in ids:
                row = await placement.lookup(ObjectId(tname, oid))
                assert row == node.worker_addresses[shard_of(tname, oid, 3)], oid

            # Converged: a second pass over a warm placement cache costs
            # zero extra redirects.
            before = client.stats.redirects
            for oid in ids:
                await client.send(ShardCounter, oid, Get(), returns=Val)
            assert client.stats.redirects == before

            # Golden wire: a request for a seated object sent to the WRONG
            # worker answers the standard Redirect to the owner's identity
            # address — byte-identical to a plain multi-server cluster's.
            owner = await placement.lookup(ObjectId(tname, "c-0"))
            wrong = next(a for a in node.worker_addresses if a != owner)
            req = encode_request_frame(
                RequestEnvelope(tname, "c-0", type_id(Get), codec.serialize(Get()))
            )
            expected = encode_response_frame(
                ResponseEnvelope.err(ResponseError.redirect(owner))
            )
            whost, _, wport = wrong.rpartition(":")
            assert await _raw_roundtrip(whost, int(wport), req) == expected
            # ... and to the reference's bytes for the same Redirect.
            from rio_tpu import protocol as ref_protocol

            assert expected == ref_protocol.encode_response_frame(
                ref_protocol.ResponseEnvelope.err(ref_protocol.ResponseError.redirect(owner))
            )

            # Per-object serialized execution across shards: 5 concurrent
            # hammers per object, each racing the bump's interleave window.
            hot = [f"hot-{i}" for i in range(8)]

            async def hammer(oid):
                for _ in range(5):
                    await client.send(ShardCounter, oid, Bump(amount=1), returns=Val)

            await asyncio.gather(*[hammer(o) for o in hot for _ in range(5)])
            for oid in hot:
                out = await client.send(ShardCounter, oid, Get(), returns=Val)
                assert (out.value, out.overlapped) == (25, 0), (oid, out)

            # Migration between shards: the move overrides the hash map.
            src = await placement.lookup(ObjectId(tname, "c-7"))
            dst = next(a for a in node.worker_addresses if a != src)
            ack = await client.send(
                CONTROL_TYPE,
                src,
                MigrateObject(type_name=tname, object_id="c-7", target=dst),
                returns=MigrationAck,
            )
            assert ack.ok, ack.detail
            assert await placement.lookup(ObjectId(tname, "c-7")) == dst
            out = await client.send(ShardCounter, "c-7", Get(), returns=Val)
            assert (out.address, out.value) == (dst, 7)  # volatile state carried
            out = await client.send(ShardCounter, "c-7", Bump(amount=1), returns=Val)
            assert (out.address, out.value) == (dst, 8)  # router defers to the row

            # Journals merge causally across worker processes.
            snaps = [
                await client.send(ADMIN_TYPE, a, DumpEvents(), returns=EventsSnapshot)
                for a in node.worker_addresses
            ]
            merged = merge_events(s.events() for s in snaps)
            assert len({e.node for e in merged}) >= 2
            assert any(e.key.startswith(tname + "/") for e in merged)
        finally:
            client.close()
            members.close()
            placement.close()

    _drive_sharded(node, drive)


def test_sharded_worker_death_reseats_slice_on_survivor(tmp_path):
    node = ShardedServer(
        address="127.0.0.1:0",
        workers=2,
        registry=COUNTER_REGISTRY,
        data_dir=str(tmp_path),
    )

    async def drive():
        await node.wait_ready(60.0)
        members = sqlite_members(node.data_dir)
        placement = sqlite_placement(node.data_dir)
        client = Client(members)
        try:
            tname = type_id(ShardCounter)
            out = await client.send(ShardCounter, "victim", Bump(amount=5), returns=Val)
            assert out.value == 5
            seat = await placement.lookup(ObjectId(tname, "victim"))
            node.terminate_worker(node.worker_addresses.index(seat))

            # The supervisor's monitor thread records the death.
            loop = asyncio.get_event_loop()
            deadline = loop.time() + 30.0
            while loop.time() < deadline:
                if not await members.is_active(seat):
                    break
                await asyncio.sleep(0.05)
            else:
                raise TimeoutError("dead worker never marked inactive")

            # Next touch: stale row cleaned, reseated on the survivor —
            # a crash kill loses volatile state (fresh activation).
            survivor = next(a for a in node.worker_addresses if a != seat)
            out = await client.send(ShardCounter, "victim", Get(), returns=Val)
            assert (out.address, out.value) == (survivor, 0)
            assert await placement.lookup(ObjectId(tname, "victim")) == survivor
            out = await client.send(ShardCounter, "victim", Bump(amount=2), returns=Val)
            assert (out.address, out.value) == (survivor, 2)
        finally:
            client.close()
            members.close()
            placement.close()

    _drive_sharded(node, drive)


def test_sharded_worker_death_shard_aware_client_falls_back(tmp_path):
    """A shard-aware client holding the adopted map must
    NOT keep direct-dialing a SIGKILLed worker's slice. The corpse drops
    out of the active view, so the direct dial is skipped; the send
    degrades to redirect-follow, reseats on the survivor, and subsequent
    traffic converges — while the healthy worker's slice keeps
    direct-dialing with zero redirects throughout."""
    node = ShardedServer(
        address="127.0.0.1:0",
        workers=2,
        registry=COUNTER_REGISTRY,
        data_dir=str(tmp_path),
    )

    async def drive():
        await node.wait_ready(60.0)
        members = sqlite_members(node.data_dir)
        placement = sqlite_placement(node.data_dir)
        client = Client(members, shard_aware=True, membership_view_ttl=0.2)
        try:
            tname = type_id(ShardCounter)
            # Warm pass: every unplaced send direct-dials its slice owner.
            for i in range(8):
                out = await client.send(ShardCounter, f"sk-{i}", Bump(amount=1), returns=Val)
                assert out.address == node.worker_addresses[shard_of(tname, f"sk-{i}", 2)]
            assert client.stats.redirects == 0
            assert client.stats.shard_routes >= 8
            assert client._shard_map is not None
            assert tuple(client._shard_map.slots) == tuple(node.worker_addresses)

            out = await client.send(ShardCounter, "victim", Bump(amount=5), returns=Val)
            assert out.value == 5
            seat = out.address
            node.terminate_worker(node.worker_addresses.index(seat))
            loop = asyncio.get_event_loop()
            deadline = loop.time() + 30.0
            while loop.time() < deadline:
                if not await members.is_active(seat):
                    break
                await asyncio.sleep(0.05)
            else:
                raise TimeoutError("dead worker never marked inactive")

            # Stale-map hazard: "victim" (and the dead worker's whole
            # slice) must reseat on the survivor, not be direct-dialed
            # into the corpse off the old map.
            survivor = next(a for a in node.worker_addresses if a != seat)
            out = await client.send(ShardCounter, "victim", Get(), returns=Val)
            assert (out.address, out.value) == (survivor, 0)
            assert await placement.lookup(ObjectId(tname, "victim")) == survivor
            # Fresh unplaced traffic hashing to the dead slot also lands.
            dead_idx = node.worker_addresses.index(seat)
            fresh = next(
                f"fr-{i}" for i in range(100)
                if shard_of(tname, f"fr-{i}", 2) == dead_idx
            )
            out = await client.send(ShardCounter, fresh, Bump(amount=3), returns=Val)
            assert (out.address, out.value) == (survivor, 3)
        finally:
            client.close()
            members.close()
            placement.close()

    _drive_sharded(node, drive)


@pytest.mark.skipif(not HAS_REUSEPORT, reason="needs SO_REUSEPORT")
def test_sharded_front_door_entry_and_graceful_drain(tmp_path):
    """A client that knows ONLY the shared front-door address still reaches
    every shard (redirects carry identity addresses); SIGTERM drains each
    worker cleanly — exit 0, rows released, membership inactive."""
    node = ShardedServer(
        address="127.0.0.1:0",
        workers=2,
        registry="rio_tpu_torch.utils.routing_live:build_echo_registry",
        data_dir=str(tmp_path),
    )
    tname = type_id(EchoActor)

    async def drive():
        await node.wait_ready(60.0)
        front = LocalStorage()
        fhost, _, fport = node.front_address.rpartition(":")
        await front.push(Member(ip=fhost, port=int(fport), active=True))
        client = Client(front)
        placement = sqlite_placement(node.data_dir)
        try:
            for i in range(12):
                out = await client.send(EchoActor, f"fd-{i}", Echo(value=i), returns=Echo)
                assert out.value == i
            for i in range(12):
                row = await placement.lookup(ObjectId(tname, f"fd-{i}"))
                assert row == node.worker_addresses[shard_of(tname, f"fd-{i}", 2)]
        finally:
            client.close()
            placement.close()

    async def after_stop():
        members = sqlite_members(node.data_dir)
        placement = sqlite_placement(node.data_dir)
        try:
            for a in node.worker_addresses:
                assert not await members.is_active(a)
            for i in range(12):
                assert await placement.lookup(ObjectId(tname, f"fd-{i}")) is None
        finally:
            members.close()
            placement.close()

    prepare_node_storage(node.data_dir)
    node.start()
    try:
        asyncio.run(drive())
        codes = node.stop(graceful=True)
        assert codes == [0, 0], codes
        asyncio.run(after_stop())
    except BaseException:
        for i in range(node.workers):
            sys.stderr.write(f"--- worker{i}.log ---\n{node.worker_log(i)}\n")
        raise
    finally:
        node.stop()


# ----------------------------------------------------------------------
# The port's entry points, and the two packages across the wire
# ----------------------------------------------------------------------


def test_sharded_server_is_in_the_port_prelude():
    import rio_tpu_torch

    assert rio_tpu_torch.ShardedServer is ShardedServer
    assert "ShardedServer" in rio_tpu_torch.__all__


@pytest.mark.parametrize("flags", [[], ["--shard-aware"]], ids=["redirect", "shard_aware"])
def test_the_smoke_cli_passes(flags):
    import json
    import pathlib
    import subprocess

    root = pathlib.Path(__file__).resolve().parent.parent
    # The smoke's CLI with its node's files made first: its two workers
    # opening fresh files together fail at random (ROADMAP C, property 8;
    # test_a_first_connect_during_a_peers_write_fails_at_once_in_both_packages).
    out = subprocess.run(
        [sys.executable, "-m", "rio_tpu_torch.utils.sharded_smoke", *flags],
        cwd=root, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    line = next(l for l in out.stdout.splitlines() if l.startswith("SMOKE OK "))
    result = json.loads(line[len("SMOKE OK "):])
    assert result["ok"] and result["n"] == 16
    assert len(result["spread"]) == 2 and sum(result["spread"].values()) == 16
    if flags:
        assert result["redirects"] == 0 and result["shard_routes"] == 16


@pytest.mark.parametrize("node_pkg", ["rio_tpu_torch", "rio_tpu"], ids=["port_node", "reference_node"])
def test_each_packages_client_drives_the_others_sharded_node(node_pkg, tmp_path):
    """A 2-worker node of one package, entered through its sqlite members
    file by the OTHER package's ``Client`` and ``measure_rpc_external``:
    the same answers, seated on the crc32 slice, with a positive rate."""
    import importlib

    node_mod = importlib.import_module(f"{node_pkg}.sharded")
    client_pkg = "rio_tpu" if node_pkg == "rio_tpu_torch" else "rio_tpu_torch"
    client_mod = importlib.import_module(client_pkg)
    client_sharded = importlib.import_module(f"{client_pkg}.sharded")
    client_live = importlib.import_module(f"{client_pkg}.utils.routing_live")
    node = node_mod.ShardedServer(
        address="127.0.0.1:0",
        workers=2,
        registry=f"{node_pkg}.utils.routing_live:build_echo_registry",
        data_dir=str(tmp_path),
    )
    tname = client_mod.type_id(client_live.EchoActor)

    async def drive():
        await node.wait_ready(60.0)
        members = client_sharded.sqlite_members(node.data_dir)
        placement = client_sharded.sqlite_placement(node.data_dir)
        client = client_mod.Client(members)
        try:
            for i in range(12):
                out = await client.send(
                    client_live.EchoActor, f"x-{i}", client_live.Echo(value=i),
                    returns=client_live.Echo,
                )
                assert out.value == i
            for i in range(12):
                row = await placement.lookup(client_mod.ObjectId(tname, f"x-{i}"))
                assert row == node.worker_addresses[shard_of(tname, f"x-{i}", 2)], i
            rate = await client_live.measure_rpc_external(
                members, n_workers=4, requests_per_worker=20, n_objects=16,
            )
            assert rate > 0
        finally:
            client.close()
            members.close()
            placement.close()

    _drive_sharded(node, drive)


@pytest.mark.parametrize("pkg", ["rio_tpu", "rio_tpu_torch"])
def test_a_first_connect_during_a_peers_write_fails_at_once_in_both_packages(pkg, tmp_path):
    """The property behind ``prepare_node_storage`` (ROADMAP C.8): a fresh
    file's switch to WAL fails at once while a peer holds a write lock,
    whatever the busy timeout, in the reference's ``utils/sqlite.py`` and in
    its copy. A fix to both shows here."""
    import importlib
    import sqlite3
    import time

    path = str(tmp_path / "members.db")
    peer = sqlite3.connect(path, isolation_level=None)
    peer.execute("CREATE TABLE t (a)")
    peer.execute("BEGIN IMMEDIATE")
    db = importlib.import_module(f"{pkg}.utils.sqlite").SqliteDb(path)
    try:
        t0 = time.perf_counter()
        with pytest.raises(sqlite3.OperationalError, match="database is locked"):
            asyncio.run(db.execute("SELECT 1"))
        assert time.perf_counter() - t0 < 1.0  # the 5 s busy timeout never ran
    finally:
        peer.execute("ROLLBACK")
        peer.close()
        db.close()
    # Once the file is in WAL mode, the same first connect waits and succeeds.
    prepared = importlib.import_module(f"{pkg}.utils.sqlite").SqliteDb(path)
    try:
        asyncio.run(prepared.execute("SELECT 1"))
        peer = sqlite3.connect(path, isolation_level=None)
        peer.execute("BEGIN IMMEDIATE")
        late = importlib.import_module(f"{pkg}.utils.sqlite").SqliteDb(path)
        assert asyncio.run(late.execute("SELECT 1")) == [(1,)]
        peer.execute("ROLLBACK")
        peer.close()
        late.close()
    finally:
        prepared.close()
