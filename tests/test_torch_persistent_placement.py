"""PersistentTorchObjectPlacement: the port's provider with write-behind durability.

Every scenario of ``tests/test_persistent_placement.py`` on
``PersistentTorchObjectPlacement(device="cpu")``: over the port's
``SqliteObjectPlacement`` and over its ``LocalObjectPlacement``
(a "restart" is a fresh provider over the same store), and with the
reference's failing backings built on the port's ``LocalObjectPlacement``.
Then the same mutations on ``PersistentJaxObjectPlacement`` over
``rio_tpu``'s SQLite backing and on the port's provider over its own leave
the same backing rows, and the live-cluster restart
of ``tests/test_persistent_restart_e2e.py`` runs ``rio_tpu`` servers on the
port's provider over SQLite.
"""

import asyncio
from collections import Counter

import pytest

pytest.importorskip("torch")

from rio_tpu import ObjectId as JaxObjectId  # noqa: E402
from rio_tpu.object_placement.persistent import PersistentJaxObjectPlacement  # noqa: E402
from rio_tpu.object_placement.sqlite import SqliteObjectPlacement as RefSqliteObjectPlacement  # noqa: E402

from rio_tpu_torch.object_placement import (  # noqa: E402
    LocalObjectPlacement,
    ObjectPlacementItem,
    PersistentTorchObjectPlacement,
)
from rio_tpu_torch.object_placement.sqlite import SqliteObjectPlacement  # noqa: E402
from rio_tpu_torch.registry import ObjectId  # noqa: E402

from .test_persistent_restart_e2e import Pin, Poke, Where, build_registry  # noqa: E402
from .server_utils import Cluster, run_integration_test  # noqa: E402


def _provider(backing, **kw):
    p = PersistentTorchObjectPlacement(
        backing, flush_interval=0.01, mode="greedy", device="cpu", **kw
    )
    for i in range(4):
        p.register_node(f"10.9.0.{i}:5000")
    return p


async def _settled_flush(p):
    # One interval for the flusher's coalescing sleep, then force.
    await asyncio.sleep(0.03)
    await p.flush()


@pytest.fixture(params=["sqlite", "local"])
def store(request, tmp_path):
    """A factory of backing stores over ONE durable directory: a fresh
    ``SqliteObjectPlacement`` on the same file, or the same in-memory
    ``LocalObjectPlacement``."""
    if request.param == "sqlite":
        return lambda: SqliteObjectPlacement(str(tmp_path / "dir.db"))
    shared = LocalObjectPlacement()
    return lambda: shared


async def test_restart_restores_directory(store):
    p1 = _provider(store())
    await p1.prepare()
    ids = [ObjectId("Game", str(i)) for i in range(200)]
    addrs = await p1.assign_batch(ids)
    await _settled_flush(p1)
    await p1.aclose()

    # "Restart": a fresh provider over the same store sees every seat.
    p2 = _provider(store())
    await p2.prepare()
    assert p2.count() == len(ids)
    assert await p2.lookup_batch(ids) == addrs
    assert p2._dirty == {}  # restored rows are already durable
    assert await p2.assign_batch(ids) == addrs  # stickiness across the restart
    await p2.aclose()


async def test_every_mutation_path_writes_behind(store):
    backing = store()
    p = _provider(backing)
    await p.prepare()

    ids = [ObjectId("T", str(i)) for i in range(40)]
    await p.assign_batch(ids)  # allocation path
    await p.update(ObjectPlacementItem(ObjectId("T", "manual"), "10.9.0.1:5000"))
    await _settled_flush(p)
    assert await backing.lookup(ObjectId("T", "manual")) == "10.9.0.1:5000"
    assert len(await backing.items()) == 41

    await p.remove(ObjectId("T", "manual"))  # remove path
    victim = await p.lookup(ids[0])  # clean_server drops the node's rows
    on_victim = [i for i in ids if await p.lookup(i) == victim]
    await p.clean_server(victim)
    await _settled_flush(p)
    assert await backing.lookup(ObjectId("T", "manual")) is None
    for oid in on_victim:
        assert await backing.lookup(oid) is None

    # rebalance path: kill a node, re-solve; the backing follows the movers
    p.sync_members([f"10.9.0.{i}:5000" for i in range(4) if i != 2])
    await p.rebalance()
    await _settled_flush(p)
    live = {f"10.9.0.{i}:5000" for i in range(4) if i != 2}
    for item in await backing.items():
        assert item.server_address in live
    await p.aclose()


async def test_restore_counts_load_and_quarantines_ghost_nodes(store):
    """The restored population counts as node load, and addresses the
    restore invents start dead and attract no new objects."""
    backing = store()
    await backing.prepare()
    for i in range(90):  # heavy restored load on node A
        await backing.update(ObjectPlacementItem(ObjectId("T", f"a{i}"), "10.9.0.0:5000"))
    for i in range(30):  # rows on a node that died while we were down
        await backing.update(ObjectPlacementItem(ObjectId("T", f"g{i}"), "10.9.9.9:1"))
    p = PersistentTorchObjectPlacement(backing, flush_interval=0.01, mode="greedy", device="cpu")
    p.register_node("10.9.0.0:5000")
    p.register_node("10.9.0.1:5000")
    await p.prepare()
    assert p.count() == 120
    where = await p.assign_batch([ObjectId("N", str(i)) for i in range(40)])
    assert "10.9.9.9:1" not in where  # the ghost receives no new object
    assert await p.lookup(ObjectId("T", "g0")) == "10.9.9.9:1"  # its rows stand
    counts = Counter(where)
    assert counts["10.9.0.1:5000"] >= 35, counts  # the empty live node fills
    await p.aclose()


async def test_aclose_mid_flush_cancellation_loses_nothing():
    """aclose() cancelling the flusher MID-write puts the in-flight dirty
    set back, so the final flush lands it."""

    class SlowBacking(LocalObjectPlacement):
        def __init__(self):
            super().__init__()
            self.calls = 0
            self.entered = asyncio.Event()

        async def update_batch(self, items):
            self.calls += 1
            if self.calls == 1:
                self.entered.set()
                await asyncio.Event().wait()  # parked until cancelled
            await super().update_batch(items)

    backing = SlowBacking()
    p = _provider(backing)
    await p.prepare()
    await p.update(ObjectPlacementItem(ObjectId("T", "a"), "10.9.0.0:5000"))
    await asyncio.wait_for(backing.entered.wait(), 5)  # flusher mid-write
    await asyncio.wait_for(p.aclose(), 5)
    assert backing.calls == 2
    assert await backing.lookup(ObjectId("T", "a")) == "10.9.0.0:5000"


async def test_flush_failure_keeps_marks_and_retries():
    class FlakyBacking(LocalObjectPlacement):
        def __init__(self):
            super().__init__()
            self.fail_next = 0

        async def update_batch(self, items):
            if self.fail_next > 0:
                self.fail_next -= 1
                raise ConnectionError("backing down")
            await super().update_batch(items)

    backing = FlakyBacking()
    p = _provider(backing)
    await p.prepare()
    backing.fail_next = 1
    await p.update(ObjectPlacementItem(ObjectId("T", "a"), "10.9.0.0:5000"))
    with pytest.raises(ConnectionError):
        await p.flush()
    assert p._dirty == {"T.a": "10.9.0.0:5000"}  # the mark survived
    assert await p.flush() == 1  # and the next flush lands it
    assert await backing.lookup(ObjectId("T", "a")) == "10.9.0.0:5000"
    await p.aclose()


async def test_background_flusher_runs_without_manual_flush(store):
    backing = store()
    p = _provider(backing)
    await p.prepare()
    await p.assign_batch([ObjectId("T", str(i)) for i in range(10)])
    for _ in range(100):
        if len(await backing.items()) == 10:
            break
        await asyncio.sleep(0.02)
    assert len(await backing.items()) == 10
    await p.aclose()


async def test_promotion_after_cold_restart_keeps_surviving_standbys(store):
    """A promotion on a cold mirror rebuilds the standby row from the
    backing's post-CAS row, so the flush keeps the surviving seat."""
    p1 = _provider(store())
    await p1.prepare()
    oid = ObjectId("Game", "g0")
    await p1.update(ObjectPlacementItem(oid, "10.9.0.0:5000"))
    await p1.set_standbys(oid, ["10.9.0.1:5000", "10.9.0.2:5000"])
    await _settled_flush(p1)
    await p1.aclose()

    p2 = _provider(store())
    await p2.prepare()
    assert await p2.promote_standby(oid, "10.9.0.1:5000", 0) == 1
    assert await p2.standbys(oid) == (["10.9.0.2:5000"], 1)
    await _settled_flush(p2)
    assert await p2._backing.standbys(oid) == (["10.9.0.2:5000"], 1)
    await p2.aclose()


# ---------------------------------------------- parity with the JAX provider


async def _mutations(p, make_id) -> dict[str, str]:
    """One run of every write path; the backing's rows afterwards."""
    await p.prepare()
    ids = [make_id("M", str(i)) for i in range(120)]
    await p.assign_batch(ids)
    await p.update(ObjectPlacementItem(make_id("M", "manual"), "10.9.0.3:5000"))
    await p.remove(ids[5])
    await p.set_standbys(ids[7], ["10.9.0.1:5000"])
    await p.clean_server("10.9.0.0:5000")
    p.sync_members([f"10.9.0.{i}:5000" for i in (1, 3)])
    await p.rebalance()
    await p.rebalance(delta=False)
    await p.aclose()
    rows = {str(i.object_id): i.server_address for i in await p._backing.items()}
    rows["standbys"] = str(await p._backing.standbys(ids[7]))
    return rows


async def test_backing_rows_equal_the_jax_provider(tmp_path):
    def jax_make():
        return PersistentJaxObjectPlacement(
            RefSqliteObjectPlacement(str(tmp_path / "jax.db")), flush_interval=0.01, mode="greedy"
        )

    def torch_make():
        return _provider(SqliteObjectPlacement(str(tmp_path / "torch.db")))

    p_jax = jax_make()
    for i in range(4):
        p_jax.register_node(f"10.9.0.{i}:5000")
    rows_jax = await _mutations(p_jax, JaxObjectId)
    rows_torch = await _mutations(torch_make(), ObjectId)
    assert len(rows_jax) > 60
    assert rows_torch == rows_jax


# ------------------------------------------------------ a live cluster


def test_drain_flushes_write_behind_before_exit(tmp_path):
    """AdminCommand.drain() on the port's persistent provider flushes the
    write-behind before the server exits (the flusher's interval is far
    above the test's length)."""
    from rio_tpu.commands import AdminCommand

    placement = PersistentTorchObjectPlacement(
        SqliteObjectPlacement(str(tmp_path / "dir.db")),
        mode="greedy", flush_interval=30.0, device="cpu",
    )

    async def body(cluster: Cluster):
        client = cluster.client()
        try:
            for i in range(30):
                await client.send(Pin, f"o{i}", Poke(), returns=Where)
            victim_addr = await cluster.allocation_address("Pin", "o0")
            victim = next(s for s in cluster.servers if s.local_address == victim_addr)
            victim.admin_sender().send(AdminCommand.drain())
            deadline = asyncio.get_event_loop().time() + 15.0
            while asyncio.get_event_loop().time() < deadline:
                if victim._stopped.is_set():
                    break
                await asyncio.sleep(0.05)
            assert victim._stopped.is_set()
            rows = {str(i.object_id): i.server_address for i in await placement._backing.items()}
            assert rows, "backing store empty after drain"
            assert all(a != victim_addr for a in rows.values()), rows
        finally:
            client.close()

    asyncio.run(
        run_integration_test(
            body, registry_builder=build_registry, num_servers=3, placement=placement,
            timeout=60.0,
        )
    )


def test_cluster_restart_restores_and_reseats(tmp_path):
    """A live cluster on the port's persistent provider over SQLite, stopped
    and rebooted on fresh addresses: the directory is restored at
    ``Server.prepare()``, traffic re-seats every object on a live node, and
    no new allocation lands on a ghost."""
    db = tmp_path / "directory.db"
    n_objects = 40

    def placement():
        return PersistentTorchObjectPlacement(
            SqliteObjectPlacement(str(db)), mode="greedy", flush_interval=0.01, device="cpu"
        )

    placement1 = placement()

    async def first_life(cluster: Cluster):
        client = cluster.client()
        try:
            for i in range(n_objects):
                out = await client.send(Pin, f"o{i}", Poke(), returns=Where)
                assert out.address in cluster.addresses
            assert placement1.count() == n_objects
            await placement1.flush()
            assert len(await placement1._backing.items()) == n_objects
        finally:
            client.close()

    asyncio.run(
        run_integration_test(
            first_life, registry_builder=build_registry, num_servers=3, placement=placement1
        )
    )

    placement2 = placement()

    async def second_life(cluster: Cluster):
        assert placement2.count() == n_objects
        ghosts = {await placement2.lookup(ObjectId("Pin", f"o{i}")) for i in range(n_objects)}
        assert None not in ghosts
        assert ghosts.isdisjoint(set(cluster.addresses))
        assert all(not placement2._nodes[g].alive for g in ghosts)
        client = cluster.client()
        try:
            for i in range(n_objects):
                out = await client.send(Pin, f"o{i}", Poke(), returns=Where)
                assert out.address in cluster.addresses, f"o{i} -> {out.address}"
            for i in range(10):
                out = await client.send(Pin, f"new{i}", Poke(), returns=Where)
                assert out.address in cluster.addresses
        finally:
            client.close()

    asyncio.run(
        run_integration_test(
            second_life, registry_builder=build_registry, num_servers=3, placement=placement2
        )
    )
