"""The port's durable backends hold the reference's own contract, and share its files.

The SQLite, Postgres and Redis forms of membership, placement, state,
reminders and streams under ``rio_tpu_torch/`` run the reference's contract
checks (``check_membership``, ``check_placement`` with ``check_standbys``
and ``check_state`` from ``tests/test_backends.py``; ``check_reminders``
and ``check_leases`` from ``tests/test_reminder_storage.py``;
``check_stream_storage`` from ``tests/test_streams.py``): SQLite on a
file, Postgres through ``tests/fake_pg.py`` (sqlite behind a DBAPI
stand-in), Redis against ``tests/fake_redis.py``'s RESP server.

``check_state`` expects the reference's ``StateNotFound``; the port raises
its own class of that name, so the check reads the port's for its run.

Then each SQLite backend of one package writes a file that the other
package's reads, both ways: what the reader sees equals what the writer's
own package reads back. A deployment that switches packages keeps its
database.
"""

import asyncio
import dataclasses
import importlib

import pytest

from tests import test_backends as contract
from tests.fake_redis import FakeRedisServer
from tests.test_backends import check_membership, check_placement, check_state
from tests.test_reminder_storage import check_leases, check_reminders
from tests.test_streams import check_stream_storage

LIMIT_S = 60.0


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=LIMIT_S))


def _cls(pkg: str, module: str, name: str):
    return getattr(importlib.import_module(f"{pkg}.{module}"), name)


@pytest.fixture
def port_state_not_found(monkeypatch):
    from rio_tpu_torch.errors import StateNotFound

    monkeypatch.setattr(contract, "StateNotFound", StateNotFound)


# ------------------------------------------------------------ the contract

FAMILIES = {
    # family -> (module under the package, class prefix/suffix, the checks)
    "membership": ("cluster.storage", "{}MembershipStorage", (check_membership,)),
    "placement": ("object_placement", "{}ObjectPlacement", (check_placement,)),
    "state": ("state", "{}State", (check_state,)),
    "reminders": ("reminders", "{}ReminderStorage", (check_reminders, check_leases)),
    "streams": ("streams", "{}StreamStorage", (check_stream_storage,)),
}
KINDS = {"sqlite": "Sqlite", "postgres": "Postgres", "redis": "Redis"}


def _port_backend(family: str, kind: str):
    module, pattern, _ = FAMILIES[family]
    return _cls("rio_tpu_torch", f"{module}.{kind}", pattern.format(KINDS[kind]))


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_the_ports_backend_holds_the_references_contract(family, kind, tmp_path, port_state_not_found):
    cls = _port_backend(family, kind)
    assert cls.__module__.startswith("rio_tpu_torch.")
    checks = FAMILIES[family][2]

    async def body():
        if kind == "redis":
            server = await FakeRedisServer().start()
            try:
                for i, check in enumerate(checks):
                    store = cls(f"redis://127.0.0.1:{server.port}", key_prefix=f"t_{family}_{i}")
                    await check(store)
                    store.close()
            finally:
                await server.stop()
            return
        for i, check in enumerate(checks):
            if kind == "sqlite":
                store = cls(str(tmp_path / f"{family}_{i}.db"))
            else:
                from tests import fake_pg

                fake_pg.install()
                fake_pg.reset()
                store = cls(f"postgresql://fake-pg/torch-{family}-{i}")
            await check(store)
            store.close()

    _run(body())


def test_the_ports_postgres_backends_run_on_the_ports_pgdb():
    from rio_tpu_torch.utils.pg import PgDb
    from tests import fake_pg

    fake_pg.install()
    fake_pg.reset()
    for family in FAMILIES:
        store = _port_backend(family, "postgres")("postgresql://fake-pg/torch-pgdb")
        assert type(store.db) is PgDb, family
        store.close()


def test_the_ports_redis_backends_share_one_client_of_the_port():
    from rio_tpu_torch.utils.resp import RedisClient

    async def body():
        server = await FakeRedisServer().start()
        try:
            client = RedisClient("127.0.0.1", server.port)
            assert await client.ping()
            for family in FAMILIES:
                store = _port_backend(family, "redis")(client, key_prefix=f"shared_{family}")
                assert store.client is client, family
            mem = _port_backend("membership", "redis")(client, key_prefix="t_trim")
            for _ in range(150):
                await mem.notify_failure("10.0.0.9", 9000)
            assert len(await mem.member_failures("10.0.0.9", 9000)) == 100
            client.close()
        finally:
            await server.stop()

    _run(body())


# ------------------------------------------------- files across the packages

REF, PORT = "rio_tpu", "rio_tpu_torch"


@dataclasses.dataclass
class Score:
    wins: int = 0
    history: list = dataclasses.field(default_factory=list)


async def _write_membership(pkg, path):
    Member = _cls(pkg, "cluster.storage", "Member")
    s = _cls(pkg, "cluster.storage.sqlite", "SqliteMembershipStorage")(path)
    await s.prepare()
    await s.push(Member(ip="10.0.0.1", port=5000, active=True, load="l1"))
    await s.push(Member(ip="10.0.0.2", port=5001, active=False))
    await s.push(Member(ip="10.0.0.3", port=5002, active=True))
    await s.set_inactive("10.0.0.3", 5002)
    for _ in range(3):
        await s.notify_failure("10.0.0.2", 5001)
    s.close()


async def _read_membership(pkg, path):
    s = _cls(pkg, "cluster.storage.sqlite", "SqliteMembershipStorage")(path)
    await s.prepare()
    members = sorted((m.address, m.active, m.load) for m in await s.members())
    active = [m.address for m in await s.active_members()]
    failures = len(await s.member_failures("10.0.0.2", 5001))
    s.close()
    return members, active, failures


async def _write_placement(pkg, path):
    ObjectId = _cls(pkg, "registry", "ObjectId")
    Item = _cls(pkg, "object_placement", "ObjectPlacementItem")
    s = _cls(pkg, "object_placement.sqlite", "SqliteObjectPlacement")(path)
    await s.prepare()
    await s.update_batch([Item(ObjectId("Svc", f"o{i}"), f"h{i % 3}:1") for i in range(20)])
    await s.update(Item(ObjectId("Svc", "dotted.id"), "h9:9"))
    await s.remove(ObjectId("Svc", "o4"))
    await s.clean_server("h2:1")
    await s.set_standbys(ObjectId("Svc", "o1"), ["s1:1", "s2:2"])
    assert await s.promote_standby(ObjectId("Svc", "o1"), "s1:1", 0) == 1
    s.close()


async def _read_placement(pkg, path):
    ObjectId = _cls(pkg, "registry", "ObjectId")
    s = _cls(pkg, "object_placement.sqlite", "SqliteObjectPlacement")(path)
    await s.prepare()
    rows = sorted((str(i.object_id), i.server_address) for i in await s.items())
    standbys = await s.standbys(ObjectId("Svc", "o1"))
    looked = await s.lookup(ObjectId("Svc", "dotted.id"))
    s.close()
    return rows, standbys, looked


async def _write_state(pkg, path):
    s = _cls(pkg, "state.sqlite", "SqliteState")(path)
    await s.prepare()
    await s.save("Player", "p1", "Score", Score(wins=3, history=["w", "l"]))
    await s.save("Player", "p2", "Score", Score(wins=1))
    await s.save("Player", "p3", "Score", Score(wins=9))
    await s.delete("Player", "p3", "Score")
    s.close()


async def _read_state(pkg, path):
    NotFound = _cls(pkg, "errors", "StateNotFound")
    s = _cls(pkg, "state.sqlite", "SqliteState")(path)
    await s.prepare()
    out = []
    for oid in ("p1", "p2", "p3"):
        try:
            out.append(dataclasses.asdict(await s.load("Player", oid, "Score", Score)))
        except NotFound:
            out.append(None)
    s.close()
    return out


async def _write_reminders(pkg, path):
    Reminder = _cls(pkg, "reminders", "Reminder")
    s = _cls(pkg, "reminders.sqlite", "SqliteReminderStorage")(path)
    await s.prepare()
    await s.upsert(Reminder("Player", "p1", "save", period=5.0, next_due=100.0))
    await s.upsert(Reminder("Player", "p1", "expire", period=2.0, next_due=50.0))
    await s.upsert(Reminder("Npc", "n1", "tick", period=1.0, next_due=70.0))
    await s.reschedule("Player", "p1", "expire", 80.0)
    assert await s.acquire_lease(3, "n1:1", ttl=10.0, now=1000.0) is not None
    assert await s.acquire_lease(3, "n2:2", ttl=10.0, now=1020.0) is not None
    s.close()


async def _read_reminders(pkg, path):
    s = _cls(pkg, "reminders.sqlite", "SqliteReminderStorage")(path)
    await s.prepare()

    def rows(rs):
        return [(r.object_kind, r.object_id, r.reminder_name, r.period, r.next_due, r.shard) for r in rs]

    listed = rows(await s.list_object("Player", "p1"))
    shard = s.shard_for("Player", "p1")
    due = rows(await s.due(shard, now=90.0))
    counts = await s.shard_counts()
    lease = await s.get_lease(3)
    s.close()
    return listed, due, counts, dataclasses.astuple(lease)


async def _write_streams(pkg, path):
    Record = _cls(pkg, "streams", "StreamRecord")
    Subscription = _cls(pkg, "streams", "Subscription")
    s = _cls(pkg, "streams.sqlite", "SqliteStreamStorage")(path)
    await s.prepare()
    p = s.partition_of("orders", "k1")
    for i in range(4):
        await s.append(Record("orders", p, 0, "M", b"x%d" % i, "k1", 1.5 + i))
    await s.subscribe(Subscription("orders", "g1", "T", 0.5))
    await s.subscribe(Subscription("orders", "g0", "T2"))
    await s.commit("orders", "g1", p, 3)
    s.close()


async def _read_streams(pkg, path):
    s = _cls(pkg, "streams.sqlite", "SqliteStreamStorage")(path)
    await s.prepare()
    p = s.partition_of("orders", "k1")
    recs = [dataclasses.astuple(r) for r in await s.read("orders", p, 0, 10)]
    subs = [dataclasses.astuple(x) for x in await s.subscriptions("orders")]
    latest = await s.latest("orders", p)
    cursors = await s.cursors("orders", "g1")
    s.close()
    return recs, subs, latest, cursors


CROSS = {
    "membership": (_write_membership, _read_membership),
    "placement": (_write_placement, _read_placement),
    "state": (_write_state, _read_state),
    "reminders": (_write_reminders, _read_reminders),
    "streams": (_write_streams, _read_streams),
}


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)], ids=["ref-writes", "port-writes"])
@pytest.mark.parametrize("family", list(CROSS))
def test_a_sqlite_file_reads_the_same_in_both_packages(family, writer, reader, tmp_path):
    write, read = CROSS[family]
    path = str(tmp_path / f"{family}.db")

    async def body():
        await write(writer, path)
        theirs = await read(reader, path)
        own = await read(writer, path)
        return theirs, own

    theirs, own = _run(body())
    assert theirs == own
    assert any(theirs)  # the file held what was written
