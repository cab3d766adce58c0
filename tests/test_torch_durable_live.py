"""A live cluster of the port persists to SQLite, stops, and restarts from the files.

The CPU rehearsal of ``chip_smoke.py``'s ``durable`` group at a small size
(3 servers, 200 echo objects, 64 durable counters): the port's servers on
``SqliteMembershipStorage``, ``PersistentTorchObjectPlacement(device="cpu")``
over the port's ``SqliteObjectPlacement``, and ``SqliteState``
(``rio_tpu_torch.utils.durable_live``). The first life allocates, drains
the write-behind, reads the file back and stops; the second restores the
directory, boots fresh servers on new ports and holds the restart contract
of ``tests/test_persistent_restart_e2e.py``.

The same scenario on the reference's runtime (``rio_tpu`` servers,
``PersistentJaxObjectPlacement`` over ``rio_tpu``'s SQLite backends, a
``DurableCounter`` built on ``rio_tpu``) gives the same outcome fields, and
the port's cluster restarts from files the reference's cluster wrote.
"""

import asyncio

import pytest

pytest.importorskip("torch")

from rio_tpu import AppData as RefAppData  # noqa: E402
from rio_tpu import Client as RefClient  # noqa: E402
from rio_tpu import Registry as RefRegistry  # noqa: E402
from rio_tpu import Server as RefServer  # noqa: E402
from rio_tpu import ServiceObject as RefServiceObject  # noqa: E402
from rio_tpu import handler as ref_handler  # noqa: E402
from rio_tpu import message as ref_message  # noqa: E402
from rio_tpu.cluster.membership_protocol import LocalClusterProvider as RefLocalClusterProvider  # noqa: E402
from rio_tpu.cluster.storage.sqlite import SqliteMembershipStorage as RefSqliteMembership  # noqa: E402
from rio_tpu.commands import AdminCommand as RefAdminCommand  # noqa: E402
from rio_tpu.commands import ServerInfo as RefServerInfo  # noqa: E402
from rio_tpu.object_placement.persistent import PersistentJaxObjectPlacement  # noqa: E402
from rio_tpu.object_placement.sqlite import SqliteObjectPlacement as RefSqlitePlacement  # noqa: E402
from rio_tpu.registry import ObjectId as RefObjectId  # noqa: E402
from rio_tpu.registry import type_id as ref_type_id  # noqa: E402
from rio_tpu.state import StateProvider as RefStateProvider  # noqa: E402
from rio_tpu.state import managed_state as ref_managed_state  # noqa: E402
from rio_tpu.state.sqlite import SqliteState as RefSqliteState  # noqa: E402
from rio_tpu.utils.routing_live import Echo as RefEcho  # noqa: E402
from rio_tpu.utils.routing_live import EchoActor as RefEchoActor  # noqa: E402

from rio_tpu_torch.utils import durable_live as D  # noqa: E402

N_SERVERS, N_OBJECTS, N_COUNTERS, N_NEW, N_SAMPLE = 3, 200, 64, 20, 50
LIMIT_S = 120.0


# The port's utils/churn_live.py DurableCounter, on the reference's runtime, with the
# same wire and state names: a counter either package saved, the other reads.
@ref_message(name="churn_live.Add")
class RefAdd:
    n: int = 1


@ref_message(name="churn_live.Get")
class RefGet:
    pass


@ref_message(name="churn_live.Total")
class RefTotal:
    value: int = 0
    address: str = ""


@ref_message(name="churn_live.CounterState")
class RefCounterState:
    value: int = 0


class DurableCounter(RefServiceObject):
    state = ref_managed_state(RefCounterState)

    @ref_handler
    async def add(self, msg: RefAdd, ctx: RefAppData) -> RefTotal:
        self.state.value += msg.n
        await self.save_state(ctx)
        info = ctx.try_get(RefServerInfo)
        return RefTotal(value=self.state.value, address=info.address if info else "")

    @ref_handler
    async def get(self, msg: RefGet, ctx: RefAppData) -> RefTotal:
        info = ctx.try_get(RefServerInfo)
        return RefTotal(value=self.state.value, address=info.address if info else "")


REF = D.Runtime(
    Server=RefServer, Client=RefClient, AppData=RefAppData,
    LocalClusterProvider=RefLocalClusterProvider, StateProvider=RefStateProvider,
    ObjectId=RefObjectId, AdminCommand=RefAdminCommand, type_id=ref_type_id,
    SqliteMembershipStorage=RefSqliteMembership, SqliteObjectPlacement=RefSqlitePlacement,
    SqliteState=RefSqliteState,
    make_placement=lambda backing: PersistentJaxObjectPlacement(backing),
    build_registry=lambda: RefRegistry().add_type(RefEchoActor).add_type(DurableCounter),
    EchoActor=RefEchoActor, Echo=RefEcho, Counter=DurableCounter, Add=RefAdd, Get=RefGet,
    Total=RefTotal,
)


def _port():
    return D.port_runtime("cpu")


def _lives(first_rt, second_rt, data_dir) -> tuple[dict, dict]:
    async def both():
        first = await D.first_life(
            first_rt, str(data_dir), n_servers=N_SERVERS, n_objects=N_OBJECTS, n_counters=N_COUNTERS
        )
        second = await D.second_life(
            second_rt, str(data_dir), first, n_servers=N_SERVERS, n_new=N_NEW, sample_size=N_SAMPLE
        )
        return first, second

    return asyncio.run(asyncio.wait_for(both(), timeout=LIMIT_S))


FIRST_FIELDS = ("n_servers", "n_echo", "n_objects", "directory_rows", "file_rows", "rows_equal",
                "acked", "pre_exit_flush_rows", "closing_flush_rows", "exited_cleanly")
SECOND_FIELDS = ("n_servers", "restored", "restored_on_ghosts", "restored_on_live", "new",
                 "new_on_ghosts", "new_on_live", "answered", "counters", "lost", "pre_exit_flush_rows",
                 "closing_flush_rows", "exited_cleanly")


def _outcome(first: dict, second: dict) -> dict:
    out = {f"first.{k}": first[k] for k in FIRST_FIELDS}
    out.update({f"second.{k}": second[k] for k in SECOND_FIELDS})
    out["second.hops.n"] = second["hops"]["n"]
    return out


def _hold_the_contract(first: dict, second: dict) -> None:
    n = N_OBJECTS + N_COUNTERS
    assert first["n_servers"] == second["n_servers"] == N_SERVERS
    assert first["directory_rows"] == first["file_rows"] == n
    assert first["rows_equal"], "the file's rows differ from the directory"
    assert set(first["acked"].values()) == {1}
    assert first["rows_written"] >= n
    assert first["exited_cleanly"] and second["exited_cleanly"]
    # The restored count before any traffic; every restored row names a ghost.
    assert second["restored"] == first["file_rows"]
    assert second["restored_on_ghosts"] == n and second["restored_on_live"] == 0
    assert not set(second["live"]) & set(first["addresses"])
    # New ids seat on live servers only.
    assert second["new_on_ghosts"] == 0 and second["new_on_live"] == N_NEW
    # Every sampled restored id answers through the re-seat; every counter reads back.
    assert second["answered"] == second["hops"]["n"] == N_SAMPLE
    assert 1.0 <= second["hops"]["mean"] <= 2.0
    assert second["counters"] == N_COUNTERS and second["lost"] == []
    # The re-seat wrote back the ghosts' rows it cleaned and the new ids.
    assert second["reseat_rows"] >= n + N_NEW


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    return _lives(_port(), _port(), tmp_path_factory.mktemp("port"))


def test_the_ports_cluster_restarts_from_its_sqlite_files(port_run):
    first, second = port_run
    assert first["directory_device"] == "cpu"
    _hold_the_contract(first, second)


def test_the_reference_runtime_gives_the_same_outcome(port_run, tmp_path):
    ref_first, ref_second = _lives(REF, REF, tmp_path)
    _hold_the_contract(ref_first, ref_second)
    assert _outcome(ref_first, ref_second) == _outcome(*port_run)


def test_the_ports_cluster_restarts_from_files_the_reference_wrote(port_run, tmp_path):
    first, second = _lives(REF, _port(), tmp_path)
    _hold_the_contract(first, second)
    assert _outcome(first, second) == _outcome(*port_run)
