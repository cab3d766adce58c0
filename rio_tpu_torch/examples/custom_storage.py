"""custom-storage: a user-defined persistence backend.

Parity with the reference's custom-storage example
(``rio-rs/examples/custom-storage/src/ping_state.rs``): the
framework's ``StateLoader``/``StateSaver`` boundary is a plugin seam — an
application can persist actor state in its *own* table/schema instead of the
framework's ``state_provider_object_state`` table.

Here ``PingStateStorage`` keeps ``PingState`` rows in a bespoke
``ping_state(object_id, pings, last_ping_at)`` sqlite table, and the
``PingService`` actor declares ``state = managed_state(PingState,
PingStateStorage)`` to route its persistence through it. A second cluster
boot proves state survives full process "restarts"::

    python -m rio_tpu_torch.examples.custom_storage
"""

import asyncio
import sqlite3
import time
from typing import Any


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
from rio_tpu_torch.cluster.membership_protocol import LocalClusterProvider
from rio_tpu_torch.errors import StateNotFound
from rio_tpu_torch.state import StateProvider


@message
class Ping:
    pass


@message
class PingState:
    pings: int = 0
    last_ping_at: float = 0.0


class PingStateStorage(StateProvider):
    """Custom backend: its own table, its own schema — not the framework's.

    Implements the same ``load/save/delete`` surface as the built-in
    providers, which is all ``managed_state`` needs.
    """

    def __init__(self, path: str) -> None:
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS ping_state ("
            "object_id TEXT PRIMARY KEY, pings INTEGER NOT NULL, "
            "last_ping_at REAL NOT NULL)"
        )
        self._db.commit()

    async def load(self, object_kind: str, object_id: str, state_type: str, ty: Any) -> Any:
        row = self._db.execute(
            "SELECT pings, last_ping_at FROM ping_state WHERE object_id=?",
            (object_id,),
        ).fetchone()
        if row is None:
            raise StateNotFound(object_id)
        return PingState(pings=row[0], last_ping_at=row[1])

    async def save(self, object_kind: str, object_id: str, state_type: str, value: Any) -> None:
        self._db.execute(
            "INSERT INTO ping_state (object_id, pings, last_ping_at) VALUES (?,?,?) "
            "ON CONFLICT(object_id) DO UPDATE SET "
            "pings=excluded.pings, last_ping_at=excluded.last_ping_at",
            (object_id, value.pings, value.last_ping_at),
        )
        self._db.commit()

    async def delete(self, object_kind: str, object_id: str, state_type: str) -> None:
        self._db.execute("DELETE FROM ping_state WHERE object_id=?", (object_id,))
        self._db.commit()


from rio_tpu_torch.state import managed_state  # noqa: E402 (after PingStateStorage exists)


class PingService(ServiceObject):
    state = managed_state(PingState, PingStateStorage)

    @handler
    async def ping(self, msg: Ping, ctx: AppData) -> PingState:
        self.state.pings += 1
        self.state.last_ping_at = time.time()
        await self.save_state(ctx)
        return self.state


async def boot_and_ping(db_path: str, n_pings: int) -> PingState:
    """Boot a fresh 1-node cluster, ping, tear down (a 'process restart')."""
    members = LocalStorage()
    placement = LocalObjectPlacement()
    server = Server(
        address="127.0.0.1:0",
        registry=Registry().add_type(PingService),
        cluster_provider=LocalClusterProvider(members),
        object_placement_provider=placement,
    )
    server.app_data.set(PingStateStorage(db_path), as_type=PingStateStorage)
    await server.prepare()
    await server.bind()
    task = asyncio.create_task(server.run())
    await asyncio.sleep(0.1)
    client = Client(members)
    state = None
    for _ in range(n_pings):
        state = await client.send(PingService, "pingu", Ping(), returns=PingState)
    client.close()
    task.cancel()
    await asyncio.gather(task, return_exceptions=True)
    return state


async def main() -> None:
    db = "custom_storage_demo.db"
    import os

    if os.path.exists(db):
        os.remove(db)
    s1 = await boot_and_ping(db, 3)
    print(f"[run 1] pings={s1.pings}")
    s2 = await boot_and_ping(db, 2)  # brand-new cluster, same table
    print(f"[run 2] pings={s2.pings} (state survived the restart)")
    assert s2.pings == 5
    row = sqlite3.connect(db).execute(
        "SELECT object_id, pings FROM ping_state"
    ).fetchall()
    print(f"[demo] custom table contents: {row}")
    os.remove(db)
    print("[demo] done")


if __name__ == "__main__":
    asyncio.run(main())
