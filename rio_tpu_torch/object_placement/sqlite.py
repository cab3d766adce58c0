"""SQLite object-placement directory.

Reference: ``rio-rs/src/object_placement/sqlite.rs`` — table
``object_placement(struct_name, object_id, server_address)`` with an index
on ``server_address``; upsert (``:68-85``), lookup (``:86-100``),
``clean_server`` DELETE-by-address (``:101-112``).
"""

from __future__ import annotations

from ..registry import ObjectId
from ..utils.sqlite import SqliteDb
from . import ObjectPlacement, ObjectPlacementItem, sanitize_standby_row

MIGRATIONS = [
    """
    CREATE TABLE IF NOT EXISTS object_placement (
        struct_name    TEXT NOT NULL,
        object_id      TEXT NOT NULL,
        server_address TEXT,
        PRIMARY KEY (struct_name, object_id)
    );
    CREATE INDEX IF NOT EXISTS idx_object_placement_server
        ON object_placement (server_address);
    CREATE TABLE IF NOT EXISTS object_standby (
        struct_name TEXT NOT NULL,
        object_id   TEXT NOT NULL,
        standbys    TEXT NOT NULL DEFAULT '',
        epoch       INTEGER NOT NULL DEFAULT 0,
        PRIMARY KEY (struct_name, object_id)
    );
    """
]


class SqliteObjectPlacement(ObjectPlacement):
    def __init__(self, path: str) -> None:
        self.db = SqliteDb(path)

    async def prepare(self) -> None:
        await self.db.migrate(MIGRATIONS)

    async def update(self, item: ObjectPlacementItem) -> None:
        await self.db.execute(
            "INSERT INTO object_placement (struct_name, object_id, server_address) "
            "VALUES (?,?,?) ON CONFLICT(struct_name, object_id) "
            "DO UPDATE SET server_address=excluded.server_address",
            item.object_id.type_name, item.object_id.id, item.server_address,
        )

    async def lookup(self, object_id: ObjectId) -> str | None:
        rows = await self.db.execute(
            "SELECT server_address FROM object_placement "
            "WHERE struct_name=? AND object_id=?",
            object_id.type_name, object_id.id,
        )
        return rows[0][0] if rows else None

    async def clean_server(self, address: str) -> None:
        await self.db.execute(
            "DELETE FROM object_placement WHERE server_address=?", address
        )

    async def remove(self, object_id: ObjectId) -> None:
        await self.db.execute(
            "DELETE FROM object_placement WHERE struct_name=? AND object_id=?",
            object_id.type_name, object_id.id,
        )
        await self.db.execute(
            "DELETE FROM object_standby WHERE struct_name=? AND object_id=?",
            object_id.type_name, object_id.id,
        )

    async def set_standbys(self, object_id: ObjectId, addresses: list[str]) -> int:
        # Upsert that PRESERVES the fence: only promote_standby moves epoch.
        await self.db.execute(
            "INSERT INTO object_standby (struct_name, object_id, standbys, epoch) "
            "VALUES (?,?,?,0) ON CONFLICT(struct_name, object_id) "
            "DO UPDATE SET standbys=excluded.standbys",
            object_id.type_name, object_id.id, ",".join(addresses),
        )
        _, epoch = await self.standbys(object_id)
        return epoch

    async def standbys(self, object_id: ObjectId) -> tuple[list[str], int]:
        rows = await self.db.execute(
            "SELECT standbys, epoch FROM object_standby "
            "WHERE struct_name=? AND object_id=?",
            object_id.type_name, object_id.id,
        )
        if not rows:
            return [], 0
        held, epoch = rows[0]
        # TEXT-affinity columns round-trip whatever a legacy writer stored;
        # degrade garbage to "no standbys" instead of crashing the read path.
        if isinstance(held, bytes):
            try:
                held = held.decode()
            except UnicodeDecodeError:
                held = ""
        if not isinstance(held, str):
            held = ""
        return sanitize_standby_row([a for a in held.split(",") if a], epoch)

    async def promote_standby(
        self, object_id: ObjectId, address: str, expected_epoch: int
    ) -> int | None:
        held, epoch = await self.standbys(object_id)
        if epoch != expected_epoch or address not in held:
            return None
        remaining = ",".join(a for a in held if a != address)
        # CAS: the epoch guard in the WHERE makes a lost race a 0-row
        # update; the re-read below distinguishes "we won" from "someone
        # else promoted a different standby first".
        await self.db.execute(
            "UPDATE object_standby SET standbys=?, epoch=epoch+1 "
            "WHERE struct_name=? AND object_id=? AND epoch=?",
            remaining, object_id.type_name, object_id.id, expected_epoch,
        )
        held2, epoch2 = await self.standbys(object_id)
        if epoch2 != expected_epoch + 1 or address in held2:
            return None
        await self.update(ObjectPlacementItem(object_id, address))
        return epoch2

    async def items(self) -> list[ObjectPlacementItem]:
        rows = await self.db.execute(
            "SELECT struct_name, object_id, server_address "
            "FROM object_placement WHERE server_address IS NOT NULL"
        )
        return [
            ObjectPlacementItem(ObjectId(t, i), addr) for t, i, addr in rows
        ]

    def close(self) -> None:
        self.db.close()
