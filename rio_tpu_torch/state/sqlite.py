"""SQLite state provider.

Reference: ``rio-rs/src/state/sqlite.rs:54-115`` — table
``state_provider_object_state(object_kind, object_id, state_type,
serialized_state)`` with JSON-serialized values.
"""

from __future__ import annotations

from typing import Any

from .. import codec
from ..errors import StateNotFound
from ..utils.sqlite import SqliteDb
from . import StateProvider

MIGRATIONS = [
    """
    CREATE TABLE IF NOT EXISTS state_provider_object_state (
        object_kind      TEXT NOT NULL,
        object_id        TEXT NOT NULL,
        state_type       TEXT NOT NULL,
        serialized_state TEXT NOT NULL,
        PRIMARY KEY (object_kind, object_id, state_type)
    );
    """
]


class SqliteState(StateProvider):
    def __init__(self, path: str) -> None:
        self.db = SqliteDb(path)

    async def prepare(self) -> None:
        await self.db.migrate(MIGRATIONS)

    async def load(self, object_kind: str, object_id: str, state_type: str, ty: Any) -> Any:
        rows = await self.db.execute(
            "SELECT serialized_state FROM state_provider_object_state "
            "WHERE object_kind=? AND object_id=? AND state_type=?",
            object_kind, object_id, state_type,
        )
        if not rows:
            raise StateNotFound(f"{object_kind}/{object_id}/{state_type}")
        return codec.deserialize_json(rows[0][0], ty)

    async def save(self, object_kind: str, object_id: str, state_type: str, value: Any) -> None:
        await self.db.execute(
            "INSERT INTO state_provider_object_state "
            "(object_kind, object_id, state_type, serialized_state) VALUES (?,?,?,?) "
            "ON CONFLICT(object_kind, object_id, state_type) "
            "DO UPDATE SET serialized_state=excluded.serialized_state",
            object_kind, object_id, state_type, codec.serialize_json(value),
        )

    async def delete(self, object_kind: str, object_id: str, state_type: str) -> None:
        await self.db.execute(
            "DELETE FROM state_provider_object_state "
            "WHERE object_kind=? AND object_id=? AND state_type=?",
            object_kind, object_id, state_type,
        )

    def close(self) -> None:
        self.db.close()
