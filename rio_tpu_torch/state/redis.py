"""Redis state persistence.

Reference: ``rio-rs/src/state/redis.rs:33-60`` — one JSON value per
``(object_kind, object_id, state_type)`` key.
"""

from __future__ import annotations

from typing import Any

from .. import codec
from ..errors import StateNotFound
from ..utils.resp import RedisClient
from . import StateProvider


class RedisState(StateProvider):
    def __init__(self, client: RedisClient | str, key_prefix: str = "rio") -> None:
        self.client = (
            RedisClient.from_url(client) if isinstance(client, str) else client
        )
        self.prefix = key_prefix

    def _key(self, object_kind: str, object_id: str, state_type: str) -> str:
        return f"{self.prefix}:state:{object_kind}:{object_id}:{state_type}"

    async def load(self, object_kind: str, object_id: str, state_type: str, ty: Any) -> Any:
        raw = await self.client.execute("GET", self._key(object_kind, object_id, state_type))
        if raw is None:
            raise StateNotFound(f"{object_kind}/{object_id}/{state_type}")
        return codec.deserialize_json(raw.decode(), ty)

    async def save(self, object_kind: str, object_id: str, state_type: str, value: Any) -> None:
        await self.client.execute(
            "SET", self._key(object_kind, object_id, state_type), codec.serialize_json(value)
        )

    async def delete(self, object_kind: str, object_id: str, state_type: str) -> None:
        await self.client.execute("DEL", self._key(object_kind, object_id, state_type))

    def close(self) -> None:
        self.client.close()
