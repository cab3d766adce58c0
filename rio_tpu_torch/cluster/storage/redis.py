"""Redis membership storage.

Reference: ``rio-rs/src/cluster/storage/redis.rs:85-159`` — one hash of
``ip:port -> "ip;port;active;timestamp"`` plus a per-member failure list
trimmed to the most recent 1,000 entries. Keys take a configurable prefix so
tests can isolate under one shared server (the reference's test-isolation
trick, ``tests/cluster_storage_backend.rs:50``).
"""

from __future__ import annotations

import time

from ...utils.resp import RedisClient
from . import Member, MembershipStorage

FAILURE_KEEP = 1000  # reference LTRIM bound (redis.rs:~150)
FAILURE_READ = 100   # parity with the SQL backends' LIMIT 100


class RedisMembershipStorage(MembershipStorage):
    def __init__(self, client: RedisClient | str, key_prefix: str = "rio") -> None:
        self.client = (
            RedisClient.from_url(client) if isinstance(client, str) else client
        )
        self.prefix = key_prefix

    @property
    def _members_key(self) -> str:
        return f"{self.prefix}:members"

    def _failures_key(self, ip: str, port: int) -> str:
        return f"{self.prefix}:member_failures:{ip}:{port}"

    @staticmethod
    def _encode(member: Member, last_seen: float | None = None) -> str:
        ts = member.last_seen if last_seen is None else last_seen
        # The load vector is comma-joined floats (LoadVector.encode) and the
        # shard map is "epoch|addr,addr" (ShardMap.encode), so neither can
        # collide with this value's own ';' separator.
        return (
            f"{member.ip};{member.port};{int(member.active)};{ts};"
            f"{member.load};{member.shard_map}"
        )

    @staticmethod
    def _decode(raw: bytes) -> Member:
        # Tolerate short values written before the load / shard_map columns
        # existed (4- and 5-field legacies respectively).
        parts = raw.decode().split(";")
        ip, port, active, last_seen = parts[:4]
        load = parts[4] if len(parts) > 4 else ""
        shard_map = parts[5] if len(parts) > 5 else ""
        return Member(ip=ip, port=int(port), active=active == "1",
                      last_seen=float(last_seen), load=load, shard_map=shard_map)

    async def push(self, member: Member) -> None:
        # Timestamp goes into the stored value only — the caller's Member is
        # left untouched, matching the SQL backends (sqlite.py push).
        await self.client.execute(
            "HSET", self._members_key, member.address,
            self._encode(member, last_seen=time.time()),
        )

    async def remove(self, ip: str, port: int) -> None:
        await self.client.execute("HDEL", self._members_key, f"{ip}:{port}")
        await self.client.execute("DEL", self._failures_key(ip, port))

    async def set_is_active(self, ip: str, port: int, active: bool) -> None:
        raw = await self.client.execute("HGET", self._members_key, f"{ip}:{port}")
        if raw is None:
            return
        m = self._decode(raw)
        m.active = active
        if active:
            m.last_seen = time.time()
        await self.client.execute("HSET", self._members_key, m.address, self._encode(m))

    async def members(self) -> list[Member]:
        flat = await self.client.execute("HGETALL", self._members_key)
        return [self._decode(flat[i + 1]) for i in range(0, len(flat), 2)]

    async def notify_failure(self, ip: str, port: int) -> None:
        key = self._failures_key(ip, port)
        await self.client.execute("RPUSH", key, repr(time.time()))
        await self.client.execute("LTRIM", key, -FAILURE_KEEP, -1)

    async def member_failures(self, ip: str, port: int) -> list[float]:
        raw = await self.client.execute(
            "LRANGE", self._failures_key(ip, port), -FAILURE_READ, -1
        )
        return [float(r) for r in raw or []]

    def close(self) -> None:
        self.client.close()
