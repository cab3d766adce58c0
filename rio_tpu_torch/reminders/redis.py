"""Redis reminder storage.

Layout (all under ``{prefix}:``):

* ``rem:{kind}:{id}:{name}`` — one JSON document per reminder;
* ``sched:{shard}`` — sorted set scoring each reminder key by ``next_due``
  (the ``due`` scan is one ``ZRANGEBYSCORE``, like the reference keeps its
  failure ledger in native list structures rather than serialized blobs);
* ``obj:{kind}:{id}`` — set of reminder names (object-scoped enumeration);
* ``lease:{shard}`` / ``leaseepoch:{shard}`` — lease JSON + a monotone
  ``INCR`` epoch counter.

Lease semantics: a *fresh* acquisition uses ``SET NX`` (atomic — a race has
exactly one winner). Takeover of an *expired* lease is read-check-write:
two nodes racing the same expired lease can transiently both believe they
own the shard for one tick. That window is accepted by design — delivery is
at-least-once and ``epoch`` (bumped through ``INCR`` before either write)
still totally orders the owners; Lua/WATCH would buy exactly-once ticking
the daemon doesn't promise anyway.
"""

from __future__ import annotations

import json
import time

from ..utils.resp import RedisClient, check_replies
from . import NUM_REMINDER_SHARDS, Lease, Reminder, ReminderStorage

_SEP = "\x1f"  # object ids may contain ':' and '.', so field-separate keys


class RedisReminderStorage(ReminderStorage):
    def __init__(
        self,
        client: RedisClient | str,
        key_prefix: str = "rio",
        num_shards: int = NUM_REMINDER_SHARDS,
    ) -> None:
        self.client = (
            RedisClient.from_url(client) if isinstance(client, str) else client
        )
        self.prefix = key_prefix
        self.num_shards = num_shards

    # -- keys ---------------------------------------------------------------

    def _rem_key(self, kind: str, oid: str, name: str) -> str:
        return f"{self.prefix}:rem:{kind}:{oid}:{name}"

    def _sched_key(self, shard: int) -> str:
        return f"{self.prefix}:sched:{shard}"

    def _obj_key(self, kind: str, oid: str) -> str:
        return f"{self.prefix}:obj:{kind}:{oid}"

    def _lease_key(self, shard: int) -> str:
        return f"{self.prefix}:lease:{shard}"

    @staticmethod
    def _member(kind: str, oid: str, name: str) -> str:
        return _SEP.join((kind, oid, name))

    @staticmethod
    def _doc(r: Reminder) -> str:
        return json.dumps(
            [r.object_kind, r.object_id, r.reminder_name, r.period, r.next_due, r.shard]
        )

    @staticmethod
    def _parse(raw: bytes | None) -> Reminder | None:
        if raw is None:
            return None
        return Reminder(*json.loads(raw))

    # -- reminders ----------------------------------------------------------

    async def upsert(self, reminder: Reminder) -> None:
        r = reminder
        r.shard = self.shard_for(r.object_kind, r.object_id)
        member = self._member(r.object_kind, r.object_id, r.reminder_name)
        check_replies(await self.client.execute_pipeline([
            ("SET", self._rem_key(r.object_kind, r.object_id, r.reminder_name), self._doc(r)),
            ("ZADD", self._sched_key(r.shard), r.next_due, member),
            ("SADD", self._obj_key(r.object_kind, r.object_id), r.reminder_name),
        ]))

    async def remove(self, object_kind: str, object_id: str, reminder_name: str) -> None:
        shard = self.shard_for(object_kind, object_id)
        member = self._member(object_kind, object_id, reminder_name)
        check_replies(await self.client.execute_pipeline([
            ("DEL", self._rem_key(object_kind, object_id, reminder_name)),
            ("ZREM", self._sched_key(shard), member),
            ("SREM", self._obj_key(object_kind, object_id), reminder_name),
        ]))

    async def remove_object(self, object_kind: str, object_id: str) -> None:
        names = await self.client.execute("SMEMBERS", self._obj_key(object_kind, object_id))
        for name in names:
            await self.remove(object_kind, object_id, name.decode())

    async def list_object(self, object_kind: str, object_id: str) -> list[Reminder]:
        names = sorted(
            n.decode()
            for n in await self.client.execute(
                "SMEMBERS", self._obj_key(object_kind, object_id)
            )
        )
        if not names:
            return []
        raws = check_replies(await self.client.execute_pipeline(
            [("GET", self._rem_key(object_kind, object_id, n)) for n in names]
        ))
        return [r for r in (self._parse(raw) for raw in raws) if r is not None]

    async def due(self, shard: int, now: float, limit: int = 256) -> list[Reminder]:
        members = await self.client.execute(
            "ZRANGEBYSCORE", self._sched_key(shard), "-inf", now, "LIMIT", 0, limit
        )
        if not members:
            return []
        keys = []
        for m in members:
            kind, oid, name = m.decode().split(_SEP)
            keys.append(self._rem_key(kind, oid, name))
        raws = check_replies(
            await self.client.execute_pipeline([("GET", k) for k in keys])
        )
        return [r for r in (self._parse(raw) for raw in raws) if r is not None]

    async def reschedule(
        self, object_kind: str, object_id: str, reminder_name: str, next_due: float
    ) -> None:
        raw = await self.client.execute(
            "GET", self._rem_key(object_kind, object_id, reminder_name)
        )
        r = self._parse(raw)
        if r is None:
            return
        r.next_due = next_due
        member = self._member(object_kind, object_id, reminder_name)
        check_replies(await self.client.execute_pipeline([
            ("SET", self._rem_key(object_kind, object_id, reminder_name), self._doc(r)),
            ("ZADD", self._sched_key(r.shard), next_due, member),
        ]))

    async def shard_counts(self) -> dict[int, int]:
        counts = check_replies(await self.client.execute_pipeline(
            [("ZCARD", self._sched_key(s)) for s in range(self.num_shards)]
        ))
        return {s: int(c) for s, c in enumerate(counts) if int(c)}

    # -- leases -------------------------------------------------------------

    async def acquire_lease(
        self, shard: int, owner: str, ttl: float, now: float | None = None
    ) -> Lease | None:
        now = time.time() if now is None else now
        key = self._lease_key(shard)
        raw = await self.client.execute("GET", key)
        if raw is not None:
            o, epoch, expires_at = json.loads(raw)
            if o == owner:
                # Renewal — even past expiry: owner unchanged, epoch frozen
                # (matches the sqlite protocol).
                lease = Lease(shard, owner, int(epoch), now + ttl)
                await self.client.execute("SET", key, json.dumps([owner, epoch, lease.expires_at]))
                return lease
            if expires_at > now:
                return None
        epoch = int(await self.client.execute("INCR", f"{self.prefix}:leaseepoch:{shard}"))
        payload = json.dumps([owner, epoch, now + ttl])
        if raw is None:
            # Fresh shard: NX makes the race atomic — exactly one winner.
            if await self.client.execute("SET", key, payload, "NX") is None:
                return None
        else:
            # Expired-lease takeover (read-check-write; see module docstring).
            await self.client.execute("SET", key, payload)
        return Lease(shard, owner, epoch, now + ttl)

    async def release_lease(self, shard: int, owner: str, epoch: int) -> None:
        key = self._lease_key(shard)
        raw = await self.client.execute("GET", key)
        if raw is None:
            return
        o, e, _ = json.loads(raw)
        if o == owner and int(e) == epoch:
            await self.client.execute("SET", key, json.dumps([o, e, 0.0]))

    async def get_lease(self, shard: int) -> Lease | None:
        raw = await self.client.execute("GET", self._lease_key(shard))
        if raw is None:
            return None
        o, e, exp = json.loads(raw)
        return Lease(shard, o, int(e), float(exp))

    def close(self) -> None:
        self.client.close()
