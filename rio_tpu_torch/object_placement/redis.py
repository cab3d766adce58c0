"""Redis object-placement directory.

Reference: ``rio-rs/src/object_placement/redis.rs:36-87`` — one key per
object (``{prefix}:placement:{type}.{id} -> address``) plus a per-server set
of placed object keys so ``clean_server`` can bulk-unassign everything on a
dead node without scanning the keyspace.
"""

from __future__ import annotations

from typing import Callable

from ..registry import ObjectId
from ..utils.resp import RedisClient, RespError, check_replies
from . import ObjectPlacement, ObjectPlacementItem, sanitize_standby_row

# Optimistic-lock retries before a standby CAS gives up. Contention on one
# object's replica row is a handful of promoters post-death, not a hot path;
# hitting the ceiling means the row is being rewritten pathologically fast.
_CAS_ATTEMPTS = 64


class RedisObjectPlacement(ObjectPlacement):
    def __init__(self, client: RedisClient | str, key_prefix: str = "rio") -> None:
        self.client = (
            RedisClient.from_url(client) if isinstance(client, str) else client
        )
        self.prefix = key_prefix

    def _obj_key(self, key: str) -> str:
        return f"{self.prefix}:placement:{key}"

    def _server_key(self, address: str) -> str:
        return f"{self.prefix}:placement_server:{address}"

    def _standby_key(self, key: str) -> str:
        return f"{self.prefix}:standby:{key}"

    async def update(self, item: ObjectPlacementItem) -> None:
        await self.update_batch([item])

    async def update_batch(self, items: list[ObjectPlacementItem]) -> None:
        """Pipelined upsert (reference uses ``redis::pipe()`` similarly):
        one round trip to read old addresses, one for all writes."""
        if not items:
            return
        keys = [str(i.object_id) for i in items]
        olds = check_replies(
            await self.client.execute_pipeline(
                [("GET", self._obj_key(k)) for k in keys]
            )
        )
        cmds: list[tuple] = []
        for item, key, old in zip(items, keys, olds):
            if isinstance(old, bytes):
                cmds.append(("SREM", self._server_key(old.decode()), key))
            if item.server_address is None:
                cmds.append(("DEL", self._obj_key(key)))
            else:
                cmds.append(("SET", self._obj_key(key), item.server_address))
                cmds.append(("SADD", self._server_key(item.server_address), key))
        check_replies(await self.client.execute_pipeline(cmds))

    async def lookup(self, object_id: ObjectId) -> str | None:
        raw = await self.client.execute("GET", self._obj_key(str(object_id)))
        return raw.decode() if raw is not None else None

    async def clean_server(self, address: str) -> None:
        """Bulk-unassign a dead node's objects.

        The per-server set is a snapshot, so re-read each key and delete only
        those still pointing at ``address`` — a re-placement that lands
        before the GET survives. A re-placement racing *between* the GET and
        the DEL can still be lost (check-then-act; closing it fully needs
        Lua/WATCH compare-and-delete) — the same exposure class as the
        reference's snapshot-then-delete Redis impl, vs. the SQL backends'
        atomic ``DELETE WHERE server_address=?``. Pipelined: 2 round trips +
        1 variadic DEL regardless of object count.
        """
        raw_keys = await self.client.execute("SMEMBERS", self._server_key(address))
        keys = [k.decode() for k in raw_keys or []]
        if keys:
            current = check_replies(
                await self.client.execute_pipeline(
                    [("GET", self._obj_key(k)) for k in keys]
                )
            )
            stale = [
                self._obj_key(k)
                for k, cur in zip(keys, current)
                if isinstance(cur, bytes) and cur.decode() == address
            ]
            if stale:
                await self.client.execute("DEL", *stale)
        await self.client.execute("DEL", self._server_key(address))

    async def remove(self, object_id: ObjectId) -> None:
        key = str(object_id)
        old = await self.client.execute("GET", self._obj_key(key))
        cmds: list[tuple] = [("DEL", self._obj_key(key)), ("DEL", self._standby_key(key))]
        if old is not None:
            cmds.insert(0, ("SREM", self._server_key(old.decode()), key))
        check_replies(await self.client.execute_pipeline(cmds))

    @staticmethod
    def _parse_standby(raw: object) -> tuple[list[str], int]:
        # Value is ``"{epoch}|{addr,...}"``; legacy/garbage values (wrong
        # type, undecodable bytes, non-integer epoch) degrade to "no
        # standbys" rather than raising on the read path.
        if not isinstance(raw, bytes):
            return [], 0
        try:
            text = raw.decode()
        except UnicodeDecodeError:
            return [], 0
        epoch_s, _, held = text.partition("|")
        return sanitize_standby_row([a for a in held.split(",") if a], epoch_s)

    async def _standby_row(self, key: str) -> tuple[list[str], int]:
        return self._parse_standby(
            await self.client.execute("GET", self._standby_key(key))
        )

    async def _standby_cas(
        self,
        key: str,
        decide: Callable[[list[str], int], tuple[list[tuple] | None, int | None]],
    ) -> int | None:
        """Atomic read-modify-write on the standby row via WATCH/MULTI/EXEC.

        ``decide(held, epoch)`` returns ``(write_cmds, result)``;
        ``write_cmds is None`` aborts without touching the row. A concurrent
        writer between WATCH and EXEC voids the transaction (null EXEC
        reply) and the loop re-reads — the epoch fence can never be written
        from a stale read, unlike the plain read-then-SET this replaces
        (two racing promoters could both bump from the same epoch).
        """
        skey = self._standby_key(key)
        for _ in range(_CAS_ATTEMPTS):
            async with self.client.transaction() as txn:
                await txn.execute("WATCH", skey)
                held, epoch = self._parse_standby(await txn.execute("GET", skey))
                cmds, result = decide(held, epoch)
                if cmds is None:
                    await txn.execute("UNWATCH")
                    return result
                await txn.execute("MULTI")
                for c in cmds:
                    await txn.execute(*c)
                if await txn.execute("EXEC") is not None:
                    return result
        raise RespError(f"standby CAS on {key!r} lost {_CAS_ATTEMPTS} races")

    async def set_standbys(self, object_id: ObjectId, addresses: list[str]) -> int:
        key = str(object_id)
        skey = self._standby_key(key)

        def decide(held: list[str], epoch: int) -> tuple[list[tuple], int]:
            # Epoch only moves in promote_standby; writing under WATCH means
            # a promotion racing this replacement can't have its bump rolled
            # back to the pre-promotion value.
            if addresses or epoch:
                return [("SET", skey, f"{epoch}|{','.join(addresses)}")], epoch
            return [("DEL", skey)], epoch

        epoch = await self._standby_cas(key, decide)
        assert epoch is not None
        return epoch

    async def standbys(self, object_id: ObjectId) -> tuple[list[str], int]:
        return await self._standby_row(str(object_id))

    async def promote_standby(
        self, object_id: ObjectId, address: str, expected_epoch: int
    ) -> int | None:
        key = str(object_id)
        skey = self._standby_key(key)

        def decide(
            held: list[str], epoch: int
        ) -> tuple[list[tuple] | None, int | None]:
            if epoch != expected_epoch or address not in held:
                return None, None
            remaining = ",".join(a for a in held if a != address)
            return [("SET", skey, f"{epoch + 1}|{remaining}")], epoch + 1

        new_epoch = await self._standby_cas(key, decide)
        if new_epoch is None:
            return None
        await self.update(ObjectPlacementItem(object_id, address))
        return new_epoch

    async def lookup_batch(self, object_ids: list[ObjectId]) -> list[str | None]:
        # A failed GET must raise, not read as "unplaced" — a None here
        # green-lights a second activation of a possibly-seated object.
        raws = check_replies(
            await self.client.execute_pipeline(
                [("GET", self._obj_key(str(o))) for o in object_ids]
            )
        )
        return [r.decode() if isinstance(r, bytes) else None for r in raws]

    async def items(self) -> list[ObjectPlacementItem]:
        """Enumerate via KEYS on the placement prefix + one pipelined MGET
        pass. KEYS is O(keyspace) and blocking — acceptable for the warm
        RESTART path this exists for (PersistentJaxObjectPlacement.prepare
        runs once, before traffic), not for request-path use."""
        prefix = self._obj_key("")
        raw_keys = await self.client.execute("KEYS", prefix + "*")
        keys = [k.decode()[len(prefix):] for k in raw_keys or []]
        if not keys:
            return []
        raws = check_replies(
            await self.client.execute_pipeline(
                [("GET", self._obj_key(k)) for k in keys]
            )
        )
        return [
            ObjectPlacementItem(ObjectId(*k.split(".", 1)), r.decode())
            for k, r in zip(keys, raws)
            if isinstance(r, bytes)
        ]

    def close(self) -> None:
        self.client.close()
