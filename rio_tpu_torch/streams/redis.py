"""Redis stream storage.

Layout (all under ``{prefix}:``):

* ``slog:{stream}:{partition}`` — the append log as a native list
  (``RPUSH``/``LRANGE``/``LLEN``): the new length minus one IS the
  assigned offset, so offset assignment is atomic with the append (no
  read-back like the SQL backends need). Each element is the
  codec-serialized :class:`~rio_tpu_torch.streams.StreamRecord` with offset 0 —
  the true offset is its list index, stamped on read.
* ``ssub:{stream}`` — hash of group → JSON subscription doc;
* ``scur:{stream}:{group}:{partition}`` — committed offset as a plain
  integer string. The monotone guard is read-check-write: two cursors
  racing a commit can transiently write the smaller value, which the
  next commit or redelivery pass repairs — accepted exactly like the
  reminder lease takeover window (delivery is at-least-once anyway).
"""

from __future__ import annotations

import json
import time

from .. import codec
from ..utils.resp import RedisClient, check_replies
from . import NUM_STREAM_PARTITIONS, StreamRecord, StreamStorage, Subscription


class RedisStreamStorage(StreamStorage):
    def __init__(
        self,
        client: RedisClient | str,
        key_prefix: str = "rio",
        num_partitions: int = NUM_STREAM_PARTITIONS,
    ) -> None:
        self.client = (
            RedisClient.from_url(client) if isinstance(client, str) else client
        )
        self.prefix = key_prefix
        self.num_partitions = num_partitions

    # -- keys ---------------------------------------------------------------

    def _log_key(self, stream: str, partition: int) -> str:
        return f"{self.prefix}:slog:{stream}:{partition}"

    def _sub_key(self, stream: str) -> str:
        return f"{self.prefix}:ssub:{stream}"

    def _cur_key(self, stream: str, group: str, partition: int) -> str:
        return f"{self.prefix}:scur:{stream}:{group}:{partition}"

    # -- log ----------------------------------------------------------------

    async def append(self, record: StreamRecord) -> int:
        r = record
        if not r.ts:
            r.ts = time.time()
        r.offset = 0  # index-addressed; the list position is the offset
        length = int(
            await self.client.execute(
                "RPUSH", self._log_key(r.stream, r.partition), codec.serialize(r)
            )
        )
        r.offset = length - 1
        return r.offset

    async def read(
        self, stream: str, partition: int, from_offset: int, limit: int = 256
    ) -> list[StreamRecord]:
        start = max(0, from_offset)
        raws = await self.client.execute(
            "LRANGE", self._log_key(stream, partition), start, start + limit - 1
        )
        out = []
        for i, raw in enumerate(raws):
            rec = codec.deserialize(raw, StreamRecord)
            rec.offset = start + i
            out.append(rec)
        return out

    async def latest(self, stream: str, partition: int) -> int:
        return int(await self.client.execute("LLEN", self._log_key(stream, partition)))

    # -- subscriptions ------------------------------------------------------

    async def subscribe(self, sub: Subscription) -> None:
        doc = json.dumps([sub.stream, sub.group, sub.target_type, sub.redelivery_period])
        await self.client.execute("HSET", self._sub_key(sub.stream), sub.group, doc)

    async def unsubscribe(self, stream: str, group: str) -> None:
        await self.client.execute("HDEL", self._sub_key(stream), group)

    async def subscriptions(self, stream: str) -> list[Subscription]:
        flat = await self.client.execute("HGETALL", self._sub_key(stream))
        subs = [Subscription(*json.loads(flat[i + 1])) for i in range(0, len(flat), 2)]
        subs.sort(key=lambda s: s.group)
        return subs

    # -- cursors ------------------------------------------------------------

    async def commit(
        self, stream: str, group: str, partition: int, offset: int
    ) -> None:
        key = self._cur_key(stream, group, partition)
        cur = await self.client.execute("GET", key)
        if cur is None or int(cur) < offset:
            await self.client.execute("SET", key, offset)

    async def committed(self, stream: str, group: str, partition: int) -> int:
        raw = await self.client.execute("GET", self._cur_key(stream, group, partition))
        return int(raw) if raw is not None else 0

    async def cursors(self, stream: str, group: str) -> dict[int, int]:
        replies = check_replies(await self.client.execute_pipeline(
            [("GET", self._cur_key(stream, group, p)) for p in range(self.num_partitions)]
        ))
        return {p: int(r) for p, r in enumerate(replies) if r is not None}

    def close(self) -> None:
        self.client.close()
