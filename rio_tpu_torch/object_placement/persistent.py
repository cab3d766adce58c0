"""Durability bridge: the device-solved directory with a write-behind backing store.

Counterpart of ``rio_tpu/object_placement/persistent.py``.
:class:`~rio_tpu_torch.object_placement.torch_placement.TorchObjectPlacement`
keeps the directory in a host mirror for O(1) lookups and batched device
solves; a restart loses it and relies on lazy re-allocation.
:class:`PersistentTorchObjectPlacement` keeps the speed and adds
durability: every mirror mutation (allocation, update, rebalance apply,
clean_server, remove) marks the key dirty, and a background flusher
coalesces the dirty set into batched writes against any
``ObjectPlacement``-shaped backing store (SQLite, Postgres, Redis, the
in-memory :class:`~rio_tpu_torch.object_placement.LocalObjectPlacement`).
``prepare()`` warm-restores the whole directory through the backing's
``items()``.

Consistency model — write-behind, deliberately:

* the solver path never waits on the database;
* a crash loses at most ``flush_interval`` worth of placements, each of
  which lazy re-allocation re-seats on first touch;
* flush failures keep the dirty set (newer marks win the merge) and retry
  on the next cycle: a backing store that is briefly down degrades
  durability freshness, never availability.

Every mirror write runs on the event loop (the base class applies solver
results there), so the flusher is started with ``get_running_loop()``.
"""

from __future__ import annotations

import asyncio
import logging

from ..registry import ObjectId
from . import ObjectPlacement, ObjectPlacementItem, sanitize_standby_row
from .torch_placement import TorchObjectPlacement

log = logging.getLogger(__name__)

__all__ = ["PersistentTorchObjectPlacement"]


class PersistentTorchObjectPlacement(TorchObjectPlacement):
    """TorchObjectPlacement + write-behind durability on a backing store."""

    def __init__(
        self,
        backing: ObjectPlacement,
        *,
        flush_interval: float = 0.05,
        **torch_kwargs,
    ) -> None:
        super().__init__(**torch_kwargs)
        self._backing = backing
        self._flush_interval = flush_interval
        self._dirty: dict[str, str | None] = {}  # key -> address | None=delete
        self._dirty_standbys: dict[str, list[str]] = {}  # key -> standby set
        self._flusher: asyncio.Task | None = None
        self._flush_wake: asyncio.Event | None = None  # created on the loop
        self._flush_lock = asyncio.Lock()  # serializes manual + background
        self._restoring = False

    # ------------------------------------------------------------- restore
    async def prepare(self) -> None:
        """Warm-restore the mirror from the backing store (once, at boot)."""
        await self._backing.prepare()
        items = await self._backing.items()
        async with self._lock:
            self._restoring = True
            known = set(self._nodes)
            try:
                for item in items:
                    if item.server_address is not None:
                        self._set_placement(
                            str(item.object_id),
                            self._node_index(item.server_address),
                        )
            finally:
                self._restoring = False
            # Nodes the restore had to invent are hearsay from the stored
            # directory (the node may have died while this one was down):
            # they start dead, so the solver never seats NEW objects on a
            # ghost; sync_members/register_node revives the live ones.
            for address in set(self._nodes) - known:
                self._nodes[address].alive = False
            # The restored population counts as load, or the next
            # allocation treats the cluster as empty.
            self._recount_loads()
            if items:
                self._epoch += 1
        log.info("restored %d placements from %s", len(items), type(self._backing).__name__)

    # ------------------------------------------------------- dirty tracking
    # Every mirror mutation of the base class flows through these four
    # methods (allocation apply, rebalance mover loop, update, remove,
    # clean_server, replica rows), so overriding them catches the write set.
    def _set_placement(self, key: str, idx: int) -> bool:
        changed = super()._set_placement(key, idx)
        if changed and not self._restoring:
            self._mark(key, self._node_order[idx])
        return changed

    def _drop_placement(self, key: str) -> int | None:
        idx = super()._drop_placement(key)
        if idx is not None and not self._restoring:
            self._mark(key, None)
        return idx

    def _set_standby_row(self, key: str, addresses: list[str], epoch: int) -> None:
        super()._set_standby_row(key, addresses, epoch)
        if not self._restoring:
            self._dirty_standbys[key] = list(addresses)
            self._wake_flusher()

    def _drop_standby_row(self, key: str) -> None:
        super()._drop_standby_row(key)
        if not self._restoring:
            self._dirty_standbys[key] = []
            self._wake_flusher()

    def _mark(self, key: str, address: str | None) -> None:
        self._dirty[key] = address
        self._wake_flusher()

    def _wake_flusher(self) -> None:
        if self._flush_wake is None:
            self._flush_wake = asyncio.Event()
        self._flush_wake.set()
        if self._flusher is None or self._flusher.done():
            self._flusher = asyncio.get_running_loop().create_task(self._flush_loop())

    # --------------------------------------------------------------- flush
    async def _flush_loop(self) -> None:
        assert self._flush_wake is not None
        while True:
            await self._flush_wake.wait()
            self._flush_wake.clear()
            # Coalesce a burst (one rebalance marks ~the displaced share)
            # into one batched write.
            await asyncio.sleep(self._flush_interval)
            try:
                await self.flush()
            except Exception:
                log.exception("placement write-behind flush failed; retrying")
                await asyncio.sleep(self._flush_interval)
                self._flush_wake.set()

    async def flush(self) -> int:
        """Write the current dirty set to the backing store (also callable
        directly, e.g. before a planned shutdown). Returns rows written.

        Serialized against the background flusher: a manual flush must not
        return while an in-flight background write still holds part of the
        dirty set.
        """
        async with self._flush_lock:
            return await self._flush_locked()

    async def _flush_locked(self) -> int:
        flushed = await self._flush_standbys_locked()
        if not self._dirty:
            return flushed
        dirty, self._dirty = self._dirty, {}
        try:
            # One batched write for updates AND deletes: every backend's
            # update_batch treats server_address=None as unassign.
            await self._backing.update_batch(
                [
                    ObjectPlacementItem(ObjectId(*k.split(".", 1)), addr)
                    for k, addr in dirty.items()
                ]
            )
        except BaseException:
            # Failed rows stay dirty; marks made DURING the failed flush are
            # newer and win the merge. BaseException on purpose: a flusher
            # cancelled mid-write (aclose during a flush) must also put its
            # unwritten marks back for the final flush.
            for k, addr in dirty.items():
                self._dirty.setdefault(k, addr)
            raise
        return flushed + len(dirty)

    async def _flush_standbys_locked(self) -> int:
        if not self._dirty_standbys:
            return 0
        dirty, self._dirty_standbys = self._dirty_standbys, {}
        done = 0
        try:
            # Per-key writes (the trait has no standby batch hook); the
            # backing keeps its own epoch — only promote_standby
            # (write-through below) moves it.
            for k, addrs in list(dirty.items()):
                await self._backing.set_standbys(ObjectId(*k.split(".", 1)), addrs)
                dirty.pop(k)
                done += 1
        except BaseException:
            for k, addrs in dirty.items():
                self._dirty_standbys.setdefault(k, addrs)
            raise
        return done

    # ------------------------------------------------------- replica rows
    # Standby SETS ride the write-behind like primary rows; the EPOCH is the
    # failover fence and must be durable the instant it moves, so
    # promote_standby is write-through: the backing store's CAS decides and
    # the mirror follows.

    async def standbys(self, object_id) -> tuple[list[str], int]:
        key = str(object_id)
        row = self._standby_rows.get(key)
        if row is not None:
            held, epoch = row
            return sanitize_standby_row(held, epoch)
        # Mirror miss (cold restart): read through, not cached — a row is
        # mirrored once this node writes it, keeping the restore lazy.
        return await self._backing.standbys(object_id)

    async def set_standbys(self, object_id, addresses: list[str]) -> int:
        # Seed the mirror with the BACKING's epoch on first touch after a
        # restart, or the returned fence would restart at 0 behind the
        # durable row.
        key = str(object_id)
        if key not in self._standby_rows:
            _, epoch = await self._backing.standbys(object_id)
            async with self._lock:
                if key not in self._standby_rows:
                    self._set_standby_row(key, list(addresses), epoch)
                    return epoch
        return await super().set_standbys(object_id, addresses)

    async def promote_standby(
        self, object_id, address: str, expected_epoch: int
    ) -> int | None:
        # The durable CAS must see this node's standby writes first.
        await self.flush()
        new_epoch = await self._backing.promote_standby(object_id, address, expected_epoch)
        if new_epoch is None:
            return None
        key = str(object_id)
        # Cold-restart mirror miss: the post-CAS backing row is
        # authoritative (it already excludes the promoted address);
        # rebuilding from ([], 0) would flush an empty set over the
        # surviving standbys.
        survivors: list[str] | None = None
        if key not in self._standby_rows:
            survivors, _ = await self._backing.standbys(object_id)
        async with self._lock:
            row = self._standby_rows.get(key)
            if row is not None:
                survivors = [a for a in row[0] if a != address]
            self._set_standby_row(key, survivors or [], new_epoch)
            self._set_placement(key, self._node_index(address))
            self._epoch += 1
        return new_epoch

    async def aclose(self) -> None:
        """Final flush + stop the flusher (planned shutdown)."""
        if self._flusher is not None:
            self._flusher.cancel()
            try:
                await self._flusher
            except asyncio.CancelledError:
                pass
            self._flusher = None
        await self.flush()
