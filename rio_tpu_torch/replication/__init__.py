"""Replicated actors: anti-affinity standbys, log-shipped state, fast failover.

A plain virtual actor recovers from a node death by lazy re-activation: the
next request self-assigns a fresh instance whose state is whatever the
state backend last saw. Volatile state is gone, and even managed state can
trail the last acknowledged write. This package closes that window for
actors that opt in (``__replicated__ = True`` on the class):

1. **Anti-affinity standby seats** — each replicated object gets ``k``
   standby rows in the placement directory
   (:meth:`~rio_tpu_torch.object_placement.ObjectPlacement.set_standbys`). When
   the provider is solver-backed, ``assign_standbys`` places the seats with
   a K-round Sinkhorn solve that prices a primary/standby co-location at
   :data:`~rio_tpu_torch.object_placement.torch_placement._ANTI_AFFINITY_COST` —
   the seats land on *different* nodes, load-balanced against everything
   else the solver knows. Reference backends fall back to hashed selection
   over the live membership (minus the primary).
2. **Log-shipped state** — after every *acknowledged* request, the service
   layer asks :meth:`ReplicationManager.ship_on_ack` to snapshot the
   object's volatile state (``__migrate_state__``, the same protocol the
   migration engine uses, read consistently via ``Registry.peek``) and
   ship it to every standby's node-scoped ``MigrationInbox`` as a
   :class:`~rio_tpu_torch.migration.ReplicaAppend`. The ship completes *before*
   the client sees the ack, so a primary death cannot lose an acknowledged
   write; byte-identical snapshots are skipped (read-mostly actors ship
   nothing). An anti-entropy loop re-ships anything a transient failure
   left dirty.
3. **Epoch-fenced failover** — the standby row carries an epoch that moves
   *only* through the backends'
   :meth:`~rio_tpu_torch.object_placement.ObjectPlacement.promote_standby` CAS.
   When the request path finds the primary's node dead
   (``Service.get_or_create_placement``), it promotes a live standby —
   the CAS flips the primary row to the survivor *before* ``clean_server``
   sweeps the dead node's rows — and the client's existing
   redirect/deallocate machinery lands traffic on the promoted node. Its
   first activation restores the last shipped replica
   (:meth:`ReplicationManager.restore_replica`, running in the same LOAD
   slot as migration's volatile restore). Appends fenced with an older
   epoch — a deposed primary that has not yet noticed — are nacked by the
   standbys, and a node actively serving an object nacks appends for it
   outright. The deposed side is fenced twice: its seat cache expires
   within ``seat_ttl`` and the refresh (``_seats_for``) finds the
   directory naming another node as primary, so it surrenders the key —
   dropping its ship state — instead of re-adopting the post-promotion
   epoch.

Everything rides existing plumbing: the inbox actor, the ``Registry.peek``
consistent snapshot, the ``InstallState``-style codec payloads, the
placement trait. The manager itself makes cross-node calls only to
inboxes, so the migration package's acyclic wait-for-graph argument is
unchanged.
"""

from __future__ import annotations

import asyncio
import logging
import time
import zlib
from dataclasses import dataclass
from typing import Any

from .. import codec
from ..app_data import AppData
from ..cluster.storage import MembershipStorage
from ..errors import ObjectNotFound
from ..journal import (
    REPLICA_DEPOSE,
    REPLICA_PROMOTE,
    REPLICA_RESHIP,
    REPLICA_SEAT,
    Journal,
)
from ..migration import INBOX_TYPE, MigrationManager, ReplicaAck, ReplicaAppend
from ..object_placement import ObjectPlacement
from ..registry import ObjectId, Registry, type_id

log = logging.getLogger("rio_tpu_torch.replication")

__all__ = [
    "ReplicaFreshness",
    "ReplicationConfig",
    "ReplicationManager",
    "ReplicationStats",
]


@dataclass
class ReplicationConfig:
    """Knobs for the replication engine (documented in MIGRATING.md)."""

    k: int = 1  # standby seats per replicated object
    ship_on_ack: bool = True  # synchronous ship before the client's ack
    anti_entropy_interval: float = 5.0  # periodic re-ship / seat repair
    seat_ttl: float = 2.0  # standby-row cache lifetime on the primary
    ensure_seats: bool = True  # seat standbys on first ship when missing


@dataclass
class ReplicaFreshness:
    """Standby-side lag bookkeeping for one held replica.

    Updated on every primary contact (append, idempotent replay, refresh
    ping). Wall-clock age is measured from the LOCAL monotonic clock at
    receive time — ``ship_ts`` (the primary's wall clock) is carried for
    observability but never trusted across nodes.
    """

    epoch: int = 0
    seq: int = 0  # last applied payload sequence
    head_seq: int = 0  # primary's head sequence at last contact
    ship_ts: float = 0.0  # primary wall clock at last contact
    recv_mono: float = 0.0  # local monotonic at last contact

    def age_s(self, now: float | None = None) -> float:
        now = time.monotonic() if now is None else now
        return max(0.0, now - self.recv_mono)

    @property
    def lag_seq(self) -> int:
        return max(0, self.head_seq - self.seq)


@dataclass
class ReplicationStats:
    """Counters exported through :func:`rio_tpu_torch.otel.stats_gauges`."""

    shipped: int = 0  # deltas acked by the full standby set
    ship_bytes: int = 0  # payload bytes sent (per-standby copies counted)
    ship_skipped: int = 0  # snapshot unchanged since last full ack
    ship_failures: int = 0  # per-standby send failures / nacks
    unreplicated: int = 0  # ships with no live standby seat available
    stale_epoch_nacks: int = 0  # this primary's appends fenced off
    deposed: int = 0  # ships aborted: the directory names another primary
    appends: int = 0  # deltas accepted while standing by
    append_nacks: int = 0  # deltas rejected (stale epoch / primary here)
    replica_restores: int = 0  # activations warmed from a shipped replica
    promotions: int = 0  # epoch CAS wins (this node drove the failover)
    promotions_lost: int = 0  # CAS races lost to a concurrent promoter
    seats_assigned: int = 0  # standby seats written to the directory
    anti_entropy_rounds: int = 0
    refreshes: int = 0  # payload-less freshness pings shipped (read scale)
    refresh_nacks: int = 0  # pings bounced (standby lost the replica / fenced)
    lag_ms_last: float = 0.0  # last full-set ship round-trip
    lag_ms_max: float = 0.0


class ReplicationManager:
    """Per-node replication coordinator; injected into AppData by the Server.

    One instance plays every role: the *primary* role (snapshot → ship →
    track acks) in :meth:`ship_on_ack` and the anti-entropy loop; the
    *standby* role (fence-check → store) in :meth:`apply_append`; the
    *failover* role (epoch CAS promote, replica restore) in
    :meth:`maybe_promote` / :meth:`restore_replica`.
    """

    def __init__(
        self,
        *,
        address: str,
        registry: Registry,
        placement: ObjectPlacement,
        members_storage: MembershipStorage,
        app_data: AppData,
        config: ReplicationConfig | None = None,
        client: Any | None = None,
    ) -> None:
        self.address = address
        self.registry = registry
        self.placement = placement
        self.members_storage = members_storage
        self.app_data = app_data
        self.config = config or ReplicationConfig()
        self.stats = ReplicationStats()
        # Standby role: key -> (payload, epoch, seq). The last delta each
        # primary shipped here; claimed by the first post-promotion
        # activation.
        self._replica_store: dict[tuple[str, str], tuple[bytes, int, int]] = {}
        # Standby role: lag/age bookkeeping per held replica, consumed by the
        # read-scale layer's staleness gate (rio_tpu_torch/readscale).
        self._replica_meta: dict[tuple[str, str], ReplicaFreshness] = {}
        # Read-scale hooks: per-object replica-count overrides (the hotness
        # detector's dynamic k) and the freshness-ping switch the
        # ReadScaleManager flips on at attach time.
        self._k_overrides: dict[tuple[str, str], int] = {}
        self.read_refresh = False
        self.refresh_interval: float | None = None
        # Primary role: dedup + retry state.
        self._last_shipped: dict[tuple[str, str], bytes] = {}
        self._seq: dict[tuple[str, str], int] = {}
        self._dirty: set[tuple[str, str]] = set()
        # Standby-row cache: key -> (held, epoch, monotonic ts). A directory
        # read per acked request would put the backend back on the hot path
        # the solver provider exists to avoid.
        self._seats: dict[tuple[str, str], tuple[list[str], int, float]] = {}
        self._client = client
        # Control-plane flight recorder (rio_tpu_torch/journal). Role transitions
        # only — the per-request ship path never records.
        self._journal = app_data.try_get(Journal)

    def _jrecord(self, kind: str, object_id: ObjectId, **attrs: Any) -> None:
        if self._journal is not None:
            self._journal.record(
                kind, f"{object_id.type_name}/{object_id.id}", **attrs
            )

    # ------------------------------------------------------------------
    # Primary role: ship-on-ack
    # ------------------------------------------------------------------

    async def ship_on_ack(self, object_id: ObjectId) -> None:
        """Ship the object's current volatile snapshot to its standby set.

        Called by the service layer after a successful dispatch and BEFORE
        the response leaves the node — the acknowledged-write guarantee
        lives in that ordering. Never raises: a ship failure marks the key
        dirty for the anti-entropy loop (degraded replication, not a
        failed request).
        """
        if not self.config.ship_on_ack:
            return
        key = (object_id.type_name, object_id.id)
        try:
            payload = await self.registry.peek(
                object_id.type_name, object_id.id, MigrationManager._volatile_snapshot
            )
        except ObjectNotFound:
            return
        if payload is None:
            return  # type exports no __migrate_state__: nothing to ship
        if self._last_shipped.get(key) == payload:
            self.stats.ship_skipped += 1
            return
        try:
            await self._ship(object_id, key, payload)
        except Exception:  # noqa: BLE001 — never fail the acked request
            self.stats.ship_failures += 1
            self._dirty.add(key)
            log.exception("replica ship failed for %s", object_id)

    async def _ship(
        self, object_id: ObjectId, key: tuple[str, str], payload: bytes
    ) -> None:
        seats = await self._seats_for(object_id, key)
        if seats is None:
            return  # deposed: _seats_for dropped our primary-role state
        held, epoch = seats
        if not held:
            self.stats.unreplicated += 1
            self._dirty.add(key)
            return
        live = [a for a in held if await self.members_storage.is_active(a)]
        if len(live) < len(held):
            # A dead standby fails the round immediately — the client's
            # retry ladder against an unreachable inbox would stall the
            # acked request for seconds. The anti-entropy round repairs
            # the seat and re-ships.
            self.stats.ship_failures += len(held) - len(live)
            self._seats.pop(key, None)
            degraded = True
            if not live:
                self._dirty.add(key)
                return
            held = live
        else:
            degraded = False
        seq = self._seq.get(key, 0) + 1
        self._seq[key] = seq
        msg = ReplicaAppend(
            type_name=object_id.type_name,
            object_id=object_id.id,
            epoch=epoch,
            seq=seq,
            payload=payload,
            head_seq=seq,
            ship_ts=time.time(),
        )
        t0 = time.perf_counter()
        acks = await asyncio.gather(
            *(self._append_to(addr, msg) for addr in held), return_exceptions=True
        )
        ok_all = True
        for addr, ack in zip(held, acks):
            if isinstance(ack, BaseException):
                ok_all = False
                self.stats.ship_failures += 1
                log.warning("replica append %s -> %s failed: %r", object_id, addr, ack)
            elif not ack.ok:
                ok_all = False
                self.stats.ship_failures += 1
                if ack.epoch > epoch:
                    # Fenced: the standby has seen a newer promotion. Drop
                    # the cached row — the next ship re-reads the directory
                    # (and finds we are no longer the primary).
                    self.stats.stale_epoch_nacks += 1
                    self._seats.pop(key, None)
        lag_ms = (time.perf_counter() - t0) * 1e3
        self.stats.lag_ms_last = lag_ms
        if lag_ms > self.stats.lag_ms_max:
            self.stats.lag_ms_max = lag_ms
        if ok_all:
            self.stats.shipped += 1
            self.stats.ship_bytes += len(payload) * len(held)
            if not degraded:
                # Only a FULL-set ack closes the key: a degraded round
                # (dead standby skipped) must re-ship the same bytes to
                # the repaired seat, so it can't feed the dedup cache.
                self._last_shipped[key] = payload
                self._dirty.discard(key)
        else:
            self._dirty.add(key)

    async def _append_to(self, addr: str, msg: ReplicaAppend) -> ReplicaAck:
        return await self._get_client().send(
            INBOX_TYPE, addr, msg, returns=ReplicaAck
        )

    async def _seats_for(
        self, object_id: ObjectId, key: tuple[str, str]
    ) -> tuple[list[str], int] | None:
        """Standby seats for a key this node ships as primary, or ``None``
        when the directory says this node is NOT the primary anymore.

        The epoch nack fences a deposed primary only while its seat cache
        holds the pre-promotion epoch; a re-read after ``seat_ttl`` would
        otherwise adopt the CURRENT epoch and let stale ships through. So
        every cache refresh first checks the primary row: another node's
        address there means we were deposed (declared dead and failed over
        while still running) — surrender the key instead of shipping.
        """
        cached = self._seats.get(key)
        now = time.monotonic()
        if cached is not None and now - cached[2] <= self.config.seat_ttl:
            return cached[0], cached[1]
        primary = await self.placement.lookup(object_id)
        if primary is not None and primary != self.address:
            self._drop_primary_role(key)
            self.stats.deposed += 1
            self._jrecord(REPLICA_DEPOSE, object_id, directory_primary=primary)
            log.warning(
                "deposed as primary for %s (directory names %s); ship aborted",
                object_id, primary,
            )
            return None
        if self.config.ensure_seats:
            held, epoch = await self.repair_seats(object_id, primary=primary)
        else:
            held, epoch = await self.placement.standbys(object_id)
        self._seats[key] = (held, epoch, now)
        return held, epoch

    def _drop_primary_role(self, key: tuple[str, str]) -> None:
        """Surrender primary-role state for a key the directory re-seated:
        no more ships (the promoted node's are authoritative), no retry via
        the dirty set, no dedup/seq state to confuse a later re-promotion
        back to this node."""
        self._last_shipped.pop(key, None)
        self._seq.pop(key, None)
        self._dirty.discard(key)
        self._seats.pop(key, None)

    async def repair_seats(
        self, object_id: ObjectId, *, primary: str | None = None
    ) -> tuple[list[str], int]:
        """Bring the object's standby set to ``k`` LIVE seats; ``(held, epoch)``.

        Dead standbys are dropped, missing seats topped up. Solver
        providers place new seats through ``assign_standbys`` (the
        anti-affinity K-seat solve); reference backends hash the object
        across the live membership minus the primary. Either way the epoch
        fence comes back from ``set_standbys`` — this method never
        advances it.
        """
        held, epoch = await self.placement.standbys(object_id)
        live = [a for a in held if await self.members_storage.is_active(a)]
        k = self.replica_k((object_id.type_name, object_id.id))
        if len(live) == k and len(live) == len(held):
            return held, epoch
        if primary is None:
            primary = await self.placement.lookup(object_id)
        if primary is not None and primary != self.address:
            # Seat repair is a PRIMARY-role action. A node the directory no
            # longer names (falsely declared dead, then failed over) must
            # not rewrite the standby set out from under the real primary.
            return held, epoch
        exclude = {primary, *live} - {None}
        fresh: list[str] = []
        if len(live) < k:
            assign = getattr(self.placement, "assign_standbys", None)
            if assign is not None:
                try:
                    fresh = (await assign([object_id], k=k))[0]
                except Exception:  # noqa: BLE001 — degrade to the hashed path
                    log.exception("solver standby assignment failed for %s", object_id)
            if not fresh:
                members = sorted(
                    m.address
                    for m in await self.members_storage.active_members()
                    if m.address not in exclude
                )
                if members:
                    # crc32, not hash(): per-process hash randomization would
                    # re-pick seats on every restart and churn the standby set.
                    start = zlib.crc32(str(object_id).encode()) % len(members)
                    fresh = [
                        members[(start + i) % len(members)]
                        for i in range(min(k - len(live), len(members)))
                    ]
        fresh = [a for a in dict.fromkeys(fresh) if a and a not in exclude]
        seats = (live + fresh)[:k]
        if seats == held:
            return held, epoch
        if not seats:
            return live, epoch  # nothing placeable; keep whatever stands
        epoch = await self.placement.set_standbys(object_id, seats)
        self.stats.seats_assigned += len([a for a in seats if a not in held])
        self._jrecord(
            REPLICA_SEAT, object_id, seats=list(seats), epoch=int(epoch)
        )
        return seats, epoch

    # ------------------------------------------------------------------
    # Dynamic replication factor (read-scale hotness detector)
    # ------------------------------------------------------------------

    def replica_k(self, key: tuple[str, str]) -> int:
        """Effective standby count for a key: override, else ``config.k``."""
        return self._k_overrides.get(key, max(1, self.config.k))

    def set_replica_k(self, object_id: ObjectId, k: int | None) -> None:
        """Override (or ``None`` to clear) one object's standby count.

        Takes effect on the next :meth:`repair_seats` — the caller drives
        that explicitly for an immediate re-seat. Grows AND shrinks: repair
        truncates live seats above ``k`` through ``set_standbys`` (epoch
        preserved — only ``promote_standby`` moves the fence).
        """
        key = (object_id.type_name, object_id.id)
        if k is None:
            self._k_overrides.pop(key, None)
        else:
            self._k_overrides[key] = max(1, int(k))
        # Drop the seat cache so the next ship sees the resized set.
        self._seats.pop(key, None)

    # ------------------------------------------------------------------
    # Standby role
    # ------------------------------------------------------------------

    def apply_append(self, msg: ReplicaAppend) -> ReplicaAck:
        """Store one shipped delta; purely local (inbox handler contract).

        Fencing, in order: a node actively SERVING the object is its
        primary — a late append for it can only come from a deposed
        predecessor, nack it outright; an append whose epoch is older than
        one already stored here lost a promotion race, nack with the newer
        epoch so the sender re-reads the directory; same-epoch replays
        (``seq`` not newer) are acked but not applied.
        """
        key = (msg.type_name, msg.object_id)
        if self.registry.has(msg.type_name, msg.object_id):
            self.stats.append_nacks += 1
            return ReplicaAck(ok=False, detail="object is primary here")
        stored = self._replica_store.get(key)
        if msg.refresh:
            # Payload-less freshness ping: only bumps lag/age bookkeeping.
            # Without a same-epoch replica here there is nothing whose
            # freshness it could attest — nack so the primary re-ships the
            # full payload (a newer-epoch ping means our copy predates the
            # last promotion and may be behind the restored line).
            if stored is None or msg.epoch != stored[1]:
                self.stats.append_nacks += 1
                return ReplicaAck(
                    ok=False,
                    epoch=stored[1] if stored is not None else 0,
                    detail="no replica for refresh",
                )
            self._touch_meta(key, stored[1], stored[2], msg)
            return ReplicaAck(ok=True, epoch=stored[1])
        if stored is not None:
            _, epoch, seq = stored
            if msg.epoch < epoch:
                self.stats.append_nacks += 1
                return ReplicaAck(ok=False, epoch=epoch, detail="stale epoch")
            if msg.epoch == epoch and msg.seq <= seq:
                # Idempotent replay — still primary contact: refresh age.
                self._touch_meta(key, epoch, seq, msg)
                return ReplicaAck(ok=True, epoch=epoch)
        self._replica_store[key] = (msg.payload, msg.epoch, msg.seq)
        self._touch_meta(key, msg.epoch, msg.seq, msg)
        self.stats.appends += 1
        return ReplicaAck(ok=True, epoch=msg.epoch)

    def _touch_meta(
        self, key: tuple[str, str], epoch: int, seq: int, msg: ReplicaAppend
    ) -> None:
        self._replica_meta[key] = ReplicaFreshness(
            epoch=epoch,
            seq=seq,
            head_seq=max(msg.head_seq, seq),  # legacy frames ship head_seq=0
            ship_ts=msg.ship_ts,
            recv_mono=time.monotonic(),
        )

    def replica_entry(self, key: tuple[str, str]) -> tuple[bytes, int, int] | None:
        """Held replica ``(payload, epoch, seq)`` for a key, or None."""
        return self._replica_store.get(key)

    def replica_freshness(self, key: tuple[str, str]) -> ReplicaFreshness | None:
        return self._replica_meta.get(key)

    def restore_replica(self, obj: Any) -> bool:
        """LOAD-lifecycle hook on a promoted node: warm the fresh activation
        from the last shipped delta. Runs in the same slot as migration's
        volatile restore, and only when that found no stash (a coordinated
        handoff is newer than any replica)."""
        key = (type_id(type(obj)), obj.id)
        if key not in self._replica_store:
            return False
        restore = getattr(obj, "__restore_state__", None)
        if restore is None:
            # Leave the entry in place: popping before this check would
            # discard the shipped payload permanently when the hook is
            # missing (or a first activation races in before the class
            # gains it) instead of keeping it for a later activation.
            return False
        payload, _, seq = self._replica_store.pop(key)
        self._replica_meta.pop(key, None)  # this node stops standing by
        restore(codec.deserialize(payload, Any))
        # This node is primary for the key now: continue the sequence so
        # our own ships are never mistaken for replays downstream.
        self._seq[key] = seq
        self.stats.replica_restores += 1
        return True

    # ------------------------------------------------------------------
    # Failover role
    # ------------------------------------------------------------------

    async def maybe_promote(
        self, object_id: ObjectId, dead: str | None = None
    ) -> str | None:
        """Fail a replicated object over to a live standby.

        Two callers, both in the request path's placement resolution: the
        dead-owner branch (BEFORE ``clean_server`` — the winning CAS writes
        the primary row at the survivor, and that row, not pointing at
        ``dead``, survives the sweep) and the unplaced branch (the dead
        node owned MANY objects; the first failover's clean_server wiped
        the rest of its rows, so their requests arrive with no primary row
        at all — self-assigning would strand the replica on the standby).
        Returns the new primary's address, or None when the object has no
        live standby (lazy re-activation covers it, as ever).
        """
        held, epoch = await self.placement.standbys(object_id)
        for cand in held:
            if cand == dead or not await self.members_storage.is_active(cand):
                continue
            new_epoch = await self.placement.promote_standby(object_id, cand, epoch)
            if new_epoch is not None:
                self.stats.promotions += 1
                self._seats.pop((object_id.type_name, object_id.id), None)
                self._jrecord(
                    REPLICA_PROMOTE,
                    object_id,
                    new_primary=cand,
                    dead=dead or "",
                    epoch=int(epoch),
                    new_epoch=int(new_epoch),
                )
                log.info(
                    "promoted %s standby %s (epoch %d -> %d)",
                    object_id, cand, epoch, new_epoch,
                )
                return cand
            # Lost the CAS: a concurrent promoter won. Their directory row
            # is authoritative — use it if it names a live node.
            self.stats.promotions_lost += 1
            winner = await self.placement.lookup(object_id)
            if winner is not None and await self.members_storage.is_active(winner):
                return winner
            return None
        return None

    # ------------------------------------------------------------------
    # Anti-entropy
    # ------------------------------------------------------------------

    async def run(self) -> None:
        """Background repair loop (one task per server, like the daemons)."""
        while True:
            # Re-read per iteration: the ReadScaleManager tightens the
            # cadence at attach time so freshness pings bound staleness.
            interval = max(0.05, self.config.anti_entropy_interval)
            if self.read_refresh and self.refresh_interval is not None:
                interval = min(interval, max(0.05, self.refresh_interval))
            await asyncio.sleep(interval)
            try:
                await self.anti_entropy_round()
            except Exception:  # noqa: BLE001 — the loop must outlive a round
                log.exception("anti-entropy round failed")

    async def anti_entropy_round(self) -> int:
        """Re-ship every dirty or drifted key; returns keys shipped.

        Covers the two ways ship-on-ack degrades: a send that failed (key
        in ``_dirty``) and a snapshot that changed outside a handled
        request (timers mutating volatile state ack nothing).
        """
        self.stats.anti_entropy_rounds += 1
        keys = {
            (oid.type_name, oid.id)
            for oid in self.registry.object_ids()
            if self.registry.is_replicated(oid.type_name)
        }
        keys |= self._dirty
        for key in keys:
            # Force a directory re-read (and seat repair) for every key
            # this round touches — a dirty key is often dirty BECAUSE a
            # standby died, and the cached row still names it.
            self._seats.pop(key, None)
        shipped = 0
        for tname, oid in keys:
            try:
                payload = await self.registry.peek(
                    tname, oid, MigrationManager._volatile_snapshot
                )
            except ObjectNotFound:
                self._dirty.discard((tname, oid))
                continue
            if payload is None or self._last_shipped.get((tname, oid)) == payload:
                if self.read_refresh and (tname, oid) in self._last_shipped:
                    # Nothing to re-ship, but the standbys' wall-clock age
                    # still advances — keep their replicas servably fresh.
                    await self.refresh_standbys(ObjectId(tname, oid))
                continue
            self._jrecord(
                REPLICA_RESHIP, ObjectId(tname, oid), bytes=len(payload)
            )
            await self._ship(ObjectId(tname, oid), (tname, oid), payload)
            shipped += 1
        return shipped

    async def refresh_standbys(self, object_id: ObjectId) -> None:
        """Ship a payload-less freshness ping to the standby set.

        A nack (standby restarted and lost the replica, or its epoch moved)
        reopens the key for a full re-ship on the next round — the ping
        never carries state, so it can never mask divergence.
        """
        key = (object_id.type_name, object_id.id)
        seq = self._seq.get(key, 0)
        if seq == 0:
            return  # nothing ever shipped; nothing to attest
        seats = await self._seats_for(object_id, key)
        if seats is None:
            return  # deposed
        held, epoch = seats
        live = [a for a in held if await self.members_storage.is_active(a)]
        if not live:
            return
        msg = ReplicaAppend(
            type_name=object_id.type_name,
            object_id=object_id.id,
            epoch=epoch,
            seq=seq,
            head_seq=seq,
            ship_ts=time.time(),
            refresh=True,
        )
        acks = await asyncio.gather(
            *(self._append_to(addr, msg) for addr in live), return_exceptions=True
        )
        self.stats.refreshes += 1
        for ack in acks:
            if isinstance(ack, BaseException) or not ack.ok:
                self.stats.refresh_nacks += 1
                self._last_shipped.pop(key, None)
                self._dirty.add(key)
                break

    # ------------------------------------------------------------------

    def _get_client(self):
        if self._client is None:
            from ..client import Client

            self._client = Client(
                self.members_storage, placement_resolver=self._resolve
            )
        return self._client

    async def _resolve(self, handler_type: str, handler_id: str) -> str | None:
        if handler_type == INBOX_TYPE:
            return handler_id  # node-scoped: the id IS the address
        return await self.placement.lookup(ObjectId(handler_type, handler_id))

    def close(self) -> None:
        if self._client is not None:
            self._client.close()
            self._client = None
