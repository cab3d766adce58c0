"""ReminderDaemon: the per-node scheduler that ticks owned shards.

One daemon runs inside every ``Server(..., reminder_daemon=True)`` as a
``run()`` child task (beside the placement daemon). Each poll it walks the
shard space and enforces a three-layer ownership protocol:

1. **Directory seat** (``ObjectPlacement``): each shard is a directory row
   ``ObjectId("rio.ReminderShard", str(shard))`` — the same trait every
   service object is seated through, so ``JaxObjectPlacement`` folds shards
   into its device solve and the placement daemon reseats them on churn
   like any other population. An *unowned* shard is claimed by its
   rendezvous-preferred node (``sorted(active)[shard % n]``) so a cold
   cluster spreads shards without coordination; a shard whose seated owner
   left the active set is freed exactly the way the service layer frees
   dead owners (``clean_server``). When the directory seats a shard on a
   *different* live node (e.g. a solver rebalance moved it), this daemon
   releases its lease and stops ticking — the directory is the scheduling
   authority.
2. **Lease** (``ReminderStorage``): the directory is eventually consistent
   under races, so the storage-side lease (TTL + monotone epoch) is what
   guarantees at most one node ticks a shard at a time. A node only scans
   a shard while holding its unexpired lease.
3. **Delivery**: each due reminder becomes a ``rio.ReminderFired`` message
   sent through an internal cluster :class:`~rio_tpu_torch.client.Client`
   (placement → redirect → retry with ``utils/backoff``) to the target
   object, activating it wherever placement wants it — an ordinary request
   on the existing wire protocol, no new frame kind. The reminder is
   rescheduled only *after* the send resolves: a transport-level failure
   leaves ``next_due`` in the past and the next poll retries —
   **at-least-once** delivery.

Missed-tick catch-up (node died mid-window, shard re-owned after the lease
expired): the first post-recovery fire carries ``missed`` (how many whole
periods were lost). ``catchup="skip"`` (default) jumps ``next_due`` past
the gap but stays phase-aligned with the original schedule;
``catchup="all"`` advances one period per fire, replaying every missed tick
on successive scans.

Tick-rate feeds placement cost: after each scan the daemon reports the
shard's delivered-tick volume into the provider's ``AffinityTracker`` (when
one is wired), so hot shards weigh more in the hierarchical OT solve —
reminder-shard ownership *is* a granular allocation problem.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import time
from dataclasses import dataclass, field

from ..client import Client
from ..cluster.storage import MembershipStorage
from ..journal import REMINDER_HANDOFF, REMINDER_RELEASE, REMINDER_SEAT, STORAGE
from ..object_placement import ObjectPlacement, ObjectPlacementItem
from ..registry import ObjectId
from ..service_object import ReminderFired
from ..utils import ExponentialBackoff
from ..utils.backoff import DecorrelatedJitter
from . import Reminder, ReminderStorage

log = logging.getLogger("rio_tpu_torch.reminders")

#: Directory type name under which shard seats live. A reserved framework
#: kind — registries never construct it; only the daemons read/write it.
SHARD_TYPE = "rio.ReminderShard"


@dataclass
class ReminderDaemonConfig:
    """Tunables; defaults sized for human-scale periods (seconds+).

    Tests shrink everything to tens of milliseconds — every interval is a
    plain float, nothing is quantized.
    """

    poll_interval: float = 1.0
    # Lease TTL. Failover bound: after an owner dies unannounced, a
    # survivor ticks its shards within ttl + one poll.
    lease_ttl: float = 5.0
    # Max due rows delivered per shard per poll (backpressure bound).
    batch: int = 256
    catchup: str = "skip"  # "skip" (phase-aligned jump) | "all" (replay)
    # Delivery client's retry policy (at-least-once inner loop). Bounded
    # small: the poll loop is the outer retry and must not starve sibling
    # reminders behind one dead target.
    delivery_backoff: ExponentialBackoff = field(
        default_factory=lambda: ExponentialBackoff(initial=0.01, cap=0.25, max_retries=4)
    )


@dataclass
class ReminderDaemonStats:
    polls: int = 0
    owned_shards: int = 0  # gauge: shards leased as of the last poll
    claims: int = 0  # directory seats this node took
    releases: int = 0  # leases handed back (reseat elsewhere / drain)
    ticks: int = 0  # reminders delivered
    missed_ticks: int = 0  # periods skipped by catch-up accounting
    delivery_failures: int = 0  # transport-level; reminder stays due
    errors: int = 0
    shard_errors: int = 0  # single-shard failures skipped mid-scan
    degraded_polls: int = 0  # polls where ≥1 storage call failed


class ReminderDaemon:
    """Poll loop: claim/renew shard ownership, scan due reminders, deliver."""

    def __init__(
        self,
        *,
        address: str,
        members_storage: MembershipStorage,
        placement: ObjectPlacement,
        storage: ReminderStorage,
        config: ReminderDaemonConfig | None = None,
        client: Client | None = None,
        journal=None,
        storage_health=None,
    ) -> None:
        self.address = address
        self.members_storage = members_storage
        self.placement = placement
        self.storage = storage
        self.config = config or ReminderDaemonConfig()
        self.stats = ReminderDaemonStats()
        self._client = client
        # Control-plane flight recorder; seat transitions only, never ticks.
        self.journal = journal
        # Shared rio.storage.* outage ledger (rio_tpu_torch.faults.StorageHealth).
        self.storage_health = storage_health
        self._held: dict[int, int] = {}  # shard -> lease epoch we hold
        self._handed_off: dict[int, float] = {}  # shard -> when we released it
        self._draining = False
        self._storage_down = False
        # Last good active-member view: a membership blip must not stall the
        # whole scan — held leases keep their shards ticking from this view.
        self._last_active: set[str] = set()

    # -- storage-outage bookkeeping (one journal event per edge) -------------

    def _note_storage_error(self, op: str, exc: BaseException) -> None:
        if self.storage_health is not None:
            self.storage_health.note_error(op, exc, source="reminders")
        if not self._storage_down:
            self._storage_down = True
            log.warning("reminder daemon: storage degraded at %s: %r", op, exc)
            if self.journal is not None:
                self.journal.record(
                    STORAGE,
                    source="reminders",
                    op=op,
                    mode="degraded",
                    error=repr(exc)[:120],
                )

    def _note_storage_ok(self) -> None:
        if not self._storage_down:
            return
        self._storage_down = False
        log.info("reminder daemon: storage recovered")
        if self.storage_health is not None:
            self.storage_health.note_ok("reminders")
        if self.journal is not None:
            self.journal.record(STORAGE, source="reminders", mode="recovered")

    def _jrecord(self, kind: str, shard: int, **attrs) -> None:
        if self.journal is not None:
            self.journal.record(kind, f"{SHARD_TYPE}/{shard}", **attrs)

    def _get_client(self) -> Client:
        if self._client is None:
            self._client = Client(
                self.members_storage, backoff=self.config.delivery_backoff
            )
        return self._client

    # ------------------------------------------------------------------
    # Ownership
    # ------------------------------------------------------------------

    def _preferred(self, shard: int, active: list[str]) -> str | None:
        """Rendezvous tie-break for UNOWNED shards: all nodes sort the same
        active set, so they agree on who claims without coordination."""
        if not active:
            return None
        return sorted(active)[shard % len(active)]

    async def _resolve_owner(self, shard: int, active: set[str], now: float) -> str | None:
        oid = ObjectId(SHARD_TYPE, str(shard))
        owner = await self.placement.lookup(oid)
        if owner is not None and owner != self.address and owner not in active:
            # Dead owner: free everything it held (mirrors the service
            # layer's dead-owner path, service.rs:227-238).
            await self.placement.clean_server(owner)
            owner = None
        if owner is not None and owner != self.address and owner in active:
            # Live seated owner that is provably not ticking: its lease has
            # lapsed a full TTL past expiry (or was never taken). Happens
            # when a solver rebalance seats the shard on a node without a
            # reminder daemon, or a claimant died between seat and lease.
            # Steal through the lease (storage serializes to one winner)
            # and move the seat to the actual ticker.
            if not self._draining and await self._seat_is_stale(shard, owner, now):
                lease = await self.storage.acquire_lease(
                    shard, self.address, self.config.lease_ttl, now
                )
                if lease is not None:
                    self._held[shard] = lease.epoch
                    await self.placement.update(
                        ObjectPlacementItem(object_id=oid, server_address=self.address)
                    )
                    self.stats.claims += 1
                    self._jrecord(
                        REMINDER_SEAT, shard, stolen_from=owner, epoch=lease.epoch
                    )
                    return self.address
        if owner is None and not self._draining:
            if self._preferred(shard, sorted(active)) == self.address:
                await self.placement.update(
                    ObjectPlacementItem(object_id=oid, server_address=self.address)
                )
                self.stats.claims += 1
                self._jrecord(REMINDER_SEAT, shard, reason="preferred")
                owner = self.address
        return owner

    async def _seat_is_stale(self, shard: int, owner: str, now: float) -> bool:
        lease = await self.storage.get_lease(shard)
        if lease is None:
            # Seated but no lease. If WE just released this shard on seeing
            # the seat move (a rebalance/migration handed it off), the gap
            # is the new owner's normal claim race, not proof it is dead —
            # stealing now would flip the seat straight back and revert the
            # migration. Give the new owner a full TTL to claim first.
            return now - self._handed_off.get(shard, float("-inf")) > self.config.lease_ttl
        if lease.owner != owner:
            return False  # directory lag behind a lease someone else holds
        return lease.expires_at + self.config.lease_ttl <= now

    async def _release_held(self, shard: int) -> None:
        epoch = self._held.pop(shard, None)
        if epoch is not None:
            self.stats.releases += 1
            self._handed_off[shard] = time.time()
            self._jrecord(REMINDER_RELEASE, shard, epoch=epoch)
            with contextlib.suppress(Exception):
                await self.storage.release_lease(shard, self.address, epoch)

    async def poll_once(self, now: float | None = None) -> bool:
        """One full pass over the shard space. Returns True when every
        storage call succeeded (False → the caller backs off).

        Outage resilience: a failed ``active_members`` falls back to the
        last good view, and each shard is isolated — one shard's storage
        error skips THAT shard (its held lease/seat untouched, so it
        resumes where it left off after the blip) and the scan continues.
        """
        now = time.time() if now is None else now
        cfg = self.config
        poll_ok = True
        try:
            active = {m.address for m in await self.members_storage.active_members()}
            self._last_active = active
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — membership blip
            poll_ok = False
            self._note_storage_error("membership.active_members", e)
            active = self._last_active
        owned = 0
        for shard in range(self.storage.num_shards):
            if self._draining:
                break
            try:
                owner = await self._resolve_owner(shard, active, now)
                if owner != self.address:
                    # Seated elsewhere (or unclaimed and not ours to claim):
                    # make sure we are not still ticking it.
                    await self._release_held(shard)
                    continue
                lease = await self.storage.acquire_lease(
                    shard, self.address, cfg.lease_ttl, now
                )
                if lease is None:
                    # Directory says us, lease says someone else: the previous
                    # owner's lease has not expired yet. Back off until it does.
                    self._held.pop(shard, None)
                    continue
                self._held[shard] = lease.epoch
                owned += 1
                await self._tick_shard(shard, now)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — skip shard, keep scanning
                poll_ok = False
                self.stats.shard_errors += 1
                if shard in self._held:
                    owned += 1  # lease still ours; resumes after the blip
                self._note_storage_error(f"reminders.shard.{shard}", e)
        self.stats.owned_shards = owned
        if poll_ok:
            self._note_storage_ok()
        else:
            self.stats.degraded_polls += 1
        return poll_ok

    # ------------------------------------------------------------------
    # Ticking
    # ------------------------------------------------------------------

    async def _tick_shard(self, shard: int, now: float) -> None:
        cfg = self.config
        due = await self.storage.due(shard, now, cfg.batch)
        delivered = 0
        for rem in due:
            missed = max(0, int((now - rem.next_due) // rem.period))
            fired = ReminderFired(name=rem.reminder_name, due=rem.next_due, missed=missed)
            if not await self._deliver(rem, fired):
                # Transport-level failure: next_due stays in the past and
                # the next poll retries — the at-least-once outer loop.
                self.stats.delivery_failures += 1
                continue
            delivered += 1
            self.stats.ticks += 1
            if cfg.catchup == "all":
                next_due = rem.next_due + rem.period  # replay the backlog
            else:  # "skip": jump the gap, keep the original phase
                self.stats.missed_ticks += missed
                next_due = rem.next_due + (missed + 1) * rem.period
            await self.storage.reschedule(
                rem.object_kind, rem.object_id, rem.reminder_name, next_due
            )
        if delivered:
            self._observe_load(shard, delivered)

    def _observe_load(self, shard: int, ticks: int) -> None:
        """Feed the shard's tick volume into the placement provider's
        affinity tracker (when wired): tick-rate becomes cost in the
        hierarchical OT solve, so the solver seats hot shards where
        capacity is."""
        tracker = getattr(self.placement, "affinity_tracker", None)
        if tracker is None:
            return
        with contextlib.suppress(Exception):
            tracker.observe(f"{SHARD_TYPE}.{shard}", self.address, weight=float(ticks))

    async def _deliver(self, rem: Reminder, fired: ReminderFired) -> bool:
        """Send one tick; True when the tick is considered fired.

        An exception *raised by the target's handler* (typed application
        error, unsupported type, panic) still counts as fired — the actor
        ran (or terminally cannot); retrying each poll would hot-loop.
        Only transport-level failures (owner unreachable, retries
        exhausted) leave the reminder due.
        """
        from ..errors import Disconnect, RetryExhausted, ServerNotAvailable

        try:
            await self._get_client().send(rem.object_kind, rem.object_id, fired)
            return True
        except (RetryExhausted, ServerNotAvailable, Disconnect, OSError) as e:
            log.warning(
                "reminder %s/%s/%s undelivered (%r); will retry next poll",
                rem.object_kind, rem.object_id, rem.reminder_name, e,
            )
            return False
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — handler-side outcome
            log.warning(
                "reminder %s/%s/%s fired into a failing handler: %r",
                rem.object_kind, rem.object_id, rem.reminder_name, e,
            )
            return True

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------

    async def handoff(self) -> None:
        """Graceful drain: stop claiming, release every held lease, and
        free our directory seats so survivors claim on their next poll
        (well inside one lease interval). Called by
        ``Server._drain_and_exit`` before the placement cordon."""
        self._draining = True
        for shard in list(self._held):
            self._jrecord(REMINDER_HANDOFF, shard, reason="drain")
            await self._release_held(shard)
            oid = ObjectId(SHARD_TYPE, str(shard))
            with contextlib.suppress(Exception):
                if await self.placement.lookup(oid) == self.address:
                    await self.placement.remove(oid)

    async def run(self) -> None:
        """Serve until cancelled (a ``Server.run`` child task)."""
        await self.storage.prepare()
        # Degraded-poll retry pacing: jittered so a cluster of daemons does
        # not hammer a recovering rendezvous in lockstep; capped a little
        # above the healthy interval — the scheduler keeps scanning.
        interval = max(1e-3, self.config.poll_interval)
        backoff = DecorrelatedJitter(base=interval / 2.0, cap=interval * 4.0)
        try:
            while not self._draining:
                poll_ok = False
                try:
                    poll_ok = await self.poll_once()
                    self.stats.polls += 1
                except asyncio.CancelledError:
                    raise
                except Exception:
                    # Like the placement daemon: a transient storage or
                    # membership error must never kill the scheduler.
                    self.stats.errors += 1
                    log.exception("reminder daemon poll failed")
                if poll_ok:
                    backoff = DecorrelatedJitter(base=interval / 2.0, cap=interval * 4.0)
                    await asyncio.sleep(self.config.poll_interval)
                else:
                    await asyncio.sleep(backoff.next())
            await asyncio.Event().wait()  # drained: park until cancelled
        finally:
            if self._client is not None:
                self._client.close()
