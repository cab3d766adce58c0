"""Background churn→re-solve wiring (the proactive half of recovery).

The reference recovers *reactively inside the request path*: a request to
an object whose host died triggers ``clean_server`` + lazy re-allocation
(``rio-rs/src/service.rs:227-238,261-298``).  rio-tpu keeps that path —
and this daemon adds the *proactive* half SURVEY §7.3 promises: watch
membership liveness, feed it to :class:`~rio_tpu_torch.object_placement.
torch_placement.TorchObjectPlacement` (``sync_members``), and trigger a
warm-started ``rebalance()`` so displaced objects are re-seated by the OT
solver *before* traffic hits them — no application involvement.

Opt in per node::

    Server(..., placement_daemon=True)

The daemon is a no-op for placement providers without the solver surface
(``sync_members``/``rebalance``), so it is safe to enable unconditionally.

Reminder-shard seats (``rio.ReminderShard`` rows written by
:class:`~rio_tpu_torch.reminders.daemon.ReminderDaemon`) are ordinary directory
rows, so a rebalance here re-seats them like any object — deliberately:
tick load reported through the provider's ``AffinityTracker`` makes hot
shards expensive, and the solver moves them to capacity. The reminder
daemons follow the directory (release the lease when seated elsewhere) and
lease-steal seats the solver lands on nodes that run no reminder daemon,
so a re-seat never strands a shard.
"""

from __future__ import annotations

import asyncio
import logging
import random
from dataclasses import dataclass

from .cluster.storage import MembershipStorage
from .journal import MEMBER_DOWN, MEMBER_UP, SOLVE, STORAGE
from .object_placement import ObjectPlacement
from .utils.backoff import DecorrelatedJitter

log = logging.getLogger("rio_tpu_torch.placement_daemon")


@dataclass
class PlacementDaemonStats:
    polls: int = 0
    load_syncs: int = 0  # ClusterLoadView pushes into the provider
    liveness_changes: int = 0
    kicks: int = 0  # event-driven wakeups (provider churn listener)
    rebalances: int = 0
    delta_rebalances: int = 0  # committed solves that took the delta path
    rebalances_skipped: int = 0  # sibling daemon on a shared provider won
    rebalances_discarded: int = 0  # lost an epoch race; retried next poll
    retries_abandoned: int = 0  # discard-retry budget exhausted; wait for churn
    degraded_polls: int = 0  # polls lost to storage errors (backoff pacing)
    moves: int = 0
    bursts: int = 0  # MigrateBatch bursts this daemon's rebalances produced
    burst_keys: int = 0  # keys those bursts carried
    errors: int = 0


@dataclass
class PlacementDaemonConfig:
    """Tunables; defaults sized for the gossip defaults (10 s interval).

    One config may be shared by every server in a process; each daemon
    keeps its own :class:`PlacementDaemonStats`.
    """

    poll_interval: float = 1.0
    # Debounce: a churn burst (several nodes flapping within this window)
    # costs one warm-started solve, not one per event.
    debounce: float = 0.25
    # Floor between full re-solves, so a flapping node can't make the
    # daemon spin the device.
    min_rebalance_interval: float = 1.0
    # Epoch-discard retries back off exponentially (min_rebalance_interval
    # * 2^k, capped below) and give up after this many CONSECUTIVE discards
    # — under sustained allocation traffic that bumps the epoch during
    # every solve, unbounded retries would dispatch a full device solve per
    # poll forever, each one discarded (livelock doing no useful work). The
    # lazy request-path re-seat still covers displaced objects; the next
    # liveness change re-arms the daemon.
    max_discard_retries: int = 5
    retry_backoff_max: float = 30.0
    mode: str | None = None  # solver mode override for daemon rebalances
    # Subscribe to the provider's churn listener (when it has one) so a
    # liveness flip / cordon wakes the poll loop IMMEDIATELY instead of at
    # the next poll_interval tick — with the provider's delta path this is
    # what turns node death into millisecond reaction instead of
    # poll_interval + full-solve latency. The poll loop itself remains the
    # fallback for providers without the hook (and for membership-storage
    # churn the local provider hasn't been told about yet).
    event_kick: bool = True


class PlacementDaemon:
    """Watch membership storage; re-solve placement on liveness changes."""

    def __init__(
        self,
        members_storage: MembershipStorage,
        placement: ObjectPlacement,
        config: PlacementDaemonConfig | None = None,
        *,
        migrator=None,
        journal=None,
        storage_health=None,
    ) -> None:
        self.members_storage = members_storage
        self.placement = placement
        self.config = config or PlacementDaemonConfig()
        self.stats = PlacementDaemonStats()
        self.migrator = migrator  # MigrationManager: moves become handoffs
        # Control-plane flight recorder (rio_tpu_torch.journal.Journal | None).
        # The daemon — not the provider — emits liveness/solve events: one
        # provider may be shared by several in-process servers, and only
        # the daemon knows which NODE observed the transition.
        self.journal = journal
        # Shared rio.storage.* outage ledger (rio_tpu_torch.faults.StorageHealth).
        self.storage_health = storage_health
        self._storage_down = False
        self._last_liveness: frozenset[tuple[str, bool]] | None = None
        self._retry_solve = False  # last solve was epoch-discarded
        self._consecutive_discards = 0
        self._retry_not_before = float("-inf")  # backoff gate (loop time)
        self._kick_event = asyncio.Event()

    # -- storage-outage bookkeeping (one journal event per edge) -------------

    def _note_storage_error(self, op: str, exc: BaseException) -> None:
        if self.storage_health is not None:
            self.storage_health.note_error(op, exc, source="placement_daemon")
        if not self._storage_down:
            self._storage_down = True
            if self.journal is not None:
                self.journal.record(
                    STORAGE,
                    source="placement_daemon",
                    op=op,
                    mode="degraded",
                    error=repr(exc)[:120],
                )

    def _note_storage_ok(self) -> None:
        if not self._storage_down:
            return
        self._storage_down = False
        log.info("placement daemon: storage recovered")
        if self.storage_health is not None:
            self.storage_health.note_ok("placement_daemon")
        if self.journal is not None:
            self.journal.record(
                STORAGE, source="placement_daemon", mode="recovered"
            )

    def kick(self) -> None:
        """Wake the poll loop now (idempotent, loop-thread only).

        Wired to the provider's churn listener by :meth:`run` (see
        ``PlacementDaemonConfig.event_kick``); callable directly by
        anything else that knows churn happened. The daemon's own
        ``sync_members`` call re-fires the listener — that self-kick costs
        one extra no-change poll, which the debounce/min-interval gates
        already absorb."""
        self.stats.kicks += 1
        self._kick_event.set()

    async def _idle(self, timeout: float) -> None:
        """Sleep until ``timeout`` or the next kick, whichever is first."""
        try:
            await asyncio.wait_for(self._kick_event.wait(), timeout)
        except asyncio.TimeoutError:
            return
        self._kick_event.clear()

    async def _rebalance(self, mode: str | None):
        """Dispatch the re-solve, routing moves through the migration
        coordinator when both sides support it (the provider's
        ``move_sink`` hook and a wired :class:`MigrationManager`). Raw
        directory writes remain the fallback for bare providers and
        migration-less deployments."""
        if self.migrator is not None:
            import inspect

            if "move_sink" in inspect.signature(self.placement.rebalance).parameters:
                mst = self.migrator.stats
                before = (mst.batches, mst.batch_keys, mst.prefetch_hits)
                moved = await self.placement.rebalance(
                    mode=mode, move_sink=self.migrator.apply_moves
                )
                # Attribute this rebalance's actuation to the daemon so
                # per-daemon gauges show how batched the plan came out
                # (migrator stats are node-global and shared).
                self.stats.bursts += mst.batches - before[0]
                self.stats.burst_keys += mst.batch_keys - before[1]
                hits = mst.prefetch_hits - before[2]
                if moved:
                    log.info(
                        "rebalance actuated: %d moves in %d bursts "
                        "(%d prefetch hits)",
                        moved,
                        mst.batches - before[0],
                        hits,
                    )
                return moved
        return await self.placement.rebalance(mode=mode)

    @property
    def supported(self) -> bool:
        return hasattr(self.placement, "sync_members") and hasattr(
            self.placement, "rebalance"
        )

    async def _liveness(self) -> tuple[frozenset[tuple[str, bool]], list]:
        members = await self.members_storage.members()
        return frozenset((m.address, bool(m.active)) for m in members), members

    def _sync_load(self, members: list) -> None:
        """Feed the members' piggybacked load vectors into the provider on
        every poll (not just liveness changes): capacity derates shape the
        NEXT solve whenever it happens, and the quantized derate keeps the
        epoch from thrashing. No-op for providers without ``sync_load``."""
        if not hasattr(self.placement, "sync_load"):
            return
        from .load import ClusterLoadView

        self.placement.sync_load(ClusterLoadView.from_members(members))
        self.stats.load_syncs += 1

    def _journal_liveness(
        self,
        prev: frozenset[tuple[str, bool]] | None,
        now: frozenset[tuple[str, bool]],
    ) -> None:
        """Emit MEMBER_UP/MEMBER_DOWN per address whose liveness flipped."""
        if self.journal is None or prev is None:
            return
        before = dict(prev)
        after = dict(now)
        for address, active in sorted(after.items()):
            if before.get(address) != active:
                self.journal.record(
                    MEMBER_UP if active else MEMBER_DOWN, address
                )
        for address in sorted(set(before) - set(after)):
            self.journal.record(MEMBER_DOWN, address, removed=True)

    def _journal_solve(self, stats_before, stats_now, moved) -> None:
        """Emit one SOLVE event per dispatched rebalance, carrying the
        provider's SolveStats detail when this call produced fresh stats."""
        if self.journal is None:
            return
        attrs: dict = {"moved": int(moved or 0)}
        epoch = 0
        if stats_now is not None and stats_now is not stats_before:
            epoch = int(getattr(stats_now, "epoch", 0) or 0)
            attrs.update(
                mode=str(getattr(stats_now, "mode", "")),
                displaced=int(getattr(stats_now, "displaced", 0) or 0),
                solve_ms=round(float(getattr(stats_now, "solve_ms", 0.0) or 0.0), 3),
                apply_ms=round(float(getattr(stats_now, "apply_ms", 0.0) or 0.0), 3),
                discarded=bool(getattr(stats_now, "discarded", False)),
            )
            # Convergence detail: only fields the solve actually
            # observed — -1 sentinels and zero-chunk counts stay off the
            # wire so legacy readers see the same attrs they always did.
            iters = int(getattr(stats_now, "solver_iters", 0) or 0)
            if iters > 0:
                attrs["solver_iters"] = iters
            residual = float(getattr(stats_now, "residual", -1.0))
            if residual >= 0.0:
                attrs["residual"] = residual
            warm = float(getattr(stats_now, "warm_ratio", -1.0))
            if warm >= 0.0:
                attrs["warm_ratio"] = round(warm, 4)
            compile_ms = float(getattr(stats_now, "compile_ms", -1.0))
            if compile_ms >= 0.0:
                attrs["compile_ms"] = round(compile_ms, 3)
                attrs["exec_ms"] = round(
                    float(getattr(stats_now, "exec_ms", 0.0) or 0.0), 3
                )
            chunks = int(getattr(stats_now, "chunks", 0) or 0)
            if chunks > 1:
                attrs["chunks"] = chunks
        self.journal.record(SOLVE, epoch=epoch, **attrs)

    def _solve_epoch(self):
        """The provider's last COMMITTED-solve epoch, when it exposes one.

        Discarded attempts are stats events too (SolveStats history), so
        scan the current stats' history backwards for the last
        non-discarded entry — archived entries are flattened (their own
        history is empty), so recursing into them would dead-end after
        two consecutive discards and misreport "no committed solve"."""
        stats = getattr(self.placement, "stats", None)
        if stats is None:
            return None
        if not getattr(stats, "discarded", False):
            return getattr(stats, "epoch", None)
        for prior in reversed(getattr(stats, "history", None) or []):
            if not getattr(prior, "discarded", False):
                return getattr(prior, "epoch", None)
        return None

    async def run(self) -> None:
        """Poll loop; runs until cancelled (a Server.run child task)."""
        if not self.supported:
            log.debug(
                "placement provider %s has no solver surface; daemon idle",
                type(self.placement).__name__,
            )
            await asyncio.Event().wait()  # park forever (until cancelled)
        cfg = self.config
        loop = asyncio.get_running_loop()
        last_rebalance = float("-inf")
        if cfg.event_kick and hasattr(self.placement, "add_churn_listener"):
            # Event-driven wakeups: the provider fires on every
            # liveness-affecting change (sync_members flip, cordon,
            # clean_server), so churn reaction is bounded by debounce +
            # solve time, not poll_interval.
            self.placement.add_churn_listener(self.kick)
        # Degraded-poll pacing: jittered retries while the rendezvous is
        # down, so co-located daemons don't stampede it on recovery. The
        # daemon's plan state (_last_liveness, retry ladder) is instance-
        # resident and the provider's warm-start state is provider-resident
        # — both survive an outage untouched; the next good poll resumes
        # exactly where the blip interrupted.
        interval = max(1e-3, cfg.poll_interval)
        storage_backoff = DecorrelatedJitter(base=interval / 2.0, cap=interval * 4.0)
        while True:
            poll_failed = False
            try:
                liveness, members = await self._liveness()
                self.stats.polls += 1
                self._note_storage_ok()
                self._sync_load(members)
                retry = self._retry_solve and loop.time() >= self._retry_not_before
                changed = liveness != self._last_liveness
                if changed:
                    # Fresh churn: the backoff ladder was about the OLD
                    # event's epoch races — start over.
                    self._consecutive_discards = 0
                    self._retry_not_before = float("-inf")
                if changed or retry:
                    # NOTE _retry_solve is NOT cleared here: every exit of
                    # this branch sets it explicitly, so a transient
                    # exception mid-retry leaves the flag armed and the
                    # still-unserved churn event is retried next poll.
                    first_sync = self._last_liveness is None and not retry
                    prev_liveness = self._last_liveness
                    self._last_liveness = liveness
                    self.placement.sync_members(members)
                    if first_sync:
                        # Startup: learn the initial member set without
                        # solving — nothing is displaced yet.
                        await self._idle(cfg.poll_interval)
                        continue
                    if changed:  # a pure retry serves an already-counted event
                        self.stats.liveness_changes += 1
                        self._journal_liveness(prev_liveness, liveness)
                    solve_epoch = self._solve_epoch()
                    # Debounce a churn burst into one solve; the random
                    # jitter staggers the daemons of co-located servers
                    # sharing one provider so one of them solves first.
                    await asyncio.sleep(cfg.debounce * (1 + random.random()))
                    liveness, members = await self._liveness()
                    self._last_liveness = liveness
                    self.placement.sync_members(members)
                    wait = last_rebalance + cfg.min_rebalance_interval - loop.time()
                    if wait > 0:
                        await asyncio.sleep(wait)
                    if solve_epoch is not None and self._solve_epoch() != solve_epoch:
                        # A sibling daemon on the SAME provider already
                        # solved this churn event — don't dispatch another
                        # device solve just to have it epoch-discarded.
                        self._retry_solve = False  # event served by sibling
                        self.stats.rebalances_skipped += 1
                        await self._idle(cfg.poll_interval)
                        continue
                    stats_before = getattr(self.placement, "stats", None)
                    moved = await self._rebalance(cfg.mode)
                    last_rebalance = loop.time()
                    stats_now = getattr(self.placement, "stats", None)
                    # Attribute a discard to OUR attempt only when the
                    # stats object actually changed under the call — a
                    # stale discarded flag (e.g. rebalance early-returned
                    # on an empty directory without touching stats) must
                    # not re-arm the retry forever.
                    ours_discarded = (
                        stats_now is not stats_before
                        and getattr(stats_now, "discarded", False)
                    )
                    self._journal_solve(stats_before, stats_now, moved)
                    if ours_discarded:
                        # The solve lost an epoch race (concurrent churn or
                        # allocation landed mid-solve): the liveness change
                        # is still unserved — retry, but on an exponential
                        # backoff, and give up after max_discard_retries
                        # consecutive losses (sustained allocation traffic
                        # would otherwise livelock the device: one discarded
                        # solve per poll forever).
                        self.stats.rebalances_discarded += 1
                        self._consecutive_discards += 1
                        if self._consecutive_discards > cfg.max_discard_retries:
                            self._retry_solve = False
                            self.stats.retries_abandoned += 1
                            log.warning(
                                "churn re-solve discarded %d times in a row; "
                                "abandoning retries until the next liveness "
                                "change (lazy re-seat still covers requests)",
                                self._consecutive_discards,
                            )
                        else:
                            self._retry_solve = True
                            self._retry_not_before = loop.time() + min(
                                cfg.min_rebalance_interval
                                * 2 ** (self._consecutive_discards - 1),
                                cfg.retry_backoff_max,
                            )
                            log.info(
                                "churn re-solve discarded (epoch race); "
                                "retry %d/%d backed off",
                                self._consecutive_discards,
                                cfg.max_discard_retries,
                            )
                    else:
                        self._retry_solve = False
                        self._consecutive_discards = 0
                        self.stats.rebalances += 1
                        if "+delta" in str(getattr(stats_now, "mode", "")):
                            self.stats.delta_rebalances += 1
                        self.stats.moves += int(moved)
                        log.info(
                            "churn re-solve: %d objects moved "
                            "(%d liveness changes seen)",
                            moved,
                            self.stats.liveness_changes,
                        )
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001
                # The daemon must never die to a transient storage error —
                # liveness watching is the node's recovery path.
                poll_failed = True
                self.stats.errors += 1
                self.stats.degraded_polls += 1
                self._note_storage_error("placement.poll", e)
                log.exception("placement daemon poll failed")
            if poll_failed:
                await self._idle(storage_backoff.next())
            else:
                storage_backoff = DecorrelatedJitter(
                    base=interval / 2.0, cap=interval * 4.0
                )
                await self._idle(cfg.poll_interval)
