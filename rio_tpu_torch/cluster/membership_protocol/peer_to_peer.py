"""Gossip-style failure detector.

Reference: ``rio-rs/src/cluster/membership_protocol/peer_to_peer.rs`` — an
Orleans-like peer-to-peer health protocol: every node registers itself
active, then each tick TCP-pings a (bounded, ring-ordered) subset of peers,
records failures in the shared membership storage's failure ledger, marks
peers inactive once failures-in-window cross the threshold (``:101-112``),
drops long-inactive members (``:175-185``), and re-activates reachable ones
(``:188-192``).

Outage resilience (beyond the reference): the tick survives storage
exceptions — the loop keeps probing from its last good membership view,
backs off with decorrelated jitter instead of the full interval, journals
one STORAGE event per degraded/recovered edge, and resumes cleanly when
the rendezvous returns. A single ``members()`` blip must never kill the
cluster's failure detector.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import time

from ...client import Client
from ...journal import STORAGE
from ...utils.backoff import DecorrelatedJitter
from ..storage import Member, MembershipStorage
from . import ClusterProvider

log = logging.getLogger("rio_tpu_torch.gossip")


@dataclasses.dataclass
class PeerToPeerClusterConfig:
    """Tunables, with the reference's defaults (``peer_to_peer.rs:23-44``)."""

    interval_secs: float = 10.0
    num_failures_threshold: int = 3
    interval_secs_threshold: float = 60.0
    limit_monitored_members: int | None = None
    drop_inactive_after_secs: float | None = None
    ping_timeout: float = 0.5
    # Suppress the inactive verdict for a member whose heartbeat row is
    # fresher than the failure window: it still reaches the rendezvous, so
    # it is alive — we just can't reach it (asymmetric partition). Flipping
    # it inactive would flap forever against its own active re-push every
    # tick. A genuinely dead member stops pushing, its row goes stale, and
    # the verdict lands unsuppressed one window later.
    trust_heartbeat_freshness: bool = True


@dataclasses.dataclass
class GossipStats:
    """Tick/outage counters (duck-typed into ``otel.stats_gauges``)."""

    ticks: int = 0  # completed probe rounds (healthy or degraded)
    degraded_ticks: int = 0  # rounds where ≥1 storage call failed
    storage_errors: int = 0  # individual failed storage calls
    suppressed_verdicts: int = 0  # inactive flips vetoed by fresh heartbeats


class PeerToPeerClusterProvider(ClusterProvider):
    def __init__(
        self,
        members_storage: MembershipStorage,
        config: PeerToPeerClusterConfig | None = None,
        transport_faults=None,
    ) -> None:
        self._storage = members_storage
        self.config = config or PeerToPeerClusterConfig()
        self.stats = GossipStats()
        # Fault-injection handle (rio_tpu_torch.faults.TransportFaults): routes
        # the prober's pings through per-(src, dst) link verdicts so tests
        # can script asymmetric partitions without touching the network.
        self._transport_faults = transport_faults
        self._storage_down = False

    def members_storage(self) -> MembershipStorage:
        return self._storage

    # -- storage-outage bookkeeping (one journal event per edge) -------------

    def _note_storage_error(self, op: str, exc: BaseException) -> None:
        self.stats.storage_errors += 1
        if self._storage_health is not None:
            self._storage_health.note_error(op, exc, source="gossip")
        if not self._storage_down:
            self._storage_down = True
            log.warning("gossip: storage degraded at %s: %r", op, exc)
            if self._journal is not None:
                self._journal.record(
                    STORAGE,
                    source="gossip",
                    op=op,
                    mode="degraded",
                    error=repr(exc)[:120],
                )

    def _note_storage_ok(self) -> None:
        if not self._storage_down:
            return
        self._storage_down = False
        log.info("gossip: storage recovered")
        if self._storage_health is not None:
            self._storage_health.note_ok("gossip")
        if self._journal is not None:
            self._journal.record(STORAGE, source="gossip", mode="recovered")

    # -- monitored-subset selection (reference peer_to_peer.rs:50-78) -------

    def _members_to_monitor(self, members: list[Member], self_address: str) -> list[Member]:
        others = sorted(
            (m for m in members if m.address != self_address), key=lambda m: m.address
        )
        limit = self.config.limit_monitored_members
        if limit is None or limit >= len(others):
            return others
        # Ring order starting just past self, so monitoring load spreads
        # across the cluster instead of everyone pinging the same prefix.
        idx = sum(1 for m in others if m.address < self_address)
        return [others[(idx + i) % len(others)] for i in range(limit)]

    # -- per-member probe + verdict (reference peer_to_peer.rs:81-112) -------

    async def _test_member(self, client: Client, member: Member) -> None:
        reachable = await client.ping(member.address)
        if reachable:
            if not member.active:
                await self._storage.set_active(member.ip, member.port)
            return
        await self._storage.notify_failure(member.ip, member.port)
        failures = await self._storage.member_failures(member.ip, member.port)
        window_start = time.time() - self.config.interval_secs_threshold
        recent = [f for f in failures if f >= window_start]
        if len(recent) >= self.config.num_failures_threshold and member.active:
            if (
                self.config.trust_heartbeat_freshness
                and member.last_seen
                and member.last_seen >= window_start
            ):
                # Asymmetric partition: this node cannot reach the member,
                # but its heartbeat row is fresher than the failure window —
                # it demonstrably reaches the rendezvous and re-pushes
                # itself active every tick. Keep recording failures in the
                # ledger; do not flip the verdict (it would flap
                # active/inactive once per tick against the re-push).
                self.stats.suppressed_verdicts += 1
                log.debug(
                    "gossip: %s unreachable but heartbeat-fresh; verdict suppressed",
                    member.address,
                )
                return
            log.info("gossip: marking %s inactive (%d recent failures)",
                     member.address, len(recent))
            await self._storage.set_inactive(member.ip, member.port)

    async def _drop_stale(self, members: list[Member]) -> None:
        drop_after = self.config.drop_inactive_after_secs
        if drop_after is None:
            return
        cutoff = time.time() - drop_after
        for m in members:
            if not m.active and m.last_seen and m.last_seen < cutoff:
                log.info("gossip: dropping long-inactive member %s", m.address)
                await self._storage.remove(m.ip, m.port)

    # -- main loop (reference peer_to_peer.rs:144-209) ------------------------

    def _backoff(self) -> DecorrelatedJitter:
        # Retry sleeps during a storage outage: start well under the tick
        # interval (the outage may be a blip) and cap at one interval — a
        # degraded detector should probe MORE eagerly than a healthy one,
        # never less.
        interval = max(1e-3, self.config.interval_secs)
        return DecorrelatedJitter(base=interval / 8.0, cap=interval)

    async def serve(self, address: str) -> None:
        backoff = self._backoff()
        while True:
            # Registration must survive a rendezvous that is down at boot:
            # retry with jitter instead of dying before the first tick.
            try:
                await self._storage.push(
                    Member.from_address(
                        address, active=True, load=self._load_snapshot(),
                        shard_map=self._shard_map,
                    )
                )
                self._note_storage_ok()
                break
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — storage outage at boot
                self._note_storage_error("membership.push", e)
                await asyncio.sleep(backoff.next())
        client = Client(
            self._storage,
            connect_timeout=self.config.ping_timeout,
            transport_faults=self._transport_faults,
            identity=address,
        )
        view: list[Member] = []  # last good membership snapshot
        try:
            while True:
                tick_start = time.monotonic()
                tick_ok = True
                try:
                    members = await self._storage.members()
                    view = members
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # noqa: BLE001 — keep serving last good view
                    tick_ok = False
                    self._note_storage_error("membership.members", e)
                    members = view
                monitored = self._members_to_monitor(members, address)
                results = await asyncio.gather(
                    *(self._test_member(client, m) for m in monitored),
                    return_exceptions=True,
                )
                for r in results:
                    if isinstance(r, asyncio.CancelledError):
                        raise r
                    if isinstance(r, BaseException):
                        # A ping verdict's storage bookkeeping failed; the
                        # other members' probes already ran (gather).
                        tick_ok = False
                        self._note_storage_error("membership.verdict", r)
                try:
                    await self._drop_stale(members)
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # noqa: BLE001
                    tick_ok = False
                    self._note_storage_error("membership.remove", e)
                # Keep our own registration fresh — re-push (not just
                # set_active) so a node whose row was dropped while it was
                # partitioned can rejoin once reachable again. The push also
                # refreshes this node's load vector for peers' views.
                try:
                    await self._storage.push(
                        Member.from_address(
                            address, active=True, load=self._load_snapshot(),
                            shard_map=self._shard_map,
                        )
                    )
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # noqa: BLE001
                    tick_ok = False
                    self._note_storage_error("membership.push", e)
                self.stats.ticks += 1
                if tick_ok:
                    self._note_storage_ok()
                    backoff = self._backoff()  # reset the jitter sequence
                    elapsed = time.monotonic() - tick_start
                    await asyncio.sleep(max(0.0, self.config.interval_secs - elapsed))
                else:
                    self.stats.degraded_ticks += 1
                    await asyncio.sleep(backoff.next())
        finally:
            client.close()
