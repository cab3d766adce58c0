"""Cluster providers: who is alive, and how we find out.

Reference: ``rio-rs/src/cluster/membership_protocol/mod.rs:15-31`` — a
``ClusterProvider`` owns a membership-storage view and runs a long-lived
``serve(address)`` loop next to the server (registration, health checking).
"""

from __future__ import annotations

import abc
import asyncio
from typing import Callable

from ..storage import Member, MembershipStorage

__all__ = ["ClusterProvider", "LocalClusterProvider"]


class ClusterProvider(abc.ABC):
    # Zero-arg callable returning this node's encoded load vector
    # (``LoadMonitor.encoded_snapshot``); providers fold it into every
    # heartbeat push so the vector piggybacks on the membership row.
    _load_source: Callable[[], str] | None = None

    @abc.abstractmethod
    def members_storage(self) -> MembershipStorage: ...

    @abc.abstractmethod
    async def serve(self, address: str) -> None:
        """Run until cancelled; must register ``address`` as an active member."""

    def set_load_source(self, source: Callable[[], str] | None) -> None:
        self._load_source = source

    # Encoded rio_tpu_torch.commands.ShardMap this node advertises ('' for
    # non-sharded nodes). Like the load vector it piggybacks on every
    # heartbeat push, so shard-aware clients learn the worker slot map from
    # the membership view with no new RPCs.
    _shard_map: str = ""

    def set_shard_map(self, encoded: str) -> None:
        self._shard_map = encoded or ""

    # Optional observability hooks, wired by the server the same way as the
    # load source: a Journal for STORAGE outage/recovery events and a
    # StorageHealth for rio.storage.* gauges. Both default to None — a bare
    # provider (tests, examples) journals nothing and never fails on it.
    _journal = None
    _storage_health = None

    def set_observability(self, journal=None, storage_health=None) -> None:
        self._journal = journal
        self._storage_health = storage_health

    def _load_snapshot(self) -> str:
        """Encoded load for the next heartbeat push ('' when unmonitored
        or the monitor's snapshot fails — telemetry never blocks liveness)."""
        if self._load_source is None:
            return ""
        try:
            return self._load_source()
        except Exception:  # noqa: BLE001
            return ""


class LocalClusterProvider(ClusterProvider):
    """Test no-op provider (reference ``local.rs:13-32``): registers self,
    then idles — liveness is whatever the shared storage says. With a load
    source wired it re-pushes its heartbeat row frequently so load vectors
    propagate even without a gossip loop."""

    def __init__(self, members_storage: MembershipStorage) -> None:
        self._storage = members_storage

    def members_storage(self) -> MembershipStorage:
        return self._storage

    async def serve(self, address: str) -> None:
        # Same outage contract as the gossip provider: a storage blip must
        # never kill the provider task (and with it the server). Retry the
        # registration, swallow heartbeat push failures.
        while True:
            try:
                await self._storage.push(
                    Member.from_address(
                        address, active=True, load=self._load_snapshot(),
                        shard_map=self._shard_map,
                    )
                )
                break
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — storage outage at boot
                await asyncio.sleep(0.1)
        while True:
            if self._load_source is None and not self._shard_map:
                await asyncio.sleep(3600)
                continue
            await asyncio.sleep(0.2)
            try:
                await self._storage.push(
                    Member.from_address(
                        address, active=True, load=self._load_snapshot(),
                        shard_map=self._shard_map,
                    )
                )
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — ride out the blip
                pass
