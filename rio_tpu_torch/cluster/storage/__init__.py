"""Membership storage: the cluster's shared rendezvous.

Reference: ``rio-rs/src/cluster/storage/mod.rs`` — ``Member{ip, port,
active, last_seen}`` (``:20-59``) and the ``MembershipStorage`` trait
(``:70-121``): nodes register themselves, the gossip protocol records
failures and flips activity, and clients read the active set to route
requests. Backends: in-memory (tests), sqlite, and a read-only HTTP view.
"""

from __future__ import annotations

import abc
import dataclasses
import time


@dataclasses.dataclass
class Member:
    """One cluster node as seen through membership storage."""

    ip: str
    port: int
    active: bool = False
    last_seen: float = 0.0  # unix seconds
    # Encoded load vector (rio_tpu_torch.load.LoadVector.encode()); empty when the
    # node runs no LoadMonitor or the backend predates the column. Riding the
    # heartbeat row is what lets every peer derive a ClusterLoadView from the
    # storage it already polls — no new RPCs.
    load: str = ""
    # Encoded rio_tpu_torch.commands.ShardMap ("epoch|addr,addr,..."); empty for
    # non-sharded nodes and legacy rows. Same appended-column contract as
    # ``load``: rides the heartbeat so shard-aware clients learn the worker
    # slot map from the membership view they already poll.
    shard_map: str = ""

    @property
    def address(self) -> str:
        return f"{self.ip}:{self.port}"

    @classmethod
    def from_address(
        cls, address: str, active: bool = False, load: str = "", shard_map: str = ""
    ) -> "Member":
        ip, _, port = address.rpartition(":")
        return cls(
            ip=ip,
            port=int(port),
            active=active,
            last_seen=time.time(),
            load=load,
            shard_map=shard_map,
        )


class MembershipStorage(abc.ABC):
    """CRUD + failure ledger over the member set (reference ``:70-121``)."""

    async def prepare(self) -> None:
        """Run migrations / create schema. Idempotent."""
        return None

    @abc.abstractmethod
    async def push(self, member: Member) -> None:
        """Insert-or-update a member (upsert keyed by ip:port)."""

    @abc.abstractmethod
    async def remove(self, ip: str, port: int) -> None: ...

    @abc.abstractmethod
    async def set_is_active(self, ip: str, port: int, active: bool) -> None: ...

    @abc.abstractmethod
    async def members(self) -> list[Member]: ...

    @abc.abstractmethod
    async def notify_failure(self, ip: str, port: int) -> None:
        """Append a failure observation (timestamped) for a member."""

    @abc.abstractmethod
    async def member_failures(self, ip: str, port: int) -> list[float]:
        """Recent failure timestamps for a member (bounded window)."""

    # -- default helpers (reference mod.rs:96-121) --------------------------

    async def active_members(self) -> list[Member]:
        return [m for m in await self.members() if m.active]

    async def is_active(self, address: str) -> bool:
        return any(m.address == address and m.active for m in await self.members())

    async def set_active(self, ip: str, port: int) -> None:
        await self.set_is_active(ip, port, True)

    async def set_inactive(self, ip: str, port: int) -> None:
        await self.set_is_active(ip, port, False)


class LocalStorage(MembershipStorage):
    """In-memory membership whose *clones alias the same data*.

    Reference ``cluster/storage/local.rs:13-64``: sharing one instance across
    N in-process servers is the backbone of the multi-node-in-one-process
    test harness.
    """

    def __init__(self) -> None:
        self._members: dict[str, Member] = {}
        self._failures: dict[str, list[float]] = {}

    async def push(self, member: Member) -> None:
        member.last_seen = time.time()
        self._members[member.address] = member

    async def remove(self, ip: str, port: int) -> None:
        self._members.pop(f"{ip}:{port}", None)
        self._failures.pop(f"{ip}:{port}", None)

    async def set_is_active(self, ip: str, port: int, active: bool) -> None:
        m = self._members.get(f"{ip}:{port}")
        if m is not None:
            m.active = active
            if active:
                m.last_seen = time.time()

    async def members(self) -> list[Member]:
        return [dataclasses.replace(m) for m in self._members.values()]

    async def notify_failure(self, ip: str, port: int) -> None:
        self._failures.setdefault(f"{ip}:{port}", []).append(time.time())

    async def member_failures(self, ip: str, port: int) -> list[float]:
        # Bounded like the SQL backends' LIMIT 100 (reference sqlite.rs:165-179)
        return self._failures.get(f"{ip}:{port}", [])[-100:]
