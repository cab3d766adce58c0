"""Multi-node-in-one-process integration harness.

Reference: ``rio-rs/tests/server_utils.rs:49-139`` — boot N real servers on
ephemeral ports inside one event loop, all sharing *aliased* in-memory
membership/placement/state fakes, race the test body against the servers and
a timeout, and tear everything down.

The port's copy of ``tests/server_utils.py``, on the port's runtime, for
the programs of the package that boot such a cluster
(:mod:`rio_tpu_torch.tools.endurance`).
"""

from __future__ import annotations

import asyncio
import contextlib
from dataclasses import dataclass, field
from typing import Awaitable, Callable

from rio_tpu_torch import (
    AppData,
    Client,
    LocalObjectPlacement,
    LocalStorage,
    Registry,
    Server,
)
from rio_tpu_torch.cluster.membership_protocol import ClusterProvider, LocalClusterProvider
from rio_tpu_torch.cluster.membership_protocol.peer_to_peer import (
    PeerToPeerClusterConfig,
    PeerToPeerClusterProvider,
)
from rio_tpu_torch.object_placement import ObjectPlacement
from rio_tpu_torch.registry import ObjectId


def fast_gossip_config() -> PeerToPeerClusterConfig:
    """Aggressive gossip for tests (reference ``server_utils.rs:25-31``)."""
    return PeerToPeerClusterConfig(
        interval_secs=0.25,
        num_failures_threshold=1,
        interval_secs_threshold=2.0,
        drop_inactive_after_secs=60.0,
        ping_timeout=0.2,
    )


@dataclass
class Cluster:
    """Everything a test body needs to poke at a running cluster."""

    servers: list[Server]
    members: LocalStorage
    placement: ObjectPlacement
    tasks: list[asyncio.Task] = field(default_factory=list)

    @property
    def addresses(self) -> list[str]:
        return [s.local_address for s in self.servers]

    def client(self, **kwargs) -> Client:
        return Client(self.members, **kwargs)

    async def is_allocated(self, type_name: str, object_id: str) -> bool:
        """Placement introspection (reference ``server_utils.rs:106-114``)."""
        return await self.placement.lookup(ObjectId(type_name, object_id)) is not None

    async def allocation_address(self, type_name: str, object_id: str) -> str | None:
        return await self.placement.lookup(ObjectId(type_name, object_id))


async def wait_for_active_members(
    members: LocalStorage, count: int, timeout: float = 10.0
) -> None:
    """Poll until ≥``count`` members are active (reference ``:119-139``)."""
    deadline = asyncio.get_event_loop().time() + timeout
    while asyncio.get_event_loop().time() < deadline:
        if len(await members.active_members()) >= count:
            return
        await asyncio.sleep(0.02)
    raise TimeoutError(f"never saw {count} active members")


async def run_integration_test(
    test_fn: Callable[[Cluster], Awaitable[None]],
    *,
    registry_builder: Callable[[], Registry],
    num_servers: int = 2,
    timeout: float = 30.0,
    members: LocalStorage | None = None,
    placement: ObjectPlacement | None = None,
    gossip: bool = False,
    provider_builder: Callable[[LocalStorage], ClusterProvider] | None = None,
    transport: str = "asyncio",
    server_kwargs: dict | None = None,
    app_data_builder: Callable[[], "AppData"] | None = None,
) -> None:
    members = members if members is not None else LocalStorage()
    placement = placement if placement is not None else LocalObjectPlacement()

    servers: list[Server] = []
    for _ in range(num_servers):
        if provider_builder is not None:
            provider: ClusterProvider = provider_builder(members)
        elif gossip:
            provider = PeerToPeerClusterProvider(members, fast_gossip_config())
        else:
            provider = LocalClusterProvider(members)
        extra = dict(server_kwargs or {})
        if app_data_builder is not None:
            # One AppData PER SERVER (Server.__init__ injects per-node
            # handles like AdminSender into it — sharing one instance
            # across servers would clobber them); the builder puts shared
            # fakes (e.g. an aliased ReminderStorage) into each.
            extra["app_data"] = app_data_builder()
        server = Server(
            address="127.0.0.1:0",
            registry=registry_builder(),
            cluster_provider=provider,
            object_placement_provider=placement,
            transport=transport,
            **extra,
        )
        await server.prepare()
        await server.bind()
        servers.append(server)

    cluster = Cluster(servers=servers, members=members, placement=placement)
    cluster.tasks = [asyncio.create_task(s.run()) for s in servers]
    try:
        await wait_for_active_members(members, num_servers)
        # Race the test against *all* servers exiting and the timeout
        # (reference tokio::select! over join_all(servers) vs test vs sleep,
        # server_utils.rs:92-101 — a single server exiting is a legitimate
        # event some tests trigger on purpose).
        test = asyncio.create_task(test_fn(cluster))
        # A server finishing *cleanly* (admin exit) is legitimate; a server
        # crashing with an exception fails the test immediately with that
        # exception, and all-servers-gone fails it too.
        crash: asyncio.Future = asyncio.get_event_loop().create_future()
        remaining = len(cluster.tasks)

        def on_server_done(t: asyncio.Task) -> None:
            nonlocal remaining
            remaining -= 1
            if crash.done():
                return
            exc = None if t.cancelled() else t.exception()
            if exc is not None:
                crash.set_exception(exc)
            elif remaining == 0:
                crash.set_exception(
                    AssertionError("every server exited before the test completed")
                )

        for t in cluster.tasks:
            t.add_done_callback(on_server_done)
        done, _ = await asyncio.wait(
            [test, crash], timeout=timeout, return_when=asyncio.FIRST_COMPLETED
        )
        if not done:
            test.cancel()
            crash.cancel()
            raise TimeoutError(f"integration test timed out after {timeout}s")
        if test in done:
            # Retrieve (and surface) a crash that completed in the same
            # wakeup; cancel() on an already-failed future is a no-op and
            # would leave its exception unretrieved.
            if crash.done() and not crash.cancelled():
                crash.result()
            else:
                crash.cancel()
            test.result()  # re-raise test failures
        else:
            test.cancel()
            crash.result()  # raises the server's exception
    finally:
        for t in cluster.tasks:
            t.cancel()
        await asyncio.gather(*cluster.tasks, return_exceptions=True)
        with contextlib.suppress(Exception):
            for s in servers:
                s._listener and s._listener.close()
