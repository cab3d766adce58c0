"""presence: background tasks, shared counters, and self-shutdown.

Parity with the reference's presence example
(``rio-rs/examples/presence/src/services.rs:25-55``): a per-user
``PresenceService`` actor that

* spawns a background watchdog task in ``after_load``;
* bumps a process-global counter living in ``AppData`` (the reference's
  ``AtomicU32``) while the user is online;
* shuts itself down via the admin channel (``AdminSender``) once the user
  goes idle — the watchdog, not a request, triggers deallocation.

Runs a 2-node cluster in one process::

    python -m rio_tpu_torch.examples.presence
"""

import asyncio
import itertools
import time


from rio_tpu_torch import (
    AdminCommand,
    AdminSender,
    AppData,
    Client,
    LocalObjectPlacement,
    LocalStorage,
    Registry,
    Server,
    ServiceObject,
    handler,
    message,
    type_id,
)
from rio_tpu_torch.cluster.membership_protocol import LocalClusterProvider

IDLE_AFTER = 0.6   # seconds without a heartbeat before the watchdog evicts
WATCH_TICK = 0.15


@message
class Heartbeat:
    pass


@message
class OnlineCount:
    count: int = 0


class OnlineCounter:
    """Shared across every actor on a node via AppData (reference AtomicU32)."""

    def __init__(self) -> None:
        self.value = itertools.count()  # monotone ids for demo logging
        self.online = 0


class PresenceService(ServiceObject):
    """One per user; alive exactly while the user is heartbeating."""

    def __init__(self) -> None:
        super().__init__()
        self.last_seen = 0.0
        self._watchdog: asyncio.Task | None = None

    async def after_load(self, ctx: AppData) -> None:
        self.last_seen = time.monotonic()
        counter = ctx.get_or_default(OnlineCounter)
        counter.online += 1
        # Background task owned by the actor (reference spawns in after_load).
        self._watchdog = asyncio.create_task(self._watch(ctx))

    async def before_shutdown(self, ctx: AppData) -> None:
        ctx.get_or_default(OnlineCounter).online -= 1
        if self._watchdog is not None:
            self._watchdog.cancel()
            self._watchdog = None

    async def _watch(self, ctx: AppData) -> None:
        while True:
            await asyncio.sleep(WATCH_TICK)
            if time.monotonic() - self.last_seen > IDLE_AFTER:
                # Idle: deallocate ourselves through the admin queue —
                # the same path the reference's AdminSender uses.
                ctx.get(AdminSender).send(
                    AdminCommand.shutdown(type_id(type(self)), self.id)
                )
                return

    @handler
    async def beat(self, msg: Heartbeat, ctx: AppData) -> OnlineCount:
        self.last_seen = time.monotonic()
        return OnlineCount(count=ctx.get_or_default(OnlineCounter).online)


def build_registry() -> Registry:
    return Registry().add_type(PresenceService)


async def main() -> None:
    members = LocalStorage()
    placement = LocalObjectPlacement()
    servers = []
    for _ in range(2):
        s = Server(
            address="127.0.0.1:0",
            registry=build_registry(),
            cluster_provider=LocalClusterProvider(members),
            object_placement_provider=placement,
        )
        await s.prepare()
        print(f"[server] presence node on {await s.bind()}")
        servers.append(s)
    tasks = [asyncio.create_task(s.run()) for s in servers]
    await asyncio.sleep(0.1)

    client = Client(members)
    for user in ("ana", "bo", "cy"):
        r = await client.send(PresenceService, user, Heartbeat(), returns=OnlineCount)
        print(f"[client] {user} online (node sees {r.count} online)")

    print("[demo] keeping 'ana' alive, letting 'bo' and 'cy' idle out…")
    for _ in range(6):
        await asyncio.sleep(0.3)
        r = await client.send(PresenceService, "ana", Heartbeat(), returns=OnlineCount)
    print(f"[client] after idling: ana's node sees {r.count} online")

    allocated = [
        u for u in ("ana", "bo", "cy")
        if await placement.lookup(
            __import__("rio_tpu_torch").ObjectId("PresenceService", u)
        ) is not None
    ]
    print(f"[demo] still allocated: {allocated}")

    client.close()
    for t in tasks:
        t.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)
    print("[demo] done")


if __name__ == "__main__":
    asyncio.run(main())
