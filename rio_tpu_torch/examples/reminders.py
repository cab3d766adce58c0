"""reminders: presence expiry without a polling watchdog.

``examples/presence.py`` keeps every actor alive with a hand-rolled
background task that wakes 4x/second to check an idle deadline — the
pattern every framework user reinvents when nothing can *wake* an actor.
This example is the same presence-expiry feature rebuilt on the timers &
reminders subsystem:

* a **volatile timer** (``register_timer``) replaces the watchdog task:
  the idle check is an ordinary message through the dispatch queue
  (serialized with real requests — no races against handlers), and the
  framework cancels it at deactivation;
* a **durable reminder** (``register_reminder``) drives a cleanup sweep
  that must survive the actor being deallocated — the whole point: a
  deactivated ``SessionLog`` is *woken* on schedule by whichever node owns
  its reminder shard, trims its persisted history, and deactivates again.

Runs a 2-node cluster in one process::

    python -m rio_tpu_torch.examples.reminders
"""

import asyncio
import time


from rio_tpu_torch import (
    AppData,
    Client,
    LocalObjectPlacement,
    LocalReminderStorage,
    LocalStorage,
    Registry,
    ReminderDaemonConfig,
    ReminderFired,
    ReminderStorage,
    Server,
    ServiceObject,
    handler,
    message,
)
from rio_tpu_torch.cluster.membership_protocol import LocalClusterProvider

IDLE_AFTER = 0.6   # seconds without a heartbeat before self-shutdown
IDLE_TICK = 0.15   # volatile-timer period for the idle check
SWEEP_EVERY = 0.5  # durable-reminder period for the cleanup sweep


@message
class Heartbeat:
    pass


@message
class IdleCheck:
    pass


@message
class Seen:
    online: bool = True
    server: str = ""


class PresenceService(ServiceObject):
    """One per user; alive exactly while the user is heartbeating.

    The idle watchdog is a volatile timer: registered on activation, fired
    through the normal dispatch queue, cancelled automatically when the
    actor shuts down. Compare ``examples/presence.py``, which hand-rolls
    the same loop with asyncio.create_task + manual cancellation.
    """

    def __init__(self) -> None:
        super().__init__()
        self.last_seen = 0.0

    async def after_load(self, ctx: AppData) -> None:
        self.last_seen = time.monotonic()
        self.register_timer(ctx, "idle-check", IDLE_TICK, IdleCheck())

    @handler
    async def beat(self, msg: Heartbeat, ctx: AppData) -> Seen:
        self.last_seen = time.monotonic()
        from rio_tpu_torch import ServerInfo

        return Seen(server=ctx.get(ServerInfo).address)

    @handler
    async def idle(self, msg: IdleCheck, ctx: AppData) -> None:
        if time.monotonic() - self.last_seen > IDLE_AFTER:
            print(f"[{self.id}] idle -> deactivating (timer dies with me)")
            await self.shutdown(ctx)


class SessionLog(ServiceObject):
    """Cluster-wide session ledger, swept by a DURABLE reminder.

    The sweep keeps running even when this actor is deactivated: the
    reminder daemon on the shard-owning node sends ``rio.ReminderFired``,
    which re-activates the actor wherever placement wants it.
    """

    def __init__(self) -> None:
        super().__init__()
        self.entries: list[tuple[str, float]] = []
        self.sweeps = 0

    @handler
    async def record(self, msg: Heartbeat, ctx: AppData) -> None:
        self.entries.append((f"hb-{len(self.entries)}", time.time()))
        if len(self.entries) == 1:  # first write arms the sweep
            await self.register_reminder(ctx, "sweep", SWEEP_EVERY)

    async def receive_reminder(self, fired: ReminderFired, ctx: AppData) -> None:
        from rio_tpu_torch import ServerInfo

        cutoff = time.time() - 2 * SWEEP_EVERY
        before = len(self.entries)
        self.entries = [e for e in self.entries if e[1] >= cutoff]
        self.sweeps += 1
        print(
            f"[{self.id}] sweep #{self.sweeps} on "
            f"{ctx.get(ServerInfo).address}: {before} -> {len(self.entries)} "
            f"entries (missed={fired.missed})"
        )


def build_registry() -> Registry:
    return Registry().add_type(PresenceService).add_type(SessionLog)


async def main() -> None:
    members = LocalStorage()
    placement = LocalObjectPlacement()
    reminders = LocalReminderStorage()
    servers = []
    for _ in range(2):
        s = Server(
            address="127.0.0.1:0",
            registry=build_registry(),
            cluster_provider=LocalClusterProvider(members),
            object_placement_provider=placement,
            app_data=AppData().set(reminders, as_type=ReminderStorage),
            reminder_daemon=True,
            reminder_daemon_config=ReminderDaemonConfig(
                poll_interval=0.1, lease_ttl=1.0
            ),
        )
        await s.prepare()
        print(f"[server] node on {await s.bind()}")
        servers.append(s)
    tasks = [asyncio.create_task(s.run()) for s in servers]
    await asyncio.sleep(0.1)

    client = Client(members)
    for user in ("ana", "bo"):
        r = await client.send(PresenceService, user, Heartbeat(), returns=Seen)
        print(f"[client] {user} online via {r.server}")
        await client.send(SessionLog, "global", Heartbeat())

    print("[demo] keeping 'ana' alive; 'bo' idles out via its timer…")
    for _ in range(6):
        await asyncio.sleep(0.3)
        await client.send(PresenceService, "ana", Heartbeat(), returns=Seen)
        await client.send(SessionLog, "global", Heartbeat())

    print("[demo] the durable sweep keeps firing regardless of activations…")
    await asyncio.sleep(1.2)

    client.close()
    for t in tasks:
        t.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)
    print("[demo] done")


if __name__ == "__main__":
    asyncio.run(main())
