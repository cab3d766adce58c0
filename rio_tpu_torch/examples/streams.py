"""streams: durable partitioned streams + saga workflows, end to end.

The platform layer on top of the actor mesh (``rio_tpu_torch/streams/``):

* a **producer** publishes orders into the durable ``orders`` stream —
  every publish is acked with its ``(partition, offset)`` only after the
  append hit storage (sqlite here; postgres/redis are the same trait);
* **two consumer groups** (``billing`` and ``audit``) each get every
  record exactly-once-per-group via placement-seated cursor actors, with
  the reminder subsystem as the at-least-once redelivery backstop;
* a **saga** coordinates a multi-actor workflow with typed
  step/compensation chains — the demo runs one saga to completion, then
  forces a veto mid-chain and watches the compensations run in reverse;
* the whole saga is **one trace tree**: the same waterfall the operator
  CLI renders (``python -m rio_tpu_torch.admin trace``) is assembled here
  in-process from every node's span ring + journal, so the
  step/compensation story reads as causal hops, not scattered logs.

Run::

    python -m rio_tpu_torch.examples.streams
"""

import asyncio
import tempfile
from collections import defaultdict


from rio_tpu_torch import (
    AppData,
    Client,
    LocalObjectPlacement,
    LocalReminderStorage,
    LocalStorage,
    Registry,
    ReminderDaemonConfig,
    ReminderStorage,
    Server,
    ServiceObject,
    handler,
    message,
    tracing,
)
from rio_tpu_torch.admin import assemble_waterfall, cluster_events, format_waterfall, scrape_spans
from rio_tpu_torch.cluster.membership_protocol import LocalClusterProvider
from rio_tpu_torch.journal import SAGA, STREAM, format_event
from rio_tpu_torch.registry import wire_error
from rio_tpu_torch.state import LocalState, StateProvider
from rio_tpu_torch.streams import StreamDelivery, StreamStorage
from rio_tpu_torch.streams.sqlite import SqliteStreamStorage

RECEIVED: dict[str, list[str]] = defaultdict(list)  # "group/sink-id" -> items
LEDGER: dict[str, list[str]] = defaultdict(list)  # account id -> effects


@message
class Order:
    sku: str = ""
    qty: int = 0


@message
class Reserve:
    amount: int = 0


@message
class Release:
    amount: int = 0


@wire_error
class OutOfStock(Exception):
    pass


class Billing(ServiceObject):
    """Consumer group ``billing``: one cursor actor per partition feeds
    these; the id encodes stream/group/partition."""

    async def receive_stream(self, delivery: StreamDelivery, ctx) -> None:
        order = delivery.decode(Order)
        RECEIVED[f"billing/{self.id}"].append(order.sku)


class Audit(ServiceObject):
    async def receive_stream(self, delivery: StreamDelivery, ctx) -> None:
        order = delivery.decode(Order)
        RECEIVED[f"audit/{self.id}"].append(order.sku)


class Inventory(ServiceObject):
    """Saga participant: reserve/release with a persisted dedup ledger
    (the framework's blanket ``rio.SagaStep`` handler wraps these)."""

    @handler
    async def reserve(self, msg: Reserve, ctx) -> int:
        LEDGER[self.id].append(f"reserve:{msg.amount}")
        return msg.amount

    @handler
    async def release(self, msg: Release, ctx) -> int:
        LEDGER[self.id].append(f"release:{msg.amount}")
        return msg.amount


class StrictWarehouse(ServiceObject):
    """Participant that vetoes every reservation — the forced-compensation
    leg of the demo."""

    @handler
    async def reserve(self, msg: Reserve, ctx) -> int:
        LEDGER[self.id].append("veto")
        raise OutOfStock(f"{self.id} cannot reserve {msg.amount}")


async def main() -> dict:
    tracing.set_sample_rate(1.0)  # trace everything: the demo shows waterfalls
    tmp = tempfile.TemporaryDirectory(prefix="rio-streams-")
    storage = SqliteStreamStorage(f"{tmp.name}/streams.db")
    state = LocalState()
    reminders = LocalReminderStorage()

    members = LocalStorage()
    placement = LocalObjectPlacement()
    servers: list[Server] = []
    for _ in range(2):
        app_data = (
            AppData()
            .set(storage, as_type=StreamStorage)
            .set(state, as_type=StateProvider)
            .set(reminders, as_type=ReminderStorage)
        )
        s = Server(
            address="127.0.0.1:0",
            registry=(
                Registry()
                .add_type(Billing)
                .add_type(Audit)
                .add_type(Inventory)
                .add_type(StrictWarehouse)
            ),
            cluster_provider=LocalClusterProvider(members),
            object_placement_provider=placement,
            app_data=app_data,
            # The redelivery/resume backstop, at demo cadence.
            reminder_daemon=True,
            reminder_daemon_config=ReminderDaemonConfig(
                poll_interval=0.05, lease_ttl=2.0
            ),
        )
        await s.prepare()
        print(f"[server] streams node on {await s.bind()}")
        servers.append(s)
    tasks = [asyncio.create_task(s.run()) for s in servers]
    await asyncio.sleep(0.1)

    client = Client(members)
    summary: dict = {}
    try:
        # -- producer → two consumer groups over the wire -----------------
        await client.subscribe_stream("orders", "billing", Billing)
        await client.subscribe_stream("orders", "audit", Audit)
        skus = [f"sku-{i}" for i in range(8)]
        acks = []
        for i, sku in enumerate(skus):
            ack = await client.publish_stream(
                "orders", Order(sku=sku, qty=1 + i), key=sku
            )
            acks.append(ack)
        print(f"[produce] {len(acks)} publishes acked, e.g. sku-0 -> {acks[0]}")

        def group_total(group: str) -> int:
            return sum(
                len(v) for k, v in RECEIVED.items() if k.startswith(group + "/")
            )

        deadline = asyncio.get_event_loop().time() + 20.0
        while group_total("billing") < len(skus) or group_total("audit") < len(skus):
            if asyncio.get_event_loop().time() > deadline:
                raise RuntimeError("consumer groups never caught up")
            await asyncio.sleep(0.05)
        for group in ("billing", "audit"):
            cursors = await client.stream_cursors("orders", group)
            lag = 0
            for p, off in cursors.items():
                lag += await storage.latest("orders", p) - off
            print(
                f"[consume] group {group}: {group_total(group)} deliveries "
                f"across {len(cursors)} partition cursor(s), lag={lag}"
            )
        summary["published"] = len(acks)
        summary["billing"] = group_total("billing")
        summary["audit"] = group_total("audit")

        # -- saga one: happy path ------------------------------------------
        from rio_tpu_torch.streams.saga import step

        done = await client.start_saga(
            "order-1000",
            [
                step(Inventory, "east", Reserve(amount=3), Release(amount=3)),
                step(Inventory, "west", Reserve(amount=5), Release(amount=5)),
            ],
        )
        print(f"[saga] order-1000 -> {done.status} ({done.total} steps)")
        assert done.status == "completed", done

        # -- saga two: forced compensation ---------------------------------
        undone = await client.start_saga(
            "order-1001",
            [
                step(Inventory, "east", Reserve(amount=2), Release(amount=2)),
                step(StrictWarehouse, "strict", Reserve(amount=9), Release(amount=9)),
            ],
        )
        print(
            f"[saga] order-1001 -> {undone.status} "
            f"(error: {undone.error.splitlines()[0] if undone.error else ''})"
        )
        assert undone.status == "compensated", undone
        assert LEDGER["east"] == ["reserve:3", "reserve:2", "release:2"]
        print(f"[saga] ledger east={LEDGER['east']} strict={LEDGER['strict']}")
        summary["saga_completed"] = done.status
        summary["saga_compensated"] = undone.status

        # -- the waterfall: one saga = one trace tree ----------------------
        trace_id = undone.trace_id
        snapshots = await scrape_spans(client, members, trace_id=trace_id)
        events = await cluster_events(client, members, kinds=[SAGA, STREAM])
        trees = assemble_waterfall(
            [r for s in snapshots for r in s.spans()],
            [e for e in events if e.trace_id == trace_id],
        )
        print(
            f"\n[trace] compensated saga as one waterfall "
            f"(admin `trace {trace_id[:16]}…` renders the same):"
        )
        if trace_id in trees:
            print(format_waterfall(trace_id, trees[trace_id]))
        saga_story = [e for e in events if e.kind == SAGA]
        print(f"\n[journal] saga story ({len(saga_story)} SAGA events):")
        for ev in saga_story[-12:]:
            print(f"  {format_event(ev)}")
        summary["waterfall_hops"] = trees.get(trace_id, {}).get("hops", 0)
        summary["saga_events"] = len(saga_story)
        assert summary["saga_events"] > 0
    finally:
        client.close()
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        tracing.set_sample_rate(0.0)
        tmp.cleanup()
    print("[demo] done")
    return summary


if __name__ == "__main__":
    out = asyncio.run(main())
    print(out)
