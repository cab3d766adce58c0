"""In-process command channels between handlers and the server loop.

Reference: ``rio-rs/src/server.rs:30-73`` — ``AdminCommands`` (server exit /
object shutdown) and the internal-client ``SendCommand`` oneshot bridge that
lets a handler message other objects through its own server (consumed at
``server.rs:309-363``). Handlers reach these through :class:`~rio_tpu_torch.app_data.AppData`.
"""

from __future__ import annotations

import asyncio
import dataclasses
import zlib
from enum import Enum
from typing import Any


def shard_of(type_name: str, object_id: str, n_shards: int) -> int:
    """Deterministic shard index for an object key.

    crc32 over the canonical ``type/id`` key: stable across processes and
    restarts (Python's ``hash()`` is salted per process), cheap, and uniform
    enough at the worker counts one host runs. Every worker of a sharded
    node computes the same slice from the same membership slots — no
    coordination, no directory round trip.
    """
    return zlib.crc32(f"{type_name}/{object_id}".encode()) % n_shards


@dataclasses.dataclass(frozen=True)
class ShardRouter:
    """AppData-injectable shard map for one worker of a sharded node.

    ``slots[i]`` is the identity address of the worker owning shard ``i``
    (``shard_of(type, id, len(slots))``). The service layer consults this
    ONLY when seating an unplaced object: a non-owner worker answers the
    standard ``Redirect`` to the owner instead of self-assigning, so the
    existing directory machinery routes cross-shard traffic unchanged.
    Kept here (not in ``rio_tpu_torch.sharded``) for the same reason as
    :class:`DispatchObserver`: the request engine resolves it per
    connection and must never import the supervisor module.
    """

    self_address: str
    slots: tuple  # worker identity addresses, index == shard

    def owner(self, type_name: str, object_id: str) -> str:
        return self.slots[shard_of(type_name, object_id, len(self.slots))]


@dataclasses.dataclass(frozen=True)
class ShardMap:
    """The shard map a sharded node publishes through its membership rows.

    ``slots`` mirrors :class:`ShardRouter.slots` (worker identity
    addresses, index == shard); ``epoch`` increments every time the
    supervisor (re)builds the map, so a client can tell a *reseated* map
    apart from the one it adopted and drop stale direct-dial state.

    The encoded form rides the membership heartbeat as an appended column
    (the ``Member.load`` precedent) so legacy rows — and legacy readers —
    are untouched. Encoding constraint: the Redis backend joins member
    fields with ``;``, so the text must never contain one; ``epoch|a,b,c``
    uses only ``|`` and ``,``, both impossible in a ``host:port`` address.
    """

    epoch: int
    slots: tuple  # worker identity addresses, index == shard

    def encode(self) -> str:
        return f"{self.epoch}|{','.join(self.slots)}"

    @classmethod
    def decode(cls, text: str) -> "ShardMap | None":
        """Parse an encoded map; garbage (or empty) decodes to ``None`` —
        a client must treat an unparseable column exactly like a legacy
        row with no map at all."""
        if not text or "|" not in text:
            return None
        head, _, body = text.partition("|")
        try:
            epoch = int(head)
        except ValueError:
            return None
        slots = tuple(s for s in body.split(",") if s)
        if not slots or any(":" not in s or ";" in s for s in slots):
            return None
        return cls(epoch=epoch, slots=slots)

    def owner(self, type_name: str, object_id: str) -> str:
        return self.slots[shard_of(type_name, object_id, len(self.slots))]


class AdminCommandKind(Enum):
    SERVER_EXIT = "server_exit"
    SHUTDOWN_OBJECT = "shutdown_object"
    DRAIN_SERVER = "drain_server"
    MIGRATE_OBJECT = "migrate_object"
    # Observability scrape: log (in-process queue) or return (over the wire
    # via the node-scoped rio.Admin actor, rio_tpu_torch/admin.py) this node's
    # gauge + RED-histogram snapshot.
    DUMP_STATS = "dump_stats"
    # Control-plane flight recorder: log (in-process) or return (wire, via
    # rio.Admin DumpEvents) this node's journal tail. Old servers answer the
    # wire form with the clean unknown-kind AdminAck.
    DUMP_EVENTS = "dump_events"
    # Gauge time-series ring: log (in-process) or return (wire, via
    # rio.Admin DumpSeries) this node's periodic gauge samples. Old servers
    # answer the wire form with the clean unknown-kind AdminAck.
    DUMP_SERIES = "dump_series"
    # Request-waterfall span ring: log (in-process) or return (wire, via
    # rio.Admin DumpSpans) this node's retained request spans. Old servers
    # answer the wire form with the clean unknown-kind AdminAck.
    DUMP_SPANS = "dump_spans"
    # Communication-affinity edge graph: log (in-process) or return (wire,
    # via rio.Admin DumpEdges) this node's sampled (src, dst) edge rates.
    # Old servers answer the wire form with the clean unknown-kind AdminAck.
    DUMP_EDGES = "dump_edges"


@dataclasses.dataclass
class AdminCommand:
    kind: AdminCommandKind
    type_name: str = ""
    object_id: str = ""
    target: str = ""  # MIGRATE_OBJECT: destination node address

    @classmethod
    def server_exit(cls) -> "AdminCommand":
        return cls(AdminCommandKind.SERVER_EXIT)

    @classmethod
    def drain(cls) -> "AdminCommand":
        """Graceful exit: cordon this node in the placement provider,
        re-solve so its population re-seats on the survivors, run the
        shutdown lifecycle for local instances, then exit — one admin
        message for the whole ops drain flow. Degrades to ``server_exit``
        semantics (plus lifecycle hooks) on providers without a solver
        surface. The reference's only exit is immediate
        (``server.rs:30-34``)."""
        return cls(AdminCommandKind.DRAIN_SERVER)

    @classmethod
    def shutdown(cls, type_name: str, object_id: str) -> "AdminCommand":
        return cls(AdminCommandKind.SHUTDOWN_OBJECT, type_name, object_id)

    @classmethod
    def dump_stats(cls) -> "AdminCommand":
        """Log this node's gauge + histogram snapshot (the in-process twin
        of the wire scrape served by ``rio.Admin``)."""
        return cls(AdminCommandKind.DUMP_STATS)

    @classmethod
    def dump_events(cls) -> "AdminCommand":
        """Log this node's control-plane journal tail (the in-process twin
        of the wire ``DumpEvents`` scrape served by ``rio.Admin``)."""
        return cls(AdminCommandKind.DUMP_EVENTS)

    @classmethod
    def dump_series(cls) -> "AdminCommand":
        """Log this node's gauge time-series window (the in-process twin
        of the wire ``DumpSeries`` scrape served by ``rio.Admin``)."""
        return cls(AdminCommandKind.DUMP_SERIES)

    @classmethod
    def dump_spans(cls) -> "AdminCommand":
        """Log this node's retained request spans (the in-process twin
        of the wire ``DumpSpans`` scrape served by ``rio.Admin``)."""
        return cls(AdminCommandKind.DUMP_SPANS)

    @classmethod
    def dump_edges(cls) -> "AdminCommand":
        """Log this node's sampled communication-affinity edges (the
        in-process twin of the wire ``DumpEdges`` scrape served by
        ``rio.Admin``)."""
        return cls(AdminCommandKind.DUMP_EDGES)

    @classmethod
    def migrate(cls, type_name: str, object_id: str, target: str) -> "AdminCommand":
        """Hand one locally-seated object to ``target`` through the full
        migration protocol (pin → deactivate → snapshot → flip → fence) —
        the ops/debug entry to the same path the rebalancer actuates."""
        return cls(AdminCommandKind.MIGRATE_OBJECT, type_name, object_id, target)


class AdminSender:
    """AppData-injectable handle for queueing :class:`AdminCommand`s."""

    def __init__(self) -> None:
        self.queue: asyncio.Queue[AdminCommand] = asyncio.Queue()

    def send(self, cmd: AdminCommand) -> None:
        self.queue.put_nowait(cmd)


@dataclasses.dataclass
class SendCommand:
    """One internal actor→actor request plus its response future."""

    handler_type: str
    handler_id: str
    message_type: str
    payload: bytes
    response: asyncio.Future
    # Captured at enqueue time: the consumer task replays the request from
    # its OWN context, so the sender's trace would otherwise die at the
    # queue boundary.
    trace_ctx: tuple | None = None
    # The affinity source identity ("{type}.{id}" of the sending actor),
    # snapshotted at enqueue for the same reason as trace_ctx. Rides the
    # replayed RequestEnvelope in-process only — never the wire.
    source: str = ""
    # QoS scope of the sending handler (tenant, priority, monotonic
    # deadline expiry; 0.0 = none), snapshotted at enqueue like trace_ctx:
    # the consumer decrements the remaining budget into the replayed
    # envelope, or answers DEADLINE_EXCEEDED without dispatching when the
    # budget is already spent (rio_tpu_torch/qos scope propagation).
    qos_scope: tuple = ("", 0, 0.0)


class InternalClientSender:
    """AppData-injectable handle for the server's internal request queue.

    Reference ``server.rs:48-73``: requests enqueued here are replayed
    through the full Service dispatch path by the server's consumer task —
    never inline — so a handler awaiting a send can't deadlock on its own
    object lock chain (see the reference's ``test_proxy_deadlock``).
    """

    def __init__(self) -> None:
        self.queue: asyncio.Queue[SendCommand] = asyncio.Queue()

    async def send(
        self, handler_type: str, handler_id: str, message_type: str, payload: bytes
    ) -> bytes:
        """Enqueue a request and await the (serialized) response."""
        from .affinity import current_source
        from .qos import current_scope
        from .tracing import outbound_ctx

        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self.queue.put_nowait(
            SendCommand(
                handler_type, handler_id, message_type, payload, fut,
                trace_ctx=outbound_ctx(),
                source=current_source(),
                qos_scope=current_scope(),
            )
        )
        return await fut


@dataclasses.dataclass
class ServerInfo:
    """The hosting server's identity, injected into AppData."""

    address: str


@dataclasses.dataclass
class ServerDraining:
    """Shared drain flag, injected into AppData by the Server.

    While ``active``, the service layer refuses NEW activations (already-
    seated objects keep being served) so the drain's lifecycle pass cannot
    race fresh self-assignments — see ``Server._drain_and_exit``.
    """

    active: bool = False


@dataclasses.dataclass
class DispatchObserver:
    """AppData-injectable hook called after every successfully served request.

    ``fn(object_key, serving_address)`` — the seam through which the server
    feeds live traffic into an :class:`~rio_tpu_torch.object_placement.
    torch_placement.AffinityTracker` (state-locality features for the
    hierarchical placement solver) without the application touching the
    dispatch path.  Kept here (not in ``torch_placement``) so the request
    engine never imports torch.
    """

    fn: Any  # Callable[[str, str], None]; Any avoids typing import cost
