"""rio-tpu's actor runtime and placement solver in PyTorch, with hand-written CUDA kernels.

A port of :mod:`rio_tpu` (JAX) to PyTorch on an NVIDIA Hopper GPU. Modules
mirror the JAX package's layout so that each function has an obvious
counterpart:

* the actor runtime (``Server``, ``Client``, membership, the
  ``PlacementDaemon`` and the node services a ``Server`` wires in): copies
  of ``rio_tpu``'s modules, word for word but for the package name
  (:mod:`rio_tpu_torch.codec` runs on ``msgpack``, as the reference's does);
* :mod:`rio_tpu_torch.object_placement` — the trait, ``LocalObjectPlacement``
  and the device directory ``TorchObjectPlacement``;
* :mod:`rio_tpu_torch.ops` — ``rio_tpu/ops`` (Sinkhorn, scaling form,
  rounding, quota repair, cost construction);
* :mod:`rio_tpu_torch.kernels` — the CUDA sources and their build;
* :mod:`rio_tpu_torch.entry` — the placement step that
  ``__graft_entry__.entry`` and ``bench.py``'s solve tier run;
* :mod:`rio_tpu_torch.convert` — JAX-side numpy arrays to the port's tensors.

The package imports neither ``jax`` nor any module of ``rio_tpu``. Entry points run on CUDA unless the caller passes
``device="cpu"`` (:func:`rio_tpu_torch.device.resolve_device`).

This module re-exports the runtime's prelude, the names of
``rio_tpu/__init__.py``, and :func:`resolve_device`. Importing it, or any
module of the runtime, leaves torch unloaded, as importing ``rio_tpu``
leaves jax: ``resolve_device``, ``ShardedServer`` and the fault surface
load on first use.
"""

from .app_data import AppData
from .client import Client, ClientBuilder
from .client.pool import ClientPool
from .cluster.membership_protocol import ClusterProvider, LocalClusterProvider
from .cluster.storage import LocalStorage, Member, MembershipStorage
from .commands import (
    AdminCommand,
    AdminSender,
    InternalClientSender,
    ServerInfo,
    ShardMap,
    ShardRouter,
    shard_of,
)
from .errors import RioError, ServerBusy
from .journal import Journal, JournalEvent
from .load import (
    ClusterLoadView,
    LoadMonitor,
    LoadThresholds,
    LoadVector,
)
from .message_router import MessageRouter
from .migration import MigrationManager, MigrationStats
from .object_placement import LocalObjectPlacement, ObjectPlacement, ObjectPlacementItem
from .readscale import ReadScaleConfig, ReadScaleManager
from .registry import (
    ObjectId,
    Registry,
    handler,
    message,
    readonly,
    type_id,
    type_name,
    wire_error,
)
from .registry.declarative import RegistryDeclaration, make_registry
from .reminders import LocalReminderStorage, Reminder, ReminderStorage
from .reminders.daemon import ReminderDaemonConfig
from .server import Server
from .service_object import (
    LifecycleKind,
    LifecycleMessage,
    ReminderFired,
    ServiceObject,
)

__version__ = "0.7.2"  # the reference package's version


# Fault-injection surface, re-exported lazily.
_FAULTS_EXPORTS = frozenset(
    {
        "FaultRule",
        "FaultSchedule",
        "FaultyMembershipStorage",
        "FaultyObjectPlacement",
        "FaultyReminderStorage",
        "InjectedFault",
        "LinkRule",
        "OutageWindow",
        "StorageHealth",
        "StorageResilienceConfig",
        "TransportFaults",
    }
)


def __getattr__(name: str):
    # Lazy: ``python -m rio_tpu_torch.sharded`` and ``python -m rio_tpu_torch.faults
    # --demo`` execute their module as __main__; an eager import here would load
    # it twice (runpy's double-exec warning).
    if name == "ShardedServer":
        from .sharded import ShardedServer

        return ShardedServer
    if name == "resolve_device":
        # Lazy: it imports torch, which no node of the runtime needs.
        from .device import resolve_device

        return resolve_device
    if name in _FAULTS_EXPORTS:
        from . import faults

        return getattr(faults, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "resolve_device",
    "AppData",
    "AdminCommand",
    "AdminSender",
    "Client",
    "ClientPool",
    "ClientBuilder",
    "ClusterLoadView",
    "ClusterProvider",
    "FaultRule",
    "FaultSchedule",
    "FaultyMembershipStorage",
    "FaultyObjectPlacement",
    "FaultyReminderStorage",
    "InjectedFault",
    "InternalClientSender",
    "LinkRule",
    "OutageWindow",
    "StorageHealth",
    "StorageResilienceConfig",
    "TransportFaults",
    "Journal",
    "JournalEvent",
    "LifecycleKind",
    "LifecycleMessage",
    "LocalClusterProvider",
    "LoadMonitor",
    "LoadThresholds",
    "LoadVector",
    "LocalObjectPlacement",
    "LocalStorage",
    "Member",
    "MembershipStorage",
    "MessageRouter",
    "MigrationManager",
    "MigrationStats",
    "ObjectId",
    "ObjectPlacement",
    "ObjectPlacementItem",
    "ReadScaleConfig",
    "ReadScaleManager",
    "Registry",
    "RegistryDeclaration",
    "Reminder",
    "ReminderDaemonConfig",
    "ReminderFired",
    "ReminderStorage",
    "LocalReminderStorage",
    "RioError",
    "Server",
    "ServerBusy",
    "ServerInfo",
    "ServiceObject",
    "ShardedServer",
    "ShardMap",
    "ShardRouter",
    "shard_of",
    "handler",
    "make_registry",
    "message",
    "readonly",
    "type_id",
    "type_name",
    "wire_error",
]
