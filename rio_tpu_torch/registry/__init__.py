"""In-process actor table + dynamic dispatch.

Reference: ``rio-rs/src/registry/mod.rs`` — the registry maps
``(type_name, object_id) -> live object`` and
``(type_name, message_type) -> handler callback`` (``:82-203``). The Rust
implementation needs dashmap/papaya lock-free maps and per-object ``RwLock``;
here plain dicts (atomic under the GIL) plus a per-object ``asyncio.Lock``
give the same serialized ``&mut self`` execution without ever holding a
map-wide lock across an ``await`` (the deadlock the reference stress-tests in
``registry/mod.rs:561-625``).
"""

from __future__ import annotations

import asyncio
import dataclasses
import inspect
from typing import Any, Callable

from .. import codec
from ..errors import (
    HandlerNotFound,
    ObjectNotFound,
    TypeNotFound,
)
from .handler import (
    ERROR_TYPES,
    MESSAGE_TYPES,
    READONLY_MESSAGES,
    HandlerSpec,
    decode_error,
    encode_error,
    handler,
    is_readonly_message,
    message,
    readonly,
    register_readonly,
    resolve_handlers,
    wire_error,
)
from .identifiable import type_id, type_name

__all__ = [
    "Registry",
    "ObjectId",
    "handler",
    "readonly",
    "message",
    "wire_error",
    "type_id",
    "type_name",
    "MESSAGE_TYPES",
    "ERROR_TYPES",
    "READONLY_MESSAGES",
    "register_readonly",
    "is_readonly_message",
    "encode_error",
    "decode_error",
]


@dataclasses.dataclass(frozen=True)
class ObjectId:
    """Cluster-wide actor address ``(type_name, object_id)``.

    Reference: ``rio-rs/src/service_object.rs:20``.
    """

    type_name: str
    id: str

    def __str__(self) -> str:  # storage key form used by placement backends
        return f"{self.type_name}.{self.id}"


class ApplicationRaised(Exception):
    """Internal carrier: a registered (typed) user error crossed dispatch."""

    def __init__(self, payload: bytes, type_name: str, original: BaseException):
        super().__init__(type_name)
        self.payload = payload
        self.type_name = type_name
        self.original = original


@dataclasses.dataclass
class _Entry:
    obj: Any
    lock: asyncio.Lock


class Registry:
    """Holds live service objects and dispatches serialized messages to them."""

    def __init__(self) -> None:
        self._constructors: dict[str, Callable[[], Any]] = {}
        self._handlers: dict[tuple[str, str], HandlerSpec] = {}
        self._objects: dict[tuple[str, str], _Entry] = {}
        self._node_scoped: set[str] = set()
        self._replicated: set[str] = set()
        self._readonly: set[tuple[str, str]] = set()

    # -- type / handler registration (reference registry/mod.rs:82-182) ----

    def add_type(
        self,
        cls: type,
        constructor: Callable[[], Any] | None = None,
        *,
        auto_handlers: bool = True,
    ) -> "Registry":
        """Register a service class: constructor + all its ``@handler`` methods.

        ``auto_handlers=False`` registers the constructor only — used by the
        declarative layer (``make_registry``) to expose exactly the declared
        message surface and nothing else.
        """
        tname = type_id(cls)
        self._constructors[tname] = constructor or cls
        if getattr(cls, "__node_scoped__", False):
            # Node-scoped actors (one per server; the object id IS a node
            # address) are routed without the placement directory — the
            # service layer serves ``id == self.address`` locally and
            # redirects everything else. Framework control planes (e.g.
            # migration) use this so the solver never re-seats them.
            self._node_scoped.add(tname)
        if getattr(cls, "__replicated__", False):
            # Replicated actors (``__replicated__ = True``) opt into hot
            # standbys: the service layer ships their volatile state to the
            # standby set after every acknowledged request
            # (rio_tpu_torch/replication).
            self._replicated.add(tname)
        for spec in resolve_handlers(cls):
            # Lifecycle dispatch (activation Load), reminder wakeups, and
            # stream/saga step delivery are framework plumbing and must
            # exist regardless of the declared message surface.
            if auto_handlers or spec.message_type_name in (
                "rio.LifecycleMessage",
                "rio.ReminderFired",
                "rio.StreamDelivery",
                "rio.SagaStep",
            ):
                self._handlers[(tname, spec.message_type_name)] = spec
                if spec.readonly:
                    self._readonly.add((tname, spec.message_type_name))
                    READONLY_MESSAGES.add((tname, spec.message_type_name))
        return self

    def add_handler(self, cls: type, msg_cls: type, fn: Callable, returns: Any = Any) -> "Registry":
        """Explicitly register ``fn`` as ``cls``'s handler for ``msg_cls``.

        Escape hatch matching the reference's manual ``add_handler``; most
        code should rely on ``@handler`` methods picked up by `add_type`.
        """
        import inspect

        if not inspect.iscoroutinefunction(fn):
            raise TypeError("handler must be async")
        self._handlers[(type_id(cls), type_id(msg_cls))] = HandlerSpec(
            message_type=msg_cls,
            message_type_name=type_id(msg_cls),
            returns=returns,
            fn=fn,
        )
        return self

    def has_type(self, type_name: str) -> bool:
        return type_name in self._constructors

    def is_node_scoped(self, type_name: str) -> bool:
        return type_name in self._node_scoped

    def is_replicated(self, type_name: str) -> bool:
        return type_name in self._replicated

    def is_readonly(self, type_name: str, message_type: str) -> bool:
        return (type_name, message_type) in self._readonly

    def has_handler(self, type_name: str, message_type: str) -> bool:
        return (type_name, message_type) in self._handlers

    def handler_spec(self, type_name: str, message_type: str) -> HandlerSpec | None:
        return self._handlers.get((type_name, message_type))

    def registered_types(self) -> list[str]:
        return list(self._constructors)

    # -- object lifecycle (reference registry/mod.rs:205-239) ---------------

    def new_from_type(self, type_name: str, object_id: str) -> Any:
        ctor = self._constructors.get(type_name)
        if ctor is None:
            raise TypeNotFound(type_name)
        obj = ctor()
        obj.id = object_id
        return obj

    def has(self, type_name: str, object_id: str) -> bool:
        return (type_name, object_id) in self._objects

    def insert(self, type_name: str, object_id: str, obj: Any) -> None:
        self._objects[(type_name, object_id)] = _Entry(obj, asyncio.Lock())

    def get(self, type_name: str, object_id: str) -> Any | None:
        entry = self._objects.get((type_name, object_id))
        return entry.obj if entry else None

    def remove(self, type_name: str, object_id: str) -> Any | None:
        entry = self._objects.pop((type_name, object_id), None)
        return entry.obj if entry else None

    async def deactivate(
        self,
        type_name: str,
        object_id: str,
        app_data: Any,
        *,
        before_remove: Callable[[Any], Any] | None = None,
    ) -> bool:
        """Gracefully deactivate one live object under its dispatch lock.

        Runs the SHUTDOWN lifecycle handler *directly* (dispatching a
        LifecycleMessage through :meth:`send` would deadlock on the lock we
        must hold), then the optional ``before_remove(obj)`` awaitable —
        the migration snapshot seam — and finally drops the entry. Because
        the lock is held end-to-end and :meth:`send_raw` rechecks entry
        identity after acquiring it, no handler can observe the object
        between snapshot and removal. Returns False when the object is not
        live (or another deactivation won the race); lifecycle/snapshot
        exceptions propagate with the object still seated — callers treat
        that as an aborted deactivation.
        """
        from ..service_object import LifecycleKind, LifecycleMessage

        key = (type_name, object_id)
        entry = self._objects.get(key)
        if entry is None:
            return False
        async with entry.lock:
            if self._objects.get(key) is not entry:
                return False
            spec = self._handlers.get((type_name, "rio.LifecycleMessage"))
            if spec is not None:
                await spec.fn(
                    entry.obj, LifecycleMessage(kind=LifecycleKind.SHUTDOWN), app_data
                )
            if before_remove is not None:
                await before_remove(entry.obj)
            if self._objects.get(key) is entry:
                del self._objects[key]
        return True

    async def peek(
        self,
        type_name: str,
        object_id: str,
        fn: Callable[[Any], Any],
    ) -> Any:
        """Run ``fn(obj)`` under the object's dispatch lock, without removing it.

        The read-side twin of :meth:`deactivate`: the migration prefetch uses
        it to snapshot volatile state *before* the pin (no handler can run
        concurrently, so the snapshot is consistent), leaving the object live
        and serving. ``fn`` may return an awaitable. Raises
        :class:`ObjectNotFound` when the object is not (or no longer) seated.
        """
        key = (type_name, object_id)
        entry = self._objects.get(key)
        if entry is None:
            raise ObjectNotFound(f"{type_name}/{object_id}")
        async with entry.lock:
            if self._objects.get(key) is not entry:
                raise ObjectNotFound(f"{type_name}/{object_id}")
            result = fn(entry.obj)
            if inspect.isawaitable(result):
                result = await result
        return result

    def count_objects(self) -> int:
        return len(self._objects)

    def object_ids(self) -> list[ObjectId]:
        return [ObjectId(t, i) for (t, i) in self._objects]

    # -- dispatch (reference registry/mod.rs:123-203) -----------------------

    async def send_raw(
        self,
        type_name: str,
        object_id: str,
        message_type: str,
        payload: bytes,
        app_data: Any,
    ) -> bytes:
        """Deserialize → lock object → run handler → serialize result.

        Raises :class:`ObjectNotFound` / :class:`HandlerNotFound` for routing
        errors, :class:`ApplicationRaised` for registered user error types,
        and propagates anything else raw (the Service layer treats that as a
        panic: deallocate + ``Unknown``).
        """
        spec = self._handlers.get((type_name, message_type))
        if spec is None:
            raise HandlerNotFound(f"{type_name}/{message_type}")
        entry = self._objects.get((type_name, object_id))
        if entry is None:
            raise ObjectNotFound(f"{type_name}/{object_id}")
        msg = codec.deserialize(payload, spec.message_type)
        # Serialized &mut self execution: one handler at a time per object.
        async with entry.lock:
            if self._objects.get((type_name, object_id)) is not entry:
                # The object was deactivated (migration handoff, shutdown)
                # while this request waited on the lock: running the handler
                # would mutate a removed instance and silently lose the
                # update. Surface a routing error instead — the client's
                # Allocate retry re-resolves against the directory.
                raise ObjectNotFound(f"{type_name}/{object_id}")
            try:
                result = await spec.fn(entry.obj, msg, app_data)
            except Exception as e:  # noqa: BLE001 - triaged below
                if type_id(type(e)) in ERROR_TYPES:
                    pl, tn = encode_error(e)
                    raise ApplicationRaised(pl, tn, e) from e
                raise
        return codec.serialize(result)

    async def send(
        self,
        type_name: str,
        object_id: str,
        msg: Any,
        app_data: Any,
        returns: Any = None,
    ) -> Any:
        """Typed convenience over :meth:`send_raw` (tests, internal callers)."""
        mtype = type_id(type(msg))
        raw = await self.send_raw(type_name, object_id, mtype, codec.serialize(msg), app_data)
        spec = self._handlers.get((type_name, mtype))
        ty = returns if returns is not None else (spec.returns if spec else Any)
        return codec.deserialize(raw, ty)
