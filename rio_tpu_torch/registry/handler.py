"""Message + handler declaration surface.

The reference expresses handlers as ``impl Handler<M> for Svc`` with
associated ``Returns``/``Error`` types (``rio-rs/src/registry/handler.rs:12-24``)
and messages as serde-derived structs. The Python-native equivalent:

* ``@message`` — declares a dataclass message type and registers its wire
  name (replaces ``#[derive(Message, TypeName)]``).
* ``@handler`` — marks an async method ``async def f(self, msg: M, ctx)``
  as the handler for message type ``M`` (the type is read from the
  annotation); return annotation gives the response type.
* ``@wire_error`` — registers an exception class for typed error tunneling
  (reference ``protocol.rs:174-229``): the server serializes the exception's
  ``args``, the client re-raises the same class.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, TypeVar, get_type_hints

from ..errors import SerializationError
from .identifiable import type_id

T = TypeVar("T")

# Global wire-name registries. Keyed by wire type-name; used by clients to
# decode subscription streams and by the error tunnel to re-raise typed
# errors.
MESSAGE_TYPES: dict[str, type] = {}
ERROR_TYPES: dict[str, type] = {}

# ``(service type-name, message type-name)`` pairs whose handler is marked
# ``@readonly`` — safe to serve from a bounded-staleness standby replica.
# Global (like MESSAGE_TYPES) so clients can route reads without holding a
# Registry; populated by ``Registry.add_type`` / ``register_readonly``.
READONLY_MESSAGES: set[tuple[str, str]] = set()

HANDLER_ATTR = "__rio_handler__"
READONLY_ATTR = "__rio_readonly__"


def message(cls: T | None = None, *, name: str | None = None):
    """Declare (and register) a message dataclass.

    Usage::

        @message
        class Ping:
            payload: str = ""
    """

    def apply(c):
        if not dataclasses.is_dataclass(c):
            c = dataclasses.dataclass(c)
        if name is not None:
            c.__type_name__ = name
        MESSAGE_TYPES[type_id(c)] = c
        return c

    return apply if cls is None else apply(cls)


def wire_error(cls: T | None = None, *, name: str | None = None):
    """Register an exception class for cross-wire typed re-raising.

    The exception's ``args`` tuple must be codec-serializable.
    """

    def apply(c):
        if name is not None:
            c.__type_name__ = name
        ERROR_TYPES[type_id(c)] = c
        return c

    return apply if cls is None else apply(cls)


@dataclasses.dataclass
class HandlerSpec:
    """Resolved metadata for one ``(service, message)`` handler."""

    message_type: type
    message_type_name: str
    returns: Any
    fn: Callable  # unbound async method (self, msg, ctx) -> returns
    readonly: bool = False


def handler(fn: Callable) -> Callable:
    """Mark ``async def f(self, msg: M, ctx) -> R`` as the handler for ``M``."""
    if not inspect.iscoroutinefunction(fn):
        raise TypeError(f"handler {fn.__qualname__} must be 'async def'")
    setattr(fn, HANDLER_ATTR, True)
    return fn


def readonly(fn: Callable) -> Callable:
    """Mark a ``@handler`` method as safe to serve from a standby replica.

    A readonly handler must not mutate actor state: the read-scale layer may
    dispatch it against a shadow instance restored from the replica log
    (rio_tpu_torch/readscale), where writes would be silently lost. Composes with
    ``@handler`` in either order.
    """
    setattr(fn, READONLY_ATTR, True)
    return fn


def resolve_handlers(cls: type) -> list[HandlerSpec]:
    """Collect :class:`HandlerSpec`s from a service class's ``@handler`` methods."""
    specs: list[HandlerSpec] = []
    for attr_name in dir(cls):
        fn = getattr(cls, attr_name, None)
        if fn is None or not getattr(fn, HANDLER_ATTR, False):
            continue
        hints = get_type_hints(fn)
        params = [p for p in inspect.signature(fn).parameters if p != "self"]
        if not params:
            raise TypeError(f"handler {fn.__qualname__} needs a message parameter")
        msg_ty = hints.get(params[0])
        if msg_ty is None or not isinstance(msg_ty, type):
            raise TypeError(
                f"handler {fn.__qualname__}: first parameter must be annotated "
                "with a concrete message class"
            )
        specs.append(
            HandlerSpec(
                message_type=msg_ty,
                message_type_name=type_id(msg_ty),
                returns=hints.get("return", Any),
                fn=fn,
                readonly=getattr(fn, READONLY_ATTR, False),
            )
        )
    return specs


def register_readonly(cls: type) -> None:
    """Publish ``cls``'s ``@readonly`` handler pairs into READONLY_MESSAGES.

    Client processes that never build a server Registry call this (or rely
    on sharing the process with one) so read-marked requests route to
    standby seats.
    """
    tname = type_id(cls)
    for spec in resolve_handlers(cls):
        if spec.readonly:
            READONLY_MESSAGES.add((tname, spec.message_type_name))


def is_readonly_message(handler_type: str, message_type: str) -> bool:
    return (handler_type, message_type) in READONLY_MESSAGES


# ---------------------------------------------------------------------------
# Typed error tunneling
# ---------------------------------------------------------------------------


def encode_error(exc: BaseException) -> tuple[bytes, str]:
    """Serialize a user exception → (payload, wire type-name)."""
    from .. import codec

    name = type_id(type(exc))
    try:
        payload = codec.serialize(list(exc.args))
    except SerializationError:
        payload = codec.serialize([str(exc)])
    return payload, name


def decode_error(payload: bytes, type_name: str) -> BaseException:
    """Reconstruct a typed exception if its class is registered."""
    from .. import codec
    from ..errors import ApplicationError

    cls = ERROR_TYPES.get(type_name)
    if cls is None:
        return ApplicationError(payload, type_name)
    try:
        args = codec.deserialize(payload, Any)
        return cls(*args)
    except Exception:
        return ApplicationError(payload, type_name)
