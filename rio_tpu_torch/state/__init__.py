"""Per-object state persistence — the framework's checkpoint/resume system.

Reference: ``rio-rs/src/state/mod.rs`` — ``StateLoader``/``StateSaver``
traits (``:53-113``) and ``ObjectStateManager`` keyed
``(object_kind, object_id, state_type)`` (``:143-181``). Loads happen
automatically at activation (``LifecycleMessage::Load``); saves are manual,
handler-driven. Missing state is tolerated (fresh objects); other load
errors abort activation.
"""

from __future__ import annotations

import abc
from typing import Any, TypeVar

from .. import codec
from ..errors import LoadStateError, StateNotFound
from ..registry import type_id

T = TypeVar("T")

__all__ = [
    "StateLoader",
    "StateSaver",
    "StateProvider",
    "LocalState",
    "load_state",
    "save_state",
    "managed_state",
    "ManagedField",
]


class StateLoader(abc.ABC):
    @abc.abstractmethod
    async def load(self, object_kind: str, object_id: str, state_type: str, ty: Any) -> Any:
        """Fetch one state value; raises :class:`StateNotFound` if absent."""

    async def prepare(self) -> None:
        return None


class StateSaver(abc.ABC):
    @abc.abstractmethod
    async def save(self, object_kind: str, object_id: str, state_type: str, value: Any) -> None: ...

    async def delete(self, object_kind: str, object_id: str, state_type: str) -> None:
        """Optional: remove persisted state (used by tests/cleanup)."""
        raise NotImplementedError


class StateProvider(StateLoader, StateSaver, abc.ABC):
    """Both halves; what applications register in AppData."""


class LocalState(StateProvider):
    """In-memory provider (reference ``state/local.rs:12-63``): a dict of
    JSON strings whose clones alias the same data."""

    def __init__(self) -> None:
        self._data: dict[tuple[str, str, str], str] = {}

    async def load(self, object_kind: str, object_id: str, state_type: str, ty: Any) -> Any:
        raw = self._data.get((object_kind, object_id, state_type))
        if raw is None:
            raise StateNotFound(f"{object_kind}/{object_id}/{state_type}")
        return codec.deserialize_json(raw, ty)

    async def save(self, object_kind: str, object_id: str, state_type: str, value: Any) -> None:
        self._data[(object_kind, object_id, state_type)] = codec.serialize_json(value)

    async def delete(self, object_kind: str, object_id: str, state_type: str) -> None:
        self._data.pop((object_kind, object_id, state_type), None)

    def count(self) -> int:
        return len(self._data)


# ---------------------------------------------------------------------------
# Managed state: the `#[derive(ManagedState)]` equivalent
# (reference rio-macros/src/managed_state.rs:20-157) — a class-level
# descriptor declares a persisted field; ServiceObject.load_state pulls every
# declared field from the provider at activation.
# ---------------------------------------------------------------------------


class ManagedField:
    """Descriptor for one persisted state field on a ServiceObject."""

    def __init__(self, state_type: type, provider: type | None = None) -> None:
        self.state_type = state_type
        self.provider = provider  # AppData key; None → the StateProvider default
        self.name = ""

    def __set_name__(self, owner: type, name: str) -> None:
        self.name = name

    def __get__(self, obj: Any, objtype: type | None = None) -> Any:
        if obj is None:
            return self
        if self.name not in obj.__dict__:
            obj.__dict__[self.name] = self.state_type()
        return obj.__dict__[self.name]

    def __set__(self, obj: Any, value: Any) -> None:
        obj.__dict__[self.name] = value


def managed_state(state_type: type, provider: type | None = None) -> ManagedField:
    """Declare a persisted field::

        class Aggregator(ServiceObject):
            stats = managed_state(Stats)            # default provider
            audit = managed_state(Audit, SqliteState)  # explicit provider type
    """
    return ManagedField(state_type, provider)


def managed_fields(cls: type) -> list[ManagedField]:
    out = []
    for klass in cls.__mro__:
        for v in vars(klass).values():
            if isinstance(v, ManagedField):
                out.append(v)
    return out


def _resolve_loader(ctx: Any, field: ManagedField) -> StateLoader:
    key = field.provider or StateProvider
    provider = ctx.try_get(key)
    if provider is None:
        raise LoadStateError(
            f"no state provider of type {key.__name__} in AppData "
            f"(register one with app_data.set(provider, as_type={key.__name__}))"
        )
    return provider


async def load_state(obj: Any, ctx: Any) -> None:
    """Load every managed field of ``obj`` (activation path).

    Missing state (fresh object) is tolerated; anything else propagates and
    aborts activation (reference managed_state.rs:40-67 semantics).
    """
    kind = type_id(type(obj))
    for field in managed_fields(type(obj)):
        loader = _resolve_loader(ctx, field)
        try:
            value = await loader.load(kind, obj.id, type_id(field.state_type), field.state_type)
        except StateNotFound:
            continue
        setattr(obj, field.name, value)


async def save_state(obj: Any, ctx: Any, field_name: str | None = None) -> None:
    """Persist managed fields of ``obj`` (all, or just ``field_name``).

    The handler-driven save path (reference ``ObjectStateManager::save_state``,
    e.g. metric-aggregator ``services.rs:85-87``).
    """
    kind = type_id(type(obj))
    saved = 0
    for field in managed_fields(type(obj)):
        if field_name is not None and field.name != field_name:
            continue
        saver = _resolve_loader(ctx, field)
        if not isinstance(saver, StateSaver):
            raise LoadStateError(f"provider for {field.name} cannot save")
        await saver.save(kind, obj.id, type_id(field.state_type), getattr(obj, field.name))
        saved += 1
    if field_name is not None and saved == 0:
        raise LoadStateError(
            f"{type(obj).__name__} has no managed field named {field_name!r}"
        )
