"""Type-keyed shared state container.

Reference: ``rio-rs/src/app_data.rs:27-48`` — a ``Send+Sync`` type map used
to inject state providers, the internal-client/admin channels, the
``MessageRouter``, and app singletons into handlers.
"""

from __future__ import annotations

from typing import Any, Callable, TypeVar

T = TypeVar("T")


class AppData:
    """One value per type; handlers receive this as their context argument."""

    def __init__(self) -> None:
        self._values: dict[type, Any] = {}

    def set(self, value: Any, *, as_type: type | None = None) -> "AppData":
        self._values[as_type or type(value)] = value
        return self

    def get(self, ty: type[T]) -> T:
        try:
            return self._values[ty]
        except KeyError:
            raise KeyError(f"AppData has no value of type {ty.__name__}") from None

    def try_get(self, ty: type[T]) -> T | None:
        return self._values.get(ty)

    def get_or_default(self, ty: type[T], factory: Callable[[], T] | None = None) -> T:
        """Reference ``app_data.rs:37-48``: fetch or insert a default."""
        if ty not in self._values:
            self._values[ty] = (factory or ty)()
        return self._values[ty]

    def __contains__(self, ty: type) -> bool:
        return ty in self._values
