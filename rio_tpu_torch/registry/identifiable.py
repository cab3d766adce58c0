"""Stable string type identities for routing.

Reference: ``rio-rs/src/registry/identifiable_type.rs:13-25`` — every
routable type has a ``user_defined_type_id`` defaulting to the type's name,
overridable for wire-stability across refactors. Here the override is the
``__type_name__`` class attribute (set directly or via the ``@type_name``
decorator).
"""

from __future__ import annotations

from typing import TypeVar

T = TypeVar("T", bound=type)


def type_id(cls: type) -> str:
    """Return the wire type-name for a class."""
    return getattr(cls, "__type_name__", cls.__name__)


def type_name(name: str):
    """Class decorator overriding the wire type-name (``#[type_name = ...]``)."""

    def apply(cls: T) -> T:
        cls.__type_name__ = name
        return cls

    return apply
