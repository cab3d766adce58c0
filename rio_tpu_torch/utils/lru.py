"""Bounded LRU map (the client's placement cache, reference
``client/mod.rs:137-147`` — 1,000 entries by default)."""

from __future__ import annotations

from collections import OrderedDict
from typing import Generic, Hashable, TypeVar

K = TypeVar("K", bound=Hashable)
V = TypeVar("V")


class LruCache(Generic[K, V]):
    def __init__(self, capacity: int = 1000) -> None:
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._map: OrderedDict[K, V] = OrderedDict()

    def get(self, key: K) -> V | None:
        try:
            self._map.move_to_end(key)
            return self._map[key]
        except KeyError:
            return None

    def put(self, key: K, value: V) -> None:
        self._map[key] = value
        self._map.move_to_end(key)
        while len(self._map) > self.capacity:
            self._map.popitem(last=False)

    def pop(self, key: K) -> V | None:
        return self._map.pop(key, None)

    def clear(self) -> None:
        self._map.clear()

    def __len__(self) -> int:
        return len(self._map)

    def __contains__(self, key: K) -> bool:
        return key in self._map
