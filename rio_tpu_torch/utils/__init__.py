"""Small shared utilities (LRU cache, backoff policy, async helpers)."""

from .lru import LruCache
from .backoff import DecorrelatedJitter, ExponentialBackoff

__all__ = ["LruCache", "ExponentialBackoff", "DecorrelatedJitter"]
