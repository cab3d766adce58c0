"""Exponential backoff policy for the client retry middleware.

Reference: ``rio-rs/src/client/tower_services.rs:142-146`` — 1 µs doubling
to a 2 s cap, at most 20 retries.
"""

from __future__ import annotations

import asyncio
import dataclasses
import random


@dataclasses.dataclass
class ExponentialBackoff:
    initial: float = 1e-6
    cap: float = 2.0
    factor: float = 2.0
    max_retries: int = 20

    def delays(self):
        """Yield ``max_retries`` sleep durations."""
        d = self.initial
        for _ in range(self.max_retries):
            yield min(d, self.cap)
            d *= self.factor

    async def sleep(self, attempt: int) -> None:
        await asyncio.sleep(min(self.initial * (self.factor**attempt), self.cap))


class DecorrelatedJitter:
    """Decorrelated-jitter delays (the AWS architecture-blog variant).

    ``next() = min(cap, uniform(base, prev * 3))`` — successive delays are
    randomized against the PREVIOUS draw, so a thundering herd that shed at
    the same instant decorrelates after one round instead of re-colliding
    on every doubling the way pure exponential backoff does. One instance
    per request (the draw sequence is the per-request state).
    """

    def __init__(self, base: float = 1e-3, cap: float = 2.0) -> None:
        self.base = max(1e-9, base)
        self.cap = cap
        self._prev = self.base

    def next(self) -> float:
        self._prev = min(self.cap, random.uniform(self.base, self._prev * 3))
        return self._prev
