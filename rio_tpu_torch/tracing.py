"""Tracing spans of the port: a copy of ``rio_tpu/tracing.py``.

The port imports no module of ``rio_tpu``, so it keeps its own span API:
name, duration and key/values, pluggable sinks (a logging sink provided).
Spans opened here (``placement_solve`` in
:mod:`rio_tpu_torch.object_placement.torch_placement`) reach the sinks
registered with :func:`add_sink` of THIS module, not ``rio_tpu.tracing``'s.
"""

from __future__ import annotations

import contextvars
import logging
import os
import random
import time
from dataclasses import dataclass, field
from typing import Any, Callable

log = logging.getLogger("rio_tpu_torch.trace")

_SINKS: list[Callable[["Span"], None]] = []
_ENABLED = False

# Active (trace_id, span_id), propagated through awaits by contextvars —
# the stand-in for the reference's nested `tracing` span contexts
# (service.rs:192-369): a request's placement→activate→dispatch spans all
# share one trace and point at their parent.
_CTX: contextvars.ContextVar[tuple[str, str] | None] = contextvars.ContextVar(
    "rio_tpu_torch_trace", default=None
)
_rand = random.Random()

# Head-based probabilistic sampling for client-rooted traces: the client
# flips this coin ONCE per request with no active context; everything
# downstream (server adoption, forwarded hops) honors the decision carried
# on the wire instead of re-sampling.
_SAMPLE_RATE = 0.0


def _reseed() -> None:
    # An import-time-seeded Random is fork-hazardous: two workers forked
    # after import share the generator state and emit colliding trace/span
    # ids. Seed from the OS entropy pool, and re-seed in every forked child.
    _rand.seed(os.urandom(16))


_reseed()
if hasattr(os, "register_at_fork"):  # absent on non-POSIX
    os.register_at_fork(after_in_child=_reseed)


def current_trace_id() -> str | None:
    """The active trace id (e.g. to stamp application log lines)."""
    ctx = _CTX.get()
    return ctx[0] if ctx else None


def set_sample_rate(rate: float) -> None:
    """Probability that a client request with no active trace roots one."""
    global _SAMPLE_RATE
    _SAMPLE_RATE = min(1.0, max(0.0, rate))


def sample_rate() -> float:
    return _SAMPLE_RATE


def head_sampled() -> bool:
    """One head-based sampling decision (rate 0 short-circuits the coin)."""
    return _SAMPLE_RATE > 0.0 and _rand.random() < _SAMPLE_RATE


def new_trace_id() -> str:
    return f"{_rand.getrandbits(128):032x}"


def new_span_id() -> str:
    return f"{_rand.getrandbits(64):016x}"


def outbound_ctx() -> tuple[str, str, bool] | None:
    """The wire ``trace_ctx`` an outbound request should carry.

    The active span's ids when a trace is live (so the receiving node's
    spans join it), else ``None`` — the caller decides separately whether
    to root a fresh sampled trace (:func:`head_sampled`).
    """
    ctx = _CTX.get()
    if ctx is None:
        return None
    return (ctx[0], ctx[1], True)


def adopt(ctx: tuple[str, str, bool] | None):
    """Adopt an inbound wire ``trace_ctx`` for the current task.

    Returns a token for :func:`release` (``None`` when there is nothing to
    adopt — absent context or sampled=False). While adopted, spans opened
    here join the caller's trace and nested outbound sends forward it.
    """
    if ctx is None or not ctx[2]:
        return None
    return _CTX.set((ctx[0], ctx[1]))


def release(token) -> None:
    if token is not None:
        _CTX.reset(token)


@dataclass
class Span:
    name: str
    attrs: dict[str, Any] = field(default_factory=dict)
    start: float = 0.0
    duration: float = 0.0
    # W3C-style correlation ids (hex; 128-bit trace, 64-bit span). Filled
    # only on the sinked path — the null path never allocates ids.
    trace_id: str = ""
    span_id: str = ""
    parent_id: str = ""
    wall_start: float = 0.0  # unix seconds (exporters need wall clock)


def add_sink(sink: Callable[[Span], None]) -> None:
    """Register a span consumer (e.g. an OTLP exporter bridge)."""
    global _ENABLED
    _SINKS.append(sink)
    _ENABLED = True


def clear_sinks() -> None:
    global _ENABLED
    _SINKS.clear()
    _ENABLED = False


def enabled() -> bool:
    """True when at least one sink is registered (spans are live)."""
    return _ENABLED


def logging_sink(span: Span) -> None:
    log.debug("span %s %.3fms %s", span.name, span.duration * 1e3, span.attrs)


class _NullSpan:
    """Shared no-op context manager: zero allocation on the unsinked path."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _LiveSpan:
    __slots__ = ("_span", "_token")

    def __init__(self, name: str, attrs: dict[str, Any]) -> None:
        self._span = Span(name=name, attrs=attrs)

    def __enter__(self) -> Span:
        s = self._span
        parent = _CTX.get()
        if parent is None:
            s.trace_id = f"{_rand.getrandbits(128):032x}"
        else:
            s.trace_id, s.parent_id = parent
        s.span_id = f"{_rand.getrandbits(64):016x}"
        self._token = _CTX.set((s.trace_id, s.span_id))
        s.wall_start = time.time()
        s.start = time.perf_counter()
        return s

    def __exit__(self, *exc) -> bool:
        s = self._span
        s.duration = time.perf_counter() - s.start
        _CTX.reset(self._token)
        for sink in _SINKS:
            try:
                sink(s)
            except Exception:  # sinks must never break the request path
                log.exception("trace sink failed")
        return False


def span(name: str, **attrs: Any):
    """Trace a block. Free (shared null object) when no sink is registered."""
    if not _ENABLED:
        return _NULL_SPAN
    return _LiveSpan(name, attrs)
