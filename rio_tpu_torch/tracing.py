"""Tracing spans of the port: a copy of ``rio_tpu/tracing.py``, on the profiler's clock too.

The port imports no module of ``rio_tpu``, so it keeps its own span API:
name, duration and key/values, pluggable sinks (a logging sink provided).
Spans opened here (``placement_solve`` in
:mod:`rio_tpu_torch.object_placement.torch_placement`, the stages of
``entry.placement_step`` and of the two-level solve) reach the sinks
registered with :func:`add_sink` of THIS module, not ``rio_tpu.tracing``'s.

One addition to the copy: while torch's profiler records, a span also
opens ``torch.profiler.record_function(name)``, so its range sits in the
profiler's trace beside the kernels, and it times its stage into a ring of
the newest :data:`STAGE_RING` entries per name: a ``torch.cuda.Event`` pair
on the current stream in a process where CUDA is initialised (nothing
synchronises until :func:`device_stage_ms` reads them), the host's
``perf_counter`` elsewhere. Whether the profiler records is read from
``torch.autograd.profiler`` in ``sys.modules``: this module never imports
torch, so the runtime's processes stay torch-free. With no sink and no
profiler, :func:`span` returns one shared null object, as in the copy.
"""

from __future__ import annotations

import contextvars
import logging
import os
import random
import sys
import time
from collections import deque
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


STAGE_RING = 4096
# name -> the newest (start, end) pairs of its spans opened while the
# profiler recorded: torch.cuda.Event pairs, or perf_counter seconds.
_STAGES: dict[str, deque] = {}


def _profiler():
    """``torch.autograd.profiler`` while it records, else None; never imports torch."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof if prof is not None and prof._is_profiler_enabled else None


class _StageRange:
    """A profiler range of one span, timed into :data:`_STAGES`."""

    __slots__ = ("_name", "_range", "_cuda", "_start")

    def __init__(self, name: str, prof) -> None:
        self._name = name
        self._range = prof.record_function(name)

    def __enter__(self) -> None:
        self._range.__enter__()
        cuda = sys.modules["torch"].cuda
        if cuda.is_initialized() and not cuda.is_current_stream_capturing():
            self._cuda = cuda
            self._start = cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._cuda = None
            self._start = time.perf_counter()

    def __exit__(self, *exc) -> bool:
        if self._cuda is None:
            end = time.perf_counter()
        else:
            end = self._cuda.Event(enable_timing=True)
            end.record()
        _STAGES.setdefault(self._name, deque(maxlen=STAGE_RING)).append((self._start, end))
        self._range.__exit__(*exc)
        return False


def device_stage_ms(name: str, last: int) -> float:
    """Summed milliseconds of the ``last`` newest stage times of ``name``.

    A CUDA entry is the elapsed time from its start event to its end event,
    the stage's device wall: its device work plus any idle inside it that
    waits for the host. It waits for the end event. A host entry (a process
    without CUDA) is the span's host duration. Raises ``ValueError`` when
    the ring holds fewer than ``last`` entries.
    """
    ring = _STAGES.get(name, ())
    if not 0 <= last <= len(ring):
        raise ValueError(f"{last} stage times of {name!r} asked for, {len(ring)} held")
    total = 0.0
    for start, end in list(ring)[len(ring) - last :]:
        if isinstance(start, float):
            total += (end - start) * 1e3
        else:
            end.synchronize()
            total += start.elapsed_time(end)
    return total


class _LiveSpan:
    __slots__ = ("_span", "_token", "_stage")

    def __init__(self, name: str, attrs: dict[str, Any]) -> None:
        self._span = Span(name=name, attrs=attrs)
        prof = _profiler()
        self._stage = None if prof is None else _StageRange(name, prof)

    def __enter__(self) -> Span:
        s = self._span
        parent = _CTX.get()
        if parent is None:
            s.trace_id = f"{_rand.getrandbits(128):032x}"
        else:
            s.trace_id, s.parent_id = parent
        s.span_id = f"{_rand.getrandbits(64):016x}"
        self._token = _CTX.set((s.trace_id, s.span_id))
        if self._stage is not None:
            self._stage.__enter__()
        s.wall_start = time.time()
        s.start = time.perf_counter()
        return s

    def __exit__(self, *exc) -> bool:
        s = self._span
        s.duration = time.perf_counter() - s.start
        if self._stage is not None:
            self._stage.__exit__(*exc)
        _CTX.reset(self._token)
        for sink in _SINKS:
            try:
                sink(s)
            except Exception:  # sinks must never break the request path
                log.exception("trace sink failed")
        return False


def span(name: str, **attrs: Any):
    """Trace a block. Free (shared null object) when no sink is registered
    and torch's profiler is not recording."""
    if not _ENABLED:
        prof = _profiler()
        return _NULL_SPAN if prof is None else _StageRange(name, prof)
    return _LiveSpan(name, attrs)
