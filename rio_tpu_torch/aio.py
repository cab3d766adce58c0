"""Protocol-based asyncio transport (the default data plane).

``asyncio.StreamReader``'s ``readexactly`` costs two coroutine round trips
per frame plus wakeup/feed machinery; at rio-tpu's frame sizes that was
~30% of the request path.  These ``asyncio.Protocol`` classes do the
framing inline in ``data_received`` (C-backed buffer handling in
:class:`rio_tpu_torch.codec.FrameReader`) and hand complete frame payloads
straight to the dispatch loop — the same event-driven shape as the C++
epoll engine (``native/rio_native.cc``), so both transports share
semantics: per-connection ordered responses, streaming-mode switch on a
subscription request, finish-in-flight on peer EOF.

Concurrency model: handlers for one connection run **concurrently** (each
actor still serializes its own handlers via its per-object lock), responses
leave in exactly the request order — preserved FIFO by flushing completed
head responses from the handler task's done-callback.  That keeps the
reference's no-correlation-id wire contract (``rio-rs/src/protocol.rs``)
intact under client-side pipelining, without a per-connection writer task.

Reference: the tokio frame loop this replaces is
``rio-rs/src/service.rs:370-459`` (server) and ``client/mod.rs:199-220``
(client framed streams).
"""

from __future__ import annotations

import asyncio
import logging
import os
from collections import deque
from time import perf_counter as _perf
from typing import TYPE_CHECKING, Callable

from .codec import FrameReader
from .errors import Disconnect, SerializationError
from .message_router import MessageRouter
from .spans import Phases, finish_request
from .protocol import (
    CommandEnvelope,
    RequestEnvelope,
    ResponseEnvelope,
    ResponseError,
    SubscriptionRequest,
    SubscriptionResponse,
    UnknownFrameKind,
    decode_inbound,
    encode_response_frame,
    encode_subresponse_frame,
)

if TYPE_CHECKING:
    from .service import Service

log = logging.getLogger("rio_tpu_torch.aio")

# Batch-decode (data-plane ladder rung 1): deserialize every complete frame
# of a data_received burst in one tight pass over the cached codec schemas,
# instead of alternating decode / dispatch-bookkeeping per frame in the
# worker loop. Module global (not per-instance) so the bench can A/B it
# in-session; measured +4-6% under pipelining on the r6 capture.
_BATCH_DECODE = os.environ.get("RIO_TPU_BATCH_DECODE", "1") != "0"

# Egress coalescing (the outbound mirror of batch decode): frames produced
# in one loop tick — e.g. every completed HEAD response of a done-callback
# wave — are corked and written as ONE buffer instead of one syscall per
# frame. Concatenating complete length-prefixed frames is byte-identical on
# the wire, so the FIFO-per-connection contract is untouched. =0 restores
# the per-frame write, which is the baseline leg of `bench.py --egress`.
_EGRESS_COALESCE = os.environ.get("RIO_TPU_EGRESS_COALESCE", "1") != "0"


class _BadFrame:
    """Queued marker for a frame that failed to decode (batch-decode path).

    The error response must leave in arrival order with everything else on
    the connection, so the failure rides the same queue as decoded inbounds.
    ``not_supported`` distinguishes a frame kind this server doesn't speak
    (a newer client's command against an old server — answered
    NOT_SUPPORTED so the peer can downgrade) from a corrupt frame
    (answered UNKNOWN).
    """

    __slots__ = ("detail", "not_supported")

    def __init__(self, detail: str, *, not_supported: bool = False) -> None:
        self.detail = detail
        self.not_supported = not_supported

    def response(self) -> ResponseEnvelope:
        if self.not_supported:
            return ResponseEnvelope.err(ResponseError.not_supported(self.detail))
        return ResponseEnvelope.err(
            ResponseError.unknown(f"bad frame: {self.detail}")
        )


def _stamp_handler_end(task) -> None:
    """Done-callback for pipelined dispatch tasks carrying a phase clock."""
    task._rio_ph[0].handler_end = _perf()


class ServerConnProtocol(asyncio.Protocol):
    """One accepted connection: framing + ordered-concurrent dispatch."""

    MAX_CONCURRENT = 64  # per-connection in-flight handler cap
    MAX_PENDING_FRAMES = 1024  # inbound backpressure threshold (pause reads)

    __slots__ = (
        "_service_factory",
        "_on_task",
        "_service",
        "_frames",
        "_queue",
        "_waiter",
        "_eof",
        "_transport",
        "_worker",
        "_paused",
        "_reading_paused",
        "_drain",
        "_streaming",
        "_resp_q",
        "_room",
        "_broken",
        "_lost",
        "_out",
        "_flush_scheduled",
        "_spans",
        "_affinity",
        "_qos",
        "_ph_tick",
    )

    def __init__(
        self,
        service_factory: Callable[[], "Service"],
        on_task: Callable[[asyncio.Task], None] | None = None,
    ) -> None:
        self._service_factory = service_factory
        self._on_task = on_task
        self._service: Service | None = None
        self._spans = None  # SpanRing (resolved from the service at accept)
        self._affinity = None  # EdgeSampler (TCP byte counters), same resolve
        self._qos = None  # QosScheduler (admission + start grants), same resolve
        self._ph_tick = -1  # 1-in-8 phase-clock stride for untraced traffic
        self._frames = FrameReader()
        # Inbound work: decoded envelopes / _BadFrame markers (batch-decode
        # path) or raw frame payloads (RIO_TPU_BATCH_DECODE=0 fallback).
        self._queue: deque = deque()
        self._waiter: asyncio.Future | None = None  # reader parked on _queue
        self._eof = False
        self._transport: asyncio.Transport | None = None
        self._worker: asyncio.Task | None = None
        self._paused = False
        self._reading_paused = False
        self._drain: asyncio.Future | None = None  # streaming backpressure
        self._streaming = False
        self._resp_q: deque[asyncio.Future] = deque()  # FIFO response slots
        self._room: asyncio.Future | None = None  # reader parked on cap
        self._broken = False  # a response failed; FIFO can't recover
        self._lost = False  # connection_lost fired; writes are pointless
        self._out: list[bytes] = []  # corked response frames (one syscall/tick)
        self._flush_scheduled = False

    # -- transport callbacks -------------------------------------------------

    def connection_made(self, transport: asyncio.BaseTransport) -> None:
        self._transport = transport  # type: ignore[assignment]
        self._service = self._service_factory()
        self._spans = getattr(self._service, "spans", None)
        self._affinity = getattr(self._service, "affinity", None)
        self._qos = getattr(self._service, "qos", None)
        self._worker = asyncio.ensure_future(self._run())
        if self._on_task is not None:
            self._on_task(self._worker)

    def _stamp_inbound(self, env, t_recv: float) -> None:
        """Attach the per-request phase clock (span retention armed only).

        Traced requests always carry one; untraced traffic is sampled on
        the same 1-in-8 stride the RED histograms use, so the ring's
        tail-based capture sees outliers without the hot path paying a
        clock read per request.
        """
        if type(env) is not RequestEnvelope:
            return
        tc = env.trace_ctx
        if tc is None:
            self._ph_tick = tick = (self._ph_tick + 1) & 7
            if tick:
                return
            ph = Phases(t_recv)
        else:
            ph = Phases(t_recv, tc)
        ph.decode = _perf()
        env._phases = ph

    def data_received(self, data: bytes) -> None:
        if self._affinity is not None:
            # Honest bytes-over-TCP ledger (bench --affinity numerator):
            # raw socket reads, before any decode.
            self._affinity.tcp_in_bytes += len(data)
        try:
            payloads = self._frames.feed(data)
        except SerializationError as e:
            # Unframeable stream (oversized header): nothing sane follows.
            log.warning("dropping connection: %s", e)
            assert self._transport is not None
            self._transport.close()
            return
        if payloads:
            if _BATCH_DECODE:
                # One tight decode pass per socket read: the cached dataclass
                # schemas stay hot and the worker loop receives ready
                # envelopes. Decode failures become in-order error markers.
                append = self._queue.append
                if self._spans is None:
                    for p in payloads:
                        try:
                            append(decode_inbound(p))
                        except UnknownFrameKind as e:
                            append(_BadFrame(str(e), not_supported=True))
                        except Exception as e:  # noqa: BLE001 — malformed frame
                            append(_BadFrame(str(e)))
                else:
                    # Span retention armed: one recv stamp per socket read
                    # (shared by the burst), decode stamped per envelope.
                    t_recv = _perf()
                    for p in payloads:
                        try:
                            env = decode_inbound(p)
                        except UnknownFrameKind as e:
                            append(_BadFrame(str(e), not_supported=True))
                            continue
                        except Exception as e:  # noqa: BLE001 — malformed frame
                            append(_BadFrame(str(e)))
                            continue
                        self._stamp_inbound(env, t_recv)
                        append(env)
            else:
                self._queue.extend(payloads)
            self._wake()
            # Inbound backpressure: MAX_CONCURRENT caps in-flight handlers
            # but not buffered frames — a fast pipelining client could grow
            # _queue without bound (the native engine cuts such peers off at
            # _MAX_PENDING_FRAMES).  Pausing the transport propagates real
            # TCP backpressure instead; the dispatch loop resumes reads as
            # it drains.
            if (
                not self._reading_paused
                and len(self._queue) + len(self._resp_q) > self.MAX_PENDING_FRAMES
            ):
                self._reading_paused = True
                assert self._transport is not None
                self._transport.pause_reading()

    def eof_received(self) -> bool | None:
        self._eof = True
        self._wake()
        return True  # keep transport open until responses flush

    def connection_lost(self, exc: Exception | None) -> None:
        self._eof = True
        self._lost = True
        self._wake()
        self._wake_room()
        if self._drain is not None and not self._drain.done():
            self._drain.set_result(None)
        if self._streaming and self._worker is not None:
            # A streaming worker blocks on the router queue, not on inbound
            # frames; cancellation is the only way to stop it (same rule as
            # the native transport).
            self._worker.cancel()

    def pause_writing(self) -> None:
        self._paused = True

    def resume_writing(self) -> None:
        self._paused = False
        if self._drain is not None and not self._drain.done():
            self._drain.set_result(None)

    # -- response FIFO -------------------------------------------------------

    def _push_response(self, fut: asyncio.Future) -> None:
        self._resp_q.append(fut)
        if fut.done():
            self._flush_ready()
        else:
            fut.add_done_callback(self._on_response_ready)

    def _on_response_ready(self, fut: asyncio.Future) -> None:
        self._flush_ready()

    def _flush_ready(self) -> None:
        """Queue every completed head response, preserving request order.

        Runs synchronously from the handler task's done-callback — only the
        FIFO head's completion actually emits (possibly several at once),
        so out-of-order completions cost nothing until their turn.  Frames
        are CORKED: appended to ``_out`` and written as one syscall at the
        end of the loop tick (``_do_flush``) — under pipelining this
        collapses dozens of per-response ``send``s into one.
        """
        q = self._resp_q
        spans = self._spans
        while q and q[0].done() and not self._broken:
            fut = q.popleft()
            if fut.cancelled() or self._lost:
                continue  # shutdown path / dead socket; nothing to write
            try:
                resp = fut.result()
                frame = encode_response_frame(resp)
            except Exception:
                # An unencodable/failed response would desync every later
                # FIFO match on this connection; drop the connection.
                log.exception("response encode error; dropping connection")
                self._break()
                break
            if spans is not None:
                ctx = getattr(fut, "_rio_ph", None)
                if ctx is not None:
                    ph, env = ctx
                    ph.encode = _perf()
                    err = resp.error
                    if err is not None:
                        ph.attrs = {"status": int(err.kind)}
                    self._write_soon(frame)
                    ph.flush = _perf()
                    finish_request(spans, ph, env)
                    continue
            self._write_soon(frame)
        self._wake_room()
        self._maybe_resume_reading()

    def _break(self) -> None:
        self._broken = True
        self._eof = True
        self._out.clear()
        self._wake()
        assert self._transport is not None
        self._transport.close()

    def _write_soon(self, data: bytes) -> None:
        if not _EGRESS_COALESCE:
            # Per-frame baseline (bench A/B): one transport.write per frame.
            if self._lost or self._broken:
                return
            try:
                assert self._transport is not None
                if self._affinity is not None:
                    self._affinity.tcp_out_bytes += len(data)
                self._transport.write(data)
            except Exception:
                log.exception("response write error; dropping connection")
                self._break()
            return
        self._out.append(data)
        if not self._flush_scheduled:
            self._flush_scheduled = True
            asyncio.get_running_loop().call_soon(self._do_flush)

    def _do_flush(self) -> None:
        self._flush_scheduled = False
        out = self._out
        if not out:
            return
        data = out[0] if len(out) == 1 else b"".join(out)
        out.clear()
        if self._lost or self._broken:
            return
        try:
            assert self._transport is not None
            if self._affinity is not None:
                self._affinity.tcp_out_bytes += len(data)
            self._transport.write(data)
        except Exception:
            log.exception("response write error; dropping connection")
            self._break()

    def _wake_room(self) -> None:
        r = self._room
        if r is not None and not r.done():
            self._room = None
            r.set_result(None)

    def _maybe_resume_reading(self) -> None:
        if (
            self._reading_paused
            and not self._lost
            and len(self._queue) + len(self._resp_q) <= self.MAX_PENDING_FRAMES // 2
        ):
            self._reading_paused = False
            assert self._transport is not None
            self._transport.resume_reading()

    # -- reader/dispatcher ---------------------------------------------------

    def _wake(self) -> None:
        w = self._waiter
        if w is not None and not w.done():
            self._waiter = None
            w.set_result(None)

    async def _next_inbound(self):
        while not self._queue:
            if self._eof:
                return None
            self._waiter = asyncio.get_running_loop().create_future()
            await self._waiter
        item = self._queue.popleft()
        self._maybe_resume_reading()
        return item

    async def _flushed(self) -> None:
        """Honor write backpressure (the StreamWriter.drain equivalent)."""
        while self._paused and not self._eof:
            self._drain = asyncio.get_running_loop().create_future()
            await self._drain

    async def _run(self) -> None:
        service = self._service
        transport = self._transport
        assert service is not None and transport is not None
        loop = asyncio.get_running_loop()
        cancelled = False
        try:
            while True:
                inbound = await self._next_inbound()
                if inbound is None:
                    # Peer finished sending; keep the socket open until
                    # every in-flight response has been written (the peer
                    # may have half-closed and still be reading).
                    while self._resp_q and not self._lost and not self._broken:
                        self._room = loop.create_future()
                        await self._room
                    return
                if type(inbound) is bytes:
                    # Fallback path (batch decode off): the queue holds raw
                    # frame payloads; decode them here as before. The phase
                    # clock starts at decode (recv_us collapses to ~0 — the
                    # batch path is the measured default).
                    t_recv = _perf() if self._spans is not None else 0.0
                    try:
                        inbound = decode_inbound(inbound)
                    except UnknownFrameKind as e:
                        inbound = _BadFrame(str(e), not_supported=True)
                    except Exception as e:  # malformed frame → error response
                        inbound = _BadFrame(str(e))
                    else:
                        if self._spans is not None:
                            self._stamp_inbound(inbound, t_recv)
                if type(inbound) is _BadFrame:
                    fut: asyncio.Future = loop.create_future()
                    fut.set_result(inbound.response())
                    self._push_response(fut)
                    continue
                if type(inbound) is CommandEnvelope:
                    # Control-plane command: rides the ordinary response
                    # FIFO (commands are infrequent — no inline fast path,
                    # no phase stamping).
                    while len(self._resp_q) >= self.MAX_CONCURRENT and not self._eof:
                        self._room = loop.create_future()
                        await self._room
                    self._push_response(
                        loop.create_task(service.call_command(inbound))
                    )
                    continue
                if type(inbound) is RequestEnvelope:
                    qos = self._qos
                    dispatched = None
                    if qos is not None:
                        # One synchronous admission + grant step between
                        # decode and dispatch: a shed (token bucket / full
                        # class queue) rides the ordinary FIFO response
                        # path as a pre-resolved future — the handler never
                        # starts (_BadFrame pattern, so ordering is
                        # preserved). Otherwise ``dispatched`` is the
                        # awaitable that runs the handler under its grant.
                        dispatched = qos.dispatch(service.call, inbound)
                        if type(dispatched) is ResponseError:
                            fut = loop.create_future()
                            fut.set_result(ResponseEnvelope.err(dispatched))
                            self._push_response(fut)
                            continue
                    ph = (
                        inbound.__dict__.get("_phases")
                        if self._spans is not None
                        else None
                    )
                    if not self._resp_q and not self._queue:
                        # Sole in-flight request on this connection: dispatch
                        # inline (no task) — the common non-pipelined case,
                        # worth ~5-8% (measured). Frames arriving DURING the
                        # inline await just buffer; when it finishes, the
                        # backlog takes the concurrent spawn path below, so
                        # head-of-line serialization is bounded to this one
                        # request (and FIFO response order delays delivery
                        # behind a slow head regardless of execution model).
                        if ph is not None:
                            ph.queue = ph.handler_start = _perf()
                        if dispatched is None:
                            resp = await service.call(inbound)
                        else:
                            # Under contention the grant may park
                            # (weighted-fair / strict tiers) or resolve to
                            # DEADLINE_EXCEEDED without running the handler.
                            resp = await dispatched
                        if ph is not None:
                            ph.handler_end = _perf()
                        if not self._broken:
                            try:
                                frame = encode_response_frame(resp)
                            except Exception:
                                log.exception(
                                    "response encode error; dropping connection"
                                )
                                return
                            if ph is None:
                                self._write_soon(frame)
                            else:
                                ph.encode = _perf()
                                err = resp.error
                                if err is not None:
                                    ph.attrs = {"status": int(err.kind)}
                                self._write_soon(frame)
                                ph.flush = _perf()
                                finish_request(self._spans, ph, inbound)
                        if self._paused:
                            await self._flushed()
                        continue
                    while len(self._resp_q) >= self.MAX_CONCURRENT and not self._eof:
                        self._room = loop.create_future()
                        await self._room
                    task = loop.create_task(
                        service.call(inbound)
                        if dispatched is None
                        else dispatched
                    )
                    if ph is not None:
                        # Pipelined path: handler runs in its own task;
                        # queue-exit/handler-start stamp here, handler-end in
                        # the task's done-callback, encode/flush when the
                        # FIFO head drains it (_flush_ready).
                        ph.queue = ph.handler_start = _perf()
                        task._rio_ph = (ph, inbound)
                        task.add_done_callback(_stamp_handler_end)
                    self._push_response(task)
                else:
                    # Flush every pending response before switching the
                    # connection into subscription streaming mode.
                    while self._resp_q and not self._eof:
                        self._room = loop.create_future()
                        await self._room
                    self._do_flush()  # corked responses precede the stream
                    self._streaming = True
                    await self._stream_subscription(inbound)
                    return
        except asyncio.CancelledError:
            cancelled = True
            raise
        except ConnectionError:
            pass
        except Exception:
            log.exception("connection worker error")
        finally:
            if cancelled:
                # Server shutdown: sever the connection now — cancel every
                # in-flight handler (the pre-pipelining behavior, where the
                # inline-awaited handler died with the worker).
                for fut in self._resp_q:
                    fut.cancel()
                self._resp_q.clear()
                self._out.clear()
            self._do_flush()  # corked frames must beat transport.close()
            transport.close()

    async def _stream_subscription(self, req: SubscriptionRequest) -> None:
        service, transport = self._service, self._transport
        assert service is not None and transport is not None
        result = await service.subscribe(req)
        if isinstance(result, ResponseError):
            transport.write(
                encode_subresponse_frame(SubscriptionResponse(error=result))
            )
            return
        queue = result
        router = service.app_data.get(MessageRouter)
        try:
            while not self._eof:
                item = await queue.get()
                transport.write(encode_subresponse_frame(item))
                if self._paused:
                    await self._flushed()
        finally:
            router.drop_subscription(req.handler_type, req.handler_id, queue)


class ClientConnProtocol(asyncio.Protocol):
    """One outbound connection: framing + FIFO frame delivery.

    Surface-compatible with :class:`rio_tpu_torch.native.transport.NativeClientConn`
    (``roundtrip`` / ``read_frame`` / ``write`` / ``close``), plus
    **pipelining**: multiple requests may be in flight at once.  The wire
    has no correlation ids (the reference's contract), but the server
    answers each connection's requests in order, so inbound frames resolve
    the oldest pending ``roundtrip`` FIFO-style.  ``pending`` exposes the
    in-flight depth for the pool's least-loaded pick.
    """

    __slots__ = (
        "_frames",
        "_waiters",
        "_queue",
        "_transport",
        "closed",
        "delivered",
        "_out",
        "_flush_scheduled",
    )

    def __init__(self) -> None:
        self._frames = FrameReader()
        self._waiters: deque[asyncio.Future] = deque()  # FIFO roundtrips
        self._queue: deque[bytes] = deque()  # frames beyond waiters (subscribe)
        self._transport: asyncio.Transport | None = None
        self.closed = False
        self.delivered = 0  # inbound frames seen (client's progress signal)
        self._out: list[bytes] = []  # corked request frames (one syscall/tick)
        self._flush_scheduled = False

    @property
    def pending(self) -> int:
        return len(self._waiters)

    def connection_made(self, transport: asyncio.BaseTransport) -> None:
        self._transport = transport  # type: ignore[assignment]

    def data_received(self, data: bytes) -> None:
        try:
            payloads = self._frames.feed(data)
        except SerializationError:
            self.closed = True
            assert self._transport is not None
            self._transport.close()
            return
        for payload in payloads:
            self.delivered += 1
            if self._waiters:
                w = self._waiters.popleft()
                if not w.done():
                    w.set_result(payload)
                # else: the matching roundtrip was cancelled mid-flight —
                # this payload is its orphaned response; drop it (handing
                # it to the next waiter would shift every later match).
            else:
                self._queue.append(payload)

    def connection_lost(self, exc: Exception | None) -> None:
        self.closed = True
        for w in self._waiters:
            if not w.done():
                w.set_result(None)
        self._waiters.clear()

    # -- conn surface ---------------------------------------------------------

    def _write_soon(self, frame_bytes: bytes) -> None:
        """Cork writes: one syscall per loop tick instead of per request.

        Order safety: waiter registration order == append order == flush
        order, and the server cannot answer a frame before it is written,
        so FIFO matching is unaffected.
        """
        if not _EGRESS_COALESCE:
            # Per-frame baseline (bench A/B), mirroring the server side.
            if self.closed or self._transport is None:
                return
            try:
                self._transport.write(frame_bytes)
            except Exception:
                log.exception("request write error; dropping connection")
                self.close()
            return
        self._out.append(frame_bytes)
        if not self._flush_scheduled:
            self._flush_scheduled = True
            asyncio.get_running_loop().call_soon(self._do_flush)

    def _do_flush(self) -> None:
        self._flush_scheduled = False
        out = self._out
        if not out or self.closed or self._transport is None:
            out.clear()
            return
        data = out[0] if len(out) == 1 else b"".join(out)
        out.clear()
        try:
            self._transport.write(data)
        except Exception:
            log.exception("request write error; dropping connection")
            self.close()

    async def roundtrip(self, frame_bytes: bytes) -> bytes:
        if self.closed:
            raise Disconnect("connection closed")
        assert self._transport is not None
        fut = asyncio.get_running_loop().create_future()
        self._waiters.append(fut)
        self._write_soon(frame_bytes)
        payload = await fut
        if payload is None:
            raise Disconnect("connection closed mid-request")
        return payload

    async def read_frame(self) -> bytes | None:
        """Next inbound frame; None at EOF (subscription streaming)."""
        while not self._queue:
            if self.closed:
                return None
            fut = asyncio.get_running_loop().create_future()
            self._waiters.append(fut)
            return await fut
        return self._queue.popleft()

    def write(self, frame_bytes: bytes) -> None:
        assert self._transport is not None
        self._write_soon(frame_bytes)

    def close(self) -> None:
        self._do_flush()  # corked frames must beat transport.close()
        self.closed = True
        if self._transport is not None:
            self._transport.close()


async def connect(host: str, port: int, timeout: float) -> ClientConnProtocol:
    """Dial ``host:port`` and return the framed connection."""
    loop = asyncio.get_running_loop()
    _, proto = await asyncio.wait_for(
        loop.create_connection(ClientConnProtocol, host, port), timeout
    )
    return proto
