"""Server transport backed by the C++ epoll engine.

The engine (``native/rio_native.cc``) owns the listening socket, the
accepted connections, framing, and write backpressure on a dedicated
native thread — the counterpart of the reference's accept + per-connection
frame loops (``rio-rs/src/server.rs:285-305``, ``service.rs:370-459``).
Python only sees complete frame payloads (via an eventfd the asyncio loop
watches) and hands back complete response frames, so the per-byte work
never touches the interpreter.

Dispatch semantics match :meth:`rio_tpu_torch.service.Service.run` exactly:
requests on one connection are answered in order, and a subscription
request switches the connection into streaming mode.
"""

from __future__ import annotations

import asyncio
import ctypes
import logging
import os
from collections import deque
from time import perf_counter as _perf
from typing import TYPE_CHECKING, Callable

from ..message_router import MessageRouter
from ..spans import Phases, finish_request
from ..protocol import (
    CommandEnvelope,
    RequestEnvelope,
    ResponseEnvelope,
    ResponseError,
    SubscriptionRequest,
    UnknownFrameKind,
    decode_inbound,
    encode_response_frame,
    encode_subresponse_frame,
)
from . import EV_CLOSED, EV_FRAME, EV_OPENED, NativeLib, RnEvent, get

if TYPE_CHECKING:
    from ..service import Service

log = logging.getLogger("rio_tpu_torch.native.transport")

_DRAIN_BATCH = 256
_MAX_PENDING_FRAMES = 1024  # per-conn cap (reference relies on TCP backpressure)
_MAX_CONCURRENT = 64  # per-conn in-flight handler cap (matches aio transport)
_MAX_WRITE_BACKLOG = 1 << 20  # pause subscription pumps past 1 MiB unsent

# Same knob as rio_tpu_torch.aio: join a done-callback wave of completed HEAD
# responses into one engine.send (one mutex grab + eventfd kick, one write
# syscall) instead of one per frame. Concatenated length-prefixed frames
# are byte-identical on the wire.
_EGRESS_COALESCE = os.environ.get("RIO_TPU_EGRESS_COALESCE", "1") != "0"


class Engine:
    """Thin pythonic wrapper over the rn_engine_* C ABI."""

    def __init__(
        self, lib: NativeLib, host: str, port: int, reuse_port: bool = False
    ) -> None:
        self._lib = lib
        self._dll = lib._dll
        port_inout = ctypes.c_uint16(port)
        if reuse_port:
            if not getattr(lib, "has_engine_opt", False):
                raise OSError(
                    "reuse_port needs rn_engine_create_opt — rebuild native/ "
                    "(the env-pinned library predates it)"
                )
            self._handle = self._dll.rn_engine_create_opt(
                host.encode(), ctypes.byref(port_inout), 1
            )
        else:
            self._handle = self._dll.rn_engine_create(
                host.encode(), ctypes.byref(port_inout)
            )
        if not self._handle:
            raise OSError(f"rn_engine_create failed for {host}:{port}")
        self.port = port_inout.value
        self.notify_fd: int = self._dll.rn_engine_notify_fd(self._handle)
        self._events = (RnEvent * _DRAIN_BATCH)()

    def start(self) -> None:
        self._dll.rn_engine_start(self._handle)

    def drain(self) -> list[tuple[int, int, bytes]]:
        if self._handle is None:
            return []
        n = self._dll.rn_engine_drain(self._handle, self._events, _DRAIN_BATCH)
        out = []
        for i in range(n):
            ev = self._events[i]
            data = ctypes.string_at(ev.data, ev.len) if ev.len else b""
            out.append((ev.type, ev.conn, data))
        return out

    def send(self, conn: int, data: bytes) -> None:
        # Stragglers (e.g. a subscription pump racing shutdown) must not
        # pass NULL into the C ABI.
        if self._handle is not None:
            self._dll.rn_engine_send(self._handle, conn, data, len(data))

    def backlog(self, conn: int) -> int:
        if self._handle is None:
            return 0
        return int(self._dll.rn_engine_backlog(self._handle, conn))

    def close_conn(self, conn: int) -> None:
        if self._handle is not None:
            self._dll.rn_engine_close_conn(self._handle, conn)

    def shutdown(self) -> None:
        handle, self._handle = self._handle, None
        if handle:
            self._dll.rn_engine_free(handle)


class NativeClientConn:
    """One outbound connection managed by a :class:`ClientEngine`.

    Exposes the same surface the asyncio client connection offers
    (``roundtrip``/``read_frame``/``write``/``close``) including
    **pipelining**: concurrent roundtrips register futures in a FIFO deque
    and inbound frames resolve the oldest one inside the engine's event
    drain — the same design as :class:`rio_tpu_torch.aio.ClientConnProtocol`.
    (A shared Queue was racy here: a parked getter woken by a response
    could be beaten to ``get_nowait`` by a roundtrip issued later,
    silently delivering the response to the wrong caller.)  A roundtrip
    cancelled mid-flight leaves its cancelled future in the deque; its
    response, when it arrives, is discarded rather than shifting every
    later match.
    """

    def __init__(self, engine: "ClientEngine", conn_id: int) -> None:
        self._engine = engine
        self._id = conn_id
        self._waiters: deque[asyncio.Future] = deque()  # FIFO roundtrips
        self._queue: deque[bytes] = deque()  # frames beyond waiters (subscribe)
        self.opened: asyncio.Future[bool] = asyncio.get_running_loop().create_future()
        self.closed = False
        self.delivered = 0  # inbound frames seen (client's progress signal)

    @property
    def pending(self) -> int:
        return len(self._waiters)

    def _deliver(self, payload: bytes) -> None:
        """Resolve the oldest pending roundtrip (engine drain context)."""
        self.delivered += 1
        if self._waiters:
            w = self._waiters.popleft()
            if not w.done():
                w.set_result(payload)
            # else: that roundtrip was cancelled — this payload is its
            # orphaned response; drop it (each cancelled roundtrip is owed
            # exactly ONE orphan frame; never skip several slots per frame).
            return
        self._queue.append(payload)

    def _close_pending(self) -> None:
        for w in self._waiters:
            if not w.done():
                w.set_result(None)
        self._waiters.clear()

    async def roundtrip(self, frame_bytes: bytes) -> bytes:
        """Send one request; await its response (FIFO-matched)."""
        from ..errors import Disconnect

        if self.closed:
            raise Disconnect("native connection closed")
        fut = asyncio.get_running_loop().create_future()
        self._waiters.append(fut)
        self._engine._engine.send(self._id, frame_bytes)
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
        self._engine._engine.send(self._id, frame_bytes)

    def close(self) -> None:
        # Always drop: the C++ Conn/fd must be released even when the close
        # was peer-initiated (closed=True set by EV_CLOSED).  Locally
        # initiated closes emit no EV_CLOSED, so park-ed waiters must be
        # resolved here or they hang forever.
        self.closed = True
        self._close_pending()
        self._engine._drop(self._id)


class ClientEngine:
    """Client-side connection manager over a listener-less engine.

    One engine (one native IO thread) serves every outbound connection of
    a :class:`rio_tpu_torch.Client`; frames and connect results come back
    through the same eventfd/drain bridge the server transport uses.
    """

    def __init__(self) -> None:
        lib = get()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._engine = Engine(lib, "", 0)
        self._conns: dict[int, NativeClientConn] = {}
        self._loop: asyncio.AbstractEventLoop | None = None
        self._started = False

    def _ensure_started(self) -> None:
        if self._started:
            return
        self._loop = asyncio.get_running_loop()
        self._loop.add_reader(self._engine.notify_fd, self._on_ready)
        self._engine.start()
        self._started = True

    def _on_ready(self) -> None:
        for _ in range(8):
            events = self._engine.drain()
            if not events:
                return
            self._dispatch_events(events)

    def _dispatch_events(self, events) -> None:
        for ev_type, conn, data in events:
            c = self._conns.get(conn)
            if c is None:
                continue
            if ev_type == EV_OPENED:
                if not c.opened.done():
                    c.opened.set_result(True)
            elif ev_type == EV_FRAME:
                c._deliver(data)
            elif ev_type == EV_CLOSED:
                c.closed = True
                if not c.opened.done():
                    c.opened.set_result(False)
                c._close_pending()
                self._conns.pop(conn, None)
                # Free the C++ side: a peer FIN takes the engine's soft-EOF
                # path, which keeps the fd open for writes until told
                # otherwise (server semantics); clients have no reply to
                # flush, so release it now.
                self._engine.close_conn(conn)

    async def connect(self, host: str, port: int, timeout: float) -> NativeClientConn:
        import socket as _socket

        from ..errors import ServerNotAvailable

        self._ensure_started()
        try:
            # Async resolution inside the timeout — a stuck resolver must
            # not stall the event loop (the asyncio path gets this from
            # open_connection).
            infos = await asyncio.wait_for(
                asyncio.get_running_loop().getaddrinfo(
                    host, port, family=_socket.AF_INET, type=_socket.SOCK_STREAM
                ),
                timeout,
            )
            quad = infos[0][4][0]
        except (OSError, asyncio.TimeoutError) as e:
            raise ServerNotAvailable(f"{host}:{port}: resolve failed: {e}") from e
        conn_id = self._lib._dll.rn_engine_connect(
            self._engine._handle, quad.encode(), port
        )
        if conn_id == 0:
            raise ServerNotAvailable(f"{host}:{port}: bad address")
        conn = NativeClientConn(self, conn_id)
        self._conns[conn_id] = conn
        try:
            ok = await asyncio.wait_for(conn.opened, timeout)
        except asyncio.TimeoutError:
            conn.close()
            raise ServerNotAvailable(f"{host}:{port}: connect timeout") from None
        if not ok:
            raise ServerNotAvailable(f"{host}:{port}: connection refused")
        return conn

    def _drop(self, conn_id: int) -> None:
        self._conns.pop(conn_id, None)
        self._engine.close_conn(conn_id)

    def close(self) -> None:
        if self._loop is not None and self._started:
            self._loop.remove_reader(self._engine.notify_fd)
        for c in list(self._conns.values()):
            c.closed = True
            c._close_pending()
        self._conns.clear()
        self._engine.shutdown()


class _ConnState:
    __slots__ = (
        "queue",
        "waiter",
        "eof",
        "worker",
        "streaming",
        "resp_q",
        "room",
        "broken",
        "ph_tick",
    )

    def __init__(self) -> None:
        # The worker drains ``queue`` and, at EOF, finishes in-flight
        # requests (FIFO) before exiting — matching the asyncio path where
        # a peer disconnect never cancels a running handler mid-mutation.
        # When span retention is armed the queue holds (payload, recv_ts)
        # tuples instead of raw payloads — the engine decodes frames later
        # in the worker, so receive time must ride along.
        self.queue: deque = deque()
        self.waiter: asyncio.Future | None = None
        self.eof = False
        self.worker: asyncio.Task | None = None
        self.streaming = False
        self.resp_q: deque[asyncio.Future] = deque()  # FIFO response slots
        self.room: asyncio.Future | None = None
        self.broken = False
        self.ph_tick = -1  # 1-in-8 phase-clock stride for untraced traffic

    def wake(self) -> None:
        w = self.waiter
        if w is not None and not w.done():
            self.waiter = None
            w.set_result(None)

    def wake_room(self) -> None:
        r = self.room
        if r is not None and not r.done():
            self.room = None
            r.set_result(None)


def _stamp_handler_end(task) -> None:
    """Done-callback for pipelined dispatch tasks carrying a phase clock."""
    task._rio_ph[0].handler_end = _perf()


class NativeServerTransport:
    """Accept/dispatch loop over the native engine.

    Mirrors the shape of ``asyncio.Server`` enough for
    :class:`rio_tpu_torch.server.Server` (``close()`` + ``wait_closed()``).
    """

    def __init__(
        self,
        service_factory: Callable[[], "Service"],
        host: str,
        port: int,
        reuse_port: bool = False,
    ) -> None:
        lib = get()
        if lib is None:
            raise RuntimeError("native library unavailable (build native/ first)")
        self._lib = lib
        self._service_factory = service_factory
        if host in ("", "::"):
            host = "0.0.0.0"
        else:
            # The engine only takes dotted quads. ``Server.bind()`` resolves
            # names asynchronously before constructing us; this fallback only
            # runs for direct construction off the event loop.
            import socket

            try:
                socket.inet_aton(host)
            except OSError:
                host = socket.gethostbyname(host)
        self._engine = Engine(lib, host, port, reuse_port=reuse_port)
        self.port = self._engine.port
        # SpanRing (node-wide; resolved from the first connection's service
        # — the factory builds services lazily, and the event dispatcher
        # needs the handle before any worker has run).
        self._spans = None
        self._spans_resolved = False
        # EdgeSampler (node-wide TCP byte counters), same lazy resolve.
        self._affinity = None
        # QosScheduler (admission + handler-start grants), same lazy resolve.
        self._qos = None
        self._conns: dict[int, _ConnState] = {}
        self._workers: set[asyncio.Task] = set()
        self._loop: asyncio.AbstractEventLoop | None = None
        self._closed = asyncio.Event()
        self._started = False

    # ------------------------------------------------------------------

    def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._loop.add_reader(self._engine.notify_fd, self._on_ready)
        self._engine.start()
        self._started = True

    def _on_ready(self) -> None:
        # Bounded batches per callback: enough to amortize the eventfd
        # round trip, small enough that conn workers still run between
        # wakeups (the engine re-arms the eventfd when more is pending).
        for _ in range(8):
            events = self._engine.drain()
            if not events:
                return
            self._dispatch_events(events)

    def _dispatch_events(self, events) -> None:
        for ev_type, conn, data in events:
            if ev_type == EV_OPENED:
                state = _ConnState()
                state.worker = asyncio.ensure_future(self._conn_worker(conn, state))
                self._workers.add(state.worker)
                state.worker.add_done_callback(self._workers.discard)
                self._conns[conn] = state
            elif ev_type == EV_FRAME:
                if self._affinity is not None:
                    # Frame payload + the 4-byte length prefix the engine
                    # already consumed — matches what crossed TCP.
                    self._affinity.tcp_in_bytes += len(data) + 4
                state = self._conns.get(conn)
                if state is not None:
                    if len(state.queue) >= _MAX_PENDING_FRAMES:
                        # The asyncio path gets TCP backpressure for free
                        # (reads pause past the handler cap); the engine
                        # reads greedily, so an unbounded pipeliner must be
                        # cut off rather than allowed to grow server memory.
                        # Dropping the state + EOF here (Python-initiated
                        # closes emit no EV_CLOSED) lets the worker finish
                        # in-flight frames and exit instead of leaking.
                        log.warning("conn %d exceeded pending-frame cap", conn)
                        self._conns.pop(conn, None)
                        if state.streaming:
                            # A streaming worker never reads state.queue
                            # again; EOF alone would orphan it.
                            if state.worker is not None:
                                state.worker.cancel()
                        else:
                            # Drop the unserved backlog: the engine closes as
                            # soon as its write queue drains, so responses for
                            # these frames would be thrown away — don't burn
                            # the worker executing them into a dead socket.
                            state.queue.clear()
                            state.eof = True
                            state.wake()
                        self._engine.close_conn(conn)
                    else:
                        if self._spans is not None:
                            # Frame-receive stamp; decode happens in the
                            # worker (unlike the asyncio transport).
                            state.queue.append((data, _perf()))
                        else:
                            state.queue.append(data)
                        state.wake()
            elif ev_type == EV_CLOSED:
                state = self._conns.pop(conn, None)
                if state is not None and state.worker is not None:
                    if state.streaming:
                        # Subscription pumps block on the router queue, not
                        # on inbound frames; cancellation is the only (and
                        # safe — no actor state) way to stop them.
                        state.worker.cancel()
                    else:
                        state.eof = True
                        state.wake()
                        state.wake_room()

    # ------------------------------------------------------------------

    def _push_response(self, conn: int, state: _ConnState, fut: asyncio.Future) -> None:
        state.resp_q.append(fut)
        if fut.done():
            self._flush_ready(conn, state)
        else:
            fut.add_done_callback(lambda _f: self._flush_ready(conn, state))

    def _flush_ready(self, conn: int, state: _ConnState) -> None:
        """Write every completed head response, preserving request order.

        Runs synchronously from the handler task's done-callback (the same
        FIFO-flush design as :class:`rio_tpu_torch.aio.ServerConnProtocol`), so
        out-of-order completions cost nothing until their turn. With egress
        coalescing on (default) the whole wave leaves as ONE joined
        ``engine.send`` — one mutex grab + eventfd kick + write syscall
        instead of one per frame; wire bytes are identical.
        """
        q = state.resp_q
        spans = self._spans
        affinity = self._affinity
        wave: list[bytes] = []  # coalesced frames awaiting one engine.send
        stamped: list = []  # (ph, env) pairs whose flush stamp awaits that send
        try:
            while q and q[0].done() and not state.broken:
                fut = q.popleft()
                if fut.cancelled():
                    continue  # shutdown path; nothing to write
                resp = fut.result()
                frame = encode_response_frame(resp)
                if spans is not None:
                    ctx = getattr(fut, "_rio_ph", None)
                    if ctx is not None:
                        ph, env = ctx
                        ph.encode = _perf()
                        err = resp.error
                        if err is not None:
                            ph.attrs = {"status": int(err.kind)}
                        if _EGRESS_COALESCE:
                            wave.append(frame)
                            stamped.append((ph, env))
                            continue
                        if affinity is not None:
                            affinity.tcp_out_bytes += len(frame)
                        self._engine.send(conn, frame)
                        ph.flush = _perf()
                        finish_request(spans, ph, env)
                        continue
                if _EGRESS_COALESCE:
                    wave.append(frame)
                else:
                    if affinity is not None:
                        affinity.tcp_out_bytes += len(frame)
                    self._engine.send(conn, frame)
            if wave:
                data = wave[0] if len(wave) == 1 else b"".join(wave)
                if affinity is not None:
                    affinity.tcp_out_bytes += len(data)
                self._engine.send(conn, data)
                if stamped:
                    t = _perf()
                    for ph, env in stamped:
                        ph.flush = t
                        finish_request(spans, ph, env)
        except Exception:
            log.exception("response write error; dropping conn %d", conn)
            # Best-effort: frames collected before the failure are complete
            # responses in FIFO order — hand them to the engine (which
            # flushes its queue before close) like the per-frame path did.
            if wave:
                try:
                    self._engine.send(conn, b"".join(wave))
                except Exception:  # noqa: BLE001 — conn is done either way
                    pass
            state.broken = True
            state.eof = True
            state.wake()
            self._conns.pop(conn, None)
            self._engine.close_conn(conn)
        state.wake_room()

    def _stamp_inbound(
        self, state: _ConnState, env: RequestEnvelope, t_recv: float
    ) -> "Phases | None":
        """Attach the per-request phase clock (span retention armed only).

        Traced requests always carry one; untraced traffic samples on the
        same 1-in-8 stride the RED histograms use (per connection), so the
        ring's tail capture sees outliers without a per-request clock read.
        """
        tc = env.trace_ctx
        if tc is None:
            state.ph_tick = tick = (state.ph_tick + 1) & 7
            if tick:
                return None
            ph = Phases(t_recv)
        else:
            ph = Phases(t_recv, tc)
        ph.decode = _perf()
        env._phases = ph
        return ph

    async def _next_payload(self, state: _ConnState) -> bytes | None:
        while not state.queue:
            if state.eof:
                return None
            state.waiter = asyncio.get_running_loop().create_future()
            await state.waiter
        return state.queue.popleft()

    async def _conn_worker(self, conn: int, state: _ConnState) -> None:
        """Ordered-concurrent dispatch for one connection.

        Same semantics as the asyncio transport: handlers run concurrently
        per connection, responses leave strictly in request order
        (service.rs:370-459 wire shape under pipelining).
        """
        service = self._service_factory()
        if not self._spans_resolved:
            self._spans_resolved = True
            self._spans = getattr(service, "spans", None)
            self._affinity = getattr(service, "affinity", None)
            self._qos = getattr(service, "qos", None)
        loop = asyncio.get_running_loop()
        cancelled = False
        try:
            while True:
                payload = await self._next_payload(state)
                if payload is None:
                    # Peer finished sending; flush every in-flight response
                    # before handing the fd back (the engine then closes
                    # once its write queue drains).
                    while state.resp_q and not state.broken:
                        state.room = loop.create_future()
                        await state.room
                    return
                if type(payload) is tuple:
                    payload, t_recv = payload
                else:
                    t_recv = 0.0
                try:
                    inbound = decode_inbound(payload)
                except UnknownFrameKind as e:
                    # A frame kind this server doesn't speak (newer client):
                    # clean NOT_SUPPORTED, connection survives.
                    fut: asyncio.Future = loop.create_future()
                    fut.set_result(
                        ResponseEnvelope.err(ResponseError.not_supported(str(e)))
                    )
                    self._push_response(conn, state, fut)
                    continue
                except Exception as e:  # malformed frame → error response
                    fut = loop.create_future()
                    fut.set_result(
                        ResponseEnvelope.err(ResponseError.unknown(f"bad frame: {e}"))
                    )
                    self._push_response(conn, state, fut)
                    continue
                if type(inbound) is CommandEnvelope:
                    # Control-plane command: ordinary response FIFO, no
                    # inline fast path or phase stamping (commands are
                    # infrequent) — mirrors rio_tpu_torch.aio.
                    while len(state.resp_q) >= _MAX_CONCURRENT and not state.eof:
                        state.room = loop.create_future()
                        await state.room
                    self._push_response(
                        conn, state, loop.create_task(service.call_command(inbound))
                    )
                    continue
                ph = None
                if t_recv and type(inbound) is RequestEnvelope:
                    ph = self._stamp_inbound(state, inbound, t_recv)
                if type(inbound) is RequestEnvelope:
                    qos = self._qos
                    dispatched = None
                    if qos is not None:
                        # One synchronous admission + grant step between
                        # decode and dispatch: sheds ride the FIFO response
                        # path as pre-resolved futures — the handler never
                        # starts (same design as the asyncio transport).
                        dispatched = qos.dispatch(service.call, inbound)
                        if type(dispatched) is ResponseError:
                            fut = loop.create_future()
                            fut.set_result(ResponseEnvelope.err(dispatched))
                            self._push_response(conn, state, fut)
                            continue
                    if not state.resp_q and not state.queue:
                        # Sole in-flight request on this connection:
                        # dispatch inline (no task), the common case.
                        if ph is not None:
                            ph.queue = ph.handler_start = _perf()
                        if dispatched is None:
                            resp = await service.call(inbound)
                        else:
                            resp = await dispatched
                        if ph is not None:
                            ph.handler_end = _perf()
                        if not state.broken:
                            frame = encode_response_frame(resp)
                            if self._affinity is not None:
                                self._affinity.tcp_out_bytes += len(frame)
                            if ph is None:
                                self._engine.send(conn, frame)
                            else:
                                ph.encode = _perf()
                                err = resp.error
                                if err is not None:
                                    ph.attrs = {"status": int(err.kind)}
                                self._engine.send(conn, frame)
                                ph.flush = _perf()
                                finish_request(self._spans, ph, inbound)
                        continue
                    while len(state.resp_q) >= _MAX_CONCURRENT and not state.eof:
                        state.room = loop.create_future()
                        await state.room
                    task = loop.create_task(
                        service.call(inbound)
                        if dispatched is None
                        else dispatched
                    )
                    if ph is not None:
                        # Pipelined path: handler-end stamps in the task's
                        # done-callback; encode/flush when the FIFO head
                        # drains it (_flush_ready).
                        ph.queue = ph.handler_start = _perf()
                        task._rio_ph = (ph, inbound)
                        task.add_done_callback(_stamp_handler_end)
                    self._push_response(conn, state, task)
                else:
                    if conn not in self._conns:
                        # Peer already disconnected (CLOSED was drained while
                        # this frame sat in the queue): entering streaming
                        # mode now would leak the router subscription — no
                        # EV_CLOSED will ever cancel us again.
                        return
                    # Flush pending responses before streaming mode.
                    while state.resp_q and not state.eof:
                        state.room = loop.create_future()
                        await state.room
                    state.streaming = True
                    await self._stream_subscription(conn, service, inbound)
                    return
        except asyncio.CancelledError:
            cancelled = True
            raise
        except Exception:
            log.exception("native conn worker error (conn=%d)", conn)
        finally:
            if cancelled:
                for fut in state.resp_q:
                    fut.cancel()
                state.resp_q.clear()
            # Mirror the asyncio transport's close: whatever ends the
            # worker, the engine should close the socket — after pending
            # responses flush (close_pending semantics in the engine).
            self._conns.pop(conn, None)
            self._engine.close_conn(conn)

    async def _stream_subscription(
        self, conn: int, service: "Service", req: SubscriptionRequest
    ) -> None:
        from ..protocol import SubscriptionResponse

        result = await service.subscribe(req)
        if isinstance(result, ResponseError):
            self._engine.send(
                conn, encode_subresponse_frame(SubscriptionResponse(error=result))
            )
            self._engine.close_conn(conn)
            return
        queue = result
        router = service.app_data.get(MessageRouter)
        try:
            while True:
                item = await queue.get()
                # Write backpressure: the asyncio path blocks in
                # writer.drain(); here we poll the engine's per-conn unsent
                # byte count so a stalled subscriber can't grow the write
                # queue without bound.
                while self._engine.backlog(conn) > _MAX_WRITE_BACKLOG:
                    await asyncio.sleep(0.005)
                self._engine.send(conn, encode_subresponse_frame(item))
        finally:
            router.drop_subscription(req.handler_type, req.handler_id, queue)

    # ------------------------------------------------------------------

    def close(self) -> None:
        if self._loop is not None and self._started:
            self._loop.remove_reader(self._engine.notify_fd)
        # Cancel every worker ever started (not just those still in _conns:
        # a worker whose conn closed mid-dispatch may still be draining).
        for worker in list(self._workers):
            worker.cancel()
        self._workers.clear()
        self._conns.clear()
        self._engine.shutdown()
        self._closed.set()

    async def wait_closed(self) -> None:
        await self._closed.wait()
