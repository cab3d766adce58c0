"""ctypes binding for the C++ data plane (``native/rio_native.cc``).

The native library provides:

* a wire codec for the framework envelopes (exactly the byte layout of
  :mod:`rio_tpu_torch.protocol`) plus an incremental frame reader, and
* an epoll connection engine that owns sockets + framing on a native
  thread (see :mod:`rio_tpu_torch.native.transport`).

Everything degrades gracefully: :func:`get` returns ``None`` when the
library can't be built/loaded (or ``RIO_TPU_NATIVE=0``), and callers fall
back to the pure-Python paths, which are wire-compatible.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from pathlib import Path

from ..errors import SerializationError

log = logging.getLogger("rio_tpu_torch.native")

_SRC_DIR = Path(__file__).resolve().parent.parent.parent / "native"
_SRC = _SRC_DIR / "rio_native.cc"
# The port builds the repo's source into its own git-ignored directory and
# never touches the artefact that ``native/`` holds for the reference.
_SO = Path(__file__).resolve().parent.parent / "kernels" / "_build" / "librio_native.so"

_lock = threading.Lock()
_lib: "NativeLib | None | bool" = False  # False = not attempted yet


class RnEvent(ctypes.Structure):
    _fields_ = [
        ("type", ctypes.c_uint32),
        ("pad", ctypes.c_uint32),
        ("conn", ctypes.c_uint64),
        ("data", ctypes.POINTER(ctypes.c_uint8)),
        ("len", ctypes.c_uint64),
    ]


EV_FRAME = 1
EV_CLOSED = 2
EV_OPENED = 3

_U8P = ctypes.POINTER(ctypes.c_uint8)
_U32 = ctypes.c_uint32
_U32P = ctypes.POINTER(ctypes.c_uint32)


def _ensure_built() -> Path | None:
    """Compile the shared library if missing or stale; None on failure."""
    env_lib = os.environ.get("RIO_TPU_NATIVE_LIB")
    if env_lib:
        return Path(env_lib) if Path(env_lib).exists() else None
    if not _SRC.exists():
        return _SO if _SO.exists() else None
    if _SO.exists() and _SO.stat().st_mtime >= _SRC.stat().st_mtime:
        return _SO
    try:
        _SO.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            [
                os.environ.get("CXX", "g++"),
                "-O2", "-std=c++17", "-fPIC", "-Wall", "-pthread",
                "-shared", "-o", str(_SO), str(_SRC),
            ],
            check=True,
            capture_output=True,
            timeout=120,
        )
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", b"")
        log.warning("native build failed: %s %s", e, detail)
        return None
    return _SO


class NativeLib:
    """Typed wrapper over the loaded shared library."""

    def __init__(self, dll: ctypes.CDLL) -> None:
        self._dll = dll
        dll.rn_free.argtypes = [_U8P]
        dll.rn_free.restype = None

        enc_sig = {
            "rn_encode_request_frame": 4,
            "rn_encode_subscribe_frame": 2,
            "rn_encode_subresponse_ok_frame": 2,
        }
        for name, n_bufs in enc_sig.items():
            fn = getattr(dll, name)
            fn.argtypes = [ctypes.c_char_p, _U32] * n_bufs + [_U32P]
            fn.restype = _U8P
        dll.rn_encode_response_ok_frame.argtypes = [ctypes.c_char_p, _U32, _U32P]
        dll.rn_encode_response_ok_frame.restype = _U8P
        for name in ("rn_encode_response_err_frame", "rn_encode_subresponse_err_frame"):
            fn = getattr(dll, name)
            fn.argtypes = [_U32, ctypes.c_char_p, _U32, ctypes.c_char_p, _U32, _U32P]
            fn.restype = _U8P

        dll.rn_encode_request_frame_traced.argtypes = (
            [ctypes.c_char_p, _U32] * 6 + [ctypes.c_int32, _U32P]
        )
        dll.rn_encode_request_frame_traced.restype = _U8P

        try:
            # Command frames (KIND_COMMAND, streams/sagas PR): absent from
            # env-pinned prebuilt libraries, which then report
            # has_command=False and callers stay on the Python codec.
            dll.rn_encode_command_frame.argtypes = (
                [ctypes.c_char_p, _U32] * 3 + [_U32P]
            )
            dll.rn_encode_command_frame.restype = _U8P
            dll.rn_encode_command_frame_traced.argtypes = (
                [ctypes.c_char_p, _U32] * 5 + [ctypes.c_int32, _U32P]
            )
            dll.rn_encode_command_frame_traced.restype = _U8P
            self.has_command = True
        except AttributeError:
            self.has_command = False

        dll.rn_decode_inbound.argtypes = [
            ctypes.c_char_p, _U32, _U32P, _U32P, ctypes.POINTER(ctypes.c_int32),
        ]
        dll.rn_decode_inbound.restype = ctypes.c_int

        try:
            # QoS request frames (tenant/priority/deadline_ms):
            # absent from env-pinned prebuilt libraries, which then report
            # has_qos=False — callers stay on the Python codec and the
            # parity tests skip.
            dll.rn_encode_request_frame_qos.argtypes = (
                [ctypes.c_char_p, _U32] * 6
                + [ctypes.c_int32, ctypes.c_char_p, _U32,
                   ctypes.c_uint64, ctypes.c_uint64, _U32P]
            )
            dll.rn_encode_request_frame_qos.restype = _U8P
            dll.rn_decode_inbound_qos.argtypes = [
                ctypes.c_char_p, _U32, _U32P, _U32P,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint64),
            ]
            dll.rn_decode_inbound_qos.restype = ctypes.c_int
            self.has_qos = True
        except AttributeError:
            self.has_qos = False
        for name in ("rn_decode_response", "rn_decode_subresponse"):
            fn = getattr(dll, name)
            fn.argtypes = [ctypes.c_char_p, _U32, _U32P, _U32P, _U32P]
            fn.restype = ctypes.c_int

        dll.rn_reader_new.argtypes = []
        dll.rn_reader_new.restype = ctypes.c_void_p
        dll.rn_reader_free.argtypes = [ctypes.c_void_p]
        dll.rn_reader_free.restype = None
        dll.rn_reader_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p, _U32]
        dll.rn_reader_feed.restype = ctypes.c_int
        dll.rn_reader_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_void_p),
            _U32P,
        ]
        dll.rn_reader_next.restype = ctypes.c_int

        dll.rn_engine_create.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint16)]
        dll.rn_engine_create.restype = ctypes.c_void_p
        try:
            # Newer ABI with the SO_REUSEPORT flag; absent from env-pinned
            # prebuilt libraries (RIO_TPU_NATIVE_LIB), which then refuse
            # reuse_port loudly in the transport instead of ignoring it.
            dll.rn_engine_create_opt.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint16), ctypes.c_int32,
            ]
            dll.rn_engine_create_opt.restype = ctypes.c_void_p
            self.has_engine_opt = True
        except AttributeError:
            self.has_engine_opt = False
        dll.rn_engine_notify_fd.argtypes = [ctypes.c_void_p]
        dll.rn_engine_notify_fd.restype = ctypes.c_int
        dll.rn_engine_port.argtypes = [ctypes.c_void_p]
        dll.rn_engine_port.restype = ctypes.c_uint16
        dll.rn_engine_start.argtypes = [ctypes.c_void_p]
        dll.rn_engine_start.restype = None
        dll.rn_engine_drain.argtypes = [ctypes.c_void_p, ctypes.POINTER(RnEvent), ctypes.c_int]
        dll.rn_engine_drain.restype = ctypes.c_int
        dll.rn_engine_send.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p, _U32]
        dll.rn_engine_send.restype = None
        dll.rn_engine_backlog.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        dll.rn_engine_backlog.restype = ctypes.c_longlong
        dll.rn_engine_connect.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint16]
        dll.rn_engine_connect.restype = ctypes.c_uint64
        dll.rn_engine_close_conn.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        dll.rn_engine_close_conn.restype = None
        dll.rn_engine_stop.argtypes = [ctypes.c_void_p]
        dll.rn_engine_stop.restype = None
        dll.rn_engine_free.argtypes = [ctypes.c_void_p]
        dll.rn_engine_free.restype = None

    # -- codec ---------------------------------------------------------

    def _take(self, ptr, n: int) -> bytes:
        out = ctypes.string_at(ptr, n)
        self._dll.rn_free(ptr)
        return out

    def encode_request_frame(self, ht: bytes, hid: bytes, mt: bytes, payload: bytes) -> bytes:
        n = _U32(0)
        ptr = self._dll.rn_encode_request_frame(
            ht, len(ht), hid, len(hid), mt, len(mt), payload, len(payload), ctypes.byref(n)
        )
        if not ptr:
            raise SerializationError("rn_encode_request_frame: frame too large")
        return self._take(ptr, n.value)

    def encode_request_frame_traced(
        self, ht: bytes, hid: bytes, mt: bytes, payload: bytes,
        trace_id: bytes, span_id: bytes, sampled: bool,
    ) -> bytes:
        n = _U32(0)
        ptr = self._dll.rn_encode_request_frame_traced(
            ht, len(ht), hid, len(hid), mt, len(mt), payload, len(payload),
            trace_id, len(trace_id), span_id, len(span_id),
            1 if sampled else 0, ctypes.byref(n),
        )
        if not ptr:
            raise SerializationError("rn_encode_request_frame_traced: frame too large")
        return self._take(ptr, n.value)

    def encode_command_frame(self, cmd: bytes, subject: bytes, payload: bytes) -> bytes:
        n = _U32(0)
        ptr = self._dll.rn_encode_command_frame(
            cmd, len(cmd), subject, len(subject), payload, len(payload), ctypes.byref(n)
        )
        if not ptr:
            raise SerializationError("rn_encode_command_frame: frame too large")
        return self._take(ptr, n.value)

    def encode_command_frame_traced(
        self, cmd: bytes, subject: bytes, payload: bytes,
        trace_id: bytes, span_id: bytes, sampled: bool,
    ) -> bytes:
        n = _U32(0)
        ptr = self._dll.rn_encode_command_frame_traced(
            cmd, len(cmd), subject, len(subject), payload, len(payload),
            trace_id, len(trace_id), span_id, len(span_id),
            1 if sampled else 0, ctypes.byref(n),
        )
        if not ptr:
            raise SerializationError("rn_encode_command_frame_traced: frame too large")
        return self._take(ptr, n.value)

    def encode_request_frame_qos(
        self, ht: bytes, hid: bytes, mt: bytes, payload: bytes,
        trace_id: bytes, span_id: bytes, sampled: int,
        tenant: bytes, priority: int, deadline_ms: int,
    ) -> bytes:
        """QoS-classified request frame; ``sampled`` < 0 means untraced
        (the wire carries a nil trace slot to hold position)."""
        n = _U32(0)
        ptr = self._dll.rn_encode_request_frame_qos(
            ht, len(ht), hid, len(hid), mt, len(mt), payload, len(payload),
            trace_id, len(trace_id), span_id, len(span_id), sampled,
            tenant, len(tenant), priority, deadline_ms, ctypes.byref(n),
        )
        if not ptr:
            raise SerializationError("rn_encode_request_frame_qos: frame too large")
        return self._take(ptr, n.value)

    def encode_subscribe_frame(self, ht: bytes, hid: bytes) -> bytes:
        n = _U32(0)
        ptr = self._dll.rn_encode_subscribe_frame(ht, len(ht), hid, len(hid), ctypes.byref(n))
        if not ptr:
            raise SerializationError("rn_encode_subscribe_frame: frame too large")
        return self._take(ptr, n.value)

    def encode_response_ok_frame(self, body: bytes) -> bytes:
        n = _U32(0)
        ptr = self._dll.rn_encode_response_ok_frame(body, len(body), ctypes.byref(n))
        if not ptr:
            raise SerializationError("rn_encode_response_ok_frame: frame too large")
        return self._take(ptr, n.value)

    def encode_response_err_frame(self, kind: int, detail: bytes, payload: bytes) -> bytes:
        n = _U32(0)
        ptr = self._dll.rn_encode_response_err_frame(
            kind, detail, len(detail), payload, len(payload), ctypes.byref(n)
        )
        if not ptr:
            raise SerializationError("rn_encode_response_err_frame: frame too large")
        return self._take(ptr, n.value)

    def encode_subresponse_ok_frame(self, message_type: bytes, body: bytes) -> bytes:
        n = _U32(0)
        ptr = self._dll.rn_encode_subresponse_ok_frame(
            message_type, len(message_type), body, len(body), ctypes.byref(n)
        )
        if not ptr:
            raise SerializationError("rn_encode_subresponse_ok_frame: frame too large")
        return self._take(ptr, n.value)

    def encode_subresponse_err_frame(self, kind: int, detail: bytes, payload: bytes) -> bytes:
        n = _U32(0)
        ptr = self._dll.rn_encode_subresponse_err_frame(
            kind, detail, len(detail), payload, len(payload), ctypes.byref(n)
        )
        if not ptr:
            raise SerializationError("rn_encode_subresponse_err_frame: frame too large")
        return self._take(ptr, n.value)

    def decode_inbound(self, payload: bytes):
        """Returns ``(0, ht, hid, mt, body)`` (traced frames append
        ``tid, sid, sampled``) | ``(1, ht, hid)`` |
        ``(2, cmd, subject, body[, tid, sid, sampled])`` | None."""
        offs = (_U32 * 6)()
        lens = (_U32 * 6)()
        sampled = ctypes.c_int32(-1)
        rc = self._dll.rn_decode_inbound(
            payload, len(payload), offs, lens, ctypes.byref(sampled)
        )
        if rc < 0:
            return None
        n_fields = 4 if rc == 0 else 3 if rc == 2 else 2
        spans = [payload[offs[i] : offs[i] + lens[i]] for i in range(n_fields)]
        if rc in (0, 2) and sampled.value >= 0:
            spans.extend(
                (
                    payload[offs[4] : offs[4] + lens[4]],
                    payload[offs[5] : offs[5] + lens[5]],
                    bool(sampled.value),
                )
            )
        return (rc, *spans)

    def decode_inbound_qos(self, payload: bytes):
        """QoS-aware inbound decode. For requests, always returns the full
        11-tuple ``(0, ht, hid, mt, body, tid, sid, sampled, tenant,
        priority, deadline_ms)`` where ``sampled`` is None on untraced
        frames; other kinds match :meth:`decode_inbound`. None on error."""
        offs = (_U32 * 7)()
        lens = (_U32 * 7)()
        sampled = ctypes.c_int32(-1)
        qos = (ctypes.c_uint64 * 2)()
        rc = self._dll.rn_decode_inbound_qos(
            payload, len(payload), offs, lens, ctypes.byref(sampled), qos
        )
        if rc < 0:
            return None
        if rc == 0:
            spans = [payload[offs[i] : offs[i] + lens[i]] for i in range(4)]
            traced = sampled.value >= 0
            return (
                0,
                *spans,
                payload[offs[4] : offs[4] + lens[4]] if traced else b"",
                payload[offs[5] : offs[5] + lens[5]] if traced else b"",
                bool(sampled.value) if traced else None,
                payload[offs[6] : offs[6] + lens[6]],
                int(qos[0]),
                int(qos[1]),
            )
        n_fields = 3 if rc == 2 else 2
        spans = [payload[offs[i] : offs[i] + lens[i]] for i in range(n_fields)]
        if rc == 2 and sampled.value >= 0:
            spans.extend(
                (
                    payload[offs[4] : offs[4] + lens[4]],
                    payload[offs[5] : offs[5] + lens[5]],
                    bool(sampled.value),
                )
            )
        return (rc, *spans)

    def decode_response(self, payload: bytes):
        """Returns ``(True, body)`` | ``(False, kind, detail, err_payload)`` | None."""
        kind = _U32(0)
        offs = (_U32 * 2)()
        lens = (_U32 * 2)()
        rc = self._dll.rn_decode_response(payload, len(payload), ctypes.byref(kind), offs, lens)
        if rc < 0:
            return None
        if rc == 1:
            return (True, payload[offs[0] : offs[0] + lens[0]])
        return (
            False,
            kind.value,
            payload[offs[0] : offs[0] + lens[0]],
            payload[offs[1] : offs[1] + lens[1]],
        )

    def decode_subresponse(self, payload: bytes):
        """Returns ``(True, mt, body)`` | ``(False, kind, detail, err_payload)`` | None."""
        kind = _U32(0)
        offs = (_U32 * 2)()
        lens = (_U32 * 2)()
        rc = self._dll.rn_decode_subresponse(payload, len(payload), ctypes.byref(kind), offs, lens)
        if rc < 0:
            return None
        if rc == 1:
            return (
                True,
                payload[offs[0] : offs[0] + lens[0]],
                payload[offs[1] : offs[1] + lens[1]],
            )
        return (
            False,
            kind.value,
            payload[offs[0] : offs[0] + lens[0]],
            payload[offs[1] : offs[1] + lens[1]],
        )


class NativeFrameReader:
    """Incremental frame decoder backed by the C++ reader.

    Drop-in for :class:`rio_tpu_torch.codec.FrameReader`.
    """

    def __init__(self, lib: NativeLib | None = None) -> None:
        self._lib = lib or get()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self._handle = self._lib._dll.rn_reader_new()

    def feed(self, data: bytes) -> list[bytes]:
        dll = self._lib._dll
        n = dll.rn_reader_feed(self._handle, data, len(data))
        if n < 0:
            raise SerializationError("incoming frame too large")
        out: list[bytes] = []
        ptr = ctypes.c_void_p()
        ln = _U32(0)
        for _ in range(n):
            if not dll.rn_reader_next(self._handle, ctypes.byref(ptr), ctypes.byref(ln)):
                break
            out.append(ctypes.string_at(ptr, ln.value))
        return out

    def __del__(self) -> None:
        handle, self._handle = getattr(self, "_handle", None), None
        if handle and getattr(self, "_lib", None) is not None:
            self._lib._dll.rn_reader_free(handle)


def engine_profitable() -> bool:
    """Whether the ``auto`` transport should pick the C++ epoll engine.

    The engine's win is running sockets + framing on a separate OS thread,
    overlapping with the interpreter.  MEASURED on a single-core host that
    becomes a pure loss: every message pays ~4 eventfd wakeups / context
    switches of thread ping-pong with nothing to overlap (9.0k msgs/s
    native vs 25k asyncio on the bench box).  So ``auto`` only picks the
    engine when there is real parallelism to exploit; explicit
    ``transport="native"`` always honors the caller.  Override with
    ``RIO_TPU_FORCE_NATIVE=1`` for A/B measurements.
    """
    if os.environ.get("RIO_TPU_FORCE_NATIVE") == "1":
        return get() is not None
    if (os.cpu_count() or 1) < 2:
        return False
    return get() is not None


def get() -> NativeLib | None:
    """Load (building on demand) the native library; None when unavailable."""
    global _lib
    if _lib is not False:
        return _lib  # type: ignore[return-value]
    with _lock:
        if _lib is not False:
            return _lib  # type: ignore[return-value]
        if os.environ.get("RIO_TPU_NATIVE", "1") == "0":
            _lib = None
            return None
        path = _ensure_built()
        if path is None:
            _lib = None
            return None
        try:
            _lib = NativeLib(ctypes.CDLL(str(path)))
        except OSError as e:
            log.warning("failed to load %s: %s", path, e)
            _lib = None
    return _lib
