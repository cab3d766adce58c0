"""Wire protocol: request/response/subscription envelopes.

Mirrors the reference protocol surface (``rio-rs/src/protocol.rs``):

* ``RequestEnvelope{handler_type, handler_id, message_type, payload}``
  (reference ``protocol.rs:9-14``)
* ``ResponseEnvelope{body: Result<bytes, ResponseError>}`` (``:47-49``)
* ``ResponseError`` control-flow variants — ``Redirect``,
  ``DeallocateServiceObject``, ``Allocate``, ``NotSupported``,
  ``ApplicationError(bytes)``, ``Unknown`` (``:78-105``)
* pub/sub ``SubscriptionRequest``/``SubscriptionResponse`` (``:237-258``)

Encoding: each envelope is a positional msgpack array (see
:mod:`rio_tpu_torch.codec`); a ``ResponseEnvelope`` body is a 2-element tagged
array ``[ok: bool, value]`` where the error arm is ``[tag, detail]``.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum
from typing import Any

from . import codec
from .errors import SerializationError


@dataclass
class RequestEnvelope:
    """One actor-addressed request crossing the wire."""

    handler_type: str
    handler_id: str
    message_type: str
    payload: bytes
    # Appended wire-safe field (the appended-field evolution pattern): the caller's
    # trace context ``(trace_id, parent_span_id, sampled)``. ``None`` —
    # the unsampled hot path — is OMITTED from the wire entirely, so an
    # untraced frame is byte-identical to the legacy 4-element layout and
    # old decoders (which reject extra fields) never see it. The C++ codec
    # (native/rio_native.cc) mirrors both arities.
    trace_ctx: tuple[str, str, bool] | None = None
    # QoS classification — same appended-field evolution rule.
    # All three are omitted from the wire when default, so an unclassified
    # frame stays byte-identical to the legacy 4/5-element layouts; when any
    # is set, the trace slot is emitted (``None`` for untraced) to hold its
    # position. ``deadline_ms`` is the REMAINING budget in milliseconds
    # (relative, not a wall-clock deadline — clocks across hosts don't
    # agree); 0 means "no deadline". Internal hops decrement it.
    tenant: str = ""
    priority: int = 0
    deadline_ms: int = 0
    # In-process only — NEVER serialized (`to_bytes` below doesn't emit it,
    # and the positional decode leaves it at the default). The affinity
    # source identity of an internal server-to-self send ("{type}.{id}" of
    # the sending actor); "" means the request arrived over TCP, i.e. from
    # an external client or another node.
    source: str = ""

    def to_bytes(self) -> bytes:
        tc = self.trace_ctx
        if not (self.tenant or self.priority or self.deadline_ms):
            if tc is None:
                return codec.serialize(
                    [self.handler_type, self.handler_id, self.message_type, self.payload]
                )
            return codec.serialize(
                [
                    self.handler_type,
                    self.handler_id,
                    self.message_type,
                    self.payload,
                    [tc[0], tc[1], tc[2]],
                ]
            )
        # QoS-classified frame: the trace slot is emitted (None when
        # untraced) to hold position 4; trailing default QoS fields are
        # truncated so e.g. tenant-only frames stay 6 elements.
        wire: list = [
            self.handler_type,
            self.handler_id,
            self.message_type,
            self.payload,
            None if tc is None else [tc[0], tc[1], tc[2]],
            self.tenant,
            self.priority,
            self.deadline_ms,
        ]
        while wire[-1] in ("", 0) and len(wire) > 6:
            wire.pop()
        return codec.serialize(wire)

    @classmethod
    def from_bytes(cls, data: bytes) -> "RequestEnvelope":
        return codec.deserialize(data, cls)


@dataclass
class CommandEnvelope:
    """One control-plane command crossing the wire (streams/sagas).

    Unlike :class:`RequestEnvelope`, a command is addressed to the *server*
    (``command`` names the verb, ``subject`` scopes it — a stream name, a
    saga id), not to a seated object; the server decides which actor or
    subsystem services it. Commands ride a distinct frame kind
    (:data:`KIND_COMMAND`) so an old server rejects them with a clean
    NOT_SUPPORTED response instead of a garbled request decode.
    """

    command: str
    subject: str
    payload: bytes
    # Same appended-field evolution rule as RequestEnvelope: ``None`` is
    # omitted from the wire so untraced frames stay 3-element.
    trace_ctx: tuple[str, str, bool] | None = None

    def to_bytes(self) -> bytes:
        tc = self.trace_ctx
        if tc is None:
            return codec.serialize([self.command, self.subject, self.payload])
        return codec.serialize(
            [self.command, self.subject, self.payload, [tc[0], tc[1], tc[2]]]
        )

    @classmethod
    def from_bytes(cls, data: bytes) -> "CommandEnvelope":
        return codec.deserialize(data, cls)


class ErrorKind(IntEnum):
    """Wire tags for ``ResponseError`` variants."""

    UNKNOWN = 0
    REDIRECT = 1
    DEALLOCATE = 2
    ALLOCATE = 3
    NOT_SUPPORTED = 4
    APPLICATION = 5
    HANDLER_NOT_FOUND = 6
    SERIALIZATION = 7
    # Overload shed (rio_tpu_torch/load): retryable — the client backs off and
    # retries the request against another member. The C++ codec
    # (native/rio_native.cc) treats the kind as a generic uint, so this
    # needs no structural wire change; tests/test_native.py pins parity.
    SERVER_BUSY = 8
    # QoS deadline shed (rio_tpu_torch/qos): retryable — the caller's remaining
    # budget expired before (or while) the request was queued, so the server
    # refused to burn handler time on a doomed request. Like SERVER_BUSY the
    # kind rides the generic uint slot in the C++ codec unchanged.
    DEADLINE_EXCEEDED = 9


@dataclass
class ResponseError:
    """Structured server→client error; drives client routing decisions.

    ``REDIRECT`` carries the authoritative address in ``detail`` (str);
    ``APPLICATION`` carries the serialized user error in ``payload`` plus the
    user error's type name in ``detail`` for typed re-raising.
    """

    kind: ErrorKind
    detail: str = ""
    payload: bytes = b""

    @classmethod
    def redirect(cls, address: str) -> "ResponseError":
        return cls(ErrorKind.REDIRECT, detail=address)

    @classmethod
    def deallocate(cls) -> "ResponseError":
        return cls(ErrorKind.DEALLOCATE)

    @classmethod
    def allocate(cls, detail: str = "") -> "ResponseError":
        return cls(ErrorKind.ALLOCATE, detail=detail)

    @classmethod
    def not_supported(cls, detail: str = "") -> "ResponseError":
        return cls(ErrorKind.NOT_SUPPORTED, detail=detail)

    @classmethod
    def application(cls, payload: bytes, type_name: str = "") -> "ResponseError":
        return cls(ErrorKind.APPLICATION, detail=type_name, payload=payload)

    @classmethod
    def unknown(cls, detail: str) -> "ResponseError":
        return cls(ErrorKind.UNKNOWN, detail=detail)

    @classmethod
    def server_busy(cls, detail: str = "") -> "ResponseError":
        return cls(ErrorKind.SERVER_BUSY, detail=detail)

    @classmethod
    def deadline_exceeded(cls, detail: str = "") -> "ResponseError":
        return cls(ErrorKind.DEADLINE_EXCEEDED, detail=detail)


@dataclass
class ResponseEnvelope:
    """Result of one request: ``ok`` payload bytes xor a ``ResponseError``."""

    body: bytes | None = None
    error: ResponseError | None = None

    @property
    def is_ok(self) -> bool:
        return self.error is None

    @classmethod
    def ok(cls, body: bytes) -> "ResponseEnvelope":
        return cls(body=body)

    @classmethod
    def err(cls, error: ResponseError) -> "ResponseEnvelope":
        return cls(error=error)

    def to_bytes(self) -> bytes:
        if self.error is None:
            # None normalizes to bin0 (not nil) so asyncio and native servers
            # emit byte-identical frames (native has no nil entry point; both
            # decoders already normalize to b"").
            return codec.serialize([True, self.body or b""])
        return codec.serialize(
            [False, [int(self.error.kind), self.error.detail, self.error.payload]]
        )

    @classmethod
    def from_bytes(cls, data: bytes) -> "ResponseEnvelope":
        wire = codec.deserialize(data, Any)
        if not isinstance(wire, (list, tuple)) or len(wire) != 2:
            raise SerializationError("malformed ResponseEnvelope")
        ok, value = wire
        if ok:
            return cls.ok(value if value is not None else b"")
        kind, detail, payload = value
        return cls.err(ResponseError(ErrorKind(kind), detail, payload))


# ---------------------------------------------------------------------------
# Pub/sub (reference protocol.rs:237-258)
# ---------------------------------------------------------------------------


@dataclass
class SubscriptionRequest:
    """Ask the hosting server to stream an object's published messages."""

    handler_type: str
    handler_id: str

    def to_bytes(self) -> bytes:
        return codec.serialize(self)

    @classmethod
    def from_bytes(cls, data: bytes) -> "SubscriptionRequest":
        return codec.deserialize(data, cls)


@dataclass
class SubscriptionResponse:
    """One published message (or terminal error) on a subscription stream."""

    body: bytes = b""
    message_type: str = ""
    error: ResponseError | None = None

    def to_bytes(self) -> bytes:
        if self.error is None:
            return codec.serialize([True, self.message_type, self.body])
        return codec.serialize(
            [False, [int(self.error.kind), self.error.detail, self.error.payload]]
        )

    @classmethod
    def from_bytes(cls, data: bytes) -> "SubscriptionResponse":
        wire = codec.deserialize(data, Any)
        if not isinstance(wire, (list, tuple)) or len(wire) < 2:
            raise SerializationError("malformed SubscriptionResponse")
        if wire[0]:
            if len(wire) != 3:
                raise SerializationError("malformed SubscriptionResponse ok arm")
            return cls(message_type=wire[1], body=wire[2])
        kind, detail, payload = wire[1]
        return cls(error=ResponseError(ErrorKind(kind), detail, payload))


# ---------------------------------------------------------------------------
# Frame kinds — a connection can carry requests and subscription requests
# (the reference tries bincode-decoding each frame as Request then
# Subscription, service.rs:370-459; we use an explicit 1-byte kind prefix,
# which is cheaper and unambiguous).
# ---------------------------------------------------------------------------

KIND_REQUEST = b"\x00"
KIND_SUBSCRIBE = b"\x01"
KIND_COMMAND = b"\x02"


class UnknownFrameKind(SerializationError):
    """An inbound frame whose 1-byte kind prefix this server does not speak.

    Distinct from a generic decode failure so transports can answer
    NOT_SUPPORTED (a *protocol* gap — the client may downgrade or report
    cleanly) rather than UNKNOWN (a corrupt frame). The connection survives
    either way; the FIFO response contract keeps the stream aligned.
    """

# These helpers are deliberately pure Python.  The C++ codec
# (``rio_tpu_torch.native``) produces byte-identical frames (parity-locked by
# ``tests/test_native.py``) and is used where C++ already owns the buffer
# (the epoll engine's reply fast path); calling it per-frame from Python was
# MEASURED SLOWER than the msgpack C extension — one ctypes round trip costs
# more than packing a request-sized envelope — so the hot path stays here.


def encode_request_frame(env: RequestEnvelope) -> bytes:
    return codec.frame(KIND_REQUEST + env.to_bytes())


def encode_subscribe_frame(req: SubscriptionRequest) -> bytes:
    return codec.frame(KIND_SUBSCRIBE + req.to_bytes())


def encode_command_frame(env: CommandEnvelope) -> bytes:
    return codec.frame(KIND_COMMAND + env.to_bytes())


def encode_response_frame(resp: ResponseEnvelope) -> bytes:
    """Complete response frame (server→client hot path)."""
    return codec.frame(resp.to_bytes())


def encode_subresponse_frame(item: SubscriptionResponse) -> bytes:
    """Complete subscription-stream frame (server→client hot path)."""
    return codec.frame(item.to_bytes())


def decode_response(payload: bytes) -> ResponseEnvelope:
    """Decode a ResponseEnvelope payload (client hot path)."""
    return ResponseEnvelope.from_bytes(payload)


def decode_subresponse(payload: bytes) -> SubscriptionResponse:
    """Decode a SubscriptionResponse payload (client hot path)."""
    return SubscriptionResponse.from_bytes(payload)


def decode_inbound(payload: bytes) -> RequestEnvelope | SubscriptionRequest | CommandEnvelope:
    """Decode one inbound frame payload on the server side."""
    if not payload:
        raise SerializationError("empty frame")
    kind, body = payload[:1], payload[1:]
    if kind == KIND_REQUEST:
        return RequestEnvelope.from_bytes(body)
    if kind == KIND_SUBSCRIBE:
        return SubscriptionRequest.from_bytes(body)
    if kind == KIND_COMMAND:
        return CommandEnvelope.from_bytes(body)
    raise UnknownFrameKind(f"unknown frame kind {kind!r}")
