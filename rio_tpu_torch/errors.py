"""Error taxonomy for rio-tpu.

Mirrors the error surface of the reference framework (rio-rs
``rio-rs/src/errors.rs:10-179``) as idiomatic Python exceptions: every
subsystem raises a typed exception, and the subset of errors that must cross
the wire (handler errors, placement redirects) has a stable wire encoding in
:mod:`rio_tpu_torch.protocol`.
"""

from __future__ import annotations


class RioError(Exception):
    """Base class for all framework errors."""


# ---------------------------------------------------------------------------
# Handler / dispatch errors (reference: errors.rs:10-28 HandlerError)
# ---------------------------------------------------------------------------


class HandlerError(RioError):
    """Errors raised while dispatching a message to a service object."""


class HandlerNotFound(HandlerError):
    """No handler registered for ``(type_name, message_type)``."""


class ObjectNotFound(HandlerError):
    """No live instance for ``(type_name, object_id)`` in this registry."""


class TypeNotFound(HandlerError):
    """``type_name`` has no registered constructor (unknown service type)."""


class ApplicationError(HandlerError):
    """A user handler raised; carries the serialized user error payload.

    The payload is an opaque byte string produced by the server-side codec
    and decoded back into a typed error by the client (reference:
    ``protocol.rs:210-229`` typed-error tunneling).
    """

    def __init__(self, payload: bytes, type_name: str = ""):
        super().__init__(f"application error ({type_name or 'untyped'})")
        self.payload = payload
        self.type_name = type_name


class SerializationError(HandlerError):
    """Message payload could not be (de)serialized."""


class LockError(HandlerError):
    """The per-object lock could not be acquired (shutdown race)."""


# ---------------------------------------------------------------------------
# Lifecycle errors (reference: errors.rs:34-40)
# ---------------------------------------------------------------------------


class ServiceObjectLifeCycleError(RioError):
    """A lifecycle hook (before_load/after_load/...) failed."""


class LoadStateError(RioError):
    """State loading failed for a reason other than missing state."""


class StateNotFound(LoadStateError):
    """No persisted state for ``(object_kind, object_id, state_type)``.

    Tolerated during activation (fresh objects have no state yet); any other
    load error aborts activation.
    """


# ---------------------------------------------------------------------------
# Server / cluster errors (reference: errors.rs:44-179)
# ---------------------------------------------------------------------------


class ServerError(RioError):
    """Server bootstrap/runtime failure (bind, migration, shutdown)."""


class ClientBuilderError(RioError):
    """Client was built with an invalid/missing configuration."""


class MembershipError(RioError):
    """Membership storage operation failed."""


class MembershipReadOnly(MembershipError):
    """Write attempted on a read-only membership view (HTTP members API)."""


class ClusterProviderServeError(RioError):
    """The cluster provider's serve loop failed irrecoverably."""


class ObjectPlacementError(RioError):
    """Placement directory operation failed."""


class NoSchedulableCapacity(ObjectPlacementError, ValueError):
    """A placement solve ran with zero registered nodes.

    Raised by the solver backends (e.g. ``JaxObjectPlacement.assign_batch``)
    when asked to seat objects before any node has registered — typically a
    bring-up ordering bug (placing before ``register_node``/``sync_members``)
    or a cluster that lost every member. Subclasses ``ValueError`` for
    callers that caught the old bare error."""


# ---------------------------------------------------------------------------
# Client-side request errors (reference: protocol.rs:129-159 ClientError)
# ---------------------------------------------------------------------------


class ClientError(RioError):
    """Base for errors surfaced by :class:`rio_tpu_torch.client.Client`."""


class ServerNotAvailable(ClientError):
    """No active server could be reached."""


class Disconnect(ClientError):
    """The connection dropped mid-request."""


class ServerBusy(ClientError):
    """The server shed the request under overload (``ErrorKind.SERVER_BUSY``).

    Retryable: the client's backoff middleware avoids the busy node and
    retries against another member; only after the retry budget is
    exhausted does it surface (wrapped in :class:`RetryExhausted`).
    """

    def __init__(self, address: str = "", detail: str = ""):
        super().__init__(f"server busy at {address or '?'}: {detail or 'overloaded'}")
        self.address = address
        self.detail = detail


class DeadlineExceeded(ClientError):
    """The request's deadline budget expired (``ErrorKind.DEADLINE_EXCEEDED``).

    Raised when a server sheds a request whose remaining ``deadline_ms``
    budget ran out before the handler started (doomed-work shedding,
    rio_tpu_torch/qos), or client-side when the budget is spent before another
    retry attempt could be sent. Retryable only while budget remains.
    """

    def __init__(self, address: str = "", detail: str = ""):
        super().__init__(
            f"deadline exceeded at {address or 'client'}: {detail or 'budget spent'}"
        )
        self.address = address
        self.detail = detail


class RequestTimeout(ClientError):
    """The request did not complete within the configured deadline."""


class RetryExhausted(ClientError):
    """The retry middleware gave up after the configured retry budget."""

    def __init__(self, attempts: int, last: BaseException | None):
        super().__init__(f"retries exhausted after {attempts} attempts: {last!r}")
        self.attempts = attempts
        self.last = last
