"""Declarative registry + typed client stubs — the ``make_registry!`` layer.

Reference: ``rio-macros/src/registry.rs:88-204`` (docs
``rio-macros/src/lib.rs:190-307``). The Rust macro

.. code-block:: rust

    make_registry! { MetricAggregator: [ Metric => (MetricResponse, NoopError) ] }

expands to a ``server::registry()`` constructor (``add_type`` +
``add_handler`` per pair, with a compile-time ``assert_handler_type``) and a
``client::metric_aggregator::send_metric(client, id, msg)`` typed wrapper
per message. Python has no proc macros, so :func:`make_registry` does the
same work at declaration time: it validates every ``(service, message,
response, error)`` tuple against the service's actual ``@handler`` methods
— raising immediately on mismatch, the runtime analog of the macro's
compile-time assertion (exercised by trybuild in the reference,
``rio-macros/tests/ui.rs``) — and synthesizes the registry factory plus a
typed client-stub namespace.

Usage::

    decl = make_registry({
        MetricAggregator: [
            (Metric, MetricResponse),
            (GetMetric, MetricStats, MetricError),   # optional typed error
        ],
    })
    server = Server(registry=decl.registry(), ...)          # per-server
    stats = await decl.client.metric_aggregator.send_get_metric(
        client, "cpu", GetMetric(...))
"""

from __future__ import annotations

import dataclasses
import re
from types import SimpleNamespace
from typing import Any, Sequence

from . import Registry
from .handler import ERROR_TYPES, HandlerSpec, resolve_handlers
from .identifiable import type_id

__all__ = ["make_registry", "RegistryDeclaration"]


def _snake_case(name: str) -> str:
    s = re.sub(r"(.)([A-Z][a-z]+)", r"\1_\2", name)
    s = re.sub(r"([a-z0-9])([A-Z])", r"\1_\2", s)
    return s.lower()


@dataclasses.dataclass
class _Entry:
    service: type
    spec: HandlerSpec
    response: type
    error: type | None


class RegistryDeclaration:
    """Validated declaration; makes registries and holds typed client stubs."""

    def __init__(self, entries: list[_Entry]):
        self._entries = entries
        self.client = SimpleNamespace()
        services: dict[type, SimpleNamespace] = {}
        for e in entries:
            ns = services.setdefault(e.service, SimpleNamespace())
            setattr(self.client, _snake_case(type_id(e.service)), ns)
            setattr(
                ns,
                f"send_{_snake_case(type_id(e.spec.message_type))}",
                self._make_stub(e),
            )

    @staticmethod
    def _make_stub(e: _Entry):
        svc_name = type_id(e.service)
        response = e.response

        async def send(client: Any, object_id: str, msg: Any) -> Any:
            if not isinstance(msg, e.spec.message_type):
                raise TypeError(
                    f"expected {e.spec.message_type.__name__}, got {type(msg).__name__}"
                )
            return await client.send(svc_name, object_id, msg, returns=response)

        send.__name__ = f"send_{_snake_case(type_id(e.spec.message_type))}"
        send.__doc__ = (
            f"Typed send: {svc_name} <- {type_id(e.spec.message_type)} "
            f"-> {getattr(response, '__name__', response)}"
        )
        return send

    def registry(self) -> Registry:
        """Fresh :class:`Registry` with every declared type + handler
        (one per server, like the generated ``server::registry()``).

        Only *declared* handlers are exposed: undeclared ``@handler`` methods
        on the class stay unreachable over the wire, exactly like the macro,
        whose expansion registers only the listed message types.
        """
        reg = Registry()
        seen: set[type] = set()
        for e in self._entries:
            if e.service not in seen:
                reg.add_type(e.service, auto_handlers=False)
                seen.add(e.service)
            reg.add_handler(e.service, e.spec.message_type, e.spec.fn, returns=e.response)
        return reg

    @property
    def services(self) -> list[type]:
        return list(dict.fromkeys(e.service for e in self._entries))


def make_registry(decl: dict[type, Sequence[tuple]]) -> RegistryDeclaration:
    """Validate a ``{Service: [(Msg, Response[, Error]), ...]}`` declaration.

    Raises ``TypeError`` at declaration time on any mismatch — the runtime
    analog of the macro's compile-time ``assert_handler_type``
    (``rio-macros/src/registry.rs:190-195``):

    * the service has no ``@handler`` for the message type;
    * the handler's return annotation differs from the declared response;
    * the declared error type is not a ``@wire_error``-registered exception.
    """
    entries: list[_Entry] = []
    for service, pairs in decl.items():
        specs = {s.message_type: s for s in resolve_handlers(service)}
        for pair in pairs:
            if len(pair) == 2:
                msg_ty, resp_ty = pair
                err_ty = None
            elif len(pair) == 3:
                msg_ty, resp_ty, err_ty = pair
            else:
                raise TypeError(
                    f"{type_id(service)}: declaration tuples are "
                    f"(Message, Response) or (Message, Response, Error); got {pair!r}"
                )
            spec = specs.get(msg_ty)
            if spec is None:
                raise TypeError(
                    f"{type_id(service)} has no @handler for message "
                    f"{getattr(msg_ty, '__name__', msg_ty)} "
                    f"(handlers exist for: "
                    f"{', '.join(m.__name__ for m in specs) or 'none'})"
                )
            if spec.returns is not Any and resp_ty is not Any and spec.returns != resp_ty:
                raise TypeError(
                    f"{type_id(service)}.{spec.fn.__name__} returns "
                    f"{getattr(spec.returns, '__name__', spec.returns)} but the "
                    f"declaration says {getattr(resp_ty, '__name__', resp_ty)} "
                    "(assert_handler_type)"
                )
            if err_ty is not None:
                if not (isinstance(err_ty, type) and issubclass(err_ty, BaseException)):
                    raise TypeError(
                        f"{type_id(service)}: declared error "
                        f"{getattr(err_ty, '__name__', err_ty)} is not an exception class"
                    )
                if type_id(err_ty) not in ERROR_TYPES:
                    raise TypeError(
                        f"{type_id(service)}: error type {err_ty.__name__} is not "
                        "registered — decorate it with @wire_error so it can "
                        "tunnel across the wire"
                    )
            entries.append(_Entry(service=service, spec=spec, response=resp_ty, error=err_ty))
    return RegistryDeclaration(entries)
