"""Wire serialization for rio-tpu.

The reference frames TCP traffic with a 4-byte length prefix and encodes
payloads with bincode (``rio-rs/src/service.rs:370-378``,
``client/mod.rs:199-203``). rio-tpu keeps the same wire shape — length
delimited frames carrying a compact binary payload — but the payload codec is
msgpack-based and schema'd by Python dataclasses instead of serde derives.

Two layers:

* **Value codec** — ``serialize``/``deserialize``: dataclass-aware msgpack.
  Dataclasses are encoded *positionally* (a msgpack array of field values, in
  declaration order), which is bincode-like: compact, no field names on the
  wire, schema evolution by appending optional fields.
* **Framing** — ``FrameReader``/``frame``: 4-byte big-endian length prefix,
  matching tokio's ``LengthDelimitedCodec`` defaults.

A C++ fast path for framing + envelope packing lives in
:mod:`rio_tpu_torch.native`; this module is the always-available reference
implementation and the two are wire-compatible.
"""

from __future__ import annotations

import dataclasses
import struct
import types
import typing
from enum import Enum
from typing import Any, get_args, get_origin, get_type_hints

import msgpack

from .errors import SerializationError

MAX_FRAME = 8 * 1024 * 1024  # tokio LengthDelimitedCodec default max frame


# ---------------------------------------------------------------------------
# Value codec
# ---------------------------------------------------------------------------


# Per-dataclass schema cache: (field name, resolved type hint) in declaration
# order. ``typing.get_type_hints`` re-compiles stringified annotations on
# EVERY call (PEP 563 + ``from __future__ import annotations``) — uncached it
# was ~25% of the request path's CPU.
_DC_SCHEMA: dict[type, tuple[tuple[str, Any], ...]] = {}


def _dc_schema(ty: type) -> tuple[tuple[str, Any], ...]:
    schema = _DC_SCHEMA.get(ty)
    if schema is None:
        hints = get_type_hints(ty)
        schema = tuple((f.name, hints.get(f.name, Any)) for f in dataclasses.fields(ty))
        _DC_SCHEMA[ty] = schema
    return schema


# Encode-side cache: field NAMES only. Encoding never needs resolved hints,
# and get_type_hints raises on annotations that only resolve under
# TYPE_CHECKING — a dataclass like that must still serialize fine.
_DC_FIELD_NAMES: dict[type, tuple[str, ...]] = {}


def _dc_field_names(ty: type) -> tuple[str, ...]:
    names = _DC_FIELD_NAMES.get(ty)
    if names is None:
        names = tuple(f.name for f in dataclasses.fields(ty))
        _DC_FIELD_NAMES[ty] = names
    return names


def _to_wire(value: Any) -> Any:
    """Lower a Python value to msgpack-encodable primitives."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return [_to_wire(getattr(value, name)) for name in _dc_field_names(type(value))]
    if isinstance(value, Enum):
        return value.value
    if isinstance(value, (list, tuple)):
        return [_to_wire(v) for v in value]
    if isinstance(value, set):
        return [_to_wire(v) for v in sorted(value)]
    if isinstance(value, dict):
        return {_to_wire(k): _to_wire(v) for k, v in value.items()}
    if isinstance(value, (str, bytes, bool, int, float)) or value is None:
        return value
    raise SerializationError(f"cannot serialize value of type {type(value)!r}")


def _pack_default(value: Any) -> Any:
    """``msgpack.packb`` hook for the node types msgpack can't pack itself.

    The C packer walks primitives/lists/dicts natively and only calls back
    here for dataclass / Enum / set nodes, so a request-sized message costs
    one ``packb`` call instead of a Python-recursive ``_to_wire`` walk
    (which was the top line of the request-path profile).
    """
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return [getattr(value, name) for name in _dc_field_names(type(value))]
    if isinstance(value, Enum):
        return value.value
    if isinstance(value, (set, frozenset)):
        return sorted(value)
    raise SerializationError(f"cannot serialize value of type {type(value)!r}")


def serialize(value: Any) -> bytes:
    """Encode ``value`` (dataclass, primitive, or container) to bytes.

    Dataclasses encode positionally (bincode-like — no field names on the
    wire)::

        >>> import dataclasses
        >>> from rio_tpu_torch import codec
        >>> @dataclasses.dataclass
        ... class Point:
        ...     x: int = 0
        ...     y: int = 0
        >>> data = codec.serialize(Point(x=3, y=4))
        >>> codec.deserialize(data, Point)
        Point(x=3, y=4)
        >>> codec.deserialize(codec.serialize([1, "two", b"3"]), list)
        [1, 'two', b'3']
    """
    # Eager top-level lowering: message bodies are almost always a single
    # dataclass, and converting it here skips one C->Python default-hook
    # callback per message (the hook still handles nested nodes).  The
    # dict-hit path dodges is_dataclass/isinstance for every known type.
    names = _DC_FIELD_NAMES.get(type(value))
    if names is not None:
        value = [getattr(value, name) for name in names]
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        value = [getattr(value, name) for name in _dc_field_names(type(value))]
    try:
        return msgpack.packb(value, use_bin_type=True, default=_pack_default)
    except (TypeError, ValueError, msgpack.exceptions.PackException) as e:
        raise SerializationError(str(e)) from e


_NONE_TYPE = type(None)


def _from_wire(wire: Any, ty: Any) -> Any:
    """Raise ``wire`` back into the typed value described by ``ty``."""
    if ty is Any or ty is None or ty is _NONE_TYPE:
        return wire
    origin = get_origin(ty)
    if origin is typing.Union or isinstance(ty, types.UnionType):
        args = get_args(ty)
        if wire is None and _NONE_TYPE in args:
            return None
        non_none = [a for a in args if a is not _NONE_TYPE]
        for a in non_none:
            try:
                return _from_wire(wire, a)
            except (SerializationError, TypeError, ValueError):
                continue
        raise SerializationError(f"no Union arm of {ty} matched wire value")
    if origin in (list, tuple, set, frozenset):
        args = get_args(ty)
        if origin is tuple and args and args[-1] is not Ellipsis:
            return tuple(_from_wire(v, a) for v, a in zip(wire, args))
        elem = args[0] if args else Any
        return origin(_from_wire(v, elem) for v in wire)
    if origin is dict:
        args = get_args(ty) or (Any, Any)
        return {_from_wire(k, args[0]): _from_wire(v, args[1]) for k, v in wire.items()}
    if isinstance(ty, type) and issubclass(ty, Enum):
        return ty(wire)
    if dataclasses.is_dataclass(ty):
        if not isinstance(wire, (list, tuple)):
            raise SerializationError(f"expected array for dataclass {ty.__name__}")
        schema = _dc_schema(ty)
        if len(wire) == len(schema):
            # Exact-arity case → compiled decoder (its own fallback only
            # fires on arity mismatch, so this cannot recurse).
            dec = _dc_decoder(ty)
            if dec is not None:
                return dec(wire)
        if len(wire) > len(schema):
            raise SerializationError(
                f"{ty.__name__}: wire has {len(wire)} fields, schema has {len(schema)}"
            )
        kwargs = {
            name: _from_wire(v, hint) for (name, hint), v in zip(schema, wire)
        }
        try:
            return ty(**kwargs)
        except TypeError as e:  # wire too short for the required fields
            raise SerializationError(f"{ty.__name__}: {e}") from e
    if ty is float and isinstance(wire, int):
        return float(wire)
    if ty is bytes and isinstance(wire, str):
        return wire.encode()
    if isinstance(ty, type) and not isinstance(wire, ty):
        raise SerializationError(f"expected {ty.__name__}, got {type(wire).__name__}")
    return wire


# ---------------------------------------------------------------------------
# Compiled per-dataclass decoders.  ``_from_wire`` is a generic recursive
# walker; for the hot path (every request deserializes its message dataclass
# and envelope) we code-generate a flat positional decoder per dataclass —
# the same trick the ``dataclasses`` module uses for ``__init__``.  Semantics
# match ``_from_wire`` exactly; shape mismatches fall back to the generic
# walker (which also carries the schema-evolution rules).
# ---------------------------------------------------------------------------

_DC_DECODERS: dict[type, Any] = {}  # type -> decoder fn, or None (ineligible)


def _compile_dc_decoder(ty: type):
    """Build a positional decoder for ``ty``; None when ineligible."""
    flds = dataclasses.fields(ty)
    if any(not f.init or f.kw_only for f in flds):
        return None  # generic path passes kwargs; keep it for exotic shapes
    try:
        schema = _dc_schema(ty)
    except Exception:  # unresolvable hints (TYPE_CHECKING-only imports)
        return None
    ns: dict[str, Any] = {
        "_ty": ty,
        "_SE": SerializationError,
        "_fw": _from_wire,
        "_isinstance": isinstance,
    }

    def field_lines(i: int, hint: Any) -> list[str]:
        """Unindented decode statements assigning ``v{i}`` from ``w[{i}]``."""
        v = f"v{i}"
        if hint is Any or hint is None or hint is _NONE_TYPE:
            return [f"{v} = w[{i}]"]
        if hint in (int, str, bool):
            ns[f"_h{i}"] = hint
            return [
                f"{v} = w[{i}]",
                f"if not _isinstance({v}, _h{i}):"
                f" raise _SE('expected {hint.__name__}, got %s' % type({v}).__name__)",
            ]
        if hint is float:
            return [
                f"{v} = w[{i}]",
                f"if _isinstance({v}, int): {v} = float({v})",
                f"elif not _isinstance({v}, float):"
                f" raise _SE('expected float, got %s' % type({v}).__name__)",
            ]
        if hint is bytes:
            return [
                f"{v} = w[{i}]",
                f"if not _isinstance({v}, bytes):",
                f"    if _isinstance({v}, str): {v} = {v}.encode()",
                f"    else: raise _SE('expected bytes, got %s' % type({v}).__name__)",
            ]
        # nested dataclass / container / union / enum → generic walker
        ns[f"_h{i}"] = hint
        return [f"{v} = _fw(w[{i}], _h{i})"]

    # Trailing fields with defaults (plain OR factory) may be absent on the
    # wire — the appended-field evolution rule. Handling that HERE keeps a
    # legacy short frame on the compiled fast path: falling back to the
    # generic walker for every old-format message would tax exactly the
    # mixed-version windows where decode throughput matters.
    total = len(schema)
    required = total
    while required > 0 and (
        flds[required - 1].default is not dataclasses.MISSING
        or flds[required - 1].default_factory is not dataclasses.MISSING
    ):
        required -= 1
    lines = ["def _dec(w):", "    n = len(w)"]
    if required == total:
        lines.append(f"    if n != {total}:")
    else:
        lines.append(f"    if n > {total} or n < {required}:")
    lines.append("        return _fw(w, _ty)")  # arity errors
    args = []
    for i, (_name, hint) in enumerate(schema):
        args.append(f"v{i}")
        body = field_lines(i, hint)
        if i < required:
            lines.extend("    " + ln for ln in body)
        else:
            lines.append(f"    if n > {i}:")
            lines.extend("        " + ln for ln in body)
            lines.append("    else:")
            if flds[i].default is not dataclasses.MISSING:
                ns[f"_d{i}"] = flds[i].default
                lines.append(f"        v{i} = _d{i}")
            else:
                # default_factory field: a fresh instance per decode (the
                # dataclass __init__ semantics — sharing one would alias
                # mutable state across messages).
                ns[f"_d{i}"] = flds[i].default_factory
                lines.append(f"        v{i} = _d{i}()")
    lines.append(f"    return _ty({', '.join(args)})")
    exec("\n".join(lines), ns)  # noqa: S102 — trusted, schema-derived source
    return ns["_dec"]


def _dc_decoder(ty: type):
    try:
        return _DC_DECODERS[ty]
    except KeyError:
        dec = _compile_dc_decoder(ty)
        _DC_DECODERS[ty] = dec
        return dec


def deserialize(data: bytes, ty: Any) -> Any:
    """Decode bytes produced by :func:`serialize` into an instance of ``ty``."""
    try:
        wire = msgpack.unpackb(data, raw=False, strict_map_key=False)
    except (ValueError, msgpack.exceptions.UnpackException) as e:
        raise SerializationError(str(e)) from e
    # Dict-hit fast path for known dataclass types (skips the
    # isinstance/is_dataclass pair on the per-message hot path).
    dec = _DC_DECODERS.get(ty)
    if dec is None and isinstance(ty, type) and dataclasses.is_dataclass(ty):
        dec = _dc_decoder(ty)
    if dec is not None:
        if not isinstance(wire, (list, tuple)):
            raise SerializationError(f"expected array for dataclass {ty.__name__}")
        return dec(wire)
    return _from_wire(wire, ty)


# ---------------------------------------------------------------------------
# JSON flavor — used by state persistence (the reference persists actor state
# as serde_json strings, ``rio-rs/src/state/sqlite.rs:54-115``), so stored
# state stays human-inspectable. Dataclasses serialize as *objects* here (not
# positional arrays): durable data should survive field reordering.
# ---------------------------------------------------------------------------

import json as _json


def _json_key(key: Any) -> str:
    if isinstance(key, Enum):
        key = key.value
    if isinstance(key, bool):
        return "true" if key else "false"
    if isinstance(key, (str, int, float)):
        return str(key)
    raise SerializationError(f"cannot json-serialize dict key {type(key)!r}")


def _to_json(value: Any) -> Any:
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {name: _to_json(getattr(value, name)) for name in _dc_field_names(type(value))}
    if isinstance(value, Enum):
        return value.value
    if isinstance(value, (list, tuple, set, frozenset)):
        return [_to_json(v) for v in value]
    if isinstance(value, dict):
        return {_json_key(k): _to_json(v) for k, v in value.items()}
    if isinstance(value, bytes):
        return {"__bytes__": value.hex()}
    if isinstance(value, (str, bool, int, float)) or value is None:
        return value
    raise SerializationError(f"cannot json-serialize {type(value)!r}")


def _key_from_json(key: str, ty: Any) -> Any:
    try:
        if ty is int:
            return int(key)
        if ty is float:
            return float(key)
        if ty is bool:
            return key == "true"
        if isinstance(ty, type) and issubclass(ty, Enum):
            member = next((m for m in ty if str(m.value) == key), None)
            if member is None:
                raise SerializationError(f"no {ty.__name__} member with value {key!r}")
            return member
    except ValueError as e:
        raise SerializationError(f"bad dict key {key!r} for {ty}: {e}") from e
    return key


def _untyped_from_json(wire: Any) -> Any:
    """Recursive Any-typed decode: restore ``__bytes__`` sentinels at any
    depth (lists of rows, nested dicts) — the inverse of ``_to_json`` when
    no schema narrows the shape."""
    if isinstance(wire, dict):
        if set(wire) == {"__bytes__"}:
            try:
                return bytes.fromhex(wire["__bytes__"])
            except (TypeError, ValueError):
                return wire
        return {k: _untyped_from_json(v) for k, v in wire.items()}
    if isinstance(wire, list):
        return [_untyped_from_json(v) for v in wire]
    return wire


def _from_json(wire: Any, ty: Any) -> Any:
    # The bytes sentinel is only honored where the schema expects bytes (or
    # is untyped): a declared dict field can legitimately contain that key.
    if ty is bytes:
        if isinstance(wire, dict) and set(wire) == {"__bytes__"}:
            try:
                return bytes.fromhex(wire["__bytes__"])
            except (TypeError, ValueError) as e:
                raise SerializationError(f"bad __bytes__ payload: {e}") from e
        raise SerializationError("expected bytes sentinel")
    if ty is Any:
        # Untyped: walk containers so NESTED sentinels decode too — a bare
        # ``list`` field holding rows with bytes elements (saga steps) must
        # round-trip through the JSON state providers intact.
        return _untyped_from_json(wire)
    if ty in (list, tuple, set, frozenset):
        # Bare container annotation == container-of-Any.
        if not isinstance(wire, list):
            raise SerializationError(f"expected array for {ty}")
        return ty(_untyped_from_json(v) for v in wire)
    if ty is dict:
        if not isinstance(wire, dict):
            raise SerializationError(f"expected object for {ty}")
        return {k: _untyped_from_json(v) for k, v in wire.items()}
    if get_origin(ty) is typing.Union or isinstance(ty, types.UnionType):
        args = get_args(ty)
        if wire is None and _NONE_TYPE in args:
            return None
        for a in args:
            if a is _NONE_TYPE:
                continue
            try:
                return _from_json(wire, a)
            except (SerializationError, TypeError, ValueError):
                continue
        raise SerializationError(f"no Union arm of {ty} matched JSON value")
    if dataclasses.is_dataclass(ty) and isinstance(wire, dict):
        hints = dict(_dc_schema(ty))
        unknown = set(wire) - set(hints)
        if unknown:
            raise SerializationError(f"{ty.__name__}: unknown state fields {unknown}")
        try:
            return ty(**{k: _from_json(v, hints.get(k, Any)) for k, v in wire.items()})
        except TypeError as e:  # e.g. stored JSON missing a newly required field
            raise SerializationError(f"{ty.__name__}: {e}") from e
    if dataclasses.is_dataclass(ty):
        raise SerializationError(f"expected object for dataclass {ty.__name__}")
    origin = get_origin(ty)
    if origin in (list, tuple, set, frozenset):
        if not isinstance(wire, list):
            raise SerializationError(f"expected array for {ty}")
        args = get_args(ty)
        if origin is tuple and args and args[-1] is not Ellipsis:
            # Heterogeneous tuple: decode element-wise (mirrors _from_wire).
            if len(wire) != len(args):
                raise SerializationError(
                    f"expected {len(args)}-tuple for {ty}, got {len(wire)} items"
                )
            return tuple(_from_json(v, a) for v, a in zip(wire, args))
        elem = (args or (Any,))[0]
        return origin(_from_json(v, elem) for v in wire)
    if origin is dict:
        if not isinstance(wire, dict):
            raise SerializationError(f"expected object for {ty}")
        args = get_args(ty) or (Any, Any)
        return {_key_from_json(k, args[0]): _from_json(v, args[1]) for k, v in wire.items()}
    if isinstance(ty, type) and issubclass(ty, Enum):
        try:
            return ty(wire)
        except ValueError as e:
            raise SerializationError(str(e)) from e
    if ty is float and isinstance(wire, int):
        return float(wire)
    if isinstance(ty, type) and ty is not Any and not isinstance(wire, ty):
        raise SerializationError(f"expected {ty.__name__}, got {type(wire).__name__}")
    return wire


def serialize_json(value: Any) -> str:
    try:
        return _json.dumps(_to_json(value))
    except (TypeError, ValueError) as e:
        raise SerializationError(str(e)) from e


def deserialize_json(data: str, ty: Any) -> Any:
    try:
        wire = _json.loads(data)
    except ValueError as e:
        raise SerializationError(str(e)) from e
    return _from_json(wire, ty)


# ---------------------------------------------------------------------------
# Framing
# ---------------------------------------------------------------------------

_LEN = struct.Struct(">I")


def frame(payload: bytes) -> bytes:
    """Wrap ``payload`` in a 4-byte big-endian length-prefixed frame."""
    if len(payload) > MAX_FRAME:
        raise SerializationError(f"frame too large: {len(payload)} > {MAX_FRAME}")
    return _LEN.pack(len(payload)) + payload


class FrameReader:
    """Incremental length-delimited frame decoder (sans-io).

    Feed raw bytes with :meth:`feed`; completed frames come back as a list.
    Usable both from asyncio protocols and the test harness::

        >>> from rio_tpu_torch.codec import FrameReader, frame
        >>> r = FrameReader()
        >>> stream = frame(b"one") + frame(b"two")
        >>> r.feed(stream[:5])      # a partial frame yields nothing yet
        []
        >>> r.feed(stream[5:])      # completion flushes everything ready
        [b'one', b'two']
    """

    def __init__(self) -> None:
        self._buf = bytearray()

    def feed(self, data: bytes) -> list[bytes]:
        self._buf.extend(data)
        out: list[bytes] = []
        while True:
            if len(self._buf) < 4:
                return out
            (n,) = _LEN.unpack_from(self._buf)
            if n > MAX_FRAME:
                raise SerializationError(f"incoming frame too large: {n}")
            if len(self._buf) < 4 + n:
                return out
            out.append(bytes(self._buf[4 : 4 + n]))
            del self._buf[: 4 + n]


async def read_frame(reader) -> bytes | None:
    """Read one frame from an ``asyncio.StreamReader``; ``None`` on EOF."""
    import asyncio

    try:
        header = await reader.readexactly(4)
    except (asyncio.IncompleteReadError, ConnectionError):
        return None
    (n,) = _LEN.unpack(header)
    if n > MAX_FRAME:
        raise SerializationError(f"incoming frame too large: {n}")
    try:
        return await reader.readexactly(n)
    except (asyncio.IncompleteReadError, ConnectionError):
        return None
