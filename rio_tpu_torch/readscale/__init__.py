"""Hot-actor read scale-out: bounded-staleness reads from standby replicas.

A single celebrity actor defeats placement — millions of readers hammer one
key, and per-object serialized execution means the owning node can only
shed (ROADMAP "Hot-actor scale-out"). This package turns replication
from a durability feature into the read-scaling story:

1. **API** — ``@readonly`` (rio_tpu_torch/registry/handler.py) marks a handler as
   safe to serve from a standby. Readonly handlers must not mutate state:
   they may be dispatched against a *shadow* instance restored from the
   replica log, where writes would be silently lost.
2. **Staleness contract** — standbys track replica lag as both an
   acked-sequence delta and a wall-clock age
   (:class:`~rio_tpu_torch.replication.ReplicaFreshness`, fed by the
   ``ReplicaAppend`` ship metadata plus payload-less freshness pings on the
   anti-entropy cadence). A standby serves a readonly request only when lag
   is within :class:`ReadScaleConfig` bounds — otherwise it transparently
   proxies the request to the primary. Never an error, never a stale answer
   beyond the configured bound.
3. **Routing** — the primary sheds readonly requests under load with a
   ``SERVER_BUSY`` whose payload names its standby seats; the client caches
   those seats (and can discover them via a ``standby_resolver`` when the
   primary's :class:`~rio_tpu_torch.load.ClusterLoadView` entry runs hot) and
   fans reads across them. A server holding the standby serves the read
   locally instead of redirecting.
4. **Dynamic k** — a hotness detector ticked by the ``LoadMonitor`` loop
   reads per-object request rates from the ``AffinityTracker`` and
   raises/lowers each hot object's replica count within
   ``[k_min, k_max]``; re-seating goes through the existing epoch-fenced
   ``set_standbys`` path (``repair_seats``), with the K-seat anti-affinity
   Sinkhorn solve placing new seats (per-row gauge shift preserved).

Shadow instances live OUTSIDE the registry on purpose: a registry entry
would make ``apply_append`` treat this node as the key's primary and nack
the very log stream the shadow serves from. Shadows load managed state via
``load_state`` and volatile state via ``__restore_state__``, skipping the
``before_load``/``after_load`` hooks (those belong to the real activation's
lifecycle — e.g. timer registration — and must not run on a read-only
ghost).
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field
from typing import Any

from .. import codec
from ..app_data import AppData
from ..cluster.storage import MembershipStorage
from ..journal import READ_PROXY, READ_SHED, REPLICA_K, Journal
from ..object_placement import ObjectPlacement
from ..protocol import (
    ErrorKind,
    RequestEnvelope,
    ResponseEnvelope,
    ResponseError,
    decode_response,
    encode_request_frame,
)
from ..registry import ObjectId, Registry
from ..replication import ReplicationManager

log = logging.getLogger("rio_tpu_torch.readscale")

__all__ = [
    "ReadScaleConfig",
    "ReadScaleManager",
    "ReadScaleStats",
    "decode_seat_hint",
]


@dataclass
class ReadScaleConfig:
    """Knobs for bounded-staleness replica reads (documented in MIGRATING.md)."""

    # Staleness contract: a standby serves a readonly request only while its
    # replica is younger than max_staleness_s (wall clock since last primary
    # contact, local monotonic) AND within max_lag_seq acked writes of the
    # primary's head. 0 lag means "only serve what matches the last ship".
    max_staleness_s: float = 1.0
    max_lag_seq: int = 0
    # Freshness pings ride the anti-entropy loop; the loop cadence is
    # tightened to this at attach time (default max_staleness_s / 3, so a
    # healthy primary keeps standbys inside the bound with margin).
    refresh_interval: float | None = None
    # Primary-side shed: divert readonly requests to standby seats (named in
    # the SERVER_BUSY payload) when the local load monitor says to shed.
    shed_hot_reads: bool = True
    # Client-side routing: how long a shed's seat hint keeps diverting
    # reads, and the ClusterLoadView derate under which a primary counts as
    # hot for proactive standby discovery (1.0 = derate on any load signal,
    # 0.0 = never proactive).
    seat_hint_ttl: float = 2.0
    hot_derate: float = 0.7
    # Dynamic replication factor. hot_rate=None disables the detector; at
    # rate r the target is k_min + floor(r / hot_rate), clamped to
    # [k_min, k_max]. Growth is immediate; shrink steps one seat per tick
    # and only once the rate falls under decay_margin of the level that
    # earned the current k (hysteresis — seat churn is a directory write).
    k_min: int = 1
    k_max: int = 3
    hot_rate: float | None = None
    decay_margin: float = 0.5


@dataclass
class ReadScaleStats:
    """Counters exported through :func:`rio_tpu_torch.otel.stats_gauges`."""

    standby_reads: int = 0  # readonly requests served from a local replica
    standby_forwards: int = 0  # too-stale reads proxied to the primary
    stale_refusals: int = 0  # freshness-gate failures (each becomes a forward)
    read_sheds: int = 0  # primary-side busy sheds naming standby seats
    shadow_activations: int = 0  # shadow instances (re)built from a replica
    forward_failures: int = 0  # proxy attempts degraded to a client redirect
    k_raises: int = 0  # dynamic-k grow transitions
    k_lowers: int = 0  # dynamic-k shrink transitions


def decode_seat_hint(payload: bytes) -> list[str]:
    """Tolerant decode of a SERVER_BUSY seat-hint payload → addresses.

    Garbage (legacy empty payloads, non-list values, malformed entries)
    decodes as "no seats" — the hint is an optimization and must never
    break the client's retry ladder.
    """
    if not payload:
        return []
    try:
        wire = codec.deserialize(payload, Any)
    except Exception:  # noqa: BLE001 — untrusted bytes
        return []
    if not isinstance(wire, (list, tuple)):
        return []
    seats: list[str] = []
    for a in wire:
        if isinstance(a, bytes):
            try:
                a = a.decode()
            except UnicodeDecodeError:
                continue
        if not isinstance(a, str):
            continue
        host, sep, port = a.rpartition(":")
        if sep and host and port.isdigit():
            seats.append(a)
    return seats


@dataclass
class _Shadow:
    """One standby-side read instance, rebuilt when the replica moves."""

    lock: asyncio.Lock = field(default_factory=asyncio.Lock)
    obj: Any = None
    epoch: int = -1
    seq: int = -1
    loaded_mono: float = 0.0


class ReadScaleManager:
    """Per-node read scale-out coordinator; injected into AppData by the Server.

    Three roles: the *standby* role (freshness gate → shadow dispatch, or
    transparent proxy to the primary) in :meth:`try_serve_standby`; the
    *primary* role (shed readonly requests toward the standby seats when
    hot) in :meth:`shed_read`; the *controller* role (dynamic replication
    factor from observed request rates) in :meth:`hotness_tick`.
    """

    def __init__(
        self,
        *,
        address: str,
        registry: Registry,
        replication: ReplicationManager,
        placement: ObjectPlacement,
        members_storage: MembershipStorage,
        app_data: AppData,
        config: ReadScaleConfig | None = None,
    ) -> None:
        self.address = address
        self.registry = registry
        self.replication = replication
        self.placement = placement
        self.members_storage = members_storage
        self.app_data = app_data
        self.config = config or ReadScaleConfig()
        self.stats = ReadScaleStats()
        self._shadows: dict[tuple[str, str], _Shadow] = {}
        self._pools: dict[str, Any] = {}  # forward-proxy conns per primary
        # Controller state: last k decision per object (gauged), and the
        # rate level that earned it (the shrink hysteresis reference).
        self._k_view: dict[tuple[str, str], int] = {}
        self._k_rate: dict[tuple[str, str], float] = {}
        # Control-plane flight recorder: routing DECISIONS (shed, proxy, k
        # change) are journaled; locally served standby reads are not — they
        # are the data path, and the ring must survive a hot key.
        self._journal = app_data.try_get(Journal)
        # Attach to the replication engine: freshness pings keep servable
        # replicas inside the staleness bound while the primary is healthy.
        replication.read_refresh = True
        replication.refresh_interval = (
            self.config.refresh_interval
            if self.config.refresh_interval is not None
            else max(0.05, self.config.max_staleness_s / 3.0)
        )

    # ------------------------------------------------------------------
    # Standby role: serve or forward
    # ------------------------------------------------------------------

    def _is_readonly(self, req: RequestEnvelope) -> bool:
        return self.registry.is_readonly(req.handler_type, req.message_type)

    async def try_serve_standby(
        self, req: RequestEnvelope, object_id: ObjectId
    ) -> ResponseEnvelope | None:
        """Serve a readonly request from a locally-held replica, or proxy it.

        ``None`` falls through to the normal service path — this node is
        the primary (or about to activate as one), or it simply holds no
        replica for the key and the client gets the usual redirect.
        """
        if not self._is_readonly(req):
            return None
        key = (object_id.type_name, object_id.id)
        if self.registry.has(object_id.type_name, object_id.id):
            return None  # primary here: normal dispatch serves it
        entry = self.replication.replica_entry(key)
        if entry is None:
            return None  # not a standby for this key
        fresh = self.replication.replica_freshness(key)
        cfg = self.config
        within_bound = (
            fresh is not None
            and fresh.age_s() <= cfg.max_staleness_s
            and fresh.lag_seq <= cfg.max_lag_seq
        )
        if within_bound:
            payload, epoch, seq = entry
            try:
                resp = await self._serve_shadow(req, object_id, payload, epoch, seq)
            except Exception:  # noqa: BLE001 — the contract is never-an-error
                log.exception("shadow dispatch failed for %s; forwarding", object_id)
                resp = None
            if resp is not None:
                self.stats.standby_reads += 1
                return resp
        else:
            self.stats.stale_refusals += 1
        # Too stale (or the shadow choked): the contract says forward to
        # the primary, never an error and never an answer past the bound.
        self.stats.standby_forwards += 1
        if self._journal is not None:
            fresh_age = round(fresh.age_s(), 4) if fresh is not None else -1.0
            self._journal.record(
                READ_PROXY,
                f"{object_id.type_name}/{object_id.id}",
                stale=not within_bound,
                age_s=fresh_age,
            )
        return await self._forward_to_primary(req, object_id)

    async def _serve_shadow(
        self,
        req: RequestEnvelope,
        object_id: ObjectId,
        payload: bytes,
        epoch: int,
        seq: int,
    ) -> ResponseEnvelope | None:
        spec = self.registry.handler_spec(req.handler_type, req.message_type)
        if spec is None:
            return None
        key = (object_id.type_name, object_id.id)
        shadow = self._shadows.get(key)
        if shadow is None:
            shadow = self._shadows[key] = _Shadow()
        async with shadow.lock:
            now = time.monotonic()
            # Rebuild when the replica advanced, or periodically so managed
            # state (persisted by the primary without a volatile-snapshot
            # change, hence no new seq) obeys the same wall-clock bound.
            if (
                shadow.obj is None
                or (shadow.epoch, shadow.seq) != (epoch, seq)
                or now - shadow.loaded_mono > self.config.max_staleness_s
            ):
                obj = self.registry.new_from_type(object_id.type_name, object_id.id)
                load = getattr(obj, "load_state", None)
                if load is not None:
                    await load(self.app_data)
                restore = getattr(obj, "__restore_state__", None)
                if restore is not None:
                    restore(codec.deserialize(payload, Any))
                shadow.obj, shadow.epoch, shadow.seq = obj, epoch, seq
                shadow.loaded_mono = now
                self.stats.shadow_activations += 1
            # Typed application errors tunnel exactly as primary dispatch
            # would send them; any other exception bubbles to the caller's
            # forward fallback (the primary re-executes authoritatively).
            from ..registry import ERROR_TYPES, encode_error, type_id

            msg = codec.deserialize(req.payload, spec.message_type)
            try:
                result = await spec.fn(shadow.obj, msg, self.app_data)
            except Exception as e:  # noqa: BLE001 — triaged below
                if type_id(type(e)) in ERROR_TYPES:
                    pl, tn = encode_error(e)
                    return ResponseEnvelope.err(ResponseError.application(pl, tn))
                raise
        return ResponseEnvelope.ok(codec.serialize(result))

    async def _forward_to_primary(
        self, req: RequestEnvelope, object_id: ObjectId
    ) -> ResponseEnvelope | None:
        primary = await self.placement.lookup(object_id)
        if (
            primary is None
            or primary == self.address
            or not await self.members_storage.is_active(primary)
        ):
            return None  # normal path resolves (promote / self-assign)
        if req.deadline_ms > 0:
            # Proxy hop propagation: forward the REMAINING budget (strictly
            # decremented by our queue + handler time so far), or refuse a
            # spent one here instead of burning the primary's time on it.
            from ..qos import scope_budget_ms

            budget = scope_budget_ms()
            if budget < 0:
                return ResponseEnvelope.err(
                    ResponseError.deadline_exceeded(
                        "qos: budget spent before proxy hop to primary"
                    )
                )
            if budget > 0:
                from dataclasses import replace

                req = replace(req, deadline_ms=budget)
        try:
            pool = self._pools.get(primary)
            if pool is None:
                from ..client import _ServerConns

                pool = self._pools[primary] = _ServerConns(primary, 2, 0.5)
            conn = await pool.acquire()
            try:
                raw = await conn.roundtrip(encode_request_frame(req))
            except BaseException:
                pool.release(conn, reuse=False)
                raise
            pool.release(conn, reuse=True)
        except Exception:  # noqa: BLE001 — degrade, never error
            self.stats.forward_failures += 1
            self._pools.pop(primary, None)
            return ResponseEnvelope.err(ResponseError.redirect(primary))
        resp = decode_response(raw)
        if resp.error is not None and resp.error.kind == ErrorKind.SERVER_BUSY:
            # Strip any seat hint before relaying: the busy primary may
            # name THIS node, and a client bouncing between us and a shed
            # primary must converge on its own retry ladder instead.
            resp = ResponseEnvelope.err(
                ResponseError.server_busy(resp.error.detail)
            )
        return resp

    # ------------------------------------------------------------------
    # Primary role: shed hot reads toward the standby seats
    # ------------------------------------------------------------------

    def shed_read(
        self, req: RequestEnvelope, object_id: ObjectId, load: Any
    ) -> ResponseError | None:
        """SERVER_BUSY naming read-capable seats, or ``None`` to serve.

        Synchronous on purpose: only the replication manager's seat cache
        is consulted — a directory read per hot-key request would melt the
        backend precisely when this path fires. Seats are only named while
        the key is clean (last ship fully acked), so the primary never
        points readers at a replica it knows is behind.
        """
        cfg = self.config
        if not cfg.shed_hot_reads or load is None:
            return None
        if not self._is_readonly(req):
            return None
        if not self.registry.is_replicated(req.handler_type):
            return None
        reason = load.shed_reason()
        if reason is None:
            return None
        key = (object_id.type_name, object_id.id)
        if key in self.replication._dirty or key not in self.replication._last_shipped:
            return None
        cached = self.replication._seats.get(key)
        if cached is None or not cached[0]:
            return None
        self.stats.read_sheds += 1
        load.stats.sheds += 1
        if self._journal is not None:
            self._journal.record(
                READ_SHED,
                f"{object_id.type_name}/{object_id.id}",
                reason=reason,
                seats=list(cached[0]),
            )
        return ResponseError(
            kind=ErrorKind.SERVER_BUSY,
            detail=f"read diverted: {reason}",
            payload=codec.serialize(list(cached[0])),
        )

    # ------------------------------------------------------------------
    # Controller role: dynamic replication factor
    # ------------------------------------------------------------------

    async def hotness_tick(self, rates: dict[str, float] | None = None) -> int:
        """One detector pass; returns the number of k transitions applied.

        ``rates`` maps ``"{type_name}.{id}"`` (the AffinityTracker observer
        key) to req/sec; tests drive it directly, the LoadMonitor tick
        leaves it ``None`` to read the tracker's folded EMAs.
        """
        cfg = self.config
        if cfg.hot_rate is None or cfg.hot_rate <= 0:
            return 0
        if rates is None:
            tracker = getattr(self.placement, "affinity_tracker", None)
            if tracker is None or not hasattr(tracker, "object_rates"):
                return 0
            rates = tracker.object_rates()
        transitions = 0
        for oid in self.registry.object_ids():
            if not self.registry.is_replicated(oid.type_name):
                continue
            key = (oid.type_name, oid.id)
            rate = rates.get(str(oid), 0.0)
            cur = self.replication.replica_k(key)
            target = min(cfg.k_max, max(cfg.k_min, cfg.k_min + int(rate / cfg.hot_rate)))
            if target > cur:
                desired = target
                self._k_rate[key] = rate
                self.stats.k_raises += 1
            elif target < cur and rate < self._k_rate.get(key, rate) * cfg.decay_margin:
                # One seat per tick: a rate dip must unwind gradually, and
                # only once it falls well under the level that earned the
                # current k (decay_margin hysteresis).
                desired = cur - 1
                self._k_rate[key] = rate / max(cfg.decay_margin, 1e-9)
                self.stats.k_lowers += 1
            else:
                continue
            self.replication.set_replica_k(oid, desired)
            self._k_view[key] = desired
            if self._journal is not None:
                self._journal.record(
                    REPLICA_K,
                    f"{oid.type_name}/{oid.id}",
                    old_k=cur,
                    new_k=desired,
                    rate=round(rate, 3),
                )
            try:
                await self.replication.repair_seats(oid)
            except Exception:  # noqa: BLE001 — re-seat retries next tick
                log.exception("dynamic-k re-seat failed for %s", oid)
            transitions += 1
        return transitions

    # ------------------------------------------------------------------

    def gauges(self) -> dict[str, float]:
        """Staleness + dynamic-k gauges (merged by ``otel.server_gauges``)."""
        out: dict[str, float] = {}
        now = time.monotonic()
        ages = [f.age_s(now) for f in self.replication._replica_meta.values()]
        out["rio.read_scale.replica_staleness_s"] = max(ages) if ages else 0.0
        out["rio.read_scale.replicas_held"] = float(
            len(self.replication._replica_store)
        )
        for (tname, oid), k in self._k_view.items():
            out[f"rio.read_scale.replica_k.{tname}.{oid}"] = float(k)
        return out

    def close(self) -> None:
        for pool in self._pools.values():
            pool.close()
        self._pools.clear()
        self._shadows.clear()
