"""Cluster load telemetry & overload control.

rio-rs places objects with a uniform-cost directory lookup and has no
notion of node load; this subsystem adds the measured half of SURVEY §7's
"affinity-aware solve" promise without any new RPCs:

* :class:`LoadMonitor` — one per server: samples event-loop lag, in-flight
  request count, registry size, aggregate request rate (via the placement
  provider's ``AffinityTracker``) and migration ``state_bytes``.
* :class:`LoadVector` — the compact per-node sample. Each node's vector
  **piggybacks on its membership heartbeat row** (``Member.load``), so
  every peer sees every node's load through the storage it already polls.
* :class:`ClusterLoadView` — the derived cluster-wide view, with
  per-entry staleness, built from any ``members()`` read. Garbage from a
  misbehaving peer (NaN, negative, epoch-old) is clamped/defaulted here,
  once, so neither the placement solve nor admission control can be
  poisoned by a bad heartbeat.

Two consumers:

1. ``JaxObjectPlacement.sync_load`` derates a hot node's capacity column
   (:func:`capacity_derate`) so the OT/greedy solves route new and
   rebalanced objects away from overloaded nodes.
2. ``Service`` sheds with the retryable ``ServerBusy`` wire error when
   the LOCAL monitor crosses :class:`LoadThresholds` — peers' vectors
   never trigger shedding, only a node's own measurements do.

Deliberately torch-free: the request path (``service.py``/``server.py``)
imports this module, and that path must never pull in the accelerator
stack.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import math
import sys
import threading
import time
import traceback
from typing import Any, Callable

log = logging.getLogger("rio_tpu_torch.load")

__all__ = [
    "LoadVector",
    "LoadThresholds",
    "LoadMonitor",
    "LoadMonitorStats",
    "ClusterLoadEntry",
    "ClusterLoadView",
    "capacity_derate",
]

#: A heartbeat vector older than this is treated as absent (the node's
#: monitor died, clocks drifted, or a partition froze its row): stale data
#: must not keep derating — or keep flattering — a node indefinitely.
DEFAULT_MAX_STALENESS = 30.0

#: Derate floor: a hot node's capacity column never drops below this
#: fraction, so a load spike can't make a live node vanish from the solve
#: (which would dogpile its whole population onto the rest of the cluster).
MIN_DERATE = 0.1

#: Epochs up to this far in the future count as "now" (cross-host clock
#: skew and encode rounding); beyond it the epoch is garbage and the entry
#: is infinitely stale.
_FUTURE_EPOCH_TOLERANCE = 5.0


def _finite(value: Any, default: float = 0.0, lo: float = 0.0,
            hi: float = 1e18) -> float:
    """One clamp for every untrusted float: NaN/inf/negative/absurd inputs
    all collapse to a sane in-range value instead of propagating."""
    try:
        v = float(value)
    except (TypeError, ValueError):
        return default
    if not math.isfinite(v):
        return default
    return min(max(v, lo), hi)


@dataclasses.dataclass
class LoadVector:
    """One node's compact load sample (what rides the heartbeat row)."""

    loop_lag_ms: float = 0.0  # event-loop scheduling lag, EMA
    inflight: float = 0.0  # requests currently being served
    registry_objects: float = 0.0  # live activations on this node
    req_rate: float = 0.0  # served requests/sec, EMA
    state_bytes: float = 0.0  # migration volatile bytes moved (cumulative)
    epoch: float = 0.0  # unix seconds the sample was taken
    sheds: float = 0.0  # requests refused with ServerBusy (cumulative)
    # Interactive-class QoS pain (cumulative): priority>0 admission sheds
    # plus deadline drops on this node. 0 on nodes without a scheduler.
    qos_interactive: float = 0.0

    # Wire order. Append-only: new fields go at the END (after ``epoch``,
    # even though that reads oddly) so legacy 6-field rows still decode
    # and older readers simply never see the tail.
    _FIELDS = ("loop_lag_ms", "inflight", "registry_objects",
               "req_rate", "state_bytes", "epoch", "sheds",
               "qos_interactive")
    _MIN_FIELDS = 6  # rows this short are the pre-`sheds` legacy format

    def encode(self) -> str:
        """Compact comma-joined form for the heartbeat row.

        Commas only — the Redis backend joins member fields with ``;`` and
        the SQL backends store one TEXT column, so the vector must never
        contain either backend's own separator. 13 significant digits:
        unix-seconds epochs (~1.7e9) need >9 digits just for 1 s staleness
        resolution — ``%.6g`` would round the epoch by up to ~1000 s and
        mark every fresh sample stale."""
        return ",".join(f"{getattr(self, f):.13g}" for f in self._FIELDS)

    @classmethod
    def decode(cls, raw: str | None) -> "LoadVector | None":
        """Tolerant inverse of :meth:`encode`; ``None`` on any malformed
        input (old-format rows, truncation, a peer writing garbage)."""
        if not raw:
            return None
        parts = str(raw).split(",")
        # Tolerant append-only growth: short legacy rows fill missing
        # trailing fields with their defaults; extra trailing fields from
        # a newer sender are ignored.
        if len(parts) < cls._MIN_FIELDS:
            return None
        try:
            values = [float(p) for p in parts[: len(cls._FIELDS)]]
        except ValueError:
            return None
        return cls(**dict(zip(cls._FIELDS, values)))

    def sanitized(self) -> "LoadVector":
        """Every field clamped finite and non-negative (chaos gate: a peer
        publishing NaN/negative values becomes a harmless zero vector)."""
        return LoadVector(
            loop_lag_ms=_finite(self.loop_lag_ms, hi=1e9),
            inflight=_finite(self.inflight, hi=1e9),
            registry_objects=_finite(self.registry_objects, hi=1e12),
            req_rate=_finite(self.req_rate, hi=1e9),
            state_bytes=_finite(self.state_bytes),
            epoch=_finite(self.epoch),
            sheds=_finite(self.sheds, hi=1e12),
            qos_interactive=_finite(self.qos_interactive, hi=1e12),
        )


def capacity_derate(
    vector: "LoadVector | None",
    *,
    lag_scale: float = 100.0,
    inflight_scale: float = 256.0,
) -> float:
    """Measured-load multiplier for a node's solver capacity column.

    ``1.0`` for an idle (or unreported) node, sliding toward
    :data:`MIN_DERATE` as event-loop lag and in-flight depth grow past
    their scales. Monotone and bounded: no input, however corrupt, can
    push the result outside ``[MIN_DERATE, 1.0]``.
    """
    if vector is None:
        return 1.0
    v = vector.sanitized()
    pressure = v.loop_lag_ms / lag_scale + v.inflight / inflight_scale
    return max(MIN_DERATE, 1.0 / (1.0 + pressure))


@dataclasses.dataclass
class ClusterLoadEntry:
    """One member's vector as seen from here, with how old it is."""

    address: str
    load: LoadVector
    staleness: float  # seconds between the sample's epoch and the read
    stale: bool  # past max_staleness: treat as unreported

    @property
    def derate(self) -> float:
        return 1.0 if self.stale else capacity_derate(self.load)


class ClusterLoadView:
    """Every node's load, derived from one membership read — no new RPCs.

    Built by anyone holding a ``members()`` result (the placement daemon's
    poll, the monitor's refresh tick, a test). All sanitization lives
    here: entries are clamped on the way in, staleness is computed against
    one consistent ``now``, and consumers only ever see safe values.
    """

    def __init__(self, entries: dict[str, ClusterLoadEntry], now: float) -> None:
        self.entries = entries
        self.now = now

    @classmethod
    def from_members(
        cls,
        members,
        *,
        now: float | None = None,
        max_staleness: float = DEFAULT_MAX_STALENESS,
    ) -> "ClusterLoadView":
        """``members`` is any iterable of objects with ``address`` and an
        optional ``load`` attribute (the encoded string, a
        :class:`LoadVector`, or absent)."""
        now = time.time() if now is None else now
        entries: dict[str, ClusterLoadEntry] = {}
        for m in members:
            addr = getattr(m, "address", None)
            if callable(addr):
                addr = addr()
            if not addr:
                continue
            raw = getattr(m, "load", None)
            vec = raw if isinstance(raw, LoadVector) else LoadVector.decode(raw)
            if vec is None:
                continue
            vec = vec.sanitized()
            # A zero or far-future epoch is itself garbage: count it as
            # maximally stale rather than "fresh forever". Small future
            # skew is legitimate (cross-host clocks, plus the encode
            # rounding) and clamps to 0.
            ahead = vec.epoch - now
            if vec.epoch <= 0.0 or ahead > _FUTURE_EPOCH_TOLERANCE:
                staleness = math.inf
            else:
                staleness = max(0.0, -ahead)
            entries[str(addr)] = ClusterLoadEntry(
                address=str(addr),
                load=vec,
                staleness=staleness,
                stale=staleness > max_staleness,
            )
        return cls(entries, now)

    def get(self, address: str) -> ClusterLoadEntry | None:
        return self.entries.get(address)

    def derate(self, address: str) -> float:
        """Capacity multiplier for ``address`` (1.0 when unknown/stale)."""
        entry = self.entries.get(address)
        return 1.0 if entry is None else entry.derate

    def gauges(self) -> dict[str, float]:
        """Flat per-member gauge dict (``rio.cluster_load.<addr>.<field>``),
        the shape :func:`rio_tpu_torch.otel.stats_gauges` produces — scrape loops
        and the observability example's delta reader consume it directly."""
        out: dict[str, float] = {}
        for addr, e in self.entries.items():
            base = f"rio.cluster_load.{addr}"
            out[f"{base}.loop_lag_ms"] = e.load.loop_lag_ms
            out[f"{base}.inflight"] = e.load.inflight
            out[f"{base}.registry_objects"] = e.load.registry_objects
            out[f"{base}.req_rate"] = e.load.req_rate
            out[f"{base}.state_bytes"] = e.load.state_bytes
            out[f"{base}.sheds"] = e.load.sheds
            out[f"{base}.qos_interactive"] = e.load.qos_interactive
            out[f"{base}.staleness"] = (
                -1.0 if math.isinf(e.staleness) else e.staleness
            )
            out[f"{base}.derate"] = e.derate
        out.update(self.aggregate_gauges())
        return out

    def aggregate_gauges(self) -> dict[str, float]:
        """Cluster-wide rollups (``rio.cluster.*``), the gauges trend rules
        and the autoscale policy select with fnmatch like any per-node one.

        Only FRESH entries contribute to means/totals — a node whose
        heartbeat vector went stale (monitor died, partition froze the
        row) must neither drag the mean down nor pin a total up; it is
        counted separately in ``rio.cluster.nodes_stale``.
        """
        fresh = [e for e in self.entries.values() if not e.stale]
        out = {
            "rio.cluster.nodes": float(len(fresh)),
            "rio.cluster.nodes_stale": float(len(self.entries) - len(fresh)),
            "rio.cluster.loop_lag_mean_ms": 0.0,
            "rio.cluster.loop_lag_max_ms": 0.0,
            "rio.cluster.inflight_total": 0.0,
            "rio.cluster.req_rate_total": 0.0,
            "rio.cluster.registry_objects_total": 0.0,
            "rio.cluster.sheds_total": 0.0,
            "rio.cluster.qos_interactive_total": 0.0,
        }
        if not fresh:
            return out
        lags = [e.load.loop_lag_ms for e in fresh]
        out["rio.cluster.loop_lag_mean_ms"] = sum(lags) / len(lags)
        out["rio.cluster.loop_lag_max_ms"] = max(lags)
        out["rio.cluster.inflight_total"] = sum(e.load.inflight for e in fresh)
        out["rio.cluster.req_rate_total"] = sum(e.load.req_rate for e in fresh)
        out["rio.cluster.registry_objects_total"] = sum(
            e.load.registry_objects for e in fresh
        )
        out["rio.cluster.sheds_total"] = sum(e.load.sheds for e in fresh)
        out["rio.cluster.qos_interactive_total"] = sum(
            e.load.qos_interactive for e in fresh
        )
        return out

    def __len__(self) -> int:
        return len(self.entries)


@dataclasses.dataclass
class LoadThresholds:
    """Admission-control limits; crossing ANY enabled one sheds new
    requests with the retryable ``ServerBusy`` wire error. ``None``
    disables that check; the all-``None`` default never sheds (telemetry
    stays on either way)."""

    max_loop_lag_ms: float | None = None
    max_inflight: int | None = None
    max_registry_objects: int | None = None


@dataclasses.dataclass
class LoadMonitorStats:
    """Counters exported through :func:`rio_tpu_torch.otel.stats_gauges`."""

    samples: int = 0
    sheds: int = 0  # requests refused with ServerBusy
    stalls: int = 0  # loop stalls caught with a stack by the watchdog
    loop_lag_ms: float = 0.0
    inflight: int = 0
    registry_objects: int = 0
    req_rate: float = 0.0
    state_bytes: float = 0.0
    view_members: int = 0  # entries in the last derived ClusterLoadView


class _StallWatchdog(threading.Thread):
    """Off-loop daemon thread that catches the event loop mid-stall.

    Loop-lag EMAs say a stall HAPPENED; they cannot say what the loop was
    doing. This thread watches the heartbeat timestamp :meth:`LoadMonitor.
    run` refreshes each tick; when the beat goes quiet past the threshold
    the loop thread is still stuck inside whatever blocked it — so
    ``sys._current_frames()`` names the culprit. The captured stack is
    parked on the monitor (this thread NEVER touches the journal — rings
    are loop-thread-only) and journaled as a HEALTH event on the loop's
    next tick, cooldown-limited so a grinding server logs one stack per
    window, not one per poll.
    """

    def __init__(
        self, monitor: "LoadMonitor", loop_thread_ident: int, interval: float
    ) -> None:
        super().__init__(name="rio-tpu-stall-watchdog", daemon=True)
        self.monitor = monitor
        self.loop_ident = loop_thread_ident
        self.interval = interval
        self.stop_event = threading.Event()

    def run(self) -> None:
        m = self.monitor
        threshold_s = m.stall_threshold_ms / 1e3
        last_fire = float("-inf")
        while not self.stop_event.wait(max(0.05, threshold_s / 2)):
            beat = m._heartbeat
            if beat is None:
                continue
            # The loop owes us a beat every `interval`; anything past that
            # plus the threshold is a stall in progress RIGHT NOW.
            now = time.monotonic()
            stall_s = now - beat - self.interval
            if stall_s < threshold_s:
                continue
            if now - last_fire < m.stall_cooldown or m._pending_stall is not None:
                continue
            frame = sys._current_frames().get(self.loop_ident)
            if frame is None:
                continue
            last_fire = now
            m._pending_stall = {
                "stall_ms": round(stall_s * 1e3, 1),
                "stack": "".join(traceback.format_stack(frame, limit=24)),
            }


class LoadMonitor:
    """Per-server load sampler + admission-control gate.

    Wired automatically by :class:`rio_tpu_torch.server.Server`; the service
    layer calls :meth:`request_started`/:meth:`request_finished` around
    every dispatch (sync, O(1)) and :meth:`shed_reason` before admitting
    one. :meth:`run` is a server child task: each tick it measures
    event-loop lag (scheduling drift across its own sleep), folds the
    affinity tracker's request-rate window, and periodically derives the
    node's :class:`ClusterLoadView` from membership storage, feeding it to
    the placement provider's ``sync_load`` when the provider has one.
    """

    def __init__(
        self,
        *,
        registry=None,
        affinity_tracker=None,
        migration_stats: Callable[[], Any] | None = None,
        members_storage=None,
        placement=None,
        thresholds: LoadThresholds | None = None,
        interval: float = 1.0,
        view_interval: float = 2.0,
        max_staleness: float = DEFAULT_MAX_STALENESS,
        lag_ema: float = 0.3,
        journal=None,
        stall_threshold_ms: float = 500.0,
        stall_cooldown: float = 30.0,
    ) -> None:
        self.registry = registry
        self.affinity_tracker = affinity_tracker
        self._migration_stats = migration_stats
        self.members_storage = members_storage
        self.placement = placement
        self.thresholds = thresholds or LoadThresholds()
        self.interval = interval
        self.view_interval = view_interval
        self.max_staleness = max_staleness
        self._lag_ema = lag_ema
        self.stats = LoadMonitorStats()
        self.inflight = 0
        self.requests_total = 0
        self._rate_marker = 0  # requests_total at the previous sample
        self._last_sample: float | None = None
        self.cluster_view: ClusterLoadView | None = None
        # Optional read-scale hook: an object exposing ``hotness_tick()``
        # (rio_tpu_torch.readscale.ReadScaleManager), ticked once per sample so
        # dynamic replica counts ride the existing loop — no new task.
        self.hotness_detector: Any = None
        # Optional QoS scheduler handle (rio_tpu_torch.qos.QosScheduler, wired by
        # the Server when both subsystems are enabled): its interactive
        # shed/drop counters ride the heartbeat vector so the autoscale
        # policy can weight pressure by interactive-class pain.
        self.qos: Any = None
        # Sync per-sample callbacks riding the same cadence (the series
        # sampler and HealthWatch, wired by Server.run); each is isolated
        # like the hotness tick — a failing ticker must not stop sampling.
        self.tickers: list = []
        # Loop-stall watchdog (``_StallWatchdog``): 0 disables. The
        # heartbeat/pending handshake is two attribute stores — the
        # watchdog thread only ever reads/writes these, never the journal.
        self.journal = journal
        self.stall_threshold_ms = float(stall_threshold_ms)
        self.stall_cooldown = float(stall_cooldown)
        self._heartbeat: float | None = None
        self._pending_stall: dict | None = None

    # -- request-path hooks (sync, called per dispatch) ---------------------

    def request_started(self) -> None:
        self.inflight += 1
        self.requests_total += 1

    def request_finished(self) -> None:
        self.inflight = max(0, self.inflight - 1)

    def shed_reason(self) -> str | None:
        """A human-readable overload reason, or ``None`` to admit.

        Reads only LOCAL measurements — a peer's (possibly garbage) load
        vector can never trip this."""
        t = self.thresholds
        if t.max_inflight is not None and self.inflight > t.max_inflight:
            return f"inflight {self.inflight} > {t.max_inflight}"
        if (
            t.max_loop_lag_ms is not None
            and self.stats.loop_lag_ms > t.max_loop_lag_ms
        ):
            return (
                f"loop lag {self.stats.loop_lag_ms:.0f}ms > "
                f"{t.max_loop_lag_ms:.0f}ms"
            )
        if t.max_registry_objects is not None and self.registry is not None:
            n = self.registry.count_objects()
            if n > t.max_registry_objects:
                return f"registry {n} > {t.max_registry_objects}"
        return None

    # -- sampling -----------------------------------------------------------

    def _sample(self, lag_ms: float) -> None:
        s = self.stats
        now = time.monotonic()
        s.samples += 1
        s.loop_lag_ms = (1 - self._lag_ema) * s.loop_lag_ms + self._lag_ema * max(
            0.0, lag_ms
        )
        s.inflight = self.inflight
        # Aggregate rate from the monitor's own counter (present on every
        # server); the tracker's per-object window additionally feeds the
        # solver's move weights when the provider carries one.
        if self._last_sample is not None and now > self._last_sample:
            inst = (self.requests_total - self._rate_marker) / (
                now - self._last_sample
            )
            s.req_rate = (1 - self._lag_ema) * s.req_rate + self._lag_ema * inst
        self._rate_marker = self.requests_total
        self._last_sample = now
        if self.registry is not None:
            s.registry_objects = self.registry.count_objects()
        tracker = self.affinity_tracker
        if tracker is not None and hasattr(tracker, "fold_rates"):
            tracker.fold_rates()
        if self._migration_stats is not None:
            mst = self._migration_stats()
            if mst is not None:
                s.state_bytes = float(getattr(mst, "state_bytes", 0.0))

    def snapshot(self) -> LoadVector:
        """The node's current vector (what the heartbeat publishes)."""
        s = self.stats
        qos = self.qos
        qos_interactive = 0.0
        if qos is not None:
            qs = qos.stats
            qos_interactive = float(qs.interactive_sheds + qs.deadline_drops)
        return LoadVector(
            loop_lag_ms=s.loop_lag_ms,
            inflight=float(self.inflight),
            registry_objects=float(s.registry_objects),
            req_rate=s.req_rate,
            state_bytes=s.state_bytes,
            epoch=time.time(),
            sheds=float(s.sheds),
            qos_interactive=qos_interactive,
        )

    def encoded_snapshot(self) -> str:
        """``snapshot().encode()`` — the zero-arg form cluster providers
        call per heartbeat tick."""
        return self.snapshot().encode()

    async def _refresh_view(self) -> None:
        if self.members_storage is None:
            return
        members = await self.members_storage.members()
        view = ClusterLoadView.from_members(
            members, max_staleness=self.max_staleness
        )
        self.cluster_view = view
        self.stats.view_members = len(view)
        placement = self.placement
        if placement is not None and hasattr(placement, "sync_load"):
            placement.sync_load(view)

    def _drain_pending_stall(self) -> None:
        """Journal a watchdog capture from the loop thread (ring discipline:
        only the loop appends; the watchdog merely parks the evidence)."""
        pending = self._pending_stall
        if pending is None:
            return
        self._pending_stall = None
        self.stats.stalls += 1
        log.warning(
            "event-loop stall %.0f ms; loop thread was at:\n%s",
            pending["stall_ms"], pending["stack"],
        )
        if self.journal is not None:
            from ..journal import HEALTH

            self.journal.record(
                HEALTH,
                "loop_stall",
                stall_ms=pending["stall_ms"],
                stack=pending["stack"],
            )

    async def run(self) -> None:
        """Sampling loop; runs until cancelled (a ``Server.run`` child)."""
        loop = asyncio.get_running_loop()
        last_view = float("-inf")
        watchdog = None
        if self.stall_threshold_ms > 0:
            self._heartbeat = time.monotonic()
            watchdog = _StallWatchdog(self, threading.get_ident(), self.interval)
            watchdog.start()
        try:
            await self._run(loop, last_view)
        finally:
            if watchdog is not None:
                watchdog.stop_event.set()

    async def _run(self, loop, last_view: float) -> None:
        while True:
            t0 = loop.time()
            await asyncio.sleep(self.interval)
            # Scheduling drift across our own sleep IS event-loop lag: a
            # loop starved by slow callbacks wakes us late by that much.
            lag_ms = max(0.0, (loop.time() - t0 - self.interval)) * 1e3
            self._sample(lag_ms)
            self._heartbeat = time.monotonic()
            self._drain_pending_stall()
            detector = self.hotness_detector
            if detector is not None:
                try:
                    await detector.hotness_tick()
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001 — sampling must not die
                    log.exception("hotness detector tick failed")
            for ticker in self.tickers:
                try:
                    ticker()
                except Exception:  # noqa: BLE001 — sampling must not die
                    log.exception("load-loop ticker failed")
            if loop.time() - last_view >= self.view_interval:
                last_view = loop.time()
                try:
                    await self._refresh_view()
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001 — sampling must not die
                    pass
