"""HealthWatch: trend rules over the gauge time-series rings.

The operational lesson of the TPU runs is that this system degrades
measurably before it fails — pull latency 349→747 ms and compile 66→106 s
across nominally healthy runs, with "rising latency means stop launching
now" the heuristic that kept the relay alive. This module productizes
that heuristic for the serving plane: a small rule engine that ticks
beside the :class:`~rio_tpu_torch.load.LoadMonitor`, evaluates trends over the
node's :class:`~rio_tpu_torch.timeseries.GaugeSeries` window, and raises
alarms while the node is still serving — not after it stops.

Alarms surface on every existing observability plane at once:

* a ``HEALTH`` event in the control-plane journal (``rio_tpu_torch/journal.py``),
  carrying the offending gauge, its value, and — for handler-latency
  rules — the RED histogram's exemplar trace id, so ``admin explain``
  style tooling can jump from "p99 is rising" to one slow request;
* ``rio.health.*`` gauges (scraped by ``otel.server_gauges``, exported by
  the OTLP loop, visible in ``admin stats``/``watch``);
* the ``SeriesSnapshot.meta`` of ``DumpSeries`` scrapes (the ``watch``
  CLI prints active alerts beside the trend table).

Rules are data (:class:`TrendRule`), matched against gauge names with
``fnmatch`` patterns; :func:`default_rules` encodes the stock alarm set
(p99 rising, loop-lag rising, journal drops, busy sheds, solver residual
divergence, solve-time drift). The engine is deliberately boring: pure
host Python over a bounded window, no deps, never blocks the loop.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from fnmatch import fnmatchcase
from typing import Any, Callable, Iterable

from .journal import HEALTH, Journal
from .timeseries import (
    GaugeSeries,
    SeriesSample,
    falling_streak,
    rising_streak,
    series_values,
)

__all__ = ["TrendRule", "HealthAlert", "HealthWatch", "default_rules"]


@dataclass(frozen=True)
class TrendRule:
    """One degradation rule: a trend predicate over matching gauges.

    ``gauge`` is an ``fnmatch`` pattern over gauge names (so
    ``rio.handler.*.p99_ms`` covers every handler). Kinds:

    * ``rising`` — the gauge rose ``windows`` consecutive samples, each
      step by more than ``min_delta`` (jitter floor).
    * ``falling`` — the mirror: the gauge FELL ``windows`` consecutive
      samples, each step by more than ``min_delta`` (scale-in style
      signals: "load has been dropping for K windows").
    * ``delta`` — the gauge moved by more than ``min_delta`` across the
      window (monotonic counters: journal drops, busy sheds).
    * ``drift`` — the newest value exceeds ``factor`` × the window mean
      of the prior values plus ``min_delta`` (solve-time drift; the
      absolute floor keeps micro-latencies from tripping the ratio).
    """

    name: str
    gauge: str
    kind: str = "rising"  # rising | falling | delta | drift
    windows: int = 3  # K consecutive samples (rising) / lookback (others)
    min_delta: float = 0.0
    factor: float = 2.0  # drift multiplier
    cooldown: int = 10  # min samples between journal re-fires per gauge


@dataclass
class HealthAlert:
    """One fired (or still-active) alarm instance."""

    rule: str
    gauge: str
    value: float
    detail: str = ""
    seq: int = 0  # series sample seq at evaluation
    trace_id: str = ""  # exemplar trace for handler-latency rules


def default_rules(
    *,
    windows: int = 3,
    p99_min_delta_ms: float = 0.5,
    lag_min_delta_ms: float = 0.5,
    solve_drift_factor: float = 2.0,
) -> list[TrendRule]:
    """The stock alarm set: every signal the TPU rounds and the
    serving plane have actually seen degrade before failure."""
    return [
        TrendRule(
            name="p99_rising",
            gauge="rio.handler.*.p99_ms",
            kind="rising",
            windows=windows,
            min_delta=p99_min_delta_ms,
        ),
        TrendRule(
            name="loop_lag_rising",
            gauge="rio.load.loop_lag_ms",
            kind="rising",
            windows=windows,
            min_delta=lag_min_delta_ms,
        ),
        TrendRule(
            name="journal_dropped",
            gauge="rio.journal.dropped",
            kind="delta",
            windows=windows,
            min_delta=0.0,  # ANY drop growth is signal (ring overflow)
        ),
        TrendRule(
            name="shed_rate",
            gauge="rio.load.sheds",
            kind="delta",
            windows=windows,
            min_delta=0.0,
        ),
        TrendRule(
            name="qos_shed_rising",
            gauge="rio.qos.sheds",
            kind="delta",
            windows=windows,
            # Any growth in QoS admission sheds (token bucket / full class
            # queue) is signal: some tenant is being turned away at the
            # door — check `admin qos` for who and rebalance weights/rates.
            min_delta=0.0,
        ),
        TrendRule(
            name="deadline_exceeded_rising",
            gauge="rio.qos.deadline_drops",
            kind="delta",
            windows=windows,
            # Budgets expiring before handler start means queue wait is
            # eating callers' deadlines — the node is slower than its
            # clients assume (capacity, or a bulk tenant starving the
            # fair ring despite weighting).
            min_delta=0.0,
        ),
        TrendRule(
            name="residual_diverging",
            gauge="rio.placement_solve.residual",
            kind="rising",
            windows=windows,
            min_delta=0.0,
        ),
        TrendRule(
            name="storage_errors",
            gauge="rio.storage.errors",
            kind="delta",
            windows=windows,
            min_delta=0.0,  # any growth in rendezvous-storage failures
        ),
        TrendRule(
            name="solve_ms_drift",
            gauge="rio.placement_solve.solve_ms",
            kind="drift",
            windows=windows,
            factor=solve_drift_factor,
            min_delta=5.0,  # ignore drift below 5 ms absolute
        ),
        TrendRule(
            name="cluster_load_falling",
            gauge="rio.cluster.loop_lag_mean_ms",
            kind="falling",
            windows=windows,
            # The scale-in style signal: cluster-mean loop lag
            # dropping K consecutive windows means offered load is
            # receding — informational here; the autoscale policy runs
            # its own copy over the controller's pressure series.
            min_delta=lag_min_delta_ms,
        ),
        TrendRule(
            name="cross_node_bytes_rising",
            gauge="rio.affinity.cross_bytes_per_s",
            kind="rising",
            windows=windows,
            # Jitter floor well above sampler noise: sustained growth in
            # actor-to-actor bytes crossing TCP means placement has
            # drifted away from the traffic pattern — time to feed the
            # merged edge graph back into the solver (`admin edges`,
            # set_edge_graph + rebalance).
            min_delta=1024.0,
        ),
    ]


class HealthWatch:
    """Evaluate :class:`TrendRule`s over a node's gauge series each tick.

    Single-threaded by construction: ``tick`` runs on the server loop
    (driven by the LoadMonitor's cadence, right after the series sampler),
    reads only the ring snapshot, and does bounded host arithmetic.
    """

    def __init__(
        self,
        series: GaugeSeries,
        *,
        journal: Journal | None = None,
        exemplars: Callable[[], dict[str, str]] | None = None,
        rules: Iterable[TrendRule] | None = None,
        window: int = 32,
    ) -> None:
        self.series = series
        self.journal = journal
        self._exemplars = exemplars
        self.rules: list[TrendRule] = list(
            default_rules() if rules is None else rules
        )
        self._window = max(2, int(window))
        # (rule, gauge) -> sample seq of the last journal fire (cooldown).
        self._last_fire: dict[tuple[str, str], int] = {}
        # Currently-true alarm instances, refreshed every tick.
        self.active: list[HealthAlert] = []
        self.fired_total = 0  # journal HEALTH events emitted (post-cooldown)

    # -- evaluation ----------------------------------------------------------

    def tick(self) -> list[HealthAlert]:
        """Re-evaluate every rule; journal newly-fired alarms; return the
        currently-active set (also kept on ``self.active``)."""
        samples = self.series.window(limit=self._window)
        if len(samples) < 2:
            self.active = []
            return []
        seq = samples[-1].seq
        names = self._gauge_names(samples)
        active: list[HealthAlert] = []
        for rule in self.rules:
            for gauge in names:
                if not fnmatchcase(gauge, rule.gauge):
                    continue
                alert = self._evaluate(rule, gauge, samples, seq)
                if alert is None:
                    continue
                active.append(alert)
                self._maybe_fire(rule, alert)
        self.active = active
        return active

    @staticmethod
    def _gauge_names(samples: list[SeriesSample]) -> list[str]:
        names: set[str] = set()
        for s in samples:
            names.update(s.gauges)
        return sorted(names)

    def _evaluate(
        self,
        rule: TrendRule,
        gauge: str,
        samples: list[SeriesSample],
        seq: int,
    ) -> HealthAlert | None:
        vals = series_values(samples, gauge)
        if len(vals) < 2:
            return None
        if rule.kind == "rising":
            streak = rising_streak(vals, rule.min_delta)
            if streak < rule.windows:
                return None
            detail = f"rose {streak} consecutive windows to {vals[-1]:g}"
        elif rule.kind == "falling":
            streak = falling_streak(vals, rule.min_delta)
            if streak < rule.windows:
                return None
            detail = f"fell {streak} consecutive windows to {vals[-1]:g}"
        elif rule.kind == "delta":
            lookback = vals[-(rule.windows + 1) :]
            moved = lookback[-1] - lookback[0]
            if moved <= rule.min_delta:
                return None
            detail = f"moved +{moved:g} over {len(lookback) - 1} windows"
        elif rule.kind == "drift":
            prior = vals[:-1]
            if len(prior) < rule.windows:
                return None
            mean = sum(prior) / len(prior)
            if vals[-1] <= rule.factor * mean + rule.min_delta:
                return None
            detail = f"{vals[-1]:g} vs window mean {mean:g} (x{rule.factor:g})"
        else:  # unknown kind: a misconfigured rule must not take the node down
            return None
        return HealthAlert(
            rule=rule.name,
            gauge=gauge,
            value=float(vals[-1]),
            detail=detail,
            seq=seq,
            trace_id=self._exemplar_for(gauge),
        )

    def _exemplar_for(self, gauge: str) -> str:
        """Exemplar trace id for handler-latency gauges (`rio.handler.
        <type>.<msg>.<metric>` → the RED histogram's slowest sampled
        request), so a HEALTH event links straight to one slow trace."""
        if self._exemplars is None or not gauge.startswith("rio.handler."):
            return ""
        handler_key = gauge[len("rio.handler.") :].rsplit(".", 1)[0]
        try:
            return str(self._exemplars().get(handler_key, "") or "")
        except Exception:
            return ""

    def _maybe_fire(self, rule: TrendRule, alert: HealthAlert) -> None:
        """Journal one HEALTH event per (rule, gauge), rate-limited to one
        fire per ``cooldown`` samples so a persistent condition doesn't
        flood the ring it is trying to protect."""
        key = (alert.rule, alert.gauge)
        last = self._last_fire.get(key)
        if last is not None and alert.seq - last < rule.cooldown:
            return
        self._last_fire[key] = alert.seq
        self.fired_total += 1
        if self.journal is not None:
            ev = self.journal.record(
                HEALTH,
                alert.rule,
                gauge=alert.gauge,
                value=round(alert.value, 4),
                detail=alert.detail,
                windows=rule.windows,
            )
            if alert.trace_id:
                ev.trace_id = alert.trace_id

    # -- scrape side ---------------------------------------------------------

    def gauges(self) -> dict[str, float]:
        """Scrape-ready alarm state (picked up by ``otel.server_gauges``)."""
        out = {
            "rio.health.rules": float(len(self.rules)),
            "rio.health.alerts_active": float(len(self.active)),
            "rio.health.alerts_total": float(self.fired_total),
        }
        fired_rules = {a.rule for a in self.active}
        for rule in self.rules:
            out[f"rio.health.alert.{rule.name}"] = float(
                rule.name in fired_rules
            )
        return out

    def meta(self) -> dict[str, Any]:
        """``SeriesSnapshot.meta`` contribution: the active alarm labels.

        ``alert_traces`` (append-only key, present only when some alert
        carries one) maps each label to its exemplar trace id — the
        ``watch`` CLI prints it beside the alert so an operator can go
        straight to ``admin trace <id>``.
        """
        out: dict[str, Any] = {
            "alerts": [f"{a.rule}:{a.gauge}" for a in self.active],
        }
        traces = {
            f"{a.rule}:{a.gauge}": a.trace_id
            for a in self.active
            if a.trace_id
        }
        if traces:
            out["alert_traces"] = traces
        return out
