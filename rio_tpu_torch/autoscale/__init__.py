"""Elastic autoscaling: the cluster that sizes itself.

The serving plane already *measures* everything this needs — per-node
:class:`~rio_tpu_torch.load.LoadVector` heartbeats, the cluster-aggregate
``rio.cluster.*`` gauges, :class:`~rio_tpu_torch.health.HealthWatch` trend
rules over the gauge time-series — and already *actuates* everything this
needs: drain (cordon + reminder handoff + coordinated move-out), the
churn-kicked delta re-solve in the placement daemon, membership
liveness. This module closes the loop: an :class:`AutoscaleRuntime`
behind a directory-seated singleton actor (``rio.Autoscale``) that turns
sustained load *trends* into node provision/retire decisions.

Design rules (each one an operational lesson from the TPU rounds):

- **Scale on the trend, never the instant gauge.** Every decision is
  gated on a :class:`~rio_tpu_torch.health.TrendRule` alert over the
  controller's own gauge series (``rio.autoscale.overload`` /
  ``rio.autoscale.underload`` rise one step per consecutive
  out-of-band tick) — a single spiky sample can never resize the
  cluster, and every decision has a journaled ``HEALTH`` alarm as its
  cause ("no decision without a journaled trigger").
- **Hysteresis + decorrelated cooldowns.** Separate high/low pressure
  bands keep the controller quiet in between;
  :class:`~rio_tpu_torch.utils.backoff.DecorrelatedJitter` cooldowns after
  each decision stop resize oscillation (and decorrelate multiple
  clusters sharing one provisioning backend).
- **One controller, seated like any actor.** ``rio.Autoscale`` is a
  normal placement-directory singleton: every autoscale-enabled node
  pokes it each interval through its own dispatch path
  (:meth:`~rio_tpu_torch.service_object.ServiceObject.send`); the owner's poke
  ticks it, non-owners' pokes are redirected away, and when the owner
  dies the survivors' pokes reseat it through the standard dead-owner
  branch — the controller inherits the framework's own failover.
- **Actuate through existing machinery.** Scale-out asks the pluggable
  :class:`NodeProvisioner` for a node and lets membership churn kick the
  placement daemon's delta re-solve; scale-in cordons + drains the
  victim through the stock ``rio.Admin`` ``drain_server`` flow (reminder
  handoff, coordinated handoffs, directory release) and only then
  retires the process.

Every decision and actuation edge is a ``SCALE`` journal event carrying
the trigger rule, the gauge evidence, and the chosen node — ``python -m
rio_tpu_torch.admin scale`` renders policy state, cooldowns, and the recent
decision log; ``python -m rio_tpu_torch.autoscale --demo`` is the self-checking
smoke (one scale-out, one clean scale-in, causal journal).
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import time
from dataclasses import dataclass, field
from typing import Any

from ..app_data import AppData
from ..health import HealthWatch, TrendRule
from ..journal import SCALE, Journal
from ..load import ClusterLoadView
from ..registry import handler, message, type_name
from ..service_object import ServiceObject
from ..timeseries import GaugeSeries
from ..utils.backoff import DecorrelatedJitter

__all__ = [
    "AUTOSCALE_TYPE",
    "AUTOSCALE_ID",
    "ScalePolicy",
    "AutoscaleConfig",
    "NodeProvisioner",
    "AutoscaleRuntime",
    "AutoscaleControl",
    "ScaleTick",
    "ScaleTickAck",
    "ScaleStatus",
    "ScaleSnapshot",
]

log = logging.getLogger("rio_tpu_torch.autoscale")

#: Wire type-name of the singleton controller actor.
AUTOSCALE_TYPE = "rio.Autoscale"
#: The singleton's object id (one controller per cluster).
AUTOSCALE_ID = "controller"


# -- wire messages ------------------------------------------------------------


@message(name="rio.ScaleTick")
@dataclass
class ScaleTick:
    """Periodic poke from every autoscale-enabled node's loop."""

    source: str = ""  # poking node's address (observability only)


@message(name="rio.ScaleTickAck")
@dataclass
class ScaleTickAck:
    acted: bool = False
    action: str = ""  # scale_out | scale_in | "" (no decision this tick)
    detail: str = ""


@message(name="rio.ScaleStatus")
@dataclass
class ScaleStatus:
    """Ask the controller for its policy/decision state (CLI ``scale``)."""

    limit: int = 32  # newest decision rows returned


@message(name="rio.ScaleSnapshot")
@dataclass
class ScaleSnapshot:
    """Controller state for operators; ``decisions`` rows are positional
    ``[wall_ts, action, node, rule, pressure, nodes, detail]`` and may only
    ever grow by appending trailing fields."""

    address: str = ""  # node currently hosting the controller
    pressure: float = 0.0
    nodes: int = 0
    over_streak: int = 0
    under_streak: int = 0
    cooldown_s: float = 0.0
    pending: str = ""  # victim address mid-drain ("" when idle)
    scale_outs: int = 0
    scale_ins: int = 0
    ticks: int = 0
    alerts: list = field(default_factory=list)
    policy: dict = field(default_factory=dict)
    decisions: list = field(default_factory=list)


# -- policy -------------------------------------------------------------------


@dataclass(frozen=True)
class ScalePolicy:
    """Target-band policy over a blended cluster pressure signal.

    ``pressure = inflight/node·w_inflight + loop_lag_mean_ms·w_lag +
    req_rate/node·w_rate + shed_rate/node·w_shed``, EMA-smoothed, then
    compared against a hysteresis band: above ``high_pressure`` for
    ``sustain`` consecutive ticks → scale out (until ``max_nodes``);
    below ``low_pressure`` for ``sustain`` ticks → scale in (until
    ``min_nodes``). The sustain requirement is enforced *as a trend
    rule* over the controller's own series (see :meth:`rules`), so the
    journaled ``HEALTH`` alarm is the decision's recorded cause.
    """

    min_nodes: int = 1
    max_nodes: int = 8
    high_pressure: float = 50.0
    low_pressure: float = 5.0
    sustain: int = 3  # consecutive out-of-band ticks before acting
    ema_alpha: float = 0.5  # pressure smoothing (1.0 = raw signal)
    inflight_weight: float = 1.0
    lag_weight: float = 1.0
    rate_weight: float = 0.0  # opt-in: req_rate/node term (demo/soak use it)
    shed_weight: float = 10.0  # sheds are the loudest overload signal
    # Opt-in (like rate_weight): interactive-class QoS pain — priority>0
    # admission sheds + deadline drops per node per second, from the
    # heartbeat vector's qos_interactive counter. Weighting it makes the
    # cluster grow for the latency-sensitive class specifically, even
    # while bulk-tenant throughput looks healthy.
    interactive_weight: float = 0.0
    out_cooldown_s: float = 5.0  # jitter base after a scale-out
    in_cooldown_s: float = 15.0  # jitter base after a completed scale-in
    cooldown_max_s: float = 120.0  # jitter cap, both directions
    drain_timeout_s: float = 60.0  # victim grace before forced retire

    def pressure_of(
        self,
        agg: dict[str, float],
        shed_rate_per_node: float = 0.0,
        interactive_rate_per_node: float = 0.0,
    ) -> float:
        """Blend one ``ClusterLoadView.aggregate_gauges()`` snapshot."""
        nodes = max(1.0, agg.get("rio.cluster.nodes", 0.0))
        return (
            agg.get("rio.cluster.inflight_total", 0.0) / nodes * self.inflight_weight
            + agg.get("rio.cluster.loop_lag_mean_ms", 0.0) * self.lag_weight
            + agg.get("rio.cluster.req_rate_total", 0.0) / nodes * self.rate_weight
            + shed_rate_per_node * self.shed_weight
            + interactive_rate_per_node * self.interactive_weight
        )

    def rules(self) -> list[TrendRule]:
        """The controller's alarm set: decisions are gated on the first
        two (``*_sustained`` — the streak gauges rise one step per
        consecutive out-of-band tick, so "rose K consecutive windows"
        IS "out of band for K ticks"); the ``pressure_*`` pair is
        informational trend context in the same journal."""
        k = max(1, int(self.sustain))
        return [
            TrendRule(
                name="scale_out_sustained",
                gauge="rio.autoscale.overload",
                kind="rising",
                windows=k,
                cooldown=k,
            ),
            TrendRule(
                name="scale_in_sustained",
                gauge="rio.autoscale.underload",
                kind="rising",
                windows=k,
                cooldown=k,
            ),
            TrendRule(
                name="pressure_rising",
                gauge="rio.autoscale.pressure",
                kind="rising",
                windows=k,
                cooldown=max(k, 10),
            ),
            TrendRule(
                name="pressure_falling",
                gauge="rio.autoscale.pressure",
                kind="falling",
                windows=k,
                cooldown=max(k, 10),
            ),
        ]

    def as_dict(self) -> dict[str, float]:
        return {
            "min_nodes": float(self.min_nodes),
            "max_nodes": float(self.max_nodes),
            "high_pressure": float(self.high_pressure),
            "low_pressure": float(self.low_pressure),
            "sustain": float(self.sustain),
            "out_cooldown_s": float(self.out_cooldown_s),
            "in_cooldown_s": float(self.in_cooldown_s),
            "cooldown_max_s": float(self.cooldown_max_s),
            "drain_timeout_s": float(self.drain_timeout_s),
        }


# -- provisioner trait --------------------------------------------------------


class NodeProvisioner:
    """Actuation backend: where nodes come from and go to.

    Implementations: :class:`~rio_tpu_torch.autoscale.provision.
    InProcessProvisioner` (servers as tasks in this loop — tests, the
    ``--demo`` smoke) and :class:`~rio_tpu_torch.autoscale.provision.
    SubprocessProvisioner` (real OS processes joining shared storage —
    soaks, chaos). A cloud backend implements the same four methods.
    """

    async def provision(self) -> str:
        """Boot one node into the cluster; return its advertised address
        (the node must already be registering itself in membership)."""
        raise NotImplementedError

    async def retire(self, address: str, *, force: bool = False) -> None:
        """Reclaim a node this provisioner booted. Called after the drain
        completed (the address left the membership view) — or with
        ``force=True`` when the drain blew its timeout."""
        raise NotImplementedError

    def managed(self) -> list[str]:
        """Addresses this provisioner booted and still owns. The victim
        picker only retires managed nodes (never the seed nodes an
        operator booted by hand); empty means "anything but me"."""
        return []

    async def close(self) -> None:
        """Force-retire everything still managed (test/soak teardown)."""
        for address in list(self.managed()):
            with contextlib.suppress(Exception):
                await self.retire(address, force=True)


@dataclass
class AutoscaleConfig:
    """``Server(autoscale_config=...)`` knob bundle."""

    provisioner: NodeProvisioner
    policy: ScalePolicy = field(default_factory=ScalePolicy)
    interval: float = 1.0  # poke cadence per enabled node
    series_capacity: int = 240  # controller gauge-series ring


# -- the controller runtime ---------------------------------------------------


class AutoscaleRuntime:
    """Per-node autoscale state; *acts* only on the node that currently
    owns the ``rio.Autoscale`` seat.

    Created at ``Server.bind()`` on every node constructed with an
    :class:`AutoscaleConfig` and injected into AppData; the actor handler
    resolves it there, so whichever enabled node the directory seats the
    controller on ticks with its own membership view, journal, and
    provisioner handle. Single-ticker by construction: ticks arrive
    through the actor's per-object lock, plus a reentrancy flag for
    belt-and-braces.
    """

    def __init__(
        self,
        *,
        address: str,
        members_storage: Any,
        config: AutoscaleConfig,
        app_data: AppData,
        journal: Journal | None = None,
    ) -> None:
        self.address = address
        self.policy = config.policy
        self.provisioner = config.provisioner
        self.interval = max(0.05, float(config.interval))
        self.app_data = app_data
        self.journal = journal
        self._members = members_storage
        # The controller's own trend memory: pressure + streak gauges per
        # tick, evaluated by a private HealthWatch running policy.rules()
        # (sampled manually — the cadence is the tick, not wall time).
        self.series = GaugeSeries(
            capacity=config.series_capacity, node=address, interval=0.01
        )
        self.watch = HealthWatch(
            self.series, journal=journal, rules=self.policy.rules()
        )
        self.pressure = 0.0
        self.over_streak = 0
        self.under_streak = 0
        self.last_nodes = 0
        self.scale_outs = 0
        self.scale_ins = 0
        self.ticks = 0
        self.decisions: list[list[Any]] = []  # ScaleSnapshot wire rows
        self._out_jitter = DecorrelatedJitter(
            base=self.policy.out_cooldown_s, cap=self.policy.cooldown_max_s
        )
        self._in_jitter = DecorrelatedJitter(
            base=self.policy.in_cooldown_s, cap=self.policy.cooldown_max_s
        )
        self._cooldown_until = 0.0  # monotonic
        self._pending: dict[str, Any] | None = None  # scale-in in flight
        self._prev_sheds: float | None = None
        self._prev_mono: float | None = None
        self._shed_rate = 0.0
        self._prev_interactive: float | None = None
        self._interactive_rate = 0.0
        self._ticking = False
        self._client = None  # lazy rio_tpu_torch.Client for drain requests

    # -- the tick (runs on the owning node, under the actor lock) ------------

    async def tick(self) -> ScaleTickAck:
        if self._ticking:
            return ScaleTickAck(detail="reentrant tick dropped")
        self._ticking = True
        try:
            return await self._tick_inner()
        finally:
            self._ticking = False

    async def _tick_inner(self) -> ScaleTickAck:
        now = time.monotonic()
        members = await self._members.active_members()
        addrs = {m.address for m in members}
        view = ClusterLoadView.from_members(members)
        agg = view.aggregate_gauges()
        nodes = len(addrs)
        self.last_nodes = nodes

        # Shed *rate* from the monotonic cluster total (the gauge itself
        # only ever rises; the policy wants pressure, not history).
        sheds = agg.get("rio.cluster.sheds_total", 0.0)
        interactive = agg.get("rio.cluster.qos_interactive_total", 0.0)
        if self._prev_mono is not None and now > self._prev_mono:
            delta = max(0.0, sheds - self._prev_sheds)
            self._shed_rate = delta / (now - self._prev_mono)
            idelta = max(0.0, interactive - (self._prev_interactive or 0.0))
            self._interactive_rate = idelta / (now - self._prev_mono)
        self._prev_sheds, self._prev_mono = sheds, now
        self._prev_interactive = interactive

        raw = self.policy.pressure_of(
            agg,
            shed_rate_per_node=self._shed_rate / max(1, nodes),
            interactive_rate_per_node=self._interactive_rate / max(1, nodes),
        )
        alpha = min(1.0, max(0.01, self.policy.ema_alpha))
        self.pressure = (
            raw if self.ticks == 0 else alpha * raw + (1 - alpha) * self.pressure
        )
        self.ticks += 1

        # Hysteresis band → monotone streak counters. The streaks (not the
        # EMA) feed the sustain rules: they keep strictly rising while the
        # gauge sits out of band, so the alert stays derivable even after
        # the EMA flattens at its asymptote.
        if self.pressure > self.policy.high_pressure:
            self.over_streak += 1
            self.under_streak = 0
        elif self.pressure < self.policy.low_pressure:
            self.under_streak += 1
            self.over_streak = 0
        else:
            self.over_streak = 0
            self.under_streak = 0

        sample = dict(agg)
        sample.update(
            {
                "rio.autoscale.pressure": self.pressure,
                "rio.autoscale.overload": float(self.over_streak),
                "rio.autoscale.underload": float(self.under_streak),
                "rio.autoscale.nodes": float(nodes),
            }
        )
        self.series.sample(sample)
        alerts = {a.rule for a in self.watch.tick()}

        # A scale-in mid-flight owns the controller until the victim is
        # gone (or the drain times out) — no overlapping decisions.
        if self._pending is not None:
            return await self._advance_pending(addrs, now)
        if now < self._cooldown_until:
            return ScaleTickAck(
                detail=f"cooldown {self._cooldown_until - now:.1f}s"
            )

        if (
            "scale_out_sustained" in alerts
            and self.over_streak >= self.policy.sustain
            and nodes < self.policy.max_nodes
        ):
            return await self._scale_out(agg, nodes)
        if (
            "scale_in_sustained" in alerts
            and self.under_streak >= self.policy.sustain
            and nodes > self.policy.min_nodes
        ):
            return await self._begin_scale_in(view, addrs, agg, nodes, now)
        return ScaleTickAck()

    # -- actuation ------------------------------------------------------------

    def _evidence(self, agg: dict[str, float]) -> dict[str, float]:
        """The gauge evidence journaled with every decision."""
        return {
            "pressure": round(self.pressure, 4),
            "loop_lag_mean_ms": round(
                agg.get("rio.cluster.loop_lag_mean_ms", 0.0), 3
            ),
            "inflight_total": agg.get("rio.cluster.inflight_total", 0.0),
            "req_rate_total": round(
                agg.get("rio.cluster.req_rate_total", 0.0), 2
            ),
            "shed_rate": round(self._shed_rate, 3),
        }

    def _record(
        self, action: str, node: str, rule: str, nodes: int, detail: str = ""
    ) -> None:
        row = [
            time.time(),
            action,
            node,
            rule,
            round(self.pressure, 4),
            nodes,
            detail,
        ]
        self.decisions.append(row)
        if len(self.decisions) > 256:
            del self.decisions[: len(self.decisions) - 256]

    def _journal(self, action: str, key: str, **attrs: Any) -> None:
        if self.journal is not None:
            self.journal.record(SCALE, key, action=action, **attrs)

    async def _scale_out(
        self, agg: dict[str, float], nodes: int
    ) -> ScaleTickAck:
        rule = "scale_out_sustained"
        try:
            new_addr = await self.provisioner.provision()
        except Exception as e:  # noqa: BLE001 — a dead backend must not kill ticks
            detail = repr(e)[:160]
            self._journal(
                "scale_out_failed", "", rule=rule, error=detail,
                nodes=nodes, **self._evidence(agg),
            )
            self._record("scale_out_failed", "", rule, nodes, detail)
            self._arm_cooldown(self._out_jitter)
            log.warning("%s: scale-out failed: %s", self.address, detail)
            return ScaleTickAck(action="scale_out", detail=detail)
        self.scale_outs += 1
        self._journal(
            "scale_out", new_addr, rule=rule, nodes=nodes,
            band_high=self.policy.high_pressure, **self._evidence(agg),
        )
        self._record("scale_out", new_addr, rule, nodes)
        self._arm_cooldown(self._out_jitter)
        log.info(
            "%s: scale-out -> %s (pressure %.2f over %d ticks, %d nodes)",
            self.address, new_addr, self.pressure, self.over_streak, nodes,
        )
        # The new member registering itself is the churn that kicks the
        # placement daemon's delta re-solve — load spreads from there.
        return ScaleTickAck(acted=True, action="scale_out", detail=new_addr)

    async def _begin_scale_in(
        self,
        view: ClusterLoadView,
        addrs: set[str],
        agg: dict[str, float],
        nodes: int,
        now: float,
    ) -> ScaleTickAck:
        rule = "scale_in_sustained"
        victim = self._pick_victim(view, addrs)
        if victim is None:
            return ScaleTickAck(detail="no eligible victim")
        self._journal(
            "scale_in", victim, rule=rule, nodes=nodes,
            band_low=self.policy.low_pressure, **self._evidence(agg),
        )
        self._record("scale_in", victim, rule, nodes)
        self._pending = {
            "victim": victim,
            "deadline": now + self.policy.drain_timeout_s,
            "rule": rule,
        }
        log.info(
            "%s: scale-in victim %s (pressure %.2f under %d ticks, %d nodes)",
            self.address, victim, self.pressure, self.under_streak, nodes,
        )
        await self._request_drain(victim)
        return ScaleTickAck(acted=True, action="scale_in", detail=victim)

    def _pick_victim(
        self, view: ClusterLoadView, addrs: set[str]
    ) -> str | None:
        """Lowest-load live node, never self, managed-only when the
        provisioner owns any. ``req_rate`` is the affinity-aware tiebreak:
        between equally idle nodes, retire the one serving the least
        traffic — its population's communication edges are the cheapest
        to re-home through the drain's coordinated handoffs."""
        managed = set(self.provisioner.managed())
        candidates = [
            e
            for e in view.entries.values()
            if e.address in addrs
            and e.address != self.address
            and not e.stale
            and (not managed or e.address in managed)
        ]
        if not candidates:
            return None
        best = min(
            candidates,
            key=lambda e: (
                e.load.inflight + e.load.loop_lag_ms / 100.0,
                e.load.req_rate,
                e.load.registry_objects,
                e.address,
            ),
        )
        return best.address

    async def _request_drain(self, victim: str) -> None:
        """The stock graceful-exit flow, over the wire: ``rio.Admin`` on
        the victim enqueues ``AdminCommand.drain()`` — cordon + journal
        ``MEMBER_CORDON``, reminder-shard handoff, coordinated move-out,
        directory release, membership ``set_inactive``. A failed request
        is journaled but keeps the pending state: the drain deadline
        converts it into a forced retire (the victim may already be dead,
        which is exactly the mid-scale-in SIGKILL chaos case)."""
        from ..admin import ADMIN_TYPE, AdminAck, AdminRequest

        try:
            client = self._get_client()
            ack = await client.send(
                ADMIN_TYPE,
                victim,
                AdminRequest(kind="drain_server"),
                returns=AdminAck,
            )
            self._journal(
                "drain_requested", victim, ok=bool(ack.ok), detail=ack.detail
            )
        except Exception as e:  # noqa: BLE001 — victim may be unreachable/dead
            self._journal("drain_request_failed", victim, error=repr(e)[:160])
            log.warning(
                "%s: drain request to %s failed: %r", self.address, victim, e
            )

    async def _advance_pending(
        self, addrs: set[str], now: float
    ) -> ScaleTickAck:
        assert self._pending is not None
        victim = self._pending["victim"]
        if victim in addrs and now <= self._pending["deadline"]:
            return ScaleTickAck(detail=f"draining {victim}")
        forced = victim in addrs  # deadline blown while still a member
        try:
            await self.provisioner.retire(victim, force=forced)
        except Exception as e:  # noqa: BLE001
            self._journal("retire_failed", victim, error=repr(e)[:160])
        self.scale_ins += 1
        self._journal(
            "retired", victim, rule=self._pending["rule"], forced=forced,
            nodes=self.last_nodes,
        )
        self._record(
            "retired", victim, self._pending["rule"], self.last_nodes,
            "forced" if forced else "",
        )
        log.info(
            "%s: retired %s%s", self.address, victim,
            " (forced: drain timeout)" if forced else "",
        )
        self._pending = None
        self._arm_cooldown(self._in_jitter)
        return ScaleTickAck(acted=True, action="retired", detail=victim)

    def _arm_cooldown(self, jitter: DecorrelatedJitter) -> None:
        self._cooldown_until = time.monotonic() + jitter.next()
        self.over_streak = 0
        self.under_streak = 0

    def _get_client(self):
        if self._client is None:
            from ..client import Client

            self._client = Client(self._members)
        return self._client

    # -- the poke loop (one per enabled node, started by Server.run) ---------

    async def poke_loop(self) -> None:
        """Drive the singleton from every enabled node: the owner's poke
        dispatches locally and ticks; everyone else's raises a Redirect at
        their own service layer (internal sends never forward) and is
        dropped. When the owner dies, membership marks it inactive and the
        next surviving poke takes the dead-owner branch — clean_server +
        lazy self-assign — reseating the controller with no extra code."""
        while True:
            await asyncio.sleep(self.interval)
            try:
                await ServiceObject.send(
                    self.app_data,
                    AUTOSCALE_TYPE,
                    AUTOSCALE_ID,
                    ScaleTick(source=self.address),
                    returns=ScaleTickAck,
                )
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — Redirect / transient dispatch noise
                pass

    async def close(self) -> None:
        if self._client is not None:
            with contextlib.suppress(Exception):
                self._client.close()
            self._client = None

    # -- observability --------------------------------------------------------

    @property
    def pending(self) -> str:
        """Victim address of the scale-in currently in flight ('' if none)."""
        return (self._pending or {}).get("victim", "")

    def gauges(self) -> dict[str, float]:
        """Scrape-ready controller state (``otel.server_gauges`` picks it
        up on whichever node hosts the runtime)."""
        return {
            "rio.autoscale.pressure": round(self.pressure, 4),
            "rio.autoscale.nodes": float(self.last_nodes),
            "rio.autoscale.overload": float(self.over_streak),
            "rio.autoscale.underload": float(self.under_streak),
            "rio.autoscale.cooldown_s": round(
                max(0.0, self._cooldown_until - time.monotonic()), 3
            ),
            "rio.autoscale.pending_drain": float(self._pending is not None),
            "rio.autoscale.scale_outs": float(self.scale_outs),
            "rio.autoscale.scale_ins": float(self.scale_ins),
            "rio.autoscale.ticks": float(self.ticks),
        }

    def status(self, limit: int = 32) -> dict[str, Any]:
        """CLI/snapshot view (everything msgpack/JSON-simple)."""
        return {
            "address": self.address,
            "pressure": round(self.pressure, 4),
            "nodes": self.last_nodes,
            "over_streak": self.over_streak,
            "under_streak": self.under_streak,
            "cooldown_s": round(
                max(0.0, self._cooldown_until - time.monotonic()), 3
            ),
            "pending": (self._pending or {}).get("victim", ""),
            "scale_outs": self.scale_outs,
            "scale_ins": self.scale_ins,
            "ticks": self.ticks,
            "alerts": sorted({a.rule for a in self.watch.active}),
            "policy": self.policy.as_dict(),
            "decisions": [list(r) for r in self.decisions[-max(0, limit):]],
        }


# -- the actor ----------------------------------------------------------------


@type_name(AUTOSCALE_TYPE)
class AutoscaleControl(ServiceObject):
    """The directory-seated singleton face of the controller.

    Deliberately stateless: all state lives in the hosting node's
    :class:`AutoscaleRuntime` (AppData), so a reseat after owner death
    loses nothing but the previous node's in-flight streaks — the new
    host re-derives them from live gauges within ``sustain`` ticks, which
    is exactly the conservatism wanted right after losing a node.
    """

    @handler
    async def tick(self, msg: ScaleTick, ctx: AppData) -> ScaleTickAck:
        runtime = ctx.try_get(AutoscaleRuntime)
        if runtime is None:
            # Seated on a node without an AutoscaleConfig (operator error
            # or a rebalance surprise): report, never crash the poke.
            return ScaleTickAck(detail="no autoscale runtime on this node")
        return await runtime.tick()

    @handler
    async def status(self, msg: ScaleStatus, ctx: AppData) -> ScaleSnapshot:
        runtime = ctx.try_get(AutoscaleRuntime)
        if runtime is None:
            return ScaleSnapshot(address="", pressure=0.0)
        s = runtime.status(limit=msg.limit)
        return ScaleSnapshot(
            address=s["address"],
            pressure=s["pressure"],
            nodes=s["nodes"],
            over_streak=s["over_streak"],
            under_streak=s["under_streak"],
            cooldown_s=s["cooldown_s"],
            pending=s["pending"],
            scale_outs=s["scale_outs"],
            scale_ins=s["scale_ins"],
            ticks=s["ticks"],
            alerts=s["alerts"],
            policy=s["policy"],
            decisions=s["decisions"],
        )
