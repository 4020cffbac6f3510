"""The planner control loop: observe -> decide -> publish -> actuate.

Production shape:

- every evaluation's decisions (held ones included) are published under
  ``planner/{namespace}/decisions/{seq:010d}`` with a span, and the loop's
  rolling state under ``planner/{namespace}/state`` (lease-bound — the key
  doubles as the planner's liveness beacon);
- ``dyn_planner_*`` counters/gauges ride the same ``metrics_stage/``
  publish path workers use, so the aggregator and ``/metrics`` merge them
  cluster-wide with zero new plumbing;
- operator state (``plannerctl override/pause``) is watched live from
  ``planner/{namespace}/override``;
- dry-run evaluates, damps and publishes identically but never calls the
  connector;
- actuation failures are counted and re-tried naturally on the next tick
  (the decision engine's cooldown keeps that from thrashing).

Store layout::

    planner/{ns}/state              rolling state (lease-bound, JSON)
    planner/{ns}/decisions/{seq}    decision records (bounded ring)
    planner/{ns}/override           {"paused": bool, "pools": {pool: n}}
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..llm.metrics_aggregator import stage_key
from ..runtime.store_client import StoreError
from ..utils import tracing
from ..utils.prometheus import Registry
from .policy import HOLD, SCALE_DOWN, SCALE_UP, Decision, PlannerCore
from .signals import PoolSignals, SignalCollector

log = logging.getLogger("dynamo_tpu_torch.planner")

PLANNER_COMPONENT = "planner"


def planner_prefix(namespace: str) -> str:
    return f"planner/{namespace}/"


def state_key(namespace: str) -> str:
    return planner_prefix(namespace) + "state"


def override_key(namespace: str) -> str:
    return planner_prefix(namespace) + "override"


def decisions_prefix(namespace: str) -> str:
    return planner_prefix(namespace) + "decisions/"


class PlannerMetrics:
    """``dyn_planner_*`` series on their own registry (published to the
    stage-metrics plane under component="planner")."""

    def __init__(self) -> None:
        r = Registry()
        self.registry = r
        self.evaluations = r.counter(
            "dyn_planner_evaluations_total",
            "Planner observe/decide cycles completed", ())
        self.decisions = r.counter(
            "dyn_planner_decisions_total",
            "Decisions by pool and action", ("pool", "action"))
        self.suppressed = r.counter(
            "dyn_planner_suppressed_total",
            "Proposals held back, by reason "
            "(cooldown/flap_damping/clamp/paused)", ("pool", "reason"))
        self.actuations = r.counter(
            "dyn_planner_actuations_total",
            "Connector applications by result", ("pool", "result"))
        self.target_replicas = r.gauge(
            "dyn_planner_target_replicas",
            "Planner's current desired replicas", ("pool",))
        self.observed_replicas = r.gauge(
            "dyn_planner_observed_replicas",
            "Live registered replicas at last observation", ("pool",))
        self.queue_depth = r.gauge(
            "dyn_planner_queue_depth",
            "Observed backlog at last observation", ("pool",))
        self.occupancy = r.gauge(
            "dyn_planner_occupancy",
            "Observed batch occupancy at last observation", ("pool",))
        self.dry_run = r.gauge(
            "dyn_planner_dry_run", "1 when decisions do not actuate", ())


@dataclass
class PlannerConfig:
    """Loop knobs. Every field maps to a ``DYN_PLANNER_*`` env var through
    the CLI's EnvDefaultsParser (see cli/planner.py and docs/planner.md)."""

    interval: float = 2.0               # seconds between evaluations
    min_replicas: int = 1
    max_replicas: int = 8
    cooldown_up: float = 30.0
    cooldown_down: float = 120.0
    down_consensus: int = 3             # agreeing ticks before scale-down
    dry_run: bool = False
    keep_decisions: int = 200           # decision-ring length in the store
    # run the SLO-burn brownout controller (utils/overload.py) on this
    # loop's already-collected signals, publishing level changes to the
    # store for every frontend/router to apply fleet-wide
    brownout: bool = False


class Planner:
    """The standing control loop. ``pools`` maps pool name -> component
    (e.g. ``{"decode": "backend", "prefill": "prefill"}``)."""

    def __init__(self, drt, namespace: str, pools: Dict[str, str],
                 policy, connector, config: Optional[PlannerConfig] = None,
                 fleet=None):
        self.drt = drt
        self.namespace = namespace
        self.pools = dict(pools)
        self.config = config or PlannerConfig()
        self.connector = connector
        # fleet mode (fleet/): the pool set follows the model
        # registry live, targets pass through the chip arbiter, and a
        # lease-bound status record is published per model each tick
        self.fleet = fleet
        self.core = PlannerCore(
            policy,
            min_replicas=self.config.min_replicas,
            max_replicas=self.config.max_replicas,
            cooldown_up=self.config.cooldown_up,
            cooldown_down=self.config.cooldown_down,
            down_consensus=self.config.down_consensus,
            dry_run=self.config.dry_run)
        self.collector = SignalCollector(drt.store, namespace, self.pools)
        self.brownout: Optional[object] = None
        if self.config.brownout:
            from ..utils.overload import BrownoutMonitor

            # the monitor's own SloMonitor goes unused — the planner feeds
            # the burn its signal collector already computed into apply()
            self.brownout = BrownoutMonitor(drt.store, namespace,
                                            lease=drt.lease)
        self.metrics = PlannerMetrics()
        self.metrics.dry_run.set(value=1.0 if self.config.dry_run else 0.0)
        self.decisions_log: List[Decision] = []   # in-process tail
        self._task: Optional[asyncio.Task] = None
        self._last_signals: Dict[str, PoolSignals] = {}

    # ------------------------------------------------------------------
    async def start(self) -> "Planner":
        if self.fleet is not None:
            await self.fleet.start()
        await self._watch_override()
        await self._resume_seq()
        self._task = asyncio.create_task(self._run_loop())
        return self

    async def _resume_seq(self) -> None:
        """Continue the decision sequence where the previous planner run
        left it: a seq restart at 0 would interleave with the surviving
        ring entries and `plannerctl decisions` would show the dead run's
        tail as the newest."""
        try:
            items = await self.drt.store.get_prefix(
                decisions_prefix(self.namespace))
            if items:
                seqs = sorted(int(k.rsplit("/", 1)[1]) for k, _ in items)
                self.core._seq = seqs[-1]
                # ring entries whose paired delete was lost (e.g. to a
                # store outage) would otherwise leak forever
                keep = self.config.keep_decisions
                for s in (seqs[:-keep] if keep else seqs):
                    await self.drt.store.delete(
                        f"{decisions_prefix(self.namespace)}{s:010d}")
        except (StoreError, ValueError):
            log.warning("could not resume decision seq; starting fresh",
                        exc_info=True)

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            # dynalint: ok(swallowed-exception) reaping our own cancelled
            # loop task; _run_loop logs its own failures with exc_info
            except (asyncio.CancelledError, Exception):
                pass
            self._task = None
        close = getattr(self.connector, "close", None)
        if close is not None:
            await close()   # LocalConnector default: drain owned workers

    async def _watch_override(self) -> None:
        key = override_key(self.namespace)

        def apply_raw(value: Optional[bytes]) -> None:
            if not value:
                self.core.set_override({}, False)
                return
            try:
                d = json.loads(value.decode())
                pools = {str(k): int(v)
                         for k, v in (d.get("pools") or {}).items()}
                self.core.set_override(pools, bool(d.get("paused")))
                log.info("planner override applied: %s", d)
            except (ValueError, json.JSONDecodeError):
                log.warning("ignoring malformed planner override: %r", value)

        async def on_change(k: str, value: Optional[bytes], deleted: bool):
            if k == key:
                apply_raw(None if deleted else value)

        snapshot = await self.drt.store.watch_prefix(key, on_change)
        for k, value in snapshot:
            if k == key:
                apply_raw(value)

    # ------------------------------------------------------------------
    async def run_once(self, now: Optional[float] = None) -> List[Decision]:
        """One observe->decide->publish->actuate cycle (the loop's body;
        also the unit tests and chaos harness drive it directly)."""
        now = time.time() if now is None else now
        tracer = tracing.get_tracer()
        async with tracer.span("planner.evaluate"):
            if self.fleet is not None:
                await self.fleet.sync(self)
            signals = await self.collector.collect()
            self._last_signals = signals
            await self._brownout_tick(signals)
            decisions = self.core.evaluate(signals, now)
            if self.fleet is not None:
                decisions = self.fleet.arbitrate(decisions, signals)
                if not self.config.dry_run:
                    # same-swap-group chip handoffs become in-place
                    # weight swaps (decision pairs annotated so the
                    # connector's spawn/drain arithmetic skips them)
                    await self.fleet.actuate_swaps(decisions,
                                                   self.connector)
            # scale-ups actuate BEFORE scale-downs: a booting worker's
            # weight load overlaps the donor pool's drain, so a chip
            # handoff between models costs one boot, not boot + drain in
            # series (and scale-to-zero cold boots hide behind drains)
            order = {SCALE_UP: 0, HOLD: 1, SCALE_DOWN: 2}
            for d in sorted(decisions,
                            key=lambda d: order.get(d.action, 1)):
                await self._publish_decision(d)
                self._export(d, signals.get(d.pool))
                if d.action != HOLD and not d.dry_run:
                    await self._actuate(d)
            if self.fleet is not None and not self.config.dry_run:
                await self.fleet.publish_status(self.drt, decisions,
                                                signals)
        self.metrics.evaluations.inc()
        await self._publish_state(now)
        return decisions

    async def _brownout_tick(self, signals: Dict[str, PoolSignals]) -> None:
        """Step the brownout controller on the worst SLO burn the signal
        collector just observed; BrownoutMonitor.apply owns the gauge +
        store publication (lease-bound: a dead planner's brownout expires
        with its lease)."""
        if self.brownout is None:
            return
        burn = max((s.slo_pressure for s in signals.values()), default=0.0)
        await self.brownout.apply(burn)

    async def _actuate(self, d: Decision) -> None:
        tracer = tracing.get_tracer()
        try:
            async with tracer.span(f"planner.actuate:{d.action}",
                                   pool=d.pool, target=d.target):
                await self.connector.apply(d.pool, d.target, d)
            self.metrics.actuations.inc(d.pool, "ok")
            log.info("planner %s: %s %d -> %d (%s)", d.pool, d.action,
                     d.current, d.target, d.reason)
        except Exception:
            self.metrics.actuations.inc(d.pool, "error")
            log.exception("planner actuation failed (%s -> %d); will "
                          "re-evaluate next tick", d.pool, d.target)

    def _export(self, d: Decision, s: Optional[PoolSignals]) -> None:
        m = self.metrics
        m.decisions.inc(d.pool, d.action)
        if d.suppressed:
            m.suppressed.inc(d.pool, d.suppressed)
        m.target_replicas.set(d.pool, value=d.target)
        if s is not None:
            m.observed_replicas.set(d.pool, value=s.replicas)
            m.queue_depth.set(d.pool, value=s.queue_depth)
            m.occupancy.set(d.pool, value=s.occupancy)
        self.decisions_log.append(d)
        del self.decisions_log[:-self.config.keep_decisions]

    async def _publish_decision(self, d: Decision) -> None:
        key = f"{decisions_prefix(self.namespace)}{d.seq:010d}"
        try:
            await self.drt.store.put(
                key, json.dumps(d.to_dict()).encode())
            stale = d.seq - self.config.keep_decisions
            if stale > 0:
                await self.drt.store.delete(
                    f"{decisions_prefix(self.namespace)}{stale:010d}")
            if d.seq % (2 * self.config.keep_decisions) == 0:
                # occasional full sweep: per-publish deletes skipped during
                # store outages leave orphans behind the rolling window
                for k, _ in await self.drt.store.get_prefix(
                        decisions_prefix(self.namespace)):
                    try:
                        if int(k.rsplit("/", 1)[1]) <= stale:
                            await self.drt.store.delete(k)
                    except ValueError:
                        pass
        except StoreError:
            log.debug("decision publish skipped (store disconnected)")

    async def _publish_state(self, now: float) -> None:
        state = {
            "ts": now,
            "namespace": self.namespace,
            "policy": self.core.policy.name,
            "connector": getattr(self.connector, "name", "?"),
            "dry_run": self.config.dry_run,
            "paused": self.core.paused,
            "overrides": self.core.overrides,
            "clamps": [self.config.min_replicas, self.config.max_replicas],
            "fleet": self.fleet is not None,
            # which observer path fed the last signals: "region" (the
            # hierarchical aggregator tree's pre-merged records) or
            # "flat" (the per-worker prefix scan fallback)
            "signal_source": self.collector.last_source,
            "pools": {
                pool: {
                    "component": comp,
                    "replicas": s.replicas if s else None,
                    "occupancy": round(s.occupancy, 3) if s else None,
                    "queue_depth": s.queue_depth if s else None,
                    "kv_utilization":
                        round(s.kv_utilization, 3) if s else None,
                    "breaker_open": s.breaker_open if s else None,
                    "slo_burn": round(s.slo_pressure, 3) if s else None,
                }
                for pool, comp in self.pools.items()
                for s in (self._last_signals.get(pool),)
            },
        }
        try:
            await self.drt.store.put(
                state_key(self.namespace), json.dumps(state).encode(),
                lease=self.drt.lease)
            await self.drt.store.put(
                stage_key(self.namespace, PLANNER_COMPONENT,
                          self.drt.worker_id),
                json.dumps({"component": PLANNER_COMPONENT,
                            "metrics":
                                self.metrics.registry.state_dump()}).encode(),
                lease=self.drt.lease)
        except StoreError:
            log.debug("planner state publish skipped (store disconnected)")

    async def _run_loop(self) -> None:
        while True:
            try:
                await self.run_once()
            except asyncio.CancelledError:
                raise
            except StoreError:
                log.warning("planner tick skipped: store disconnected")
            except Exception:
                log.exception("planner evaluation failed")
            await asyncio.sleep(self.config.interval)
