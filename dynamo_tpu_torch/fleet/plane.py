"""FleetPlane: the binding that turns the planner into an N-model-pool
reconciler.

The planner loop stays the planner loop — observe, decide, publish,
actuate. The plane hooks it at three points:

- :meth:`sync` (start of every tick): the pool set, per-pool clamps,
  model-scoped signal wiring and connector pool specs all follow the
  live :class:`~.registry.FleetRegistry`. ``ctl fleet add`` mid-traffic
  means the NEXT tick already reconciles the new model; ``remove`` means
  the next tick drains its owned workers and forgets its damping state.
- :meth:`arbitrate` (between decide and actuate): every pool's clamped
  target passes through the :class:`~.arbiter.ChipArbiter` so the joint
  plan fits the global chip budget; reductions land on the Decision
  record (``suppressed="chip_budget"``, reason naming who outbid whom)
  exactly like cooldowns and clamps do.
- :meth:`publish_status` (end of tick): one lease-bound
  ``fleet_status/{ns}/{model}`` record per model (replicas, target,
  ready/booting/draining/off, chips, burn) — what ``GET /v1/models``,
  ``dyntop`` and ``plannerctl`` render. Dying with the planner's lease
  is deliberate: a stale status is worse than an absent one.

Cold-boot ordering is the loop's half of the contract: scale-ups actuate
before scale-downs in the same tick, so a preempted-into-existence
model's worker is already loading weights while the donor pool drains —
PRESERVE's overlap argument applied to scale-to-zero.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Dict, List, Optional

from ..planner.policy import HOLD, SCALE_DOWN, SCALE_UP, Decision
from ..planner.signals import PoolSignals
from .arbiter import SUPPRESSED_CHIP_BUDGET, ChipArbiter, PoolClaim
from .mobility.keys import mobility_prefetch_key, mobility_wake_prefix
from .registry import (
    STATE_BOOTING,
    STATE_DRAINING,
    STATE_OFF,
    STATE_READY,
    FleetModelSpec,
    FleetRegistry,
    publish_fleet_status,
    worker_engine,
)

log = logging.getLogger("dynamo_tpu_torch.fleet")


class FleetPlane:
    """See module docstring. ``worker_env`` is merged into every spawned
    model worker's environment (the soak harnesses pass store knobs)."""

    def __init__(self, store, namespace: str, total_chips: int = 4,
                 arbiter: Optional[ChipArbiter] = None,
                 worker_env: Optional[Dict[str, str]] = None):
        self.store = store
        self.namespace = namespace
        self.registry = FleetRegistry(store, namespace)
        self.arbiter = arbiter or ChipArbiter(total_chips)
        self.worker_env = dict(worker_env or {})
        self._last_targets: Dict[str, int] = {}
        # per-component prefetch hints last written (change-gated so the
        # store sees one write per hint change, not one per tick)
        self._last_hints: Dict[str, str] = {}

    async def start(self) -> "FleetPlane":
        await self.registry.start()
        return self

    # ------------------------------------------------------------------
    def pool_spec(self, spec: FleetModelSpec):
        """LocalConnector PoolSpec for one model: its own component, its
        model identity registered so discovery serves it the moment the
        worker is up."""
        from ..planner.connectors import PoolSpec

        extra = ["--model-name", spec.name, "--register-model"]
        if spec.model_path:
            extra += ["--model-path", spec.model_path]
        extra += list(spec.extra_args)
        return PoolSpec(component=spec.component,
                        chips=spec.chips_per_replica,
                        engine=worker_engine(spec.engine),
                        extra_args=extra,
                        env=dict(self.worker_env))

    async def sync(self, planner) -> None:
        """Reconcile the planner's pool set with the registry (start of
        every tick). ``planner`` is the :class:`~..planner.loop.Planner`."""
        specs = self.registry.snapshot()
        new_pools = {name: s.component for name, s in specs.items()}
        if new_pools != planner.pools:
            removed = set(planner.pools) - set(new_pools)
            # a model re-added under a DIFFERENT component is a remove +
            # add: the old component's workers must drain (they'd
            # otherwise run — and hold chips — forever, invisible to
            # both the collector and the arbiter) and the pool's
            # damping/signal state belongs to the old pool
            moved = {p for p in new_pools
                     if p in planner.pools
                     and planner.pools[p] != new_pools[p]}
            for pool in removed | moved:
                log.info("fleet: draining %s model pool %s",
                         "moved" if pool in moved else "removed", pool)
                planner.core.forget_pool(pool)
                planner.collector.forget_pool(pool)
                self._last_targets.pop(pool, None)
                remove = getattr(planner.connector, "remove_pool", None)
                if remove is not None:
                    await remove(pool)
            planner.pools = dict(new_pools)
            planner.collector.pools = dict(new_pools)
        planner.collector.pool_models = {name: name for name in new_pools}
        planner.core.set_pool_clamps(
            {name: (s.min_replicas, s.max_replicas)
             for name, s in specs.items()})
        set_pool = getattr(planner.connector, "set_pool", None)
        if set_pool is not None:
            for name, s in specs.items():
                set_pool(name, self.pool_spec(s))
        await self.publish_prefetch_hints()

    async def publish_prefetch_hints(self) -> None:
        """Per-component weight-prefetch hints under ``mobility/``: each
        model's workers stage (a) every sibling sharing its non-empty
        ``swap_group`` — the models a preemption could swap in — and
        (b) every ``prewarm`` model (``ctl fleet add --prewarm``).
        Change-gated: the hint key is written only when its content
        moves, and deleted when a component's hint set empties or the
        model leaves the registry."""
        specs = self.registry.snapshot()
        live: Dict[str, str] = {}
        for name, s in specs.items():
            hints = []
            for other, o in sorted(specs.items()):
                if other == name or not o.model_path:
                    continue
                if ((s.swap_group and o.swap_group == s.swap_group)
                        or o.prewarm):
                    hints.append({"model": other,
                                  "model_path": o.model_path})
            key = mobility_prefetch_key(self.namespace, s.component)
            live[key] = json.dumps({"models": hints}) if hints else ""
        stale = [k for k in self._last_hints if k not in live]
        for key, blob in live.items():
            if self._last_hints.get(key) == blob:
                continue
            if blob:
                await self.store.put(key, blob.encode())
            else:
                await self.store.delete(key)
            self._last_hints[key] = blob
        for key in stale:
            if self._last_hints.pop(key, ""):
                await self.store.delete(key)

    # ------------------------------------------------------------------
    def arbitrate(self, decisions: List[Decision],
                  signals: Dict[str, PoolSignals]) -> List[Decision]:
        """Clamp the joint plan to the chip budget; annotate reductions.
        Non-fleet pools (not in the registry) pass through untouched."""
        specs = self.registry.snapshot()
        claims = []
        for d in decisions:
            s = specs.get(d.pool)
            if s is None:
                continue
            sig = signals.get(d.pool)
            claims.append(PoolClaim(
                model=d.pool, want=d.target, current=d.current,
                chips_per_replica=s.chips_per_replica,
                min_replicas=s.min_replicas, priority=s.priority,
                burn=sig.slo_pressure if sig is not None else 0.0,
                swap_group=s.swap_group))
        if not claims:
            return decisions
        grants = self.arbiter.grant(claims)
        for d in decisions:
            granted = grants.get(d.pool)
            if granted is None:
                continue
            target, reason = granted
            if target == d.target:
                continue
            # the budget overrode the damped policy target — including,
            # deliberately, cooldown/hold decisions: preemption exists to
            # move chips NOW, when another model's burn demands them
            d.target = target
            d.suppressed = SUPPRESSED_CHIP_BUDGET
            if reason:
                d.reason = f"{d.reason}; {reason}" if d.reason else reason
            d.action = (SCALE_UP if d.target > d.current
                        else SCALE_DOWN if d.target < d.current else HOLD)
        return decisions

    # ------------------------------------------------------------------
    async def actuate_swaps(self, decisions: List[Decision],
                            connector) -> None:
        """Convert same-``swap_group`` chip handoffs into in-place weight
        swaps. Runs between :meth:`arbitrate` and actuation: when the
        arbitrated plan scales model B up while scaling its hot-swap
        sibling A down, one of A's workers is told (via the connector's
        ``swap_pool``) to overwrite its weights in place and re-register
        as B — seconds instead of drain + cold spawn. The paired
        decisions are annotated (``swap_in``/``swap_out``) so the
        connector neither spawns a worker the swap already provides nor
        SIGTERMs the worker that is leaving by swap. At most one swap per
        donor component per tick (the command key holds a single
        claim-by-delete record); the planner reconverges across ticks.
        Connectors without ``swap_pool`` (Kube, Null) fall back to the
        plain spawn/drain path untouched."""
        swap_pool = getattr(connector, "swap_pool", None)
        if swap_pool is None:
            return
        specs = self.registry.snapshot()

        def _swappable(d, action):
            s = specs.get(d.pool)
            return (s is not None and s.swap_group
                    and d.action == action and not d.dry_run)

        ups = [d for d in decisions if _swappable(d, SCALE_UP)]
        downs = [d for d in decisions if _swappable(d, SCALE_DOWN)]
        for up in ups:
            s_up = specs[up.pool]
            if not s_up.model_path:
                continue        # nothing to stage — echo/test pools
            for down in downs:
                s_down = specs[down.pool]
                if s_down.swap_group != s_up.swap_group:
                    continue
                need = (up.target - up.current
                        - getattr(up, "swap_in", 0))
                give = (down.current - down.target
                        - getattr(down, "swap_out", 0))
                if need <= 0 or give <= 0:
                    continue
                payload = {
                    "model": s_up.name,
                    "component": s_up.component,
                    "model_path": s_up.model_path,
                    "from": down.pool,
                    "issued_at": time.time(),
                }
                issued = await swap_pool(
                    self.store, self.namespace, down.pool,
                    s_down.component, payload)
                if not issued:
                    continue
                up.swap_in = getattr(up, "swap_in", 0) + issued
                down.swap_out = getattr(down, "swap_out", 0) + issued
                note = (f"swap {down.pool}->{up.pool} "
                        f"(group {s_up.swap_group})")
                up.reason = f"{up.reason}; {note}" if up.reason else note
                log.info("fleet mobility: %s", note)

    # ------------------------------------------------------------------
    @staticmethod
    def model_state(replicas: int, target: int) -> str:
        if target > replicas:
            return STATE_BOOTING
        if target < replicas:
            return STATE_DRAINING
        return STATE_READY if replicas > 0 else STATE_OFF

    async def publish_status(self, drt, decisions: List[Decision],
                             signals: Dict[str, PoolSignals]) -> None:
        """One lease-bound status record per registered model."""
        for d in decisions:
            if d.pool in self.registry.models:
                self._last_targets[d.pool] = d.target
        wakes: Dict[str, Dict] = {}
        for key, value in await drt.store.get_prefix(
                mobility_wake_prefix(self.namespace)):
            try:
                wakes[key.rsplit("/", 1)[1]] = json.loads(value.decode())
            except (ValueError, json.JSONDecodeError):
                log.warning("skipping malformed wake record %s", key)
        for name, spec in self.registry.snapshot().items():
            sig = signals.get(name)
            replicas = sig.replicas if sig is not None else 0
            target = self._last_targets.get(name, replicas)
            status = {
                "component": spec.component,
                "state": self.model_state(replicas, target),
                "replicas": replicas,
                "target": target,
                "chips": replicas * spec.chips_per_replica,
                "chips_per_replica": spec.chips_per_replica,
                "priority": spec.priority,
                "burn": round(sig.slo_pressure, 3) if sig else 0.0,
                "unserved": sig.unserved if sig else 0.0,
            }
            wake = wakes.get(name)
            if wake:
                # last observed wake (published by the worker's mobility
                # agent): how this model most recently came up —
                # "swap" (in-place weight swap) or "cold" (full boot)
                status["wake_path"] = wake.get("path")
                status["wake_seconds"] = wake.get("seconds")
            await publish_fleet_status(drt.store, self.namespace, name,
                                       status, lease=drt.lease)
