"""How the planner decides: policies + the damped decision engine.

Two pluggable policies turn a :class:`~.signals.PoolSignals` snapshot into a
raw replica proposal:

- :class:`LoadPolicy` — threshold + hysteresis on queue depth / batch
  occupancy / KV utilization. Scale-up triggers above the high-water marks,
  scale-down only when EVERY signal is below the (lower) low-water marks —
  the gap between the bands is the hysteresis that keeps a borderline load
  from flapping the fleet. Breaker-open instances do not count as capacity.
- :class:`SlaPolicy` — target TTFT and ITL. Required replicas are
  interpolated from a :class:`~.profile.ProfileTable` (how much concurrency
  one replica sustains within the targets, measured by the profile sweep);
  a measured p90 above target additionally forces at least one step up
  (NetKV's point: instance-count decisions must be metric-driven).

:class:`PlannerCore` wraps a policy with the production damping every real
autoscaler needs — per-pool min/max clamps, separate scale-up/scale-down
cooldowns, consecutive-agreement flap damping for scale-down, operator
overrides, pause — and emits one :class:`Decision` record per pool per
evaluation (held decisions included, with the suppression reason). The core
is synchronous and deterministic: tests feed it synthetic metric series and
a fake clock.
"""

from __future__ import annotations

import logging
import math
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Tuple

from .signals import PoolSignals

log = logging.getLogger("dynamo_tpu_torch.planner")

SCALE_UP, SCALE_DOWN, HOLD = "scale_up", "scale_down", "hold"


@dataclass
class Decision:
    """One pool's outcome for one evaluation — published to the store under
    ``planner/`` whether or not it actuates (dry-run publishes identically).
    """

    pool: str
    current: int                    # observed live replicas
    proposed: int                   # policy's raw proposal
    target: int                     # after override + clamps + damping
    action: str                     # scale_up | scale_down | hold
    reason: str                     # the policy's (or override's) rationale
    policy: str
    suppressed: Optional[str] = None  # cooldown|flap_damping|clamp|paused
    dry_run: bool = False
    seq: int = 0
    ts: float = 0.0
    signals: Dict = field(default_factory=dict)

    def to_dict(self) -> Dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "Decision":
        return cls(**{k: v for k, v in d.items()
                      if k in cls.__dataclass_fields__})


class LoadPolicy:
    """Threshold + hysteresis on queue depth / occupancy / KV utilization.

    Scale-up sizes the jump to the backlog: each extra replica is assumed to
    absorb one live replica's worth of slots, so a deep queue jumps several
    replicas at once instead of crawling up one per cooldown window.
    """

    name = "load"

    def __init__(self, queue_high: float = 1.0, queue_low: float = 0.0,
                 occupancy_high: float = 0.85, occupancy_low: float = 0.3,
                 kv_high: float = 0.9, kv_low: float = 0.5):
        self.queue_high = queue_high      # backlog per replica to scale up
        self.queue_low = queue_low        # total backlog to allow scale-down
        self.occupancy_high = occupancy_high
        self.occupancy_low = occupancy_low
        self.kv_high = kv_high
        # kv gets its own low-water mark like occupancy: gating scale-down
        # on kv < kv_high would oscillate right at the boundary (shrink
        # pushes utilization over kv_high -> immediate scale back up)
        self.kv_low = kv_low

    def propose(self, s: PoolSignals) -> Tuple[int, str]:
        healthy = max(s.healthy_replicas, 1)
        # rejected demand counts as backlog: shedding keeps the visible
        # queues bounded, so an overloaded-but-shedding fleet would read
        # as idle from queue depth alone (each shed/s ~ one waiting seq)
        backlog = s.queue_depth + s.shed_rate
        per_replica_q = backlog / healthy
        hot = []
        if per_replica_q > self.queue_high:
            hot.append(f"queue {s.queue_depth:.0f} + shed {s.shed_rate:.1f}/s "
                       f"(> {self.queue_high}/replica)")
        if s.occupancy > self.occupancy_high:
            hot.append(f"occupancy {s.occupancy:.2f} "
                       f"(> {self.occupancy_high})")
        if s.kv_utilization > self.kv_high:
            hot.append(f"kv {s.kv_utilization:.2f} (> {self.kv_high})")
        if s.unserved > 0:
            # scale-from-zero: requests arrived for a model nobody
            # serves — ANY unserved demand wakes the pool (there is no
            # queue to deepen and no occupancy to breach at 0 replicas)
            hot.append(f"{s.unserved:.0f} unserved request(s) "
                       f"(scale from zero)")
        if hot:
            slots_per_replica = (s.total_slots / s.replicas
                                 if s.replicas and s.total_slots else 1.0)
            backlog_steps = math.ceil(backlog / slots_per_replica) \
                if backlog else 0
            step = max(1, backlog_steps, s.breaker_open)
            return s.replicas + step, "; ".join(hot)
        cold = (s.queue_depth <= self.queue_low
                and s.occupancy < self.occupancy_low
                and s.kv_utilization < self.kv_low
                and s.breaker_open == 0
                and s.shed_rate <= 0.0)
        if cold:
            return s.replicas - 1, (
                f"idle: queue {s.queue_depth:.0f}, "
                f"occupancy {s.occupancy:.2f} (< {self.occupancy_low})")
        return s.replicas, "within band"


class SlaPolicy:
    """Target TTFT/ITL; required replicas interpolated from a profile table.

    ``capacity`` — the max concurrent sequences one replica sustains inside
    both targets — comes from the table once at construction; demand is the
    live concurrency (active slots + backlog). A measured p90 above target
    forces at least one step up even when the table says the demand fits
    (the table is a model; the histograms are the truth).
    """

    name = "sla"

    def __init__(self, table, ttft_target: float, itl_target: float,
                 headroom: float = 0.85):
        self.table = table
        self.ttft_target = ttft_target
        self.itl_target = itl_target
        cap = table.capacity_per_replica(ttft_target, itl_target)
        # headroom: plan for (cap * headroom) so the fleet is not
        # knife-edged at exactly the SLA boundary
        self.capacity = max(cap * headroom, 1e-9)

    def propose(self, s: PoolSignals) -> Tuple[int, str]:
        # shed_rate is REJECTED demand (req/s the fleet refused): without
        # it the SLA maths would size the fleet to only the traffic that
        # survived admission — overload would read as fitting capacity
        demand = s.active_slots + s.queue_depth + s.shed_rate + s.unserved
        need = max(1, math.ceil(demand / self.capacity))
        # breaker-open instances serve nothing: replace them
        need += s.breaker_open
        reason = (f"demand {demand:.0f} seqs (incl. shed "
                  f"{s.shed_rate:.1f}/s) / capacity "
                  f"{self.capacity:.1f} per replica -> {need}")
        if s.ttft_p90 is not None and s.ttft_p90 > self.ttft_target:
            need = max(need, s.replicas + 1)
            reason += (f"; ttft p90 {s.ttft_p90:.3f}s > "
                       f"{self.ttft_target:.3f}s")
        if s.itl_p90 is not None and s.itl_p90 > self.itl_target:
            need = max(need, s.replicas + 1)
            reason += (f"; itl p90 {s.itl_p90:.4f}s > "
                       f"{self.itl_target:.4f}s")
        return need, reason


class _PoolState:
    __slots__ = ("last_scale", "down_streak")

    def __init__(self) -> None:
        self.last_scale = float("-inf")  # ts of the last non-hold decision
        self.down_streak = 0             # consecutive below-current proposals


class PlannerCore:
    """The deterministic decision engine: policy proposal -> override ->
    clamps -> cooldown/flap damping -> :class:`Decision`.

    Bookkeeping (cooldowns, streaks, seq) advances identically in dry-run —
    "emits but does not actuate" means the decision STREAM is the same; only
    the connector call is skipped by the loop above.
    """

    def __init__(self, policy, min_replicas: int = 1, max_replicas: int = 8,
                 cooldown_up: float = 30.0, cooldown_down: float = 120.0,
                 down_consensus: int = 3, dry_run: bool = False):
        if min_replicas < 0 or max_replicas < max(min_replicas, 1):
            raise ValueError(f"bad clamp range [{min_replicas}, "
                             f"{max_replicas}]")
        self.policy = policy
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.cooldown_up = cooldown_up
        self.cooldown_down = cooldown_down
        self.down_consensus = max(down_consensus, 1)
        self.dry_run = dry_run
        self.paused = False
        self.overrides: Dict[str, int] = {}
        # per-pool clamp overrides (the fleet plane's per-model
        # min/max_replicas); a pool absent here uses the global clamps.
        # min 0 is legal per-pool: scale-to-zero is a fleet policy.
        self.pool_clamps: Dict[str, Tuple[int, int]] = {}
        self._pools: Dict[str, _PoolState] = {}
        self._seq = 0

    # ------------------------------------------------------------------
    def set_override(self, overrides: Dict[str, int], paused: bool) -> None:
        """Operator state from ``plannerctl`` (store-watched by the loop)."""
        self.overrides = dict(overrides)
        self.paused = paused

    def set_pool_clamps(self, clamps: Dict[str, Tuple[int, int]]) -> None:
        """Per-pool replica bounds (fleet registry records)."""
        for pool, (lo, hi) in clamps.items():
            if lo < 0 or hi < max(lo, 1):
                raise ValueError(f"bad clamp range [{lo}, {hi}] for "
                                 f"pool {pool!r}")
        self.pool_clamps = {p: (int(lo), int(hi))
                            for p, (lo, hi) in clamps.items()}

    def forget_pool(self, pool: str) -> None:
        """Drop a removed pool's damping state (fleet model removal)."""
        self._pools.pop(pool, None)
        self.pool_clamps.pop(pool, None)

    def _clamp(self, n: int, pool: Optional[str] = None) -> int:
        lo, hi = self.pool_clamps.get(pool,
                                      (self.min_replicas, self.max_replicas))
        return max(lo, min(hi, n))

    # ------------------------------------------------------------------
    def evaluate(self, signals: Dict[str, PoolSignals],
                 now: float) -> List[Decision]:
        decisions = []
        for pool, s in sorted(signals.items()):
            decisions.append(self._evaluate_pool(pool, s, now))
        return decisions

    def _evaluate_pool(self, pool: str, s: PoolSignals,
                       now: float) -> Decision:
        st = self._pools.setdefault(pool, _PoolState())
        self._seq += 1
        d = Decision(pool=pool, current=s.replicas, proposed=s.replicas,
                     target=s.replicas, action=HOLD, reason="",
                     policy=self.policy.name, dry_run=self.dry_run,
                     seq=self._seq, ts=now, signals=s.to_dict())
        if self.paused:
            d.reason = "planner paused by operator"
            d.suppressed = "paused"
            return d
        if pool in self.overrides:
            # operator override: authoritative, bypasses policy AND damping
            d.proposed = int(self.overrides[pool])
            d.target = self._clamp(d.proposed, pool)
            d.reason = f"operator override -> {d.proposed}"
            d.policy = "override"
            if d.target != d.proposed:
                d.suppressed = "clamp"
            d.action = (SCALE_UP if d.target > s.replicas
                        else SCALE_DOWN if d.target < s.replicas else HOLD)
            if d.action != HOLD:
                st.last_scale = now
                st.down_streak = 0
            return d

        proposed, reason = self.policy.propose(s)
        d.proposed = proposed
        d.reason = reason
        bounded = self._clamp(proposed, pool)
        clamped = bounded != proposed
        if bounded == s.replicas:
            d.target = bounded
            if clamped:
                d.suppressed = "clamp"
            st.down_streak = 0
            return d

        if bounded > s.replicas:
            st.down_streak = 0
            if now - st.last_scale < self.cooldown_up:
                d.suppressed = "cooldown"
                return d
            d.target = bounded
            d.action = SCALE_UP
            if clamped:
                d.suppressed = "clamp"
            st.last_scale = now
            return d

        # bounded < current: flap damping — scale-down only after
        # ``down_consensus`` consecutive agreeing evaluations AND the
        # (longer) down cooldown. Surrendering capacity is the risky
        # direction; one idle tick must never shrink the fleet.
        st.down_streak += 1
        if st.down_streak < self.down_consensus:
            d.suppressed = "flap_damping"
            return d
        if now - st.last_scale < self.cooldown_down:
            d.suppressed = "cooldown"
            return d
        d.target = bounded
        d.action = SCALE_DOWN
        if clamped:
            d.suppressed = "clamp"
        st.last_scale = now
        st.down_streak = 0
        return d
