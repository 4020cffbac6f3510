"""Cross-model chip arbitration: N pools, one budget, burn decides.

The per-pool policies (``planner/policy.py``) each propose replicas as if
their model owned the cluster; the arbiter makes those proposals
*jointly* feasible under the global chip budget. Allocation runs in two
deterministic passes:

**Tiered grant** — chips are handed out one replica at a time, tier by
tier, entitlement-ordered (priority desc, burn desc, name) inside each
tier:

1. *floors*: every model's ``min_replicas`` (the operator's availability
   promise — never arbitrated away while the budget physically allows);
2. *retention*: up to each model's live replica count (what a model is
   already using is granted before anyone grows);
3. *growth*: the rest of the budget, round-robin in entitlement order so
   equal claimants split leftover chips instead of the first starving
   its peers.

**Preemption** — after the tiered grant, a growth-starved model whose
SLO burn exceeds a retention-holding model's burn by
``DYN_FLEET_PREEMPT_MARGIN`` (or whose priority class is strictly
higher) takes chips from it: the victim's grant shrinks toward its
floor, the beneficiary boots. The margin is hysteresis — a preemption
costs a drain plus a cold boot, so a borderline burn difference must not
thrash replicas between models every tick. This is the "scale model A
down to boot model B when B's burn is worse" rule.

Chip-exempt pools (``chips_per_replica == 0``: CPU echo fleets, test
fixtures) pass through untouched — the budget constrains accelerators,
not processes.

The arbiter is pure and clock-free: claims in, grants out, every
reduction annotated so ``plannerctl decisions`` shows the arbitration
the same way it shows cooldowns and clamps.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..utils.knobs import env_float

log = logging.getLogger("dynamo_tpu_torch.fleet")

#: Decision.suppressed tag for budget-reduced targets
SUPPRESSED_CHIP_BUDGET = "chip_budget"


@dataclass
class PoolClaim:
    """One model pool's input to the arbitration round."""

    model: str
    want: int                 # clamped policy target (replicas)
    current: int              # live replicas
    chips_per_replica: int
    min_replicas: int
    priority: int = 0
    burn: float = 0.0         # worst SLO burn (0 = within budget)
    #: model-mobility swap class ("" = not swap-capable): a victim whose
    #: swap_group matches the beneficiary's hands its chips over by
    #: in-place weight swap — seconds instead of drain + cold spawn
    swap_group: str = ""

    @property
    def rank(self) -> Tuple:
        """Entitlement sort key (ascending = most entitled first)."""
        return (-self.priority, -self.burn, self.model)


class ChipArbiter:
    """Grant replicas under ``budget`` chips; see module docstring."""

    def __init__(self, budget: int, preempt_margin: Optional[float] = None):
        self.budget = max(int(budget), 0)
        self.preempt_margin = (
            env_float("DYN_FLEET_PREEMPT_MARGIN", 0.5, minimum=0.0)
            if preempt_margin is None else float(preempt_margin))

    def _outranks(self, hot: PoolClaim, victim: PoolClaim) -> bool:
        """May ``hot`` preempt ``victim``? Strictly higher priority
        always wins; within a class the burn gap must clear the margin."""
        if hot.priority != victim.priority:
            return hot.priority > victim.priority
        return hot.burn > victim.burn + self.preempt_margin

    # ------------------------------------------------------------------
    def grant(self, claims: List[PoolClaim]
              ) -> Dict[str, Tuple[int, Optional[str]]]:
        """{model: (granted_replicas, reason_or_None)} — reason is set
        only when the grant came out below the claim's ``want``."""
        out: Dict[str, Tuple[int, Optional[str]]] = {
            c.model: (c.want, None) for c in claims
            if c.chips_per_replica <= 0}          # budget-exempt
        paying = sorted((c for c in claims if c.chips_per_replica > 0),
                        key=lambda c: c.rank)
        if not paying:
            return out

        granted = {c.model: 0 for c in paying}
        left = self.budget

        def tier(target) -> None:
            nonlocal left
            hungry = list(paying)
            while hungry:
                progressed = False
                for c in list(hungry):
                    if (granted[c.model] >= min(target(c), c.want)
                            or c.chips_per_replica > left):
                        hungry.remove(c)
                        continue
                    granted[c.model] += 1
                    left -= c.chips_per_replica
                    progressed = True
                if not progressed:
                    break

        tier(lambda c: c.min_replicas)
        tier(lambda c: c.current)
        tier(lambda c: c.want)

        for c in paying:
            if granted[c.model] < min(c.min_replicas, c.want):
                log.warning(
                    "fleet arbiter: budget %d cannot cover %s's "
                    "min_replicas floor (%d x %d chips)", self.budget,
                    c.model, c.min_replicas, c.chips_per_replica)

        # ---- preemption: hot growth-starved models take retention
        # chips from colder models (toward their floors), margin-gated.
        # Each attempt is transactional: victims are drained only if the
        # freed chips actually complete a whole replica for the
        # beneficiary — a partial drain would cost the victim capacity
        # while the chips sit stranded (nobody they'd fit).
        preempted: Dict[str, str] = {}    # victim -> beneficiary
        blocked: set = set()              # hot models preemption can't help
        for _ in range(sum(c.want for c in paying) + len(paying)):
            hot = next((c for c in paying            # entitlement order
                        if granted[c.model] < c.want
                        and c.model not in blocked), None)
            if hot is None:
                break
            snapshot, left0 = dict(granted), left
            drained: List[PoolClaim] = []
            while left < hot.chips_per_replica:
                # eligible victims, coldest first; among them, a hot-swap
                # sibling (same non-empty swap_group) is preferred — its
                # chips hand over by in-place weight swap, which costs
                # seconds, while any other victim costs drain + cold
                # spawn. Entitlement order is preserved WITHIN each class
                # so the preference never drains a hotter sibling when an
                # equally-preemptible colder one exists.
                eligible = [v for v in reversed(paying)
                            if v.model != hot.model
                            and granted[v.model] > v.min_replicas
                            and self._outranks(hot, v)]
                victim = next(
                    (v for v in eligible
                     if v.swap_group and v.swap_group == hot.swap_group),
                    eligible[0] if eligible else None)
                if victim is None:
                    break
                granted[victim.model] -= 1
                left += victim.chips_per_replica
                drained.append(victim)
            if left < hot.chips_per_replica:
                # couldn't complete a replica: roll the drain back and
                # stop considering this claim (a smaller-chip hungry
                # model may still preempt successfully)
                granted, left = snapshot, left0
                blocked.add(hot.model)
                continue
            granted[hot.model] += 1
            left -= hot.chips_per_replica
            for v in drained:
                preempted[v.model] = hot.model

        for c in paying:
            got = granted[c.model]
            if got >= c.want:
                out[c.model] = (got, None)
            elif c.model in preempted:
                b = next(x for x in paying if x.model == preempted[c.model])
                why = (f"priority {b.priority} vs {c.priority}"
                       if b.priority != c.priority
                       else f"burn {b.burn:.2f} vs {c.burn:.2f}")
                out[c.model] = (got, (
                    f"chip budget {self.budget}: yielded to "
                    f"{b.model} ({why})"))
            else:
                out[c.model] = (got, (
                    f"chip budget {self.budget}: {c.want} replicas x "
                    f"{c.chips_per_replica} chip(s) does not fit"))
        return out
