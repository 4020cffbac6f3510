"""What the planner observes: per-pool load/SLA signals from the store.

Everything the decision engine consumes is collapsed into one
:class:`PoolSignals` snapshot per pool, assembled from planes that already
exist:

- live replica count      — the endpoint registration prefix (lease-bound,
  so dead workers vanish with their lease);
- slot/KV occupancy       — per-worker ForwardPassMetrics snapshots under
  ``metrics/`` (the aggregator's scrape source, read directly);
- prefill queue depth     — the shared dynstore work queue's ``q_len``;
- TTFT / ITL percentiles  — the per-stage latency histograms workers publish
  under ``metrics_stage/``, merged across processes;
- circuit-breaker state   — ``dyn_circuit_state`` series in the same dumps
  (instances any observer currently sees OPEN).

The collector is store-only (no data-plane client, no DistributedRuntime
needed beyond a StoreClient), so the planner can run anywhere the store is
reachable — including inside the frontend or as its own binary.
"""

from __future__ import annotations

import json
import logging
import time
from dataclasses import asdict, dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ..llm.disagg import prefill_queue_names
from ..llm.metrics_aggregator import STAGE_PREFIX, fetch_worker_metrics
from ..runtime.component import endpoint_prefix
from ..utils.overload import admission_depth_total, shed_totals

log = logging.getLogger("dynamo_tpu_torch.planner")


@dataclass
class PoolSignals:
    """One pool's observation snapshot — the decision engine's whole input."""

    pool: str                       # "decode" | "prefill" (or any component)
    replicas: int = 0               # live registered instances
    active_slots: float = 0.0       # sum of request_active_slots
    total_slots: float = 0.0        # sum of request_total_slots
    queue_depth: float = 0.0        # prefill queue len / requests waiting
    kv_active: float = 0.0
    kv_total: float = 0.0
    ttft_p90: Optional[float] = None
    itl_p90: Optional[float] = None
    breaker_open: int = 0           # instances some observer sees OPEN
    worker_ids: List[int] = field(default_factory=list)
    # SLO pressure (utils/slo.py): worst error-budget burn per declared
    # objective across windows — burn > 1 means the budget is being spent
    # faster than sustainable, i.e. direct scale-up pressure. Empty when
    # no DYN_SLO_* objectives are configured.
    slo_burn: Dict[str, float] = field(default_factory=dict)
    # overload plane (utils/overload.py): demand the fleet REJECTED.
    # shed_rate is admission rejects + queue sheds per second across the
    # fleet — backlog gauges alone go blind exactly when shedding keeps
    # the queues bounded, so policies must scale on rejected demand too.
    shed_rate: float = 0.0
    # in-flight requests currently held by admission controllers
    admission_depth: float = 0.0
    # scale-from-zero pressure (fleet/model pools only): requests observed
    # for this model while NO replica served it (the frontend's
    # model-labelled 404s). A scaled-to-zero pool has no queue and no
    # occupancy — unserved demand is its only wake signal.
    unserved: float = 0.0

    @property
    def slo_pressure(self) -> float:
        """The single worst burn across objectives (0 = within budget)."""
        return max(self.slo_burn.values(), default=0.0)

    @property
    def occupancy(self) -> float:
        """Batch occupancy 0..1+ (echo/overcommitted engines can exceed 1)."""
        return self.active_slots / self.total_slots if self.total_slots \
            else 0.0

    @property
    def kv_utilization(self) -> float:
        return self.kv_active / self.kv_total if self.kv_total else 0.0

    @property
    def healthy_replicas(self) -> int:
        """Replicas the breaker is not currently vetoing."""
        return max(self.replicas - self.breaker_open, 0)

    def to_dict(self) -> Dict:
        d = asdict(self)
        d["occupancy"] = round(self.occupancy, 4)
        d["kv_utilization"] = round(self.kv_utilization, 4)
        return d


# ---------------------------------------------------------------------------
# histogram quantiles over published stage-metric state dumps
# ---------------------------------------------------------------------------
def quantile_from_states(states: Iterable[Tuple[str, Dict]], metric: str,
                         q: float) -> Optional[float]:
    """Estimate the ``q``-quantile of a histogram metric across every
    published state dump (all label series merged). Linear interpolation
    inside the winning bucket, bounded by its edges; None when no samples.
    """
    buckets: Optional[List[float]] = None
    counts: Optional[List[int]] = None
    total = 0
    for _component, dump in states:
        st = dump.get(metric)
        if not st or st.get("kind") != "histogram":
            continue
        b = list(st.get("buckets") or ())
        if buckets is None:
            buckets, counts = b, [0] * len(b)
        elif b != buckets:
            continue    # mixed bucket layouts: skip rather than lie
        for series in st.get("series", {}).values():
            c = series.get("counts") or []
            for i in range(min(len(c), len(counts))):
                counts[i] += c[i]
            total += int(series.get("total", 0))
    if not total or buckets is None:
        return None
    rank = q * total
    cum = 0
    for i, c in enumerate(counts):
        cum += c
        if cum >= rank:
            lo = buckets[i - 1] if i else 0.0
            hi = buckets[i]
            frac = (rank - (cum - c)) / c if c else 1.0
            return lo + (hi - lo) * frac
    # rank landed in +Inf (observations above the last bucket): the last
    # edge is the honest lower bound
    return buckets[-1]


def filter_states_by_model(states: Iterable[Tuple[str, Dict]],
                           model: str) -> List[Tuple[str, Dict]]:
    """Project one round of ``(component, state_dump)`` pairs down to a
    single model: every metric carrying a ``model`` label keeps only that
    model's series; label-less metrics pass through untouched. This is
    what makes TTFT/ITL quantiles and SLO burn *model-scoped* for fleet
    pools — the histograms were per-model all along (the ``model`` label
    has always been there), the readers just merged them."""
    out: List[Tuple[str, Dict]] = []
    for comp, dump in states:
        nd: Dict = {}
        for name, st in dump.items():
            labels = (list(st.get("labels") or ())
                      if isinstance(st, dict) else [])
            if "model" not in labels:
                nd[name] = st
                continue
            pos = labels.index("model")
            series = {k: v for k, v in (st.get("series") or {}).items()
                      if (k.split("\x1f") + [""])[pos] == model}
            nd[name] = {**st, "series": series}
        out.append((comp, nd))
    return out


def model_request_count(states: Iterable[Tuple[str, Dict]], model: str,
                        status: str = "404") -> float:
    """Cumulative ``dyn_http_requests_total`` count for one (model,
    status) across every frontend dump — the scale-from-zero wake
    counter (frontends label a 404 with the model name when the model is
    fleet-registered, so the label set stays bounded)."""
    total = 0.0
    for _component, dump in states:
        st = dump.get("dyn_http_requests_total")
        if not st or st.get("kind") != "counter":
            continue
        labels = list(st.get("labels") or ())
        try:
            m_pos = labels.index("model")
            s_pos = labels.index("status")
        except ValueError:
            continue
        for skey, val in st.get("series", {}).items():
            parts = skey.split("\x1f")
            if (len(parts) > max(m_pos, s_pos) and parts[m_pos] == model
                    and parts[s_pos] == status):
                total += val
    return total


def model_parked_count(states: Iterable[Tuple[str, Dict]],
                       model: str) -> float:
    """Cumulative queue-until-boot parks for one model
    (``dyn_queue_until_boot_total{model,outcome="parked"}``): a parked
    request never produced the 404 the wake signal was built on, so the
    unserved-demand delta must count it too or parking would starve the
    very boot it waits for."""
    total = 0.0
    for _component, dump in states:
        st = dump.get("dyn_queue_until_boot_total")
        if not st or st.get("kind") != "counter":
            continue
        for skey, val in st.get("series", {}).items():
            parts = skey.split("\x1f")
            if len(parts) >= 2 and parts[0] == model \
                    and parts[1] == "parked":
                total += val
    return total


def open_instance_ids(states: Iterable[Tuple[str, Dict]]) -> Set[str]:
    """Hex instance ids at least one observer's exported
    ``dyn_circuit_state`` series currently marks OPEN (value 2) — shared
    between the planner's breaker signal and dyntop's breaker column."""
    open_ids: Set[str] = set()
    for _component, dump in states:
        st = dump.get("dyn_circuit_state")
        if not st or st.get("kind") != "gauge":
            continue
        labels = list(st.get("labels") or ())
        try:
            pos = labels.index("instance")
        except ValueError:
            continue
        for skey, val in st.get("series", {}).items():
            parts = skey.split("\x1f")
            if len(parts) > pos and val == 2:
                open_ids.add(parts[pos])
    return open_ids


def breaker_open_instances(states: Iterable[Tuple[str, Dict]],
                           worker_ids: Iterable[int]) -> int:
    """Instances in ``worker_ids`` some observer currently sees OPEN."""
    return len(open_instance_ids(states) & {f"{w:x}" for w in worker_ids})


class SignalCollector:
    """Assembles :class:`PoolSignals` for each configured pool from one
    round of store reads. ``pools`` maps a pool name to the component whose
    workers make it up (e.g. ``{"decode": "backend", "prefill": "prefill"}``).
    """

    def __init__(self, store, namespace: str, pools: Dict[str, str],
                 endpoint: str = "generate"):
        from ..utils.slo import SloMonitor

        self.store = store
        self.namespace = namespace
        self.pools = dict(pools)
        self.endpoint = endpoint
        # which path fed the last collect(): "region" when live regional
        # aggregators' pre-merged records served the scrape, "flat" when
        # the per-worker prefix scan did (plannerctl reports this)
        self.last_source = "flat"
        # SLO burn monitor over the same stage dumps: its gauges land on
        # the planner's stage registry (published with the dyn_planner_*
        # series), its breach log feeds PoolSignals.slo_burn
        self.slo = SloMonitor()
        # fleet mode: pool name -> model name. A model pool's latency/SLO
        # signals are computed over filter_states_by_model (its own
        # histogram series), and unserved-request wake pressure is
        # tracked for scale-from-zero.
        self.pool_models: Dict[str, str] = {}
        # per-model monitors observe WITHOUT exporting (the gauge has no
        # model label; the global monitor above owns the exported series)
        self._model_slo: Dict[str, "SloMonitor"] = {}
        self._unserved_prev: Dict[str, float] = {}
        # shed-rate derivation: cumulative fleet shed counters from the
        # last collect, differentiated against the wall between ticks
        self._shed_prev: Optional[Tuple[float, float]] = None

    def forget_pool(self, pool: str) -> None:
        """Drop a removed fleet pool's accumulated state. Without this a
        model removed and later re-added under the same name would
        compute burn deltas against pre-removal snapshots, and rings for
        never-returning models would accumulate for the planner's
        lifetime."""
        self.pool_models.pop(pool, None)
        self._model_slo.pop(pool, None)
        self._unserved_prev.pop(pool, None)

    async def live_instances(self, component: str,
                             known: Iterable[int] = ()) -> List[int]:
        """Live worker ids of one component: endpoint registrations
        (decode-shaped workers) unioned with ``known`` — ids the caller
        already holds from the lease-bound metrics and stage-metrics
        planes. Queue-pull prefill workers register no endpoint at all, so
        counting endpoints alone would read the prefill pool as permanently
        empty (never scaled down, spurious scale-ups forever)."""
        ids = set(known)
        prefix = endpoint_prefix(self.namespace, component, self.endpoint)
        for key, _value in await self.store.get_prefix(prefix):
            try:
                ids.add(int(key.rsplit(":", 1)[1], 16))
            except ValueError:
                log.warning("malformed endpoint key %s", key)
        return sorted(ids)

    async def _fetch_stage(self) -> Tuple[List[Tuple[str, Dict]],
                                          Dict[str, Set[int]],
                                          Optional["object"]]:
        """One scan of the namespace's stage-metrics prefix yielding the
        ``(component, state_dump)`` pairs (quantiles, breaker state), the
        per-component worker-id sets (liveness), and — when the region
        plane served the read — the per-component ForwardPassMetrics
        maps, sparing the per-pool ``metrics/`` scans too. The dumps are
        multi-KB, so fetching them once per tick instead of 1+P times
        matters on a standing daemon; at fleet scale the regional
        aggregators' R pre-merged records replace the N-worker scan
        entirely (flat fallback when no fresh region exists)."""
        from ..llm.metrics_aggregator import (merge_stage_items,
                                              split_stage_key,
                                              stage_base_key)
        from ..runtime.scale.regions import fetch_region_states

        regional = await fetch_region_states(self.store, self.namespace)
        if regional is not None:
            self.last_source = "region"
            return (regional.states,
                    {c: set(ids) for c, ids in regional.ids.items()},
                    regional)
        self.last_source = "flat"
        states: List[Tuple[str, Dict]] = []
        ids: Dict[str, Set[int]] = {}
        prefix = f"{STAGE_PREFIX}{self.namespace}/"
        items = list(await self.store.get_prefix(prefix))
        valid: Dict[str, str] = {}   # base_key -> component
        for key, _value in items:
            base = stage_base_key(key)
            comp, widhex = split_stage_key(base[len(prefix):])
            try:
                wid = int(widhex, 16)
            except ValueError:
                log.warning("malformed stage key %s", key)
                continue
            valid[base] = comp
            if not key.endswith("/delta"):
                # count the replica even if its payload is corrupt — a
                # live worker mid-write must not read as a missing one
                ids.setdefault(comp, set()).add(wid)
        # full+delta overlay: the ONE protocol implementation lives in
        # metrics_aggregator.merge_stage_items
        for base, (d, metrics) in merge_stage_items(items).items():
            if base in valid:
                states.append((d.get("component") or valid[base], metrics))
        return states, ids, None

    def _shed_rate(self, stage_states) -> float:
        total = shed_totals(stage_states)
        now = time.monotonic()
        rate = 0.0
        if self._shed_prev is not None:
            dt = now - self._shed_prev[0]
            if dt > 0:
                # max(0): a restarted frontend resets its counters
                rate = max(0.0, (total - self._shed_prev[1]) / dt)
        self._shed_prev = (now, total)
        return rate

    async def collect(self) -> Dict[str, PoolSignals]:
        stage_states, stage_ids, regional = await self._fetch_stage()
        if self.slo.objectives:
            self.slo.observe(stage_states)
        slo_burn = self.slo.max_burn()
        shed_rate = self._shed_rate(stage_states)
        admission_depth = admission_depth_total(stage_states)
        model_share = self._model_shed_share()
        prefill_q = 0
        for qname in prefill_queue_names(self.namespace):
            try:
                prefill_q += await self.store.q_len(qname)
            except Exception:  # noqa: BLE001 - queue plane optional
                pass
        out: Dict[str, PoolSignals] = {}
        for pool, component in self.pools.items():
            if regional is not None:
                workers = regional.workers_for(component)
            else:
                workers = await fetch_worker_metrics(
                    self.store, self.namespace, component)
            ids = await self.live_instances(
                component,
                known=set(workers) | stage_ids.get(component, set()))
            s = PoolSignals(pool=pool, replicas=len(ids), worker_ids=ids)
            for m in workers.values():
                s.active_slots += m.request_active_slots
                s.total_slots += m.request_total_slots
                s.kv_active += m.kv_active_blocks
                s.kv_total += m.kv_total_blocks
                s.queue_depth += m.num_requests_waiting
            if pool == "prefill":
                # the shared remote-prefill queue is THE prefill backlog.
                # TTFT/ITL are end-to-end serving SLOs recorded by the
                # frontend/decode side — attributing them to the prefill
                # pool would ratchet prefill replicas up for a latency
                # problem more prefill workers cannot fix; its SLA lever
                # is the queue depth above.
                s.queue_depth += prefill_q
            else:
                model = self.pool_models.get(pool)
                # model pools read their OWN latency series; the
                # single-pool shape keeps the all-series merge
                scoped = (filter_states_by_model(stage_states, model)
                          if model else stage_states)
                s.ttft_p90 = quantile_from_states(
                    scoped, "llm_ttft_seconds", 0.90)
                s.itl_p90 = quantile_from_states(
                    scoped, "llm_inter_token_seconds", 0.90)
                # end-to-end SLO burn is serving-side pressure, same
                # attribution rule as ttft/itl above (more prefill
                # replicas can't fix a decode-side latency breach)
                s.slo_burn = (self._model_burn(pool, model, scoped)
                              if model else dict(slo_burn))
                # rejected demand is serving-side pressure too: admission
                # and worker-queue sheds are absorbed by the decode fleet
                # (model pools get their even share — see above)
                share = model_share if model else 1.0
                s.shed_rate = shed_rate * share
                s.admission_depth = admission_depth * share
                if model:
                    s.unserved = self._unserved_delta(
                        pool, model, stage_states, s.replicas)
            s.breaker_open = breaker_open_instances(stage_states, ids)
            out[pool] = s
        return out

    def _model_shed_share(self) -> float:
        """Fleet mode: sheds happen pre-body (no model label), so the
        fleet-wide shed rate cannot be attributed to one model — but
        handing every model pool the FULL rate would let one model's
        storm inflate every pool's demand N-fold. Each model pool gets
        an even 1/N share: total scale-up pressure stays the true fleet
        total, no pool sees phantom demand beyond its share. Classic
        (non-fleet) pools keep full attribution."""
        n = sum(1 for p in self.pools
                if p in self.pool_models and p != "prefill")
        return 1.0 / n if n else 1.0

    def _model_burn(self, pool: str, model: str,
                    scoped_states) -> Dict[str, float]:
        """Per-model SLO burn: a private monitor per model pool fed the
        model-filtered dumps (same DYN_SLO_* objectives, no gauge export
        — the exported series stays the fleet aggregate)."""
        from ..utils.slo import SloMonitor

        mon = self._model_slo.get(pool)
        if mon is None:
            mon = self._model_slo[pool] = SloMonitor(registry_gauge=None)
        if not mon.objectives:
            return {}
        mon.observe(scoped_states)
        return mon.max_burn()

    def _unserved_delta(self, pool: str, model: str, stage_states,
                        replicas: int) -> float:
        """Requests that 404'd on — or were parked at ingress waiting
        for — this model since the last tick, counted only while the
        pool is at zero replicas (once a replica serves, stale 404s from
        the boot race must not keep inflating demand)."""
        total = (model_request_count(stage_states, model, "404")
                 + model_parked_count(stage_states, model))
        prev = self._unserved_prev.get(pool)
        self._unserved_prev[pool] = total
        if replicas > 0 or prev is None:
            return 0.0
        return max(total - prev, 0.0)


def fake_signals(pool: str, **kw) -> PoolSignals:
    """Test/chaos helper: a PoolSignals with keyword overrides."""
    return PoolSignals(pool=pool, **kw)
