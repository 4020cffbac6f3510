"""Cluster metrics aggregator: worker capacity + KV hit rate -> Prometheus.

Subscribes the namespace ``kv-hit-rate`` event plane (emitted by the KV
router per routed request) and periodically scrapes every worker's
ForwardPassMetrics snapshot from the ``metrics/`` store prefix, exposing the
reference's cluster gauges:

- ``llm_kv_blocks_active`` / ``llm_kv_blocks_total``      (per worker)
- ``llm_requests_active_slots`` / ``llm_requests_total_slots`` (per worker)
- ``llm_requests_waiting``                                (per worker)
- ``llm_load_avg`` / ``llm_load_std``                     (per component)
- ``llm_kv_hit_rate_percent``                             (cumulative)

Reference capability: components/metrics/src/main.rs:115-241 (the metrics
binary's event subscription + service scrape + prometheus export) and
lib/llm/src/kv_router/scoring.rs (load_avg/load_std over active slots).
"""

from __future__ import annotations

import asyncio
import json
import logging
import math
import os
import re
import time
from typing import Dict, List, Optional, Sequence

from ..runtime.component import DistributedRuntime
from ..utils.prometheus import Registry, diff_states, render_states
from .kv_router.protocols import ForwardPassMetrics, KVHitRateEvent

log = logging.getLogger("dynamo_tpu_torch.metrics")

METRICS_PREFIX = "metrics/"
STAGE_PREFIX = "metrics_stage/"
#: the store server's own telemetry dump (runtime/store_server.py writes
#: it into its KV under the ``metrics-store`` keyspace family); fetched
#: alongside every namespace's worker dumps so the store shows up on the
#: same merge path as any component
STORE_STAGE_PREFIX = "metrics_stage/_store/"

#: publisher self-accounting excluded from delta change-detection (its
#: own counters change on every push — including them would turn every
#: idle interval into a delta); full snapshots still carry them
_SELF_METRICS = ("dyn_metrics_pushes_total",)


def metrics_key(namespace: str, component: str, worker_id: int) -> str:
    """Store key a worker refreshes its ForwardPassMetrics under (lease-
    bound, so dead workers' snapshots vanish with their lease)."""
    return f"{METRICS_PREFIX}{namespace}/{component}/{worker_id:x}"


def stage_slices() -> int:
    """``DYN_STAGE_SLICES``: worker-stable sub-prefix slices of the
    stage keyspace (``worker_id mod slices``). Regional aggregators
    rendezvous-own SLICES and read only theirs per tick — a region tick
    is O(owned slice), not O(fleet). Must agree fleet-wide (publishers
    and aggregators hash with the same modulus)."""
    from ..utils.knobs import env_float

    return max(1, int(env_float("DYN_STAGE_SLICES", 16, minimum=1.0)))


def stage_slice_of(worker_id: int) -> int:
    return worker_id % stage_slices()


def stage_slice_prefix(namespace: str, slice_idx: int) -> str:
    """Every stage dump of one slice — the aggregator's per-tick read
    unit."""
    return f"{STAGE_PREFIX}{namespace}/s{slice_idx:02x}/"


def stage_key(namespace: str, component: str, worker_id: int) -> str:
    """Store key a worker refreshes its per-stage latency histogram dump
    under (utils.prometheus.StageMetrics state; lease-bound like above).
    The ``s{slice:02x}`` segment is a pure function of the worker id, so
    the key stays stable across aggregator membership churn while
    letting an owner scan just its slices."""
    return (f"{STAGE_PREFIX}{namespace}/s{stage_slice_of(worker_id):02x}/"
            f"{component}/{worker_id:x}")


_SLICE_SEG = re.compile(r"^s[0-9a-f]{2,}$")   # :02x pads, never truncates


def split_stage_key(rest: str) -> tuple:
    """``(component, widhex)`` from the post-``{ns}/`` remainder of a
    stage BASE key. Tolerates the pre-slice legacy layout (no ``sNN``
    segment) so FLAT readers and the ``_store`` dump keep parsing —
    note the regional aggregator's owned-slice scan reads only sliced
    keys by construction: the slice layout (like ``DYN_STAGE_SLICES``
    itself) is a fleet-wide flag day, publishers and aggregators
    upgrade together."""
    parts = rest.split("/")
    if len(parts) >= 3 and _SLICE_SEG.match(parts[0]):
        return parts[1], parts[2]
    return parts[0], (parts[1] if len(parts) > 1 else "")


def stage_delta_key(namespace: str, component: str, worker_id: int) -> str:
    """Sibling key carrying the coalesced since-last-full delta batch
    (see :class:`StagePublisher`); lease-bound like the full snapshot."""
    return stage_key(namespace, component, worker_id) + "/delta"


def stage_base_key(key: str) -> str:
    """The full-snapshot key a stage-KV key belongs to (its own key, or
    the ``/delta``-stripped sibling)."""
    return key[:-len("/delta")] if key.endswith("/delta") else key


def merge_stage_items(items) -> Dict[str, tuple]:
    """Group raw stage-KV ``(key, value)`` pairs by publisher and apply
    the delta overlay: ``{base_key: (full_doc, merged_metrics)}``.

    THE one implementation of the full+delta read protocol (see
    :class:`StagePublisher`) — :func:`fetch_stage_states` and the
    planner's ``SignalCollector`` both read through it. A delta overlays
    its full iff its ``base_seq`` matches the full's ``seq`` (stale
    deltas from before a newer full are dropped, never mis-merged);
    legacy seq-less fulls pass through unchanged; malformed payloads are
    logged and skipped."""
    fulls: Dict[str, Dict] = {}
    deltas: Dict[str, Dict] = {}
    for key, value in items:
        try:
            d = json.loads(value.decode())
        except Exception:
            log.warning("malformed stage metrics at %s", key)
            continue
        (deltas if key.endswith("/delta") else fulls)[
            stage_base_key(key)] = d
    out: Dict[str, tuple] = {}
    for key, d in fulls.items():
        metrics = d.get("metrics") or {}
        delta = deltas.get(key)
        if delta and d.get("seq") is not None \
                and delta.get("base_seq") == d.get("seq"):
            metrics = {**metrics, **(delta.get("metrics") or {})}
        out[key] = (d, metrics)
    return out


class StagePublisher:
    """Delta-batched stage-metrics publishing: O(1) store writes per
    worker per interval, O(changed) bytes instead of O(metrics).

    Protocol (stateless-reader safe):

    - every ``full_every``-th push writes the **full** registry image to
      ``stage_key`` as ``{"component", "seq", "metrics"}``;
    - pushes in between write ONE **cumulative delta** — every metric
      whose state changed since the last full — to ``stage_delta_key`` as
      ``{"component", "base_seq", "metrics"}``. Cumulative (not chained)
      means a reader needs only the (full, delta) pair it can always
      fetch in one ``get_prefix``: overlay delta iff ``base_seq`` matches
      the full's ``seq`` (a stale delta from before a newer full is
      ignored, never mis-merged);
    - an interval where nothing changed writes **nothing**.

    Pushes are additionally rate-limited to one store write per
    ``DYN_METRICS_PUSH_INTERVAL`` seconds (0 = every call), so a worker
    with a fast metrics loop still costs the store one write per
    interval. Outcomes are counted in ``dyn_metrics_pushes_total{kind}``.
    """

    def __init__(self, store, namespace: str, component: str,
                 worker_id: int, lease: int,
                 dump_fn=None, push_interval: Optional[float] = None,
                 full_every: Optional[int] = None):
        self.store = store
        self.namespace = namespace
        self.component = component
        self.worker_id = worker_id
        self.lease = lease
        self._dump_fn = dump_fn
        # the publishing identity IS the flow ledger's local endpoint:
        # a worker's host/dev link labels adopt its hex id the moment it
        # starts publishing (before that: pid)
        from ..obs.flows import set_local_worker

        set_local_worker(worker_id)
        if push_interval is None:
            try:
                push_interval = float(
                    os.environ.get("DYN_METRICS_PUSH_INTERVAL", "0") or 0)
            except ValueError:
                push_interval = 0.0
        self.push_interval = max(push_interval, 0.0)
        if full_every is None:
            try:
                full_every = int(
                    os.environ.get("DYN_METRICS_FULL_EVERY", "10") or 10)
            except ValueError:
                full_every = 10
        self.full_every = max(full_every, 1)
        self._last_full: Optional[Dict[str, Dict]] = None
        self._last_delta: Optional[Dict[str, Dict]] = None
        self._seq = 0             # seq of the last full snapshot
        self._pushes_since_full = 0
        self._last_push_t = 0.0

    def _dump(self) -> Dict[str, Dict]:
        if self._dump_fn is not None:
            return self._dump_fn()
        from ..utils.prometheus import stage_metrics

        return stage_metrics().registry.state_dump()

    async def publish(self, extra_metrics: Optional[Dict] = None,
                      force_full: bool = False) -> str:
        """One publish beat; returns what happened: ``"full"``,
        ``"delta"``, ``"skipped"`` (no change — no write) or
        ``"throttled"`` (inside the push interval — no work done)."""
        from ..utils.prometheus import stage_metrics

        now = time.monotonic()
        if self._last_full is not None and self.push_interval > 0 \
                and now - self._last_push_t < self.push_interval:
            return "throttled"
        cur = self._dump()
        if extra_metrics:
            cur = {**cur, **extra_metrics}
        if self._last_full is None or force_full \
                or self._pushes_since_full >= self.full_every - 1:
            self._seq += 1
            payload = json.dumps({"component": self.component,
                                  "seq": self._seq,
                                  "metrics": cur}).encode()
            await self.store.put(
                stage_key(self.namespace, self.component, self.worker_id),
                payload, lease=self.lease)
            self._last_full = cur
            self._last_delta = None
            self._pushes_since_full = 0
            self._last_push_t = now
            stage_metrics().metrics_pushes.inc("full")
            return "full"
        delta = diff_states(self._last_full, cur, ignore=_SELF_METRICS)
        # skip only when the delta key's content would be unchanged: an
        # EMPTY delta after a non-empty one must still be written, or a
        # metric that reverted to its full-snapshot value (e.g. a queue
        # depth back to 0) would keep reading as the stale delta value
        if delta == (self._last_delta or {}):
            stage_metrics().metrics_pushes.inc("skipped")
            return "skipped"
        # only WRITES advance the full rollover — an idle worker must
        # stay genuinely silent, not re-publish an unchanged full every
        # full_every beats
        self._pushes_since_full += 1
        payload = json.dumps({"component": self.component,
                              "base_seq": self._seq,
                              "metrics": delta}).encode()
        await self.store.put(
            stage_delta_key(self.namespace, self.component,
                            self.worker_id),
            payload, lease=self.lease)
        self._last_delta = delta
        self._last_push_t = now
        stage_metrics().metrics_pushes.inc("delta")
        return "delta"


async def publish_stage_metrics(store, namespace: str, component: str,
                                worker_id: int, lease: int,
                                extra_metrics: Optional[Dict] = None) -> None:
    """One full-snapshot refresh of this process's stage-histogram dump.
    Long-running workers should hold a :class:`StagePublisher` instead
    (delta batching); this one-shot form is kept for callers that publish
    once or rarely. ``extra_metrics`` merges additional registry
    ``state_dump()``s into the payload — the HTTP frontend ships its
    request counters (`dyn_http_*`) this way so availability SLOs can be
    evaluated cluster-wide."""
    from ..utils.prometheus import stage_metrics

    metrics = stage_metrics().registry.state_dump()
    if extra_metrics:
        metrics.update(extra_metrics)
    payload = json.dumps({
        "component": component,
        "metrics": metrics,
    }).encode()
    await store.put(stage_key(namespace, component, worker_id), payload,
                    lease=lease)


async def clear_worker_keys(store, namespace: str, component: str,
                            worker_id: int) -> None:
    """Drop a worker's published metric snapshots at deregistration.

    The keys are lease-bound, so a DEAD worker's snapshots vanish on their
    own — but a worker that exits while its runtime (and lease) live on
    (shared-runtime embedding, model remove/re-add) would otherwise keep
    exporting ghost occupancy/MFU until the process dies. Best-effort: a
    store mid-outage just leaves the lease TTL to do the same job later."""
    for key in (metrics_key(namespace, component, worker_id),
                stage_key(namespace, component, worker_id),
                stage_delta_key(namespace, component, worker_id)):
        try:
            await store.delete(key)
        except Exception:  # noqa: BLE001 - cleanup must never mask exit
            log.debug("metrics key cleanup failed for %s", key)


async def fetch_worker_metrics(store, namespace: str, component: str
                               ) -> Dict[int, "ForwardPassMetrics"]:
    """One component's live ForwardPassMetrics snapshots, keyed by worker
    id — the aggregator's scrape unit, shared with the planner's signal
    collector (which reads the same prefix without a DistributedRuntime)."""
    prefix = f"{METRICS_PREFIX}{namespace}/{component}/"
    workers: Dict[int, ForwardPassMetrics] = {}
    for key, value in await store.get_prefix(prefix):
        try:
            wid = int(key.rsplit("/", 1)[1], 16)
            workers[wid] = ForwardPassMetrics.from_dict(
                json.loads(value.decode()))
        except Exception:
            log.warning("malformed metrics at %s", key)
    return workers


async def _store_dump_items(store) -> List[tuple]:
    """The store server(s)' self-telemetry items. On a sharded store
    every shard publishes its own dump under the SAME key in its own
    KV — read each shard's copy and suffix the key with the shard name
    so the per-publisher grouping in :func:`merge_stage_items` keeps
    them distinct (a routed read would surface only the shard that owns
    the ``metrics-store`` family and silently hide the rest)."""
    if hasattr(store, "get_prefix_on"):
        items: List[tuple] = []
        for i, name in enumerate(store.shard_names):
            try:
                for key, value in await store.get_prefix_on(
                        i, STORE_STAGE_PREFIX):
                    items.append((f"{key}#{name}", value))
            except Exception:  # noqa: BLE001 - a dead shard's dump is
                # simply absent; its families already raise typed errors
                log.debug("store dump unreadable on shard %s", name)
        return items
    return list(await store.get_prefix(STORE_STAGE_PREFIX))


async def fetch_stage_states_ex(store, namespace: Optional[str] = None,
                                exclude_worker: Optional[int] = None
                                ) -> tuple:
    """``(states, region_read)``: the stage states plus the
    :class:`~dynamo_tpu_torch.runtime.scale.regions.RegionStates` that
    served them (None on the flat path) — the JAX package's dyntop renders
    the region metadata, everyone else uses :func:`fetch_stage_states`.

    Delta-aware: a worker's ``.../delta`` batch (see
    :class:`StagePublisher`) is overlaid onto its full snapshot when the
    delta's ``base_seq`` matches the snapshot's ``seq`` — stale deltas
    (from before a newer full) are dropped, and legacy seq-less full
    dumps pass through unchanged. A namespace-scoped fetch also includes
    the store server's own telemetry dump (``metrics_stage/_store/``),
    so the coordination plane itself renders on every merge surface.
    ``exclude_worker`` skips one publisher's dump — a frontend that both
    publishes and scrapes must not merge its own counters twice.

    **Region-aware**: when regional aggregators are live for the
    namespace (runtime/scale/regions.py) the states come from their R
    pre-merged region records instead of the N per-worker dumps — same
    ``(component, state_dump)`` shape, O(regions) read+merge cost. The
    flat scrape remains the fallback (no aggregator, stale records) and
    the only path for ``exclude_worker`` reads: a region record is
    already merged, one publisher cannot be subtracted from it."""
    if namespace and exclude_worker is None:
        from ..runtime.scale.regions import fetch_region_states

        regional = await fetch_region_states(store, namespace)
        if regional is not None:
            states = list(regional.states)
            for _key, (doc, metrics) in merge_stage_items(
                    await _store_dump_items(store)).items():
                states.append((doc.get("component") or "store", metrics))
            return states, regional
    prefix = STAGE_PREFIX + (f"{namespace}/" if namespace else "")
    items = list(await store.get_prefix(prefix))
    if namespace:
        items.extend(await _store_dump_items(store))
    if exclude_worker is not None:
        items = [(k, v) for k, v in items
                 if stage_base_key(k).rsplit("/", 1)[-1]
                 != f"{exclude_worker:x}"]
    return [(doc.get("component")
             or split_stage_key(
                 key[len(STAGE_PREFIX):].split("/", 1)[-1])[0],
             metrics)
            for key, (doc, metrics) in merge_stage_items(items).items()], \
        None


async def fetch_stage_states(store, namespace: Optional[str] = None,
                             exclude_worker: Optional[int] = None
                             ) -> List[tuple]:
    """All published stage dumps as ``(component, state_dump)`` pairs
    (see :func:`fetch_stage_states_ex` for the full contract — this is
    the states-only view every merge surface reads)."""
    states, _regional = await fetch_stage_states_ex(store, namespace,
                                                    exclude_worker)
    return states


class ClusterMetricsAggregator:
    """Aggregates per-worker snapshots and router hit-rate events."""

    def __init__(self, drt: DistributedRuntime, namespace: str,
                 components: Sequence[str], scrape_interval: float = 1.0):
        self.drt = drt
        self.namespace = namespace
        self.components = list(components)
        self.scrape_interval = scrape_interval
        self._task: Optional[asyncio.Task] = None

        self.registry = Registry()
        g = self.registry.gauge
        self.g_kv_active = g("llm_kv_blocks_active",
                             "KV blocks in use on a worker",
                             ("component", "worker_id"))
        self.g_kv_total = g("llm_kv_blocks_total",
                            "KV block capacity of a worker",
                            ("component", "worker_id"))
        self.g_slots_active = g("llm_requests_active_slots",
                                "Active request slots on a worker",
                                ("component", "worker_id"))
        self.g_slots_total = g("llm_requests_total_slots",
                               "Total request slots of a worker",
                               ("component", "worker_id"))
        self.g_waiting = g("llm_requests_waiting",
                           "Requests queued on a worker",
                           ("component", "worker_id"))
        self.g_load_avg = g("llm_load_avg",
                            "Mean active slots across workers",
                            ("component",))
        self.g_load_std = g("llm_load_std",
                            "Stddev of active slots across workers",
                            ("component",))
        self.g_hit_rate = g("llm_kv_hit_rate_percent",
                            "Cumulative prefix-cache hit rate "
                            "(overlap blocks / isl blocks)", ())
        self._isl_blocks = 0
        self._overlap_blocks = 0
        # last scrape snapshot, for tests/introspection
        self.workers: Dict[str, Dict[int, ForwardPassMetrics]] = {}
        # last stage-histogram scrape: (component, state_dump) pairs folded
        # into render() via render_states
        self.stage_states: List[tuple] = []

    # ------------------------------------------------------------------
    async def start(self) -> "ClusterMetricsAggregator":
        ns = self.drt.namespace(self.namespace)

        async def on_hit_rate(payload: Dict) -> None:
            ev = KVHitRateEvent.from_dict(payload)
            self._isl_blocks += ev.isl_blocks
            self._overlap_blocks += ev.overlap_blocks
            if self._isl_blocks:
                self.g_hit_rate.set(
                    value=100.0 * self._overlap_blocks / self._isl_blocks)

        await ns.subscribe("kv-hit-rate", on_hit_rate)
        self._task = asyncio.create_task(self._scrape_loop())
        return self

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()

    # ------------------------------------------------------------------
    async def scrape_once(self) -> None:
        for comp in self.components:
            workers = await fetch_worker_metrics(self.drt.store,
                                                 self.namespace, comp)
            self.workers[comp] = workers
            self._export(comp, workers)
        self.stage_states = await fetch_stage_states(self.drt.store,
                                                     self.namespace)

    def _export(self, comp: str,
                workers: Dict[int, ForwardPassMetrics]) -> None:
        for g in (self.g_kv_active, self.g_kv_total, self.g_slots_active,
                  self.g_slots_total, self.g_waiting):
            g.clear_label(0, comp)
        loads: List[float] = []
        for wid, m in workers.items():
            w = f"{wid:x}"
            self.g_kv_active.set(comp, w, value=m.kv_active_blocks)
            self.g_kv_total.set(comp, w, value=m.kv_total_blocks)
            self.g_slots_active.set(comp, w, value=m.request_active_slots)
            self.g_slots_total.set(comp, w, value=m.request_total_slots)
            self.g_waiting.set(comp, w, value=m.num_requests_waiting)
            loads.append(m.request_active_slots)
        if loads:
            avg = sum(loads) / len(loads)
            var = sum((x - avg) ** 2 for x in loads) / len(loads)
            self.g_load_avg.set(comp, value=avg)
            self.g_load_std.set(comp, value=math.sqrt(var))
        else:
            # no workers left: the series must vanish, not freeze
            self.g_load_avg.clear_label(0, comp)
            self.g_load_std.clear_label(0, comp)

    async def _scrape_loop(self) -> None:
        while True:
            try:
                await self.scrape_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("cluster metrics scrape failed")
            await asyncio.sleep(self.scrape_interval)

    # ------------------------------------------------------------------
    def render(self) -> str:
        return self.registry.render() + render_states(self.stage_states)
