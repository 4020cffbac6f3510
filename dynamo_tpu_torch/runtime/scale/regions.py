"""Hierarchical observer tree: regional pre-merge of worker telemetry.

The port's copy of the JAX package's module, record for record, so a
fleet that mixes the two packages reads one region plane. On the flat
path every observer (the JAX package's planner signal collector, SLO
monitor and dyntop, the frontend's ``/metrics``) re-fetches and
re-merges every per-worker ``metrics_stage/`` dump each tick, a cost that
grows with the fleet; the JAX package's fleet soak measured the merge
saturating before the store did. The tree:

- **Regional aggregators** (``cli/aggregator.py`` daemons) each own a
  slice of the fleet — assignment is a rendezvous hash of the worker id
  over the live aggregator ids, so membership churn only re-homes the
  dead region's workers. Each tick an aggregator scrapes its owned
  workers' ``metrics_stage/`` dumps (resolving the full+delta overlay
  with the existing :func:`~dynamo_tpu_torch.llm.metrics_aggregator.
  merge_stage_items` protocol) and their ForwardPassMetrics snapshots,
  pre-merges them per component with
  :func:`~dynamo_tpu_torch.utils.prometheus.merge_state_dumps`, and publishes
  ONE lease-bound region record.
- **Readers** fetch R region records instead of N worker dumps:
  :func:`fetch_region_states` returns the same ``(component,
  state_dump)`` shape every existing consumer (quantiles, SLO burn,
  breaker state, shed totals) already eats, plus per-component worker
  ids and per-worker ForwardPassMetrics. When no fresh record exists
  the caller falls back to the flat scrape — single-node zero-config
  deployments never notice the plane exists.
- **Region death**: records are lease-bound, so a dead aggregator's
  record vanishes; the surviving peers (each watches the ``regions/``
  prefix) see the membership change and the rendezvous re-assignment
  absorbs the orphaned workers on their next tick. Readers skip records
  older than ``DYN_REGION_STALE`` seconds — a wedged (but lease-alive)
  aggregator degrades its region to invisible rather than serving
  frozen telemetry.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ...utils.knobs import env_float
from .rendezvous import rendezvous_owner

log = logging.getLogger("dynamo_tpu_torch.scale.regions")

REGIONS_PREFIX = "regions/"


def regions_prefix(namespace: str) -> str:
    return f"{REGIONS_PREFIX}{namespace}/"


def region_key(namespace: str, agg_id: int) -> str:
    """One aggregator's record key; the suffix is its lease id (like an
    endpoint registration), so the record dies with the daemon."""
    return f"{REGIONS_PREFIX}{namespace}/{agg_id:x}"


def region_interval() -> float:
    return env_float("DYN_REGION_INTERVAL", 2.0, minimum=0.1)


def region_stale_s() -> float:
    """Age beyond which a region record is treated as dead (default
    3 publish intervals — one missed tick survives, a wedge does not)."""
    return env_float("DYN_REGION_STALE", 3.0 * region_interval(),
                     minimum=0.5)


@dataclass
class RegionRecord:
    """What one aggregator publishes per tick. ``components`` maps a
    component name to its pre-merged view::

        {"worker_ids": [int, ...],          # owned publishers
         "state": <merged registry state_dump>,
         "fpm": {"<wid:x>": <ForwardPassMetrics dict>, ...}}
    """

    agg_id: int
    seq: int
    ts: float                    # wall clock of the merge
    interval_s: float
    peers: int                   # live aggregators this one saw
    worker_count: int
    components: Dict[str, Dict] = field(default_factory=dict)
    merge_s: List[float] = field(default_factory=list)   # recent ticks

    def to_dict(self) -> Dict:
        return {"agg_id": self.agg_id, "seq": self.seq, "ts": self.ts,
                "interval_s": self.interval_s, "peers": self.peers,
                "worker_count": self.worker_count,
                "components": self.components,
                "merge_s": [round(v, 6) for v in self.merge_s]}

    @classmethod
    def from_dict(cls, d: Dict) -> "RegionRecord":
        return cls(agg_id=int(d["agg_id"]), seq=int(d.get("seq", 0)),
                   ts=float(d.get("ts", 0.0)),
                   interval_s=float(d.get("interval_s", 0.0)),
                   peers=int(d.get("peers", 1)),
                   worker_count=int(d.get("worker_count", 0)),
                   components=dict(d.get("components") or {}),
                   merge_s=list(d.get("merge_s") or ()))


@dataclass
class RegionStates:
    """One region-tree read, in every shape the flat consumers expect."""

    states: List[Tuple[str, Dict]]            # (component, state_dump)
    ids: Dict[str, Set[int]]                  # component -> worker ids
    fpm: Dict[str, Dict[int, Dict]]           # component -> wid -> dict
    meta: Dict                                # the dyntop "regions:" line

    @property
    def worker_count(self) -> int:
        return sum(len(v) for v in self.ids.values())

    def workers_for(self, component: str) -> Dict[int, object]:
        """One component's ForwardPassMetrics off the region records —
        the shared parse both the planner's collector and dyntop use
        (a malformed row skips that worker, never the read)."""
        from ...llm.kv_router.protocols import ForwardPassMetrics

        out: Dict[int, object] = {}
        for wid, d in (self.fpm.get(component) or {}).items():
            try:
                out[wid] = ForwardPassMetrics.from_dict(d)
            except Exception:  # noqa: BLE001 - one bad record must not
                # blind the whole component
                log.warning("malformed region fpm for %s/%x",
                            component, wid)
        return out


def _percentile(vals: List[float], q: float) -> Optional[float]:
    if not vals:
        return None
    s = sorted(vals)
    return s[min(int(q * len(s)), len(s) - 1)]


async def fetch_region_states(store, namespace: str,
                              stale_s: Optional[float] = None,
                              now: Optional[float] = None
                              ) -> Optional[RegionStates]:
    """Read the region plane: None when no aggregator publishes a fresh
    record for this namespace (caller falls back to the flat scrape).
    Stale records are skipped — and if EVERY record is stale the whole
    read returns None rather than serving a frozen fleet.

    Staleness is skew-tolerant: the ``stale_s`` window compares a
    record against the FRESHEST record's timestamp (aggregator clocks
    vs each other — a single wedged aggregator goes invisible while its
    peers keep publishing), while the reader's own wall clock only
    backstops the all-aggregators-wedged case at a much coarser window
    (``10 x stale_s``, >= 60s) — so a reader host with modest clock
    skew cannot silently disable the whole region plane."""
    stale_s = region_stale_s() if stale_s is None else stale_s
    now = time.time() if now is None else now
    try:
        items = await store.get_prefix(regions_prefix(namespace))
    except Exception:  # noqa: BLE001 - region plane optional by design
        log.debug("region fetch failed; flat fallback", exc_info=True)
        return None
    records: List[RegionRecord] = []
    for key, value in items:
        try:
            records.append(RegionRecord.from_dict(
                json.loads(value.decode())))
        except Exception:  # noqa: BLE001 - one bad record must not blind
            log.warning("malformed region record at %s", key)
    max_ts = max((r.ts for r in records), default=0.0)
    wedge_s = max(10.0 * stale_s, 60.0)
    fresh = [r for r in records
             if max_ts - r.ts <= stale_s and now - r.ts <= wedge_s]
    if not fresh:
        return None
    states: List[Tuple[str, Dict]] = []
    ids: Dict[str, Set[int]] = {}
    fpm: Dict[str, Dict[int, Dict]] = {}
    merge_samples: List[float] = []
    per_region: List[Dict] = []
    for r in sorted(fresh, key=lambda r: r.agg_id):
        merge_samples.extend(r.merge_s)
        per_region.append({"agg_id": f"{r.agg_id:x}",
                           "workers": r.worker_count,
                           "age_s": round(max(now - r.ts, 0.0), 3),
                           "seq": r.seq})
        for comp, view in r.components.items():
            st = view.get("state")
            if st:
                states.append((comp, st))
            comp_ids = ids.setdefault(comp, set())
            for wid in view.get("worker_ids") or ():
                comp_ids.add(int(wid))
            comp_fpm = fpm.setdefault(comp, {})
            for widhex, d in (view.get("fpm") or {}).items():
                try:
                    comp_fpm[int(widhex, 16)] = d
                except ValueError:
                    continue
    meta = {
        "aggregators": len(fresh),
        "stale": len(records) - len(fresh),
        "workers": sum(r.worker_count for r in fresh),
        "workers_min": min((r.worker_count for r in fresh), default=0),
        "workers_max": max((r.worker_count for r in fresh), default=0),
        "merge_p50_s": _percentile(merge_samples, 0.50),
        "merge_p99_s": _percentile(merge_samples, 0.99),
        "age_max_s": max((x["age_s"] for x in per_region), default=0.0),
        "regions": per_region,
    }
    return RegionStates(states=states, ids=ids, fpm=fpm, meta=meta)


# ---------------------------------------------------------------------------
# the aggregator daemon core (cli/aggregator.py drives it)
# ---------------------------------------------------------------------------
class RegionalAggregator:
    """One node of the observer tree. Owns the rendezvous slice of the
    namespace's workers implied by the live aggregator membership (its
    peers' lease-bound ``regions/`` records, watched live), pre-merges
    their telemetry every ``interval`` seconds and publishes one region
    record under its own lease."""

    def __init__(self, store, namespace: str, agg_id: int, lease: int,
                 interval: Optional[float] = None,
                 merge_ring: int = 32):
        self.store = store
        self.namespace = namespace
        self.agg_id = agg_id
        self.lease = lease
        self.interval = region_interval() if interval is None else interval
        self._member = f"{agg_id:x}"
        self._peers: Set[str] = {self._member}
        self._seq = 0
        self._merge_ring = merge_ring
        self._merge_s: List[float] = []
        self._task: Optional[asyncio.Task] = None
        self.last_record: Optional[RegionRecord] = None

    # -- membership ----------------------------------------------------
    async def _on_peer(self, key: str, value: Optional[bytes],
                       deleted: bool) -> None:
        member = key.rsplit("/", 1)[-1]
        if deleted:
            if member != self._member:
                self._peers.discard(member)
                log.info("region peer %s died; %d aggregators remain "
                         "(orphans re-absorb next tick)", member,
                         len(self._peers))
        else:
            if member not in self._peers:
                log.info("region peer %s joined (%d aggregators)",
                         member, len(self._peers) + 1)
            self._peers.add(member)

    async def start(self) -> "RegionalAggregator":
        snapshot = await self.store.watch_prefix(
            regions_prefix(self.namespace), self._on_peer)
        for key, _value in snapshot:
            self._peers.add(key.rsplit("/", 1)[-1])
        return self

    def owns(self, worker_id: int) -> bool:
        """Ownership is rendezvous over the worker's stage SLICE (its
        worker-stable ``metrics_stage/`` sub-prefix), so the stage scan
        below can read exactly the owned slices and nothing else while
        ForwardPassMetrics filtering agrees with it."""
        from ...llm.metrics_aggregator import stage_slice_of

        return rendezvous_owner(stage_slice_of(worker_id),
                                sorted(self._peers)) == self._member

    def owned_slices(self) -> List[int]:
        from ...llm.metrics_aggregator import stage_slices

        members = sorted(self._peers)
        return [s for s in range(stage_slices())
                if rendezvous_owner(s, members) == self._member]

    # -- one tick ------------------------------------------------------
    async def tick(self) -> RegionRecord:
        from ...llm.metrics_aggregator import (METRICS_PREFIX,
                                               STAGE_PREFIX,
                                               merge_stage_items,
                                               split_stage_key,
                                               stage_base_key,
                                               stage_slice_prefix)
        from ...utils.prometheus import merge_state_dumps, stage_metrics

        t0 = time.perf_counter()
        ns_prefix = f"{STAGE_PREFIX}{self.namespace}/"
        # FPM scan FIRST: the round-trip also drains any pending peer-
        # membership watch deliveries on this connection (a peer's
        # ``regions/`` put strictly precedes our request on the wire), so
        # the slice-ownership computed below reflects the membership as
        # of this tick — the ordering the pre-slice code got implicitly
        # from awaiting the full stage scan before filtering
        fpm: Dict[str, Dict[str, Dict]] = {}
        fpm_raw: Dict[str, Dict[int, bytes]] = {}
        fpm_prefix = f"{METRICS_PREFIX}{self.namespace}/"
        for key, value in await self.store.get_prefix(fpm_prefix):
            comp, _, widhex = key[len(fpm_prefix):].partition("/")
            try:
                wid = int(widhex, 16)
            except ValueError:
                log.warning("malformed metrics key %s", key)
                continue
            # raw bytes only here: the ownership filter below runs before
            # any JSON decode, so each aggregator decodes its N/R share
            # of the fleet's payloads, not all N
            fpm_raw.setdefault(comp, {})[wid] = value
        # read ONLY the owned slices: each is a worker-stable sub-prefix
        # of the stage keyspace, so a region tick's store read (and the
        # JSON decode + full/delta overlay below, the expensive part) is
        # O(owned workers) — membership churn re-homes whole slices
        # without any publisher writing a new key
        comp_states: Dict[str, List[Dict]] = {}
        comp_ids: Dict[str, Set[int]] = {}
        owned_items = []
        # the slice reads are independent: fetch them concurrently (one
        # round-trip's latency, not owned-slice-count of them)
        slice_reads = await asyncio.gather(*(
            self.store.get_prefix(stage_slice_prefix(self.namespace, s))
            for s in self.owned_slices()))
        for items in slice_reads:
            for key, value in items:
                base = stage_base_key(key)
                comp, widhex = split_stage_key(base[len(ns_prefix):])
                try:
                    wid = int(widhex, 16)
                except ValueError:
                    log.warning("malformed stage key %s", key)
                    continue
                owned_items.append((key, value))
                # liveness must not depend on payload health: a live
                # worker mid-write still counts as a replica (same rule
                # as the flat collector)
                comp_ids.setdefault(comp, set()).add(wid)
        for base, (doc, metrics) in merge_stage_items(
                owned_items).items():
            comp, _widhex = split_stage_key(base[len(ns_prefix):])
            comp_states.setdefault(doc.get("component") or comp,
                                   []).append(metrics)
        for comp, rows in fpm_raw.items():
            for wid, value in rows.items():
                if not self.owns(wid):
                    continue
                try:
                    fpm.setdefault(comp, {})[f"{wid:x}"] = json.loads(
                        value.decode())
                except ValueError:
                    log.warning("malformed metrics payload for %s/%x",
                                comp, wid)
        components: Dict[str, Dict] = {}
        for comp in set(comp_ids) | set(fpm) | set(comp_states):
            components[comp] = {
                "worker_ids": sorted(comp_ids.get(comp, ())),
                "state": merge_state_dumps(comp_states.get(comp, ())),
                "fpm": fpm.get(comp, {}),
            }
        dt = time.perf_counter() - t0
        self._merge_s.append(dt)
        del self._merge_s[:-self._merge_ring]
        self._seq += 1
        record = RegionRecord(
            agg_id=self.agg_id, seq=self._seq, ts=time.time(),
            interval_s=self.interval, peers=len(self._peers),
            worker_count=sum(len(v) for v in comp_ids.values()),
            components=components, merge_s=list(self._merge_s))
        await self.store.put(
            region_key(self.namespace, self.agg_id),
            json.dumps(record.to_dict()).encode(), lease=self.lease)
        stage_metrics().region_merge.observe(value=dt)
        self.last_record = record
        return record

    # -- standing loop --------------------------------------------------
    async def run(self) -> None:
        from ...runtime.store_client import StoreError

        while True:
            try:
                await self.tick()
            except asyncio.CancelledError:
                raise
            except StoreError:
                log.warning("region tick skipped (store unreachable)")
            except Exception:
                log.exception("region tick failed")
            await asyncio.sleep(self.interval)

    def start_loop(self) -> None:
        from ...utils.aiotasks import spawn

        self._task = spawn(self.run(), name=f"region-{self._member}")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
