"""KvScheduler: pick the worker for a tokenized request.

Default cost (reference formula, kv_router/scheduler.rs:92-205, extended
with the byte-honest residency dimension):

    logit = 2.0 * overlap_blocks_norm - cache_usage
            - normalized_active_slots - kv_bytes_frac

highest logit wins; ties break randomly; if every candidate is saturated the
request waits for capacity. ``kv_bytes_frac`` is the worker's published KV
working set in bytes over its device+host capacity — the term that prices a
long paged context at its true footprint (0 when unpublished). The selector
is pluggable (CustomWorkerSelector override point,
components/router/src/main.rs:36-95).
"""

from __future__ import annotations

import asyncio
import collections
import os
import random
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ...runtime.engine import EngineError
from .indexer import OverlapScores
from .protocols import ForwardPassMetrics, KVHitRateEvent


def _fast_fail_enabled() -> bool:
    """``DYN_ROUTER_FAST_FAIL=1``: a fully saturated/breaker-open candidate
    set answers 503 immediately instead of capacity-wait polling for up to
    ``timeout_s`` — under overload the wait is doomed, and every parked
    waiter holds resources the fleet needs to drain. Default off (the
    pre-overload-control wait behavior)."""
    return os.environ.get("DYN_ROUTER_FAST_FAIL", "0").lower() in (
        "1", "true", "yes", "on")


@dataclass
class WorkerSnapshot:
    worker_id: int
    metrics: ForwardPassMetrics


@dataclass
class ProcessedEndpoints:
    """Aggregated view of live workers (from the metrics aggregator)."""

    workers: Dict[int, ForwardPassMetrics] = field(default_factory=dict)

    @property
    def load_avg(self) -> float:
        if not self.workers:
            return 0.0
        vals = [m.request_active_slots for m in self.workers.values()]
        return sum(vals) / len(vals)

    @property
    def load_std(self) -> float:
        if not self.workers:
            return 0.0
        avg = self.load_avg
        vals = [m.request_active_slots for m in self.workers.values()]
        return (sum((v - avg) ** 2 for v in vals) / len(vals)) ** 0.5


WorkerSelector = Callable[
    [Sequence[int], int, OverlapScores, ProcessedEndpoints],
    Optional[int]]


def _transfer_weight() -> float:
    """``DYN_ROUTER_TRANSFER_WEIGHT``: logit penalty per expected
    KV-transfer second of a placement (0 = term off)."""
    from ...utils.knobs import env_float

    return env_float("DYN_ROUTER_TRANSFER_WEIGHT", 1.0, minimum=0.0)


def score_candidates(tokens: Sequence[int], block_size: int,
                     overlaps: OverlapScores,
                     endpoints: ProcessedEndpoints,
                     cluster=None) -> List[Dict[str, Any]]:
    """The full per-candidate score breakdown of the default cost — one
    dict per live worker with every term the logit is built from, so a
    routing decision is auditable after the fact instead of being a bare
    worker id (the decision-audit ring and ``/v1/router/decisions`` expose
    exactly this).

    ``cluster`` (a :class:`~..kv_cluster.registry.ClusterOverlap`, None
    when cluster KV sharing is off) folds fleet-wide prefix availability
    into the overlap term: a candidate's OWN host/disk-tier coverage
    counts like a device hit (admission restores it locally), and the
    best prefix some *other* worker holds counts at the transfer-cost
    weight — so local hit > peer hit > miss, by construction.

    With a pair-aware cost model armed (``cluster.pair_weight`` /
    ``pair_seconds``), donor election prices the (donor → candidate)
    network pair and every candidate's logit is additionally charged
    ``transfer_weight x expected-transfer-seconds`` for the bytes its
    election would move — a candidate behind a slow pair loses to one a
    cheap fetch away even at equal prefix coverage (FlowKV/NetKV)."""
    isl_blocks = max(1, len(tokens) // block_size)
    tw = _transfer_weight()
    out: List[Dict[str, Any]] = []
    for wid, m in endpoints.workers.items():
        saturated = bool(
            m.request_total_slots
            and m.request_active_slots >= m.request_total_slots
            and m.num_requests_waiting > 0)
        overlap = overlaps.scores.get(wid, 0)
        donor = None
        donor_blocks = 0
        local_eq = overlap
        if cluster is not None:
            # the worker's own tier residency is a local hit: restore is
            # a host->device upload, no network
            local_eq = max(overlap, cluster.owners.get(wid, 0))
            donor, donor_blocks = cluster.donor_for(wid, local_eq)
        extra = max(0, donor_blocks - local_eq) if donor is not None else 0
        peer_w = (cluster.weight_for(donor, wid, extra)
                  if cluster is not None and donor is not None else 0.0)
        eff = min(local_eq + peer_w * extra, float(isl_blocks))
        overlap_norm = eff / isl_blocks
        # expected seconds the elected fetch would spend moving bytes
        # onto THIS candidate (0 without a donor / without a cost model)
        xfer_s = (cluster.seconds_for(donor, wid, extra)
                  if cluster is not None and donor is not None and extra
                  else 0.0)
        # ledger provenance of the charged transfer term: which bandwidth
        # estimate ("pair" EWMA fed by the byte-flow ledger, "into_dst"
        # mean, "fleet" rate, optimistic "default") priced xfer_s
        xfer_src = (cluster.source_for(donor, wid)
                    if cluster is not None and donor is not None and extra
                    else "")
        load = (m.request_active_slots / m.request_total_slots
                if m.request_total_slots else 0.0)
        # bytes-resident dimension: the worker's total KV working set
        # (device pool + pinned host paging blocks) over its device+host
        # capacity. cache_usage prices device blocks; this prices what
        # slots cannot see — a 128k paged context pinning half the host
        # tier. 0 on workers that don't publish the byte fields.
        bytes_frac = (m.kv_resident_bytes / m.kv_capacity_bytes
                      if m.kv_capacity_bytes else 0.0)
        # full precision: the selector's tie-break compares these — the
        # audit ring rounds at serialization time, not here
        out.append({
            "worker_id": wid,
            "overlap_blocks": overlap,
            "cluster_local_blocks": local_eq,
            "kv_donor": donor,
            "kv_donor_blocks": donor_blocks,
            "overlap_norm": overlap_norm,
            "cache_usage": m.cache_usage,
            "load": load,
            "kv_bytes_frac": bytes_frac,
            "transfer_seconds": xfer_s,
            "transfer_src": xfer_src,
            "logit": 2.0 * overlap_norm - m.cache_usage - load
            - bytes_frac - tw * xfer_s,
            "saturated": saturated,
        })
    return out


def default_selector(tokens: Sequence[int], block_size: int,
                     overlaps: OverlapScores,
                     endpoints: ProcessedEndpoints,
                     rng: Optional[random.Random] = None,
                     candidates: Optional[List[Dict[str, Any]]] = None
                     ) -> Optional[int]:
    """The 2*overlap - usage - load cost; None => no capacity anywhere.
    ``candidates`` takes a precomputed :func:`score_candidates` result so
    the audited scheduler scores each decision exactly once."""
    rng = rng or random
    best: List[int] = []
    best_logit = None
    if candidates is None:
        candidates = score_candidates(tokens, block_size, overlaps,
                                      endpoints)
    for c in candidates:
        if c["saturated"]:
            continue
        logit = c["logit"]
        if best_logit is None or logit > best_logit + 1e-9:
            best, best_logit = [c["worker_id"]], logit
        elif abs(logit - best_logit) <= 1e-9:
            best.append(c["worker_id"])
    if not best:
        return None
    return rng.choice(best)


def _audit_ring_size() -> int:
    try:
        return max(1, int(os.environ.get("DYN_ROUTER_AUDIT", "512")))
    except ValueError:
        return 512


class KvScheduler:
    """Combines overlap scores + live endpoint metrics into a decision; emits
    KVHitRateEvent telemetry for each routed request and records every
    decision's full score breakdown into a bounded audit ring
    (``DYN_ROUTER_AUDIT`` entries, default 512) — the source behind
    ``GET /v1/router/decisions`` and ``tracectl decisions``."""

    def __init__(self, block_size: int,
                 selector: Optional[WorkerSelector] = None,
                 on_hit_rate: Optional[Callable[[KVHitRateEvent], None]] = None,
                 model: Optional[str] = None):
        self.block_size = block_size
        self.selector = selector
        self.on_hit_rate = on_hit_rate
        # fleet mode: the model this scheduler's candidate set serves —
        # stamped on every audit-ring entry so a merged multi-model
        # decision log stays attributable
        self.model = model
        self.endpoints = ProcessedEndpoints()
        # optional callable -> set of breaker-OPEN worker ids (wired by the
        # router service when it has breaker visibility); fast-fail treats
        # those as non-candidates
        self.breaker_open: Optional[Callable[[], set]] = None
        self.decisions: collections.deque = collections.deque(
            maxlen=_audit_ring_size())
        self._seq = 0
        # the chosen candidate's full score breakdown from the most recent
        # successful schedule() — incl. the kv_donor election, so route()
        # stamps exactly what was scored instead of re-deriving it. Only
        # meaningful synchronously after schedule() returns (no await in
        # between); None when the last decision found no capacity.
        self.last_choice: Optional[Dict[str, Any]] = None

    def update_endpoints(self, workers: Dict[int, ForwardPassMetrics]) -> None:
        self.endpoints = ProcessedEndpoints(dict(workers))

    def remove_worker(self, worker_id: int) -> None:
        self.endpoints.workers.pop(worker_id, None)

    def decision_log(self, limit: int = 0) -> List[Dict[str, Any]]:
        """The most recent decisions, oldest first; ``limit`` 0 = all that
        survive in the ring."""
        out = list(self.decisions)
        return out[-limit:] if limit else out

    def _record(self, tokens: Sequence[int], salt: int,
                candidates: List[Dict[str, Any]],
                wid: Optional[int]) -> None:
        if wid is None:
            # capacity-wait retries poll schedule() every ~50ms: collapse
            # each waiter's saturation streak into ONE audited entry so
            # waiting requests cannot flush the ring. CONCURRENT waiters
            # interleave their polls, so scan the whole trailing run of
            # None-decisions (bounded by the waiter count) for this
            # waiter's entry, not just the newest one.
            for d in reversed(self.decisions):
                if d["worker_id"] is not None:
                    break
                if d["isl_tokens"] == len(tokens) and d["salt"] == salt:
                    d["retries"] = d.get("retries", 0) + 1
                    d["at"] = time.time()
                    return
        self._seq += 1
        # candidates are rounded here (display precision); the selector
        # saw the full-precision values
        self.decisions.append({
            "seq": self._seq,
            **({"model": self.model} if self.model is not None else {}),
            "at": time.time(),
            "isl_tokens": len(tokens),
            "isl_blocks": max(1, len(tokens) // self.block_size),
            "salt": salt,
            "worker_id": wid,           # None = no capacity anywhere
            "overlap_blocks": (next(
                (c["overlap_blocks"] for c in candidates
                 if c["worker_id"] == wid), 0) if wid is not None else 0),
            "candidates": [
                {**c, "overlap_norm": round(c["overlap_norm"], 4),
                 "cache_usage": round(c["cache_usage"], 4),
                 "load": round(c["load"], 4),
                 "kv_bytes_frac": round(c["kv_bytes_frac"], 4),
                 "transfer_seconds": round(
                     c.get("transfer_seconds", 0.0), 5),
                 "logit": round(c["logit"], 4)}
                for c in candidates],
        })

    def schedule(self, tokens: Sequence[int],
                 overlaps: OverlapScores, salt: int = 0,
                 cluster=None, exclude=None) -> Optional[int]:
        endpoints = self.endpoints
        if exclude:
            # mid-stream failover re-election: score everyone EXCEPT the
            # instances the resume layer declared dead. If that vetoes the
            # whole candidate set (single-worker pool, stall not death),
            # stand down like breaker.filter — the worker-side resume
            # supersede guard makes landing on the excluded instance safe,
            # whereas refusing to route manufactures a total outage.
            kept = {w: m for w, m in endpoints.workers.items()
                    if w not in set(exclude)}
            if kept:
                endpoints = ProcessedEndpoints(kept)
        candidates = score_candidates(tokens, self.block_size, overlaps,
                                      endpoints, cluster=cluster)
        if self.selector is not None:
            wid = self.selector(tokens, self.block_size, overlaps, endpoints)
        else:
            wid = default_selector(tokens, self.block_size, overlaps,
                                   endpoints, candidates=candidates)
        self.last_choice = next(
            (c for c in candidates if c["worker_id"] == wid), None) \
            if wid is not None else None
        self._record(tokens, salt, candidates, wid)
        if wid is not None and self.on_hit_rate:
            self.on_hit_rate(KVHitRateEvent(
                worker_id=wid,
                isl_blocks=len(tokens) // self.block_size,
                overlap_blocks=overlaps.scores.get(wid, 0)))
        return wid

    def _all_unavailable(self, tokens: Sequence[int],
                         overlaps: OverlapScores, wid: Optional[int]
                         ) -> Optional[str]:
        """Fast-fail predicate: None when some candidate can take work,
        else the reason ("saturated" / "breaker_open") why every live
        candidate is unavailable right now."""
        if not self.endpoints.workers:
            return None            # membership empty: 503s elsewhere
        open_ids = set(self.breaker_open()) if self.breaker_open else set()
        if wid is None:
            return "saturated"     # selector found no capacity anywhere
        if wid in open_ids:
            cands = score_candidates(tokens, self.block_size, overlaps,
                                     self.endpoints)
            if all(c["saturated"] or c["worker_id"] in open_ids
                   for c in cands):
                return "breaker_open"
        return None

    async def schedule_or_wait(self, tokens: Sequence[int],
                               overlaps: OverlapScores,
                               poll_s: float = 0.05,
                               timeout_s: float = 30.0,
                               salt: int = 0,
                               fast_fail: Optional[bool] = None,
                               cluster=None, exclude=None) -> int:
        """Wait for capacity when all workers are saturated — unless
        ``fast_fail`` (param, or ``DYN_ROUTER_FAST_FAIL``, or a brownout
        level above normal at the router service) is active: then a fully
        saturated/breaker-open candidate set raises a typed 503
        immediately, shedding in milliseconds instead of parking every
        overload victim in a retry loop."""
        if fast_fail is None:
            fast_fail = _fast_fail_enabled()
        deadline = asyncio.get_event_loop().time() + timeout_s
        while True:
            wid = self.schedule(tokens, overlaps, salt=salt,
                                cluster=cluster, exclude=exclude)
            if fast_fail:
                why = self._all_unavailable(tokens, overlaps, wid)
                if why is not None:
                    n = len(self.endpoints.workers)
                    raise EngineError(
                        f"router fast-fail: all {n} candidates "
                        f"unavailable ({why})", 503,
                        stage="router", reason=why, retry_after=1.0)
            if wid is not None:
                return wid
            if asyncio.get_event_loop().time() > deadline:
                raise TimeoutError("no worker capacity")
            await asyncio.sleep(poll_s)
