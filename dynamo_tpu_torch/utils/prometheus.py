"""Minimal Prometheus text-format metrics (no client library in the image).

Counters, gauges and histograms with labels, rendered in exposition format at
``/metrics``. Reference capability: lib/llm/src/http/service/metrics.rs and
components/metrics prometheus export.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

_DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0
)

# Per-metric bucket presets: the shared default starts at 5 ms, which
# collapses ms-scale signals (inter-token latency, decode step) into the
# first bucket. FAST resolves 200 µs – 1 s; WIDE resolves 10 ms – 2 min
# (TTFT, queue wait, KV transfer between hosts).
LATENCY_BUCKETS_FAST = (
    0.0002, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    0.5, 1.0,
)
LATENCY_BUCKETS_WIDE = (
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
    120.0,
)


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{_escape(v)}"' for n, v in zip(names, values))
    return "{" + inner + "}"


class _Metric:
    def __init__(self, name: str, help_: str, labels: Sequence[str]):
        self.name = name
        self.help = help_
        self.labels = tuple(labels)
        self._lock = threading.Lock()


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, help_, labels=()):
        super().__init__(name, help_, labels)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, *label_values: str, amount: float = 1.0) -> None:
        key = tuple(str(v) for v in label_values)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def get(self, *label_values: str) -> float:
        key = tuple(str(v) for v in label_values)
        with self._lock:   # a torn read would race concurrent inc()
            return self._values.get(key, 0.0)

    def clear_label(self, pos: int, value: str) -> None:
        """Drop every series whose label at ``pos`` equals ``value`` (e.g.
        re-exporting a component's worker set after a scrape: dead workers'
        series must vanish rather than freeze at their last value)."""
        v = str(value)
        with self._lock:
            for key in [k for k in self._values if k[pos] == v]:
                del self._values[key]

    def render(self) -> List[str]:
        with self._lock:   # snapshot: render must not race inc/set
            items = sorted(self._values.items())
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {self.kind}"]
        for key, v in items:
            out.append(f"{self.name}{_fmt_labels(self.labels, key)} {v}")
        return out

    def state(self) -> Dict[str, Any]:
        """JSON-serializable snapshot (cross-process metric aggregation)."""
        with self._lock:
            series = {"\x1f".join(k): v for k, v in self._values.items()}
        return {"kind": self.kind, "help": self.help,
                "labels": list(self.labels), "series": series}


class Gauge(Counter):
    kind = "gauge"

    def set(self, *label_values: str, value: float) -> None:
        key = tuple(str(v) for v in label_values)
        with self._lock:
            self._values[key] = value

    def dec(self, *label_values: str, amount: float = 1.0) -> None:
        self.inc(*label_values, amount=-amount)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help_, labels=(), buckets: Sequence[float] = _DEFAULT_BUCKETS):
        super().__init__(name, help_, labels)
        self.buckets = tuple(sorted(buckets))
        self._counts: Dict[Tuple[str, ...], List[int]] = {}
        self._sums: Dict[Tuple[str, ...], float] = {}
        self._totals: Dict[Tuple[str, ...], int] = {}

    def observe(self, *label_values: str, value: float) -> None:
        key = tuple(str(v) for v in label_values)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            # per-bucket (non-cumulative) storage: render() cumulates.
            # (Incrementing every bucket >= value here double-counted once
            # render summed again — le= lines used to overshoot.)
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
                    break
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def get_count(self, *label_values: str) -> int:
        key = tuple(str(v) for v in label_values)
        with self._lock:
            return self._totals.get(key, 0)

    def render(self) -> List[str]:
        with self._lock:   # snapshot: render must not race observe()
            items = sorted((k, list(c)) for k, c in self._counts.items())
            sums = dict(self._sums)
            totals = dict(self._totals)
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {self.kind}"]
        for key, counts in items:
            cum = 0
            for b, c in zip(self.buckets, counts):
                cum += c
                lbls = _fmt_labels(self.labels + ("le",), key + (repr(b).rstrip("0").rstrip("."),))
                out.append(f"{self.name}_bucket{lbls} {cum}")
            lbls_inf = _fmt_labels(self.labels + ("le",), key + ("+Inf",))
            out.append(f"{self.name}_bucket{lbls_inf} {totals[key]}")
            out.append(f"{self.name}_sum{_fmt_labels(self.labels, key)} {sums[key]}")
            out.append(f"{self.name}_count{_fmt_labels(self.labels, key)} {totals[key]}")
        return out

    def state(self) -> Dict[str, Any]:
        with self._lock:
            series = {
                "\x1f".join(k): {"counts": list(c),
                                 "sum": self._sums.get(k, 0.0),
                                 "total": self._totals.get(k, 0)}
                for k, c in self._counts.items()}
        return {"kind": self.kind, "help": self.help,
                "labels": list(self.labels), "buckets": list(self.buckets),
                "series": series}


class Registry:
    def __init__(self):
        self._metrics: List[_Metric] = []

    def counter(self, name, help_, labels=()) -> Counter:
        m = Counter(name, help_, labels)
        self._metrics.append(m)
        return m

    def gauge(self, name, help_, labels=()) -> Gauge:
        m = Gauge(name, help_, labels)
        self._metrics.append(m)
        return m

    def histogram(self, name, help_, labels=(), buckets=_DEFAULT_BUCKETS) -> Histogram:
        m = Histogram(name, help_, labels, buckets)
        self._metrics.append(m)
        return m

    def render(self) -> str:
        lines: List[str] = []
        for m in self._metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"

    def state_dump(self) -> Dict[str, Dict]:
        """Snapshot every metric's state — the unit workers publish to the
        store so a cluster scraper can merge histograms across processes."""
        return {m.name: m.state() for m in self._metrics}


def diff_states(base: Dict[str, Dict], cur: Dict[str, Dict],
                ignore: Sequence[str] = ()) -> Dict[str, Dict]:
    """The metrics of ``cur`` whose state changed vs ``base`` — the
    coalesced **delta batch** a worker publishes between full snapshots.

    Granularity is the whole metric (a changed metric ships all its
    series), so applying a delta onto the full image it was diffed
    against is a plain dict overlay — no per-series merge semantics to
    get wrong across process restarts. ``ignore`` names metrics excluded
    from change detection (the publisher's own push counters would
    otherwise make every interval a delta)."""
    skip = set(ignore)
    return {name: st for name, st in cur.items()
            if name not in skip and base.get(name) != st}


#: gauges whose series describe a STATE (enum / worst-of), not a quantity:
#: merging across publishers must take the max, never the sum — summing two
#: observers' OPEN(2) circuit states would read as 4 and match no state
GAUGE_MERGE_MAX = frozenset({"dyn_circuit_state", "dyn_brownout_level"})


def merge_state_dumps(dumps: Iterable[Dict[str, Dict]],
                      gauge_max: Iterable[str] = GAUGE_MERGE_MAX
                      ) -> Dict[str, Dict]:
    """Reduce many ``registry.state_dump()`` images into ONE equivalent
    dump — the regional aggregator's pre-merge (runtime/scale/regions.py).

    Merge rules match what every state-dump consumer already assumes:
    counters and histogram counts/sums/totals add (so quantile/burn/total
    math over the merged dump equals the same math over the originals);
    gauges add too — per-worker gauges carry a worker/observer label, so
    addition is concatenation — EXCEPT the state-enum gauges in
    ``gauge_max``, which take the worst value. Metrics with mismatched
    kind/labels/buckets across dumps keep the first image seen (same
    skip-don't-corrupt rule as :func:`render_states`)."""
    gauge_max = set(gauge_max)
    out: Dict[str, Dict] = {}
    for dump in dumps:
        for name, st in dump.items():
            if not isinstance(st, dict):
                continue
            cur = out.get(name)
            if cur is None:
                # deep-copy histogram series: the merge accumulates in
                # place and must never mutate a caller's dump
                series0 = {
                    k: ({"counts": list(v.get("counts") or ()),
                         "sum": v.get("sum", 0.0),
                         "total": v.get("total", 0)}
                        if st.get("kind") == "histogram" else v)
                    for k, v in (st.get("series") or {}).items()}
                out[name] = {**st, "series": series0}
                continue
            if (cur.get("kind") != st.get("kind")
                    or list(cur.get("labels") or ()) != list(
                        st.get("labels") or ())):
                continue
            kind = st.get("kind")
            if kind == "histogram" and list(st.get("buckets") or ()) != \
                    list(cur.get("buckets") or ()):
                continue
            series = cur["series"]
            for skey, val in (st.get("series") or {}).items():
                prev = series.get(skey)
                if prev is None:
                    series[skey] = ({"counts": list(val["counts"]),
                                     "sum": val["sum"],
                                     "total": val["total"]}
                                    if kind == "histogram" else val)
                elif kind == "histogram":
                    if len(prev.get("counts") or ()) == len(
                            val.get("counts") or ()):
                        prev["counts"] = [a + b for a, b in zip(
                            prev["counts"], val["counts"])]
                        prev["sum"] += val["sum"]
                        prev["total"] += val["total"]
                elif kind == "counter":
                    series[skey] = prev + val
                elif name in gauge_max:
                    series[skey] = max(prev, val)
                else:
                    series[skey] = prev + val
    return out


def hist_quantile(buckets, counts, total, q: float) -> Optional[float]:
    """Bucket upper edge covering quantile ``q`` of a state-dump
    histogram (conservative: the true value is <= the returned edge).
    ``inf`` when the quantile falls in the overflow bucket, ``None`` on
    an empty histogram. The shared bucket-walk for every consumer of
    ``state_dump()`` histograms (dyntop's store line, the fleet-soak
    scaling curve)."""
    if not total:
        return None
    target = q * total
    cum = 0
    for edge, c in zip(buckets or (), counts or ()):
        cum += c
        if cum >= target:
            return float(edge)
    return float("inf")


# ---------------------------------------------------------------------------
# cross-process merge + render of state dumps
# ---------------------------------------------------------------------------
def render_states(states: Iterable[Tuple[str, Dict[str, Dict]]]) -> str:
    """Render ``(component, registry.state_dump())`` pairs as one exposition
    block, each series tagged with a leading ``component`` label. Series from
    multiple processes of the SAME component merge: counters/histogram counts
    sum, gauges last-write-wins (per-worker gauges should carry a worker
    label instead of relying on this)."""
    # metric name -> (kind, help, labels, buckets, {(component,)+key -> val})
    merged: Dict[str, Dict[str, Any]] = {}
    for component, dump in states:
        for name, st in dump.items():
            m = merged.setdefault(name, {
                "kind": st["kind"], "help": st.get("help", ""),
                "labels": list(st.get("labels", ())),
                "buckets": st.get("buckets"), "series": {}})
            if m["kind"] != st["kind"] or m["labels"] != list(
                    st.get("labels", ())):
                continue    # incompatible foreign dump: skip, don't corrupt
            if (st["kind"] == "histogram"
                    and list(st.get("buckets") or ()) != list(
                        m["buckets"] or ())):
                continue    # different bucket layout (mixed-version
                            # rollout): summing or relabelling would lie
            for skey, val in st.get("series", {}).items():
                key = (component,) + tuple(skey.split("\x1f")) \
                    if skey else (component,)
                cur = m["series"].get(key)
                if st["kind"] == "histogram":
                    if (cur is not None and m["buckets"] is not None
                            and len(cur["counts"]) == len(val["counts"])):
                        cur["counts"] = [a + b for a, b in
                                         zip(cur["counts"], val["counts"])]
                        cur["sum"] += val["sum"]
                        cur["total"] += val["total"]
                    else:
                        m["series"][key] = {"counts": list(val["counts"]),
                                            "sum": val["sum"],
                                            "total": val["total"]}
                elif st["kind"] == "counter":
                    m["series"][key] = (cur or 0.0) + val
                else:   # gauge
                    m["series"][key] = val
    lines: List[str] = []
    for name, m in sorted(merged.items()):
        labels = ("component",) + tuple(m["labels"])
        lines.append(f"# HELP {name} {m['help']}")
        lines.append(f"# TYPE {name} {m['kind']}")
        for key, val in sorted(m["series"].items()):
            if m["kind"] == "histogram":
                cum = 0
                for b, c in zip(m["buckets"] or (), val["counts"]):
                    cum += c
                    lb = _fmt_labels(labels + ("le",),
                                     key + (repr(b).rstrip("0").rstrip("."),))
                    lines.append(f"{name}_bucket{lb} {cum}")
                lines.append(f"{name}_bucket"
                             f"{_fmt_labels(labels + ('le',), key + ('+Inf',))}"
                             f" {val['total']}")
                lines.append(f"{name}_sum{_fmt_labels(labels, key)}"
                             f" {val['sum']}")
                lines.append(f"{name}_count{_fmt_labels(labels, key)}"
                             f" {val['total']}")
            else:
                lines.append(f"{name}{_fmt_labels(labels, key)} {val}")
    return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------------
# per-stage LLM latency metrics (one set per process, own registry)
# ---------------------------------------------------------------------------
class StageMetrics:
    """The request-lifecycle flight-recorder histograms every serving
    process records locally: TTFT, inter-token latency, prefill queue wait,
    KV-transfer duration/bytes, decode step time, batch occupancy. Workers
    publish ``registry.state_dump()`` to the store; the metrics aggregator
    and the HTTP frontend's ``/metrics`` merge them cluster-wide via
    :func:`render_states`."""

    def __init__(self, registry: Optional[Registry] = None):
        r = registry or Registry()
        self.registry = r
        self.ttft = r.histogram(
            "llm_ttft_seconds", "Time to first token", ("model",),
            buckets=LATENCY_BUCKETS_WIDE)
        self.inter_token = r.histogram(
            "llm_inter_token_seconds", "Gap between streamed tokens",
            ("model",), buckets=LATENCY_BUCKETS_FAST)
        self.queue_wait = r.histogram(
            "llm_prefill_queue_wait_seconds",
            "Remote prefill job wait in the shared queue", (),
            buckets=LATENCY_BUCKETS_WIDE)
        self.kv_transfer = r.histogram(
            "llm_kv_transfer_seconds",
            "Prefill->decode KV block transfer duration", ("direction",),
            # sub-ms on loopback, seconds across hosts: fast floor, slow tail
            buckets=LATENCY_BUCKETS_FAST + (2.5, 10.0, 60.0))
        self.kv_transfer_bytes = r.counter(
            "llm_kv_transfer_bytes_total",
            "Bytes of KV moved prefill->decode", ("direction",))
        self.decode_step = r.histogram(
            "llm_decode_step_seconds", "One engine decode iteration", (),
            buckets=LATENCY_BUCKETS_FAST)
        self.batch_occupancy = r.gauge(
            "llm_batch_occupancy", "Active sequences in the engine batch",
            # per-worker label (pid): render_states merges same-component
            # gauges last-write-wins, which would collapse replicas
            ("worker",))
        # robustness plane (store reconnect / deadlines / circuit breaker):
        # counted here so they ride the existing publish_stage_metrics →
        # aggregator merge path with zero new plumbing
        self.store_reconnects = r.counter(
            "dyn_store_reconnects_total",
            "Store reconnect outcomes", ("result",))   # attempt|ok|fail
        self.lease_regrants = r.counter(
            "dyn_lease_regrants_total",
            "Leases re-granted after a store reconnect", ())
        self.session_replays = r.counter(
            "dyn_session_replay_total",
            "Session state replayed on reconnect", ("kind",))
        self.deadline_expiries = r.counter(
            "dyn_deadline_expiries_total",
            "Requests expired at a pipeline stage", ("stage",))
        self.circuit_state = r.gauge(
            "dyn_circuit_state",
            "Per-instance circuit breaker state "
            "(0=closed 1=half-open 2=open)",
            # observer label (pid): each client process has its OWN view of
            # an instance's circuit; merging them last-write-wins would
            # make the series flap between observers' states
            ("observer", "instance"))
        self.faults_injected = r.counter(
            "dyn_faults_injected_total",
            "Fault-injection points fired", ("point", "action"))
        # speculative decoding (engine/spec.py): proposal/acceptance volume
        # plus the accepted-per-dispatch shape — the two numbers that tell
        # an operator whether spec decode is paying for its verify passes
        self.spec_proposed = r.counter(
            "dyn_spec_proposed_total",
            "Draft tokens proposed for speculative verification", ())
        self.spec_accepted = r.counter(
            "dyn_spec_accepted_total",
            "Draft tokens accepted by speculative verification", ())
        self.spec_per_dispatch = r.histogram(
            "dyn_spec_accepted_per_dispatch",
            "Accepted draft tokens per verify dispatch (per lane)", (),
            # token counts, not latencies: one bucket per plausible k
            buckets=(0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0))
        # goodput plane (utils/roofline.py): analytic FLOPs/bytes per
        # dispatch over measured dispatch wall time against the platform
        # peak table — "how close to the hardware is this worker"
        self.mfu = r.gauge(
            "dyn_mfu", "Model FLOP utilization over the recent dispatch "
            "window (analytic cost model / platform peak)", ("worker",))
        self.mbu = r.gauge(
            "dyn_mbu", "Memory bandwidth utilization over the recent "
            "dispatch window", ("worker",))
        self.hbm_gbps = r.gauge(
            "dyn_hbm_gbps", "Achieved main-memory GB/s over the recent "
            "dispatch window", ("worker",))
        # compile plane: warmup cost and bucket-explosion regressions are
        # invisible in latency histograms until they hit a request — count
        # every program build (the JAX engine's bucket programs; the help
        # text stays the JAX package's, byte for byte)
        self.compile_seconds = r.counter(
            "dyn_compile_seconds_total",
            "Wall seconds spent XLA-compiling bucket programs", ("kind",))
        self.compiled_programs = r.counter(
            "dyn_compiled_programs",
            "Bucket programs compiled", ("kind",))   # prefill|decode|verify|draft
        # model-mobility plane (fleet/mobility/): weight prefetch + hot
        # swap — a swap that recompiles or silently reloads cold defeats
        # the seconds-scale wake contract, so both are first-class series
        self.weight_cache_bytes = r.gauge(
            "dyn_weight_cache_bytes",
            "Host-RAM weight-cache residency by pin state "
            "(LRU budget: DYN_WEIGHT_CACHE_BYTES)", ("state",))
        self.model_swaps = r.counter(
            "dyn_model_swaps_total",
            "Model swap attempts by outcome (swap = in-place, reload = "
            "typed full-reload fallback)",
            ("outcome",))   # swap|reload|shape_mismatch|error
        self.model_wake_seconds = r.histogram(
            "dyn_model_wake_seconds",
            "Model wake latency from swap command (or spawn) to serving "
            "registration, by wake path", ("path",),   # swap|cold
            buckets=(0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 45.0, 90.0, 180.0))
        # SLO burn rates (utils/slo.py): whoever runs an SloMonitor in this
        # process exports through here and the stage-metrics merge path
        self.slo_burn = r.gauge(
            "dyn_slo_burn_rate",
            "Error-budget burn rate per SLO and window (1.0 = budget "
            "consumed exactly at the sustainable rate)", ("slo", "window"))
        # overload-control plane (utils/overload.py): sheds are the
        # goodput-preserving outcome under pressure — they must be as
        # visible as the failures they replace
        self.admission_rejects = r.counter(
            "dyn_admission_rejects_total",
            "Requests rejected at HTTP admission (immediate 429)",
            ("reason", "priority"))   # rate_limit|concurrency|brownout...
        self.queue_shed = r.counter(
            "dyn_queue_shed_total",
            "Requests shed at a bounded stage queue (depth bound or "
            "predicted-late)", ("stage",))
        self.brownout_level = r.gauge(
            "dyn_brownout_level",
            "Active brownout degradation level (0=normal 1=shed-batch "
            "2=cap-tokens 3=no-spec 4=shed-all)", ())
        self.admission_depth = r.gauge(
            "dyn_admission_queue_depth",
            "In-flight requests currently held by the admission "
            "controller", ())
        self.admission_kv_bytes = r.gauge(
            "dyn_admission_kv_bytes",
            "Estimated KV bytes of all admitted in-flight requests (the "
            "byte-honest admission dimension; 0 when DYN_ADMIT_KV_BYTES "
            "is off)", ())
        # tenancy plane (utils/overload.py TenantAdmission/BurnTracker):
        # quota sheds are deliberate isolation, counted separately from
        # overload sheds so rejected-demand autoscaling pressure stays
        # blind to them; label cardinality is bounded to the quota table
        # plus "other" (tenant ids are client-controlled strings)
        self.tenant_rejects = r.counter(
            "dyn_tenant_admission_rejects_total",
            "Requests rejected by a per-tenant quota at HTTP ingress "
            "(tenant_rate | tenant_concurrency)", ("tenant", "reason"))
        self.tenant_requests = r.counter(
            "dyn_tenant_requests_total",
            "HTTP requests by tenant and status (the per-tenant "
            "availability burn's input)", ("tenant", "status"))
        self.tenant_inflight = r.gauge(
            "dyn_tenant_inflight",
            "In-flight requests per quota-governed tenant", ("tenant",))
        self.tenant_burn = r.gauge(
            "dyn_tenant_slo_burn",
            "Per-tenant availability error-budget burn, worst window "
            "(feeds the brownout ladder when DYN_TENANT_AVAILABILITY is "
            "set)", ("tenant",))
        # fleet-safe telemetry pipelines (utils/tracing.py head sampling +
        # the span sink's bounded retain-on-outage buffer, and the stage
        # publisher's delta batching): the pressure-relief valves must be
        # as observable as the planes they protect
        self.spans_sampled_out = r.counter(
            "dyn_spans_sampled_out_total",
            "Finished spans withheld from the store sink by trace-id "
            "head sampling (DYN_TRACE_SAMPLE); error traces are never "
            "sampled away", ())
        self.spans_dropped = r.counter(
            "dyn_spans_dropped_total",
            "Spans evicted from the span sink's bounded retain-on-outage "
            "buffer (oldest first) — nonzero means a store outage "
            "outlasted the buffer", ())
        self.metrics_pushes = r.counter(
            "dyn_metrics_pushes_total",
            "Stage-metrics publishes by kind: full snapshot, coalesced "
            "delta, or skipped (nothing changed — no store write)",
            ("kind",))   # full|delta|skipped
        self.stage_service = r.histogram(
            "dyn_stage_service_seconds",
            "Observed per-item service time of a bounded stage (the "
            "predictive shed's wait estimate input)", ("stage",),
            buckets=LATENCY_BUCKETS_FAST + (2.5, 10.0, 60.0))
        # KV tier + cluster-sharing plane (llm/kvbm/tiers.py and
        # llm/kv_cluster/): host/disk tier effectiveness was previously a
        # dict nobody scraped; cluster sharing makes the tiers a fleet
        # resource, so their hit economics must be first-class series
        self.kv_tier_hits = r.counter(
            "dyn_kv_tier_hits_total",
            "KV tier lookups served from a tier (admission restores and "
            "disk promotions)", ("tier",))   # host|disk
        self.kv_tier_misses = r.counter(
            "dyn_kv_tier_misses_total",
            "KV tier lookups that missed every local tier", ())
        self.kv_tier_blocks = r.gauge(
            "dyn_kv_tier_blocks",
            "Sealed KV blocks resident per tier", ("tier", "worker"))
        self.kv_cluster_hits = r.counter(
            "dyn_kv_cluster_hits_total",
            "Routed requests whose cluster-registry match exceeded the "
            "chosen worker's local overlap (a donor was stamped)", ())
        self.kv_cluster_fetches = r.counter(
            "dyn_kv_cluster_fetches_total",
            "Peer prefix fetches that deposited blocks into the local "
            "host tier", ())
        self.kv_cluster_fallbacks = r.counter(
            "dyn_kv_cluster_fallbacks_total",
            "Cluster fetches abandoned (timeout / donor death / error) — "
            "the request fell back to local prefill recompute", ())
        self.kv_cluster_fetch_seconds = r.histogram(
            "dyn_kv_cluster_fetch_seconds",
            "Peer prefix fetch duration, request out to blocks deposited",
            (), buckets=LATENCY_BUCKETS_FAST + (2.5, 10.0))
        # mid-stream failover (llm/resume.py): a broken stream re-enters
        # the router under the same context id and a new worker continues
        # from the next token — the client sees a pause, not a 503
        self.stream_resumes = r.counter(
            "dyn_stream_resumes_total",
            "Mid-stream failover attempts by outcome: resumed (a new "
            "worker continued the stream), exhausted (DYN_RESUME_MAX "
            "spent -> typed 503 resume_exhausted), expired (original "
            "deadline passed mid-retry -> 504)", ("outcome",))
        self.resume_kv_reattach_blocks = r.counter(
            "dyn_resume_kv_reattach_blocks_total",
            "Sealed KV blocks a resumed request re-attached at admission "
            "(cluster-fetched or tier-restored) instead of re-prefilling "
            "— zero on a resume means the full-local-prefill fallback "
            "path was taken", ())
        self.resume_latency = r.histogram(
            "dyn_resume_latency_seconds",
            "Client-visible pause per successful resume: stream break "
            "detected to first frame from the replacement worker",
            (), buckets=LATENCY_BUCKETS_FAST + (2.5, 10.0))
        # layer-streamed KV ingestion (llm/kv_transfer.py streamed mode):
        # each arriving layer's device scatter is enqueued while later
        # layers are still in flight; a torn stream (donor death, codec
        # violation, abandoned waiter) degrades to counted local prefill
        # with the partially-written pool pages released unseen
        self.kv_stream_ingests = r.counter(
            "dyn_kv_stream_ingests_total",
            "Remote-prefill KV streams ingested layer-by-layer into the "
            "decode pool (scatters overlapped with arrival)", ())
        self.kv_stream_fallbacks = r.counter(
            "dyn_kv_stream_fallbacks_total",
            "Streamed KV ingests aborted mid-stream (torn transfer / "
            "codec violation / abandoned waiter) — pool pages released, "
            "request fell back to local prefill", ("reason",))
        # per-(src,dst)-pair KV transfer bandwidth: EWMA observed by the
        # RECEIVER of every disagg push / cluster fetch — the
        # TransferCostModel's pair-aware input (src "q" = unknown sender,
        # e.g. the anonymous prefill-worker pool)
        self.kv_pair_bw = r.gauge(
            "llm_kv_pair_bw_bytes_per_s",
            "Observed KV transfer bandwidth per (src,dst) worker pair, "
            "exponentially weighted", ("src", "dst"))
        # placement-driven h2d prefetch (engine/engine.py stage_prefetch):
        # matched host/disk-tier prefix blocks uploaded to a device
        # staging buffer while the request still waits in the slot-gate
        # queue, consumed by admission's restore as a d2d scatter
        self.prefetch_h2d_hits = r.counter(
            "dyn_prefetch_h2d_hits_total",
            "Tier-resident prefix blocks admission restored from the "
            "prefetched device staging buffer (no h2d on the critical "
            "path)", ())
        self.prefetch_h2d_stalls = r.counter(
            "dyn_prefetch_h2d_stalls_total",
            "Tier-resident prefix blocks admission had to upload "
            "synchronously although a prefetch had been requested "
            "(prefetch incomplete or staging evicted)", ())
        # KV paging plane (llm/kvpage/): the virtual-memory counters —
        # demotions (d2h seal-and-demote), page-ins (async staged h2d),
        # faults (synchronous inline page-ins: the number that must stay
        # at zero in steady-state decode), and the lane's true footprint
        # in bytes (device-resident pages + pinned host working set)
        self.kvpage_demotions = r.counter(
            "dyn_kvpage_demotions_total",
            "KV blocks sealed and demoted d2h to the host tier by the "
            "paging plane", ())
        self.kvpage_pageins = r.counter(
            "dyn_kvpage_pageins_total",
            "Cold-block segments paged in h2d ahead of the attention "
            "pass that read them (async prefetch hits)", ())
        self.kvpage_faults = r.counter(
            "dyn_kvpage_faults_total",
            "Page faults: cold segments assembled synchronously on the "
            "engine thread because prefetch had not staged them", ())
        self.kvpage_resident_bytes = r.gauge(
            "dyn_kvpage_resident_bytes",
            "Paged-lane working set in bytes by residency tier "
            "(device pages vs pinned host blocks)", ("tier", "worker"))
        self.kvpage_pagein_wait = r.histogram(
            "dyn_kvpage_pagein_wait_seconds",
            "Time the paged forward blocked waiting for a scheduled "
            "page-in to finish assembling (0 = fully overlapped)",
            (), buckets=LATENCY_BUCKETS_FAST)
        # scale plane (runtime/scale/): the hierarchical observer tree's
        # own health — region pre-merge cost per tick (the number the
        # hierarchy exists to keep flat as the fleet grows) — and the
        # sharded store client's per-shard degradation counter
        self.region_merge = r.histogram(
            "dyn_region_merge_seconds",
            "One regional aggregator tick: scrape the owned workers' "
            "stage dumps, pre-merge, publish the region record", (),
            buckets=LATENCY_BUCKETS_FAST + (2.5, 10.0))
        self.store_shard_errors = r.counter(
            "dyn_store_shard_errors_total",
            "Store calls that failed against one shard of a sharded "
            "store (that shard's families degraded; others unaffected)",
            ("shard",))
        # queue-until-boot (llm/http_service.py): scale-from-zero requests
        # parked at ingress until the planner boots a replica — parked is
        # also the planner's wake signal (counted into PoolSignals.unserved
        # alongside model-labelled 404s)
        self.queue_until_boot = r.counter(
            "dyn_queue_until_boot_total",
            "Scale-from-zero requests parked at HTTP ingress by outcome "
            "(parked|served|expired|overflow)", ("model", "outcome"))
        # flight-recorder plane (obs/): black-box ring health, watchdog
        # stall detections, and incident-bundle coordination — the
        # eviction counter is how a bundle consumer tells a quiet window
        # from a ring too small to cover it
        self.flightrec_evicted = r.counter(
            "dyn_flightrec_evicted_total",
            "Flight-recorder ring entries evicted before any incident "
            "captured them (spans|events|logtail)", ("ring",))
        self.watchdog_stalls = r.counter(
            "dyn_watchdog_stalls_total",
            "Hang-watchdog stall detections by kind (decode|transfer|"
            "drain|event_loop); each also emits a never-sampled "
            "stall:* span", ("kind",))
        self.incidents_captured = r.counter(
            "dyn_incidents_captured_total",
            "Incident capture beacons published, by trigger reason",
            ("reason",))
        self.incident_dumps = r.counter(
            "dyn_incident_dumps_total",
            "Flight-recorder ring dumps this process contributed to "
            "incident bundles", ())
        # byte-flow ledger (obs/flows.py): every byte-moving site —
        # disagg push/receive, cluster kv_fetch, paged page-in/out, h2d
        # prefetch, d2h write-through, weight prefetch, swap slabs —
        # accounts (src,dst,kind,bytes,seconds) through one chokepoint;
        # these series are its published face (dyntop links:, /v1/flows,
        # ctl flows all fold them back via flows_from_states)
        self.link_bytes = r.counter(
            "dyn_link_bytes_total",
            "Bytes moved per link and flow kind — network pairs are "
            "worker hex endpoints (src 'q' = anonymous prefill pool), "
            "host/device edges are host:<id> / dev:<id> / disk",
            ("src", "dst", "kind"))
        self.link_bw = r.gauge(
            "dyn_link_bw_bytes_per_s",
            "Windowed transfer rate per link: bytes recorded in the "
            "trailing DYN_LINK_WINDOW seconds over the window length",
            ("src", "dst"))
        self.link_saturation = r.gauge(
            "dyn_link_saturation",
            "Windowed link utilization vs calibrated capacity "
            "(DYN_LINK_CAPACITY_* override, else the link's measured "
            "peak rate), 0..1; link label is 'src>dst'", ("link",))
        self.link_congested = r.counter(
            "dyn_link_congested_total",
            "Rising-edge saturation crossings of DYN_LINK_SAT_THRESHOLD "
            "per link — each also emits a link.congested flight-recorder "
            "event and is incident-capture eligible", ("link",))

    def clear_worker(self, worker: str) -> None:
        """Drop every per-worker gauge series for ``worker`` (pid). Wired
        into engine shutdown/deregistration so a process that outlives its
        engine (shared-runtime tests, model remove/re-add) stops exporting
        ghost occupancy/MFU for an engine that no longer exists."""
        for g in (self.batch_occupancy, self.mfu, self.mbu, self.hbm_gbps):
            g.clear_label(0, worker)
        self.kv_tier_blocks.clear_label(1, worker)   # (tier, worker)
        self.kvpage_resident_bytes.clear_label(1, worker)


_stage: Optional[StageMetrics] = None
_stage_lock = threading.Lock()


def stage_metrics() -> StageMetrics:
    """Process-global :class:`StageMetrics` (lazily created)."""
    global _stage
    if _stage is None:
        with _stage_lock:
            if _stage is None:
                _stage = StageMetrics()
    return _stage
