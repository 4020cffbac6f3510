"""Central registry of the ``DYN_*`` environment knobs the port reads.

The port's copy of the JAX package's ``utils/knobs.py``: the same
:func:`env_float` parse policy and :class:`Knob` records, with an entry for
each knob a module of ``dynamo_tpu_torch`` reads (type, default, owning
subsystem and description as in the JAX registry, which the tests hold it
to). The JAX package also generates ``docs/configuration.md`` from its
registry and lints it against the code; those gates cover the JAX package
only.

This module is stdlib-only and import-light on purpose.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional

log = logging.getLogger("dynamo_tpu_torch.knobs")


def env_float(name: str, default: float,
              env: Optional[Mapping[str, str]] = None,
              minimum: Optional[float] = None) -> float:
    """Parse a float knob, warning and falling back to ``default`` on a
    malformed (or, with ``minimum``, out-of-range) value — a bad env var
    must never crash a component at startup. This is the one shared copy
    of the parse policy, next to the registry the values are declared in.
    ``env`` overrides ``os.environ`` (tests pass a plain dict)."""
    raw = (os.environ if env is None else env).get(name)
    if raw is None or raw == "":
        return default
    try:
        val = float(raw)
    except ValueError:
        log.warning("ignoring malformed %s=%r", name, raw)
        return default
    if minimum is not None and val < minimum:
        log.warning("ignoring out-of-range %s=%r (minimum %s)",
                    name, raw, minimum)
        return default
    return val


#: the JAX package's doc for each subsystem (keeps the table rows terse)
_DOCS = {
    "runtime": "docs/robustness.md",
    "overload": "docs/robustness.md",
    "multi_model": "docs/multi_model.md",
    "engine": "docs/observability.md",
    "tracing": "docs/observability.md",
    "metrics": "docs/observability.md",
    "logging": "docs/observability.md",
    "slo": "docs/observability.md",
    "roofline": "docs/observability.md",
    "llm": "docs/benchmarking.md",
    "faults": "docs/robustness.md",
    "router": "docs/kv_cache_routing.md",
    "store": "docs/observability.md",
    "disagg": "docs/disagg_serving.md",
    "spec": "docs/speculative.md",
    "kvpage": "docs/long_context.md",
}


@dataclass(frozen=True)
class Knob:
    name: str            # the full env var name, e.g. "DYN_LEASE_TTL"
    type: str            # str | int | float | bool | csv | json
    default: str         # human-readable default ("" = unset/off)
    subsystem: str       # key into _DOCS (owning plane)
    description: str     # one line, imperative, no trailing period
    derived: bool = False  # materialized by dynconfig flag layering

    @property
    def doc(self) -> str:
        return _DOCS[self.subsystem]


def _k(name: str, type: str, default: str, subsystem: str,
       description: str, derived: bool = False) -> Knob:
    return Knob(name, type, default, subsystem, description, derived)


_ALL: List[Knob] = [
    # ----------------------------------------------------------- runtime
    _k("DYN_REQUEST_TIMEOUT", "float", "", "runtime",
       "default end-to-end request deadline when the client sends none, "
       "seconds"),
    # ---------------------------------------------------------- overload
    _k("DYN_ADMIT_RPS", "float", "0", "overload",
       "token-bucket admission rate at HTTP ingress (0 = no rate cap)"),
    _k("DYN_ADMIT_BURST", "float", "2*rps", "overload",
       "token-bucket burst size"),
    _k("DYN_ADMIT_CONCURRENCY", "int", "0", "overload",
       "max in-flight requests admitted (0 = no concurrency cap)"),
    _k("DYN_ADMIT_QUEUE", "int", "-1", "overload",
       "admission wait-queue depth (-1 = unbounded, 0 = reject at cap)"),
    _k("DYN_ADMIT_BATCH_RESERVE", "float", "0.25", "overload",
       "fraction of admission capacity batch-priority traffic may use "
       "when interactive traffic is waiting"),
    _k("DYN_ADMIT_KV_BYTES", "float", "0", "overload",
       "in-flight KV byte budget at HTTP ingress: requests are priced at "
       "estimated tokens x DYN_ADMIT_KV_TOKEN_BYTES so one long-context "
       "request consumes its true share of the admission envelope (0 = "
       "dimension off)"),
    _k("DYN_ADMIT_KV_TOKEN_BYTES", "float", "0", "overload",
       "per-token KV price in bytes for the byte-honest admission "
       "dimension (2 * layers * kv_heads * head_dim * dtype_bytes of the "
       "served model; 0 = dimension off)"),
    _k("DYN_WORKER_SLOTS", "int", "0", "overload",
       "worker decode slot gate (0/unset = ungated)"),
    _k("DYN_WORKER_QUEUE_DEPTH", "int", "2*slots", "overload",
       "bounded wait queue behind the worker slot gate"),
    _k("DYN_WORKER_BATCH_QUEUE_DEPTH", "int", "-1", "overload",
       "batch-priority share of the worker wait queue (-1 = half)"),
    _k("DYN_BROWNOUT_MAX_TOKENS", "int", "256", "overload",
       "max_tokens ceiling applied at brownout level 2+"),
    _k("DYN_BROWNOUT_UP_BURN", "float", "2.0", "overload",
       "worst-SLO burn rate that steps the brownout ladder up"),
    _k("DYN_BROWNOUT_DOWN_BURN", "float", "0.75", "overload",
       "burn rate below which the ladder steps back down"),
    _k("DYN_BROWNOUT_DWELL_UP", "float", "5.0", "overload",
       "min seconds between upward brownout steps"),
    _k("DYN_BROWNOUT_DWELL_DOWN", "float", "30.0", "overload",
       "min seconds between downward brownout steps"),
    _k("DYN_BROWNOUT_MAX_LEVEL", "int", "3", "overload",
       "highest brownout level the controller may reach (ladder max 4)"),
    _k("DYN_TENANT_QUOTAS", "json", "", "overload",
       "static per-tenant admission quotas at HTTP ingress, e.g. "
       '\'{"acme": {"rps": 5, "burst": 10, "concurrency": 8}}\'; merged '
       "with (and overridden by) the fleet registry's per-model tenant "
       "tables"),
    _k("DYN_TENANT_AVAILABILITY", "float", "", "overload",
       "per-tenant good-request fraction objective (e.g. 0.99); when "
       "set, the worst tenant's burn also steps the brownout ladder"),
    # ------------------------------------------------------- multi_model
    _k("DYN_BOOT_WAIT", "float", "0", "multi_model",
       "queue-until-boot: max seconds a request for a fleet-registered "
       "scaled-to-zero model parks at HTTP ingress waiting for a replica "
       "to boot, bounded by the request deadline (0 = off, immediate 404 "
       "as before)"),
    _k("DYN_BOOT_WAIT_QUEUE", "int", "64", "multi_model",
       "max requests parked by queue-until-boot at once; beyond it "
       "requests get an immediate typed 503 (boot_queue_full)"),
    _k("DYN_FLEET_PREEMPT_MARGIN", "float", "0.5", "multi_model",
       "SLO-burn advantage a model needs before the chip arbiter "
       "preempts another model's live replicas (hysteresis against "
       "replica thrash; higher priority classes preempt regardless)"),
    _k("DYN_WEIGHT_CACHE_BYTES", "int", str(32 << 30), "multi_model",
       "per-worker pinned host-RAM weight cache budget (model "
       "mobility): sibling checkpoints prefetch here while the "
       "incumbent serves, so a hot-swap pays only the h2d stream"),
    _k("DYN_SWAP_GROUP_LAYERS", "int", "4", "multi_model",
       "layers per h2d group during a weight hot-swap (each group is "
       "one donated in-place slab scatter on the engine's existing "
       "device buffers)"),
    _k("DYN_SWAP_DRAIN_TIMEOUT", "float", "120", "multi_model",
       "seconds a swap command waits for in-flight streams to drain "
       "before falling back to a counted full reload (never a hang)"),
    # ------------------------------------------------------------ engine
    _k("DYN_PROFILE_DIR", "str", "", "engine",
       "capture a torch.profiler Chrome trace of the first working "
       "iterations into this directory"),
    _k("DYN_PROFILE_STEPS", "int", "32", "engine",
       "engine iterations the DYN_PROFILE_DIR capture spans"),
    # ----------------------------------------------------------- tracing
    _k("DYN_TRACING", "bool", "1", "tracing",
       "request span tracing (0 disables recording entirely)"),
    _k("DYN_TRACE_BUFFER", "int", "4096", "tracing",
       "per-process span ring-buffer capacity"),
    _k("DYN_TRACE_SAMPLE", "float", "1.0", "tracing",
       "trace-id-consistent head-sampling fraction exported to the store "
       "span sink; error/deadline/breaker traces are always kept"),
    _k("DYN_FLIGHTREC", "bool", "1", "tracing",
       "always-on flight recorder: per-process black-box rings dumped "
       "into incident bundles (0 = record nothing)"),
    _k("DYN_FLIGHTREC_SPANS", "int", "2048", "tracing",
       "flight-recorder span ring capacity (every finished span, "
       "including head-sampled-out ones)"),
    _k("DYN_FLIGHTREC_EVENTS", "int", "4096", "tracing",
       "flight-recorder event ring capacity (engine step timings, gate "
       "waits, transfer EWMA snapshots, store health transitions)"),
    _k("DYN_FLIGHTREC_LOGTAIL", "int", "256", "tracing",
       "flight-recorder structured-log tail capacity"),
    _k("DYN_WATCHDOG", "bool", "1", "tracing",
       "hang watchdog: stall:* span emission + incident triggers (0 = "
       "heartbeats are recorded but never judged)"),
    _k("DYN_WATCHDOG_INTERVAL", "float", "0.25", "tracing",
       "watchdog poll period, seconds (its own tick lag is the "
       "event-loop-stall probe)"),
    _k("DYN_WATCHDOG_MULT", "float", "8.0", "tracing",
       "stall threshold as a multiple of an activity's EWMA unit time (a "
       "decode dispatch exceeding mult x EWMA step time is wedged)"),
    _k("DYN_WATCHDOG_FLOOR", "float", "1.0", "tracing",
       "absolute floor, seconds, under the EWMA-multiple threshold — a "
       "noisy sub-millisecond EWMA must not yield false stalls"),
    _k("DYN_WATCHDOG_TRANSFER", "float", "5.0", "tracing",
       "no-layer-progress budget for an in-flight disagg KV stream, "
       "seconds, before stall:transfer fires"),
    _k("DYN_WATCHDOG_LOOP_STALL", "float", "1.0", "tracing",
       "event-loop stall threshold: watchdog tick lateness, seconds"),
    _k("DYN_INCIDENT_TTL", "float", "3600", "tracing",
       "incident beacon + bundle lease TTL, seconds"),
    _k("DYN_INCIDENT_COOLDOWN", "float", "30", "tracing",
       "triggers raised within this many seconds of a live beacon attach "
       "to that incident instead of opening a new one"),
    _k("DYN_INCIDENT_WINDOW", "float", "30", "tracing",
       "ring-slice window dumped into a bundle, seconds before the "
       "trigger"),
    # ----------------------------------------------------------- metrics
    _k("DYN_FLOWS", "bool", "1", "metrics",
       "byte-flow ledger master switch; 0 disables all link accounting "
       "(the flows_overhead A/B arm)"),
    _k("DYN_LINK_WINDOW", "float", "10.0", "metrics",
       "trailing window for per-link rate/saturation, seconds"),
    _k("DYN_LINK_SAT_THRESHOLD", "float", "0.9", "metrics",
       "saturation level whose rising edge emits a link.congested "
       "flight-recorder event and bumps dyn_link_congested_total"),
    _k("DYN_LINK_CAPACITY_NET", "float", "0", "metrics",
       "calibrated capacity for network (worker-pair) links, bytes/s (0 "
       "= use each link's measured peak rate)"),
    _k("DYN_LINK_CAPACITY_H2D", "float", "0", "metrics",
       "calibrated capacity for host-to-device links, bytes/s (0 = "
       "measured peak)"),
    _k("DYN_LINK_CAPACITY_D2H", "float", "0", "metrics",
       "calibrated capacity for device-to-host links, bytes/s (0 = "
       "measured peak)"),
    _k("DYN_LINK_CAPACITY_DISK", "float", "0", "metrics",
       "calibrated capacity for disk/checkpoint-read links, bytes/s (0 = "
       "measured peak)"),
    # ----------------------------------------------------------- logging
    _k("DYN_LOG", "str", "info", "logging",
       "root log level, with per-target overrides "
       "('info,dynamo_tpu.runtime=debug')"),
    _k("DYN_LOGGING_JSONL", "str", "", "logging",
       "JSONL log output: '1'/'stderr' = JSON lines on stderr, other "
       "values = file path"),
    # --------------------------------------------------------------- slo
    _k("DYN_SLO_TTFT_P90", "float", "", "slo",
       "TTFT p90 objective, seconds (unset = SLO not monitored)"),
    _k("DYN_SLO_ITL_P90", "float", "", "slo",
       "inter-token latency p90 objective, seconds"),
    _k("DYN_SLO_AVAILABILITY", "float", "", "slo",
       "good-request fraction objective, e.g. 0.999"),
    _k("DYN_SLO_WINDOWS", "csv", "60,300,1800", "slo",
       "burn-rate windows, seconds"),
    # ------------------------------------- distributed runtime, store,
    # faults, stage publishing and the KV router
    _k("DYN_LEASE_TTL", "float", "10.0", "runtime",
       'store lease liveness TTL, seconds (keepalives fire every '
       'ttl/3)'),
    _k("DYN_DRAIN_TIMEOUT", "float", "10.0", "runtime",
       'graceful-drain grace on SIGTERM before cooperative stop, '
       'seconds'),
    _k("DYN_CB_THRESHOLD", "int", "3", "runtime",
       'consecutive failures that open an instance circuit breaker '
       '(0 disables)'),
    _k("DYN_CB_COOLDOWN", "float", "5.0", "runtime",
       'breaker OPEN hold before the half-open probe, seconds'),
    _k("DYN_RESUME_MAX", "int", "2", "runtime",
       "mid-stream failover budget: resume attempts per stream after a "
       "transport break or stall (0 disables resumable streams)"),
    _k("DYN_RESUME_STALL", "float", "30.0", "runtime",
       "inter-frame stall budget, seconds; a stream silent this long is "
       "treated as a break and resumed (0 disables stall detection)"),
    _k("DYN_STORE_RECONNECT", "bool", "1", "runtime",
       'store-client reconnect + session replay on connection loss'),
    _k("DYN_STORE_RECONNECT_ATTEMPTS", "int", "10", "runtime",
       'max reconnect attempts before the client reports closed'),
    _k("DYN_STORE_RECONNECT_BASE", "float", "0.05", "runtime",
       'reconnect backoff base delay, seconds (doubles per attempt)'),
    _k("DYN_STORE_RECONNECT_MAX", "float", "2.0", "runtime",
       'reconnect backoff ceiling, seconds'),
    _k("DYN_STORE_METRICS_INTERVAL", "float", "2.0", "store",
       "seconds between the store server's self-telemetry dumps into"
       ' its own KV (0 = record but never publish)'),
    _k("DYN_STORE_SHARDS", "str", "", "store",
       'static store shard map routing keyspace families/groups to '
       'extra dynstore processes, e.g. '
       "'telemetry=10.0.0.2:4222;traces=10.0.0.3:4222' (unset = the "
       'single default store; unrouted families stay on it)'),
    _k("DYN_REGION_INTERVAL", "float", "2.0", "store",
       "seconds between a regional aggregator's pre-merge ticks (one "
       "region record published per tick)"),
    _k("DYN_REGION_STALE", "float", "3*interval", "store",
       "age in seconds beyond which observers treat a region record as "
       "dead and fall back to the flat per-worker scrape"),
    _k("DYN_FAULTS", "csv", "", "faults",
       'fault-injection table armed at process start, e.g. '
       "'store.connect:refuse,kv.push.part:drop:0.5'"),
    _k("DYN_METRICS_PUSH_INTERVAL", "float", "0", "metrics",
       "min seconds between a worker's stage-metrics store writes (0"
       ' = every metrics-loop beat); writes are delta-coalesced '
       'either way'),
    _k("DYN_METRICS_FULL_EVERY", "int", "10", "metrics",
       'stage-metrics pushes per full snapshot (the rest ship only '
       'changed metrics)'),
    _k("DYN_STAGE_SLICES", "int", "16", "metrics",
       'worker-stable sub-prefix slices of the metrics_stage/ '
       'keyspace (worker_id mod slices); regional aggregators '
       'rendezvous-own slices and read only theirs per tick instead '
       'of scanning the full prefix (must agree fleet-wide)'),
    _k("DYN_ROUTER_AUDIT", "int", "512", "router",
       'router decision audit ring capacity'),
    _k("DYN_ROUTER_FAST_FAIL", "bool", "0", "router",
       'fail saturated scheduling with a typed 503 instead of '
       'capacity-waiting'),
    _k("DYN_KV_CLUSTER", "bool", "0", "router",
       'cluster-wide KV sharing: workers publish sealed-block '
       'registry records + serve/consume kv_fetch, routers stamp '
       'donors'),
    _k("DYN_KV_CLUSTER_PUBLISH_INTERVAL", "float", "1.0", "router",
       "min seconds between a worker's registry record writes "
       "(seal/evict-driven, write-coalesced)"),
    _k("DYN_KV_CLUSTER_FETCH_TIMEOUT", "float", "5.0", "router",
       "peer prefix fetch budget, seconds; expiry falls back to local "
       "prefill recompute"),
    _k("DYN_KV_CLUSTER_MAX_BLOCKS", "int", "0", "router",
       "cap on KV blocks per peer fetch, donor and receiver side "
       "(0 = unlimited)"),
    _k("DYN_KV_CLUSTER_PEER_WEIGHT", "float", "0.5", "router",
       "score value of a free peer-held block relative to a local block "
       "(discounted further by estimated transfer time)"),
    _k("DYN_ROUTER_TRANSFER_WEIGHT", "float", "1.0", "router",
       "logit penalty per expected KV-transfer second of a placement "
       "(bytes-to-move x measured per-pair bandwidth; 0 = transfer-cost "
       "term off)"),
    _k("DYN_H2D_PREFETCH_BLOCKS", "int", "32", "router",
       "device staging blocks for placement-driven h2d prefetch of "
       "matched tier prefixes while a request queues at the slot gate "
       "(0 = prefetch off, admission uploads synchronously as before)"),
    # ---------------------------------------------------------------- spec
    _k("DYN_SPEC", "str", "", "spec",
       "speculative decoding mode: '' (off) | ngram | draft"),
    _k("DYN_SPEC_K", "int", "4", "spec",
       "max draft tokens per lane per dispatch"),
    _k("DYN_SPEC_K_MIN", "int", "1", "spec", "adaptive-k floor"),
    _k("DYN_SPEC_ADAPT", "bool", "1", "spec",
       "per-lane adaptive k on acceptance history"),
    _k("DYN_SPEC_NGRAM_MAX", "int", "3", "spec",
       "longest suffix n-gram the prompt-lookup proposer tries"),
    _k("DYN_SPEC_NGRAM_MIN", "int", "1", "spec",
       "shortest suffix n-gram fallback"),
    _k("DYN_SPEC_NGRAM_WINDOW", "int", "2048", "spec",
       "trailing-token window the n-gram proposer indexes"),
    _k("DYN_SPEC_DRAFT", "str", "", "spec",
       "draft model preset name or checkpoint dir (mode=draft)"),
    # -------------------------------------------------------- KV paging
    _k("DYN_KVPAGE_DEVICE_BUDGET", "int", "0", "kvpage",
       "device KV pages the paged long-context lane may hold resident "
       "(0 = KV paging off; engine-config kvpage_budget overrides)"),
    _k("DYN_KVPAGE_SEG_PAGES", "int", "8", "kvpage",
       "cold KV blocks per staged h2d upload segment"),
    _k("DYN_KVPAGE_PREFETCH", "int", "2", "kvpage",
       "segments the page-in thread assembles ahead of the attention "
       "pass (0 = synchronous page-ins, every one a counted fault)"),
    _k("DYN_KVPAGE_MAX_CONTEXT", "int", "131072", "kvpage",
       "context ceiling of the paged lane, tokens (the dense path's "
       "max_context still governs normal requests)"),
    _k("DYN_KVPAGE_DECODE_STEPS", "int", "4", "kvpage",
       "paged-lane decode tokens chained on-device per host fetch "
       "(sampled token feeds the next forward without a round-trip; "
       "1 = per-token synchronous as before)"),
    _k("DYN_KVPAGE_BATCH", "int", "1", "kvpage",
       "concurrent paged decode lanes sharing the device budget: each "
       "lane gets budget/batch pages and one batched dispatch serves a "
       "window step for every lane, with cold segments lane-stacked "
       "into shared staging slots (engine-config kvpage_batch "
       "overrides; 1 = the serial lane)"),
    # -------------------------------------------------------------- disagg
    _k("DYN_PREFILL_QUEUE_MAX", "int", "0", "disagg",
       "bounded shared prefill queue depth (0 = unbounded)"),
    _k("DYN_PREFILL_QUEUE_MAX_BATCH", "int", "max/2", "disagg",
       "batch-priority share of the prefill queue"),
    _k("DYN_KV_STREAM", "bool", "1", "disagg",
       "layer-streamed disagg KV ingestion: each arriving layer's device "
       "scatter is enqueued while later layers are in flight (0 = legacy "
       "full-arrival import; the bench A/B switch)"),
    _k("DYN_KV_BW_ALPHA", "float", "0.3", "disagg",
       "EWMA weight of a new per-pair KV-transfer bandwidth observation "
       "(llm_kv_pair_bw_bytes_per_s)"),
    # ---------------------------------------------------------- roofline
    _k("DYN_PEAK_FLOPS", "float", "", "roofline",
       "override peak accelerator FLOP/s for MFU accounting"),
    _k("DYN_PEAK_GBPS", "float", "", "roofline",
       "override peak HBM GB/s for MBU accounting"),
    # --------------------------------------------------------------- llm
    _k("DYN_TOKEN_ECHO_DELAY_MS", "float", "10", "llm",
       "echo-engine per-token pacing, milliseconds (0 = as fast as "
       "possible; test/bench fixture)"),
    # --------------------------------------------------------------- sdk
    _k("DYN_SERVICE_CONFIG", "json", "", "sdk",
       "service-graph config JSON injected into sdk.serve children"),
    _k("DYN_SERVICE_CONFIG_FILE", "str", "", "sdk",
       "path to the service config JSON (set by deploy manifests)"),
]

# The regional aggregator daemon (cli/aggregator.py) resolves its flags
# through the dynconfig layering as DYN_AGGREGATOR_<FLAG>.
_AGGREGATOR = [
    ("STORE", "str", "127.0.0.1:4222", "store host:port"),
    ("NAMESPACE", "str", "dynamo", "namespace whose workers this "
                                   "aggregator's region tree covers"),
    ("INTERVAL", "float", "DYN_REGION_INTERVAL", "seconds between "
                                                 "region merges"),
]
_ALL.extend(
    _k(f"DYN_AGGREGATOR_{flag}", typ, default, "store", desc,
       derived=True)
    for flag, typ, default, desc in _AGGREGATOR)

KNOBS: Dict[str, Knob] = {k.name: k for k in _ALL}
if len(KNOBS) != len(_ALL):
    raise RuntimeError("duplicate knob registration")
