"""Central registry of the dynstore keyspace (the port's copy).

Every key the system puts/watches in dynstore belongs to exactly one
prefix family registered here: its owner subsystem, its lifecycle
(lease-bound liveness state vs persistent config/log vs TTL tombstone vs
work queue), the module that defines its helper/constant, and a one-line
description. The store server labels its per-op telemetry with
:func:`classify_key`, so a JAX store and the port's store report the same
families for the same keys. The port's ``store-key-drift`` dynalint rule
gates the registry two-way — every store API call site of the port must
resolve (through the def-use layer) to a registered family, and every
family must still have call sites — and the port's keyspace document is
generated from it::

    python -m dynamo_tpu_torch.runtime.keyspace --write

Key families whose *literal* prefix starts with a placeholder (endpoint
registrations live under ``{namespace}/components/...``) cannot be
grepped; they are resolvable only through their registered helpers,
which is exactly why the gate is dataflow-based.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

#: lifecycle classes (how a key leaves the store)
LEASE = "lease"            # bound to a session lease: vanishes with owner
PERSISTENT = "persistent"  # lives until an explicit delete
TTL = "ttl"                # bound to a short no-keepalive lease
QUEUE = "queue"            # dynstore work queue (q_push/q_pull namespace)

#: shard ownership groups: the family sets that co-locate when the store
#: is split across dynstore processes (``DYN_STORE_SHARDS`` tokens may
#: name a group instead of listing its families one by one — see
#: runtime/scale/shards.py). The boundaries follow the per-family op
#: accounting (``dyn_store_op_seconds{family}``): write-heavy telemetry
#: and the TTL-churning span sink are the planes worth isolating first.
SHARD_CONTROL = "control"      # discovery/config/planner — low rate, hot
SHARD_TELEMETRY = "telemetry"  # metrics dumps + region records — high write
SHARD_TRACES = "traces"        # span sink — highest key churn (TTL)
SHARD_QUEUE = "queue"          # prefill work queues — latency-critical
SHARD_KV = "kv"                # KV-cluster registry — router-read-heavy


@dataclass(frozen=True)
class KeyFamily:
    """One registered store-key prefix family."""

    name: str                 # short id used in findings/docs
    pattern: str              # full key pattern, for humans
    owner: str                # owning subsystem (module path)
    lifecycle: str            # LEASE | PERSISTENT | TTL | QUEUE
    description: str
    #: literal prefix a key string starts with (None when the pattern
    #: starts with a placeholder and only helpers can build it)
    prefix: Optional[str] = None
    #: helper functions that build/parse keys of this family
    helpers: Tuple[str, ...] = ()
    #: module-level constants naming the prefix
    constants: Tuple[str, ...] = ()
    #: shard ownership group (see SHARD_* above): which dynstore process
    #: serves this family when DYN_STORE_SHARDS splits the keyspace
    shard: str = SHARD_CONTROL


_ALL: List[KeyFamily] = [
    KeyFamily(
        name="endpoints",
        pattern="{ns}/components/{component}/{endpoint}:{lease:x}",
        owner="runtime/component.py", lifecycle=LEASE,
        description="endpoint instance registrations — the service "
                    "discovery plane; key suffix is the worker's lease id "
                    "(= worker_id), so instances vanish with their lease",
        helpers=("endpoint_key", "endpoint_prefix")),
    KeyFamily(
        name="models",
        pattern="models/{model_type}/{name}[:i-{instance}]",
        owner="llm/remote.py", lifecycle=LEASE,
        description="model cards published by workers (chat template, "
                    "context length, runtime config) for frontends",
        prefix="models/", helpers=("model_key", "split_model_key"),
        constants=("MODEL_PREFIX",)),
    KeyFamily(
        name="metrics",
        pattern="metrics/{ns}/{component}/{worker_id:x}",
        owner="llm/metrics_aggregator.py", lifecycle=LEASE,
        description="per-worker ForwardPassMetrics snapshots (slots, KV "
                    "occupancy, hit rate) scraped by router/planner",
        prefix="metrics/", helpers=("metrics_key",),
        constants=("METRICS_PREFIX",), shard=SHARD_TELEMETRY),
    KeyFamily(
        name="metrics-stage",
        pattern="metrics_stage/{ns}/s{wid mod DYN_STAGE_SLICES:02x}/"
                "{component}/{worker_id:x}[/delta]",
        owner="llm/metrics_aggregator.py", lifecycle=LEASE,
        description="per-stage Prometheus registry snapshots merged "
                    "cluster-wide by the metrics aggregator (full "
                    "snapshot + coalesced since-last-full delta key); "
                    "the worker-stable slice segment lets a regional "
                    "aggregator read only its rendezvous-owned slices "
                    "per tick instead of scanning the fleet",
        prefix="metrics_stage/",
        helpers=("stage_key", "stage_delta_key", "stage_slice_prefix"),
        constants=("STAGE_PREFIX",), shard=SHARD_TELEMETRY),
    KeyFamily(
        name="metrics-store",
        pattern="metrics_stage/_store/store/0",
        owner="runtime/store_server.py", lifecycle=PERSISTENT,
        description="the store's OWN telemetry dump (per-op latency by "
                    "keyspace family, watch/lease/key gauges), written "
                    "into its KV by the server itself; dies with the "
                    "store process",
        prefix="metrics_stage/_store/", constants=("STORE_STAGE_PREFIX",),
        shard=SHARD_TELEMETRY),
    KeyFamily(
        # dynalint: ok(store-key-drift) no module of the port writes this
        # family (the JAX package's fleet soak does); it stays registered so
        # the port's store labels a mixed fleet's beacon keys as the JAX store
        # does
        name="fleet-soak",
        pattern="fleet/{ns}/beacon",
        owner="scripts/fleet_soak.py", lifecycle=PERSISTENT,
        description="fleet-soak watch fan-out beacon: the soak puts a "
                    "timestamped payload, every synthetic worker watches "
                    "the prefix and reports delivery lag",
        prefix="fleet/", helpers=("fleet_beacon_key",
                                  "fleet_beacon_prefix"),
        shard=SHARD_TELEMETRY),
    KeyFamily(
        name="fleet-models",
        pattern="fleet_models/{ns}/{model}",
        owner="fleet/registry.py", lifecycle=PERSISTENT,
        description="desired-state model registry: one record per served "
                    "model (card ref, component, chip shape, min/max "
                    "replicas, priority, tenant quota table) mutated by "
                    "`ctl fleet add/remove`, reconciled by the planner's "
                    "fleet plane and watched by fleet routers/frontends",
        prefix="fleet_models/",
        helpers=("fleet_model_key", "fleet_models_prefix"),
        constants=("FLEET_MODELS_PREFIX",)),
    KeyFamily(
        name="fleet-status",
        pattern="fleet_status/{ns}/{model}",
        owner="fleet/registry.py", lifecycle=LEASE,
        description="observed per-model state (replicas, target, "
                    "ready/booting/draining/off, chips, SLO burn) "
                    "published lease-bound by the reconciling planner; "
                    "rendered by GET /v1/models, dyntop and plannerctl",
        prefix="fleet_status/",
        helpers=("fleet_status_key", "fleet_status_prefix"),
        constants=("FLEET_STATUS_PREFIX",)),
    KeyFamily(
        name="mobility",
        pattern="mobility/{ns}/(prefetch|swap)/{component}"
                " | mobility/{ns}/wake/{model}",
        owner="fleet/mobility/keys.py", lifecycle=PERSISTENT,
        description="model-mobility control plane: per-component weight "
                    "prefetch hints (arbiter swap-group siblings + `ctl "
                    "fleet add --prewarm`), SIGUSR1-style swap commands "
                    "one worker of the component claims-by-delete, and "
                    "per-model last-wake records (path swap|cold, "
                    "seconds) read by /v1/models, dyntop and the soak "
                    "wake lane",
        prefix="mobility/",
        helpers=("mobility_prefetch_key", "mobility_prefix",
                 "mobility_swap_key", "mobility_wake_key",
                 "mobility_wake_prefix")),
    KeyFamily(
        name="faults",
        pattern="faults/{point}",
        owner="utils/faults.py", lifecycle=PERSISTENT,
        description="live fault-injection points (operator-written; value "
                    "is the fault spec) watched by every process",
        prefix="faults/", constants=("FAULTS_PREFIX",)),
    KeyFamily(
        name="overload",
        pattern="overload/{ns}/brownout",
        owner="utils/overload.py", lifecycle=LEASE,
        description="fleet-wide brownout level published by the brownout "
                    "controller, watched by frontends + routers",
        prefix="overload/", helpers=("brownout_key",),
        constants=("BROWNOUT_PREFIX",)),
    KeyFamily(
        name="traces",
        pattern="traces/{trace_id}/{span_id}",
        owner="utils/tracing.py", lifecycle=TTL,
        description="cross-process span sink (TTL-leased, rotated at "
                    "ttl/2) read by GET /v1/traces/{request_id}",
        prefix="traces/", helpers=("trace_store_key",),
        constants=("TRACE_STORE_PREFIX",), shard=SHARD_TRACES),
    KeyFamily(
        name="planner",
        pattern="planner/{ns}/(state|override|decisions/{seq:016d})",
        owner="planner/loop.py", lifecycle=PERSISTENT,
        description="autoscaler plane: lease-bound liveness state, "
                    "operator override/pause, decision audit log "
                    "(pruned by the loop itself)",
        prefix="planner/",
        helpers=("planner_prefix", "state_key", "override_key",
                 "decisions_prefix")),
    KeyFamily(
        name="kv-cluster",
        pattern="kv_cluster/{ns}/{component}/{worker_id:x}",
        owner="llm/kv_cluster/registry.py", lifecycle=LEASE,
        description="cluster-wide sealed-block registry: one lease-bound "
                    "record per worker (tier geometry + resident host/disk "
                    "hashes) watched by routers for cluster-hit scoring; "
                    "dead owners' records vanish with their lease",
        prefix="kv_cluster/", helpers=("cluster_key", "cluster_prefix"),
        constants=("KV_CLUSTER_PREFIX",), shard=SHARD_KV),
    KeyFamily(
        name="disagg-config",
        pattern="disagg/{ns}/{model}",
        owner="llm/disagg.py", lifecycle=PERSISTENT,
        description="disaggregation router thresholds, watched live by "
                    "decode workers (etcd-watched config in the "
                    "reference)",
        prefix="disagg/", helpers=("disagg_config_key",),
        constants=("DISAGG_CONFIG_PREFIX",)),
    KeyFamily(
        name="prefill-queue",
        pattern="{ns}.prefill[.batch]",
        owner="llm/disagg.py", lifecycle=QUEUE,
        description="per-priority remote-prefill work queues (interactive "
                    "keeps the legacy unsuffixed name)",
        helpers=("prefill_queue_name", "prefill_queue_names"),
        shard=SHARD_QUEUE),
    KeyFamily(
        name="prefill-cancel",
        pattern="{ns}.prefill/cancelled/{request_id}",
        owner="llm/disagg.py", lifecycle=TTL,
        description="cancellation tombstones letting prefill workers drop "
                    "dequeued jobs nobody waits for (TTL-leased)",
        helpers=("_cancel_key",), shard=SHARD_QUEUE),
    KeyFamily(
        name="regions",
        pattern="regions/{ns}/{agg_id:x}",
        owner="runtime/scale/regions.py", lifecycle=LEASE,
        description="hierarchical observer tree: one lease-bound record "
                    "per regional aggregator (pre-merged stage metrics + "
                    "ForwardPassMetrics of its rendezvous-owned workers), "
                    "read by fetch_stage_states / planner / SLO / dyntop "
                    "instead of the flat per-worker scrape; a dead "
                    "aggregator's record vanishes with its lease and the "
                    "surviving peers re-absorb its workers",
        prefix="regions/", helpers=("region_key", "regions_prefix"),
        constants=("REGIONS_PREFIX",), shard=SHARD_TELEMETRY),
    KeyFamily(
        name="incidents",
        pattern="incidents/{ns}/(beacon|bundle/{id})/...",
        owner="obs/incidents.py", lifecycle=TTL,
        description="coordinated incident capture: beacons (the "
                    "manifest every process watches — any trigger "
                    "freezes fleet-wide ring dumps) and per-process "
                    "flight-recorder dumps under the bundle prefix; "
                    "both expire with their DYN_INCIDENT_TTL lease",
        prefix="incidents/",
        helpers=("incident_beacon_key", "incident_beacon_prefix",
                 "incident_dump_key", "incident_dump_prefix"),
        constants=("INCIDENT_PREFIX",), shard=SHARD_TELEMETRY),
    KeyFamily(
        name="deployments",
        pattern="deploy/deployments/{ns}/{name}",
        owner="deploy/crd.py", lifecycle=PERSISTENT,
        description="DynamoDeployment specs (the CRD store), watched by "
                    "the operator reconcile loop",
        prefix="deploy/deployments/", helpers=("deploy_key",),
        constants=("DEPLOY_PREFIX",)),
    KeyFamily(
        name="deploy-status",
        pattern="deploy/status/{ns}/{name}",
        owner="deploy/operator.py", lifecycle=PERSISTENT,
        description="observed deployment state written back by the "
                    "operator (deleted when the deployment goes)",
        prefix="deploy/status/", helpers=("status_key",),
        constants=("STATUS_PREFIX",)),
    KeyFamily(
        name="deploy-artifacts",
        pattern="deploy/artifacts/{name}/{version:08d}[.json]",
        owner="deploy/artifacts.py", lifecycle=PERSISTENT,
        description="artifact descriptors (image digests, object-store "
                    "pointers) versioned per name",
        prefix="deploy/artifacts/", helpers=("descriptor_key",),
        constants=("ARTIFACT_PREFIX",)),
]

KEYSPACE: Dict[str, KeyFamily] = {f.name: f for f in _ALL}
if len(KEYSPACE) != len(_ALL):
    raise RuntimeError("duplicate keyspace family registration")

#: literal prefixes, longest first (so deploy/status/ wins over deploy/)
PREFIXES: List[Tuple[str, KeyFamily]] = sorted(
    ((f.prefix, f) for f in _ALL if f.prefix),
    key=lambda p: -len(p[0]))

HELPER_INDEX: Dict[str, KeyFamily] = {
    h: f for f in _ALL for h in f.helpers}
CONSTANT_INDEX: Dict[str, KeyFamily] = {
    c: f for f in _ALL for c in f.constants}


def family_for_literal(head: str) -> Optional[KeyFamily]:
    """The registered family a literal key head belongs to, if any (a
    partial head matches too: the lint resolver sees f-string heads)."""
    for prefix, fam in PREFIXES:
        if head.startswith(prefix) or prefix.startswith(head):
            return fam
    return None


def families_for_prefix(prefix: str) -> List[str]:
    """Every family a ``get_prefix``/``watch_prefix`` over ``prefix``
    could touch — the sharded store client's fan-out set (a scan may
    span families: ``metrics_stage/`` covers both ``metrics-stage`` and
    ``metrics-store``). Falls back to the placeholder-led patterns like
    :func:`classify_key`; an unmatchable prefix returns ``["other"]``
    (routed to the default shard), and the EMPTY prefix scans every
    family."""
    if prefix == "":
        return [f.name for f in _ALL] + ["other"]
    out = [fam.name for p, fam in PREFIXES
           if p.startswith(prefix) or prefix.startswith(p)]
    if "/components/" in prefix:
        out.append("endpoints")
    if not out:
        out.append("other")
    return out


def classify_key(key: str) -> str:
    """Family name for a FULL key/queue name (the store's own per-op
    telemetry labels every ``dyn_store_op_seconds`` series with this).

    It requires a real prefix match, then falls back to the
    placeholder-led patterns the registry cannot express as literals:
    endpoint registrations (``{ns}/components/...``) and the per-namespace
    prefill queue/cancel names. Everything else is ``"other"`` — a growing
    ``other`` rate in the store dump means an unregistered keyspace.
    """
    for prefix, fam in PREFIXES:
        if key.startswith(prefix):
            return fam.name
    if "/components/" in key:
        return "endpoints"
    if ".prefill/cancelled/" in key:
        return "prefill-cancel"
    if key.endswith(".prefill") or key.endswith(".prefill.batch"):
        return "prefill-queue"
    return "other"


#: the generated document, relative to the repository root
DOC_REL = "dynamo_tpu_torch/docs/keyspace.md"


def render_markdown(wire_fields: Optional[Dict[str, str]] = None) -> str:
    """The generated body of the port's keyspace document (store families
    + the wire control-header field registry — the two distributed-protocol
    surfaces its dynalint gates).

    ``wire_fields`` defaults to importing ``wire.WIRE_FIELDS`` — the lint
    rule passes its AST-extracted copy instead, so a dynalint run never
    imports wire.py (and thus msgpack) on analysis-only machines."""
    if wire_fields is None:
        from .wire import WIRE_FIELDS as wire_fields

    out = [
        "# Keyspace & wire protocol registry (PyTorch port)",
        "",
        "<!-- GENERATED FILE — do not edit by hand. "
        "Regenerate: python -m dynamo_tpu_torch.runtime.keyspace --write -->",
        "",
        "The two cross-process protocol surfaces of `dynamo_tpu_torch`,",
        "generated from their central registries and gated two-way by the",
        "port's dynalint (`store-key-drift`, `wire-field-drift`; run",
        "`python -m dynamo_tpu_torch.cli.dynalint`): every producer/consumer",
        "call site must resolve to a registered entry, every entry must",
        "still be used, and this file must match the registries",
        "byte-for-byte.",
        "",
        "## Store keyspace (`dynamo_tpu_torch/runtime/keyspace.py`)",
        "",
        "Lifecycle: **lease** keys vanish with their owner's session lease;",
        "**persistent** keys live until an explicit delete; **ttl** keys",
        "ride a short no-keepalive lease; **queue** names address dynstore",
        "work queues rather than KV keys.",
        "",
        "The **shard** column is the family's ownership group when the",
        "store is split across dynstore processes: a `DYN_STORE_SHARDS`",
        "token may name a group to route all of its families to one",
        "shard. Unrouted families (and the `other` fallback) stay on the",
        "default store.",
        "",
        "| family | key pattern | owner | lifecycle | shard | "
        "description |",
        "|---|---|---|---|---|---|",
    ]
    for f in sorted(_ALL, key=lambda f: f.name):
        out.append(f"| `{f.name}` | `{f.pattern}` | {f.owner} | "
                   f"{f.lifecycle} | {f.shard} | {f.description} |")
    out.extend([
        "",
        f"{len(_ALL)} key families registered.",
        "",
        "## Wire control-header fields (`dynamo_tpu_torch/runtime/wire.py`)",
        "",
        "Every field name that may appear in a two-part frame's control",
        "header. Producers/consumers must spell these through the",
        "registry constants — planes that drop unknown fields degrade",
        "gracefully, but a misspelled field is a silent protocol fork.",
        "",
        "| field | description |",
        "|---|---|",
    ])
    for name in sorted(wire_fields):
        out.append(f"| `{name}` | {wire_fields[name]} |")
    out.extend(["", f"{len(wire_fields)} wire fields registered.", ""])
    return "\n".join(out)


def _main(argv: List[str]) -> int:
    import os
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    target = os.path.join(repo, DOC_REL)
    if "--write" in argv:
        os.makedirs(os.path.dirname(target), exist_ok=True)
        with open(target, "w", encoding="utf-8") as f:
            f.write(render_markdown())
        print(f"wrote {target} ({len(KEYSPACE)} key families)")
    else:
        print(render_markdown())
    return 0


if __name__ == "__main__":          # pragma: no cover - trivial shell
    import sys
    sys.exit(_main(sys.argv[1:]))
