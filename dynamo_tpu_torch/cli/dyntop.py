"""dyntop: the operator's single pane of glass — a live cluster view.

    python -m dynamo_tpu_torch.cli.dyntop --store 127.0.0.1:4222 \
        [--namespace dynamo] [--component backend --component prefill] \
        [--interval 1.0] [--once] [--plain]

Reads the same planes the metrics aggregator and the planner's signal
collector read — per-worker ``ForwardPassMetrics`` snapshots under
``metrics/`` and the stage-histogram dumps under ``metrics_stage/`` — and
renders, per worker: active/total slots, KV occupancy, prefix hit rate,
MFU / MBU / achieved HBM GB/s, spec accept rate, and circuit-breaker
state; plus cluster-level TTFT/ITL p90, prefill queue depth, compile
counters, and SLO burn rates (when ``DYN_SLO_*`` objectives are set).
The coordination store renders as its own ``store:`` line (op/s, p99 of
the hottest keyspace family, watches/leases/conns, watch fan-out/s,
telemetry drops) from the dump it publishes about itself;
``--store-detail`` expands it into a per-family table.

Renders with curses when stdout is a TTY (plain ANSI-refresh otherwise or
with ``--plain``); ``--once`` prints a single snapshot and exits (what the
loopback smoke test drives).

The JAX package's ``dyntop``: for the same store contents, from JAX or
port workers alike, ``--once --plain`` renders the same text.
"""

from __future__ import annotations

import argparse
import asyncio
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

from ..utils.dynconfig import EnvDefaultsParser
from ..utils.prometheus import hist_quantile


def parse_args(argv=None) -> argparse.Namespace:
    p = EnvDefaultsParser(prog="dyntop")
    p.add_argument("--store", default="127.0.0.1:4222")
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--component", action="append", default=None,
                   help="worker component to watch (repeatable; "
                        "default: backend + prefill)")
    p.add_argument("--interval", type=float, default=1.0)
    p.add_argument("--once", action="store_true",
                   help="print one snapshot and exit")
    p.add_argument("--plain", action="store_true",
                   help="force plain-refresh output (no curses)")
    p.add_argument("--store-detail", action="store_true",
                   help="expand the store: line into a per-keyspace-"
                        "family table (ops, p99, resident keys/bytes, "
                        "queue depth)")
    return p.parse_args(argv)


# ---------------------------------------------------------------------------
# collection (one store round-trip set per refresh)
# ---------------------------------------------------------------------------
class ClusterSnapshotter:
    """Assembles one renderable snapshot per tick from the store planes.
    Owns an :class:`~dynamo_tpu_torch.utils.slo.SloMonitor` so burn rates
    accumulate across refreshes."""

    def __init__(self, store, namespace: str, components: List[str]):
        from ..utils.slo import SloMonitor

        self.store = store
        self.namespace = namespace
        self.components = list(components)
        # gauge=None: dyntop observes, it does not export
        self.slo = SloMonitor(registry_gauge=None)
        # previous refresh's store totals (monotonic, ops_total,
        # fanout_total, per-family bucket counts): differentiated into
        # the store line's op/s, fan-out/s, and windowed hot-family p99
        self._store_prev: Optional[Dict] = None

    async def collect(self) -> Dict:
        from ..llm.disagg import prefill_queue_names
        from ..llm.metrics_aggregator import (fetch_stage_states_ex,
                                              fetch_worker_metrics)
        from ..planner.signals import open_instance_ids, quantile_from_states
        from ..utils.overload import (admission_depth_total,
                                      brownout_level_from_states,
                                      shed_totals)

        states, regional = await fetch_stage_states_ex(self.store,
                                                       self.namespace)
        # fleet plane: per-model pool rows (and their components join the
        # worker table automatically — a fleet's pools are per-model, so
        # a static --component list would render an empty fleet)
        from ..fleet.registry import fetch_fleet_status, list_fleet_models

        fleet: Dict[str, Dict] = {}
        try:
            specs = await list_fleet_models(self.store, self.namespace)
            if specs:
                status = await fetch_fleet_status(self.store,
                                                  self.namespace)
                for s in specs:
                    fleet[s.name] = {
                        "component": s.component,
                        "min": s.min_replicas, "max": s.max_replicas,
                        "priority": s.priority,
                        "chips_per_replica": s.chips_per_replica,
                        **(status.get(s.name) or {"state": "unreconciled"}),
                    }
        except Exception:  # noqa: BLE001 - fleet plane optional
            pass
        components = list(self.components)
        for f in fleet.values():
            if f["component"] not in components:
                components.append(f["component"])
        workers: Dict[str, Dict] = {}
        if regional is not None:
            # region path: per-worker ForwardPassMetrics ride the region
            # records — zero per-component store scans, and components
            # the aggregators found join the table automatically
            for comp in set(components) | set(regional.fpm):
                workers[comp] = regional.workers_for(comp)
        else:
            for comp in components:
                workers[comp] = await fetch_worker_metrics(
                    self.store, self.namespace, comp)
        q_depth = 0
        for qname in prefill_queue_names(self.namespace):
            try:
                q_depth += await self.store.q_len(qname)
            except Exception:  # noqa: BLE001 - queue plane optional
                pass
        store_stats = store_stats_from_states(states)
        if store_stats is not None:
            # fleet-side telemetry-pipeline losses ride the same dumps
            for name, key in (("dyn_spans_dropped_total", "span_drops"),
                              ("dyn_spans_sampled_out_total",
                               "spans_sampled_out")):
                tot = 0.0
                for _comp, dump in states:
                    st = dump.get(name) or {}
                    tot += sum((st.get("series") or {}).values())
                store_stats[key] = tot
            now = time.monotonic()
            prev = self._store_prev
            fam_counts = store_stats.pop("_fam_counts", {})
            buckets = store_stats.pop("_buckets", None)
            if prev is not None and now > prev["t"]:
                dt = now - prev["t"]
                store_stats["op_rate"] = max(
                    store_stats["ops_total"] - prev["ops"], 0.0) / dt
                store_stats["fanout_rate"] = max(
                    store_stats["fanout_total"] - prev["fanout"], 0.0) / dt
                # windowed per-family view (this refresh only): an
                # incident-slow store must move the rendered hot/p99
                # immediately, not after it outweighs the lifetime counts
                window: Dict[str, Dict] = {}
                for fam, cur in fam_counts.items():
                    base = prev["fams"].get(fam)
                    d_ops = cur["ops"] - (base["ops"] if base else 0)
                    if d_ops <= 0:
                        continue
                    d_counts = [x - y for x, y in zip(
                        cur["counts"] or [], base["counts"] or [])] \
                        if base else cur["counts"]
                    window[fam] = {
                        "ops": d_ops,
                        "p99_s": hist_quantile(buckets, d_counts,
                                               d_ops, 0.99)}
                store_stats["families_window"] = window
            self._store_prev = {"t": now,
                                "ops": store_stats["ops_total"],
                                "fanout": store_stats["fanout_total"],
                                "fams": fam_counts}
        # sharded store: every shard publishes its own self-dump under
        # the same metrics_stage/_store/ key in its own KV — read each
        # shard's copy for the --store-detail per-shard rows
        store_shards: Optional[Dict[str, Optional[Dict]]] = None
        shard_of_family: Dict[str, str] = {}
        if hasattr(self.store, "get_prefix_on"):
            from ..llm.metrics_aggregator import (STORE_STAGE_PREFIX,
                                                  merge_stage_items)

            store_shards = {}
            for i, name in enumerate(self.store.shard_names):
                try:
                    items = await self.store.get_prefix_on(
                        i, STORE_STAGE_PREFIX)
                except Exception:  # noqa: BLE001 - a dead shard renders
                    # as such instead of blanking the whole table
                    store_shards[name] = None
                    continue
                sstates = [(d.get("component") or "store", m)
                           for _k, (d, m) in
                           merge_stage_items(items).items()]
                st = store_stats_from_states(sstates)
                if st is not None:
                    st.pop("_fam_counts", None)
                    st.pop("_buckets", None)
                store_shards[name] = st
            for fam, idx in self.store.fam_map.items():
                shard_of_family[fam] = self.store.shard_names[idx]
        # live incident beacons (flight-recorder capture plane)
        incidents: List[Dict] = []
        try:
            from ..obs.incidents import list_incidents

            incidents = await list_incidents(self.store, self.namespace)
        except Exception:  # noqa: BLE001 - incident plane optional
            pass
        burn = self.slo.observe(states) if self.slo.objectives else {}
        overload = {
            "brownout": brownout_level_from_states(states),
            "shed_total": shed_totals(states),
            "admission_depth": admission_depth_total(states),
        }
        from ..obs.flows import flows_from_states

        return {
            "cluster": cluster_kv_totals(states),
            "transfer": transfer_totals(states),
            "links": flows_from_states(states),
            "paging": kvpage_totals(states),
            "fleet": fleet,
            "at": time.time(),
            "namespace": self.namespace,
            "regions": regional.meta if regional is not None else None,
            "store": store_stats,
            "store_shards": store_shards,
            "shard_of_family": shard_of_family,
            "workers": workers,
            "breaker_open": open_instance_ids(states),
            "ttft_p90": quantile_from_states(states, "llm_ttft_seconds",
                                             0.90),
            "itl_p90": quantile_from_states(states,
                                            "llm_inter_token_seconds", 0.90),
            "prefill_queue": q_depth,
            "compiles": _compile_totals(states),
            "slo_burn": burn,
            "overload": overload,
            "incidents": incidents,
        }


def store_stats_from_states(states) -> Optional[Dict]:
    """The store server's self-telemetry, extracted from one
    ``fetch_stage_states`` result (the ``component="store"`` dump the
    server writes into its own KV). Returns cumulative totals; the
    snapshotter differentiates successive calls into op/s and fan-out/s.
    None when no store dump is being published (old store, or
    ``DYN_STORE_METRICS_INTERVAL=0``)."""
    from ..utils.prometheus import merge_state_dumps

    dumps = [d for comp, d in states
             if comp == "store" and "dyn_store_op_seconds" in d]
    if not dumps:
        return None
    # a sharded store surfaces one dump per shard: the store: line shows
    # their sum (the per-shard split lives in --store-detail)
    dump = dumps[0] if len(dumps) == 1 else merge_state_dumps(dumps)

    def gauge(name: str) -> float:
        st = dump.get(name) or {}
        return float(sum((st.get("series") or {}).values()) or 0.0)

    ops = dump["dyn_store_op_seconds"]
    fams: Dict[str, Dict] = {}
    for skey, val in (ops.get("series") or {}).items():
        parts = skey.split("\x1f")
        fam = parts[1] if len(parts) > 1 else "?"
        agg = fams.setdefault(fam, {"ops": 0, "counts": None})
        agg["ops"] += val.get("total", 0)
        counts = val.get("counts") or []
        if agg["counts"] is None:
            agg["counts"] = list(counts)
        else:
            agg["counts"] = [a + b for a, b in zip(agg["counts"], counts)]
    families = {
        fam: {"ops": a["ops"],
              "p99_s": hist_quantile(ops.get("buckets"), a["counts"],
                                     a["ops"], 0.99)}
        for fam, a in fams.items()}
    per_fam_gauges = {}
    for name, field in (("dyn_store_keys", "keys"),
                        ("dyn_store_bytes", "bytes"),
                        ("dyn_store_queue_depth", "queue_depth")):
        st = dump.get(name) or {}
        for skey, val in (st.get("series") or {}).items():
            fam = skey.split("\x1f")[0] if skey else "?"
            per_fam_gauges.setdefault(fam, {})[field] = val
    return {
        "ops_total": sum(f["ops"] for f in families.values()),
        "families": families,
        # raw per-family bucket counts + edges: the snapshotter diffs
        # successive refreshes into the windowed hot-family/p99 the
        # store: line shows (cumulative p99 barely moves in an incident)
        "_fam_counts": {fam: {"ops": a["ops"], "counts": a["counts"]}
                        for fam, a in fams.items()},
        "_buckets": ops.get("buckets"),
        "family_gauges": per_fam_gauges,
        "watches": gauge("dyn_store_watches"),
        "leases": gauge("dyn_store_leases"),
        "conns": gauge("dyn_store_conns"),
        "keys_total": gauge("dyn_store_keys"),
        "bytes_total": gauge("dyn_store_bytes"),
        "fanout_total": gauge("dyn_store_watch_fanout_total"),
        "drops": gauge("dyn_store_fanout_drops_total"),
    }


def cluster_kv_totals(states) -> Dict[str, float]:
    """Fleet-summed KV tier + cluster-sharing counters from one
    ``fetch_stage_states`` result — the ``cluster:`` line's numbers.
    All-zero when the plane is off (nothing rendered then)."""
    names = {
        "dyn_kv_tier_hits_total": "tier_hits",
        "dyn_kv_tier_misses_total": "tier_misses",
        "dyn_kv_cluster_hits_total": "hits",
        "dyn_kv_cluster_fetches_total": "fetches",
        "dyn_kv_cluster_fallbacks_total": "fallbacks",
    }
    out = {v: 0.0 for v in names.values()}
    out["tier_blocks"] = 0.0
    for _component, dump in states:
        for metric, field in names.items():
            st = dump.get(metric) or {}
            out[field] += sum((st.get("series") or {}).values())
        st = dump.get("dyn_kv_tier_blocks") or {}
        out["tier_blocks"] += sum((st.get("series") or {}).values())
    return out


def transfer_totals(states) -> Dict[str, Any]:
    """Fleet-summed KV-movement plane: bytes moved, streamed-ingest
    counters, h2d-prefetch hit/stall counters, and the per-(src,dst)
    bandwidth gauge folded to (pairs, min, max) — the ``transfer:``
    line's numbers. All-zero when nothing has moved (line not
    rendered)."""
    names = {
        "dyn_kv_stream_ingests_total": "stream_ingests",
        "dyn_kv_stream_fallbacks_total": "stream_fallbacks",
        "dyn_prefetch_h2d_hits_total": "prefetch_hits",
        "dyn_prefetch_h2d_stalls_total": "prefetch_stalls",
    }
    out: Dict[str, Any] = {v: 0.0 for v in names.values()}
    out["bytes"] = 0.0
    bws: List[float] = []
    for _component, dump in states:
        for metric, field in names.items():
            st = dump.get(metric) or {}
            out[field] += sum((st.get("series") or {}).values())
        # every transfer is counted by BOTH ends (send+recv pairs): sum
        # only the receive-side directions so moved= reports each byte
        # once
        st = dump.get("llm_kv_transfer_bytes_total") or {}
        for skey, val in (st.get("series") or {}).items():
            if skey in ("recv", "cluster_recv"):
                out["bytes"] += val
        st = dump.get("llm_kv_pair_bw_bytes_per_s") or {}
        bws.extend(v for v in (st.get("series") or {}).values() if v > 0)
    out["pairs"] = float(len(bws))
    out["bw_min"] = min(bws) if bws else 0.0
    out["bw_max"] = max(bws) if bws else 0.0
    return out


def kvpage_totals(states) -> Dict[str, float]:
    """Fleet-summed KV-paging counters + resident bytes by tier — the
    ``paging:`` line. All-zero when no engine pages (nothing rendered)."""
    names = {
        "dyn_kvpage_demotions_total": "demotions",
        "dyn_kvpage_pageins_total": "pageins",
        "dyn_kvpage_faults_total": "faults",
    }
    out = {v: 0.0 for v in names.values()}
    out["device_bytes"] = 0.0
    out["host_bytes"] = 0.0
    for _component, dump in states:
        for metric, field in names.items():
            st = dump.get(metric) or {}
            out[field] += sum((st.get("series") or {}).values())
        st = dump.get("dyn_kvpage_resident_bytes") or {}
        for skey, val in (st.get("series") or {}).items():
            tier = skey.split("\x1f")[0] if skey else "?"
            key = "device_bytes" if tier == "device" else "host_bytes"
            out[key] += val
    return out


def _compile_totals(states) -> Dict[str, Tuple[float, float]]:
    """{kind: (programs, seconds)} summed across every published dump."""
    progs: Dict[str, float] = {}
    secs: Dict[str, float] = {}
    for _component, dump in states:
        for name, acc in (("dyn_compiled_programs", progs),
                          ("dyn_compile_seconds_total", secs)):
            st = dump.get(name)
            if not st or st.get("kind") != "counter":
                continue
            for skey, val in st.get("series", {}).items():
                kind = skey.split("\x1f")[0] if skey else "?"
                acc[kind] = acc.get(kind, 0.0) + val
    return {k: (progs.get(k, 0.0), secs.get(k, 0.0))
            for k in sorted(set(progs) | set(secs))}


# ---------------------------------------------------------------------------
# rendering (pure; unit-tested)
# ---------------------------------------------------------------------------
def _fmt(v: Optional[float], spec: str = "5.3f", na: str = "    -") -> str:
    return na if v is None else format(v, spec)


def _fmt_ms(v: Optional[float]) -> str:
    if v is None:
        return "-"
    if v == float("inf"):
        return ">tail"
    return f"{v * 1e3:.1f}ms"


def render(snap: Dict, store_detail: bool = False) -> str:
    lines: List[str] = []
    hdr = (f"dyntop — ns={snap['namespace']}  "
           f"ttft_p90={_fmt(snap.get('ttft_p90'))}s  "
           f"itl_p90={_fmt(snap.get('itl_p90'))}s  "
           f"prefill_q={snap.get('prefill_queue', 0)}")
    lines.append(hdr)
    st = snap.get("store")
    if st:
        # hot family + p99 from the last refresh window when available
        # (lifetime-cumulative counts barely move during an incident);
        # the --store-detail table below stays lifetime-cumulative
        fams = st.get("families_window") or st.get("families") or {}
        hot = max(fams, key=lambda f: fams[f]["ops"]) if fams else None
        rate = st.get("op_rate")
        rate_s = f"{rate:.0f}/s" if rate is not None \
            else f"{int(st['ops_total'])} ops"
        fan = st.get("fanout_rate")
        fan_s = f"{fan:.0f}/s" if fan is not None \
            else f"{int(st['fanout_total'])}"
        drops = int(st.get("drops", 0) + st.get("span_drops", 0))
        lines.append(
            f"store: ops={rate_s}"
            + (f"  p99[{hot}]={_fmt_ms(fams[hot]['p99_s'])}" if hot else "")
            + f"  watches={int(st['watches'])}"
            f"  leases={int(st['leases'])}  conns={int(st['conns'])}"
            f"  fanout={fan_s}  drops={drops}"
            f"  sampled_out={int(st.get('spans_sampled_out', 0))}")
        if store_detail:
            shard_of = snap.get("shard_of_family") or {}
            shard_col = bool(snap.get("store_shards"))
            hdr = (f"  {'family':<16} {'ops':>9} {'p99':>8} {'keys':>7} "
                   f"{'MiB':>8} {'qdepth':>6}")
            lines.append(hdr + (f" {'shard':>6}" if shard_col else ""))
            life = st.get("families") or {}   # lifetime totals here
            gauges = st.get("family_gauges") or {}
            for fam in sorted(set(life) | set(gauges)):
                f_ops = life.get(fam, {})
                g = gauges.get(fam, {})
                row = (
                    f"  {fam:<16} {int(f_ops.get('ops', 0)):>9} "
                    f"{_fmt_ms(f_ops.get('p99_s')):>8} "
                    f"{int(g.get('keys', 0)):>7} "
                    f"{g.get('bytes', 0) / 2**20:>8.2f} "
                    f"{int(g.get('queue_depth', 0)):>6}")
                if shard_col:
                    row += f" {shard_of.get(fam, 's0'):>6}"
                lines.append(row)
    shards = snap.get("store_shards")
    if shards and (store_detail or st is None):
        # per-shard store summary: each dynstore's own self-telemetry
        for name in sorted(shards):
            sd = shards[name]
            if sd is None:
                lines.append(f"  shard {name}: UNREACHABLE")
                continue
            fams = sd.get("families") or {}
            hot = max(fams, key=lambda f: fams[f]["ops"]) if fams else None
            lines.append(
                f"  shard {name}: ops={int(sd.get('ops_total', 0))}"
                + (f"  p99[{hot}]={_fmt_ms(fams[hot]['p99_s'])}"
                   if hot else "")
                + f"  keys={int(sd.get('keys_total', 0))}"
                f"  watches={int(sd.get('watches', 0))}"
                f"  leases={int(sd.get('leases', 0))}"
                f"  conns={int(sd.get('conns', 0))}")
    rg = snap.get("regions")
    if rg:
        lines.append(
            f"regions: aggs={rg.get('aggregators', 0)}"
            + (f"(+{rg['stale']} stale)" if rg.get("stale") else "")
            + f"  workers={rg.get('workers', 0)} "
            f"({rg.get('workers_min', 0)}..{rg.get('workers_max', 0)}"
            f"/region)  merge_p50={_fmt_ms(rg.get('merge_p50_s'))} "
            f"p99={_fmt_ms(rg.get('merge_p99_s'))}  "
            f"age_max={rg.get('age_max_s', 0.0):.1f}s")
    fleet = snap.get("fleet") or {}
    if fleet:
        lines.append("fleet:")
        lines.append(
            f"  {'model':<20} {'comp':<18} {'state':<11} {'repl':>9} "
            f"{'chips':>5} {'prio':>4} {'burn':>6} {'unsrv':>5} "
            f"{'wake':>10}")
        for name in sorted(fleet):
            f = fleet[name]
            repl = (f"{f.get('replicas', '?')}->{f.get('target', '?')}"
                    if f.get("target") is not None
                    else str(f.get("replicas", "?")))
            # last wake path (model mobility): swap = in-place weight
            # swap (seconds-scale), cold = full boot
            wake = "-"
            if f.get("wake_path"):
                secs = f.get("wake_seconds")
                wake = (f"{f['wake_path']}/{secs:.1f}s"
                        if isinstance(secs, (int, float))
                        else str(f["wake_path"]))
            lines.append(
                f"  {name:<20} {f.get('component', '?'):<18} "
                f"{f.get('state', '?'):<11} {repl:>9} "
                f"{f.get('chips', 0):>5} {f.get('priority', 0):>4} "
                f"{float(f.get('burn') or 0.0):>6.2f} "
                f"{int(f.get('unserved') or 0):>5} {wake:>10}")
    cl = snap.get("cluster") or {}
    if any(cl.values()):
        th, tm = cl.get("tier_hits", 0), cl.get("tier_misses", 0)
        hit_pct = 100.0 * th / (th + tm) if (th + tm) else 0.0
        lines.append(
            f"cluster: tier_blocks={int(cl.get('tier_blocks', 0))}  "
            f"tier_hit%={hit_pct:.1f}  "
            f"peer_hits={int(cl.get('hits', 0))}  "
            f"fetches={int(cl.get('fetches', 0))}  "
            f"fallbacks={int(cl.get('fallbacks', 0))}")
    # links: the byte-flow ledger's top-talker matrix. The summary line
    # absorbs the old transfer: line's counters; per-link rows render
    # only when workers actually publish flows (older workers without a
    # ledger degrade to the summary alone — absent entirely when nothing
    # has moved, never a crash).
    tr = snap.get("transfer") or {}
    links = snap.get("links") or []
    if any(tr.values()) or links:
        line = (f"links: moved={tr.get('bytes', 0.0) / 1e6:.0f}MB  "
                f"streamed={int(tr.get('stream_ingests', 0))}  "
                f"stream_fallbacks={int(tr.get('stream_fallbacks', 0))}  "
                f"prefetch_hits={int(tr.get('prefetch_hits', 0))}  "
                f"stalls={int(tr.get('prefetch_stalls', 0))}")
        if tr.get("pairs"):
            line += (f"  pairs={int(tr['pairs'])} "
                     f"bw={tr.get('bw_min', 0.0) / 1e6:.0f}"
                     f"..{tr.get('bw_max', 0.0) / 1e6:.0f}MB/s")
        lines.append(line)
        if links:
            from ..obs.flows import fmt_bytes

            lines.append(
                f"  {'link':<24} {'bytes':>9} {'bw':>10} {'sat':>6} "
                f"kinds")
            for e in links[:6]:
                sat = float(e.get("saturation") or 0.0)
                flag = "!" if e.get("congested") else ""
                kinds = ",".join(sorted(
                    e.get("kinds") or {},
                    key=lambda k: -e["kinds"][k])[:3])
                lines.append(
                    f"  {e['src'] + '>' + e['dst']:<24} "
                    f"{fmt_bytes(float(e.get('bytes') or 0)):>9} "
                    f"{float(e.get('bw') or 0.0) / 1e6:>8.1f}MB "
                    f"{sat:>5.2f}{flag:<1} {kinds}")
    pg = snap.get("paging") or {}
    if any(pg.values()):
        lines.append(
            f"paging: demoted={int(pg.get('demotions', 0))}  "
            f"pageins={int(pg.get('pageins', 0))}  "
            f"faults={int(pg.get('faults', 0))}  "
            f"resident={pg.get('device_bytes', 0.0) / 1e6:.0f}MB dev / "
            f"{pg.get('host_bytes', 0.0) / 1e6:.0f}MB host")
    comps = snap.get("compiles") or {}
    if comps:
        lines.append("compiles: " + "  ".join(
            f"{k}={int(n)} ({s:.1f}s)" for k, (n, s) in comps.items()))
    for slo, per_w in (snap.get("slo_burn") or {}).items():
        burns = "  ".join(f"{int(w)}s={b:.2f}" for w, b in
                          sorted(per_w.items()))
        worst = max(per_w.values()) if per_w else 0.0
        flag = "  BREACH" if worst > 1.0 else ""
        lines.append(f"slo {slo}: burn {burns}{flag}")
    ov = snap.get("overload") or {}
    if any(ov.get(k) for k in ("brownout", "shed_total",
                               "admission_depth")):
        from ..utils.overload import LEVEL_NAMES

        lvl = int(ov.get("brownout", 0))
        lines.append(
            f"overload: brownout=L{lvl} ({LEVEL_NAMES.get(lvl, '?')})  "
            f"shed={int(ov.get('shed_total', 0))}  "
            f"admit_q={int(ov.get('admission_depth', 0))}")
    inc = snap.get("incidents") or []
    if inc:
        latest = inc[0]           # list_incidents sorts newest first
        age = time.time() - latest.get("at", 0.0)
        lines.append(
            f"incidents: {len(inc)} live  latest={latest.get('id', '?')} "
            f"({latest.get('reason', '?')}, {age:.0f}s ago)  "
            f"-> ctl incident show {latest.get('id', '?')}")
    lines.append(
        f"{'worker':>10} {'comp':<9} {'slots':>7} {'kv%':>5} {'hit%':>5} "
        f"{'mfu%':>6} {'mbu%':>6} {'GB/s':>7} {'spec%':>6} {'brk':>4}")
    open_set = snap.get("breaker_open") or set()
    n = 0
    for comp, workers in sorted((snap.get("workers") or {}).items()):
        for wid, m in sorted(workers.items()):
            n += 1
            kv = (100.0 * m.kv_active_blocks / m.kv_total_blocks
                  if m.kv_total_blocks else 0.0)
            brk = "OPEN" if f"{wid:x}" in open_set else "ok"
            lines.append(
                f"{wid:>10x} {comp:<9} "
                f"{int(m.request_active_slots):>3}/{int(m.request_total_slots):<3} "
                f"{kv:>5.1f} {100.0 * m.gpu_prefix_cache_hit_rate:>5.1f} "
                f"{100.0 * m.mfu:>6.2f} {100.0 * m.mbu:>6.2f} "
                f"{m.hbm_gbps:>7.2f} {100.0 * m.spec_accept_rate:>6.1f} "
                f"{brk:>4}")
    if not n:
        lines.append("(no live workers publishing metrics)")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------
async def run_once(args) -> str:
    from ..runtime.scale.shards import make_store_client

    host, port = args.store.split(":")
    store = make_store_client(host, int(port))
    await store.connect()
    try:
        snap = await ClusterSnapshotter(
            store, args.namespace,
            args.component or ["backend", "prefill"]).collect()
        return render(snap, args.store_detail)
    finally:
        await store.close()


async def _loop_plain(args) -> None:
    from ..runtime.scale.shards import make_store_client

    host, port = args.store.split(":")
    store = make_store_client(host, int(port))
    await store.connect()
    snapper = ClusterSnapshotter(store, args.namespace,
                                 args.component or ["backend", "prefill"])
    try:
        while True:
            text = render(await snapper.collect(), args.store_detail)
            if sys.stdout.isatty():
                sys.stdout.write("\x1b[H\x1b[2J")   # home + clear
            sys.stdout.write(text + "\n")
            sys.stdout.flush()
            await asyncio.sleep(args.interval)
    finally:
        await store.close()


async def _loop_curses(args) -> None:
    import curses

    from ..runtime.scale.shards import make_store_client

    host, port = args.store.split(":")
    store = make_store_client(host, int(port))
    await store.connect()
    snapper = ClusterSnapshotter(store, args.namespace,
                                 args.component or ["backend", "prefill"])
    scr = curses.initscr()
    curses.noecho()
    curses.cbreak()
    scr.nodelay(True)
    try:
        while True:
            text = render(await snapper.collect(), args.store_detail)
            scr.erase()
            maxy, maxx = scr.getmaxyx()
            for i, line in enumerate(text.splitlines()[:maxy - 1]):
                scr.addnstr(i, 0, line, maxx - 1)
            scr.refresh()
            if scr.getch() in (ord("q"), 27):   # q / ESC
                return
            await asyncio.sleep(args.interval)
    finally:
        curses.nocbreak()
        curses.echo()
        curses.endwin()
        await store.close()


def main() -> None:
    from ..utils.logging_ext import init_logging

    init_logging()
    args = parse_args()
    try:
        if args.once:
            print(asyncio.run(run_once(args)))
        elif args.plain or not sys.stdout.isatty():
            asyncio.run(_loop_plain(args))
        else:
            try:
                asyncio.run(_loop_curses(args))
            except Exception as e:
                # a terminal curses can't drive falls back to plain
                print(f"(curses UI unavailable: {e!r}; plain mode)",
                      file=sys.stderr)
                asyncio.run(_loop_plain(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
