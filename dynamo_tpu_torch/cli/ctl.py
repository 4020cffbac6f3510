"""llmctl equivalent: manage model -> endpoint registrations in the store.

    python -m dynamo_tpu_torch.cli.ctl --store 127.0.0.1:4222 http add chat \
        my-model dynamo.backend.generate [--model-path ...]
    python -m dynamo_tpu_torch.cli.ctl http list
    python -m dynamo_tpu_torch.cli.ctl http remove chat my-model
    python -m dynamo_tpu_torch.cli.ctl disagg set --namespace dynamo \
        --max-local-prefill-length 1000 --max-prefill-queue-size 2

The records it writes are the JAX ``ctl``'s, byte for byte, for the same
flags (either package's workers, frontends and planners read them), with
one default of its own: ``fleet add --engine`` is ``torch`` (the port's
planner serves a JAX record's ``jax`` on the torch worker too,
``fleet/registry.worker_engine``).

Reference capability: launch/llmctl (http add/list/remove model mappings)
plus live disagg-threshold reconfiguration (the reference's etcd-watched
DisaggregatedRouter config, lib/llm/src/disagg_router.rs:38-143).
"""

from __future__ import annotations

import asyncio
import json
import time

from ..llm.model_card import ModelDeploymentCard
from ..llm.remote import list_models, register_model, unregister_model
from ..runtime.scale.shards import make_store_client
from ..utils.dynconfig import EnvDefaultsParser


def parse_args(argv=None):
    p = EnvDefaultsParser(prog="dynamo-ctl")
    p.add_argument("--store", default="127.0.0.1:4222")
    sub = p.add_subparsers(dest="plane", required=True)
    http = sub.add_parser("http")
    hsub = http.add_subparsers(dest="action", required=True)

    add = hsub.add_parser("add")
    add.add_argument("model_type", choices=("chat", "completion", "both"))
    add.add_argument("name")
    add.add_argument("endpoint", help="ns.component.endpoint")
    add.add_argument("--model-path", default=None)
    add.add_argument("--kv-block-size", type=int, default=64)

    rem = hsub.add_parser("remove")
    rem.add_argument("model_type", choices=("chat", "completion", "both"))
    rem.add_argument("name")

    hsub.add_parser("list")

    disagg = sub.add_parser("disagg")
    dsub = disagg.add_subparsers(dest="action", required=True)
    dset = dsub.add_parser("set")
    dset.add_argument("--namespace", default="dynamo")
    dset.add_argument("--model", default="default")
    dset.add_argument("--max-local-prefill-length", type=int, default=1000)
    dset.add_argument("--max-prefill-queue-size", type=int, default=2)
    dget = dsub.add_parser("get")
    dget.add_argument("--namespace", default="dynamo")
    dget.add_argument("--model", default="default")

    # fleet plane: the desired-state model registry (fleet_models/)
    fleet = sub.add_parser("fleet")
    fsub = fleet.add_subparsers(dest="action", required=True)
    fadd = fsub.add_parser("add")
    fadd.add_argument("name")
    fadd.add_argument("--namespace", default="dynamo")
    fadd.add_argument("--component", default=None,
                      help="worker component for this model's pool "
                           "(default: backend-<name>)")
    fadd.add_argument("--engine", default="torch",
                      help="worker engine: torch | echo")
    fadd.add_argument("--model-path", default=None)
    fadd.add_argument("--chips", type=int, default=1,
                      help="chips per replica (0 = exempt from the "
                           "global chip budget)")
    fadd.add_argument("--min-replicas", type=int, default=0,
                      help="replica floor (0 allows scale-to-zero)")
    fadd.add_argument("--max-replicas", type=int, default=4)
    fadd.add_argument("--priority", type=int, default=0,
                      help="arbitration rank: higher takes chips first")
    fadd.add_argument("--tenant", action="append", default=[],
                      metavar="TENANT:rps=R,burst=B,concurrency=C",
                      help="per-tenant quota entry (repeatable), e.g. "
                           "--tenant acme:rps=5,burst=10,concurrency=8")
    fadd.add_argument("--worker-args", default="",
                      help="extra args for spawned workers, "
                           "space-separated")
    fadd.add_argument("--swap-group", default="",
                      help="model-mobility swap class: models sharing a "
                           "group hot-swap into each other on preemption "
                           "(in-place weight swap, no cold spawn)")
    fadd.add_argument("--prewarm", action="store_true",
                      help="every worker in the namespace stages this "
                           "model's weights into its host cache (wake "
                           "by swap even across swap groups)")
    frem = fsub.add_parser("remove")
    frem.add_argument("name")
    frem.add_argument("--namespace", default="dynamo")
    flist = fsub.add_parser("list")
    flist.add_argument("--namespace", default="dynamo")

    # incident plane: flight-recorder capture beacons + assembled bundles
    inc = sub.add_parser("incident")
    isub = inc.add_subparsers(dest="action", required=True)
    icap = isub.add_parser("capture",
                           help="publish a manual capture beacon: every "
                                "live process dumps its rings")
    icap.add_argument("--namespace", default="dynamo")
    icap.add_argument("--reason", default="manual")
    icap.add_argument("--trace-id", default=None,
                      help="retro-assemble this trace into the bundle "
                           "(sampled-out spans included)")
    icap.add_argument("--window", type=float, default=30.0,
                      help="seconds of ring history before now to freeze")
    ils = isub.add_parser("ls")
    ils.add_argument("--namespace", default="dynamo")
    ishow = isub.add_parser("show")
    ishow.add_argument("incident_id")
    ishow.add_argument("--namespace", default="dynamo")
    iexp = isub.add_parser("export")
    iexp.add_argument("incident_id")
    iexp.add_argument("--namespace", default="dynamo")
    iexp.add_argument("-o", "--out", default=None,
                      help="output file (default <incident_id>.json); "
                           "feed to `tracectl --bundle`")

    # byte-flow ledger: the per-link matrix every worker publishes
    fl = sub.add_parser("flows",
                        help="cluster byte-flow ledger: per-link bytes, "
                             "bandwidth and saturation, hottest first")
    fl.add_argument("--namespace", default="dynamo")
    fl.add_argument("--limit", type=int, default=0,
                    help="show at most N links (0 = all)")
    fl.add_argument("--kind", default=None,
                    help="only links that moved this flow kind "
                         "(e.g. disagg_push, kvpage_pagein)")
    fl.add_argument("--json", action="store_true", dest="as_json",
                    help="raw JSON instead of the table")
    return p.parse_args(argv)


def parse_tenant_quota(entry: str):
    """``acme:rps=5,burst=10,concurrency=8`` -> ("acme", TenantQuota)."""
    from ..utils.overload import TenantQuota

    tenant, _, rest = entry.partition(":")
    if not tenant or not rest:
        raise SystemExit(f"--tenant {entry!r}: expected "
                         f"TENANT:rps=R[,burst=B][,concurrency=C]")
    fields = {}
    for part in rest.split(","):
        key, _, val = part.partition("=")
        if key not in ("rps", "burst", "concurrency") or not val:
            raise SystemExit(f"--tenant {entry!r}: unknown field {part!r}")
        try:
            fields[key] = float(val)
        except ValueError:
            raise SystemExit(f"--tenant {entry!r}: {key}={val!r} is not "
                             f"a number")
    return tenant, TenantQuota(
        rps=fields.get("rps", 0.0), burst=fields.get("burst", 0.0),
        concurrency=int(fields.get("concurrency", 0)))


async def run(args) -> int:
    host, port = args.store.split(":")
    store = await make_store_client(host, int(port)).connect()
    try:
        if args.plane == "incident":
            return await run_incident(store, args)
        if args.plane == "flows":
            return await run_flows(store, args)
        if args.plane == "fleet":
            from ..fleet.registry import (FleetModelSpec, fetch_fleet_status,
                                          list_fleet_models,
                                          put_fleet_model,
                                          remove_fleet_model)

            if args.action == "add":
                card = None
                if args.model_path:
                    card = ModelDeploymentCard.resolve(
                        args.model_path, args.name).to_dict()
                spec = FleetModelSpec(
                    name=args.name, component=args.component or "",
                    engine=args.engine, model_path=args.model_path,
                    chips_per_replica=args.chips,
                    min_replicas=args.min_replicas,
                    max_replicas=args.max_replicas,
                    priority=args.priority,
                    tenants=dict(parse_tenant_quota(t)
                                 for t in args.tenant),
                    card=card,
                    extra_args=[a for a in args.worker_args.split() if a],
                    swap_group=args.swap_group, prewarm=args.prewarm)
                await put_fleet_model(store, args.namespace, spec)
                print(f"fleet add {args.name}: component="
                      f"{spec.component} chips/replica={spec.chips_per_replica} "
                      f"replicas=[{spec.min_replicas},{spec.max_replicas}] "
                      f"priority={spec.priority} "
                      f"tenants={sorted(spec.tenants) or '-'}"
                      + (f" swap_group={spec.swap_group}"
                         if spec.swap_group else "")
                      + (" prewarm" if spec.prewarm else ""))
            elif args.action == "remove":
                await remove_fleet_model(store, args.namespace, args.name)
                print(f"fleet remove {args.name}: the planner drains its "
                      f"pool on the next tick")
            elif args.action == "list":
                specs = await list_fleet_models(store, args.namespace)
                status = await fetch_fleet_status(store, args.namespace)
                if not specs:
                    print(f"(no fleet models registered in "
                          f"{args.namespace!r})")
                for s in specs:
                    st = status.get(s.name, {})
                    wake = ""
                    if st.get("wake_path"):
                        wake = (f" wake={st['wake_path']}"
                                f"/{st.get('wake_seconds', '?')}s")
                    print(f"{s.name:<24} {s.component:<20} "
                          f"state={st.get('state', 'unreconciled'):<10} "
                          f"replicas={st.get('replicas', '?')}/"
                          f"[{s.min_replicas},{s.max_replicas}] "
                          f"chips={st.get('chips', '?')} "
                          f"prio={s.priority} "
                          f"burn={st.get('burn', '?')} "
                          f"tenants={sorted(s.tenants) or '-'}"
                          + (f" group={s.swap_group}"
                             if s.swap_group else "") + wake)
            return 0
        if args.plane == "disagg":
            from ..llm.disagg import (DisaggConfig, disagg_config_key,
                                      set_disagg_config)

            if args.action == "set":
                cfg = DisaggConfig(
                    max_local_prefill_length=args.max_local_prefill_length,
                    max_prefill_queue_size=args.max_prefill_queue_size)
                await set_disagg_config(store, args.namespace, cfg,
                                        model=args.model)
                print(f"disagg config for {args.namespace}/{args.model}: "
                      f"{cfg.to_dict()}")
            else:
                raw = await store.get(
                    disagg_config_key(args.namespace, args.model))
                print(raw.decode() if raw else "(not set)")
            return 0
        if args.action == "add":
            if args.model_path:
                card = ModelDeploymentCard.resolve(args.model_path, args.name)
            else:
                card = ModelDeploymentCard.synthetic(args.name)
            card.kv_block_size = args.kv_block_size
            types = (["chat", "completion"] if args.model_type == "both"
                     else [args.model_type])
            for t in types:
                await register_model(store, card, args.endpoint, model_type=t)
            print(f"added {args.name} -> {args.endpoint} ({','.join(types)})")
        elif args.action == "remove":
            types = (["chat", "completion"] if args.model_type == "both"
                     else [args.model_type])
            for t in types:
                await unregister_model(store, args.name, model_type=t)
            print(f"removed {args.name}")
        elif args.action == "list":
            for m in await list_models(store):
                inst = (f"  x{m['instances']}"
                        if m.get("instances", 1) > 1 else "")
                print(f"{m['type']:<11} {m['name']:<30} {m['endpoint']}"
                      f"{inst}")
        return 0
    finally:
        await store.close()


async def run_flows(store, args) -> int:
    """Fold every worker's published stage dump into the cluster's
    per-link byte-flow matrix — the same data `dyntop` renders as
    ``links:`` and the frontend serves at ``GET /v1/flows``."""
    from ..llm.metrics_aggregator import fetch_stage_states
    from ..obs.flows import flows_from_states, fmt_bytes

    states = await fetch_stage_states(store, args.namespace)
    links = flows_from_states(states)
    if args.kind:
        links = [e for e in links if args.kind in (e.get("kinds") or {})]
    if args.limit > 0:
        links = links[:args.limit]
    if args.as_json:
        print(json.dumps({"links": links, "count": len(links)},
                         indent=1, sort_keys=True))
        return 0
    if not links:
        print(f"(no flows published in {args.namespace!r})")
        return 0
    print(f"{'link':<28} {'bytes':>10} {'bw':>12} {'sat':>6} "
          f"{'cong':>5}  kinds")
    for e in links:
        kinds = " ".join(
            f"{k}={fmt_bytes(v)}" for k, v in sorted(
                (e.get("kinds") or {}).items(), key=lambda kv: -kv[1]))
        print(f"{e['src'] + '>' + e['dst']:<28} "
              f"{fmt_bytes(float(e.get('bytes') or 0)):>10} "
              f"{float(e.get('bw') or 0.0) / 1e6:>10.1f}MB "
              f"{float(e.get('saturation') or 0.0):>6.2f} "
              f"{int(e.get('congested') or 0):>5}  {kinds}")
    return 0


async def run_incident(store, args) -> int:
    from ..obs import incidents as _incidents

    if args.action == "capture":
        beacon = await _incidents.publish_beacon(
            store, args.namespace, args.reason, window_s=args.window,
            trace_id=args.trace_id, by="ctl")
        print(f"incident {beacon['id']} captured: every live process is "
              f"dumping its rings\n  inspect: ctl incident show "
              f"{beacon['id']}")
        return 0
    if args.action == "ls":
        beacons = await _incidents.list_incidents(store, args.namespace)
        if not beacons:
            print(f"(no live incidents in {args.namespace!r})")
            return 0
        for b in beacons:
            age = time.time() - b.get("at", 0.0)
            tid = b.get("trace_id") or "-"
            print(f"{b['id']:<40} {b['reason']:<16} age={age:>6.0f}s "
                  f"trace={tid}  by={b.get('by', '?')}")
        return 0
    bundle = await _incidents.fetch_bundle(store, args.namespace,
                                           args.incident_id)
    if bundle is None:
        print(f"no incident {args.incident_id!r} (expired or never "
              f"captured)")
        return 1
    if args.action == "show":
        for line in _incidents.bundle_summary(bundle):
            print(line)
        return 0
    # export: the offline bundle tracectl --bundle consumes
    out = args.out or f"{args.incident_id}.json"
    with open(out, "w") as f:
        json.dump(bundle, f, indent=1, sort_keys=True)
    print(f"incident {args.incident_id} -> {out} "
          f"({len(bundle['processes'])} process dumps, "
          f"{len(bundle['trace'])} trace spans)")
    return 0


def main() -> None:
    raise SystemExit(asyncio.run(run(parse_args())))


if __name__ == "__main__":
    main()
