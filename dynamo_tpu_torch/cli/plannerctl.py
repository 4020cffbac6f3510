"""plannerctl: inspect and steer the running planner through the store.

    python -m dynamo_tpu_torch.cli.plannerctl --store 127.0.0.1:4222 status
    python -m dynamo_tpu_torch.cli.plannerctl decisions [--tail 20]
    python -m dynamo_tpu_torch.cli.plannerctl override decode 4
    python -m dynamo_tpu_torch.cli.plannerctl clear [decode]
    python -m dynamo_tpu_torch.cli.plannerctl pause|resume

Overrides and pause are one JSON document at ``planner/{ns}/override``
(``{"paused": bool, "pools": {pool: replicas}}``) that the planner loop
watches live; ``status`` reads the lease-bound ``planner/{ns}/state`` key
(absent => no planner alive for that namespace).
"""

from __future__ import annotations

import asyncio
import json
import time

from ..planner.loop import decisions_prefix, override_key, state_key
from ..runtime.scale.shards import make_store_client
from ..utils.dynconfig import EnvDefaultsParser


def parse_args(argv=None):
    p = EnvDefaultsParser(prog="dynamo-plannerctl")
    p.add_argument("--store", default="127.0.0.1:4222")
    p.add_argument("--namespace", default="dynamo")
    sub = p.add_subparsers(dest="action", required=True)
    sub.add_parser("status")
    dec = sub.add_parser("decisions")
    dec.add_argument("--tail", type=int, default=20)
    ov = sub.add_parser("override")
    ov.add_argument("pool")
    ov.add_argument("replicas", type=int)
    cl = sub.add_parser("clear")
    cl.add_argument("pool", nargs="?", default=None,
                    help="pool to clear (default: every override)")
    sub.add_parser("pause")
    sub.add_parser("resume")
    return p.parse_args(argv)


async def _load_override(store, ns: str) -> dict:
    raw = await store.get(override_key(ns))
    if not raw:
        return {"paused": False, "pools": {}}
    try:
        d = json.loads(raw.decode())
        return {"paused": bool(d.get("paused")),
                "pools": dict(d.get("pools") or {})}
    except (ValueError, json.JSONDecodeError):
        return {"paused": False, "pools": {}}


async def run(args) -> int:
    host, port = args.store.split(":")
    store = await make_store_client(host, int(port)).connect()
    ns = args.namespace
    try:
        if args.action == "status":
            raw = await store.get(state_key(ns))
            if not raw:
                print(f"no live planner for namespace {ns!r} "
                      f"(state key absent)")
                return 1
            st = json.loads(raw.decode())
            age = time.time() - st.get("ts", 0)
            mode = "DRY-RUN" if st.get("dry_run") else "live"
            flags = [mode, f"policy={st.get('policy')}",
                     f"connector={st.get('connector')}",
                     f"clamps={st.get('clamps')}",
                     f"signals={st.get('signal_source', 'flat')}"]
            if st.get("fleet"):
                flags.append("FLEET")
            if st.get("paused"):
                flags.append("PAUSED")
            print(f"planner[{ns}] {' '.join(flags)} "
                  f"(state {age:.1f}s old)")
            # fleet mode: per-model status records carry what the state
            # doc cannot (target, lifecycle state, chips)
            fstatus = {}
            if st.get("fleet"):
                from ..fleet.registry import fetch_fleet_status

                fstatus = await fetch_fleet_status(store, ns)
            for pool, d in sorted((st.get("pools") or {}).items()):
                ov = (st.get("overrides") or {}).get(pool)
                fs = fstatus.get(pool, {})
                fleet_cols = ""
                if fs:
                    fleet_cols = (f" state={fs.get('state')} "
                                  f"target={fs.get('target')} "
                                  f"chips={fs.get('chips')}")
                print(f"  {pool:<8} component={d.get('component')} "
                      f"replicas={d.get('replicas')} "
                      f"occupancy={d.get('occupancy')} "
                      f"queue={d.get('queue_depth')} "
                      f"kv={d.get('kv_utilization')} "
                      f"burn={d.get('slo_burn')} "
                      f"breaker_open={d.get('breaker_open')}"
                      + fleet_cols
                      + (f" OVERRIDE->{ov}" if ov is not None else ""))
            return 0
        if args.action == "decisions":
            items = await store.get_prefix(decisions_prefix(ns))
            items.sort(key=lambda kv: kv[0])
            for _key, value in items[-args.tail:]:
                try:
                    d = json.loads(value.decode())
                except (ValueError, json.JSONDecodeError):
                    continue
                sup = f" [{d['suppressed']}]" if d.get("suppressed") else ""
                dr = " (dry-run)" if d.get("dry_run") else ""
                print(f"#{d.get('seq'):>6} {d.get('pool'):<8} "
                      f"{d.get('action'):<10} {d.get('current')}->"
                      f"{d.get('target')}{sup}{dr}  {d.get('reason')}")
            return 0
        # mutations: read-modify-write the one override document
        ov = await _load_override(store, ns)
        if args.action == "override":
            ov["pools"][args.pool] = args.replicas
            print(f"override: {args.pool} -> {args.replicas} replicas")
        elif args.action == "clear":
            if args.pool is None:
                ov["pools"] = {}
                print("cleared every pool override")
            else:
                ov["pools"].pop(args.pool, None)
                print(f"cleared override for {args.pool}")
        elif args.action == "pause":
            ov["paused"] = True
            print("planner paused (decisions hold until resume)")
        elif args.action == "resume":
            ov["paused"] = False
            print("planner resumed")
        await store.put(override_key(ns), json.dumps(ov).encode())
        return 0
    finally:
        await store.close()


def main() -> None:
    raise SystemExit(asyncio.run(run(parse_args())))


if __name__ == "__main__":
    main()
