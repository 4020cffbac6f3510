"""Planner binary: the closed-loop prefill/decode autoscaler daemon.

    python -m dynamo_tpu_torch.cli.planner --store 127.0.0.1:4222 \
        --namespace dynamo --decode-component backend \
        [--prefill-component prefill] \
        --policy load|sla --connector local|kube|none \
        [--dry-run] [--profile profile.json --ttft-target 2.0 \
         --itl-target 0.05] [--min-replicas 1 --max-replicas 8]

Every flag resolves its default through ``DYN_PLANNER_<FLAG>`` (the
EnvDefaultsParser layering), so the whole knob surface is env-drivable:
``DYN_PLANNER_DRY_RUN=1``, ``DYN_PLANNER_MAX_REPLICAS=16``, ...

Inspect and steer the running loop with ``python -m
dynamo_tpu_torch.cli.plannerctl`` (status / decisions / override / pause).

The local connector spawns ``python -m dynamo_tpu_torch.cli.worker``
processes on cards granted through ``CUDA_VISIBLE_DEVICES`` (``--platform
cuda``, the default; a torch worker gets one card unless ``--worker-chips``
says otherwise), or on the CPU with ``--device cpu`` (``--platform cpu``,
or a pool of zero cards a worker, as echo workers are by default).
``--connector kube`` needs
the Kubernetes REST adapter, which comes with the deploy slice (ROADMAP
Queue 1 item 12e): it raises until then.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal

from ..planner.connectors import LocalConnector, NullConnector, PoolSpec
from ..planner.loop import Planner, PlannerConfig
from ..planner.policy import LoadPolicy, SlaPolicy
from ..planner.profile import ProfileTable
from ..runtime.component import DistributedRuntime
from ..utils import tracing
from ..utils.dynconfig import EnvDefaultsParser

log = logging.getLogger("dynamo_tpu_torch.planner")


def parse_args(argv=None) -> argparse.Namespace:
    p = EnvDefaultsParser(prog="dynamo-planner")
    p.add_argument("--store", default="127.0.0.1:4222")
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--decode-component", default="backend")
    p.add_argument("--prefill-component", default="",
                   help="component of the prefill pool ('' = decode only)")
    p.add_argument("--policy", choices=("load", "sla"), default="load")
    p.add_argument("--connector", choices=("local", "kube", "none"),
                   default="none")
    p.add_argument("--interval", type=float, default=2.0)
    p.add_argument("--min-replicas", type=int, default=1)
    p.add_argument("--max-replicas", type=int, default=8)
    p.add_argument("--cooldown-up", type=float, default=30.0)
    p.add_argument("--cooldown-down", type=float, default=120.0)
    p.add_argument("--down-consensus", type=int, default=3)
    p.add_argument("--dry-run", action="store_true",
                   help="publish decisions but never actuate")
    p.add_argument("--fleet", action="store_true",
                   help="reconcile the multi-model fleet registry "
                        "(fleet_models/): pool set follows `ctl fleet "
                        "add/remove` live, targets pass through the "
                        "chip arbiter under --total-chips, per-model "
                        "status published to fleet_status/")
    p.add_argument("--brownout", action="store_true",
                   help="run the SLO-burn brownout controller on this "
                        "loop (publishes the fleet degradation level; "
                        "DYN_BROWNOUT_* knobs)")
    # load policy knobs
    p.add_argument("--queue-high", type=float, default=1.0)
    p.add_argument("--occupancy-high", type=float, default=0.85)
    p.add_argument("--occupancy-low", type=float, default=0.3)
    p.add_argument("--kv-high", type=float, default=0.9)
    p.add_argument("--kv-low", type=float, default=0.5)
    # sla policy knobs
    p.add_argument("--profile", default=None,
                   help="profile table JSON (planner.profile sweep output)")
    p.add_argument("--ttft-target", type=float, default=2.0)
    p.add_argument("--itl-target", type=float, default=0.05)
    # local connector knobs
    p.add_argument("--worker-engine", default="torch",
                   choices=("torch", "echo"),
                   help="--engine for spawned workers (torch|echo)")
    p.add_argument("--worker-chips", type=int, default=None,
                   help="cards per spawned decode worker (0 = CPU; "
                        "default 1 for torch workers, 0 for echo)")
    p.add_argument("--prefill-worker-chips", type=int, default=None,
                   help="cards per spawned prefill worker (default 1)")
    p.add_argument("--total-chips", type=int, default=4)
    p.add_argument("--platform", default="cuda", choices=("cpu", "cuda"),
                   help="cuda: grant cards through CUDA_VISIBLE_DEVICES; "
                        "cpu: every spawned worker runs --device cpu")
    p.add_argument("--worker-args", default="",
                   help="extra args appended to spawned workers, "
                        "space-separated")
    # kube connector knobs
    p.add_argument("--kube-url", default=None,
                   help="apiserver base URL ('' = from kubeconfig)")
    p.add_argument("--kube-token", default=None)
    p.add_argument("--kube-insecure", action="store_true")
    p.add_argument("--kube-namespace", default="default")
    p.add_argument("--kube-deployment", default=None,
                   help="DynamoDeployment name to patch")
    p.add_argument("--kube-mode", choices=("crd", "deployment"),
                   default="crd")
    args = p.parse_args(argv)
    # the card unless the caller asks for the CPU: a torch worker needs
    # one, an echo worker none
    if args.worker_chips is None:
        args.worker_chips = 1 if args.worker_engine == "torch" else 0
    if args.prefill_worker_chips is None:
        args.prefill_worker_chips = 1
    return args


def build_policy(args):
    if args.policy == "sla":
        if not args.profile:
            raise SystemExit("--policy sla requires --profile (run "
                             "python -m dynamo_tpu_torch.planner.profile first)")
        table = ProfileTable.load(args.profile)
        return SlaPolicy(table, ttft_target=args.ttft_target,
                         itl_target=args.itl_target)
    return LoadPolicy(queue_high=args.queue_high,
                      occupancy_high=args.occupancy_high,
                      occupancy_low=args.occupancy_low,
                      kv_high=args.kv_high, kv_low=args.kv_low)


def build_connector(args, pools):
    if args.connector == "local":
        extra = [a for a in args.worker_args.split() if a]
        specs = {}
        for pool, component in pools.items():
            if pool == "prefill":
                specs[pool] = PoolSpec(
                    component=component, chips=args.prefill_worker_chips,
                    module="dynamo_tpu_torch.cli.prefill_worker",
                    extra_args=["--decode-component",
                                args.decode_component, *extra])
            else:
                specs[pool] = PoolSpec(component=component,
                                       chips=args.worker_chips,
                                       engine=args.worker_engine,
                                       extra_args=list(extra))
        return LocalConnector(args.store, args.namespace, specs,
                              total_chips=args.total_chips,
                              platform=args.platform)
    if args.connector == "kube":
        if not args.kube_deployment:
            raise SystemExit("--connector kube requires --kube-deployment")
        # the KubeConnector takes any api with RestKubeApi's get/apply
        # surface (tests inject one); the port's REST adapter itself is
        # part of deploy/
        raise NotImplementedError(
            "--connector kube: the Kubernetes REST adapter (deploy/) is "
            "not ported to dynamo_tpu_torch yet (ROADMAP Queue 1 item 12e)")
    return NullConnector()


async def run_planner(args, *, ready_event=None, drt=None) -> None:
    # getattr: harnesses build the Namespace by hand (chaos/soak rigs)
    fleet_mode = getattr(args, "fleet", False)
    if fleet_mode:
        # fleet mode: the pool set comes from the model registry, live —
        # starting empty is normal (models `ctl fleet add`-ed later join
        # on the next tick)
        pools = {}
    else:
        pools = {"decode": args.decode_component}
        if args.prefill_component:
            pools["prefill"] = args.prefill_component
    own_drt = drt is None
    if own_drt:
        host, port = args.store.split(":")
        drt = await DistributedRuntime(store_host=host,
                                       store_port=int(port)).connect()
    tracing.configure(component="planner")
    span_sink = await tracing.StoreSpanSink(drt.store).start()
    policy = build_policy(args)
    connector = build_connector(args, pools)
    cfg = PlannerConfig(
        interval=args.interval, min_replicas=args.min_replicas,
        max_replicas=args.max_replicas, cooldown_up=args.cooldown_up,
        cooldown_down=args.cooldown_down,
        down_consensus=args.down_consensus, dry_run=args.dry_run,
        brownout=args.brownout)
    fleet = None
    if fleet_mode:
        from ..fleet import FleetPlane

        fleet = FleetPlane(drt.store, args.namespace,
                           total_chips=args.total_chips)
    planner = await Planner(drt, args.namespace, pools, policy, connector,
                            cfg, fleet=fleet).start()
    mode = "DRY-RUN" if args.dry_run else "live"
    log.info("planner %s: pools=%s policy=%s connector=%s fleet=%s", mode,
             pools, policy.name, connector.name, bool(fleet))
    print(f"planner serving ({mode}, policy={policy.name}, "
          f"connector={connector.name}, "
          f"pools={'<fleet registry>' if fleet else pools})", flush=True)
    if ready_event is not None:
        ready_event.set()
    try:
        while True:
            await asyncio.sleep(3600)
    finally:
        await planner.stop()
        try:
            await span_sink.stop()
        except Exception:  # noqa: BLE001 - teardown best-effort
            pass
        if own_drt:
            await drt.close()


def main() -> None:
    from ..utils.logging_ext import init_logging

    init_logging()
    args = parse_args()

    async def amain():
        # SIGTERM (an orchestrator's stop) leaves through the same path
        # as Ctrl-C: run_planner's finally drains the workers this
        # planner spawned instead of leaving them serving (the JAX CLI
        # dies on SIGTERM with its workers still running)
        asyncio.get_running_loop().add_signal_handler(
            signal.SIGTERM, asyncio.current_task().cancel)
        await run_planner(args)

    try:
        asyncio.run(amain())
    except (KeyboardInterrupt, asyncio.CancelledError):
        pass


if __name__ == "__main__":
    main()
