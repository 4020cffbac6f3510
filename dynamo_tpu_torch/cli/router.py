"""Standalone KV-aware router service.

    python -m dynamo_tpu_torch.cli.router --namespace dynamo --worker-component \
        backend --store 127.0.0.1:4222

Serves ``route`` on {namespace}/router: {token_ids} -> {worker_id}. With
``--fleet`` one router serves every model of the fleet registry
(``fleet_models/``), dispatching on the request's ``model`` field.
Reference capability: components/router/src/main.rs.
"""

from __future__ import annotations

import asyncio
import logging

from ..llm.kv_router.router import FleetKvRouter, KvRouterService
from ..runtime.component import DistributedRuntime
from ..utils.dynconfig import EnvDefaultsParser

log = logging.getLogger("dynamo_tpu_torch.router")


def parse_args(argv=None):
    p = EnvDefaultsParser(prog="dynamo-router")
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--component", default="router")
    p.add_argument("--worker-component", default="backend")
    p.add_argument("--store", default="127.0.0.1:4222")
    p.add_argument("--advertise-host", default=None)
    p.add_argument("--block-size", type=int, default=64)
    p.add_argument("--fleet", action="store_true",
                   help="route for every model in the fleet registry "
                        "(fleet_models/) instead of one worker "
                        "component; requests dispatch on their 'model' "
                        "field with per-model candidate sets")
    return p.parse_args(argv)


async def run_router(args, *, ready_event=None,
                     drt: DistributedRuntime | None = None) -> None:
    host, port = args.store.split(":")
    own = drt is None
    if own:
        drt = await DistributedRuntime(
            store_host=host, store_port=int(port),
            advertise_host=args.advertise_host).connect()
    # getattr: harnesses build the Namespace by hand
    fleet = getattr(args, "fleet", False)
    if fleet:
        svc = FleetKvRouter(drt, args.namespace,
                            block_size=args.block_size)
    else:
        svc = KvRouterService(drt, args.namespace, args.worker_component,
                              block_size=args.block_size)
    # fleet brownout level: any level above normal switches the scheduler
    # to fast-fail instead of capacity-wait polling (utils/overload.py).
    # Armed BEFORE start so fleet mode hands the shared state to every
    # per-model router it creates.
    from ..utils.overload import BrownoutState

    try:
        svc.brownout = await BrownoutState().watch(drt.store, args.namespace)
    except Exception:
        log.warning("brownout watch failed; router stays in wait mode",
                    exc_info=True)
    # the route handler's rpc span exports to the store like a worker's,
    # so a frontend's /v1/traces/<id> shows where the router spent the
    # request's routing time (the JAX router CLI keeps its spans local)
    from ..utils import tracing

    tracing.configure(component="router")
    span_sink = await tracing.StoreSpanSink(drt.store).start()
    await svc.start()
    await svc.serve(drt.namespace(args.namespace).component(args.component))
    # flight recorder + watchdog + incident coordination: an incident
    # bundle gets this router's decision-ring slice — WHY the wedged /
    # torn-stream request landed on that worker is part of the black box
    from .. import obs

    obs_handle = await obs.start_process(
        "router", store=drt.store, namespace=args.namespace,
        proc_label=f"router:{drt.worker_id:x}", span_sink=span_sink)
    obs_handle.manager.add_source("router_decisions",
                                  lambda: svc.decisions(0))
    # publish this process's stage registry (dyn_kv_cluster_hits_total,
    # histogram series the audit plane reads) onto the standard
    # metrics_stage/ merge path — a router that only *made* decisions
    # would keep its cluster-hit counter invisible to /metrics and dyntop
    from ..llm.metrics_aggregator import StagePublisher

    stage_pub = StagePublisher(drt.store, args.namespace, args.component,
                               drt.worker_id, drt.lease)

    async def stage_publish_loop():
        while True:
            try:
                await stage_pub.publish()
            except Exception:
                log.debug("router stage publish skipped", exc_info=True)
            await asyncio.sleep(2.0)

    stage_task = asyncio.create_task(stage_publish_loop())
    print(f"kv router serving {args.namespace}.{args.component}.route "
          f"(workers: {'<fleet registry>' if fleet else args.worker_component})",
          flush=True)
    if ready_event is not None:
        ready_event.set()
    try:
        while True:
            await asyncio.sleep(3600)
    finally:
        stage_task.cancel()
        await obs_handle.stop()
        await span_sink.stop()
        await svc.stop()
        if own:
            await drt.close()


def main() -> None:
    from ..utils.logging_ext import init_logging
    init_logging()
    try:
        asyncio.run(run_router(parse_args()))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
