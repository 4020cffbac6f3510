"""Regional aggregator daemon: one node of the hierarchical observer tree.

    python -m dynamo_tpu_torch.cli.aggregator --store 127.0.0.1:4222 \
        [--namespace dynamo] [--interval 2.0]

Run N of these (any N; one is enough for thousands of workers, more
divide the merge work) against the same store. Each instance:

- registers lease-bound under ``regions/{ns}/{lease:x}`` — the lease id
  IS the region id, so a dead aggregator's record (and region) vanishes
  with its session;
- owns the rendezvous-hashed slice of the namespace's workers implied
  by the live aggregator set (it watches the ``regions/`` prefix for
  peers; membership churn only re-homes the affected region's workers);
- per ``--interval`` tick, pre-merges its workers' ``metrics_stage/``
  dumps (full+delta overlay) + ForwardPassMetrics snapshots and
  publishes ONE region record that the planner's signal collector, the
  SLO monitor, dyntop and ``fetch_stage_states`` read instead of the
  flat per-worker scrape.

Flags resolve env defaults as ``DYN_AGGREGATOR_<FLAG>`` (dynconfig
layering); ``--interval`` additionally honors ``DYN_REGION_INTERVAL``.
Zero aggregators running = every reader silently uses the flat scrape.
"""

from __future__ import annotations

import asyncio
import logging

from ..runtime.scale.regions import RegionalAggregator, region_interval
from ..utils.dynconfig import EnvDefaultsParser

log = logging.getLogger("dynamo_tpu_torch.aggregator")


def parse_args(argv=None):
    p = EnvDefaultsParser(prog="dynamo-aggregator")
    p.add_argument("--store", default="127.0.0.1:4222")
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--interval", type=float, default=None,
                   help="seconds between region merges (default: "
                        "DYN_REGION_INTERVAL, 2.0)")
    return p.parse_args(argv)


async def run_aggregator(args, *, ready_event=None,
                         drt=None) -> "RegionalAggregator":
    from ..llm.metrics_aggregator import StagePublisher
    from ..runtime.component import DistributedRuntime
    from ..utils import tracing

    own_drt = drt is None
    if own_drt:
        host, port = args.store.split(":")
        drt = await DistributedRuntime(store_host=host,
                                       store_port=int(port)).connect()
    tracing.configure(component="aggregator")
    # flight recorder + watchdog + incident coordination: a capture
    # beacon gets this aggregator's merge-loop view of the window too
    from .. import obs

    obs_handle = await obs.start_process(
        "aggregator", store=drt.store, namespace=args.namespace,
        proc_label=f"aggregator:{drt.worker_id:x}")
    interval = args.interval if args.interval is not None \
        else region_interval()
    agg = await RegionalAggregator(drt.store, args.namespace,
                                   agg_id=drt.worker_id, lease=drt.lease,
                                   interval=interval).start()
    # first record lands before "serving" prints, so a harness waiting
    # on the log line can immediately read a fresh region
    await agg.tick()
    agg.start_loop()
    # the aggregator's own dyn_region_merge_seconds histogram rides the
    # ordinary stage-metrics plane (delta-batched like any worker)
    publisher = StagePublisher(drt.store, args.namespace, "aggregator",
                               drt.worker_id, drt.lease)
    agg._drt = drt            # keeps the runtime alive with the daemon
    agg._own_drt = own_drt
    agg._obs_handle = obs_handle

    async def publish_loop():
        while True:
            try:
                await publisher.publish()
            except Exception:
                log.debug("aggregator stage publish skipped",
                          exc_info=True)
            await asyncio.sleep(max(interval, 1.0))

    from ..utils.aiotasks import spawn
    agg._pub_task = spawn(publish_loop(), name="aggregator-publish")
    print(f"regional aggregator serving (region={drt.worker_id:x}, "
          f"ns={args.namespace}, interval={interval}s)", flush=True)
    if ready_event is not None:
        ready_event.set()
    return agg


async def amain(args) -> None:
    agg = await run_aggregator(args)
    try:
        while True:
            await asyncio.sleep(3600)
    finally:
        await agg.stop()
        agg._pub_task.cancel()
        await agg._obs_handle.stop()
        if agg._own_drt:
            await agg._drt.close()


def main() -> None:
    from ..utils.logging_ext import init_logging

    init_logging()
    try:
        asyncio.run(amain(parse_args()))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
