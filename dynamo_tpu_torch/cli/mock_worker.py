"""Mock worker: publishes fake ForwardPassMetrics under a live lease.

    python -m dynamo_tpu_torch.cli.mock_worker --namespace dynamo \
        --component backend --store localhost:4222 [--period 1.0]

Lets the metrics aggregator, router scoring and dashboards be exercised with
no engine at all: the snapshot values ramp deterministically so scrapes can
be asserted against (the JAX package's ramp, value for value). Reference
capability: components/metrics/src/bin/mock_worker.rs.
"""

from __future__ import annotations

import asyncio
import json
from typing import Optional

from ..llm.kv_router.protocols import ForwardPassMetrics
from ..llm.metrics_aggregator import metrics_key
from ..runtime.component import DistributedRuntime
from ..utils.dynconfig import EnvDefaultsParser


def snapshot(tick: int, total_slots: int, kv_total: int) -> ForwardPassMetrics:
    """Deterministic ramp: active load cycles 0..total, kv follows."""
    active = tick % (total_slots + 1)
    kv_active = (tick * 7) % (kv_total + 1)
    return ForwardPassMetrics(
        request_active_slots=float(active),
        request_total_slots=float(total_slots),
        kv_active_blocks=float(kv_active),
        kv_total_blocks=float(kv_total),
        num_requests_waiting=float(tick % 3),
        gpu_cache_usage_perc=kv_active / kv_total if kv_total else 0.0,
        gpu_prefix_cache_hit_rate=0.5,
    )


async def run_mock_worker(args, *, drt: Optional[DistributedRuntime] = None,
                          ready_event: Optional[asyncio.Event] = None) -> None:
    host, port = args.store.split(":")
    own = drt is None
    if own:
        drt = await DistributedRuntime(store_host=host,
                                       store_port=int(port)).connect()
    key = metrics_key(args.namespace, args.component, drt.worker_id)
    tick = 0
    print(f"mock worker {drt.worker_id:x} publishing {key}", flush=True)
    try:
        while True:
            m = snapshot(tick, args.total_slots, args.kv_total)
            await drt.store.put(key, json.dumps(m.to_dict()).encode(),
                                lease=drt.lease)
            if ready_event is not None and tick == 0:
                ready_event.set()
            tick += 1
            await asyncio.sleep(args.period)
    finally:
        if own:
            await drt.close()


def main(argv=None) -> None:
    ap = EnvDefaultsParser("dynamo-mock-worker")
    ap.add_argument("--store", default="127.0.0.1:4222")
    ap.add_argument("--namespace", default="dynamo")
    ap.add_argument("--component", default="backend")
    ap.add_argument("--period", type=float, default=1.0)
    ap.add_argument("--total-slots", type=int, default=8)
    ap.add_argument("--kv-total", type=int, default=512)
    args = ap.parse_args(argv)
    from ..utils.logging_ext import init_logging
    init_logging()
    asyncio.run(run_mock_worker(args))


if __name__ == "__main__":
    main()
