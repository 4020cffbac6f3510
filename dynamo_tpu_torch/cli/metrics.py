"""Cluster metrics aggregator binary.

    python -m dynamo_tpu_torch.cli.metrics --namespace dynamo \
        --component backend [--component prefill] --store localhost:4222 \
        --port 9091 [--scrape-interval 1.0] [--push-url URL]

Subscribes the namespace kv-hit-rate events, scrapes every worker's
ForwardPassMetrics from the store, and serves the cluster Prometheus gauges
(llm_kv_blocks_*, llm_requests_*_slots, llm_load_avg/std,
llm_kv_hit_rate_percent) and the workers' stage dumps on ``/metrics``, or
PUTs the same text to a pushgateway with ``--push-url``. The exposition is
the JAX package's aggregator's, byte for byte, for the same snapshots; the
server is the port's own HTTP/1.1 server and the push a ``urllib`` request
on a thread, so nothing beyond the standard library is needed.

Reference capability: the standalone metrics binary
(components/metrics/src/main.rs:115-241).
"""

from __future__ import annotations

import asyncio
import logging
import urllib.error
import urllib.request

from ..llm.http_service import HttpServer, Response
from ..llm.metrics_aggregator import ClusterMetricsAggregator
from ..runtime.component import DistributedRuntime
from ..utils.dynconfig import EnvDefaultsParser

log = logging.getLogger("dynamo_tpu_torch.cli.metrics")

_TEXT = "text/plain; charset=utf-8"


def build_server(agg: ClusterMetricsAggregator, port: int) -> HttpServer:
    async def metrics(_req) -> Response:
        return Response(200, agg.render().encode(), _TEXT)

    return HttpServer("0.0.0.0", port, {("GET", "/metrics"): metrics})


def _put(url: str, body: bytes) -> int:
    req = urllib.request.Request(url, data=body, method="PUT",
                                 headers={"Content-Type": "text/plain"})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


async def push_loop(agg: ClusterMetricsAggregator, url: str,
                    interval: float) -> None:
    """Pushgateway mode: PUT the rendered exposition text to ``url``
    every ``interval`` seconds (the reference binary's serve-or-push
    switch, components/metrics/src/main.rs:26-31)."""
    while True:
        try:
            status = await asyncio.to_thread(_put, url,
                                             agg.render().encode())
            if status >= 400:
                log.warning("pushgateway %s returned %d", url, status)
        except OSError as e:
            log.warning("pushgateway push failed: %s", e)
        await asyncio.sleep(interval)


async def run_metrics(args, *, ready_event=None) -> None:
    host, port = args.store.split(":")
    drt = await DistributedRuntime(store_host=host,
                                   store_port=int(port)).connect()
    agg = await ClusterMetricsAggregator(
        drt, args.namespace, args.component,
        scrape_interval=args.scrape_interval).start()
    server = None
    pusher = None
    if args.push_url:
        pusher = asyncio.create_task(
            push_loop(agg, args.push_url, args.push_interval))
        log.info("metrics aggregator pushing to %s every %.1fs",
                 args.push_url, args.push_interval)
        print(f"metrics aggregator pushing to {args.push_url}", flush=True)
    else:
        server = build_server(agg, args.port)
        bound = await server.start()
        log.info("metrics aggregator on :%d (ns=%s components=%s)",
                 bound, args.namespace, args.component)
        print(f"metrics aggregator on :{bound}", flush=True)
    if ready_event is not None:
        ready_event.set()
    try:
        while True:
            await asyncio.sleep(3600)
    finally:
        if pusher is not None:
            pusher.cancel()
        await agg.stop()
        if server is not None:
            await server.stop()
        await drt.close()


def parse_args(argv=None):
    ap = EnvDefaultsParser("dynamo-metrics")
    ap.add_argument("--store", default="127.0.0.1:4222")
    ap.add_argument("--namespace", default="dynamo")
    ap.add_argument("--component", action="append", default=None,
                    help="worker component to scrape (repeatable)")
    ap.add_argument("--port", type=int, default=9091,
                    help="port of /metrics (0 picks a free one)")
    ap.add_argument("--scrape-interval", type=float, default=1.0)
    ap.add_argument("--push-url", default=None,
                    help="pushgateway URL; set => push instead of serve")
    ap.add_argument("--push-interval", type=float, default=5.0)
    args = ap.parse_args(argv)
    if not args.component:
        args.component = ["backend"]
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    from ..utils.logging_ext import init_logging
    init_logging()
    try:
        asyncio.run(run_metrics(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
