"""Prefill worker: pulls the shared prefill queue, computes prompt KV on its
own card through the torch engine, ships it to the owning decode worker.

    python -m dynamo_tpu_torch.cli.prefill_worker --namespace dynamo \
        --decode-component backend --store localhost:4222 \
        [--device cuda|cpu] [--model-path ...] \
        [--extra-engine-args '{"preset": "llama-3-8b"}']

The port's copy of the JAX package's ``cli/prefill_worker.py``: the same
queue, wire and spans, so it feeds JAX decode workers as well as the
port's. Like the reference's PrefillWorker (examples/llm/components/
prefill_worker.py:46-158), prefill workers need **no registration**: they
are queue consumers, so scaling up/down is just starting/stopping
processes — unacked jobs are redelivered if one dies mid-prefill.

Its stage dump (component ``prefill``) also carries the port-only engine
counters of ``cli/worker.engine_counters``: its prefill dispatches, its
flash-kernel launches and its peak device memory.

As the decode worker does, it builds its engine before it connects to the
store (:func:`build_engine`): no liveness lease exists while the bring-up
holds the process.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import time
from typing import Optional

from ..llm.disagg import PrefillQueue
from ..llm.kv_transfer import KV_RECEIVE_ENDPOINT, push_kv, push_kv_error
from ..llm.model_card import ModelDeploymentCard
from ..llm.protocols.common import BackendInput
from ..runtime.component import DistributedRuntime
from ..runtime.engine import Context
from ..utils import tracing
from ..utils.dynconfig import EnvDefaultsParser
from .worker import engine_counters

MAX_ATTEMPTS = 3
PREFILL_COMPONENT = "prefill"   # stage-metrics component tag

log = logging.getLogger("dynamo_tpu_torch.prefill_worker")


def make_engine(args):
    """The prefill worker's torch engine, built on the calling thread."""
    from ..engine.engine import TorchEngine, TorchEngineConfig

    if args.model_path:
        card = ModelDeploymentCard.resolve(args.model_path, args.model_name)
    else:
        card = ModelDeploymentCard.synthetic(args.model_name or "prefill")
    card.kv_block_size = args.kv_block_size
    extra = json.loads(args.extra_engine_args) if args.extra_engine_args else {}
    extra.setdefault("device", args.device)
    return TorchEngine(TorchEngineConfig.from_card(card, **extra))


async def build_engine(args):
    """:func:`make_engine` on an executor thread; a caller that can builds
    it before connecting to the store, so no lease exists while the import
    and bring-up hold the event loop (``cli.worker.build_engine``)."""
    return await asyncio.get_running_loop().run_in_executor(
        None, lambda: make_engine(args))


async def run_prefill_worker(args, *,
                             ready_event: Optional[asyncio.Event] = None,
                             drt: Optional[DistributedRuntime] = None,
                             max_jobs: Optional[int] = None,
                             token=None, engine=None) -> None:
    """Pull jobs for ``engine`` (built here when None: before connecting
    when this call connects ``drt`` itself)."""
    host, port = args.store.split(":")
    own_drt = drt is None
    if engine is None and own_drt:
        engine = await build_engine(args)
    if own_drt:
        drt = await DistributedRuntime(
            store_host=host, store_port=int(port),
            advertise_host=args.advertise_host).connect()
    if token is not None:
        def _lease_lost(lease: int) -> None:
            log.critical("liveness lease %x unrecoverably lost; "
                         "shutting down", lease)
            token.cancel()
        drt.store.on_lease_lost = _lease_lost
    ns = drt.namespace(args.namespace)
    if engine is None:
        engine = await build_engine(args)

    queue = PrefillQueue(drt.store, args.namespace)
    kv_client = await ns.component(args.decode_component) \
        .endpoint(KV_RECEIVE_ENDPOINT).client().start()

    # tracing + stage metrics: spans flush to the store (the frontend's
    # /v1/traces stitches them); histogram dumps refresh under our lease
    tracing.configure(component="prefill_worker")
    span_sink = await tracing.StoreSpanSink(drt.store).start()

    # flight recorder + watchdog + incident coordination (see cli/worker):
    # a prefill stall or torn push shows up in THIS process's rings, and a
    # beacon raised anywhere in the cluster captures our slice too
    from .. import obs

    obs_handle = await obs.start_process(
        "prefill_worker", store=drt.store, namespace=args.namespace,
        proc_label=f"prefill_worker:{drt.worker_id:x}",
        span_sink=span_sink, install_signal=token is not None)
    from ..llm.metrics_aggregator import StagePublisher

    publisher = StagePublisher(drt.store, args.namespace,
                               PREFILL_COMPONENT, drt.worker_id, drt.lease)

    async def stage_metrics_loop():
        while True:
            try:
                await publisher.publish(extra_metrics=engine_counters(
                    engine.core, drt.worker_id))
            except Exception:
                log.exception("stage metrics publish failed")
            await asyncio.sleep(1.0)

    stage_task = asyncio.create_task(stage_metrics_loop())

    log.info("prefill worker up, pulling %s", queue.queue)
    print(f"prefill worker pulling {queue.queue}", flush=True)
    if ready_event is not None:
        ready_event.set()
    done = 0
    try:
        while max_jobs is None or done < max_jobs:
            # race the (possibly long-parked) queue pull against drain: a
            # SIGTERM'd prefill worker must stop TAKING jobs immediately —
            # an abandoned pull's message is requeued when the connection
            # closes (at-least-once)
            pull = asyncio.ensure_future(queue.dequeue())
            if token is not None or drt.draining.is_set():
                waiters = {pull, asyncio.ensure_future(drt.draining.wait())}
                if token is not None:
                    waiters.add(asyncio.ensure_future(token.wait()))
                # unbounded-ok: drain/cancel always completes this wait
                await asyncio.wait(waiters,
                                   return_when=asyncio.FIRST_COMPLETED)
                for w in waiters:
                    if w is not pull:
                        w.cancel()
                if not pull.done():
                    pull.cancel()
                    log.info("draining: queue pull stopped")
                    break
            msg_id, job = await pull
            if await queue.consume_cancelled(job.request_id):
                await queue.ack(msg_id)
                log.info("dropping cancelled prefill job %s", job.request_id)
                done += 1
                continue
            # all spans of this job parent under the decode worker's span
            # (carried in job.trace); fallback: stitch by request id
            job_parent = tracing.extract_wire(job.trace, job.request_id)
            ctx = None
            try:
                from ..utils import faults

                # chaos hook: a stalled/failed prefill worker — the decode
                # side's deadline-bounded KV wait must turn this into a 504
                await faults.fire("prefill.compute")
                bi = BackendInput.from_dict(job.request)
                ctx = Context(job.request_id, deadline=job.deadline)
                # register with the runtime so the Worker shell's drain
                # waits for (then stops/kills) the in-flight compute+push
                # instead of cancelling it mid-job — the job must be acked
                # or requeued, never silently half-done
                drt._active[ctx.id] = ctx
                async with tracing.get_tracer().span(
                        "prefill.compute", parent=job_parent,
                        request_id=job.request_id,
                        prompt_tokens=len(bi.token_ids)) as csp:
                    compute_t0 = time.monotonic()
                    k, v, tok, logp = await engine.prefill_extract(bi, ctx)
                    # pure per-item compute cost, published for operators
                    # (the decode side's predictive shed runs on its own
                    # depth-normalized turnaround EWMA)
                    from ..utils.prometheus import stage_metrics

                    stage_metrics().stage_service.observe(
                        "prefill", value=time.monotonic() - compute_t0)
                if await queue.consume_cancelled(job.request_id):
                    # submitter gave up mid-compute: skip the (large) push
                    await queue.ack(msg_id)
                    log.info("dropping cancelled prefill job %s post-compute",
                             job.request_id)
                    done += 1
                    continue
                with tracing.current_span_var_scope(
                        csp.context() if csp is not None else job_parent):
                    await push_kv(kv_client, job.decode_worker_id,
                                  job.request_id, tok, logp, k, v,
                                  src_worker=drt.worker_id)
                await queue.ack(msg_id)
                log.info("prefilled %s (%d tokens) -> worker %x",
                         job.request_id, len(bi.token_ids),
                         job.decode_worker_id)
            except Exception as e:
                # the store only redelivers unacked jobs when THIS connection
                # dies — so ack and explicitly re-enqueue with an attempt
                # count, dead-lettering back to the decode worker when the
                # job looks poisoned (it falls back / errors the request)
                log.exception("prefill job %s failed (attempt %d)",
                              job.request_id, job.attempts + 1)
                job.attempts += 1
                await queue.ack(msg_id)
                if job.attempts < MAX_ATTEMPTS:
                    # restamp so queue-wait measures THIS attempt's wait,
                    # not wait + failed compute + backoff since the first.
                    # Bounds are NOT re-enforced: the job was already
                    # admitted once — a retry must not be shed by a queue
                    # that filled up behind it
                    job.enqueued_at = 0.0
                    await queue.enqueue(job, enforce_bounds=False)
                else:
                    try:
                        await push_kv_error(kv_client, job.decode_worker_id,
                                            job.request_id, str(e))
                    except Exception:
                        log.exception("could not dead-letter %s",
                                      job.request_id)
                await asyncio.sleep(0.2)
            finally:
                if ctx is not None:
                    drt._active.pop(ctx.id, None)
            done += 1
    finally:
        stage_task.cancel()
        queue.close()   # cancel parked per-priority pulls
        await obs_handle.stop()
        try:
            await span_sink.stop()   # final flush: short-lived runs
        except Exception:            # (max_jobs) must not lose spans
            log.warning("span sink final flush failed; tail spans lost",
                        exc_info=True)
        # deregistration: drop the published stage dump so aggregators
        # stop rendering this worker when a shared runtime outlives it
        from ..llm.metrics_aggregator import clear_worker_keys

        await clear_worker_keys(drt.store, args.namespace,
                                PREFILL_COMPONENT, drt.worker_id)
        engine.shutdown()
        if own_drt:
            await drt.close()


def parse_args(argv=None) -> argparse.Namespace:
    p = EnvDefaultsParser(prog="dynamo-prefill-worker")
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--decode-component", default="backend")
    p.add_argument("--store", default="127.0.0.1:4222")
    p.add_argument("--advertise-host", default=None)
    p.add_argument("--model-path", default=None)
    p.add_argument("--model-name", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device of the engine (cuda | cpu)")
    p.add_argument("--kv-block-size", type=int, default=64)
    p.add_argument("--extra-engine-args", default=None,
                   help="inline JSON engine kwargs")
    return p.parse_args(argv)


def main() -> None:
    from ..utils.logging_ext import init_logging
    init_logging()
    args = parse_args()
    # Worker shell: SIGINT/SIGTERM drain gracefully — stop pulling the
    # queue, finish/ship the in-flight job, revoke the lease, exit
    from ..runtime.worker import Worker

    shell = Worker()

    async def app(token):
        # the engine first: no lease exists while its bring-up holds the
        # process (ROADMAP Queue 3 item 8)
        engine = await build_engine(args)
        host, port = args.store.split(":")
        drt = await DistributedRuntime(
            store_host=host, store_port=int(port),
            advertise_host=args.advertise_host).connect()
        shell.add_runtime(drt)
        await run_prefill_worker(args, drt=drt, token=token, engine=engine)

    try:
        shell.execute(app)
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
