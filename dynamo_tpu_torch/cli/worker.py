"""Worker binary: serve a torch engine as a distributed endpoint.

    python -m dynamo_tpu_torch.cli.worker --engine torch|echo \
        --namespace dynamo --component backend --store localhost:4222 \
        [--device cuda|cpu] [--model-path ...] [--register-model] \
        [--extra-engine-args '{"preset": "llama-3-8b"}']

Serves ``generate`` (BackendInput -> EngineOutput stream), publishes KV cache
events on the component event plane, and refreshes ForwardPassMetrics in the
store under its lease (routers scrape the prefix). The wire, the store keys
and the event payloads are the JAX package's ``cli.worker``'s, so a JAX
router and frontend route to this worker as to their own.

With ``--enable-disagg`` the worker is a decode worker with conditional
remote prefill, as the JAX worker's: long cold prompts go to the shared
prefill queue (``cli/prefill_worker.py`` pulls it), their KV streams back
on the ``kv_receive`` endpoint layer by layer into the engine's pool, and
the request enters decode directly.

With ``DYN_KV_CLUSTER=1`` the worker joins the cluster KV sharing plane, as
the JAX worker does (``llm/kv_cluster``): its engine mirrors sealed blocks
to the host tier, it serves ``kv_fetch`` over that tier and publishes a
lease-bound registry record of it, and a request the router stamped with a
donor fetches the prefix blocks it lacks from that donor before it enters
the engine; the matched tier prefix then uploads on a side stream while
the request waits at the slot gate.

The engine is built before the worker connects to the store, so no
liveness lease exists while the bring-up holds the process (see
:func:`build_engine`).

Not ported yet, and refused at start instead of ignored: ``--num-nodes``
above 1 (ROADMAP Queue 1 item 11); a model-mobility swap or prefetch
command (item 12) is refused in the log and left for another worker.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import time
from typing import Optional

from ..llm.disagg import (DisaggConfig, DisaggRouter, PrefillQueue,
                          RemotePrefillRequest)
from ..llm.kv_router.protocols import KV_EVENT_SUBJECT, ForwardPassMetrics
from ..llm.kv_router.publisher import KvEventPublisher
from ..llm.kv_transfer import (KV_RECEIVE_ENDPOINT, KvReceiver,
                               RemotePrefillError, stream_enabled)
from ..llm.metrics_aggregator import metrics_key
from ..llm.model_card import ModelDeploymentCard
from ..llm.protocols.common import BackendInput
from ..llm.remote import register_model, serve_core_engine
from ..runtime.component import DistributedRuntime
from ..runtime.store_client import StoreError
from ..utils import overload, tracing
from ..utils.dynconfig import EnvDefaultsParser

log = logging.getLogger("dynamo_tpu_torch.worker")

#: the JAX package's model-mobility keyspace (``fleet/mobility/keys.py``)
MOBILITY_PREFIX = "mobility/"


def check_ported(args) -> None:
    """Raise, naming the ROADMAP item, for options whose JAX code paths the
    port does not have yet."""
    if getattr(args, "num_nodes", 1) > 1:
        raise NotImplementedError(
            "--num-nodes above 1: multi-node serving (parallel/) is not "
            "ported to dynamo_tpu_torch yet (ROADMAP Queue 1 item 11)")


def _build_card(args) -> ModelDeploymentCard:
    if args.model_path:
        card = ModelDeploymentCard.resolve(args.model_path, args.model_name)
    else:
        card = ModelDeploymentCard.synthetic(args.model_name or "echo")
    card.kv_block_size = args.kv_block_size
    return card


def _engine_cfg(args, card: ModelDeploymentCard):
    from ..engine.engine import TorchEngineConfig

    extra = json.loads(args.extra_engine_args) if args.extra_engine_args \
        else {}
    extra.setdefault("device", args.device)
    from ..llm import kv_cluster

    if kv_cluster.enabled():
        # cluster sharing needs sealed blocks mirrored to the host tier
        # (write-through) so peers can fetch prefixes that never saw
        # device eviction pressure; a no-op when host_cache_blocks=0
        extra.setdefault("cluster_writethrough", True)
    return TorchEngineConfig.from_card(card, **extra)


async def build_engine(args, card: Optional[ModelDeploymentCard] = None):
    """The worker's engine: a :class:`TorchEngine` (``--engine torch``) or
    the echo engine, built on an executor thread. A caller that can builds
    it before it connects to the store: the engine module's import (the
    process's first ``import torch``) runs on the event loop and holds it
    for seconds on a busy host, and the bring-up competes with the loop
    for the interpreter lock; with no lease granted yet there is no
    keepalive to starve."""
    if args.engine != "torch":
        from ..llm.engines import EchoCoreEngine

        return EchoCoreEngine()
    from ..engine.engine import TorchEngine

    cfg = _engine_cfg(args, card or _build_card(args))
    return await asyncio.get_running_loop().run_in_executor(
        None, lambda: TorchEngine(cfg))


async def _connect_drt(args) -> DistributedRuntime:
    host, port = args.store.split(":")
    return await DistributedRuntime(
        store_host=host, store_port=int(port),
        advertise_host=args.advertise_host).connect()


async def _refuse_mobility(drt: DistributedRuntime, namespace: str,
                           component: str) -> None:
    """Watch this component's model-mobility commands and refuse them
    loudly: the swap and cold-reload paths (``fleet/mobility``) are not
    ported yet (ROADMAP Queue 1 item 12). The key is left in place, so a
    JAX worker of the component may claim it."""
    prefix = f"{MOBILITY_PREFIX}{namespace}/"
    mine = (f"{prefix}swap/{component}", f"{prefix}prefetch/{component}")

    async def on_event(key: str, value: Optional[bytes],
                       deleted: bool) -> None:
        if not deleted and key in mine:
            log.error("refusing model-mobility command %s: weight swap and "
                      "cold reload are not ported to dynamo_tpu_torch yet "
                      "(ROADMAP Queue 1 item 12)", key)

    for key, value in await drt.store.watch_prefix(prefix, on_event):
        await on_event(key, value, False)


async def _disagg_handler(args, drt: DistributedRuntime, component,
                          engine, gate, cluster=None):
    """The decode worker's ``generate`` handler with conditional remote
    prefill (SURVEY §3.2): long cold prompts go to the shared queue; KV
    comes back on the ``kv_receive`` endpoint (served here) and the
    request enters decode directly. Any failure of the remote path falls
    back to a local prefill, never to a user error."""
    core = engine.core
    queue = PrefillQueue(drt.store, args.namespace)
    drouter = await DisaggRouter(
        args.namespace,
        config=DisaggConfig(
            max_local_prefill_length=args.max_local_prefill_length,
            max_prefill_queue_size=args.max_prefill_queue_size),
    ).start(drt.store)
    receiver = KvReceiver(worker_id=drt.worker_id)
    await component.endpoint(KV_RECEIVE_ENDPOINT).serve(receiver.handler)
    remote_timeout = args.remote_prefill_timeout

    from ..llm.kv_transfer import await_remote_kv as _await_kv

    async def await_remote_kv(ctx, fut):
        return await _await_kv(ctx, fut, queue, receiver, remote_timeout)

    async def generate_handler(request, ctx):
        bi = BackendInput.from_dict(request)
        if cluster is not None:
            # donor-stamped prefix fetch BEFORE the slot gate and the
            # local probe: the peer fetch overlaps the queue wait instead
            # of holding a slot through up to the fetch timeout, and the
            # deposited blocks count as local prefix hits, so a
            # cluster-warm prompt prefills locally instead of paying the
            # remote-prefill queue for KV a peer already holds
            await cluster.fetcher.ensure_prefix(bi, ctx)
        # placement-driven h2d prefetch: the matched tier blocks upload on
        # an executor thread WHILE this request waits at the slot gate
        from ..utils.aiotasks import spawn_blocking
        spawn_blocking(engine.prefetch_tiers, bi, name="h2d-prefetch")
        if gate is not None:
            await gate.acquire(ctx.priority, ctx.deadline)
            svc_started = time.monotonic()
            try:
                async for item in _generate_disagg(bi, request, ctx):
                    yield item
            finally:
                gate.release(time.monotonic() - svc_started)
        else:
            async for item in _generate_disagg(bi, request, ctx):
                yield item

    async def _generate_disagg(bi, request, ctx):
        # local prefix-cache hits count against remoting: a prompt we
        # mostly have cached prefills locally regardless of length.
        # CROSS-THREAD CONTRACT: this runs on the asyncio thread while the
        # engine thread mutates the block pool. probe_prefix and
        # TieredKvCache.__contains__ are strictly READ-ONLY (no LRU
        # reorder), which is what makes the unlocked probe safe under the
        # GIL — do not swap in tiered.lookup() (it mutates LRU order)
        # without adding a lock.
        host = core.tiered
        prefix_hit = core.pool.probe_prefix(
            bi.token_ids, (lambda h: h in host) if host else None,
            lora_id=bi.kv_salt or bi.lora_id)
        remote = False
        qsize = 0
        if drouter.length_exceeds_local(len(bi.token_ids), prefix_hit):
            # only candidates pay the queue-depth RPC
            qsize = await queue.size()
            remote = drouter.should_prefill_remote(
                len(bi.token_ids), prefix_hit, qsize)
        tracer = tracing.get_tracer()
        if remote:
            # layer-streamed ingest (DYN_KV_STREAM): hand the receiver an
            # engine handle so each arriving layer's scatter is enqueued
            # while later layers are still on the wire — the future then
            # resolves to the handle (not arrays) once the final scatter
            # is enqueued, never synced
            ingest = None
            if stream_enabled() and hasattr(engine, "kv_ingest"):
                ingest = engine.kv_ingest(bi, ctx.id)
            # register interest BEFORE enqueueing: a fast prefill worker
            # may push the KV back before we'd otherwise start listening
            fut = receiver.expect(ctx.id, ingest=ingest)
            async with tracer.span("prefill.remote_wait", trace_id=ctx.id,
                                   prompt_tokens=len(bi.token_ids),
                                   prefix_hit_tokens=prefix_hit) as wsp:
                remote_t0 = time.monotonic()
                try:
                    await queue.enqueue(RemotePrefillRequest(
                        ctx.id, drt.worker_id, request,
                        deadline=ctx.deadline, priority=ctx.priority))
                except overload.OverloadError as e:
                    # bounded-queue / predictive shed at enqueue: the
                    # remote path is refused in milliseconds; local
                    # prefill (deadline-bounded) takes over
                    receiver.abandon(ctx.id)
                    log.info("prefill enqueue shed for %s (%s); "
                             "prefilling locally", ctx.id, e.reason)
                    kv = None
                else:
                    try:
                        kv = await await_remote_kv(ctx, fut)
                    except RemotePrefillError as e:
                        log.warning("remote prefill for %s dead-lettered "
                                    "(%s); prefilling locally", ctx.id, e)
                        kv = None
                    if kv is not None:
                        # the predictive shed needs PER-ITEM service time:
                        # normalize the turnaround by the depth seen at
                        # the remote decision (raw turnaround would count
                        # the queue twice and feed back into shedding)
                        queue.observe_service(
                            (time.monotonic() - remote_t0)
                            / max(qsize + 1, 1))
                if wsp is not None:
                    wsp.attrs["fallback_local"] = kv is None
                    wsp.attrs["streamed"] = kv is not None \
                        and kv is ingest
            if kv is not None and ingest is not None and kv is ingest:
                # the sequence is already entering decode; consume its
                # output queue. An engine-side ingest failure surfaces
                # BEFORE the first token as a typed error — fall through
                # to local prefill, never a user error
                try:
                    async with tracer.span("decode.stream", trace_id=ctx.id,
                                           injected=True, streamed=True):
                        async for out in engine.generate_streamed(
                                bi, ctx, ingest):
                            yield out.to_dict()
                    return
                except RemotePrefillError as e:
                    log.warning("streamed KV ingest for %s failed (%s); "
                                "prefilling locally", ctx.id, e)
                    kv = None
            if kv is not None:
                k, v, tok, logp = kv
                async with tracer.span("decode.stream", trace_id=ctx.id,
                                       injected=True):
                    async for out in engine.generate_prefilled(
                            bi, ctx, k, v, tok, logp):
                        yield out.to_dict()
                return
        async with tracer.span("decode.stream", trace_id=ctx.id,
                               injected=False):
            async for out in engine.generate(bi, ctx):
                yield out.to_dict()

    return generate_handler


def engine_counters(core, worker_id: int) -> dict:
    """This worker's engine dispatches and kernel launches as a stage-dump
    fragment, published beside the stage registry: a frontend's
    ``/metrics`` then shows, per worker, that its prefills and decode steps
    ran (``dyn_engine_dispatches_total{kind}``) and went through the
    hand-written kernels (``dyn_kernel_launches_total{kernel}``; these
    count on the card only), on the card its peak device memory
    (``dyn_device_memory_peak_bytes``), and with cluster write-through the
    mirrors' blocks, bytes, seconds and host enqueue seconds
    (``dyn_kv_writethrough_*_total``).
    Port-only series: the JAX worker publishes none of them."""
    from ..ops import attention as att
    from ..utils.prometheus import Registry

    r = Registry()
    wid = f"{worker_id:x}"
    d = r.counter("dyn_engine_dispatches_total",
                  "Engine dispatches by kind since the worker started",
                  ("worker", "kind"))
    d.inc(wid, "prefill", amount=core.prefill_dispatches)
    d.inc(wid, "decode", amount=core.decode_dispatches)
    d.inc(wid, "decode_step", amount=core.decode_steps_run)
    k = r.counter("dyn_kernel_launches_total",
                  "Hand-written attention kernel launches since the worker "
                  "started", ("worker", "kernel"))
    k.inc(wid, "flash_attention", amount=att.flash_attention.launches)
    k.inc(wid, "paged_attention", amount=att.paged_attention.launches)
    if core.cfg.cluster_writethrough:
        r.counter("dyn_kv_writethrough_blocks_total",
                  "Sealed blocks mirrored to the host tier (cluster "
                  "write-through)", ("worker",)).inc(
                      wid, amount=core.writethrough_blocks)
        r.counter("dyn_kv_writethrough_bytes_total",
                  "Bytes of those mirrors", ("worker",)).inc(
                      wid, amount=core.writethrough_bytes)
        r.counter("dyn_kv_writethrough_seconds_total",
                  "The mirror copies' own time (device events on a card)",
                  ("worker",)).inc(wid, amount=core.writethrough_seconds)
        r.counter("dyn_kv_writethrough_enqueue_seconds_total",
                  "Host time enqueueing those copies", ("worker",)).inc(
                      wid, amount=core.writethrough_enqueue_seconds)
    if core.device.type == "cuda":
        import torch

        r.gauge("dyn_device_memory_peak_bytes",
                "Peak device memory allocated by this worker's process",
                ("worker",)).set(wid, value=float(
                    torch.cuda.max_memory_allocated(core.device)))
    return r.state_dump()


async def run_worker(args, *, ready_event: Optional[asyncio.Event] = None,
                     drt: Optional[DistributedRuntime] = None,
                     token=None, engine=None) -> None:
    """Serve ``engine`` (built here by :func:`build_engine` when None) on
    ``drt`` (connected here when None, after the engine is up)."""
    check_ported(args)
    card = _build_card(args)
    own_drt = drt is None
    if engine is None and own_drt:
        # no lease exists yet: bring the engine up first
        engine = await build_engine(args, card)
    if own_drt:
        drt = await _connect_drt(args)
    if token is not None:
        # losing the liveness lease for good (the store client's reconnect
        # window exhausted, or the server could not keep our identity)
        # cancels the worker, so an orchestrator restarts it with a fresh
        # lease instead of it serving unroutably
        def _lease_lost(lease: int) -> None:
            log.critical("liveness lease %x unrecoverably lost; "
                         "shutting down", lease)
            token.cancel()
        drt.store.on_lease_lost = _lease_lost

    def _session_replayed() -> None:
        log.warning("store session re-established: lease %x re-granted, "
                    "endpoint/model keys re-registered", drt.worker_id)
    drt.store.on_session_replayed = _session_replayed
    ns = drt.namespace(args.namespace)
    component = ns.component(args.component)

    # tracing: span context arrives over the wire (rpc spans); finished
    # spans flush to the store so a frontend's /v1/traces stitches the
    # cross-process timeline
    tracing.configure(component="decode_worker")
    span_sink = await tracing.StoreSpanSink(drt.store).start()

    # flight recorder + hang watchdog + incident coordination
    from .. import obs

    obs_handle = await obs.start_process(
        "decode_worker", store=drt.store, namespace=args.namespace,
        proc_label=f"decode_worker:{drt.worker_id:x}",
        span_sink=span_sink, install_signal=token is not None)

    # --- engine -------------------------------------------------------
    if engine is None:
        # a caller that connected first: off the loop, while its lease
        # keepalives keep flowing as far as the bring-up lets them
        engine = await build_engine(args, card)
    core = getattr(engine, "core", None)

    # --- KV event publishing -----------------------------------------
    async def publish(subject, payload):
        await component.publish(subject, payload)

    pub = KvEventPublisher(worker_id=drt.worker_id, publish=publish,
                           subject=KV_EVENT_SUBJECT)
    await pub.start()
    if core is not None:
        core.pool.on_block_sealed = pub.block_stored
        core.pool.on_blocks_removed = pub.blocks_removed

    # --- cluster KV sharing (DYN_KV_CLUSTER=1) -----------------------
    # serve the kv_fetch donor endpoint over the host tier, publish this
    # worker's sealed-block registry record (lease-bound), and fetch
    # donor-stamped prefixes before requests enter the engine
    from ..llm import kv_cluster

    cluster = None
    if core is not None and kv_cluster.enabled():
        cluster = await kv_cluster.KvClusterWorker.attach(
            component, drt, args.namespace, core)

    # --- serve endpoint ----------------------------------------------
    # worker-ingress overload gate (DYN_WORKER_SLOTS / DYN_WORKER_QUEUE_
    # DEPTH, unset = off): excess load fails fast as a typed 429 naming
    # this stage instead of queueing into a deadline burn
    gate = overload.gate_from_env()
    endpoint = component.endpoint("generate")
    if getattr(args, "enable_disagg", False) and core is not None:
        await endpoint.serve(await _disagg_handler(args, drt, component,
                                                   engine, gate, cluster))
    else:
        served = engine if gate is None \
            else overload.SlotGatedEngine(engine, gate)
        if cluster is not None:
            # prefetch wraps OUTSIDE the slot gate: the peer fetch overlaps
            # the queue wait instead of holding a slot while blocks
            # stream, and the local-tier h2d prefetch uploads matched
            # blocks to device staging during the same wait
            served = cluster.wrap(served, prefetcher=engine.prefetch_tiers)
        await serve_core_engine(endpoint, served)
    if args.register_model:
        await register_model(drt.store, card, endpoint.path,
                             model_type="chat", lease=drt.lease)
        await register_model(drt.store, card, endpoint.path,
                             model_type="completion", lease=drt.lease)
    await _refuse_mobility(drt, args.namespace, args.component)

    # --- metrics loop -------------------------------------------------
    from ..llm.metrics_aggregator import StagePublisher

    stage_pub = StagePublisher(drt.store, args.namespace, args.component,
                               drt.worker_id, drt.lease)

    async def metrics_loop():
        while True:
            key = metrics_key(args.namespace, args.component, drt.worker_id)
            extra = None
            if core is not None:
                m = ForwardPassMetrics(**core.utilization())
                extra = engine_counters(core, drt.worker_id)
            else:
                # echo engine: real in-flight count, capacity from
                # --echo-slots
                m = ForwardPassMetrics(
                    request_active_slots=len(drt._active),
                    request_total_slots=args.echo_slots)
            try:
                await drt.store.put(key, json.dumps(m.to_dict()).encode(),
                                    lease=drt.lease)
                await stage_pub.publish(extra_metrics=extra)
            except StoreError:
                # store mid-outage (reconnect in flight): skip the beat;
                # the session replay re-puts the last snapshot anyway
                log.debug("metrics publish skipped (store disconnected)")
            except Exception:
                log.exception("stage metrics publish failed")
            await asyncio.sleep(args.metrics_interval)

    mtask = asyncio.create_task(metrics_loop())
    log.info("worker %x serving %s", drt.worker_id, endpoint.path)
    print(f"worker {drt.worker_id:x} serving {endpoint.path}", flush=True)
    if ready_event is not None:
        ready_event.set()
    try:
        if token is not None:
            await token.wait()     # Worker shell: serve until shutdown signal
        else:
            while True:
                await asyncio.sleep(3600)
    finally:
        drt.store.on_lease_lost = None
        mtask.cancel()
        await obs_handle.stop()
        try:
            await span_sink.stop()
        except Exception:
            log.warning("span sink final flush failed; tail spans lost",
                        exc_info=True)
        await pub.stop()
        # deregistration cleanup: drop the published metric snapshots so
        # aggregators stop rendering a ghost worker when a shared runtime
        # outlives this serve loop
        from ..llm.metrics_aggregator import clear_worker_keys

        await clear_worker_keys(drt.store, args.namespace, args.component,
                                drt.worker_id)
        if cluster is not None:
            try:
                await cluster.stop()   # cancel publisher, drop registry key
            except Exception:
                log.warning("kv-cluster detach failed", exc_info=True)
        if core is not None:
            try:
                engine.shutdown()   # joins the engine thread, clears gauges
            except Exception:
                log.exception("engine shutdown failed")
        if own_drt:
            await drt.close()


def parse_args(argv=None) -> argparse.Namespace:
    p = EnvDefaultsParser(prog="dynamo-worker")
    p.add_argument("--engine", choices=("torch", "echo"), default="torch")
    p.add_argument("--device", default="cuda",
                   help="torch device of --engine torch (cuda | cpu)")
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--component", default="backend")
    p.add_argument("--store", default="127.0.0.1:4222")
    p.add_argument("--advertise-host", default=None)
    p.add_argument("--model-path", default=None)
    p.add_argument("--model-name", default=None)
    p.add_argument("--register-model", action="store_true")
    p.add_argument("--kv-block-size", type=int, default=64)
    p.add_argument("--metrics-interval", type=float, default=1.0)
    p.add_argument("--echo-slots", type=int, default=64,
                   help="advertised request slots of the echo engine "
                        "(its occupancy signal for the planner)")
    p.add_argument("--enable-disagg", action="store_true",
                   help="decode role with conditional remote prefill")
    p.add_argument("--max-local-prefill-length", type=int, default=1000,
                   help="with --enable-disagg: prefill prompts longer "
                        "than this (minus prefix hits) remotely")
    p.add_argument("--max-prefill-queue-size", type=int, default=2,
                   help="with --enable-disagg: remote only while the "
                        "prefill queue is shorter than this")
    p.add_argument("--remote-prefill-timeout", type=float, default=120.0,
                   help="seconds to wait for remote KV before prefilling "
                        "locally")
    p.add_argument("--extra-engine-args", default=None,
                   help="inline JSON engine kwargs")
    p.add_argument("--num-nodes", type=int, default=1,
                   help="multi-node worker (above 1 raises until the "
                        "multi-GPU slice)")
    return p.parse_args(argv)


def main() -> None:
    from ..utils.logging_ext import init_logging

    init_logging()
    args = parse_args()
    check_ported(args)
    # Worker shell: SIGINT/SIGTERM cancel the root token; the runtime
    # deregisters first (lease revoke), in-flight requests get the grace
    # window, then stop and kill; the engine shuts down last
    from ..runtime.worker import Worker

    shell = Worker()

    async def app(token):
        # the engine first: no lease exists while its bring-up holds the
        # process (ROADMAP Queue 3 item 8)
        engine = await build_engine(args)
        drt = await _connect_drt(args)
        shell.add_runtime(drt)
        await run_worker(args, drt=drt, token=token, engine=engine)

    try:
        shell.execute(app)
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
