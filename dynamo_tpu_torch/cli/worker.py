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

Not ported yet, and refused at start instead of ignored: ``--enable-disagg``
(ROADMAP Queue 1 item 6), ``DYN_KV_CLUSTER`` (item 8) and ``--num-nodes``
above 1 (item 11); a model-mobility swap or prefetch command (item 12) is
refused in the log and left for another worker.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
from typing import Optional

from ..llm.kv_router.protocols import KV_EVENT_SUBJECT, ForwardPassMetrics
from ..llm.kv_router.publisher import KvEventPublisher
from ..llm.kv_router.router import check_kv_cluster_off
from ..llm.metrics_aggregator import metrics_key
from ..llm.model_card import ModelDeploymentCard
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
    if getattr(args, "enable_disagg", False):
        raise NotImplementedError(
            "--enable-disagg: disaggregated prefill/decode (llm/disagg.py, "
            "llm/kv_transfer.py) is not ported to dynamo_tpu_torch yet "
            "(ROADMAP Queue 1 item 6)")
    if getattr(args, "num_nodes", 1) > 1:
        raise NotImplementedError(
            "--num-nodes above 1: multi-node serving (parallel/) is not "
            "ported to dynamo_tpu_torch yet (ROADMAP Queue 1 item 11)")
    check_kv_cluster_off()


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
    return TorchEngineConfig.from_card(card, **extra)


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


def engine_counters(core, worker_id: int) -> dict:
    """This worker's engine dispatches and kernel launches as a stage-dump
    fragment, published beside the stage registry: a frontend's
    ``/metrics`` then shows, per worker, that its prefills and decode steps
    ran (``dyn_engine_dispatches_total{kind}``) and went through the
    hand-written kernels (``dyn_kernel_launches_total{kernel}``; these
    count on the card only), and on the card its peak device memory
    (``dyn_device_memory_peak_bytes``). Port-only series: the JAX worker
    publishes none of them."""
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
    if core.device.type == "cuda":
        import torch

        r.gauge("dyn_device_memory_peak_bytes",
                "Peak device memory allocated by this worker's process",
                ("worker",)).set(wid, value=float(
                    torch.cuda.max_memory_allocated(core.device)))
    return r.state_dump()


async def run_worker(args, *, ready_event: Optional[asyncio.Event] = None,
                     drt: Optional[DistributedRuntime] = None,
                     token=None) -> None:
    check_ported(args)
    own_drt = drt is None
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
    card = _build_card(args)
    core = None
    if args.engine == "torch":
        from ..engine.engine import TorchEngine

        cfg = _engine_cfg(args, card)
        # engine bring-up (weights to the card, the kernels' build and
        # probe) takes far longer than the lease TTL: run it off the event
        # loop so lease keepalives keep flowing
        engine = await asyncio.get_running_loop().run_in_executor(
            None, lambda: TorchEngine(cfg))
        core = engine.core
    else:
        from ..llm.engines import EchoCoreEngine

        engine = EchoCoreEngine()

    # --- KV event publishing -----------------------------------------
    async def publish(subject, payload):
        await component.publish(subject, payload)

    pub = KvEventPublisher(worker_id=drt.worker_id, publish=publish,
                           subject=KV_EVENT_SUBJECT)
    await pub.start()
    if core is not None:
        core.pool.on_block_sealed = pub.block_stored
        core.pool.on_blocks_removed = pub.blocks_removed

    # --- serve endpoint ----------------------------------------------
    # worker-ingress overload gate (DYN_WORKER_SLOTS / DYN_WORKER_QUEUE_
    # DEPTH, unset = off): excess load fails fast as a typed 429 naming
    # this stage instead of queueing into a deadline burn
    gate = overload.gate_from_env()
    endpoint = component.endpoint("generate")
    served = engine if gate is None else overload.SlotGatedEngine(engine,
                                                                  gate)
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
                   help="decode role with remote prefill (raises until "
                        "the disaggregation slice)")
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
        drt = await _connect_drt(args)
        shell.add_runtime(drt)
        await run_worker(args, drt=drt, token=token)

    try:
        shell.execute(app)
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
