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

On the simple serving path (no disagg, no cluster KV, one node) a
:class:`~..fleet.mobility.MobilityAgent` follows the fleet's
``mobility/`` commands, as the JAX worker's does: it stages prefetch-hinted
sibling checkpoints into a host weight cache (pinned on a card), and a swap
command drains the worker, overwrites its weights in place
(``TorchEngine.swap_weights``) and re-registers it under the sibling's
component — or, on a typed refusal, rebuilds the engine cold after freeing
the old one's device memory. Either way the rebuild runs while the worker
holds no lease. A tensor-parallel worker swaps each rank's own shard, and
its cold reload ends the rank group and starts a new one on the new
model (:func:`reload_engine`).

With ``--tp N`` the worker is tensor-parallel over N ranks, one process a
rank (``parallel/``, the JAX multi-host worker's model): this process is
rank 0, the leader, which builds its engine, starts the host's other
``N / --num-nodes`` ranks as follower processes of this same module
(``--local-rank``), waits for them on the dispatch channel, and only then
takes its lease and serves. A node of ``--node-rank`` above 0 serves
nothing: it runs its ranks as followers of the leader at
``--coordinator``. ``--devices`` lists the card of each local rank (a card
may repeat: ranks then share it over ``--dist-backend gloo``; NCCL refuses
two ranks on one GPU). A one-node tp worker keeps prefix reuse, the host
and disk tiers, ``--enable-disagg``, ``DYN_KV_CLUSTER`` and speculative
decoding, the KV paging lane, image models and model mobility: the
leader plans, and each device change is a frame its followers replay, the
bytes moving through a host collective (``engine/engine.py``). Across
nodes (``--num-nodes`` above 1) prefix reuse and the tiers are off, and
the worker runs no mobility agent, as the JAX multi-host worker sets
them.

Not ported yet, and refused at start instead of ignored: ``--num-nodes``
above 1 with ranks that are not tp ranks (pp, sp, ep across nodes: ROADMAP
Queue 1 item 11b).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import time
from dataclasses import dataclass
from typing import List, Optional

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


def check_ported(args) -> None:
    """Raise, naming the ROADMAP item, for options whose JAX code paths the
    port does not have yet."""
    tp, nodes = getattr(args, "tp", 1), getattr(args, "num_nodes", 1)
    if nodes > 1 and (tp < nodes or tp % nodes):
        raise NotImplementedError(
            f"--num-nodes {nodes} with --tp {tp}: the ranks of a multi-node "
            f"worker are tp ranks, tp/num-nodes on each node; other axes "
            f"across nodes (pp, sp, ep) are not ported to dynamo_tpu_torch "
            f"yet (ROADMAP Queue 1 item 11b)")
    if tp > 1 and getattr(args, "engine", "torch") != "torch":
        raise ValueError("--tp above 1 needs --engine torch")


@dataclass
class RankLayout:
    """Where one worker's tp ranks run and how they meet: the fields of
    the worker's tp flags (``--tp``, ``--device``, ``--dist-backend``,
    ``--devices``, ``--num-nodes``, ``--node-rank``, ``--local-rank``,
    ``--coordinator``, ``--dispatch-port``). ``cli.run`` fills the first
    four for one node."""

    tp: int
    device: str = "cuda"
    backend: Optional[str] = None
    devices: Optional[str] = None
    num_nodes: int = 1
    node_rank: int = 0
    local_rank: int = 0
    coordinator: Optional[str] = None
    dispatch_port: Optional[int] = None

    @classmethod
    def of(cls, args) -> "RankLayout":
        return cls(args.tp, args.device, args.dist_backend, args.devices,
                   args.num_nodes, args.node_rank, args.local_rank,
                   args.coordinator, args.dispatch_port)

    @property
    def local_ranks(self) -> int:
        """Ranks each node runs."""
        return max(1, self.tp // max(1, self.num_nodes))

    @property
    def rank(self) -> int:
        """This process's global rank."""
        return self.node_rank * self.local_ranks + self.local_rank

    @property
    def dist_backend(self) -> str:
        """``--dist-backend``, else NCCL on a card and gloo on the CPU."""
        if self.backend:
            return self.backend
        return "gloo" if self.device == "cpu" else "nccl"

    @property
    def device_list(self) -> Optional[List[int]]:
        return ([int(x) for x in self.devices.split(",")] if self.devices
                else None)

    def rendezvous(self) -> str:
        """The process group's ``host:port`` (one node: a free local port,
        chosen once)."""
        if not self.coordinator:
            if self.num_nodes > 1:
                raise SystemExit("--num-nodes above 1 needs --coordinator "
                                 "host:port (rank 0's node)")
            from ..parallel.multihost import free_port

            self.coordinator = f"127.0.0.1:{free_port()}"
        return self.coordinator

    def channel_port(self) -> int:
        """The leader's dispatch port (one node: a free port, chosen
        once)."""
        if self.dispatch_port is None:
            if self.num_nodes > 1:
                raise SystemExit("--num-nodes above 1 needs --dispatch-port")
            from ..parallel.multihost import free_port

            self.dispatch_port = free_port()
        return self.dispatch_port

    def join(self):
        """Join the process group on this rank's device; its mesh."""
        from ..parallel.mesh import rank_device, serving_mesh
        from ..parallel.multihost import init_distributed

        devices = self.device_list
        init_distributed(self.rendezvous(), self.tp, self.rank,
                         self.dist_backend,
                         device=rank_device(self.device, self.local_rank,
                                            devices))
        return serving_mesh(self.tp, rank=self.rank,
                            local_rank=self.local_rank, device=self.device,
                            devices=devices)


def check_rank_devices(p, layout: RankLayout) -> None:
    """The local ranks' cards, at parse time: a usage error rather than a
    fault in a spawned rank."""
    if layout.tp <= 1 or layout.device == "cpu":
        return
    n, devs = layout.local_ranks, layout.device_list
    if devs is not None:
        if len(devs) < n:
            p.error(f"--devices lists {len(devs)} card(s) for {n} local "
                    f"ranks")
        if layout.dist_backend == "nccl" and len(set(devs[:n])) < n:
            p.error("NCCL refuses two ranks on one GPU; share a card over "
                    "--dist-backend gloo")
        return
    import torch

    have = torch.cuda.device_count()
    if have < n:
        p.error(f"--tp {layout.tp} runs {n} ranks on this node but it has "
                f"{have} CUDA device(s); list the cards with --devices "
                f"(e.g. --devices 0,0 --dist-backend gloo puts two ranks on "
                f"one card)")


def follower_argv(layout: RankLayout, *, model_path: Optional[str],
                  model_name: Optional[str], kv_block_size: int,
                  engine_args: Optional[str]) -> list:
    """The ``cli.worker`` arguments of this node's other ranks: the same
    model, engine, layout and rendezvous as this process."""
    argv = ["--engine", "torch", "--device", layout.device,
            "--tp", str(layout.tp), "--num-nodes", str(layout.num_nodes),
            "--node-rank", str(layout.node_rank),
            "--coordinator", layout.rendezvous(),
            "--dispatch-port", str(layout.channel_port()),
            "--dist-backend", layout.dist_backend,
            "--kv-block-size", str(kv_block_size)]
    if layout.devices:
        argv += ["--devices", layout.devices]
    if model_path:
        argv += ["--model-path", model_path]
    if model_name:
        argv += ["--model-name", model_name]
    if engine_args:
        argv += ["--extra-engine-args", engine_args]
    return argv


def start_ranks(layout: RankLayout, *, model_path: Optional[str] = None,
                model_name: Optional[str] = None, kv_block_size: int = 64,
                engine_args: Optional[str] = None):
    """The leader's side of bring-up (rank 0, before its engine): start
    this node's other ranks on the model and engine arguments given, join
    the process group, open the dispatch channel. Returns the
    :class:`~..parallel.multihost.LeaderPlane` whose ``mesh`` the engine
    takes."""
    from ..parallel.multihost import (DispatchPublisher, LeaderPlane,
                                      spawn_local_followers)

    argv = follower_argv(layout, model_path=model_path,
                         model_name=model_name, kv_block_size=kv_block_size,
                         engine_args=engine_args)
    ranks = spawn_local_followers(argv, range(1, layout.local_ranks))
    try:
        mesh = layout.join()
        # one node: the followers dial loopback
        publisher = DispatchPublisher(
            layout.channel_port(), layout.tp - 1,
            host="127.0.0.1" if layout.num_nodes == 1 else "0.0.0.0")
    except BaseException:
        for p in ranks.procs:
            p.kill()
        raise
    return LeaderPlane(mesh, publisher, ranks)


def tp_extra(num_nodes: int, extra: dict) -> dict:
    """Across nodes (``num_nodes`` above 1), what the JAX multi-host worker
    forces off (its ``cli/worker.py``): prefix reuse and the host and disk
    tiers. One node keeps them at every tp."""
    if num_nodes > 1:
        extra.update(enable_prefix_reuse=False, host_cache_blocks=0,
                     disk_cache_blocks=0)
    return extra


def tp_engine(layout: RankLayout, card: ModelDeploymentCard, extra: dict, *,
              model_path: Optional[str] = None,
              model_name: Optional[str] = None, kv_block_size: int = 64):
    """The leader's :class:`TorchEngine` of ``layout``'s ranks on one node
    (``cli.run --tensor-parallel-size``, ``cli.prefill_worker --tp``):
    start the others as ``cli.worker`` followers with this engine's
    arguments, then build the rank-0 engine, which returns once every
    follower joined. ``model_name`` is the name the followers build their
    card from."""
    import dataclasses

    from ..engine.engine import TorchEngine, TorchEngineConfig

    cfg = TorchEngineConfig.from_card(card, **extra)
    # the followers' cards lack the caller's --context-length: they take
    # the resolved max_context
    plane = start_ranks(layout, model_path=model_path, model_name=model_name,
                        kv_block_size=kv_block_size,
                        engine_args=json.dumps(dict(
                            extra, max_context=cfg.max_context)))
    try:
        return TorchEngine(dataclasses.replace(cfg, tp=layout.tp,
                                               mesh=plane.mesh), plane=plane)
    except BaseException:
        plane.close()
        raise


def group_starter(layout: RankLayout, *, kv_block_size: int = 64,
                  engine_args: Optional[str] = None):
    """The ``start_plane`` of :func:`reload_engine` for ``layout``'s ranks
    on one node: a new group on a fresh rendezvous and dispatch channel,
    whose followers build the model of ``cfg`` (its checkpoint, else its
    seed) on ``engine_args`` at the leader's resolved context."""
    import dataclasses

    def start(cfg):
        fresh = dataclasses.replace(layout, coordinator=None,
                                    dispatch_port=None)
        extra = json.loads(engine_args) if engine_args else {}
        return start_ranks(fresh, model_path=cfg.params_path,
                           kv_block_size=kv_block_size,
                           engine_args=json.dumps(dict(
                               extra, max_context=cfg.max_context,
                               seed=cfg.seed)))
    return start


def reload_engine(old, new_cfg, start_plane=None):
    """The cold reload (a refused swap's fallback): shut ``old`` down and
    give its device memory back first (two 8B engines plus their KV do not
    fit one card with headroom), then build the engine of ``new_cfg``. A
    tensor-parallel ``old`` sends its followers the ``shutdown`` frame and
    waits for them to exit; ``start_plane(new_cfg)`` then starts the new
    rank group (:func:`start_ranks`) whose mesh the new leader takes."""
    import dataclasses

    from ..engine.engine import TorchEngine

    try:
        old.shutdown()
    except Exception:  # noqa: BLE001 - the reload must go on
        log.exception("engine shutdown during reload")
    old.core.release_device()
    if start_plane is None:
        return TorchEngine(new_cfg)
    plane = start_plane(new_cfg)
    try:
        return TorchEngine(dataclasses.replace(
            new_cfg, tp=plane.mesh.tp, mesh=plane.mesh), plane=plane)
    except BaseException:
        plane.close()
        raise


def _build_card(args) -> ModelDeploymentCard:
    if args.model_path:
        card = ModelDeploymentCard.resolve(args.model_path, args.model_name)
    else:
        card = ModelDeploymentCard.synthetic(args.model_name or "echo")
    card.kv_block_size = args.kv_block_size
    return card


def _engine_cfg(args, card: ModelDeploymentCard, mesh=None):
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
    return TorchEngineConfig.from_card(
        card, tensor_parallel=getattr(args, "tp", 1), mesh=mesh,
        **tp_extra(getattr(args, "num_nodes", 1), extra))


def make_engine(args, card: Optional[ModelDeploymentCard] = None):
    """The worker's engine, built on the calling thread: a
    :class:`TorchEngine` (``--engine torch``) or the echo engine. At
    ``--tp`` above 1 this is the leader's: its ranks are started first
    (:func:`start_ranks`) and it returns once every follower joined."""
    if args.engine != "torch":
        from ..llm.engines import EchoCoreEngine

        return EchoCoreEngine()
    from ..engine.engine import TorchEngine

    card = card or _build_card(args)
    if getattr(args, "tp", 1) <= 1:
        return TorchEngine(_engine_cfg(args, card))
    plane = start_ranks(RankLayout.of(args), model_path=args.model_path,
                        model_name=args.model_name,
                        kv_block_size=args.kv_block_size,
                        engine_args=args.extra_engine_args)
    try:
        return TorchEngine(_engine_cfg(args, card, plane.mesh), plane=plane)
    except BaseException:
        plane.close()
        raise


def run_follower(args) -> None:
    """A follower rank (``--node-rank`` above 0, or ``--local-rank``
    above 0): join the process group, build this rank's engine, replay the
    leader's dispatches until it shuts down (exit 0) or is lost (raises).
    The first rank of a follower node starts the node's other ranks."""
    from ..engine.engine import EngineCore
    from ..parallel.multihost import FollowerLoop, spawn_local_followers

    layout = RankLayout.of(args)
    ranks = None
    if layout.local_rank == 0:
        ranks = spawn_local_followers(
            follower_argv(layout, model_path=args.model_path,
                          model_name=args.model_name,
                          kv_block_size=args.kv_block_size,
                          engine_args=args.extra_engine_args),
            range(1, layout.local_ranks))
    mesh = layout.join()
    core = EngineCore(_engine_cfg(args, _build_card(args), mesh))
    leader_host = layout.rendezvous().rsplit(":", 1)[0]
    log.info("tp rank %d/%d on %s: following the leader at %s:%d",
             layout.rank, layout.tp, mesh.device, leader_host,
             layout.channel_port())
    try:
        FollowerLoop(core, leader_host, layout.channel_port()).run()
    finally:
        core.close()
    if ranks is not None:
        ranks.close()


async def build_engine(args, card: Optional[ModelDeploymentCard] = None):
    """:func:`make_engine` on an executor thread. A caller that can builds
    it before it connects to the store: the engine module's import (the
    process's first ``import torch``) and the bring-up compete with the
    event loop for the interpreter lock for seconds on a busy host; with
    no lease granted yet there is no keepalive to starve."""
    return await asyncio.get_running_loop().run_in_executor(
        None, lambda: make_engine(args, card))


async def _connect_drt(args) -> DistributedRuntime:
    host, port = args.store.split(":")
    return await DistributedRuntime(
        store_host=host, store_port=int(port),
        advertise_host=args.advertise_host).connect()


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
    (``dyn_kv_writethrough_*_total``). A tensor-parallel worker adds each
    follower rank's dispatches, launches and peak memory, and every
    rank's weight bytes (``dyn_weight_bytes``) and swap bytes and
    seconds, from the counters the
    leader last gathered (``EngineCore.rank_stats``), under the worker
    label ``{worker}/rank{r}``.
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
    ranks = core.rank_stats[1:] if core.tp > 1 else []
    for rank, st in enumerate(ranks, start=1):
        rid = f"{wid}/rank{rank}"
        d.inc(rid, "prefill", amount=st["prefill_dispatches"])
        d.inc(rid, "decode", amount=st["decode_dispatches"])
        d.inc(rid, "decode_step", amount=st["decode_steps"])
        k.inc(rid, "flash_attention", amount=st["flash_launches"])
        k.inc(rid, "paged_attention", amount=st["paged_launches"])
    if core.tp > 1:
        w = r.gauge("dyn_weight_bytes", "Weight bytes on this rank's device",
                    ("worker",))
        rank_counters = [
            (r.counter("dyn_weight_swap_bytes_total",
                       "Weight bytes this rank overwrote in hot swaps",
                       ("worker",)), "swap_bytes"),
            (r.counter("dyn_weight_swap_seconds_total",
                       "Seconds of this rank's swap streams, each to its "
                       "barrier", ("worker",)), "swap_seconds")]
        for rank, st in enumerate(core.rank_stats):
            label = wid if rank == 0 else f"{wid}/rank{rank}"
            w.set(label, value=st["weight_bytes"])
            for c, key in rank_counters:
                c.inc(label, amount=st[key])
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

        peak = r.gauge("dyn_device_memory_peak_bytes",
                       "Peak device memory allocated by this worker's "
                       "process", ("worker",))
        peak.set(wid, value=float(torch.cuda.max_memory_allocated(
            core.device)))
        for rank, st in enumerate(ranks, start=1):
            peak.set(f"{wid}/rank{rank}",
                     value=st["device_memory_peak_bytes"])
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
    engine_ref = None         # set on the simple path (model mobility)
    served = None
    if getattr(args, "enable_disagg", False) and core is not None:
        await endpoint.serve(await _disagg_handler(args, drt, component,
                                                   engine, gate, cluster))
    else:
        # model mobility (simple path only: no disagg/cluster/multi-node —
        # those keep the plain cold-spawn wake): handlers stream through
        # an EngineRef so a cold-reload fallback can rebind the engine
        if core is not None and cluster is None and args.num_nodes == 1:
            from ..fleet.mobility import EngineRef

            engine_ref = EngineRef(engine)
        base = engine_ref if engine_ref is not None else engine
        served = base if gate is None \
            else overload.SlotGatedEngine(base, gate)
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

    # --- metrics loop -------------------------------------------------
    from ..llm.metrics_aggregator import StagePublisher

    stage_pub = StagePublisher(drt.store, args.namespace, args.component,
                               drt.worker_id, drt.lease)

    # --- model mobility agent (simple path only) ---------------------
    mobility = None
    stopped = asyncio.Event()     # set when a failed swap ends the worker
    if engine_ref is not None:
        from ..fleet.mobility import MobilityAgent

        async def _reregister(payload):
            """Post-swap identity change: fresh lease (prepare_drain
            revoked the old one), serve ``generate`` under the new
            model's component, re-advertise the model, and move the
            metrics/KV-event identity along."""
            nonlocal component, card, stage_pub
            import os

            drt.lease = await drt.store.lease_grant(
                ttl=float(os.environ.get("DYN_LEASE_TTL", "10.0")))
            drt.worker_id = drt.lease
            drt.draining.clear()
            if token is not None:
                drt.store.on_lease_lost = _lease_lost
            args.component = payload.get("component") or args.component
            args.model_path = payload.get("model_path") or args.model_path
            args.model_name = payload.get("model") or args.model_name
            component = ns.component(args.component)
            pub.worker_id = drt.worker_id
            card = _build_card(args)
            await serve_core_engine(component.endpoint("generate"),
                                    served)
            if args.register_model:
                ep_path = component.endpoint("generate").path
                await register_model(drt.store, card, ep_path,
                                     model_type="chat", lease=drt.lease)
                await register_model(drt.store, card, ep_path,
                                     model_type="completion",
                                     lease=drt.lease)
            stage_pub = StagePublisher(drt.store, args.namespace,
                                       args.component, drt.worker_id,
                                       drt.lease)
            log.info("worker %x re-registered as %s (%s)",
                     drt.worker_id, args.model_name, args.component)

        async def _cold_reload(new_cfg):
            """Typed swap-fallback: rebuild the engine off-loop (the
            weight load can exceed the lease TTL; the agent drained, so
            no lease is live) and re-attach the KV event hooks
            (:func:`reload_engine`; at tp > 1 a new rank group on the
            new model). The EngineRef rebinding is the agent's job."""
            nonlocal engine, core
            old = engine_ref.engine
            core = None           # the metrics beat reads no dead core
            start_plane = None
            if args.tp > 1:
                start_plane = group_starter(
                    RankLayout.of(args), kv_block_size=args.kv_block_size,
                    engine_args=args.extra_engine_args)
            new_engine = await asyncio.get_running_loop(
                ).run_in_executor(None, reload_engine, old, new_cfg,
                                  start_plane)
            engine = new_engine
            core = new_engine.core
            core.pool.on_block_sealed = pub.block_stored
            core.pool.on_blocks_removed = pub.blocks_removed
            return new_engine

        def _swap_failed():
            """A swap that failed past the drain left no lease and
            possibly no engine: end the worker so its orchestrator reaps
            it and releases its cards, instead of a zombie that holds
            them."""
            log.critical("model swap failed after the drain; shutting "
                         "down")
            if token is not None:
                token.cancel()
            stopped.set()

        mobility = await MobilityAgent(
            drt, args.namespace, args.component, engine_ref,
            reregister=_reregister, cold_reload=_cold_reload,
            model_name=args.model_name or "",
            on_fatal=_swap_failed).start()

    async def metrics_loop():
        while True:
            # recomputed per beat: a model swap moves this worker to a
            # new component + lease mid-life
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
            await stopped.wait()
    finally:
        try:
            drt.store.on_lease_lost = None
            mtask.cancel()
            await obs_handle.stop()
            try:
                await span_sink.stop()
            except Exception:
                log.warning("span sink final flush failed; tail spans "
                            "lost", exc_info=True)
            await pub.stop()
            # deregistration cleanup: drop the published metric snapshots
            # so aggregators stop rendering a ghost worker when a shared
            # runtime outlives this serve loop
            from ..llm.metrics_aggregator import clear_worker_keys

            try:
                await clear_worker_keys(drt.store, args.namespace,
                                        args.component, drt.worker_id)
            except asyncio.CancelledError:
                # the Worker shell closed our runtime at a signal: its
                # store cancels the call, and nothing is left to drop
                closed = getattr(drt.store, "closed", None)
                if closed is None or not closed.is_set():
                    raise
                log.debug("metric keys not cleared: the runtime is closed")
            except Exception:
                log.warning("metric keys not cleared; aggregators may "
                            "show a ghost worker", exc_info=True)
            if cluster is not None:
                try:
                    await cluster.stop()   # cancel publisher, drop registry
                except Exception:
                    log.warning("kv-cluster detach failed", exc_info=True)
        finally:
            # whatever failed above (a store call on the runtime the
            # Worker shell closed ends cancelled), the engine shuts down:
            # a tp leader's followers take its shutdown frame and exit 0
            if mobility is not None:
                mobility.cache.close()     # drop pinned host weight trees
            if core is not None:
                try:
                    engine.shutdown()   # joins the engine thread, clears
                except Exception:       # gauges
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
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks, one process each")
    p.add_argument("--num-nodes", type=int, default=1,
                   help="nodes the tp ranks span (tp/num-nodes a node)")
    p.add_argument("--node-rank", type=int, default=0,
                   help="this node's index; node 0 holds the leader")
    p.add_argument("--local-rank", type=int, default=0,
                   help="the rank within this node (set by the node's first "
                        "rank for the ranks it starts)")
    p.add_argument("--coordinator", default=None,
                   help="host:port of the process group's rendezvous on "
                        "node 0 (one node: a free local port)")
    p.add_argument("--dispatch-port", type=int, default=None,
                   help="the leader's dispatch channel port (one node: a "
                        "free port)")
    p.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                   help="collectives' backend (nccl on a card, gloo on "
                        "--device cpu); gloo lets ranks share a card")
    p.add_argument("--devices", default=None,
                   help="comma list of each local rank's CUDA device "
                        "(default: rank j on cuda:j; a card may repeat)")
    args = p.parse_args(argv)
    if args.engine == "torch":
        check_rank_devices(p, RankLayout.of(args))
    return args


def main() -> None:
    from ..utils.logging_ext import init_logging

    init_logging()
    args = parse_args()
    check_ported(args)
    if args.node_rank > 0 or args.local_rank > 0:
        run_follower(args)
        return
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
