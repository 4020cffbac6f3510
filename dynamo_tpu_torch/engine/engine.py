"""The in-tree torch engine: continuous batching over a paged KV pool.

Architecture:
- A synchronous :class:`EngineCore` owns all mutable state (slots, page
  tables, sampling state, the KV pools) and is driven from one engine thread
  — the single-owner actor discipline the reference uses for its schedulers.
- Each iteration admits waiting requests and runs ONE batched prefill
  dispatch that advances every mid-prefill sequence by one chunk (flash
  attention over the gathered context), then enqueues ONE decode dispatch of
  ``decode_steps`` autoregressive steps over every decode-ready sequence
  (paged attention straight off the pool). Sampling and penalties run on the
  device; each dispatch fetches one packed (token, logprob) tensor to the
  host.
- Decode is pipelined as in the JAX engine: a decode dispatch's results are
  fetched one iteration later, while the next dispatch, chained off the
  previous one's tokens on the device, is already enqueued. Its host inputs
  go to the card through pinned memory without a host sync, so the fetch's
  round trip and the host's accounting overlap the card's work.
- KV block manager, on by default as in the JAX engine: full pages seal
  under the xxh3-64 block-hash chain and park as reusable when their
  sequence ends; admission claims the longest cached prefix of the prompt
  (``_restore_prefix``), uploading blocks from the host/disk tiers
  (``host_cache_blocks``, ``disk_cache_blocks``) where the device pool
  evicted them. Evicted pages are offloaded right before the next dispatch
  that could overwrite them (``_flush_evictions``). The pool's seal/evict
  hooks are where a KV event publisher attaches.
- :class:`TorchEngine` is the asyncio facade implementing the AsyncEngine
  contract (BackendInput -> stream of EngineOutput).
- Observability, as in the JAX engine and on the engine thread: the process
  ``StageMetrics`` (``llm_decode_step_seconds`` per fetched decode
  dispatch, ``llm_batch_occupancy``, the goodput gauges ``dyn_mfu`` /
  ``dyn_mbu`` / ``dyn_hbm_gbps`` from ``utils/roofline.GoodputMeter``),
  flight-recorder heartbeats and events around each decode dispatch, and
  ``DYN_PROFILE_DIR`` / ``DYN_PROFILE_STEPS``: a ``torch.profiler`` Chrome
  trace of the first working iterations. All of it reads the host clock
  times the engine already takes (the prefill's first-token fetch, the
  decode dispatch's event-waited fetch): no host sync is added.

- Disaggregated prefill, as in the JAX engine: ``prefill_extract`` runs
  a prompt's chunked prefill and gathers its KV to the host for a prefill
  worker; a decode worker enters a remotely prefilled sequence straight
  into decode, either from whole arrays (``inject_prefilled``) or layer by
  layer as the KV arrives (``begin_stream_inject`` ... ``finish_stream_
  inject``, driven through :class:`KvIngest`), each group of layers going
  to the card through pinned staging without a host sync.
- Speculative decoding, as in the JAX engine (``spec="ngram"|"draft"`` or
  ``DYN_SPEC``): each round a proposer (:mod:`.spec`) drafts up to k tokens
  a lane, ONE forward over the k+1 positions (the flash kernel) verifies
  them, and :func:`~.sampling.spec_verify` samples acceptance on the device
  for one packed fetch. Rounds are synchronous: there is no in-flight
  window in this mode.
- Cluster KV sharing (``llm/kv_cluster``), as in the JAX engine: with
  ``cluster_writethrough`` every newly sealed block is mirrored to the host
  tier once its KV is in the pool (``_advance_writethrough``: a pinned
  copy under an event, taken by the tier at a later step boundary, so a
  chained enqueue takes no host sync), and ``stage_prefetch`` uploads a
  queued request's tier-resident prefix on a side stream while it waits
  at the slot gate; admission scatters the staged blocks after waiting on
  the upload's event (``_restore_prefix``).

- Gemma3 VLM image requests, as in the JAX engine: admission validates
  the prompt's image spans, runs the SigLIP tower and projector once per
  request (``_encode_images``; the soft tokens stay on the device) and
  salts the block-hash chain with the frontend's ``kv_salt`` (else a
  digest of the normalized pixels); the chunker never splits an image
  span (``multimodal.chunk_end``); a prefill dispatch whose chunks carry
  an image span runs ``attn_impl="dense"`` with the soft tokens as an
  embedding override and the same-image or-mask (``image_waves`` counts
  them), while text waves keep the flash kernel and decode the paged one.
- Mixture-of-Experts models (Mixtral) through ``models/moe.py``: sorted
  dispatch on prefill chunks, dense (sync-free) dispatch on decode.
- The long-context KV paging lane (``llm/kvpage``), as in the JAX engine:
  with ``kvpage_budget > 0`` (or ``DYN_KVPAGE_DEVICE_BUDGET``) and a host
  tier, a prompt over ``max_context`` or over the pool is routed to a
  :class:`~..llm.kvpage.runner.PagedEngine` at admission instead of
  refused; it holds at most ``budget`` pages of the shared pool, demotes
  sealed blocks into the pinned host tier and streams them back per
  layer, one unit of its work at the head of every ``step``.

- Tensor parallelism, Megatron-sharded, one process a rank
  (:mod:`..parallel`): a rank holds its cut of the weights and a pool of
  its kv heads, and the forwards sum the row-parallel products over the tp
  group. Rank 0 schedules; each dispatch is a host plan that only it
  makes and a device program (``_run_prefill_program``,
  ``_run_decode_program``) that every rank runs: ``dispatch_hook``
  receives each program's host inputs before it runs, and a follower
  replays them through :meth:`EngineCore.mirror_dispatch` (the JAX
  engine's multi-host model). Every state change a program makes comes
  from its frame, the lanes' uniforms included (the port's lane streams
  are host generators, so the frame carries their draws where the JAX
  engine's carries seeds). The KV block manager, disaggregation and
  speculative decoding keep that split: rank 0 plans on the host, and every
  KV copy is a frame every rank replays (``kv_offload``: each rank's d2h of
  evicted or mirrored pages, gathered on the leader into whole blocks for
  its tiers; ``kv_restore``: the leader's whole tier blocks scattered, each
  rank uploading its kv heads; ``kv_extract`` and ``kv_inject``: a
  sequence's KV gathered to, or scattered from, the leader's whole
  ``[L, T, Hkv, Dh]`` arrays; ``verify``: a speculative round's program).
  The bytes move through a host collective of the tp group
  (``parallel.collectives.gather_heads``/``scatter_heads``), not through
  the frames, so host blocks, the disagg wire and the tiers hold all kv
  heads as at tp=1. The tiers and the proposer (an n-gram table or a draft
  model, unsharded) are the leader's alone. So are the KV paging lane's
  plan and pager (its chunks and windows are ``kvpage_prefill`` and
  ``kvpage_decode`` frames, each segment scattered to the ranks at its
  upload step) and a VLM's tower (an image wave's frame carries the
  soft-token rows it reads). A weight swap overwrites every rank's own
  shard from its own host cut (``swap_prefetch``, ``swap_check``,
  ``swap``).

Not ported yet (the JAX engine has them): MoE checkpoints (neither
package's loader maps expert tensors) and pp/sp/ep.

Reference capability: the role vLLM/TRT-LLM play behind the reference's
adapters (continuous batching, paged KV, streaming detached tokens), per
SURVEY §7 step 3.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import glob
import logging
import os
import queue as thread_queue
import random
import tempfile
import threading
import time
from dataclasses import dataclass, fields, replace
from typing import (Any, AsyncIterator, Callable, Deque, Dict, List,
                    Optional, Tuple)

import numpy as np
import torch

from ..device import resolve_device, to_device
from ..llm.kvbm.tiers import DiskKvTier, HostKvTier, TieredKvCache
from ..llm.kvbm.transfer import (CopyStream, from_host_array, host_dtype,
                                 to_host_array)
from ..llm.model_card import ModelDeploymentCard
from ..llm.protocols.common import BackendInput, EngineOutput, FinishReason
from ..models import llama
from ..obs import flightrec as _flightrec
from ..parallel import collectives
from ..ops.attention import (check_kernel_support, flash_attention,
                             paged_attention)
from ..runtime.engine import AsyncEngine, Context, EngineError
from ..utils import roofline
from ..utils.prometheus import stage_metrics
from . import multimodal as mm
from .cache import OutOfPages, PagePool
from .loader import MOE_CHECKPOINT_GAP
from .sampling import (STATIC_K, apply_penalties, host_uniforms,
                       lane_generator, resume_seed, sample, spec_accept,
                       spec_uniforms, spec_unpack, spec_verify)
from .spec import SeqSpecState, build_proposer, resolve_spec

log = logging.getLogger("dynamo_tpu_torch.engine")

#: blocks one write-through gather moves at most: its pinned staging
#: buffer, allocated once at construction, holds this many
WT_STAGE_BLOCKS = 16

# JAX engine options this engine does not implement yet: asking for one
# raises instead of silently serving a different engine
_NOT_PORTED = frozenset({
    "sp", "ep", "pp", "prefill_lanes", "attn_impl", "warmup"})

#: the counters each tp rank contributes to ``EngineCore.rank_stats``
RANK_STATS = ("flash_launches", "paged_launches", "prefill_dispatches",
              "decode_dispatches", "decode_steps", "weight_bytes",
              "device_memory_peak_bytes", "spec_dispatches",
              "kv_restore_bytes", "kv_restore_seconds", "kv_offload_bytes",
              "kv_offload_seconds", "kvpage_pagein_bytes",
              "kvpage_pagein_seconds", "swap_bytes", "swap_seconds")

#: why tp > 1 needs a mesh: there is no single-controller SPMD in PyTorch
TP_NEEDS_RANKS = (
    "tp > 1 in one process: the port has no single-controller SPMD; each "
    "tensor-parallel rank is a process of its own with a mesh "
    "(parallel.mesh.serving_mesh). Serve with cli.worker --tp or cli.run "
    "--tensor-parallel-size, which start the ranks")


@dataclass
class TorchEngineConfig:
    model: llama.LlamaConfig
    page_size: int = 64
    max_batch: int = 8
    max_context: int = 2048
    prefill_chunk: int = 512
    num_pages: Optional[int] = None     # default: max_batch*max_context worth
    decode_steps: int = 8               # decode iterations per dispatch
    seed: int = 0
    preset: Optional[str] = None
    device: str = "cuda"
    # safetensors dir or GGUF file to load (None or no weights there:
    # random weights from the seed)
    params_path: Optional[str] = None
    # KV block manager: prefix reuse + tiered offload
    enable_prefix_reuse: bool = True
    host_cache_blocks: int = 0          # host-DRAM KV tier capacity (0 = off)
    disk_cache_blocks: int = 0          # mmap spill tier capacity (0 = off)
    disk_cache_path: Optional[str] = None
    # cluster KV sharing (llm/kv_cluster/): mirror every newly sealed block
    # to the host tier write-through, so peers can fetch hot prefixes that
    # never saw device-pool eviction pressure. Requires host_cache_blocks
    # > 0; the worker CLI turns it on with DYN_KV_CLUSTER=1
    cluster_writethrough: bool = False
    # speculative decoding (engine/spec.py). None => consult the DYN_SPEC*
    # env knobs; "" / "off" force-disables regardless of env
    spec: Optional[str] = None          # "ngram" | "draft" | "off"/None
    spec_k: Optional[int] = None        # max drafts/lane (None => DYN_SPEC_K)
    spec_draft: Optional[str] = None    # draft preset/dir (None => env)
    # KV paging (llm/kvpage/): serve contexts beyond max_context with
    # device residency bounded to a page budget: chunked prefill demotes
    # sealed blocks d2h, decode streams them back through staged uploads.
    # None => consult the DYN_KVPAGE_* env knobs; 0 disables. Needs
    # host_cache_blocks > 0 and does not compose with spec decoding
    # (checked at construction)
    kvpage_budget: Optional[int] = None      # device pages for the lane
    kvpage_seg_pages: Optional[int] = None   # blocks per staging segment
    kvpage_prefetch: Optional[int] = None    # segments prefetched ahead
    kvpage_max_context: Optional[int] = None  # paged context ceiling
    kvpage_batch: Optional[int] = None       # concurrent decode lanes
    # tensor parallelism: ranks, and this rank's mesh
    # (parallel.mesh.ServingMesh; its device replaces ``device``)
    tp: int = 1
    mesh: Optional[Any] = None

    @classmethod
    def from_card(cls, card: ModelDeploymentCard, tensor_parallel: int = 1,
                  mesh: Optional[Any] = None,
                  **extra) -> "TorchEngineConfig":
        gguf = _gguf_file(card.path) if card.path else None
        if card.model_config:
            moe = [k for k in ("num_local_experts", "num_experts")
                   if card.model_config.get(k)]
            if moe:
                raise NotImplementedError(
                    f"{card.path}: MoE checkpoint ({moe[0]}="
                    f"{card.model_config[moe[0]]}); {MOE_CHECKPOINT_GAP}")
            mcfg = llama.LlamaConfig.from_hf_config(card.model_config)
        elif extra.get("preset"):
            mcfg = llama.preset(extra["preset"])
        elif gguf:
            # GGUF cards carry no HF config dict — the model shape lives in
            # the container metadata; sizing from a preset here would build
            # sampler state (penalty counts) at the wrong vocab width
            from ..llm.gguf import read_gguf

            g = read_gguf(gguf)
            try:
                if g.metadata.get(f"{g.architecture()}.expert_count"):
                    raise NotImplementedError(
                        f"{gguf}: MoE checkpoint; {MOE_CHECKPOINT_GAP}")
                mcfg = g.llama_config()
            finally:
                g.close()
        else:
            mcfg = llama.preset("tiny-byte")
        kw: Dict[str, Any] = dict(model=mcfg, page_size=card.kv_block_size,
                                  params_path=card.path, tp=tensor_parallel,
                                  mesh=mesh)
        names = {f.name for f in fields(cls)} - {"model", "params_path",
                                                 "mesh"}
        for k, v in extra.items():
            if k in names:
                kw[k] = v
            elif k in _NOT_PORTED:
                raise NotImplementedError(
                    f"engine arg {k!r} is not supported by the torch engine "
                    f"yet")
            else:
                raise ValueError(f"unknown engine arg {k!r}")
        cfg = cls(**kw)
        if cfg.tp > 1 and cfg.mesh is None:
            raise NotImplementedError(TP_NEEDS_RANKS)
        cfg.max_context = min(cfg.max_context, card.context_length)
        return cfg


def _has_safetensors(path: str) -> bool:
    return os.path.isdir(path) and bool(
        glob.glob(os.path.join(path, "*.safetensors")))


def _gguf_file(path: str) -> Optional[str]:
    """The GGUF weights file for ``path``: the file itself or the first
    *.gguf inside the directory."""
    if os.path.isfile(path) and path.endswith(".gguf"):
        return path
    hits = sorted(glob.glob(os.path.join(path, "*.gguf")))
    return hits[0] if hits else None


@dataclass
class _Slot:
    seq_id: str
    request: BackendInput
    prompt: List[int]
    prefill_done: int = 0           # prompt tokens already in cache
    # leading tokens whose KV the pool holds once every enqueued dispatch
    # has run
    kv_written: int = 0
    generated: int = 0
    last_token: int = 0
    cum_logprob: float = 0.0
    cancelled: bool = False
    # physical tokens written after every ENQUEUED decode dispatch executes
    # (runs ahead of `generated`, which advances when results are fetched)
    sched_len: int = 0
    # VLM requests: per-position image-group ids and the projected soft
    # tokens on the device, flattened to [n_images * mm_tokens, D]
    mm_spans: Optional[np.ndarray] = None
    mm_soft: Optional[torch.Tensor] = None
    # at tp > 1 the leader's host copy of ``mm_soft`` (the model's host
    # dtype): an image wave's frame carries the rows it reads
    mm_host: Optional[np.ndarray] = None


@dataclass
class StepOutput:
    seq_id: str
    token: int
    logprob: float                  # cumulative over the sequence
    finish: Optional[FinishReason] = None
    prompt_tokens: int = 0
    error: Optional[str] = None     # cause when finish == ERROR
    token_logprob: float = 0.0      # this token's own logprob
    # typed-error fields (meaningful only with finish == ERROR)
    error_code: int = 500
    error_stage: Optional[str] = None
    error_reason: Optional[str] = None
    # first output only: prompt tokens admission restored from the KV
    # cache (device blocks + host/disk tiers) -> kv_prefix_hit_tokens
    prefix_hit: Optional[int] = None


class EngineCore:
    """Synchronous continuous-batching core. Single-threaded by contract.

    ``params`` (the tree of :func:`~dynamo_tpu_torch.models.llama.
    init_params`, on the engine's device) replaces the seeded random init,
    e.g. with weights converted by ``params_from_jax``. Without it the
    weights come from ``cfg.params_path`` when that holds a checkpoint (a
    directory of ``*.safetensors``, or a GGUF file), placed leaf by leaf
    through pinned staging (``engine/loader.py``), else from the seed.
    A VLM config's tower and projector likewise come from
    ``vision_params`` (the (tower, projector) trees of ``models/siglip``),
    else from the checkpoint's vision tensors, else from a generator seeded
    ``seed + 1``.
    """

    def __init__(self, cfg: TorchEngineConfig,
                 params: Optional[Dict[str, Any]] = None,
                 vision_params: Optional[Tuple[Dict[str, Any],
                                               Dict[str, Any]]] = None):
        self.cfg = cfg
        m = cfg.model
        self.tp = cfg.tp
        self.mesh = cfg.mesh
        if self.tp > 1 and (self.mesh is None or self.mesh.tp != self.tp):
            raise NotImplementedError(TP_NEEDS_RANKS)
        self.rank = self.mesh.tp_rank if self.tp > 1 else 0
        self.group = self.mesh.tp_group if self.tp > 1 else None
        self.device = (self.mesh.device if self.mesh is not None
                       else resolve_device(cfg.device))
        if self.device.type == "cuda":
            # the JAX engine's construction-time kernel check, without its
            # fallback: a model the CUDA kernels lack raises ValueError
            check_kernel_support(m.head_dim, m.dtype)
        self.page_size = cfg.page_size
        self.spec = resolve_spec(cfg)
        if self.tp > 1:
            self._check_tp()
        # the tp ranks' group for host tensors, and each rank's kv heads:
        # the KV collectives' layout
        self.host_group = self.mesh.host_group if self.tp > 1 else None
        self._kv_heads = [llama.kv_head_range(m, self.tp, r)
                          for r in range(self.tp)]
        self.enable_prefix_reuse = cfg.enable_prefix_reuse
        # every dispatch's device program: a hook receives its host inputs
        # before it runs (the leader's DispatchPublisher.hook)
        self.dispatch_hook: Optional[Callable[[str, Dict[str, Any],
                                               Dict[str, np.ndarray]],
                                              None]] = None
        # frames handed to the hook, and those whose program then returned
        # here: a failure between the two leaves followers that may wait
        # on a collective the leader will not run (TorchEngine ends the
        # worker)
        self.frames_out = 0
        self.frames_done = 0
        # the previous decode program's sampled tokens, on the device: a
        # chained decode program's input
        self._chain_tok: Optional[torch.Tensor] = None
        # a dispatch may overshoot a finishing sequence by up to
        # decode_steps tokens (or, under spec decode, k_max drafts + 1
        # bonus token): they land in its own pre-allocated pages
        overshoot = cfg.decode_steps
        if self.spec is not None:
            overshoot = max(overshoot, self.spec.k_max + 1)
        self._pad = -(-overshoot // cfg.page_size) * cfg.page_size
        self.max_pages_per_seq = -(-(cfg.max_context + self._pad)
                                   // cfg.page_size)
        num_pages = cfg.num_pages or (cfg.max_batch * self.max_pages_per_seq
                                      + 1)
        self.pool = PagePool(num_pages, cfg.page_size)
        tp, rank = self.tp, self.rank
        with torch.no_grad():
            if params is None and cfg.params_path and _has_safetensors(
                    cfg.params_path):
                from .loader import load_llama_params

                params = load_llama_params(cfg.params_path, m, self.device,
                                           tp, rank)
            elif params is None and cfg.params_path and (
                    gguf := _gguf_file(cfg.params_path)):
                from ..llm.gguf import load_llama_params_gguf

                _, params = load_llama_params_gguf(
                    gguf, cfg=m, device=self.device, dtype=m.dtype, tp=tp,
                    rank=rank)
            elif params is None:
                gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
                params = llama.init_params(m, gen, self.device, tp, rank)
                if self.device.type == "cuda":
                    # hand the draw's f32 transients back to the driver:
                    # tp ranks may share the card
                    torch.cuda.empty_cache()
            self.params = params
            self._build_vision_tower(vision_params)
            # head-major [L, Hkv, n_pages, page, Dh]: pool[l] is directly
            # the paged kernel's layout; page 0 is the scratch page. A tp
            # rank's pool holds its kv heads
            pool_shape = (m.num_layers, llama.local_kv_heads(m, tp),
                          num_pages, cfg.page_size, m.head_dim)
            self.k_pool = torch.zeros(pool_shape, dtype=m.dtype,
                                      device=self.device)
            self.v_pool = torch.zeros(pool_shape, dtype=m.dtype,
                                      device=self.device)
            # generated-token occurrence counts per lane (frequency /
            # presence penalties), reset when a sequence enters decode
            self.gen_counts = torch.zeros((cfg.max_batch, m.vocab_size),
                                          dtype=torch.int32,
                                          device=self.device)

        # --- KV block manager: tiered offload + prefix reuse ----------
        self.copy_stream = CopyStream()
        self.tiered: Optional[TieredKvCache] = None
        # the tiers hold whole blocks (all kv heads), on the leader alone
        if cfg.host_cache_blocks > 0 and self.rank == 0:
            blk_shape = (m.num_layers, m.num_kv_heads, cfg.page_size,
                         m.head_dim)
            np_dtype = host_dtype(m.dtype)
            host = HostKvTier(cfg.host_cache_blocks, blk_shape, np_dtype)
            disk = None
            if cfg.disk_cache_blocks > 0:
                # default path is per-process: two engines on one host must
                # not memmap the same spill files in w+ mode
                path = cfg.disk_cache_path or os.path.join(
                    tempfile.gettempdir(),
                    f"dynamo_tpu_torch_kv_spill.{os.getpid()}")
                disk = DiskKvTier(cfg.disk_cache_blocks, blk_shape, np_dtype,
                                  path)
            self.tiered = TieredKvCache(host, disk)
        self._evict_buf: List[Tuple[int, int]] = []
        self.pool.on_block_evicted = self._offload_evicted
        # cluster write-through: a block seals before the dispatch that
        # writes its last slot (a sampled token's KV lands when a later
        # step feeds it back), so the seal hook queues (hash, page, seq,
        # end token) and each step boundary mirrors the entries whose
        # sequence's kv_written reaches `end`: their writing dispatch is
        # already enqueued on this stream, ahead of the gather. The gather
        # lands in a pinned staging buffer under an event, one gather in
        # flight at a time; the tier takes it at a later boundary once the
        # event completed (no host sync, no pinned allocation a step)
        self._wt_pending: List[Tuple[int, int, str, int]] = []
        self._wt_copies: Deque[Dict[str, Any]] = collections.deque()
        self._wt_stage: Optional[List[torch.Tensor]] = None
        self.writethrough_blocks = 0
        self.writethrough_bytes = 0
        self.writethrough_seconds = 0.0  # the copies' own (device) time
        self.writethrough_enqueue_seconds = 0.0     # host clock
        if self.tiered is not None and cfg.cluster_writethrough:
            self.pool.add_seal_hook(self._writethrough_sealed)
            # at tp > 1 a mirror is a kv_offload frame, run at once: its
            # host gather syncs anyway, so there is nothing to stage
            if self.device.type == "cuda" and self.tp == 1:
                self._wt_stage = [torch.empty(
                    (WT_STAGE_BLOCKS, *self.k_pool[:, :, 0].shape),
                    dtype=m.dtype, pin_memory=True) for _ in range(2)]
                # the gather's first launch loads its kernels (a tenth of a
                # second on the card): pay that at bring-up, not on a step
                idx = torch.zeros(1, dtype=torch.long, device=self.device)
                for pool, stage in zip((self.k_pool, self.v_pool),
                                       self._wt_stage):
                    stage[:1].copy_(pool.index_select(2, idx)
                                    .permute(2, 0, 1, 3, 4))
                # dynalint: ok(host-sync) construction, once: the write-through
                # gather's first launch loads its kernels here instead of on a
                # step
                torch.cuda.synchronize(self.device)
        # placement-driven h2d prefetch: seq_hash -> (k, v, event) blocks
        # uploaded by stage_prefetch (an executor thread) on a side stream
        # while the request queues at the slot gate; admission waits on
        # the event and scatters them device to device. Bounded FIFO
        # (insertion-ordered dict) under _h2d_stage_lock (two threads)
        self._h2d_stage: Dict[int, Tuple[Any, Any, Any, Any]] = {}
        self._h2d_stage_lock = threading.Lock()
        # hashes a prefetch was REQUESTED for: admission counts a host
        # upload of one of these as a prefetch stall (vs a plain miss)
        self._h2d_requested: set = set()
        self._h2d_stream = None         # the uploads' side stream (card)
        # prefix-cache accounting
        self.last_prefix_hit = 0
        self.prefix_hit_tokens = 0
        self.prefix_query_tokens = 0
        self.restore_seconds = 0.0      # host clock in _restore_prefix
        self._pending_prefix_hit: Dict[str, int] = {}
        # this rank's part of the KV frames' copies: bytes of its kv heads
        # and the host clock of each program, its collective included
        self.kv_restore_bytes = self.kv_offload_bytes = 0
        self.kv_restore_seconds = self.kv_offload_seconds = 0.0
        # this rank's weight swaps: bytes overwritten, and the host clock
        # of each swap (its barrier included)
        self.swap_bytes = 0
        self.swap_seconds = 0.0
        # tp > 1: this rank's host cuts of sibling models (_shard_cache),
        # and the cut a passed swap check holds for the swap frame
        self._shards = None
        self._swap_tree = None

        B = cfg.max_batch
        self.slots: List[Optional[_Slot]] = [None] * B
        self.by_seq: Dict[str, _Slot] = {}
        self.waiting: Deque[Tuple[str, BackendInput]] = collections.deque()
        self.temperature = np.zeros(B, np.float32)
        self.top_p = np.ones(B, np.float32)
        self.top_k = np.zeros(B, np.int64)
        self.freq_pen = np.zeros(B, np.float32)
        self.pres_pen = np.zeros(B, np.float32)
        # per-lane random streams; requests without a seed get one from
        # this engine-seeded source (deterministic in admission order)
        self.generators: List[Optional[torch.Generator]] = [None] * B
        self._seed_source = random.Random(cfg.seed)
        self._decode_seen: Dict[int, str] = {}
        # layer-streamed KV injections in progress, by sequence
        self._stream_injects: Dict[str, Dict[str, Any]] = {}
        # in-flight decode dispatches, oldest first: each record is a
        # dispatch whose results are not on the host yet (at most two)
        self._inflight: Deque[Dict[str, Any]] = collections.deque()
        # (seq_id, written) releases held until the window drains
        self._deferred_release: List[Tuple[str, int]] = []
        # dispatch counters and host-clock seconds per dispatch kind, each
        # ending in its result fetch (a run reads them beside the kernel
        # launch counters); decode seconds overlap between chained
        # dispatches
        self.prefill_dispatches = 0
        self.decode_dispatches = 0
        self.decode_chained = 0         # of those, chained off the window
        self.decode_steps_run = 0
        self.prefill_seconds = 0.0
        self.decode_seconds = 0.0

        # --- observability: stage histograms and goodput accounting ----
        # analytic FLOPs/bytes per dispatch over its measured host-clock
        # time, against the card's datasheet peaks (calibrated host figures
        # on the CPU); weight bytes are the loaded tree's
        self.stage = stage_metrics()
        if self.device.type == "cuda":
            peaks = roofline.detect_peaks(
                torch.cuda.get_device_name(self.device), "cuda")
        else:
            peaks = roofline.detect_peaks("cpu", "cpu")
        if tp > 1:
            # the whole model's work against tp devices' peaks, as the JAX
            # engine's global arrays account it
            peaks = replace(peaks, flops=peaks.flops * tp,
                            hbm_bytes=peaks.hbm_bytes * tp)
        # the loaded tree's bytes; a rank's shard holds replicated leaves,
        # so tp > 1 prices the whole model analytically
        self.costs = roofline.model_costs(m, weight_bytes=None if tp > 1
                                          else float(_tree_nbytes(
                                              self.params)))
        self.goodput = roofline.GoodputMeter(self.costs, peaks)
        # each rank's counters, gathered by refresh_rank_stats (tp > 1):
        # rank_stats_seq numbers the gather they come from, in the order
        # the gathers began (rank_stats_begun)
        self.rank_stats: List[Dict[str, float]] = []
        self.rank_stats_seq = self.rank_stats_begun = 0
        if self.device.type == "cuda":
            self._probe_kernels()
        if tp > 1:
            self._check_ranks_agree()

        # --- speculative decoding: proposer, per-sequence state, counters.
        # The proposer is the leader's (host tables, or a draft model,
        # unsharded): its drafts reach the followers as the verify frame's
        # token ids
        self.proposer = (build_proposer(self.spec, cfg, self.device)
                         if self.spec is not None and self.rank == 0
                         else None)
        self._spec_states: Dict[str, SeqSpecState] = {}
        self.spec_proposed_total = 0
        self.spec_accepted_total = 0
        self.spec_dispatch_total = 0    # verify dispatches
        self.spec_k_rounds: Dict[int, int] = collections.Counter()  # by K
        self.spec_lane_rounds = 0       # (lane, round) pairs that drafted
        self.spec_seconds = 0.0         # host clock of whole rounds

        # --- KV paging lane (llm/kvpage/): long-context requests the pool
        # or max_context would refuse are served with bounded device
        # residency (chunked prefill demotes sealed blocks to the host
        # tier, decode streams them back per layer through staged uploads)
        self.kvpager = None
        from ..llm.kvpage.runner import PagedConfig

        pcfg = PagedConfig.resolve(cfg)
        if pcfg is not None:
            from ..llm.kvpage.programs import PagedPrograms
            from ..llm.kvpage.runner import PagedEngine

            why = PagedPrograms.validate(cfg)
            if why is not None:
                raise ValueError(f"KV paging does not support {why}")
            # the tier is the leader's: a follower's lane only runs the
            # programs of the leader's frames
            if cfg.host_cache_blocks <= 0:
                raise ValueError("KV paging needs a host tier to demote "
                                 "into (set host_cache_blocks > 0)")
            if self.spec is not None:
                raise ValueError("KV paging does not compose with "
                                 "speculative decoding")
            self.kvpager = PagedEngine(self, pcfg)

    def _build_vision_tower(self, given) -> None:
        """The Gemma3 VLM tower and projector (``self.vision_cfg`` None for
        a text model), as the JAX engine builds them: a checkpoint whose
        config declares a tower must hold its tensors."""
        from ..models import siglip

        m = self.cfg.model
        self.vision_cfg = None
        self.images_encoded = 0
        self.image_waves = 0            # prefill dispatches on the dense path
        self.vision_seconds = 0.0       # the tower's own time (device events)
        self._vision_events: List[Tuple[Any, Any]] = []
        if m.vision is None:
            return
        vcfg = siglip.SiglipVisionConfig.from_hf_config(m.vision,
                                                        dtype=m.dtype)
        self.vision_cfg = vcfg
        self.vision_params = self.proj_params = None
        if self.rank > 0:
            # the tower and projector are the leader's, unsharded: a
            # follower gets an image wave's soft tokens in its frame
            return
        path = self.cfg.params_path
        if given is not None:
            self.vision_params, self.proj_params = given
        elif path and _has_safetensors(path):
            from .loader import load_vision_tensors

            vt = load_vision_tensors(path)
            if vt is None:
                # random tower weights would give images confidently
                # wrong completions
                raise ValueError(
                    f"model config declares a vision tower but {path} has "
                    f"no vision_tower/multi_modal_projector tensors; serve "
                    f"the text-only config instead")
            self.vision_params = siglip.params_from_hf(vt, vcfg, self.device)
            self.proj_params = siglip.projector_from_hf(vt, vcfg,
                                                        self.device)
        else:
            gen = torch.Generator(device=self.device).manual_seed(
                self.cfg.seed + 1)
            self.vision_params = siglip.init_params(vcfg, gen, self.device)
            self.proj_params = siglip.init_projector_params(
                vcfg, m.hidden_size, gen, self.device)

    def _encode_images(self, px: np.ndarray) -> torch.Tensor:
        """Normalized pixels [N, C, H, W] -> soft tokens [N, mm_tokens, D]
        on the device (one tower pass a request, at admission)."""
        from ..models import siglip

        d = self.device
        ev = None
        if d.type == "cuda":
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        t0 = time.perf_counter()
        with torch.no_grad():
            feats = siglip.forward(self.vision_params, self.vision_cfg,
                                   to_device(px, d))
            soft = siglip.project(self.proj_params, self.vision_cfg, feats,
                                  self.cfg.model.mm_tokens_per_image)
        if ev is not None:
            ev[1].record()
            # read once the next prefill fetch has synced the stream
            self._vision_events.append(ev)
        else:
            self.vision_seconds += time.perf_counter() - t0
        self.images_encoded += px.shape[0]
        return soft

    def _prepare_mm(self, req: BackendInput, prompt: List[int]):
        """Validate and encode a VLM request: (spans, soft, digest), or an
        error string (the JAX engine's messages)."""
        import hashlib

        m = self.cfg.model
        if self.vision_cfg is None:
            return ("this model has no vision tower; images are not "
                    "servable (text-only deployment)")
        if m.image_token_id is None:
            return "model config has no image_token_id"
        spans = mm.image_spans(prompt, m.image_token_id)
        err = mm.validate_mm_prompt(spans, len(req.images),
                                    m.mm_tokens_per_image,
                                    self.cfg.prefill_chunk)
        if err:
            return err
        try:
            px = np.stack([mm.normalize_image(im, self.vision_cfg.image_size)
                           for im in req.images])
        except ValueError as e:
            return str(e)
        digest = 0
        if not getattr(req, "kv_salt", 0):
            # only when the frontend did not salt the request already
            digest = int.from_bytes(
                hashlib.blake2b(px.tobytes(), digest_size=8).digest(),
                "little")
        soft = self._encode_images(px)
        return spans, soft.reshape(-1, soft.shape[-1]), digest

    def _check_tp(self) -> None:
        """Construction checks of a tensor-parallel rank: the model shards
        (heads, FFN) and each rank's heads form an integral GQA group for
        the kernels (there is no fallback path)."""
        m = self.cfg.model
        llama.validate_tp(m, self.tp)
        if not llama.kernel_tp_ok(m, self.tp):
            raise ValueError(
                f"tp={self.tp}: a rank's {m.num_heads // self.tp} query "
                f"heads do not form whole GQA groups over its "
                f"{llama.local_kv_heads(m, self.tp)} kv heads; the attention "
                f"kernels have no layout for it")
        llama.kv_head_range(m, self.tp, self.rank)  # straddling groups raise

    def _check_ranks_agree(self) -> None:
        """Every rank must build the same engine, or its page tables and
        lanes index a different pool: the leader broadcasts a digest of
        its model and geometry, and every rank raises on a mismatch."""
        import hashlib

        from ..parallel import collectives

        c, m = self.cfg, self.cfg.model
        key = repr((sorted((k, repr(v)) for k, v in m.__dict__.items()),
                    c.page_size, c.max_batch, c.max_context,
                    c.prefill_chunk, self.pool.num_pages, c.decode_steps,
                    c.seed, c.params_path, self.tp))
        mine = int.from_bytes(hashlib.blake2b(
            key.encode(), digest_size=7).digest(), "little")
        digest = to_device(np.asarray([mine], np.int64), self.device)
        collectives.broadcast(digest, self.group)
        # dynalint: ok(host-sync) construction, once: the leader's digest
        leader = int(digest.cpu()[0])
        bad = to_device(np.asarray([float(leader != mine)], np.float32),
                        self.device)
        collectives.all_reduce_(bad, self.group)
        # dynalint: ok(host-sync) construction, once: any rank's mismatch
        if float(bad.cpu()[0]):
            raise ValueError(
                f"tp rank {self.rank}: the ranks' engines differ (model, "
                f"geometry, seed or weights path); start every rank with "
                f"the same engine arguments")

    def _probe_kernels(self) -> None:
        """Build both CUDA kernels and launch each once at this engine's
        head shapes (a tp rank's own), so that a build or launch fault
        raises at construction instead of failing the first request."""
        m, d, page = self.cfg.model, self.device, self.page_size
        kw = dict(scale=m.attn_scale, softcap=m.attn_logit_softcap,
                  window=m.sliding_window)
        q = torch.zeros((1, 1, m.num_heads // self.tp, m.head_dim),
                        dtype=m.dtype, device=d)
        kv = torch.zeros((1, page, self.k_pool.shape[1], m.head_dim),
                         dtype=m.dtype, device=d)
        k_pos = torch.arange(page, dtype=torch.int32, device=d)[None]
        with torch.no_grad():
            flash_attention(q, kv, kv, k_pos[:, -1:].contiguous(), k_pos,
                            torch.ones((1, page), dtype=torch.bool,
                                       device=d), **kw)
            paged_attention(q[:, 0], self.k_pool[0], self.v_pool[0],
                            torch.zeros((1, 1), dtype=torch.int32, device=d),
                            torch.ones(1, dtype=torch.int32, device=d), **kw)
        # dynalint: ok(host-sync) construction, once: the probe launches
        # complete here so a build or launch fault raises before the first
        # request
        torch.cuda.synchronize(d)

    # ------------------------------------------------------------------
    # public API (engine thread)
    # ------------------------------------------------------------------
    def close(self) -> None:
        """Release host-side cache resources (the disk tier's spill memmaps
        and files, the pager's prefetch thread). Idempotent; called from
        TorchEngine.shutdown."""
        if self.kvpager is not None:
            self.kvpager.close()
        if self.tiered is not None:
            self.tiered.close()
        if self._shards is not None:
            self._shards.close()

    def release_device(self) -> None:
        """Drop every device tensor this core holds — weights, KV pools,
        lane state, the draft, the pager and staging buffers — so that a
        replacement engine can allocate on the same card (a worker's
        cold reload). The core serves nothing afterwards; call it after
        :meth:`close`, with the engine thread stopped."""
        self.params = {}
        self.k_pool = self.v_pool = self.gen_counts = None
        self.vision_params = self.proj_params = None
        self.proposer = None
        self.kvpager = None
        self._wt_stage = None
        with self._h2d_stage_lock:
            self._h2d_stage.clear()
        if self.device.type == "cuda":
            import gc

            gc.collect()        # engine objects sit in reference cycles
            torch.cuda.empty_cache()

    def flush_reusable(self) -> int:
        """Evict every reusable device block, offloading each to the host
        tier when there is one (cache-clear admin op). Returns the number
        evicted. Engine thread, or while the engine is idle."""
        n = self.pool.flush_reusable()
        self._flush_evictions()
        return n

    def submit(self, seq_id: str, request: BackendInput) -> None:
        self.waiting.append((seq_id, request))

    def cancel(self, seq_id: str) -> None:
        slot = self.by_seq.get(seq_id)
        if slot is not None:
            slot.cancelled = True
        else:
            self.waiting = collections.deque(
                (s, r) for s, r in self.waiting if s != seq_id)
            if self.kvpager is not None:
                self.kvpager.cancel(seq_id)
            if seq_id in self._stream_injects:
                # mid-stream cancel: release the half-written pages
                self.abort_stream_inject(seq_id)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.by_seq or self._inflight
                    or (self.kvpager is not None
                        and self.kvpager.has_work))

    @property
    def active(self) -> int:
        return len(self.by_seq)

    def utilization(self) -> Dict[str, float]:
        """The worker's ForwardPassMetrics fields, with the JAX engine's
        keys and values for the same schedule: slots, blocks and waiting
        requests, the prefix hit rate, the windowed goodput rates, and the
        KV bytes resident against capacity (device pool plus host tier;
        the paging lane's pinned host working set counts as resident),
        and the drafted-token acceptance rate (0 with spec off or nothing
        proposed yet). Any thread: reads counters only."""
        total = self.pool.num_pages - 1
        hit_rate = (self.prefix_hit_tokens / self.prefix_query_tokens
                    if self.prefix_query_tokens else 0.0)
        goodput = self.goodput.snapshot()
        blk_bytes = float(llama.kv_block_bytes(self.cfg.model,
                                               self.cfg.page_size))
        resident = float(total - self.pool.free_pages) * blk_bytes
        capacity = float(total) * blk_bytes
        if self.tiered is not None:
            capacity += float(self.tiered.host.num_blocks) * blk_bytes
        if self.kvpager is not None:
            # the lane's device pages are already counted in the pool; its
            # pinned host working set is the part slots cannot see
            resident += self.kvpager.resident_bytes()[1]
        return {
            "request_active_slots": float(self.active),
            "request_total_slots": float(self.cfg.max_batch),
            "kv_active_blocks": float(total - self.pool.free_pages),
            "kv_total_blocks": float(total),
            "num_requests_waiting": float(len(self.waiting)),
            "gpu_prefix_cache_hit_rate": hit_rate,
            "spec_accept_rate": (
                self.spec_accepted_total / self.spec_proposed_total
                if self.spec_proposed_total else 0.0),
            "mfu": goodput["mfu"],
            "mbu": goodput["mbu"],
            "hbm_gbps": goodput["hbm_gbps"],
            "kv_resident_bytes": resident,
            "kv_capacity_bytes": capacity,
        }

    # ------------------------------------------------------------------
    # KV export/import (disaggregated prefill -> decode transfer)
    # ------------------------------------------------------------------
    def _kv_slots(self, seq_id: str, count: int) -> torch.Tensor:
        """Flat pool token slots (page * page_size + offset) of a
        sequence's first ``count`` tokens, on the engine's device."""
        slots = self.pool.write_slots(seq_id, 0, count).astype(np.int64)
        return to_device(slots, self.device)

    def _flat(self, pool: torch.Tensor) -> torch.Tensor:
        """A view of ``pool`` (or of a run of its layers) with the page and
        offset axes merged: [L, Hkv, n_pages * page, Dh]."""
        L, H, n, pg, D = pool.shape
        return pool.view(L, H, n * pg, D)

    def _to_host(self, tensors: List[torch.Tensor]) -> List[np.ndarray]:
        """Device tensors as host arrays (:func:`to_host_array`: bf16 as
        ``uint16`` bits), through pinned buffers on a card and one event
        wait for all of them."""
        if self.device.type != "cuda":
            return [to_host_array(t.contiguous()) for t in tensors]
        host = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            host.append(h)
        ev = torch.cuda.Event()
        ev.record()
        # dynalint: ok(host-sync) one event wait for a whole batch of pinned
        # copies, off the decode enqueue: disagg KV export (extract_kv,
        # prefill_extract), a tp image request's soft tokens at admission, a
        # sibling's seeded cut (swap prefetch)
        ev.synchronize()       # the pinned buffers are read after this
        return [to_host_array(h) for h in host]

    def extract_kv(self, seq_id: str, layer: Optional[int] = None,
                   count: Optional[int] = None):
        """Gather a sequence's KV out of the pool -> host numpy arrays.
        With ``layer`` set, returns that layer only ([T,Hkv,Dh] k, v) for
        layer-pipelined transfer; otherwise all layers ([L,T,Hkv,Dh]).
        ``count`` limits extraction to the first N tokens (e.g. the
        prompt). A bf16 pool's arrays are ``uint16`` bits. At tp > 1 this
        is a ``kv_extract`` frame: every rank gathers its kv heads and the
        leader returns the whole arrays."""
        sc = self.pool.seqs[seq_id]
        n = sc.num_tokens if count is None else min(count, sc.num_tokens)
        arrs = {"slots": self.pool.write_slots(seq_id, 0, n).astype(
            np.int64)}
        meta = {"layer": layer}
        with self._framed("kv_extract", meta, arrs):
            return self._run_extract_program(arrs, meta)

    def _run_extract_program(self, arrs: Dict[str, np.ndarray],
                             meta: Dict[str, Any]):
        """The KV at token ``slots`` of this rank's pools to the host (all
        layers, or ``meta["layer"]``); at tp > 1 gathered into the whole
        arrays on the leader ((None, None) on a follower)."""
        slots = to_device(arrs["slots"], self.device)
        layer = meta.get("layer")
        out = []
        for pool in (self.k_pool, self.v_pool):
            if layer is None:
                # [L, Hkv, n, Dh] -> [L, n, Hkv, Dh]
                out.append(self._flat(pool).index_select(2, slots)
                           .transpose(1, 2))
            else:
                out.append(self._flat(pool[layer:layer + 1])[0]
                           .index_select(1, slots).transpose(0, 1))
        k, v = self._to_host(out)
        if self.tp == 1:
            return k, v
        axis = 2 if layer is None else 1
        return tuple(collectives.gather_heads(x, self.host_group,
                                              self._kv_heads, axis)
                     for x in (k, v))

    def prefill_extract(self, seq_id: str, request: BackendInput
                        ) -> Tuple[np.ndarray, np.ndarray, int, float]:
        """Prefill-worker path: run the full (chunked) prefill for a request,
        sample its first token, gather the prompt KV to host, release the
        slot. Returns (k [L,T,Hkv,Dh], v, first_token, first_logprob).
        The caller owns queue/transfer; this runs on the engine thread."""
        from dataclasses import replace

        prompt = list(request.token_ids)
        if len(prompt) + 1 >= self.cfg.max_context:
            # typed 400 (not a bare ValueError): the disagg frontend's
            # error body names the configured limit and the stage that
            # rejected, end to end over the wire
            raise EngineError(
                f"prompt of {len(prompt)} tokens exceeds the configured "
                f"max_context of {self.cfg.max_context}", 400,
                stage="prefill", reason="context_exceeded")
        if request.images:
            raise ValueError("disaggregated prefill does not take image "
                             "requests yet; serve VLM prompts aggregated")
        if None not in self.slots:
            raise RuntimeError("no free slot for prefill job")
        # the first sampled token must never finish the slot (we need the KV
        # before release) — neutralize stop conditions for the prefill pass
        req = replace(request, stop=replace(
            request.stop, max_tokens=None, stop_token_ids=[],
            min_tokens=None, ignore_eos=True))
        slot_idx = self.slots.index(None)
        slot = _Slot(seq_id, req, prompt)
        self.slots[slot_idx] = slot
        self.by_seq[seq_id] = slot
        self.pool.create(seq_id, lora_id=getattr(req, "lora_id", 0))
        self._load_sampling(slot_idx, req)
        out: List[StepOutput] = []
        try:
            with torch.no_grad():
                while slot.prefill_done < len(prompt):
                    self._prefill_dispatch([(slot_idx, slot)], out)
                    if out and out[-1].finish == FinishReason.ERROR:
                        raise OutOfPages("prefill ran out of KV pages")
                so = out[-1]
                k, v = self.extract_kv(seq_id, count=len(prompt))
        finally:
            self._free_slot(slot_idx)
        return k, v, so.token, so.logprob

    def inject_prefilled(self, seq_id: str, request: BackendInput,
                         k: np.ndarray, v: np.ndarray,
                         first_token: int,
                         first_logprob: float = 0.0) -> StepOutput:
        """Receive a remotely-prefilled sequence: write its prompt KV into
        this pool and enter it straight into decode (prefill_done=len).
        ``k``/``v``: [L, T, Hkv, Dh] for the prompt tokens. At tp > 1 a
        ``kv_inject`` frame gives each rank its kv heads; every check runs
        before it, so a bad payload errors its request and sends no
        frame."""
        if None not in self.slots:
            raise RuntimeError("no free slot for injected sequence")
        prompt = list(request.token_ids)
        T = k.shape[1]
        if T != len(prompt):
            raise ValueError(f"KV covers {T} tokens, prompt is {len(prompt)}")
        m = self.cfg.model
        want = (m.num_layers, T, m.num_kv_heads, m.head_dim)
        if k.shape != want or v.shape != want:
            # checked before any page is leased (the JAX engine leases
            # first and leaks the sequence's pages when its scatter fails)
            raise ValueError(f"KV geometry {k.shape}/{v.shape} does not "
                             f"match this engine's {want}")
        whole = None
        if self.tp > 1:
            # in the pool's host dtype on the leader, before any lease
            whole = [to_host_array(_kv_tensor(a).to(m.dtype))
                     for a in (k, v)]
        self.pool.create(seq_id, lora_id=getattr(request, "lora_id", 0))
        try:
            self.pool.extend(seq_id, prompt)
            self._flush_evictions()
            if whole is not None:
                self._inject_layers(self.pool.write_slots(
                    seq_id, 0, T).astype(np.int64), 0, whole)
            else:
                slots = self._kv_slots(seq_id, T)
                for pool, arr in ((self.k_pool, k), (self.v_pool, v)):
                    # to the card through pinned memory, non-blocking;
                    # vals [L, T, Hkv, Dh] -> the pool's [L, Hkv, T, Dh]
                    vals = to_device(_kv_tensor(arr), self.device)
                    self._flat(pool).index_copy_(
                        2, slots, vals.to(pool.dtype).transpose(1, 2))
        except Exception:
            self.pool.release(seq_id)
            raise
        return self._enter_injected(seq_id, request, prompt, first_token,
                                    first_logprob)

    def _inject_layers(self, slots: np.ndarray, l0: int,
                       whole: List[np.ndarray]) -> None:
        """tp > 1: a ``kv_inject`` frame writing the leader's whole host
        layers ``whole`` (k, v [G, T, Hkv, Dh], the pool's host dtype) at
        token ``slots`` of layers ``l0`` .. ``l0 + G`` on every rank."""
        arrs = {"slots": slots}
        meta = {"l0": l0, "layers": int(whole[0].shape[0])}
        with self._framed("kv_inject", meta, arrs):
            self._run_inject_program(arrs, meta, whole)

    def _run_inject_program(self, arrs: Dict[str, np.ndarray],
                            meta: Dict[str, Any],
                            whole: Optional[List[np.ndarray]] = None) -> None:
        """This rank's kv heads of the leader's whole layers (one host
        scatter a pool) written at token ``slots`` of its pools."""
        m, d = self.cfg.model, self.device
        l0, G, slots = meta["l0"], meta["layers"], arrs["slots"]
        idx = to_device(slots, d)
        shape = (G, len(slots), self.k_pool.shape[1], m.head_dim)
        for pool, w in zip((self.k_pool, self.v_pool), whole or (None, None)):
            part = collectives.scatter_heads(w, self.host_group,
                                             self._kv_heads, shape,
                                             host_dtype(pool.dtype))
            vals = to_device(from_host_array(part, pool.dtype), d)
            # [G, T, Hkv, Dh] -> the pool's [G, Hkv, T, Dh]
            self._flat(pool[l0:l0 + G]).index_copy_(2, idx,
                                                    vals.transpose(1, 2))

    def _enter_injected(self, seq_id: str, request: BackendInput,
                        prompt: List[int], first_token: int,
                        first_logprob: float) -> StepOutput:
        """Shared tail of the two KV-import paths (bulk inject / layer
        stream): claim a slot straight into decode, seed bookkeeping, and
        emit the prefill-worker-sampled first token."""
        slot_idx = self.slots.index(None)
        slot = _Slot(seq_id, request, prompt, prefill_done=len(prompt),
                     kv_written=len(prompt))
        self.slots[slot_idx] = slot
        self.by_seq[seq_id] = slot
        self._load_sampling(slot_idx, request)
        if request.sampling.seed is not None:
            # the prefill worker drew one uniform sampling the first token
            # (``_prefill_dispatch``'s last chunk); draw it here too so
            # token 2 onward matches a local prefill of the same request
            torch.rand(1, generator=self.generators[slot_idx])
        t = int(first_token)
        try:
            slot.generated += 1
            slot.last_token = t
            self.pool.extend(seq_id, [t])
        except OutOfPages:
            self._free_slot(slot_idx)
            raise
        slot.cum_logprob = float(first_logprob)
        fin = self._finish_reason(slot, t)
        so = StepOutput(seq_id, t, slot.cum_logprob, fin,
                        prompt_tokens=len(prompt),
                        token_logprob=float(first_logprob))
        if fin is not None:
            self._free_slot(slot_idx)
        return so

    # ------------------------------------------------------------------
    # layer-streamed KV injection (disagg receive; engine thread)
    # ------------------------------------------------------------------
    def begin_stream_inject(self, seq_id: str,
                            request: BackendInput) -> None:
        """Lease pool pages for a remotely-prefilled prompt whose KV is
        still on the wire. The pages stay UNSEALED (no hash registration,
        no stored events) until :meth:`finish_stream_inject` — a torn
        stream releases them with nothing ever having referenced them."""
        prompt = list(request.token_ids)
        if None not in self.slots:
            raise RuntimeError("no free slot for streamed sequence")
        self.pool.create(seq_id, lora_id=getattr(request, "lora_id", 0))
        try:
            self.pool.ensure_pages(seq_id, len(prompt))
        except Exception:
            self.pool.release(seq_id)
            raise
        # leasing may have evicted reusable pages: their offload d2h must
        # be enqueued before our scatters overwrite them
        self._flush_evictions()
        slots = self.pool.write_slots(seq_id, 0, len(prompt)).astype(
            np.int64)
        self._stream_injects[seq_id] = {
            "request": request, "prompt": prompt,
            "slots": to_device(slots, self.device), "host_slots": slots,
            "layers_done": 0, "stage": None, "n": 0, "buf_l0": 0,
            # layers a scatter: each group of arrivals lands in one
            # scatter a pool (a scatter per layer would spend more host
            # time enqueueing than the scatters it overlaps)
            "group": max(1, min(4, self.cfg.model.num_layers)),
        }

    def _flush_stream_buf(self, st) -> None:
        """Send the staged group of layers to the card (pinned source,
        ``non_blocking=True``) and scatter it into both pools; at tp > 1
        through a ``kv_inject`` frame."""
        n = st["n"]
        if not n:
            return
        l0 = st["buf_l0"]
        pools = (self.k_pool, self.v_pool)
        if self.tp > 1:
            self._inject_layers(st["host_slots"], l0, [
                to_host_array(staged[:n].to(pool.dtype))
                for pool, staged in zip(pools, st["stage"])])
        else:
            for pool, staged in zip(pools, st["stage"]):
                vals = staged[:n].to(self.device, non_blocking=True)
                # [G, T, Hkv, Dh] -> the pool's [G, Hkv, T, Dh]
                self._flat(pool[l0:l0 + n]).index_copy_(
                    2, st["slots"], vals.to(pool.dtype).transpose(1, 2))
        st["buf_l0"] = l0 + n
        st["stage"], st["n"] = None, 0

    def stream_inject_layer(self, seq_id: str, layer: int,
                            k: np.ndarray, v: np.ndarray) -> None:
        """Accept ONE arriving layer ([T,Hkv,Dh] each) into its group's
        pinned staging buffers, and enqueue the group's scatter once it is
        full, while later layers are still in flight. Never syncs the
        host: the engine keeps dispatching other sequences' work."""
        st = self._stream_injects[seq_id]
        m = self.cfg.model
        want = (len(st["prompt"]), m.num_kv_heads, m.head_dim)
        if k.shape != want or v.shape != want:
            # before it is staged: a group's scatter (at tp > 1 a frame)
            # only ever carries checked layers
            raise ValueError(f"layer {layer} KV {k.shape}/{v.shape} does "
                             f"not match this engine's {want}")
        if st["stage"] is None:
            G = min(st["group"], self.cfg.model.num_layers - st["buf_l0"])
            st["stage"] = [torch.empty((G, *k.shape), dtype=_kv_dtype(
                k.dtype), pin_memory=self.device.type == "cuda")
                for _ in range(2)]
        for staged, arr in zip(st["stage"], (k, v)):
            np.copyto(to_host_array(staged[st["n"]]), arr)
        st["n"] += 1
        st["layers_done"] = layer + 1
        if st["n"] >= len(st["stage"][0]):
            self._flush_stream_buf(st)

    def finish_stream_inject(self, seq_id: str, first_token: int,
                             first_logprob: float) -> StepOutput:
        """All scatters enqueued: seal+register the blocks (stored events
        fire only now, for fully-arrived KV) and enter the sequence
        straight into decode."""
        st = self._stream_injects.pop(seq_id)
        prompt = st["prompt"]
        if st["layers_done"] != self.cfg.model.num_layers:
            self.pool.release(seq_id)
            raise ValueError(
                f"stream inject for {seq_id} finished at layer "
                f"{st['layers_done']}/{self.cfg.model.num_layers}")
        if None not in self.slots:
            self.pool.release(seq_id)
            raise RuntimeError("no free slot for streamed sequence")
        self._flush_stream_buf(st)         # tail group (< group layers)
        self.pool.account_tokens(seq_id, prompt)
        return self._enter_injected(seq_id, st["request"], prompt,
                                    first_token, first_logprob)

    def abort_stream_inject(self, seq_id: str) -> None:
        """Torn stream: drop the ingest state and release the leased
        pages. They were never sealed/registered, so nothing — attention,
        prefix match, KV events — can have observed the partial writes;
        the pages return to the free list."""
        if self._stream_injects.pop(seq_id, None) is not None:
            self.pool.release(seq_id)

    def step(self, flush: Optional[Callable[[List[StepOutput]], None]] = None
             ) -> List[StepOutput]:
        """Run one engine iteration.

        Steady-state decode is pipelined: a decode dispatch's tokens are
        fetched one iteration later, while the next dispatch, chained off
        the previous one's tokens on the device, is already enqueued.
        Membership changes (admission, prefill, cancel) drain the window
        first, and it drains when no live sequence is left; releases held
        for in-flight dispatches apply once it is empty.

        With the window empty, an iteration runs one batched prefill
        dispatch (admitting as many waiting requests as fit), then enqueues
        one multi-step decode dispatch over every decode-ready sequence.
        ``flush``, when given, receives the outputs that exist before that
        enqueue (first tokens, rejections, cancellations) so they reach
        callers without waiting for it (TTFT); the rest are returned.

        A sequence's first output carries admission's prefix-restore length
        (``StepOutput.prefix_hit``).

        One unit of the KV paging lane's work (a prefill chunk or a decode
        window) runs first, between dense dispatches; its outputs do not
        break the dense window's chain."""
        out = self._reap_cancelled()
        n_reaped = len(out)
        with torch.no_grad():
            self._advance_writethrough()
            if self.kvpager is not None and self.kvpager.has_work:
                out.extend(self.kvpager.advance())
            prefill_work = any(s is not None and s.prefill_done < len(s.prompt)
                               for s in self.slots)
            admit_possible = bool(self.waiting) and None in self.slots
            sync_needed = prefill_work or admit_possible or n_reaped > 0
            if self._inflight:
                if not sync_needed and self._can_chain():
                    self._dispatch_decode()
                out.extend(self._process_oldest_inflight())
                while not self.by_seq and self._inflight:
                    # every live sequence finished: drain the stale window
                    # so its pages release instead of idling in limbo
                    out.extend(self._process_oldest_inflight())
                if not self._inflight:
                    self._apply_deferred_release()
                return self._tag_prefix_hits(out)
            self._apply_deferred_release()
            if prefill_work or admit_possible:
                self._prefill_round(out)
            if flush is not None and out:
                flush(self._tag_prefix_hits(out))
                out = []
            if any(s is not None and s.prefill_done >= len(s.prompt)
                   for s in self.slots):
                if self.spec is not None:
                    # synchronous per round: the window stays empty
                    self._spec_round(out)
                else:
                    self._dispatch_decode(out)
        return self._tag_prefix_hits(out)

    def drop_window(self) -> None:
        """Forget the in-flight decode dispatches and apply the releases
        held for them (after an engine error, so no page stays leased)."""
        for _ in self._inflight:
            _flightrec.hb_done("engine.decode")
        self._inflight.clear()
        self._apply_deferred_release()

    def _tag_prefix_hits(self, out: List[StepOutput]) -> List[StepOutput]:
        if self._pending_prefix_hit:
            for so in out:
                hit = self._pending_prefix_hit.pop(so.seq_id, None)
                if hit is not None:
                    so.prefix_hit = hit
        return out

    # ------------------------------------------------------------------
    def _reap_cancelled(self) -> List[StepOutput]:
        outs = []
        for i, slot in enumerate(self.slots):
            if slot is not None and slot.cancelled:
                outs.append(StepOutput(slot.seq_id, slot.last_token, 0.0,
                                       FinishReason.CANCELLED))
                self._free_slot(i)
        return outs

    def _free_slot(self, i: int) -> None:
        slot = self.slots[i]
        if slot is None:
            return
        self._decode_seen.pop(i, None)
        self.generators[i] = None
        self._spec_states.pop(slot.seq_id, None)
        if self.proposer is not None:
            self.proposer.drop(slot.seq_id)
        # the last sampled token's KV exists only once a later step fed it
        # back: a block it completed must not stay matchable
        if self._inflight:
            # an enqueued decode dispatch may still write into this
            # sequence's pages; hold the release until the window drains so
            # the pages cannot be reallocated under the in-flight dispatch
            self._deferred_release.append((slot.seq_id, slot.kv_written))
        else:
            self.pool.release(slot.seq_id, written=slot.kv_written)
        self.by_seq.pop(slot.seq_id, None)
        self.slots[i] = None

    def _apply_deferred_release(self) -> None:
        if self._deferred_release and not self._inflight:
            for seq_id, written in self._deferred_release:
                self.pool.release(seq_id, written=written)
            self._deferred_release.clear()

    # ------------------------------------------------------------------
    # KV block manager: offload at eviction, restore at admission
    # ------------------------------------------------------------------
    def _offload_evicted(self, seq_hash: int, page: int) -> None:
        """Eviction hook: queue the page for host-tier offload. Its data
        stays valid until the page's new owner WRITES (the next device
        dispatch or restore), so :meth:`_flush_evictions` copies the batch
        out right before any of those."""
        if self.tiered is None:
            return
        # the page can be rewritten by the very next dispatch: a pending
        # write-through entry for it would mirror the new owner's data
        # under the old hash. Drop it; this eviction offloads the block
        # with still-valid data (a copy already enqueued read it before)
        self._wt_pending = [e for e in self._wt_pending
                            if e[:2] != (seq_hash, page)]
        self._evict_buf.append((seq_hash, page))

    def _flush_evictions(self) -> None:
        """Copy the queued evicted pages to the host tier. The d2h is
        enqueued on the compute stream ahead of the dispatch that may
        overwrite them, and the tier reads the pinned buffers only after
        the copy's event completed (``CopyStream.d2h_pages``). Write-through
        entries that are ready ride the same copy, deduplicated."""
        if not self._evict_buf:
            return
        wt = self._take_ready_writethrough()
        buf = list(dict.fromkeys(self._evict_buf + wt))
        self._evict_buf = []
        from ..obs.flows import record_flow

        t0 = time.perf_counter()
        k, v = self._offload_pages([p for _, p in buf])
        # the whole batch on the ledger, as the JAX engine records it: the
        # evicted pages and the write-through mirrors riding the same copy
        record_flow("d2h_writethrough", k.nbytes + v.nbytes,
                    time.perf_counter() - t0)
        for i, (seq_hash, _) in enumerate(buf):
            self.tiered.offload(seq_hash, k[i], v[i])
        if wt:
            nbytes = len(wt) * (k[0].nbytes + v[0].nbytes)
            secs = (time.perf_counter() - t0) * len(wt) / len(buf)
            self._count_writethrough(len(wt), nbytes, secs, record=False)

    def _offload_pages(self, pages: List[int]
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Whole host blocks (k, v [n, L, Hkv, page, Dh]) of device
        ``pages``: a ``kv_offload`` frame, which every rank replays before
        any later program can rewrite the pages."""
        arrs = {"pages": np.asarray(pages, np.int64)}
        with self._framed("kv_offload", {}, arrs):
            return self._run_offload_program(arrs)

    def _run_offload_program(self, arrs: Dict[str, np.ndarray]):
        """``pages`` to the host (``CopyStream.d2h_pages``); at tp > 1 this
        rank's kv heads, gathered into whole blocks on the leader ((None,
        None) on a follower)."""
        t0 = time.perf_counter()
        # dynalint: ok(flow-accounting) the leader's callers record the
        # whole blocks (d2h_writethrough: the eviction batch, each mirror)
        k, v = self.copy_stream.d2h_pages(self.k_pool, self.v_pool,
                                          arrs["pages"])
        self.kv_offload_bytes += k.nbytes + v.nbytes
        if self.tp > 1:
            k, v = (collectives.gather_heads(x, self.host_group,
                                             self._kv_heads)
                    for x in (k, v))
        self.kv_offload_seconds += time.perf_counter() - t0
        return k, v

    # ------------------------------------------------------------------
    # cluster write-through: mirror sealed blocks once their KV is written
    # ------------------------------------------------------------------
    def _writethrough_sealed(self, seq_id: str, block, page: int,
                             lora_id: int) -> None:
        """Seal hook (cluster sharing): queue the block for a host-tier
        mirror, to be copied once its sequence's KV covers it. Host-tier
        restores also seal (``fire_stored``); those blocks came FROM the
        tier, so mirroring them back would be a wasted d2h exactly on the
        cluster-warm path."""
        if block.sequence_hash in self.tiered:
            return
        end = len(self.pool.seqs[seq_id].hashes.blocks) * self.page_size
        self._wt_pending.append((block.sequence_hash, page, seq_id, end))

    def _kv_written(self, seq_id: str) -> Optional[int]:
        """Leading tokens of ``seq_id`` whose KV every enqueued dispatch
        writes; None once the sequence left the pool (its release unsealed
        every block past what was written)."""
        slot = self.by_seq.get(seq_id)
        if slot is not None:
            return slot.kv_written
        for s, written in self._deferred_release:
            if s == seq_id:
                return written
        return None

    def _take_ready_writethrough(self, limit: Optional[int] = None
                                 ) -> List[Tuple[int, int]]:
        """Pop the pending mirrors whose KV is written (at most ``limit``),
        as (hash, page); drop those whose page no longer holds their
        block."""
        ready, keep = [], []
        for e in self._wt_pending:
            seq_hash, page, seq_id, end = e
            if self.pool.blocks.sealed_hash(page) != seq_hash:
                continue        # unsealed at release, or recycled
            written = self._kv_written(seq_id)
            if (written is None or written >= end) and (
                    limit is None or len(ready) < limit):
                ready.append((seq_hash, page))
            else:
                keep.append(e)
        self._wt_pending = keep
        return ready

    def _advance_writethrough(self) -> int:
        """Step boundary: hand a completed mirror copy to the tier, then,
        with the staging buffer free, enqueue one gather of up to
        ``WT_STAGE_BLOCKS`` pending mirrors whose KV is written, behind an
        event. Never waits on the card. Returns the blocks enqueued."""
        if self._wt_copies:
            self._retire_writethrough()
            if self._wt_copies:
                return 0        # the staging buffer is still in flight
        if not self._wt_pending:
            return 0
        ready = self._take_ready_writethrough(limit=WT_STAGE_BLOCKS)
        if not ready:
            return 0
        t0 = time.perf_counter()
        n = len(ready)
        if self.tp > 1:
            # a kv_offload frame, run now: its host gather syncs anyway
            k, v = self._offload_pages([p for _, p in ready])
            for i, (seq_hash, _) in enumerate(ready):
                self.tiered.offload(seq_hash, k[i], v[i])
            secs = time.perf_counter() - t0
            self.writethrough_enqueue_seconds += secs
            self._count_writethrough(n, k.nbytes + v.nbytes, secs)
            return n
        idx = to_device(np.asarray([p for _, p in ready], np.int64),
                        self.device)
        rec: Dict[str, Any] = {"entries": ready, "end": None}
        pools = (self.k_pool, self.v_pool)
        if self._wt_stage is not None:
            rec["start"] = torch.cuda.Event(enable_timing=True)
            rec["start"].record()
            rec["host"] = [stage[:n] for stage in self._wt_stage]
            for pool, dst in zip(pools, rec["host"]):
                dst.copy_(pool.index_select(2, idx).permute(2, 0, 1, 3, 4),
                          non_blocking=True)
            rec["end"] = torch.cuda.Event(enable_timing=True)
            rec["end"].record()
        else:
            rec["host"] = [pool.index_select(2, idx).permute(2, 0, 1, 3, 4)
                           .contiguous() for pool in pools]
            rec["seconds"] = time.perf_counter() - t0
        self.writethrough_enqueue_seconds += time.perf_counter() - t0
        self._wt_copies.append(rec)
        self._retire_writethrough()
        return n

    def _retire_writethrough(self, wait: bool = False) -> None:
        """Offload the mirror copy in flight into the tier once its event
        has completed (waiting for it with ``wait``)."""
        while self._wt_copies:
            rec = self._wt_copies[0]
            end = rec["end"]
            if end is not None:
                if wait:
                    # dynalint: ok(host-sync) only with wait=True
                    # (flush_writethrough: an idle engine); the step boundary
                    # polls the event with query() instead
                    end.synchronize()
                elif not end.query():
                    return
                secs = rec["start"].elapsed_time(end) / 1e3
            else:
                secs = rec["seconds"]
            self._wt_copies.popleft()
            k, v = (to_host_array(t) for t in rec["host"])
            for i, (seq_hash, _) in enumerate(rec["entries"]):
                self.tiered.offload(seq_hash, k[i], v[i])
            self._count_writethrough(len(rec["entries"]),
                                     k.nbytes + v.nbytes, secs)

    def _count_writethrough(self, blocks: int, nbytes: int,
                            seconds: float, record: bool = True) -> None:
        """The mirror counters, and the ledger unless the caller already
        recorded these bytes with a larger batch."""
        from ..obs.flows import record_flow

        self.writethrough_blocks += blocks
        self.writethrough_bytes += nbytes
        self.writethrough_seconds += seconds
        if record:
            record_flow("d2h_writethrough", nbytes, seconds)

    def flush_writethrough(self) -> int:
        """Mirror every pending block whose KV is written and wait for the
        copies (an idle engine, tests). Returns the blocks mirrored so far
        in all."""
        self._retire_writethrough(wait=True)
        with torch.no_grad():
            while self._advance_writethrough():
                self._retire_writethrough(wait=True)
        return self.writethrough_blocks

    # ------------------------------------------------------------------
    # placement-driven h2d prefetch (executor thread -> admission restore)
    # ------------------------------------------------------------------
    def stage_prefetch(self, token_ids, lora_id: int = 0) -> int:
        """Upload matched host/disk-tier prefix blocks to device staging
        while the request still queues at the slot gate (an executor
        thread; the engine thread keeps dispatching). The copies run from
        pinned memory on a side stream under one event; admission's restore
        makes the compute stream wait on it before its device-to-device
        scatter. Returns blocks staged. At tp > 1 the leader also keeps the
        whole host blocks: the restore scatters the followers' kv heads of
        them, while its own come from the staged device copies.

        Safe beside the engine thread: the tier is locked, the staged
        tensors are fresh ones nothing else references, the stage dict is
        lock-guarded, and the pool is only probed (``contains``)."""
        from ..llm.tokens import compute_seq_hashes
        from ..obs.flows import record_flow
        from ..utils.knobs import env_float

        cap = int(env_float("DYN_H2D_PREFETCH_BLOCKS", 32, minimum=0.0))
        if cap <= 0 or self.tiered is None:
            return 0
        t0 = time.perf_counter()
        got = []
        for h in compute_seq_hashes(list(token_ids), self.page_size,
                                    lora_id=lora_id):
            if self.pool.blocks.contains(h):
                continue            # device-resident: nothing to move
            with self._h2d_stage_lock:
                if h in self._h2d_stage:
                    continue
            kv = self.tiered.peek(h)   # copies; no LRU perturbation
            if kv is None:
                break               # consecutive-prefix property
            got.append((h, kv))
            if len(got) >= cap:
                break
        if not got:
            return 0
        cuda = self.device.type == "cuda"
        shape = got[0][1][0].shape
        # pinned sources: the side stream's copies run asynchronously
        host = [torch.empty((len(got), *shape), dtype=self.k_pool.dtype,
                            pin_memory=cuda) for _ in range(2)]
        for part, dst in enumerate(host):
            arr = to_host_array(dst)
            for i, (_, kv) in enumerate(got):
                arr[i] = kv[part]
        ev = None
        if cuda:
            if self._h2d_stream is None:
                self._h2d_stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(self._h2d_stream):
                dev = [t.to(self.device, non_blocking=True) for t in host]
                ev = torch.cuda.Event()
                ev.record()
        else:
            dev = host
        whole = [to_host_array(t) for t in host] if self.tp > 1 else None
        with self._h2d_stage_lock:
            for i, (h, _) in enumerate(got):
                while len(self._h2d_stage) >= cap:
                    self._h2d_stage.pop(next(iter(self._h2d_stage)))
                self._h2d_stage[h] = (dev[0][i], dev[1][i], ev, None
                                      if whole is None
                                      else (whole[0][i], whole[1][i]))
                self._h2d_requested.add(h)
            if len(self._h2d_requested) > 4 * cap:
                # cancelled/never-admitted requests must not grow the
                # stall-attribution set forever
                self._h2d_requested.clear()
        record_flow("h2d_prefetch", host[0].nbytes + host[1].nbytes,
                    time.perf_counter() - t0)
        return len(got)

    def _restore_prefix(self, seq_id: str, prompt: List[int]) -> int:
        """Prefix reuse at admission: claim matching device blocks, consume
        prefetch-staged blocks (device to device, after their upload's
        event), and upload the remaining matching host-tier blocks; returns
        tokens satisfied from cache (always < len(prompt) so the last token
        still computes logits)."""
        t0 = time.perf_counter()
        host_lookup = None
        staged: List[np.ndarray] = []       # (k, v) host blocks, once used
        on_dev: Dict[int, Tuple[Any, Any, Any, Any]] = {}  # prefetch-staged
        n_up = 0
        if self.tiered is not None:
            def host_lookup(h):
                # fetch (and copy) eagerly: leasing the upload page can
                # evict a device block whose offload lands in — and
                # LRU-drops from — the very host tier we matched against.
                # The copy goes straight into (pinned) upload buffers.
                nonlocal n_up
                with self._h2d_stage_lock:
                    dev = self._h2d_stage.pop(h, None)
                    if dev is not None:
                        # a host upload of a requested hash stays in the
                        # set: it is counted as a stall below
                        self._h2d_requested.discard(h)
                if dev is not None:
                    on_dev[h] = dev
                    return True
                kv = self.tiered.lookup(h)
                if kv is None:
                    return False
                if not staged:
                    staged.extend(self.copy_stream.host_blocks(
                        len(prompt) // self.page_size, kv[0].shape,
                        self.k_pool.dtype, self.k_pool.is_cuda))
                staged[0][n_up] = kv[0]
                staged[1][n_up] = kv[1]
                n_up += 1
                return True
        matched, uploads = self.pool.match_prefix(
            seq_id, prompt, len(prompt) - 1, host_lookup)
        if uploads:
            # the upload pages may have been evicted just now: their old
            # blocks go out before the h2d overwrites them
            self._flush_evictions()
            host_up = [(h, p) for h, p in uploads if h not in on_dev]
            dev_up = [(h, p) for h, p in uploads if h in on_dev]
            if self.tp > 1:
                self._restore_across_ranks(seq_id, host_up, staged,
                                           [(p, on_dev[h]) for h, p in dev_up])
            elif host_up:
                from ..obs.flows import record_flow

                n = len(host_up)
                t1 = time.perf_counter()
                self.copy_stream.h2d_pages(self.k_pool, self.v_pool,
                                           [p for _, p in host_up],
                                           staged[0][:n], staged[1][:n])
                record_flow("h2d_prefetch",
                            staged[0][:n].nbytes + staged[1][:n].nbytes,
                            time.perf_counter() - t1, trace_id=seq_id)
            self._count_stalls(host_up)
            if dev_up:
                if self.tp == 1:
                    self._scatter_staged([(p, on_dev[h]) for h, p in dev_up])
                self.stage.prefetch_h2d_hits.inc(amount=float(len(dev_up)))
        self.restore_seconds += time.perf_counter() - t0
        return matched

    def _count_stalls(self, host_up: List[Tuple[int, int]]) -> None:
        """Host-tier uploads of hashes a prefetch was requested for count
        as prefetch stalls."""
        if not host_up:
            return
        with self._h2d_stage_lock:
            stalls = sum(h in self._h2d_requested for h, _ in host_up)
            self._h2d_requested.difference_update(h for h, _ in host_up)
        if stalls:
            self.stage.prefetch_h2d_stalls.inc(amount=float(stalls))

    def _scatter_staged(self, staged: List[Tuple[int, Tuple]]) -> None:
        """(page, prefetch-staged (k, v, event, ...)) blocks into their
        pages, device to device, after their upload's event; at tp > 1
        this rank's kv heads of them."""
        r = self._kv_heads[self.rank]
        ks = [st[0] for _, st in staged]
        vs = [st[1] for _, st in staged]
        if self.device.type == "cuda":
            # the side stream's uploads come first; the staged tensors are
            # then in use on this stream too
            cur = torch.cuda.current_stream(self.device)
            for ev in {id(st[2]): st[2] for _, st in staged}.values():
                cur.wait_event(ev)
            for t in ks + vs:
                t.record_stream(cur)
        if self.tp > 1:
            ks = [t[:, r.start:r.stop] for t in ks]
            vs = [t[:, r.start:r.stop] for t in vs]
        # dynalint: ok(flow-accounting) device to device: stage_prefetch
        # recorded these blocks' h2d (h2d_prefetch)
        self.copy_stream.scatter_blocks(
            self.k_pool, self.v_pool, [p for p, _ in staged], ks, vs)

    def _restore_across_ranks(self, seq_id: str,
                              host_up: List[Tuple[int, int]],
                              staged: List[np.ndarray],
                              dev_up: List[Tuple[int, Tuple]]) -> None:
        """tp > 1: one ``kv_restore`` frame for every restored page (the
        host-tier uploads, then the prefetch-staged blocks). The leader
        scatters each rank its kv heads of the whole host blocks; its own
        staged ones come from its device copies."""
        from ..obs.flows import record_flow

        n = len(host_up)
        parts: List[List[np.ndarray]] = [[], []]
        for i in range(2):
            if n:
                parts[i].append(staged[i][:n])
            parts[i] += [st[3][i][None] for _, st in dev_up]
        whole = [np.concatenate(p) for p in parts]
        arrs = {"pages": np.asarray([p for _, p in host_up]
                                    + [p for p, _ in dev_up], np.int64)}
        t1 = time.perf_counter()
        with self._framed("kv_restore", {"staged": len(dev_up)}, arrs):
            self._run_restore_program(arrs, whole, dev_up)
        if n:
            record_flow("h2d_prefetch",
                        staged[0][:n].nbytes + staged[1][:n].nbytes,
                        time.perf_counter() - t1, trace_id=seq_id)

    def _run_restore_program(self, arrs: Dict[str, np.ndarray],
                             whole: Optional[List[np.ndarray]] = None,
                             dev_up: List[Tuple[int, Tuple]] = ()) -> None:
        """tp > 1: this rank's kv heads of the leader's whole host blocks
        (``whole``: k, v [n, L, Hkv, page, Dh]) into ``pages``, through one
        host scatter a pool and an upload (``CopyStream.h2d_pages``); the
        leader's last ``len(dev_up)`` pages come from its staged device
        blocks instead."""
        t0 = time.perf_counter()
        pages = [int(p) for p in arrs["pages"]]
        m = self.cfg.model
        shape = (len(pages), m.num_layers, self.k_pool.shape[1],
                 self.page_size, m.head_dim)
        k, v = (collectives.scatter_heads(w, self.host_group, self._kv_heads,
                                          shape, host_dtype(m.dtype))
                for w in (whole or (None, None)))
        n = len(pages) - len(dev_up)
        if n:
            # dynalint: ok(flow-accounting) one rank's kv heads of the whole
            # blocks the leader records (h2d_prefetch)
            self.copy_stream.h2d_pages(self.k_pool, self.v_pool, pages[:n],
                                       k[:n], v[:n])
        if dev_up:
            self._scatter_staged(dev_up)
        self.kv_restore_bytes += k.nbytes + v.nbytes
        self.kv_restore_seconds += time.perf_counter() - t0

    def _admit_one(self, out: List[StepOutput]):
        """Admit the head-of-line request into a free slot (no prefill yet).
        Returns (slot_idx, slot), "rejected" (popped with an error emitted),
        "paged" (popped into the KV paging lane), or "blocked" (no KV
        capacity right now)."""
        seq_id, req = self.waiting[0]
        prompt = list(req.token_ids)
        over_ctx = len(prompt) >= self.cfg.max_context
        over_pool = (self.pool.pages_needed(len(prompt) + 1)
                     > self.pool.num_pages - 1)
        if over_ctx or over_pool:
            # beyond the dense path's reach: the paging lane's workload
            # when it is on; otherwise a typed 400 naming the limit (can
            # NEVER fit, even with an empty pool: reject, don't starve)
            self.waiting.popleft()
            if self.kvpager is not None:
                so = self.kvpager.try_route(seq_id, req)
                if so is None:
                    return "paged"
                out.append(so)
                return "rejected"
            if over_ctx:
                msg = (f"prompt of {len(prompt)} tokens exceeds the "
                       f"configured max_context of {self.cfg.max_context}")
            else:
                msg = (f"prompt of {len(prompt)} tokens cannot fit in the "
                       f"KV pool ({self.pool.num_pages - 1} pages)")
            out.append(StepOutput(
                seq_id, 0, 0.0, FinishReason.ERROR, error=msg,
                error_code=400, error_stage="engine_admission",
                error_reason="context_exceeded"))
            return "rejected"
        if not self.pool.can_admit(len(prompt) + 1):
            return "blocked"  # decode will free KV space eventually
        mm_spans = mm_soft = mm_host = None
        # lora_id salts the block-hash chain: blocks computed under
        # different adapters never alias in reuse or in the router index
        chain_salt = getattr(req, "lora_id", 0)
        if req.images:
            got = self._prepare_mm(req, prompt)
            if isinstance(got, str):
                self.waiting.popleft()
                out.append(StepOutput(seq_id, 0, 0.0, FinishReason.ERROR,
                                      error=got, error_code=400,
                                      error_stage="engine_admission"))
                return "rejected"
            mm_spans, mm_soft, img_digest = got
            if self.tp > 1:
                # once a request: the soft tokens' host copy its waves'
                # frames carry
                mm_host = self._to_host([mm_soft.to(self.cfg.model.dtype)])[0]
            # the same placeholder ids with different images never alias;
            # the frontend's salt, when set, is used verbatim so that the
            # router's overlap scoring hashes under the same salt
            chain_salt = (getattr(req, "kv_salt", 0)
                          or (chain_salt ^ img_digest) & ((1 << 63) - 1))
        self.waiting.popleft()
        slot_idx = self.slots.index(None)
        slot = _Slot(seq_id, req, prompt, mm_spans=mm_spans, mm_soft=mm_soft,
                     mm_host=mm_host)
        self.slots[slot_idx] = slot
        self.by_seq[seq_id] = slot
        self.pool.create(seq_id, lora_id=chain_salt)
        matched = 0
        if self.enable_prefix_reuse:
            matched = self._restore_prefix(seq_id, prompt)
            slot.prefill_done = slot.kv_written = matched
        self.last_prefix_hit = matched
        self.prefix_hit_tokens += matched
        self._pending_prefix_hit[seq_id] = matched
        self.prefix_query_tokens += len(prompt)
        self._load_sampling(slot_idx, req)
        return slot_idx, slot

    def _load_sampling(self, i: int, req: BackendInput) -> None:
        sp = req.sampling
        self.temperature[i] = float(sp.temperature or 0.0)
        self.top_p[i] = float(sp.top_p if sp.top_p is not None else 1.0)
        self.top_k[i] = int(min(sp.top_k or 0, STATIC_K))
        self.freq_pen[i] = float(sp.frequency_penalty or 0.0)
        self.pres_pen[i] = float(sp.presence_penalty or 0.0)
        if sp.seed is not None:
            # a resumed request folds its resume position into the seed:
            # the continuation gets a fresh deterministic stream
            seed = resume_seed(int(sp.seed),
                               int(getattr(req, "resume_pos", 0) or 0))
        else:
            seed = self._seed_source.getrandbits(63)
        self.generators[i] = lane_generator(seed)

    def _prefill_round(self, out: List[StepOutput]) -> None:
        """Advance every mid-prefill slot by one chunk and admit as many
        waiting requests as fit, all in ONE batched dispatch."""
        chunks = [(i, s) for i, s in enumerate(self.slots)
                  if s is not None and s.prefill_done < len(s.prompt)]
        while self.waiting and None in self.slots:
            admitted = self._admit_one(out)
            if admitted == "blocked":
                break
            if admitted in ("rejected", "paged"):
                continue
            chunks.append(admitted)
        if chunks:
            self._prefill_dispatch(chunks, out)

    def _prefill_dispatch(self, chunks: List[Tuple[int, _Slot]],
                          out: List[StepOutput]) -> None:
        """Advance each (slot_idx, slot) by one prompt chunk in a single
        batched dispatch; fetch all lanes' sampled tokens with ONE host
        round-trip and keep results only for lanes whose prompt completed."""
        cfg = self.cfg
        work = []  # (slot_idx, slot, start, count, is_last)
        for i, slot in chunks:
            start = slot.prefill_done
            if slot.mm_spans is not None:
                # never split an image span across chunks: its queries
                # need every span key written in the same dispatch
                count = mm.chunk_end(slot.mm_spans, start, cfg.prefill_chunk)
            else:
                count = min(len(slot.prompt) - start, cfg.prefill_chunk)
            try:
                self.pool.extend(slot.seq_id,
                                 slot.prompt[start:start + count])
            except OutOfPages:
                out.append(StepOutput(slot.seq_id, 0, 0.0, FinishReason.ERROR,
                                      error="out of KV pages during prefill"))
                self._free_slot(i)
                continue
            work.append((i, slot, start, count,
                         start + count == len(slot.prompt)))
        if not work:
            return
        self._flush_evictions()   # extend() may have evicted pages
        Bp = len(work)
        C = max(w[3] for w in work)
        S = max(w[2] + w[3] for w in work)
        tokens = np.zeros((Bp, C), np.int64)
        positions = np.zeros((Bp, C), np.int32)
        write_idx = np.zeros((Bp, C), np.int64)   # pad -> scratch page 0
        read_idx = np.zeros((Bp, S), np.int64)
        read_pos = np.zeros((Bp, S), np.int32)
        read_valid = np.zeros((Bp, S), bool)
        last_i = np.zeros(Bp, np.int64)
        uniforms = np.zeros(Bp, np.float32)
        # an image wave: some lane's chunk holds image positions
        image_wave = any(
            w[1].mm_spans is not None
            and w[1].mm_spans[w[2]:w[2] + w[3]].any() for w in work)
        if image_wave:
            q_span = np.zeros((Bp, C), np.int32)
            read_span = np.zeros((Bp, S), np.int32)
            ov_rows = np.zeros((Bp, C), np.int64)  # row of the lane's soft
            ov_mask = np.zeros((Bp, C), bool)
        for lane, (i, slot, start, count, is_last) in enumerate(work):
            tokens[lane, :count] = slot.prompt[start:start + count]
            positions[lane, :count] = np.arange(start, start + count)
            write_idx[lane, :count] = self.pool.write_slots(
                slot.seq_id, start, count)
            r_s, r_p, r_v = self.pool.read_slots(slot.seq_id,
                                                 start + count, S)
            read_idx[lane], read_pos[lane], read_valid[lane] = r_s, r_p, r_v
            last_i[lane] = count - 1
            if is_last:
                # only lanes that really sample consume a draw
                uniforms[lane] = float(torch.rand(
                    1, generator=self.generators[i]))
            if image_wave and slot.mm_spans is not None:
                spans = slot.mm_spans
                # soft_token_rows over a table of row numbers: each image
                # position's row of the flattened soft tokens
                table = np.arange(len(slot.mm_soft), dtype=np.int64)
                rows, maskv = mm.soft_token_rows(
                    spans, table.reshape(int(spans.max()), -1, 1),
                    start, count)
                ov_rows[lane, :count] = rows[:, 0]
                ov_mask[lane, :count] = maskv
                q_span[lane, :count] = spans[start:start + count]
                # context slots map position -> image group (0 past prompt)
                sp = np.zeros(S, np.int32)
                n = min(len(spans), S)
                sp[:n] = spans[:n]
                read_span[lane] = np.where(r_v, sp[np.minimum(r_p, S - 1)],
                                           0)
        t0 = time.perf_counter()
        d = self.device
        idx = [w[0] for w in work]
        mm_kw: Optional[Dict[str, Any]] = None
        arrs = {"tokens": tokens, "positions": positions,
                "write_idx": write_idx, "read_idx": read_idx,
                "read_pos": read_pos, "read_valid": read_valid,
                "last_i": last_i, "temp": self.temperature[idx],
                "top_p": self.top_p[idx], "top_k": self.top_k[idx],
                "uniforms": uniforms}
        if image_wave and self.tp > 1:
            # JAX's four arrays, with ov_vals compact: only the soft-token
            # rows the wave reads (ov_rows indexes them), not a dense
            # [Bp, C, hidden] buffer
            parts, at = [], 0
            for lane, w in enumerate(work):
                if w[1].mm_spans is None:
                    continue
                hit = ov_mask[lane]
                parts.append(w[1].mm_host[ov_rows[lane][hit]])
                ov_rows[lane][hit] = at + np.arange(int(hit.sum()))
                ov_rows[lane][~hit] = 0
                at += int(hit.sum())
            arrs.update(ov_vals=np.concatenate(parts), ov_rows=ov_rows,
                        ov_mask=ov_mask, q_span=q_span, read_span=read_span)
        elif image_wave:
            ov_vals = torch.zeros((Bp, C, cfg.model.hidden_size),
                                  dtype=cfg.model.dtype, device=d)
            for lane, w in enumerate(work):
                if w[1].mm_spans is not None:
                    ov_vals[lane] = w[1].mm_soft[to_device(ov_rows[lane], d)]
            mask_d = to_device(ov_mask, d)
            mm_kw = dict(embed_override=(ov_vals, mask_d),
                         attn_spans=(to_device(q_span, d),
                                     to_device(read_span, d)))
        self.image_waves += image_wave
        with self._framed("prefill", {
                "Bp": Bp, "C": C, "S": S, "seeds": [],
                "last_lanes": [lane for lane, w in enumerate(work) if w[4]],
                "mm": image_wave}, arrs):
            sampled = self._run_prefill_program(arrs, mm_kw)
        # dynalint: ok(host-sync) the prefill dispatch's designed fetch: every
        # lane's (token, logprob) in one packed read a dispatch
        packed = sampled.cpu().numpy()                    # 1 fetch
        elapsed = time.perf_counter() - t0
        for ev in self._vision_events:    # complete: the fetch synced
            self.vision_seconds += ev[0].elapsed_time(ev[1]) / 1e3
        self._vision_events.clear()
        self.prefill_dispatches += 1
        self.prefill_seconds += elapsed
        fl, by, tk = roofline.prefill_cost(
            self.costs, [(w[2], w[3]) for w in work])
        self.goodput.account(fl, by, elapsed, tk)
        for lane, (i, slot, start, count, is_last) in enumerate(work):
            slot.prefill_done = slot.kv_written = start + count
            if not is_last:
                continue
            t = int(packed[lane, 0])
            lp = float(packed[lane, 1])
            try:
                slot.generated += 1
                slot.last_token = t
                self.pool.extend(slot.seq_id, [t])
            except OutOfPages:
                out.append(StepOutput(slot.seq_id, t, lp, FinishReason.ERROR,
                                      error="out of KV pages appending the "
                                            "first generated token"))
                self._free_slot(i)
                continue
            slot.cum_logprob += lp
            fin = self._finish_reason(slot, t)
            out.append(StepOutput(slot.seq_id, t, slot.cum_logprob, fin,
                                  prompt_tokens=len(slot.prompt),
                                  token_logprob=lp))
            if fin is not None:
                self._free_slot(i)

    def _run_prefill_program(self, arrs: Dict[str, np.ndarray],
                             mm_kw: Optional[Dict[str, Any]] = None
                             ) -> torch.Tensor:
        """A prefill dispatch's device program, from its host inputs alone
        (every rank runs it): one forward over the lanes' chunks, writing
        their KV, and each lane's sampled (token, logprob) as a device
        tensor [Bp, 2]. Image waves take the dense path (the span or-mask
        has no kernel input); text waves keep the flash kernel. An image
        wave's inputs are the tp=1 leader's device ``mm_kw``, or at tp > 1
        the frame's arrays: the soft-token rows it reads (``ov_vals``,
        indexed by ``ov_rows`` under ``ov_mask``) and the spans."""
        d, m = self.device, self.cfg.model
        if mm_kw is None and "ov_vals" in arrs:
            vals = to_device(from_host_array(arrs["ov_vals"], m.dtype), d)
            mm_kw = dict(
                embed_override=(vals[to_device(arrs["ov_rows"], d)],
                                to_device(arrs["ov_mask"], d)),
                attn_spans=(to_device(arrs["q_span"], d),
                            to_device(arrs["read_span"], d)))
        logits, _, _ = llama.forward(
            self.params, m, to_device(arrs["tokens"], d),
            to_device(arrs["positions"], d), self.k_pool, self.v_pool,
            to_device(arrs["write_idx"], d), to_device(arrs["read_idx"], d),
            to_device(arrs["read_pos"], d), to_device(arrs["read_valid"], d),
            attn_impl="dense" if mm_kw else "flash",
            logits_idx=to_device(arrs["last_i"], d), group=self.group,
            **(mm_kw or {}))
        tok, logp = sample(logits[:, 0], to_device(arrs["temp"], d),
                           to_device(arrs["top_p"], d),
                           to_device(arrs["top_k"], d),
                           to_device(arrs["uniforms"], d))
        return torch.stack([tok.float(), logp], -1)

    def _finish_reason(self, slot: _Slot, token: int) -> Optional[FinishReason]:
        req = slot.request
        if not req.stop.ignore_eos:
            eos = set(req.eos_token_ids) | set(req.stop.stop_token_ids)
            if token in eos and slot.generated >= (req.stop.min_tokens or 0):
                return FinishReason.EOS
        if req.stop.max_tokens and slot.generated >= req.stop.max_tokens:
            return FinishReason.LENGTH
        if len(slot.prompt) + slot.generated >= self.cfg.max_context:
            return FinishReason.LENGTH
        return None

    # ------------------------------------------------------------------
    def _decode_eligible(self, lookahead: Optional[int] = None):
        """(slot_idx, slot, phys_len) for every decode-ready slot whose next
        dispatch's pages could be reserved; deferred = ready but no pages.
        ``phys_len`` counts the tokens every enqueued dispatch has fed.
        ``lookahead`` is the page reservation beyond phys (default: the
        decode dispatch's steps; the spec path passes its verify window)."""
        N = self.cfg.decode_steps if lookahead is None else lookahead
        active, deferred = [], []
        for i, slot in enumerate(self.slots):
            if slot is None or slot.prefill_done < len(slot.prompt):
                continue
            phys = slot.sched_len or (len(slot.prompt) + slot.generated)
            try:
                # reserve room for N speculative tokens up front
                self.pool.ensure_pages(slot.seq_id, phys + N)
            except OutOfPages:
                # pool pressure: batchmates finishing will free pages
                deferred.append((i, slot))
                continue
            active.append((i, slot, phys))
        return active, deferred

    def _can_chain(self) -> bool:
        """True if the next decode dispatch can be enqueued straight off the
        in-flight one's tokens on the device: the same lanes holding the
        same sequences, pages for every lane, and only one dispatch
        outstanding."""
        if len(self._inflight) != 1:
            return False
        rec = self._inflight[-1]
        # the chained dispatch feeds the previous dispatch's final tokens to
        # every lane, so the decode-ready set must be exactly its lanes: a
        # newly injected slot (remote prefill) or a deferred slot unblocking
        # has a last_token the device lacks
        ready_now = {i for i, s in enumerate(self.slots)
                     if s is not None and s.prefill_done >= len(s.prompt)}
        if ready_now != {i for i, _, _ in rec["active"]}:
            return False
        if any(self.slots[i] is not slot for i, slot, _ in rec["active"]):
            return False
        N = self.cfg.decode_steps
        for _, slot, _ in rec["active"]:
            try:
                self.pool.ensure_pages(slot.seq_id, slot.sched_len + N)
            except OutOfPages:
                return False
        return True

    def _evict_largest_deferred(self, deferred, out: List[StepOutput]) -> None:
        """No decode-ready lane can be dispatched and every deferred lane is
        blocked on KV capacity: evict the largest consumer so the rest of
        the system unblocks (capacity error)."""
        i, slot = max(deferred,
                      key=lambda t: len(self.pool.seqs[t[1].seq_id].pages))
        out.append(StepOutput(
            slot.seq_id, slot.last_token, slot.cum_logprob,
            FinishReason.ERROR,
            error="evicted under KV pool pressure (no capacity to "
                  "continue decoding)"))
        self._free_slot(i)

    def _dispatch_decode(self, out: Optional[List[StepOutput]] = None) -> None:
        """Enqueue one multi-step decode dispatch over every decode-ready
        lane WITHOUT fetching its results: ``decode_steps`` forward+sample
        iterations with the sampled token fed straight back on the device.
        With a dispatch in flight, chain off its final tokens on the device
        (no host data dependency). Lanes that finish mid-dispatch overshoot
        harmlessly into their own pre-allocated pages; the fetch trims
        them."""
        N = self.cfg.decode_steps
        chain = bool(self._inflight)
        active, deferred = self._decode_eligible()
        if not active:
            if deferred and not chain and out is not None:
                self._evict_largest_deferred(deferred, out)
            return
        self._flush_evictions()   # ensure_pages() may have evicted pages
        t0 = time.perf_counter()
        idx = [i for i, _, _ in active]
        P = -(-max(phys + N for _, _, phys in active) // self.page_size)
        page_tables = np.stack([self.pool.page_table_row(s.seq_id, P)
                                for _, s, _ in active])
        lengths = np.asarray([phys for _, _, phys in active], np.int32)
        for _, slot, phys in active:
            slot.sched_len = phys + N
            # the N tokens fed in sit at positions phys-1 .. phys+N-2
            slot.kv_written = phys + N - 1
        arrs = {"lanes": np.asarray(idx, np.int64),
                "page_tables": page_tables, "lengths": lengths,
                "temp": self.temperature[idx], "top_p": self.top_p[idx],
                "top_k": self.top_k[idx], "freq_pen": self.freq_pen[idx],
                "pres_pen": self.pres_pen[idx],
                "uniforms": host_uniforms([self.generators[i] for i in idx],
                                          N)}
        if not chain:
            # a chained dispatch feeds the device's own tokens and has the
            # same sequences; otherwise a sequence entering decode
            # restarts its penalty counts at one-hot(its last token)
            arrs["tokens"] = np.asarray([s.last_token for _, s, _ in active],
                                        np.int64)
            arrs["fresh"] = np.asarray(
                [self._decode_seen.get(i) != slot.seq_id
                 for i, slot, _ in active], bool)
            for i, slot, _ in active:
                self._decode_seen[i] = slot.seq_id
        with self._framed("decode", {"S": P * self.page_size,
                                     "chain": chain}, arrs):
            packed = self._run_decode_program(arrs)
        ready = None
        if packed.is_cuda:
            # into pinned memory behind the dispatch; the host waits on the
            # event only when it processes this record
            host = torch.empty(packed.shape, dtype=packed.dtype,
                               pin_memory=True)
            host.copy_(packed, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
            packed = host
        self._inflight.append({"packed": packed, "ready": ready,
                               "active": active,
                               "lengths": [phys for _, _, phys in active],
                               "chained": chain, "dispatched_at": t0})
        self.decode_dispatches += 1
        self.decode_chained += chain
        self.decode_steps_run += N
        # flight recorder: the hang watchdog judges "a dispatch in flight
        # with no fetch completing for N x the EWMA step time" off this
        _flightrec.hb_begin("engine.decode", stall="decode")
        _flightrec.note_event("engine.dispatch", depth=len(self._inflight),
                              batch=len(active), steps=N)

    def _run_decode_program(self, arrs: Dict[str, np.ndarray]
                            ) -> torch.Tensor:
        """A decode dispatch's device program, from its host inputs alone
        (every rank runs it): the penalty-count resets of sequences
        entering decode, then ``N`` forward+sample steps over the lanes
        with each sampled token fed straight back, paged attention off the
        pool. Without ``tokens`` in ``arrs`` it chains off the previous
        program's tokens on the device. Returns the packed (token,
        logprob) [N, Ba, 2] on the device."""
        d, m = self.device, self.cfg.model
        uniforms = to_device(arrs["uniforms"], d)
        N = uniforms.shape[0]
        if "tokens" in arrs:
            tok = to_device(arrs["tokens"], d)
            fresh = arrs["fresh"]
            if fresh.any():
                # the rows and columns go up pinned: a Python-scalar
                # setitem (`counts[i, t] = 1`) would wait on a pageable
                # copy of its value
                rows = to_device(arrs["lanes"][fresh], d)
                cols = to_device(arrs["tokens"][fresh], d)
                self.gen_counts.index_fill_(0, rows, 0)
                self.gen_counts.index_put_(
                    (rows, cols), torch.ones(len(rows), device=d,
                                             dtype=self.gen_counts.dtype))
        else:
            tok = self._chain_tok
        lane = to_device(arrs["lanes"], d)
        temp, top_p, top_k = (to_device(arrs[k], d)
                              for k in ("temp", "top_p", "top_k"))
        freq = to_device(arrs["freq_pen"], d)
        pres = to_device(arrs["pres_pen"], d)
        pt = to_device(arrs["page_tables"], d)
        ln = to_device(arrs["lengths"], d)
        toks, logps = [], []
        for j in range(N):
            logits, _, _ = llama.forward_decode(
                self.params, m, tok, self.k_pool, self.v_pool, pt, ln,
                attn_impl="paged", group=self.group)
            lg = apply_penalties(logits[:, 0], self.gen_counts[lane], freq,
                                 pres)
            tok, logp = sample(lg, temp, top_p, top_k, uniforms[j])
            self.gen_counts[lane, tok] += 1
            toks.append(tok)
            logps.append(logp)
            ln = ln + 1
        self._chain_tok = tok
        return torch.stack([torch.stack(toks).float(), torch.stack(logps)],
                           -1)                        # [N, Ba, 2]

    # ------------------------------------------------------------------
    # model mobility: a weight swap on every rank
    # ------------------------------------------------------------------
    def swap_weights(self, new_cfg, host_params=None,
                     group_layers: Optional[int] = None):
        """Overwrite the weights in place with the sibling ``new_cfg``
        names (engine thread, post-drain): ``hot_swap`` from
        ``host_params`` at tp=1. At tp > 1 every rank overwrites its own
        shard from the cut its :meth:`prefetch_shards` staged (loaded now
        where it has not): the leader's gate and every rank's residency
        check run before the ``swap`` frame, so a typed ``SwapError``
        leaves every rank serving the old model."""
        from ..fleet.mobility import swap as sw

        if self.tp == 1:
            return sw.hot_swap(self, host_params, new_cfg, group_layers)
        t0 = time.monotonic()
        sw.check_swap(self, new_cfg)
        src = _shard_source(new_cfg)
        with self._framed("swap_check", src, {}):
            bad = self._run_swap_check(src)
        if bad is not None:
            why = ("has no resident cut" if bad == "weights_unavailable"
                   else "has a cut that does not fit its shard")
            raise sw.SwapError(bad, f"a rank {why} of {src['key']}")
        demoted = self.flush_reusable()
        meta = dict(src, group_layers=group_layers,
                    preset=getattr(new_cfg, "preset", None))
        with self._framed("swap", meta, {}):
            groups, nbytes, secs = self._run_swap_program(meta)
        sw.clear_kv(self)
        return sw.finish_swap(self, new_cfg, t0, groups, demoted, nbytes,
                              secs)

    def prefetch_shards(self, new_cfg) -> None:
        """Stage this tp engine's cut of the sibling ``new_cfg`` names on
        every rank: a ``swap_prefetch`` frame, each rank loading its own
        cut into its own host weight cache in the background (the swap
        agent's prefetch hint). Engine thread."""
        src = _shard_source(new_cfg)
        with self._framed("swap_prefetch", src, {}):
            self._shard_cache().prefetch(src["key"], src)

    def _shard_cache(self):
        """This rank's host cache of sibling cuts (pinned on a card)."""
        if self._shards is None:
            from ..fleet.mobility.weightcache import WeightCache

            self._shards = WeightCache(loader=self._load_shard,
                                       pinned=self.device.type == "cuda")
        return self._shards

    def _load_shard(self, key: str, src: Dict[str, Any]):
        """This rank's host cut of a sibling: placed from its checkpoint
        (``engine/loader.py``'s shard placement), else drawn from its seed
        as a fresh engine of that seed draws it here."""
        m, tp, rank = self.cfg.model, self.tp, self.rank
        host = torch.device("cpu")
        path = src.get("params_path")
        if path and _has_safetensors(path):
            from .loader import load_llama_params

            return load_llama_params(path, m, host, tp, rank)
        if path and (gguf := _gguf_file(path)):
            from ..llm.gguf import load_llama_params_gguf

            return load_llama_params_gguf(gguf, cfg=m, device=host,
                                          dtype=m.dtype, tp=tp,
                                          rank=rank)[1]
        gen = torch.Generator(device=self.device).manual_seed(
            int(src["seed"]))
        # drawn where a fresh engine of that seed draws it, then to the host
        # in one event wait; on this rank's card, whichever thread loads
        # (the prefetch thread's current device is cuda:0)
        with torch.no_grad(), (torch.cuda.device(self.device)
                               if self.device.type == "cuda"
                               else contextlib.nullcontext()):
            tree = llama.init_params(m, gen, self.device, tp, rank)
            keys = [(k, n) for k, v in tree.items()
                    for n in (v if isinstance(v, dict) else (None,))]
            leaves = [tree[k] if n is None else tree[k][n] for k, n in keys]
            dtypes = [t.dtype for t in leaves]
            host = self._to_host(leaves)
            del tree, leaves
        out: Dict[str, Any] = {}
        for (k, n), a, dt in zip(keys, host, dtypes):
            t = from_host_array(a, dt)
            if n is None:
                out[k] = t
            else:
                out.setdefault(k, {})[n] = t
        return out

    def _run_swap_check(self, src: Dict[str, Any]) -> Optional[str]:
        """Every rank: its cut of ``src`` resident (loaded now if the
        prefetch has not landed) and shaped as its shard, reduced over the
        ranks (the most severe status wins). Returns the refusal's reason,
        or None when every rank can swap."""
        from ..fleet.mobility import swap as sw

        # the check holds the very tree the swap frame overwrites from: a
        # cut over the cache's budget is returned here but never kept, and
        # a kept one may be evicted before the frame
        self._swap_tree = None
        tree = self._shard_cache().load_now(src["key"], src)
        status = 0
        if tree is None:
            status = 1
        else:
            try:
                sw.check_tree(self, tree)
            except sw.SwapError:
                status = 2
        import torch.distributed as dist

        flag = to_device(np.asarray([float(status)], np.float32),
                         self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.group)
        # dynalint: ok(host-sync) the swap's residency check, once a swap,
        # with the engine drained
        status = int(flag.cpu()[0])
        if status:
            return ("weights_unavailable", "shape_mismatch")[status - 1]
        self._swap_tree = tree
        return None

    def _run_swap_program(self, meta: Dict[str, Any]
                          ) -> Tuple[int, int, float]:
        """Every rank: overwrite its shard in place from the cut its
        swap check held (the ``swap`` frame's program), then agree again
        with the other ranks on the new weights; returns (groups, bytes,
        seconds of the stream to its barrier)."""
        from ..fleet.mobility import swap as sw

        tree, self._swap_tree = self._swap_tree, None
        new_flat, old_flat = sw.check_tree(self, tree)
        t0 = time.monotonic()
        groups, nbytes = sw.overwrite(self, new_flat, old_flat,
                                      meta.get("group_layers"))
        sw.barrier(self)
        secs = time.monotonic() - t0
        self.swap_bytes += nbytes
        self.swap_seconds += secs
        self.cfg = replace(self.cfg, params_path=meta.get("params_path"),
                           preset=meta.get("preset"))
        self._check_ranks_agree()
        return groups, nbytes, secs

    def mirror_dispatch(self, kind: str, meta: Dict[str, Any],
                        arrs: Dict[str, np.ndarray]) -> None:
        """A follower's replay of a leader dispatch (the JAX engine's
        multi-host mirror): the same device program on the same host
        inputs, so this rank's shard of the KV pool, its penalty counts
        and its chained tokens advance in lockstep with the leader's.
        Nothing is read back: only the leader streams tokens."""
        with torch.no_grad():
            if kind == "prefill":
                self._run_prefill_program(arrs)
                self.prefill_dispatches += 1
                self.image_waves += bool(meta.get("mm"))
            elif kind == "decode":
                self._run_decode_program(arrs)
                self.decode_dispatches += 1
                self.decode_chained += bool(meta.get("chain"))
                self.decode_steps_run += int(arrs["uniforms"].shape[0])
            elif kind == "verify":
                self._run_verify_program(arrs)
                self.spec_dispatch_total += 1
                self.spec_k_rounds[int(meta["K"])] += 1
            elif kind == "kv_offload":
                self._run_offload_program(arrs)
            elif kind == "kv_restore":
                self._run_restore_program(arrs)
            elif kind == "kv_extract":
                self._run_extract_program(arrs, meta)
            elif kind == "kv_inject":
                self._run_inject_program(arrs, meta)
            elif kind in ("kvpage_prefill", "kvpage_decode"):
                self.kvpager.mirror(kind, meta, arrs)
            elif kind == "swap_prefetch":
                self._shard_cache().prefetch(meta["key"], meta)
            elif kind == "swap_check":
                self._run_swap_check(meta)
            elif kind == "swap":
                self._run_swap_program(meta)
            elif kind == "stats":
                self._gather_rank_stats()
            else:
                raise ValueError(f"unknown dispatch kind {kind!r}")

    @contextlib.contextmanager
    def _framed(self, kind: str, meta: Dict[str, Any],
                arrs: Dict[str, np.ndarray]):
        """Around a device program's run here: first hand its frame
        (``kind``, ``meta`` and the host inputs ``arrs`` the program reads)
        to the followers, which replay it through :meth:`mirror_dispatch`
        in the same order; ``frames_done`` catches up once the block
        returned."""
        if self.dispatch_hook is not None:
            self._publish(kind, meta, arrs)
        yield
        self.frames_done = self.frames_out

    def _publish(self, kind: str, meta: Dict[str, Any],
                 arrs: Dict[str, np.ndarray]) -> None:
        self.dispatch_hook(kind, meta, arrs)
        self.frames_out += 1

    def refresh_rank_stats(self) -> List[Dict[str, float]]:
        """Leader, engine thread, between dispatches: gather every rank's
        counters into :attr:`rank_stats` (one ``stats`` frame, one
        collective)."""
        if self.tp == 1:
            return self.rank_stats
        with self._framed("stats", {}, {}):
            self._gather_rank_stats()
        return self.rank_stats

    def _gather_rank_stats(self) -> None:
        from ..ops import attention as att
        from ..parallel import collectives

        self.rank_stats_begun += 1
        begun = self.rank_stats_begun
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)
        mine = [float(att.flash_attention.launches),
                float(att.paged_attention.launches),
                float(self.prefill_dispatches), float(self.decode_dispatches),
                float(self.decode_steps_run), float(_tree_nbytes(self.params)),
                float(peak), float(self.spec_dispatch_total),
                float(self.kv_restore_bytes), self.kv_restore_seconds,
                float(self.kv_offload_bytes), self.kv_offload_seconds,
                float(self.kvpager.pagein_bytes if self.kvpager else 0),
                self.kvpager.stage_seconds if self.kvpager else 0.0,
                float(self.swap_bytes), self.swap_seconds]
        k = len(mine)
        got = to_device(np.zeros(k * self.tp, np.float64), self.device)
        got[self.rank * k:(self.rank + 1) * k] = to_device(
            np.asarray(mine, np.float64), self.device)
        collectives.all_reduce_(got, self.group)
        # dynalint: ok(host-sync) the ranks' counters, read between
        # dispatches with the engine idle (refresh_rank_stats)
        vals = got.cpu().tolist()
        self.rank_stats = [dict(zip(RANK_STATS, vals[r * k:(r + 1) * k]))
                           for r in range(self.tp)]
        self.rank_stats_seq = begun

    def _process_oldest_inflight(self) -> List[StepOutput]:
        """Wait for the oldest in-flight dispatch's results on the host and
        account them: lanes freed since the dispatch are discarded, and a
        lane that finishes is freed at once, its overshoot tokens
        dropped."""
        rec = self._inflight.popleft()
        if rec["ready"] is not None:
            # dynalint: ok(host-sync) the decode window's designed wait: the
            # event behind the oldest dispatch's pinned copy, taken with the
            # next dispatch already enqueued
            rec["ready"].synchronize()
        # dynalint: ok(host-sync) a view of the pinned host copy the event wait
        # above completed (host memory on the CPU path): no transfer of its own
        packed = rec["packed"].numpy()                  # [N, Ba, 2]
        # the JAX engine's decode_step reading: dispatch to results on the
        # host, which overlaps between chained dispatches; here the dispatch
        # starts before its host enqueue
        elapsed = time.perf_counter() - rec["dispatched_at"]
        self.decode_seconds += elapsed
        N = packed.shape[0]
        self.stage.decode_step.observe(value=elapsed / N)
        # after the fetch (a wedged device shows up there): feed the
        # watchdog's step-time EWMA and balance hb_begin
        _flightrec.hb_done("engine.decode", elapsed / N)
        _flightrec.note_event("engine.step", s=round(elapsed, 6), n=N,
                              compiled=False)
        fl, by, tk = roofline.decode_cost(self.costs, rec["lengths"], N)
        self.goodput.account(fl, by, elapsed, tk)
        outs: List[StepOutput] = []
        for a, (i, slot, _) in enumerate(rec["active"]):
            if self.slots[i] is not slot:
                continue   # freed since dispatch (finish/cancel): discard
            for j in range(N):
                t = int(packed[j, a, 0])
                self.pool.account_tokens(slot.seq_id, [t])
                slot.generated += 1
                slot.last_token = t
                tok_lp = float(packed[j, a, 1])
                slot.cum_logprob += tok_lp
                fin = self._finish_reason(slot, t)
                outs.append(StepOutput(slot.seq_id, t, slot.cum_logprob, fin,
                                       token_logprob=tok_lp))
                if fin is not None:
                    # overshoot tokens past the finish are discarded; their
                    # writes land in this sequence's own pages, held until
                    # the window drains
                    self._free_slot(i)
                    break
        return outs

    # ------------------------------------------------------------------
    # speculative decoding (engine/spec.py owns proposers and state)
    # ------------------------------------------------------------------
    @staticmethod
    def _spec_opt_out(req: BackendInput) -> bool:
        """Lanes that must not speculate (they still ride the verify
        dispatch with zero drafts, which IS a plain single-token decode
        step): per-request opt-out, and penalty requests, whose counts the
        verify applies per dispatch, which is exact only when each dispatch
        commits one token."""
        if getattr(req, "no_spec", False):
            return True
        sp = req.sampling
        return bool(sp.frequency_penalty or sp.presence_penalty)

    def _spec_seq_state(self, slot: _Slot) -> SeqSpecState:
        st = self._spec_states.get(slot.seq_id)
        if st is None:
            # created at first decode entry: exactly one generated token
            # exists (the prefill- or injection-sampled first token)
            st = SeqSpecState(tokens=list(slot.prompt) + [slot.last_token],
                              k=self.spec.k_max,
                              pending=[slot.last_token])
            self._spec_states[slot.seq_id] = st
        return st

    def _spec_round(self, out: List[StepOutput]) -> None:
        """One synchronous speculative-decoding round over the decode-ready
        lanes (compact: active lanes only): propose up to k drafts a lane,
        verify all of them in ONE forward over K+1 positions (the flash
        kernel), sample acceptance on the device, fetch it once, and commit
        only accepted tokens plus one correction or bonus token a lane.
        The proposals, the bucket K and the commit are the leader's host
        plan; the device work is :meth:`_run_verify_program` on the
        ``verify`` frame's arrays, which every rank runs. The commit
        changes no device state: the next round's frame folds its tokens
        into the penalty counts."""
        sp = self.spec
        t0 = time.perf_counter()
        # reserve the whole verify window (k_max drafts + bonus) up front:
        # rollback is then pure bookkeeping, never data movement
        active, deferred = self._decode_eligible(lookahead=sp.k_max + 1)
        if not active:
            if deferred:
                self._evict_largest_deferred(deferred, out)
            return
        self._flush_evictions()   # ensure_pages() may have evicted pages
        drafts: List[List[int]] = []
        for i, slot, _ in active:
            st = self._spec_seq_state(slot)
            d: List[int] = []
            if not self._spec_opt_out(slot.request):
                d = [int(x) for x in
                     self.proposer.propose(slot.seq_id, st, st.k)[:st.k]]
            drafts.append(d)
            self.spec_proposed_total += len(d)
            if d:
                self.stage.spec_proposed.inc(amount=float(len(d)))

        K = sp.bucket(max(len(d) for d in drafts))
        T, U = K + 1, sp.k_max + 1
        Ba = len(active)
        S = max(phys for _, _, phys in active) + K
        tokens = np.zeros((Ba, T), np.int64)
        positions = np.zeros((Ba, T), np.int32)
        write_idx = np.zeros((Ba, T), np.int64)
        read_idx = np.zeros((Ba, S), np.int64)
        read_pos = np.zeros((Ba, S), np.int32)
        read_valid = np.zeros((Ba, S), bool)
        upd_tok = np.zeros((Ba, U), np.int64)
        upd_mask = np.zeros((Ba, U), np.int32)
        fresh = np.zeros(Ba, bool)
        for a, ((i, slot, phys), d) in enumerate(zip(active, drafts)):
            # column 0 is the last committed token (its KV is written here,
            # as in single-token decode); columns 1.. are its drafts
            tokens[a, 0] = slot.last_token
            tokens[a, 1:1 + len(d)] = d
            positions[a] = np.arange(phys - 1, phys - 1 + T)
            write_idx[a] = self.pool.write_slots(slot.seq_id, phys - 1, T)
            # causality masks the not-yet-written tail per query; validity
            # only needs the lane's coverage
            read_idx[a], read_pos[a], read_valid[a] = self.pool.read_slots(
                slot.seq_id, phys + K, S)
            upd = self._spec_states[slot.seq_id].pending[-U:]
            upd_tok[a, :len(upd)] = upd
            upd_mask[a, :len(upd)] = 1
            if self._decode_seen.get(i) != slot.seq_id:
                fresh[a] = True
                self._decode_seen[i] = slot.seq_id
        idx = [i for i, _, _ in active]
        arrs = {"lanes": np.asarray(idx, np.int64), "fresh": fresh,
                "upd_tok": upd_tok, "upd_mask": upd_mask, "tokens": tokens,
                "positions": positions, "write_idx": write_idx,
                "read_idx": read_idx, "read_pos": read_pos,
                "read_valid": read_valid, "temp": self.temperature[idx],
                "top_p": self.top_p[idx], "top_k": self.top_k[idx],
                "freq_pen": self.freq_pen[idx],
                "pres_pen": self.pres_pen[idx],
                "uniforms": spec_uniforms(
                    [self.generators[i] for i in idx], K, sp.k_max)}
        t_v = time.perf_counter()
        with self._framed("verify", {"S": S, "K": K}, arrs):
            packed = self._run_verify_program(arrs)
        # dynalint: ok(host-sync) the verify round's designed fetch: one packed
        # read a round (spec decode is synchronous by round)
        r = spec_unpack(packed.cpu().numpy(), K)      # ONE host fetch
        elapsed = time.perf_counter() - t_v
        self.spec_dispatch_total += 1
        self.spec_k_rounds[K] += 1
        fl, by, tk = roofline.verify_cost(
            self.costs, [phys for _, _, phys in active], T)
        self.goodput.account(fl, by, elapsed, tk)
        n_emitted = 0
        for a, ((i, slot, phys), d) in enumerate(zip(active, drafts)):
            st = self._spec_states[slot.seq_id]
            toks, lps, acc = spec_accept(
                d, float(self.temperature[i]) <= 0.0,
                {k: v[a] for k, v in r.items()})
            self.spec_accepted_total += acc
            if d:
                self.spec_lane_rounds += 1
                self.stage.spec_accepted.inc(amount=float(acc))
                self.stage.spec_per_dispatch.observe(value=float(acc))
            # positions phys-1 .. phys-1+acc hold committed tokens' KV; the
            # last emitted token's slot holds a rejected draft's, or none
            slot.kv_written = phys + acc
            st.pending = []
            for tok, lp in zip(toks, lps):
                self.pool.account_tokens(slot.seq_id, [tok])
                slot.generated += 1
                slot.last_token = tok
                slot.cum_logprob += lp
                st.tokens.append(tok)
                st.pending.append(tok)
                n_emitted += 1
                fin = self._finish_reason(slot, tok)
                out.append(StepOutput(slot.seq_id, tok, slot.cum_logprob,
                                      fin, token_logprob=lp))
                if fin is not None:
                    self._free_slot(i)
                    break
            if d and self.slots[i] is slot:
                st.k = sp.next_k(st.k, acc, len(d))
        if n_emitted:
            self.stage.decode_step.observe(value=elapsed / n_emitted)
        self.spec_seconds += time.perf_counter() - t0

    def _run_verify_program(self, arrs: Dict[str, np.ndarray]
                            ) -> torch.Tensor:
        """A speculative round's device program, from its host inputs alone
        (every rank runs it): the penalty-count resets of sequences entering
        decode (``fresh``) and the fold of each lane's committed tokens
        (``upd_tok`` under ``upd_mask``), ONE forward over the K+1
        positions of every lane (the flash kernel, this rank's heads), and
        the acceptance sampling on the lanes' ``uniforms``. Returns the
        packed verify result [Ba, spec_pack_width(K)] on the device."""
        d, m = self.device, self.cfg.model
        lanes, fresh = arrs["lanes"], arrs["fresh"]
        lane = to_device(lanes, d)
        if fresh.any():
            # a sequence entering decode restarts its penalty counts; the
            # fold below adds its first generated token
            self.gen_counts.index_fill_(0, to_device(lanes[fresh], d), 0)
        Ba, U = arrs["upd_tok"].shape
        self.gen_counts.index_put_(
            (lane[:, None].expand(Ba, U).reshape(-1),
             to_device(arrs["upd_tok"], d).reshape(-1)),
            to_device(arrs["upd_mask"], d).reshape(-1), accumulate=True)
        temp, top_p, top_k = (to_device(arrs[k], d)
                              for k in ("temp", "top_p", "top_k"))
        freq = to_device(arrs["freq_pen"], d)[:, None, None]
        pres = to_device(arrs["pres_pen"], d)[:, None, None]
        tok_d = to_device(arrs["tokens"], d)
        logits, _, _ = llama.forward(
            self.params, m, tok_d, to_device(arrs["positions"], d),
            self.k_pool, self.v_pool, to_device(arrs["write_idx"], d),
            to_device(arrs["read_idx"], d), to_device(arrs["read_pos"], d),
            to_device(arrs["read_valid"], d), attn_impl="flash",
            group=self.group)                                  # [Ba, T, V]
        cf = self.gen_counts[lane].float()[:, None, :]
        lg = logits - freq * cf - pres * (cf > 0).float()
        return spec_verify(lg, tok_d[:, 1:], temp, top_p, top_k,
                           to_device(arrs["uniforms"], d))


def _kv_dtype(dtype: np.dtype) -> torch.dtype:
    """torch dtype of received KV arrays of numpy ``dtype``: ``uint16``
    arrays are bf16 bits (``llm/kv_transfer.wire_dtype``)."""
    if dtype == np.uint16:
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _kv_tensor(arr: np.ndarray) -> torch.Tensor:
    """A received KV array as a CPU tensor sharing its memory."""
    return torch.from_numpy(np.ascontiguousarray(arr)).view(
        _kv_dtype(arr.dtype))


def _shard_source(cfg) -> Dict[str, Any]:
    """What names a sibling's weights on every rank: its checkpoint, else
    its seed (``key`` names its cut in the ranks' host caches)."""
    path = getattr(cfg, "params_path", None)
    return {"key": path or f"seed:{cfg.seed}", "params_path": path,
            "seed": int(cfg.seed)}


def _tree_nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


# ---------------------------------------------------------------------------
# Async facade
# ---------------------------------------------------------------------------

class TorchEngine(AsyncEngine[BackendInput, EngineOutput]):
    """AsyncEngine facade: one background engine thread runs EngineCore.

    A tensor-parallel leader passes its ``plane``
    (:class:`~..parallel.multihost.LeaderPlane`): the engine waits for the
    followers and hooks the dispatch publisher into its core before the
    thread starts, gathers every rank's counters while idle
    (``core.rank_stats``), and closes the plane at shutdown. A step or KV
    command that fails while a frame it sent the followers has not
    finished its program here ends the process (exit 13): they may already
    wait inside a collective the leader will not run again. Any other
    failure errors its requests, as at tp=1."""

    def __init__(self, cfg: TorchEngineConfig,
                 params: Optional[Dict[str, Any]] = None, plane=None):
        self.core = EngineCore(cfg, params)
        self.plane = plane
        if plane is not None:
            plane.attach(self.core)
        # DYN_PROFILE_DIR: a torch.profiler Chrome trace of the first
        # DYN_PROFILE_STEPS (default 32) working iterations, written to
        # that directory (the JAX engine's XLA trace); read here, before
        # the engine thread starts
        self._profile_dir = os.environ.get("DYN_PROFILE_DIR") or None
        try:
            self._profile_steps = int(os.environ.get("DYN_PROFILE_STEPS",
                                                     "32"))
        except ValueError:
            log.warning("invalid DYN_PROFILE_STEPS=%r; using 32",
                        os.environ.get("DYN_PROFILE_STEPS"))
            self._profile_steps = 32
        self.profile_trace: Optional[str] = None   # the file, once written
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._queues: Dict[str, asyncio.Queue] = {}
        self._inbox: thread_queue.Queue = thread_queue.Queue()
        self._wake = threading.Event()
        self._running = True
        self._thread = threading.Thread(target=self._run,
                                        name="torch-engine", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    def _run(self) -> None:
        stage = self.core.stage
        profile_dir, profile_steps = self._profile_dir, self._profile_steps
        prof = None
        last_gauges = 0.0
        last_disp = 0
        last_stats, stats_disp = 0.0, -1
        while self._running:
            while True:
                try:
                    kind, seq_id, payload = self._inbox.get_nowait()
                except thread_queue.Empty:
                    break
                if kind == "submit":
                    self.core.submit(seq_id, payload)
                elif kind == "cancel":
                    self.core.cancel(seq_id)
                elif kind == "swap":
                    self._run_swap(payload)
                else:
                    self._run_kv_command(kind, seq_id, payload)
            if not self.core.has_work:
                if self.core._wt_pending or self.core._wt_copies:
                    # idle: the last request's mirrors go to the tier now
                    # (nothing is in flight, so waiting on them is free)
                    self.core.flush_writethrough()
                # idle: keep the windowed goodput gauges honest (they decay
                # to 0 as the last burst ages out of the window)
                now = time.monotonic()
                if now - last_gauges >= 5.0:
                    last_gauges = now
                    self._set_goodput_gauges(stage)
                disp = self.core.prefill_dispatches + \
                    self.core.decode_dispatches
                if self.core.tp > 1 and (
                        disp != stats_disp and now - last_stats >= 0.5
                        or now - last_stats >= 5.0):
                    # idle: every rank's counters, between dispatches
                    last_stats, stats_disp = now, disp
                    self.core.refresh_rank_stats()
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            if profile_dir and prof is None and profile_steps > 0:
                try:
                    prof = self._start_profile()
                    log.info("torch profile capture started -> %s",
                             profile_dir)
                except Exception:
                    log.exception("DYN_PROFILE_DIR capture failed to start")
                    profile_dir = None
            try:
                outs = self.core.step(flush=self._deliver_all)
            except Exception as e:  # engine must never die silently
                log.exception("engine step failed")
                self._end_if_torn()
                outs = [StepOutput(sid, 0, 0.0, FinishReason.ERROR,
                                   error=f"engine step failed: {e}")
                        for sid in list(self.core.by_seq)]
                for sid in list(self.core.by_seq):
                    self.core.cancel(sid)
                self.core._reap_cancelled()
                self.core.drop_window()
            stage.batch_occupancy.set(str(os.getpid()),
                                      value=self.core.active)
            # goodput gauges: refreshed once dispatches were accounted —
            # throttled mid-burst, and always at the end of a burst so a
            # short request's MFU shows on /metrics
            disp = self.core.goodput.dispatches
            now = time.monotonic()
            if disp != last_disp and (now - last_gauges >= 0.5
                                      or not self.core.has_work):
                last_gauges, last_disp = now, disp
                self._set_goodput_gauges(stage)
            if prof is not None:
                profile_steps -= 1
                if profile_steps <= 0:
                    self._stop_profile(prof, profile_dir)
                    prof, profile_dir = None, None
            self._deliver_all(outs)
            paging = (self.core.kvpager is not None
                      and self.core.kvpager.has_work)
            if not outs and not self.core.by_seq and not paging:
                # waiting requests that can't be admitted yet: don't spin
                self._wake.wait(timeout=0.02)
                self._wake.clear()
        if prof is not None:
            # shutdown before DYN_PROFILE_STEPS working iterations: write
            # the short capture
            self._stop_profile(prof, profile_dir)

    def _end_if_torn(self) -> None:
        """After a failure on the engine thread: a tensor-parallel leader
        that sent its followers a frame whose program did not return here
        ends the process (exit 13), since they may wait inside a collective
        it will not run again. Otherwise the failure errors its requests,
        as at tp=1."""
        if self.core.frames_out != self.core.frames_done:
            log.critical("a tensor-parallel leader cannot drop a dispatch "
                         "its followers were sent; ending the worker")
            from ..parallel.multihost import FOLLOWER_LOST_EXIT

            os._exit(FOLLOWER_LOST_EXIT)

    def _run_kv_command(self, kind: str, seq_id: str, payload) -> None:
        """The disaggregation commands of the inbox, on the engine thread:
        a prefill worker's ``prefill_extract``, a decode worker's
        whole-array ``inject`` or layer-streamed ``ingest_*`` steps, and a
        ``call`` of a function of the core (:meth:`run_on_engine`). Their
        failures error their request; one that leaves a frame unfinished
        ends a tp worker (:meth:`_end_if_torn`)."""
        core = self.core
        if kind == "call":
            fn, fut = payload
            try:
                fut.set_result(fn(core))
            except Exception as e:  # noqa: BLE001
                fut.set_exception(e)
                self._end_if_torn()
        elif kind == "inject":
            try:
                so = core.inject_prefilled(seq_id, *payload)
            except Exception as e:  # noqa: BLE001
                self._end_if_torn()
                log.exception("KV injection failed")
                so = StepOutput(seq_id, 0, 0.0, FinishReason.ERROR,
                                error=f"KV injection failed: {e}")
            self._deliver(so)
        elif kind == "ingest_begin":
            try:
                core.begin_stream_inject(seq_id, payload)
            except Exception as e:  # noqa: BLE001
                self._end_if_torn()
                log.exception("stream-inject begin failed")
                self._ingest_fail(seq_id, e)
        elif kind == "ingest_layer":
            # a begin/earlier-layer failure already dropped the state and
            # delivered the error: later commands no-op
            if seq_id in core._stream_injects:
                try:
                    core.stream_inject_layer(seq_id, *payload)
                except Exception as e:  # noqa: BLE001
                    self._end_if_torn()
                    log.exception("stream-inject layer failed")
                    self._ingest_fail(seq_id, e)
        elif kind == "ingest_finish":
            if seq_id in core._stream_injects:
                try:
                    self._deliver(core.finish_stream_inject(seq_id,
                                                            *payload))
                except Exception as e:  # noqa: BLE001
                    self._end_if_torn()
                    log.exception("stream-inject finish failed")
                    self._ingest_fail(seq_id, e)
        elif kind == "ingest_abort":
            core.abort_stream_inject(seq_id)
        elif kind == "prefill_extract":
            request, loop, fut = payload
            try:
                res = core.prefill_extract(seq_id, request)
                loop.call_soon_threadsafe(_set_result, fut, res)
            except Exception as e:  # noqa: BLE001
                self._end_if_torn()
                log.exception("prefill_extract failed")
                loop.call_soon_threadsafe(_set_exception, fut, e)

    def _run_swap(self, payload) -> None:
        """Model-mobility hot-swap on the engine thread (single-threaded
        core contract), post-drain; a typed ``SwapError`` reaches the
        agent's fallback path through the future."""
        host_params, new_cfg, loop, fut = payload
        try:
            res = self.core.swap_weights(new_cfg, host_params)
            loop.call_soon_threadsafe(_set_result, fut, res)
        except Exception as e:  # noqa: BLE001
            # a failure inside a frame's program ends a tp worker
            self._end_if_torn()
            log.exception("weight hot-swap failed")
            loop.call_soon_threadsafe(_set_exception, fut, e)

    async def swap_weights(self, host_params, new_cfg):
        """Model-mobility hot-swap: post the in-place weight overwrite to
        the engine thread and await its :class:`~dynamo_tpu_torch.fleet.
        mobility.swap.SwapOutcome`. The caller must have drained first
        (``has_work`` False); a typed ``SwapError`` propagates here when
        the sibling's shape signature does not match. At tp > 1
        ``host_params`` goes unused: every rank swaps its own cut
        (:meth:`EngineCore.swap_weights`)."""
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._inbox.put(("swap", "", (host_params, new_cfg, loop, fut)))
        self._wake.set()
        return await fut

    @property
    def shard_swaps(self) -> bool:
        """Does each rank swap its own cut (tp > 1)? Then a swap agent
        stages siblings through :meth:`prefetch_shards` and hands no host
        tree to :meth:`swap_weights`."""
        return self.core.tp > 1

    def prefetch_shards(self, new_cfg) -> None:
        """Queue :meth:`EngineCore.prefetch_shards` on the engine thread
        (its frame goes out in the thread's order of frames); returns at
        once."""
        import concurrent.futures

        self._inbox.put(("call", "", (
            lambda core: core.prefetch_shards(new_cfg),
            concurrent.futures.Future())))
        self._wake.set()

    def _ingest_fail(self, seq_id: str, e: Exception) -> None:
        """Engine-thread cleanup of a failed stream inject: release the
        pages (never sealed, never seen) and deliver ONE typed error the
        consumer turns into a local-prefill fallback."""
        self.core.abort_stream_inject(seq_id)
        self._deliver(StepOutput(
            seq_id, 0, 0.0, FinishReason.ERROR,
            error=f"KV stream inject failed: {e}",
            error_stage="kv_ingest", error_reason="ingest_failed"))

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.core.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            # have Kineto tear CUPTI down when the capture ends: without
            # it, serving after a capture ran slower on the card (the
            # capture would slow the serving it was taken to explain).
            # Teardown is unsafe only with CUDA graphs, which the engine
            # does not capture.
            os.environ.setdefault("TEARDOWN_CUPTI", "1")
        prof = profile(activities=acts)
        prof.start()
        return prof

    def _stop_profile(self, prof, profile_dir: str) -> None:
        try:
            prof.stop()
            os.makedirs(profile_dir, exist_ok=True)
            path = os.path.join(profile_dir, f"torch_engine.{os.getpid()}."
                                f"{time.time_ns()}.pt.trace.json")
            prof.export_chrome_trace(path)
            self.profile_trace = path
            log.info("torch profile capture written to %s", path)
        except Exception:
            log.exception("stopping the torch profile failed")

    def _set_goodput_gauges(self, stage) -> None:
        pid = str(os.getpid())
        snap = self.core.goodput.snapshot()
        stage.mfu.set(pid, value=snap["mfu"])
        stage.mbu.set(pid, value=snap["mbu"])
        stage.hbm_gbps.set(pid, value=snap["hbm_gbps"])

    def _deliver_all(self, outs: List[StepOutput]) -> None:
        for so in outs:
            try:
                self._deliver(so)
            except Exception:  # closed loop etc. must not kill the thread
                log.exception("failed to deliver step output")

    def _deliver(self, so: StepOutput) -> None:
        loop = self._loop
        if loop is None:
            return
        q = self._queues.get(so.seq_id)
        if q is not None:
            loop.call_soon_threadsafe(q.put_nowait, so)

    # ------------------------------------------------------------------
    async def generate(self, request: BackendInput,
                       context: Context) -> AsyncIterator[EngineOutput]:
        async for out in self._generate(("submit", request), context):
            yield out

    async def prefill_extract(self, request: BackendInput, context: Context
                              ) -> Tuple[np.ndarray, np.ndarray, int, float]:
        """Prefill-worker entry: compute prompt KV + first token on the
        engine thread, await the result. Returns (k, v, token, logprob)."""
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._inbox.put(("prefill_extract", context.id,
                         (request, loop, fut)))
        self._wake.set()
        return await fut

    async def generate_prefilled(self, request: BackendInput, context: Context,
                                 k, v, first_token: int,
                                 first_logprob: float = 0.0
                                 ) -> AsyncIterator[EngineOutput]:
        """Stream a request whose prompt KV (and first token) arrived from a
        remote prefill worker — enters decode directly."""
        payload = (request, k, v, first_token, first_logprob)
        async for out in self._generate(("inject", payload), context):
            yield out

    # ------------------------------------------------------------------
    # layer-streamed KV ingest (disagg receive path)
    # ------------------------------------------------------------------
    def kv_ingest(self, request: BackendInput, seq_id: str) -> "KvIngest":
        """An asyncio-side handle the :class:`~..llm.kv_transfer.
        KvReceiver` drives to scatter a remote prefill's KV layer-by-
        layer as it arrives. Register it with ``receiver.expect(...,
        ingest=handle)``; consume the entered sequence with
        :meth:`generate_streamed` once the awaited future resolves to
        the handle."""
        return KvIngest(self, request, seq_id)

    async def generate_streamed(self, request: BackendInput,
                                context: Context, ingest: "KvIngest"
                                ) -> AsyncIterator[EngineOutput]:
        """Stream a request whose KV was ingested layer-streamed — the
        inject commands are already queued; this only consumes the output
        queue the ingest registered. Raises
        :class:`~..llm.kv_transfer.RemotePrefillError` (before yielding
        anything) if the engine-side ingest failed, so the caller can
        fall back to local prefill."""
        async for out in self._consume(context.id, context,
                                       ingest_fallback=True):
            yield out

    async def _generate(self, work, context: Context
                        ) -> AsyncIterator[EngineOutput]:
        kind, payload = work
        self._loop = asyncio.get_running_loop()
        seq_id = context.id
        self._queues[seq_id] = asyncio.Queue()
        self._inbox.put((kind, seq_id, payload))
        self._wake.set()
        async for out in self._consume(seq_id, context):
            yield out

    async def _consume(self, seq_id: str, context: Context,
                       ingest_fallback: bool = False
                       ) -> AsyncIterator[EngineOutput]:
        q = self._queues[seq_id]

        async def watch_cancel():
            await context.stopped()
            self._inbox.put(("cancel", seq_id, None))
            self._wake.set()

        cancel_task = asyncio.ensure_future(watch_cancel())
        try:
            while True:
                so: StepOutput = await q.get()
                if so.finish == FinishReason.ERROR:
                    if ingest_fallback and so.error_stage == "kv_ingest":
                        # torn/failed stream inject: the pages are
                        # released; hand control back so the caller
                        # prefills locally instead of erroring the user
                        from ..llm.kv_transfer import RemotePrefillError

                        raise RemotePrefillError(so.error
                                                 or "kv ingest failed")
                    yield EngineOutput(token_ids=[],
                                       finish_reason=FinishReason.ERROR,
                                       error=so.error or "engine error",
                                       error_code=so.error_code,
                                       error_stage=so.error_stage,
                                       error_reason=so.error_reason)
                    return
                ingest_fallback = False   # tokens flowed: no fallback
                yield EngineOutput(
                    token_ids=[so.token],
                    cum_log_prob=so.logprob,
                    logprobs=[{str(so.token): so.token_logprob}],
                    finish_reason=so.finish,
                    # first output only: admission's prefix-restore length
                    kv_prefix_hit_tokens=so.prefix_hit,
                )
                if so.finish is not None:
                    return
        finally:
            cancel_task.cancel()
            self._queues.pop(seq_id, None)
            self._inbox.put(("cancel", seq_id, None))
            self._wake.set()

    def run_on_engine(self, fn: Callable[["EngineCore"], Any],
                      timeout: float = 120.0) -> Any:
        """``fn(core)`` on the engine thread, from any other thread, and
        its result: how a caller reaches the core while the engine serves
        (at tp > 1 a core method that sends frames must run in the
        thread's order of frames, e.g. ``EngineCore.flush_reusable``)."""
        import concurrent.futures

        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._inbox.put(("call", "", (fn, fut)))
        self._wake.set()
        return fut.result(timeout)

    # ------------------------------------------------------------------
    # placement-driven prefetch (an executor thread)
    # ------------------------------------------------------------------
    def prefetch_tiers(self, request: BackendInput) -> int:
        """Start the h2d upload of the request's matched host/disk-tier
        prefix (and touch draft-model state when spec is on) while it
        waits in the slot-gate queue: admission consumes the staged device
        blocks instead of stalling first prefill on the upload.
        Best-effort: any failure just means the synchronous restore."""
        if getattr(request, "images", None) \
                and not getattr(request, "kv_salt", 0):
            # admission would salt this request's chain with an image
            # digest: a prefetch under the unsalted chain would stage
            # blocks admission never matches
            return 0
        try:
            n = self.core.stage_prefetch(
                request.token_ids,
                lora_id=getattr(request, "kv_salt", 0)
                or getattr(request, "lora_id", 0))
        except Exception:  # noqa: BLE001 - prefetch must never fail a req
            log.exception("h2d prefetch failed; admission restores "
                          "synchronously")
            return 0
        prop = self.core.proposer
        if prop is not None and hasattr(prop, "prefetch"):
            # the draft-model weight prefetch hook (spec decode): today's
            # proposers load at init, so this is the seam for lazily
            # loaded drafts, not a transfer
            try:
                prop.prefetch()
            except Exception:  # noqa: BLE001
                log.debug("draft prefetch hook failed", exc_info=True)
        return n

    # ------------------------------------------------------------------
    def shutdown(self) -> None:
        self._running = False
        self._wake.set()
        self._thread.join(timeout=30)
        self.core.close()
        if self.plane is not None:
            self.plane.close()
        # the engine's per-worker gauge series die with it: a process that
        # outlives its engine would otherwise export ghost occupancy/MFU
        self.core.stage.clear_worker(str(os.getpid()))


def _set_result(fut: asyncio.Future, res) -> None:
    if not fut.done():
        fut.set_result(res)


def _set_exception(fut: asyncio.Future, exc: BaseException) -> None:
    if not fut.done():
        fut.set_exception(exc)


class KvIngest:
    """Asyncio-side handle for one layer-streamed KV injection.

    Created by :meth:`TorchEngine.kv_ingest` before the request parks on
    the prefill queue; the :class:`~..llm.kv_transfer.KvReceiver` drives
    it from the ``kv_receive`` handler: :meth:`begin` validates the wire
    geometry against the engine and registers the output queue,
    :meth:`layer` posts one arrived layer to the engine thread (staged,
    and scattered a group of layers at a time while later layers are
    still on the wire), :meth:`finish` posts the finalize (seal + enter
    decode + first token), :meth:`abort` tears everything down with the
    pool pages released unseen. All methods are cheap posts — no device
    syncs."""

    def __init__(self, engine: TorchEngine, request: BackendInput,
                 seq_id: str):
        self.engine = engine
        self.request = request
        self.seq_id = seq_id
        self.began = False
        self.finished = False

    def _post(self, kind: str, payload) -> None:
        self.engine._inbox.put((kind, self.seq_id, payload))
        self.engine._wake.set()

    def begin(self, meta: dict) -> bool:
        """Validate the stream's geometry and arm the ingest. False =
        decline (mismatched model geometry / tokens): the receiver falls
        back to buffered assembly, which surfaces the mismatch through
        the whole-array import path."""
        m = self.engine.core.cfg.model
        if (int(meta.get("layers", -1)) != m.num_layers
                or int(meta.get("kv_heads", -1)) != m.num_kv_heads
                or int(meta.get("head_dim", -1)) != m.head_dim
                or int(meta.get("tokens", -1))
                != len(self.request.token_ids)):
            log.warning("kv stream geometry %s does not match engine "
                        "(%d layers, %d kv heads, %d head_dim); buffering",
                        {k: meta.get(k) for k in
                         ("layers", "kv_heads", "head_dim", "tokens")},
                        m.num_layers, m.num_kv_heads, m.head_dim)
            return False
        self.engine._loop = asyncio.get_running_loop()
        self.engine._queues[self.seq_id] = asyncio.Queue()
        self._post("ingest_begin", self.request)
        self.began = True
        return True

    def layer(self, layer: int, k: np.ndarray, v: np.ndarray) -> None:
        self._post("ingest_layer", (layer, k, v))

    def finish(self, first_token: int, first_logprob: float) -> None:
        self.finished = True
        self._post("ingest_finish", (int(first_token),
                                     float(first_logprob)))

    def abort(self) -> None:
        """Idempotent, and a no-op once :meth:`finish` posted: the waiter
        consumes the finished sequence's queue, so a late abandon (the
        ``await_remote_kv`` finally) must not tear it down. For an
        UNfinished ingest the abort posts through the same FIFO inbox the
        begin rode, so a local-prefill resubmit of the same seq_id is
        processed strictly after the pool pages were released."""
        if self.began and not self.finished:
            self._post("ingest_abort", None)
            self.engine._queues.pop(self.seq_id, None)
            self.began = False

    def discard(self) -> None:
        """The waiter gave up AFTER the ingest finished (its sequence is
        already decoding) and will never consume the outputs: cancel the
        orphaned sequence and drop its queue so the slot and the dict
        entry don't leak until max_tokens."""
        if self.finished:
            self._post("cancel", None)
            self.engine._queues.pop(self.seq_id, None)
            self.finished = False
            self.began = False
        else:
            self.abort()
