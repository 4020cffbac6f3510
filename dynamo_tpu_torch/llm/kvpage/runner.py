"""PagedEngine: serve contexts far beyond the device KV pool.

The virtual-memory model (the JAX package's ``docs/long_context.md``):

- **Chunked prefill with seal-and-demote.** Each prefill chunk writes its
  KV into pages leased from the engine's pool; once the chunk is
  enqueued, full (sealed) blocks beyond the hot-window budget are demoted
  to the host tier (``TieredKvCache``), pinned there because a demoted
  working set is state, not cache, and their pages go back to the pool.
  Device residency therefore stays at most ``budget`` pages for any
  context length. The d2h gather (``CopyStream.d2h_pages``) is enqueued on
  the compute stream behind the writing forward and waits on its event
  before the tier reads the bytes, so the pages are back in the pool only
  after their copy is done: a dense admission cannot lease and overwrite
  them first.
- **Batched decode over windowed working sets.** Up to
  ``DYN_KVPAGE_BATCH`` sequences decode at once, each owning an equal
  share of the page budget (its lane). One window step runs hot-window
  attention for every lane in one pass (each lane reads its own pages of
  the pool), then merges cold segments lane-stacked in a shared
  ``[2, B, ...]`` staging slot: one upload per (layer, segment step)
  covers every lane, and the :class:`~.pager.PageScheduler` round-robins
  segment assembly across lanes so each keeps its own prefetch double
  buffer. Faults degrade to counted synchronous assemblies on the
  faulting lane only. Sampling state (a ``torch.Generator`` and a penalty
  count row per lane) advances only on a lane's own rows, so every lane's
  token stream is the one it would get alone, and the dense engine's.
- **Page-in staging.** Host slots are pinned on a card and reused (a free
  list per slot shape; a slot is rewritten only after the upload that
  last read it completed). Uploads run on a side stream into two device
  slots: the attention on a slot waits on that slot's upload event, and
  an upload into a slot waits on the event of the attention that last
  read it, so segment *s+1* crosses the bus while segment *s* is
  attended. Within a decode window the assembled host slots are kept per
  (layer, segment) while they fit ``WINDOW_CACHE_BYTES``: cold segments
  cannot change inside a window, so only the first step pays the pager's
  takes. A window past that bound takes every segment from the pager
  again at each step through the ring, so pinned staging stays at most
  ``WINDOW_CACHE_BYTES`` plus ``STAGE_RING`` free slots per slot shape
  whatever the context length (torch keeps freed pinned blocks for reuse,
  so the process holds its peak).
- **Prefix reuse for free.** Demoted blocks carry their chained sequence
  hashes, so a repeated long prompt pins matching tier blocks at
  admission and skips recomputing them; at release the pins drop and the
  blocks become ordinary LRU tier content.

Scheduling: :meth:`PagedEngine.advance` performs one unit of work per
engine step, at the head of ``EngineCore.step`` on the engine thread:
one prefill chunk (lanes round-robin) or one decode window across every
decode-ready lane, prefill first when both exist. Admission is
byte-honest across lanes: each admitted request's working set is
reserved against the host tier up front.

Tensor parallelism: the lane's plan, its pager and the host tier are the
leader's. Each prefill chunk and decode window is a device program every
rank runs from a frame (``kvpage_prefill``, ``kvpage_decode``: the hot
reads, each layer's segment plan, the sampling rows and uniforms); a
demotion is the engine's ``kv_offload`` frame. At each upload step the
leader assembles the whole segment and scatters each rank its kv heads
(``parallel.collectives.scatter_heads``, one host collective a (layer,
step) on the engine thread, in plan order), and each rank uploads its
slice; the JAX package's host tier likewise holds whole blocks and its
puts split them by ``kv_sharding``. Every pin is checked on the leader
before a frame goes out: a miss after it would leave the followers in a
collective.

Differences from the JAX lane: there is no compile, so every work unit
feeds the goodput meter (JAX skips a shape's first, compiling use), and
pages the lane leases are offloaded from the pool's eviction queue before
the lane writes them (``EngineCore._flush_evictions``), which the JAX
lane omits.
"""

from __future__ import annotations

import collections
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...device import to_device
from ...obs.flows import record_flow
from ...parallel import collectives
from ...utils.knobs import env_float as _env_float
from ...utils.prometheus import stage_metrics
from ..kvbm.pool import OutOfBlocks
from ..kvbm.tiers import OutOfTierSpace
from ..kvbm.transfer import to_host_array
from ..protocols.common import BackendInput, FinishReason
from ..tokens import TokenSequence, chain_hash, hash_tokens, lora_chain_root
from .pager import KvPageMiss, PageinPlan, PageScheduler
from .programs import PagedPrograms

log = logging.getLogger("dynamo_tpu_torch.kvpage")

#: free host staging slots kept per slot shape: the oldest is waited on
#: and reused before a new one is pinned, and slots given back past this
#: count are dropped
STAGE_RING = 4
#: most pinned bytes a decode window keeps as its per-(layer, segment)
#: cache; Llama-3-8B at one lane holds about 8.4 MB of it per 64-token
#: block of cold context, so about 500 cold blocks (32k tokens) fit
WINDOW_CACHE_BYTES = 4 << 30


@dataclass
class PagedConfig:
    """Resolved ``DYN_KVPAGE_*`` surface (engine-config fields win over
    env knobs; a zero or unset budget turns the lane off)."""

    budget: int                 # device pages the paged lane may lease
    seg_pages: int              # blocks per cold staging segment
    prefetch: int               # segments assembled ahead (0 = sync)
    max_context: int            # paged-lane context ceiling, tokens
    batch: int                  # concurrent paged decode lanes

    @classmethod
    def resolve(cls, cfg) -> Optional["PagedConfig"]:
        budget = cfg.kvpage_budget
        if budget is None:
            budget = int(_env_float("DYN_KVPAGE_DEVICE_BUDGET", 0))
        if budget <= 0:
            return None
        seg = cfg.kvpage_seg_pages or int(
            _env_float("DYN_KVPAGE_SEG_PAGES", 8))
        prefetch = cfg.kvpage_prefetch
        if prefetch is None:
            prefetch = int(_env_float("DYN_KVPAGE_PREFETCH", 2))
        max_ctx = cfg.kvpage_max_context or int(
            _env_float("DYN_KVPAGE_MAX_CONTEXT", 131072))
        batch = cfg.kvpage_batch or int(_env_float("DYN_KVPAGE_BATCH", 1))
        return cls(budget=int(budget), seg_pages=max(1, int(seg)),
                   prefetch=max(0, int(prefetch)),
                   max_context=int(max_ctx), batch=max(1, int(batch)))


@dataclass
class _PagedSeq:
    seq_id: str
    request: BackendInput
    prompt: List[int]
    tokseq: TokenSequence
    lane: int = 0               # row in the batched decode pass
    # device pages for blocks [first_res, first_res + len(resident));
    # the resident span is always the contiguous tail of the context
    resident: List[int] = field(default_factory=list)
    first_res: int = 0
    pinned: List[int] = field(default_factory=list)   # demoted block hashes
    reserve_blocks: int = 0     # admission reservation (working set)
    total_len: int = 0          # tokens written to the KV (pool or tier)
    prefill_done: int = 0
    generated: int = 0
    last_token: int = 0
    cum_logprob: float = 0.0
    cancelled: bool = False


@dataclass
class _HostSlot:
    """One host staging slot [2, B, Hkv, seg_pages, page, Dh] (pinned on a
    card) and the event of the upload that last read it."""

    t: torch.Tensor
    arr: np.ndarray             # its host-dtype view (bf16 as uint16)
    done: Any = None


class PagedEngine:
    """The paged lane of one :class:`~...engine.engine.EngineCore`.

    Driven from the engine thread: ``advance()`` performs exactly one
    unit of work (one prefill chunk or one decode window across all
    decode-ready lanes), so paged and dense traffic interleave at engine
    step granularity.
    """

    def __init__(self, core, pcfg: PagedConfig):
        from ...models.llama import kv_block_bytes

        self.core = core
        self.pcfg = pcfg
        cfg = core.cfg
        self.page = cfg.page_size
        m = cfg.model
        self.device = core.device
        self.programs = PagedPrograms(cfg)
        self.pager = PageScheduler(core.tiered, pcfg.seg_pages,
                                   pcfg.prefetch)
        self.chunk = cfg.prefill_chunk
        self.chunk_pages = -(-self.chunk // self.page)
        # decode chaining: N tokens a host fetch, each sampled token
        # feeding the next forward on the device
        self.decode_chain = max(1, int(_env_float(
            "DYN_KVPAGE_DECODE_STEPS", cfg.decode_steps or 4)))
        # every lane gets an equal share of the page budget; the total
        # leased across lanes never exceeds ``budget``
        self.batch = pcfg.batch
        self.lane_budget = pcfg.budget // self.batch
        if self.lane_budget < self.chunk_pages + 2:
            raise ValueError(
                f"kvpage budget of {pcfg.budget} pages split over "
                f"{self.batch} lanes gives {self.lane_budget} pages per "
                f"lane, which cannot hold a prefill chunk "
                f"({self.chunk_pages} pages) plus the hot tail; need "
                f">= {self.batch * (self.chunk_pages + 2)} total")
        self.block_bytes = kv_block_bytes(m, self.page)
        # hot-window residency ceiling: during prefill the in-flight
        # chunk's pages ride inside the lane's budget share
        self.hot_keep = max(1, self.lane_budget - self.chunk_pages - 1)
        self.lanes: List[Optional[_PagedSeq]] = [None] * self.batch
        self.queue: Deque[Tuple[str, BackendInput, int]] = \
            collections.deque()
        self._worker = str(os.getpid())
        self._prefill_rr = 0
        # lane-persistent sampling state, one row (or stream) per lane,
        # (re)set at lane start; a padded row never draws or counts
        self._gens: List[Optional[torch.Generator]] = [None] * self.batch
        self._counts = torch.zeros((self.batch, m.vocab_size),
                                   dtype=torch.int32, device=self.device)
        self._temp = np.zeros(self.batch, np.float32)
        self._top_p = np.ones(self.batch, np.float32)
        self._top_k = np.zeros(self.batch, np.int64)
        self._freq = np.zeros(self.batch, np.float32)
        self._pres = np.zeros(self.batch, np.float32)
        # page-in staging (module docstring)
        self._cuda = self.device.type == "cuda"
        self._host_free: Dict[int, Deque[_HostSlot]] = {}
        self._dev_slots: List[torch.Tensor] = []
        self._up_done: List[Any] = [None, None]
        self._use_done: List[Any] = [None, None]
        self._ring = 0
        self._side = None
        self._compute = None            # the forward's compute stream
        self._timing: Deque[Tuple[Any, Any]] = collections.deque()
        self._flow = [0, 0.0]           # this forward's page-in (bytes, s)
        # counters a run reads back
        self.prefill_chunks = 0
        self.decode_windows = 0
        self.decode_steps_run = 0
        self.prefill_seconds = 0.0      # host clock, chunk to demote done
        self.decode_seconds = 0.0       # host clock, window to its fetch
        self.demoted_blocks = 0
        self.peak_resident = 0          # most pages leased at once
        self.max_window_lanes = 0       # most lanes in one decode window
        self.pagein_bytes = 0
        self.pagein_uploads = 0
        self.assemble_seconds = 0.0     # host clock of the pager's takes
        self.upload_seconds = 0.0       # the uploads' device time (card)
        self.stage_slots_made = 0       # host staging slots allocated
        self.uncached_windows = 0       # windows past WINDOW_CACHE_BYTES
        # host clock of this rank's staging: the pager's takes, the
        # segments' scatter to the ranks (tp > 1) and the uploads' enqueue
        self.stage_seconds = 0.0

    # ------------------------------------------------------------------
    @property
    def has_work(self) -> bool:
        return any(s is not None for s in self.lanes) or bool(self.queue)

    @property
    def active(self) -> Optional[_PagedSeq]:
        """The first occupied lane (single-lane introspection)."""
        for seq in self.lanes:
            if seq is not None:
                return seq
        return None

    def resident_bytes(self) -> Tuple[float, float]:
        """(device bytes, pinned host bytes) of all lanes' working sets."""
        dev = host = 0
        for seq in self.lanes:
            if seq is None:
                continue
            dev += len(seq.resident)
            host += len(seq.pinned)
        return (float(dev * self.block_bytes),
                float(host * self.block_bytes))

    def close(self) -> None:
        self.pager.close()

    def cancel(self, seq_id: str) -> None:
        for seq in self.lanes:
            if seq is not None and seq.seq_id == seq_id:
                seq.cancelled = True
                return
        self.queue = collections.deque(
            (s, r, b) for s, r, b in self.queue if s != seq_id)

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def _reserved_unpinned(self) -> int:
        """Admitted-but-not-yet-pinned working-set blocks: queued requests
        in full, plus each lane's remaining demotable span. This keeps
        N-lane admission byte-honest: what concurrent lanes will pin is
        charged before they pin it."""
        r = sum(b for _, _, b in self.queue)
        for seq in self.lanes:
            if seq is not None:
                r += max(0, seq.reserve_blocks - len(seq.pinned))
        return r

    def try_route(self, seq_id: str, req: BackendInput):
        """Accept the request into the paged lane (None) or explain why
        not (a typed ERROR StepOutput the engine emits as is)."""
        from ...engine.engine import StepOutput

        prompt_len = len(req.token_ids)

        def err(msg, code, reason):
            return StepOutput(seq_id, 0, 0.0, FinishReason.ERROR,
                              error=msg, error_code=code,
                              error_stage="engine_admission",
                              error_reason=reason)

        if prompt_len >= self.pcfg.max_context:
            return err(
                f"prompt of {prompt_len} tokens exceeds the paged "
                f"context limit of {self.pcfg.max_context} "
                f"(DYN_KVPAGE_MAX_CONTEXT)", 400, "context_exceeded")
        if req.images:
            return err("image requests are not servable on the paged "
                       "long-context lane", 400, "unsupported")
        max_new = req.stop.max_tokens or (self.pcfg.max_context
                                          - prompt_len)
        blocks = -(-(prompt_len + max_new) // self.page)
        host = self.core.tiered.host
        reserved = self._reserved_unpinned()
        # the pinned working set must fit the host tier beside what is
        # already pinned and what every admitted lane will still pin
        if blocks + len(host.pinned) + reserved + 1 > host.num_blocks:
            return err(
                f"paged working set of {blocks} KV blocks "
                f"({blocks * self.block_bytes / 1e6:.0f} MB) does not fit "
                f"the host tier ({host.num_blocks} blocks, "
                f"{len(host.pinned)} already pinned, {reserved} reserved "
                f"by admitted lanes)", 503,
                "kvpage_capacity")
        self.queue.append((seq_id, req, blocks))
        return None

    # ------------------------------------------------------------------
    # one unit of work an engine step
    # ------------------------------------------------------------------
    def advance(self) -> List:
        """One unit of paged work: start queued sequences into free lanes,
        then one prefill chunk (lanes round-robin) or one decode window
        across every decode-ready lane, prefill first: a window costs
        about the same at one lane as at all of them (uploads and passes
        are lane-stacked), so filling an admitted lane first raises the
        window's occupancy and the newcomer's TTFT."""
        from ...engine.engine import StepOutput

        out: List[StepOutput] = []
        for seq in list(self.lanes):
            if seq is not None and seq.cancelled:
                out.append(StepOutput(seq.seq_id, seq.last_token,
                                      seq.cum_logprob,
                                      FinishReason.CANCELLED))
                self._release(seq)
        for lane in range(self.batch):
            if self.lanes[lane] is None and self.queue:
                seq_id, req, blocks = self.queue.popleft()
                self._start(lane, seq_id, req, blocks)
        prefilling = [s for s in self.lanes
                      if s is not None and s.prefill_done < len(s.prompt)]
        decoding = [(s.lane, s) for s in self.lanes
                    if s is not None and s.prefill_done >= len(s.prompt)]
        with torch.no_grad():
            if prefilling:
                seq = prefilling[self._prefill_rr % len(prefilling)]
                self._prefill_rr += 1
                try:
                    self._prefill_chunk(seq, out)
                except Exception as e:  # noqa: BLE001 - kill THIS request,
                    # never the engine (see _fail), unless a frame's
                    # program broke off (tp > 1: the worker ends)
                    if self._torn():
                        raise
                    log.exception("paged sequence %s failed", seq.seq_id)
                    self._fail(seq, e, out)
            elif decoding:
                self._decode_window(decoding, out)
        return out

    def _fail(self, seq: _PagedSeq, e: Exception, out: List) -> None:
        """Emit the typed failure for ONE lane and release it: a paged
        failure kills this request, never the engine (escaping into
        step()'s catch-all would error every dense sequence and never
        release the lanes). Capacity pressure is a retryable 503; a
        KvPageMiss (the pin discipline failed) and anything unexpected
        are 500s with distinct reasons."""
        from ...engine.engine import StepOutput

        if isinstance(e, (OutOfBlocks, OutOfTierSpace)):
            code, reason = 503, "kvpage_capacity"
        elif isinstance(e, KvPageMiss):
            code, reason = 500, "kvpage_miss"
        else:
            code, reason = 500, "kvpage_internal"
        out.append(StepOutput(
            seq.seq_id, seq.last_token, seq.cum_logprob,
            FinishReason.ERROR,
            error=f"paged serving failed: {e}", error_code=code,
            error_stage="engine", error_reason=reason))
        self._release(seq)

    # ------------------------------------------------------------------
    def _start(self, lane: int, seq_id: str, req: BackendInput,
               blocks: int) -> _PagedSeq:
        from ...engine.sampling import STATIC_K, lane_generator, resume_seed

        prompt = list(req.token_ids)
        lora_id = getattr(req, "lora_id", 0)
        seq = _PagedSeq(seq_id, req, prompt,
                        TokenSequence(self.page, lora_id=lora_id),
                        lane=lane, reserve_blocks=blocks)
        # prefix reuse against the tier: pin matching leading blocks and
        # skip recomputing them (cold context from token 0)
        page = self.page
        usable = (len(prompt) - 1) // page
        parent = lora_chain_root(lora_id)
        matched = 0
        tiered = self.core.tiered
        for b in range(usable):
            blk = prompt[b * page:(b + 1) * page]
            sh = chain_hash(parent, hash_tokens(blk))
            if not tiered.pin(sh):
                break
            seq.pinned.append(sh)
            parent = sh
            matched += 1
        for t in prompt[:matched * page]:
            seq.tokseq.append(int(t))
        seq.first_res = matched
        seq.total_len = matched * page
        seq.prefill_done = matched * page
        core = self.core
        core.last_prefix_hit = matched * page
        core.prefix_hit_tokens += matched * page
        core.prefix_query_tokens += len(prompt)

        # sampling state: this lane's row, seeded as the dense engine
        # seeds a sequence (the request's seed, else the engine's source)
        sp = req.sampling
        self._temp[lane] = float(sp.temperature or 0.0)
        self._top_p[lane] = float(sp.top_p if sp.top_p is not None else 1.0)
        self._top_k[lane] = int(min(sp.top_k or 0, STATIC_K))
        self._freq[lane] = float(sp.frequency_penalty or 0.0)
        self._pres[lane] = float(sp.presence_penalty or 0.0)
        if sp.seed is not None:
            seed = resume_seed(int(sp.seed),
                               int(getattr(req, "resume_pos", 0) or 0))
        else:
            seed = core._seed_source.getrandbits(63)
        self._gens[lane] = lane_generator(seed)
        # the lane's penalty-count row is zeroed on the device by the
        # prefill program that samples its first token
        self.lanes[lane] = seq
        self._set_gauges()
        return seq

    def _release(self, seq: _PagedSeq) -> None:
        for page in seq.resident:
            self.core.pool.blocks.release(page)
        seq.resident = []
        tiered = self.core.tiered
        for h in seq.pinned:
            tiered.unpin(h)
        seq.pinned = []
        seq.reserve_blocks = 0
        if self.lanes[seq.lane] is seq:
            self.lanes[seq.lane] = None
            self._gens[seq.lane] = None
        self.pager.end_lane(seq.lane)
        self._set_gauges()

    def _set_gauges(self) -> None:
        dev, host = self.resident_bytes()
        g = stage_metrics().kvpage_resident_bytes
        g.set("device", self._worker, value=dev)
        g.set("host", self._worker, value=host)

    # ------------------------------------------------------------------
    # residency
    # ------------------------------------------------------------------
    def _slot(self, seq: _PagedSeq, pos: int) -> int:
        """Pool token slot of position ``pos`` (must be resident)."""
        blk = pos // self.page
        return (seq.resident[blk - seq.first_res] * self.page
                + pos % self.page)

    def _ensure_resident(self, seq: _PagedSeq, upto: int) -> None:
        """Lease pages so that every position < ``upto`` beyond the
        demoted prefix has a slot. A lease may evict a reusable block: its
        offload is enqueued before anything writes the page."""
        need_blocks = -(-upto // self.page)
        leased = False
        while seq.first_res + len(seq.resident) < need_blocks:
            seq.resident.append(self.core.pool.blocks.lease_new())
            leased = True
        if leased:
            self.core._flush_evictions()
            self.peak_resident = max(self.peak_resident, sum(
                len(s.resident) for s in self.lanes if s is not None))

    def _demote(self, seq: _PagedSeq, keep: int) -> None:
        """Seal-and-demote the oldest resident blocks until at most
        ``keep`` stay resident. Only full (hashed) blocks demote. The d2h
        is enqueued behind the forward that wrote them and waited on
        before the pages return to the pool."""
        sealed = len(seq.tokseq.blocks)
        n = 0
        while (len(seq.resident) - n > keep
               and seq.first_res + n < sealed):
            n += 1
        if n <= 0:
            return
        pages = seq.resident[:n]
        hashes = [seq.tokseq.blocks[seq.first_res + i].sequence_hash
                  for i in range(n)]
        t0 = time.perf_counter()
        # a kv_offload frame: each rank's d2h of its kv heads, gathered
        # into whole blocks on the leader
        k, v = self.core._offload_pages(pages)
        record_flow("kvpage_pageout", n * self.block_bytes,
                    time.perf_counter() - t0, trace_id=seq.seq_id)
        tiered = self.core.tiered
        for i, h in enumerate(hashes):
            tiered.deposit_pinned(h, k[i], v[i])
            seq.pinned.append(h)
        for page in pages:
            self.core.pool.blocks.release(page)
        del seq.resident[:n]
        seq.first_res += n
        self.demoted_blocks += n
        stage_metrics().kvpage_demotions.inc(amount=float(n))
        self._set_gauges()

    def _cold_segments(self, seq: _PagedSeq
                       ) -> List[Tuple[int, Tuple[int, ...]]]:
        """The demoted prefix [0, first_res) grouped into staging segments
        of ``seg_pages`` blocks: (start block, block hashes)."""
        hashes = seq.pinned
        sp = self.pcfg.seg_pages
        return [(i, tuple(hashes[i:i + sp]))
                for i in range(0, len(hashes), sp)]

    # ------------------------------------------------------------------
    # page-in staging
    # ------------------------------------------------------------------
    def _slot_shape(self, B: int, local: bool = False) -> Tuple[int, ...]:
        """A staging slot [2, B, Hkv, seg_pages, page, Dh]: every kv head
        (the leader's whole slot, the tier's layout), or with ``local``
        this rank's kv heads (what it uploads)."""
        m = self.core.cfg.model
        heads = self.core.k_pool.shape[1] if local else m.num_kv_heads
        return (2, B, heads, self.pcfg.seg_pages, self.page, m.head_dim)

    def _take_host(self, shape: Tuple[int, ...]) -> _HostSlot:
        """A host slot of ``shape`` whose last upload is done. New slots
        are not zeroed: the staging writes every row."""
        free = self._host_free.setdefault(shape, collections.deque())
        if free and (free[0].done is None or free[0].done.query()
                     or len(free) >= STAGE_RING):
            hs = free.popleft()
            if hs.done is not None:
                # dynalint: ok(host-sync) waits only when every slot of the
                # staging ring is still in flight (STAGE_RING uploads)
                hs.done.synchronize()
            return hs
        t = torch.empty(shape, dtype=self.core.k_pool.dtype,
                        pin_memory=self._cuda)
        self.stage_slots_made += 1
        return _HostSlot(t, to_host_array(t))

    def _give_host(self, hs: _HostSlot) -> None:
        """Back to the free list, or dropped once it holds ``STAGE_RING``
        (torch's host allocator waits on the slot's last copy before it
        reuses the memory)."""
        free = self._host_free.setdefault(tuple(hs.t.shape),
                                          collections.deque())
        if len(free) < STAGE_RING:
            free.append(hs)

    def _slot_bytes(self, B: int) -> int:
        return int(np.prod(self._slot_shape(B))) * \
            self.core.k_pool.element_size()

    def _upload(self, hs: _HostSlot):
        """Enqueue one slot's upload; returns (device tensor, ring index)."""
        if not self._cuda:
            return hs.t.clone(), None
        import torch.cuda as tc

        if self._side is None:
            self._side = tc.Stream(self.device)
            n = int(np.prod(self._slot_shape(self.batch, local=True)))
            self._dev_slots = [torch.empty(n, dtype=hs.t.dtype,
                                           device=self.device)
                               for _ in range(2)]
        i = self._ring % 2
        self._ring += 1
        dev = self._dev_slots[i][:hs.t.numel()].view(hs.t.shape)
        side = self._side
        if self._use_done[i] is not None:
            side.wait_event(self._use_done[i])
        t0, t1 = tc.Event(enable_timing=True), tc.Event(enable_timing=True)
        t0.record(side)
        with tc.stream(side):
            dev.copy_(hs.t, non_blocking=True)
        t1.record(side)
        hs.done = self._up_done[i] = t1
        self._timing.append((t0, t1))
        while self._timing and self._timing[0][1].query():
            a, b = self._timing.popleft()
            self.upload_seconds += a.elapsed_time(b) / 1e3
        return dev, i

    def _attend_slot(self, i) -> None:
        """Order the next attention after slot ``i``'s upload."""
        if i is not None:
            self._compute.wait_event(self._up_done[i])

    def _slot_read(self, i) -> None:
        """Record that the attention reading slot ``i`` is enqueued."""
        if i is not None:
            ev = torch.cuda.Event()
            ev.record(self._compute)
            self._use_done[i] = ev

    def pagein_stats(self) -> Dict[str, float]:
        """Page-in totals; waits for the uploads still in flight."""
        while self._timing:
            a, b = self._timing.popleft()
            # dynalint: ok(host-sync) a statistics read after the run, not on a
            # step
            b.synchronize()
            self.upload_seconds += a.elapsed_time(b) / 1e3
        return {"bytes": float(self.pagein_bytes),
                "uploads": float(self.pagein_uploads),
                "assemble_s": self.assemble_seconds,
                "upload_s": self.upload_seconds,
                "stage_s": self.stage_seconds}

    # ------------------------------------------------------------------
    # the leader's plan of a forward
    # ------------------------------------------------------------------
    def _hot_width(self, n: int) -> int:
        """The hot read's width: ``n`` resident positions rounded up to a
        page (masked keys add exactly 0)."""
        return -(-n // self.page) * self.page

    def _plan(self, parts, positions: np.ndarray
              ) -> Dict[int, List[List[Tuple[int, Tuple[int, ...]]]]]:
        """Per-row per-layer cold plans for one forward (or one decode
        window). Sliding layers drop segments wholly below their window at
        the FIRST query position: later window steps only move the window
        forward, so a segment kept in is at worst an all-masked exact
        no-op for them."""
        prg = self.programs
        L = self.core.cfg.model.num_layers
        page = self.page
        plans: Dict[int, List[List[Tuple[int, Tuple[int, ...]]]]] = {}
        for row, seq in parts:
            segs = self._cold_segments(seq)
            if not segs:
                continue
            p0 = int(positions[row, 0])     # first query position
            per_layer = []
            for l in range(L):
                w = prg.windows[l]
                if w is None:
                    per_layer.append(segs)
                else:
                    per_layer.append(
                        [sg for sg in segs
                         if (sg[0] + len(sg[1])) * page - 1 > p0 - w])
            plans[row] = per_layer
        return plans

    def _install(self, parts, plans) -> None:
        """Hand each lane's plan to the pager, which starts assembling."""
        for row, seq in parts:
            pl = plans.get(row)
            if pl is not None:
                self.pager.begin(PageinPlan([[sg[1] for sg in segs]
                                             for segs in pl]),
                                 lane=seq.lane)

    def _check_pins(self, plans) -> None:
        """Every cold block of ``plans`` is in the tier (its pin held), so
        that no take can miss once the forward's frame went out: a miss
        raises here, before it (the pin discipline failed)."""
        tiered = self.core.tiered
        for pl in plans.values():
            for segs in pl:
                for _, hashes in segs:
                    for h in hashes:
                        if h not in tiered:
                            raise KvPageMiss(
                                f"cold block {h:x} missing from every "
                                f"tier; the pin discipline was violated")

    def _plan_bytes(self, plans, B: int) -> int:
        """Host staging bytes of one forward's plans (a slot per (layer,
        step))."""
        L = self.core.cfg.model.num_layers
        steps = sum(max((len(pl[l]) for pl in plans.values()), default=0)
                    for l in range(L))
        return steps * self._slot_bytes(B)

    def _plan_arrays(self, plans, B: int, width: int = 1
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """A forward's plan as its frame carries it: the staging steps of
        each layer [L], and every (layer, step) segment's [B, 2] meta
        [L, max(width, steps), B, 2] = (valid blocks, first token
        position), zeros where a lane has no segment; the device rebuilds
        each pass's mask from those two numbers."""
        L = self.core.cfg.model.num_layers
        steps = np.asarray([max((len(pl[l]) for pl in plans.values()),
                                default=0) for l in range(L)], np.int64)
        meta = np.zeros((L, max(width, int(steps.max(initial=0)), 1), B, 2),
                        np.int64)
        for row, pl in plans.items():
            for l in range(L):
                for s, (start_blk, hashes) in enumerate(pl[l]):
                    meta[l, s, row] = (len(hashes), start_blk * self.page)
        return steps, meta

    def _filler(self, parts, plans, B: int):
        """The leader's fill of a (layer, step) whole host slot: every
        lane's staging segment taken from the pager (k over v, lanes
        stacked: the slot is ONE upload), zeros where a lane has none."""
        def fill(hs: _HostSlot, l: int, s: int) -> None:
            assemble_s = 0.0
            filled = set()
            for row, seq in parts:
                pl = plans.get(row)
                if pl is None or s >= len(pl[l]):
                    continue
                k, v, _n = self.pager.take((l, s), lane=seq.lane)
                assemble_s += self.pager.last_assemble_s
                # [seg, Hkv, page, Dh] -> the slot's head-major row
                hs.arr[0, row] = k.transpose(1, 0, 2, 3)
                hs.arr[1, row] = v.transpose(1, 0, 2, 3)
                self.pager.recycle(k, v)
                filled.add(row)
            for row in range(B):
                if row not in filled:
                    hs.arr[:, row] = 0  # masked out: finite, multiplied by 0
            self.assemble_seconds += assemble_s
            self._flow[1] += assemble_s
        return fill

    # ------------------------------------------------------------------
    # the device program of a forward (every rank)
    # ------------------------------------------------------------------
    def _stage(self, B: int, l: int, s: int, cache: Optional[Dict], fill
               ) -> Tuple[_HostSlot, bool]:
        """This rank's host slot of (layer ``l``, step ``s``) and whether
        the window's ``cache`` keeps it. The leader ``fill``s the whole
        slot from the pager; at tp > 1 it then scatters each rank its kv
        heads of it (one host collective a (layer, step), posted by every
        rank in plan order on its engine thread). Within a decode window
        the slots are kept per (layer, step) in ``cache``: later steps
        re-upload them with no take and no scatter."""
        key = (l, s)
        if cache is not None and key in cache:
            return cache[key], True
        if self.core.tp == 1:
            hs = self._take_host(self._slot_shape(B))
            fill(hs, l, s)
        else:
            whole = None
            if fill is not None:
                whole = self._take_host(self._slot_shape(B))
                fill(whole, l, s)
            hs = self._take_host(self._slot_shape(B, local=True))
            collectives.scatter_heads(
                None if whole is None else whole.arr, self.core.host_group,
                self.core._kv_heads, hs.arr.shape, hs.arr.dtype, axis=2,
                out=hs.arr)
            if whole is not None:
                self._give_host(whole)      # the scatter read it already
        if cache is not None:
            cache[key] = hs
        return hs, cache is not None

    def _upload_step(self, B: int, l: int, s: int, cache, fill):
        """Stage and enqueue the upload of one (layer, step) slot; returns
        (device slot, ring index)."""
        t0 = time.perf_counter()
        hs, kept = self._stage(B, l, s, cache, fill)
        t1 = time.perf_counter()
        kv_dev, i = self._upload(hs)
        if not kept:
            self._give_host(hs)     # reused only once its upload is done
        self.pagein_bytes += hs.arr.nbytes
        self.pagein_uploads += 1
        now = time.perf_counter()
        self.stage_seconds += now - t0
        # the ledger's page-in: every kv head's bytes (the tier served the
        # whole slot), priced at assembly + upload enqueue
        self._flow[0] += self._slot_bytes(B)
        self._flow[1] += now - t1
        return kv_dev, i

    def _release_cache(self, cache: Optional[Dict]) -> None:
        if cache is None:
            return
        for hs in cache.values():
            self._give_host(hs)
        cache.clear()

    def _forward(self, B: int, tokens: torch.Tensor, positions: np.ndarray,
                 write_idx: np.ndarray, read_idx: np.ndarray,
                 read_pos: np.ndarray, read_valid: np.ndarray,
                 steps: np.ndarray, meta: torch.Tensor,
                 cache: Optional[Dict] = None, fill=None) -> torch.Tensor:
        """The segmented forward of ``B`` lanes: per layer, qkv and the
        pool write, hot partial attention through the pool (every lane in
        one pass), ``steps[l]`` cold segments merged one lane-stacked
        upload at a time (the next step's upload enqueued before the
        current step's attention, its mask from ``meta[l, s]``), then the
        layer's tail. ``fill`` is the leader's (None on a follower)."""
        core = self.core
        prg = self.programs
        d = self.device
        L = core.cfg.model.num_layers
        pos_d = to_device(positions, d)
        w_d = to_device(write_idx, d)
        r_idx = to_device(read_idx, d)
        r_pos = to_device(read_pos, d)
        r_val = to_device(read_valid, d)
        x = prg.embed(core.params, tokens)
        rope = prg.rope(pos_d)
        self._flow = [0, 0.0]
        if self._cuda:
            self._compute = torch.cuda.current_stream(d)
        for l in range(L):
            q = prg.qkv(core.params, l, x, rope, core.k_pool, core.v_pool,
                        w_d)
            o, m, dd = prg.attn_hot(q, l, core.k_pool, core.v_pool, r_idx,
                                    r_pos, r_val, pos_d)
            n = int(steps[l])
            if n:
                nxt = self._upload_step(B, l, 0, cache, fill)
                for s in range(n):
                    kv_dev, i = nxt
                    if s + 1 < n:
                        nxt = self._upload_step(B, l, s + 1, cache, fill)
                    self._attend_slot(i)
                    o, m, dd = prg.attn_cold(l, q, pos_d, kv_dev, meta[l, s],
                                             o, m, dd)
                    self._slot_read(i)
            x = prg.layer_out(core.params, l, x, o, m, dd, core.group)
        if fill is not None:
            # one ledger record a forward: every lane-stacked upload's
            # bytes, priced at assembly (0 on a window-cache hit) + upload
            # enqueue (a record an upload cost more host time than the
            # upload)
            record_flow("kvpage_pagein", self._flow[0], self._flow[1])
        return x

    def _sampling(self, lanes: List[int]) -> Dict[str, np.ndarray]:
        """The lanes' sampling rows a frame carries."""
        return {"temp": self._temp[lanes], "top_p": self._top_p[lanes],
                "top_k": self._top_k[lanes], "freq": self._freq[lanes],
                "pres": self._pres[lanes]}

    def _run_prefill_program(self, arrs: Dict[str, np.ndarray],
                             fill=None) -> Optional[torch.Tensor]:
        """A prefill chunk's device program, from its host inputs alone
        (every rank runs it: the ``kvpage_prefill`` frame): the segmented
        forward of the chunk, and on the prompt's last chunk the first
        token sampled through the lane's (freshly zeroed) penalty row from
        the frame's uniform: the packed (token, logprob) [1, 2] on the
        device (None for an earlier chunk)."""
        d = self.device
        x = self._forward(1, to_device(arrs["tokens"], d), arrs["positions"],
                          arrs["write_idx"], arrs["read_idx"],
                          arrs["read_pos"], arrs["read_valid"], arrs["steps"],
                          to_device(arrs["meta"], d), fill=fill)
        if "uniforms" not in arrs:
            return None
        ln = int(arrs["lane"][0])
        self._counts[ln].zero_()
        packed, _ = self.programs.head(
            self.core.params, x, to_device(arrs["last_i"], d),
            to_device(arrs["temp"], d), to_device(arrs["top_p"], d),
            to_device(arrs["top_k"], d), to_device(arrs["uniforms"], d),
            self._counts[ln:ln + 1], to_device(arrs["freq"], d),
            to_device(arrs["pres"], d),
            torch.ones(1, dtype=torch.bool, device=d), self.core.group)
        return packed

    def _run_decode_program(self, arrs: Dict[str, np.ndarray],
                            meta: Dict[str, Any], step_fill=None
                            ) -> torch.Tensor:
        """A decode window's device program, from its host inputs alone
        (every rank runs it: the ``kvpage_decode`` frame): N chained steps
        over the B lanes, each sampled token feeding the next forward on
        the device; returns the packed (token, logprob) [N, B, 2].
        ``step_fill(i)`` (the leader's) installs step i's plan with the
        pager when it changes and returns its fill; with ``meta["cached"]``
        every rank keeps its staged slots for the whole window."""
        d = self.device
        prg, core = self.programs, self.core
        N, B = arrs["uniforms"].shape
        lane_args = [to_device(arrs[k], d) for k in ("temp", "top_p",
                                                     "top_k")]
        freq, pres = to_device(arrs["freq"], d), to_device(arrs["pres"], d)
        act_d, uni_d = (to_device(arrs["active"], d),
                        to_device(arrs["uniforms"], d))
        meta_d = to_device(arrs["meta"], d)
        last_i = torch.zeros(B, dtype=torch.long, device=d)
        tok_d = to_device(arrs["tokens"], d)
        cache: Optional[Dict] = {} if meta["cached"] else None
        packed_list: List[torch.Tensor] = []
        try:
            for i in range(N):
                S = int(arrs["hot"][i])
                fill = step_fill(i) if step_fill is not None else None
                x = self._forward(
                    B, tok_d, arrs["positions"][i], arrs["write_idx"][i],
                    *(np.ascontiguousarray(arrs[k][i, :, :S])
                      for k in ("read_idx", "read_pos", "read_valid")),
                    arrs["steps"][i], meta_d[i], cache=cache, fill=fill)
                packed, tok = prg.head(
                    core.params, x, last_i, *lane_args, uni_d[i],
                    self._counts, freq, pres, act_d, core.group)
                packed_list.append(packed)
                # each lane's sampled token feeds its next forward on the
                # device: no host round trip between window steps
                tok_d = tok[:, None]
        finally:
            self._release_cache(cache)
        return torch.stack(packed_list)

    def mirror(self, kind: str, meta: Dict[str, Any],
               arrs: Dict[str, np.ndarray]) -> None:
        """A follower's replay of the leader's ``kvpage_prefill`` or
        ``kvpage_decode`` frame."""
        if kind == "kvpage_prefill":
            self._run_prefill_program(arrs)
            self.prefill_chunks += 1
        else:
            self._run_decode_program(arrs, meta)
            self.decode_windows += 1
            self.decode_steps_run += int(arrs["uniforms"].shape[0])

    def _torn(self) -> bool:
        """Did a failure leave a frame whose program did not return here?
        Then the followers may wait inside a collective: the step must
        fail the worker (``TorchEngine._end_if_torn``), not one lane."""
        return self.core.frames_out != self.core.frames_done

    # ------------------------------------------------------------------
    def _hot_row(self, seq: _PagedSeq, upto: int, padded: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(slots, positions, valid) of width ``padded`` covering the
        resident span [first_res*page, upto) of one lane."""
        start = seq.first_res * self.page
        n = upto - start
        slots = np.zeros(padded, np.int64)
        pos = np.zeros(padded, np.int32)
        valid = np.zeros(padded, bool)
        t = np.arange(start, upto)
        pages = np.asarray(seq.resident, np.int64)
        slots[:n] = (pages[t // self.page - seq.first_res] * self.page
                     + t % self.page)
        pos[:n] = t
        valid[:n] = True
        return slots, pos, valid

    def _prefill_chunk(self, seq: _PagedSeq, out: List) -> None:
        """The leader's host plan of one prefill chunk, its program (a
        ``kvpage_prefill`` frame), then seal-and-demote beyond the hot
        window (a ``kv_offload`` frame)."""
        from ...engine.engine import StepOutput
        from ...utils.roofline import prefill_cost

        t_disp = time.perf_counter()
        C = self.chunk
        prompt = seq.prompt
        start = seq.prefill_done
        count = min(C, len(prompt) - start)
        self._ensure_resident(seq, start + count)
        tokens = np.zeros((1, C), np.int64)
        positions = np.zeros((1, C), np.int32)
        write_idx = np.zeros((1, C), np.int64)    # pad -> scratch page 0
        tokens[0, :count] = prompt[start:start + count]
        positions[0, :count] = np.arange(start, start + count)
        write_idx[0, :count] = [self._slot(seq, p)
                                for p in range(start, start + count)]
        S = self._hot_width(start + count - seq.first_res * self.page)
        read_idx = np.zeros((1, S), np.int64)
        read_pos = np.zeros((1, S), np.int32)
        read_valid = np.zeros((1, S), bool)
        read_idx[0], read_pos[0], read_valid[0] = self._hot_row(
            seq, start + count, S)
        parts = [(0, seq)]
        plans = self._plan(parts, positions)
        self._check_pins(plans)
        self._install(parts, plans)
        steps, meta = self._plan_arrays(plans, 1)
        arrs = {"tokens": tokens, "positions": positions,
                "write_idx": write_idx, "read_idx": read_idx,
                "read_pos": read_pos, "read_valid": read_valid,
                "steps": steps, "meta": meta}
        is_last = start + count >= len(prompt)
        if is_last:
            ln = seq.lane
            arrs.update(self._sampling([ln]),
                        lane=np.asarray([ln], np.int64),
                        last_i=np.asarray([count - 1], np.int64),
                        uniforms=torch.rand(
                            1, generator=self._gens[ln]).numpy())
        with self.core._framed("kvpage_prefill", {}, arrs):
            packed = self._run_prefill_program(
                arrs, self._filler(parts, plans, 1))
        for t in prompt[start:start + count]:
            seq.tokseq.append(int(t))
        seq.total_len = start + count
        seq.prefill_done = start + count
        # demote beyond the hot window now that the writes are enqueued
        self._demote(seq, self.hot_keep)
        tok = lp = None
        if is_last:
            # the lane's designed fetch: the prefill tail's (token, logprob)
            # dynalint: ok(host-sync) the paging lane's prefill-tail fetch:
            # one (token, logprob) a prompt
            arr = packed.cpu().numpy()
            tok, lp = int(arr[0, 0]), float(arr[0, 1])
        elapsed = time.perf_counter() - t_disp
        self.prefill_chunks += 1
        self.prefill_seconds += elapsed
        fl, by, tk = prefill_cost(self.core.costs, [(start, count)])
        self.core.goodput.account(fl, by, elapsed, tk)
        if not is_last:
            return
        seq.generated = 1
        seq.last_token = tok
        seq.cum_logprob = lp
        fin = self._finish(seq, tok)
        out.append(StepOutput(seq.seq_id, tok, seq.cum_logprob, fin,
                              prompt_tokens=len(prompt),
                              token_logprob=lp))
        if fin is not None:
            self._release(seq)

    def _window(self, seq: _PagedSeq) -> int:
        """Decode tokens to chain before the next host fetch: bounded by
        the chain knob, the request's remaining token budget and the paged
        context ceiling (tokens past a mid-window EOS are the only wasted
        work: their writes die with the released pages)."""
        n = self.decode_chain
        if seq.request.stop.max_tokens:
            n = min(n, seq.request.stop.max_tokens - seq.generated)
        n = min(n, self.pcfg.max_context - len(seq.prompt) - seq.generated)
        return max(1, n)

    def _decode_window(self, parts, out: List) -> None:
        """One chained decode window across every decode-ready lane: N =
        the least window bound over lanes, so no lane oversteps its token
        budget; each step samples one token a lane from one batched pass,
        with ONE host fetch at the end. The leader plans every step on the
        host (the hot reads, the cold plans, the uniforms), then runs the
        window's program (a ``kvpage_decode`` frame)."""
        from ...engine.engine import StepOutput
        from ...utils.roofline import decode_cost

        t_disp = time.perf_counter()
        N = min(self._window(seq) for _, seq in parts)
        B = self.batch
        # per-lane residency setup: a failure here (pool pressure) is
        # lane-local, nothing shared is touched yet, so only the starved
        # lane errors and the window goes on without it. Demotion comes
        # before the lease, so a lane never holds more than its share
        # (the JAX lane leases first and may hold one page over)
        ready = []
        for row, seq in parts:
            try:
                need = (-(-(seq.total_len + N) // self.page)
                        - seq.first_res - len(seq.resident))
                if len(seq.resident) + need > self.lane_budget:
                    self._demote(seq, self.lane_budget - need)
                self._ensure_resident(seq, seq.total_len + N)
                ready.append((row, seq))
            except Exception as e:  # noqa: BLE001 - typed per-lane error
                if self._torn():
                    raise
                log.exception("paged sequence %s failed", seq.seq_id)
                self._fail(seq, e, out)
        if not ready:
            return
        parts = ready
        self.max_window_lanes = max(self.max_window_lanes, len(parts))
        active = np.zeros(B, bool)
        tokens = np.zeros((B, 1), np.int64)
        uniforms = np.zeros((N, B), np.float32)
        for row, seq in parts:
            active[row] = True
            tokens[row, 0] = seq.last_token
            uniforms[:, row] = torch.rand(
                N, generator=self._gens[seq.lane]).numpy()
        positions = np.zeros((N, B, 1), np.int32)
        write_idx = np.zeros((N, B, 1), np.int64)    # pad -> scratch
        hot = np.ones(N, np.int64)
        for i in range(N):
            S = 1
            for row, seq in parts:
                pos = seq.total_len + i
                positions[i, row, 0] = pos
                write_idx[i, row, 0] = self._slot(seq, pos)
                S = max(S, pos + 1 - seq.first_res * self.page)
            hot[i] = self._hot_width(S)
        Smax = int(hot.max())
        read_idx = np.zeros((N, B, Smax), np.int64)
        read_pos = np.zeros((N, B, Smax), np.int32)
        read_valid = np.zeros((N, B, Smax), bool)
        for i in range(N):
            for row, seq in parts:
                (read_idx[i, row, :hot[i]], read_pos[i, row, :hot[i]],
                 read_valid[i, row, :hot[i]]) = self._hot_row(
                    seq, seq.total_len + i + 1, int(hot[i]))
        # one page-in plan and one set of host slots serve every chained
        # step (demotion happens only at window boundaries) while they
        # fit the cache bound; past it each step plans and takes its
        # segments again
        plans = [self._plan(parts, positions[0])]
        cached = self._plan_bytes(plans[0], B) <= WINDOW_CACHE_BYTES
        if not cached:
            self.uncached_windows += 1
            plans += [self._plan(parts, positions[i]) for i in range(1, N)]
        for pl in plans:
            self._check_pins(pl)
        width = max(int(self._plan_arrays(pl, B)[0].max(initial=0))
                    for pl in plans)
        step_arrays = [self._plan_arrays(plans[min(i, len(plans) - 1)], B,
                                         width) for i in range(N)]
        arrs = dict(self._sampling(list(range(B))), tokens=tokens,
                    active=active, uniforms=uniforms, positions=positions,
                    write_idx=write_idx, read_idx=read_idx,
                    read_pos=read_pos, read_valid=read_valid, hot=hot,
                    steps=np.stack([a[0] for a in step_arrays]),
                    meta=np.stack([a[1] for a in step_arrays]))

        def step_fill(i: int):
            pl = plans[min(i, len(plans) - 1)]
            if i == 0 or not cached:
                self._install(parts, pl)
            return self._filler(parts, pl, B)

        try:
            with self.core._framed("kvpage_decode", {"cached": cached},
                                   arrs):
                packed = self._run_decode_program(arrs, {"cached": cached},
                                                  step_fill)
            # the lane's designed fetch: one packed (token, logprob)
            # [N, B, 2] for the whole window, every lane at once
            # dynalint: ok(host-sync) the paging lane's window fetch: one
            # packed [N, B, 2] read for a whole chained window
            arr = packed.cpu().numpy()
        except Exception as e:  # noqa: BLE001 - window-fatal
            if self._torn():
                raise
            # a failure inside the batched chain cannot be pinned on one
            # lane once shared state advanced: every participating lane
            # gets the typed error; lanes still prefilling are untouched
            # (their generators and count rows were not used)
            log.exception("paged decode window failed (%d lanes)",
                          len(parts))
            for row, seq in parts:
                self._fail(seq, e, out)
            return
        fl = by = tk = 0.0
        for row, seq in parts:
            fin = None
            pos0 = seq.total_len
            for i in range(N):
                seq.tokseq.append(int(seq.last_token))
                seq.total_len = pos0 + i + 1
                tok, lp = int(arr[i, row, 0]), float(arr[i, row, 1])
                f, b, t = decode_cost(self.core.costs, [pos0 + i], 1)
                fl, by, tk = fl + f, by + b, tk + t
                seq.generated += 1
                seq.last_token = tok
                seq.cum_logprob += lp
                fin = self._finish(seq, tok)
                out.append(StepOutput(seq.seq_id, tok, seq.cum_logprob,
                                      fin, token_logprob=lp))
                if fin is not None:
                    # mid-window stop: this lane's tokens past it are
                    # dropped; their writes die with the release below
                    break
            if fin is not None:
                self._release(seq)
        elapsed = time.perf_counter() - t_disp
        self.decode_windows += 1
        self.decode_steps_run += N
        self.decode_seconds += elapsed
        self.core.goodput.account(fl, by, elapsed, tk)

    def _finish(self, seq: _PagedSeq, token: int) -> Optional[FinishReason]:
        req = seq.request
        if not req.stop.ignore_eos:
            eos = set(req.eos_token_ids) | set(req.stop.stop_token_ids)
            if token in eos and seq.generated >= (req.stop.min_tokens or 0):
                return FinishReason.EOS
        if req.stop.max_tokens and seq.generated >= req.stop.max_tokens:
            return FinishReason.LENGTH
        if len(seq.prompt) + seq.generated >= self.pcfg.max_context:
            return FinishReason.LENGTH
        return None
