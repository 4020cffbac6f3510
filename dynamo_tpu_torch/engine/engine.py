"""The in-tree torch engine: continuous batching over a paged KV pool.

Architecture:
- A synchronous :class:`EngineCore` owns all mutable state (slots, page
  tables, sampling state, the KV pools) and is driven from one engine thread
  — the single-owner actor discipline the reference uses for its schedulers.
- Each iteration admits waiting requests and runs ONE batched prefill
  dispatch that advances every mid-prefill sequence by one chunk (flash
  attention over the gathered context), then ONE decode dispatch of
  ``decode_steps`` autoregressive steps over every decode-ready sequence
  (paged attention straight off the pool). Sampling and penalties run on the
  device; each dispatch fetches one packed (token, logprob) tensor to the
  host.
- :class:`TorchEngine` is the asyncio facade implementing the AsyncEngine
  contract (BackendInput -> stream of EngineOutput).

Not ported yet (the JAX engine has them): the chained in-flight decode
window, prefix reuse and KV tiers, speculative decoding, disaggregated
prefill, the long-context paging lane, multimodal input, MoE and tp/pp/sp.

Reference capability: the role vLLM/TRT-LLM play behind the reference's
adapters (continuous batching, paged KV, streaming detached tokens), per
SURVEY §7 step 3.
"""

from __future__ import annotations

import asyncio
import collections
import glob
import logging
import os
import queue as thread_queue
import random
import threading
import time
from dataclasses import dataclass, fields
from typing import (Any, AsyncIterator, Callable, Deque, Dict, List,
                    Optional, Tuple)

import numpy as np
import torch

from ..device import resolve_device
from ..llm.model_card import ModelDeploymentCard
from ..llm.protocols.common import BackendInput, EngineOutput, FinishReason
from ..models import llama
from ..runtime.engine import AsyncEngine, Context
from .cache import OutOfPages, PagePool
from .sampling import (STATIC_K, apply_penalties, draw_uniforms,
                       lane_generator, resume_seed, sample)

log = logging.getLogger("dynamo_tpu_torch.engine")

# JAX engine options this engine does not implement yet: asking for one
# raises instead of silently serving a different engine
_NOT_PORTED = frozenset({
    "tp", "sp", "ep", "pp", "prefill_lanes", "params_path", "attn_impl",
    "warmup", "enable_prefix_reuse", "host_cache_blocks",
    "disk_cache_blocks", "disk_cache_path", "cluster_writethrough", "spec",
    "spec_k", "spec_draft", "kvpage_budget", "kvpage_seg_pages",
    "kvpage_prefetch", "kvpage_max_context", "kvpage_batch"})


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

    @classmethod
    def from_card(cls, card: ModelDeploymentCard,
                  **extra) -> "TorchEngineConfig":
        if card.path and (glob.glob(os.path.join(card.path, "*.safetensors"))
                          or str(card.path).endswith(".gguf")):
            raise NotImplementedError(
                f"{card.path}: checkpoint loading is not ported to torch yet "
                f"(weights are random, from the seed)")
        if card.model_config:
            mcfg = llama.LlamaConfig.from_hf_config(card.model_config)
        elif extra.get("preset"):
            mcfg = llama.preset(extra["preset"])
        else:
            mcfg = llama.preset("tiny-byte")
        kw: Dict[str, Any] = dict(model=mcfg, page_size=card.kv_block_size)
        names = {f.name for f in fields(cls)} - {"model"}
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
        cfg.max_context = min(cfg.max_context, card.context_length)
        return cfg


@dataclass
class _Slot:
    seq_id: str
    request: BackendInput
    prompt: List[int]
    prefill_done: int = 0           # prompt tokens already in cache
    generated: int = 0
    last_token: int = 0
    cum_logprob: float = 0.0
    cancelled: bool = False


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


class EngineCore:
    """Synchronous continuous-batching core. Single-threaded by contract.

    ``params`` (the tree of :func:`~dynamo_tpu_torch.models.llama.
    init_params`, on the engine's device) replaces the seeded random init,
    e.g. with weights converted by ``params_from_jax``.
    """

    def __init__(self, cfg: TorchEngineConfig,
                 params: Optional[Dict[str, Any]] = None):
        self.cfg = cfg
        m = cfg.model
        self.device = resolve_device(cfg.device)
        self.page_size = cfg.page_size
        # a dispatch may overshoot a finishing sequence by up to
        # decode_steps tokens: they land in its own pre-allocated pages
        self._pad = -(-cfg.decode_steps // cfg.page_size) * cfg.page_size
        self.max_pages_per_seq = -(-(cfg.max_context + self._pad)
                                   // cfg.page_size)
        num_pages = cfg.num_pages or (cfg.max_batch * self.max_pages_per_seq
                                      + 1)
        self.pool = PagePool(num_pages, cfg.page_size)
        with torch.no_grad():
            if params is None:
                gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
                params = llama.init_params(m, gen, self.device)
            self.params = params
            # head-major [L, Hkv, n_pages, page, Dh]: pool[l] is directly
            # the paged kernel's layout; page 0 is the scratch page
            pool_shape = (m.num_layers, m.num_kv_heads, num_pages,
                          cfg.page_size, m.head_dim)
            self.k_pool = torch.zeros(pool_shape, dtype=m.dtype,
                                      device=self.device)
            self.v_pool = torch.zeros(pool_shape, dtype=m.dtype,
                                      device=self.device)
            # generated-token occurrence counts per lane (frequency /
            # presence penalties), reset when a sequence enters decode
            self.gen_counts = torch.zeros((cfg.max_batch, m.vocab_size),
                                          dtype=torch.int32,
                                          device=self.device)

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
        # dispatch counters and host-clock seconds per dispatch kind, each
        # ending in its result fetch (a run reads them beside the kernel
        # launch counters)
        self.prefill_dispatches = 0
        self.decode_dispatches = 0
        self.decode_steps_run = 0
        self.prefill_seconds = 0.0
        self.decode_seconds = 0.0

    # ------------------------------------------------------------------
    # public API (engine thread)
    # ------------------------------------------------------------------
    def submit(self, seq_id: str, request: BackendInput) -> None:
        self.waiting.append((seq_id, request))

    def cancel(self, seq_id: str) -> None:
        slot = self.by_seq.get(seq_id)
        if slot is not None:
            slot.cancelled = True
        else:
            self.waiting = collections.deque(
                (s, r) for s, r in self.waiting if s != seq_id)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.by_seq)

    def step(self, flush: Optional[Callable[[List[StepOutput]], None]] = None
             ) -> List[StepOutput]:
        """Run one engine iteration: reap cancelled sequences, one batched
        prefill dispatch (admitting as many waiting requests as fit), then
        one multi-step decode dispatch over every decode-ready sequence.

        ``flush``, when given, receives the outputs that exist before the
        decode dispatch (first tokens, rejections, cancellations) so they
        reach callers without waiting for it (TTFT); the rest are
        returned."""
        out = self._reap_cancelled()
        with torch.no_grad():
            prefill_work = any(s is not None and s.prefill_done < len(s.prompt)
                               for s in self.slots)
            if prefill_work or (self.waiting and None in self.slots):
                self._prefill_round(out)
            if flush is not None and out:
                flush(out)
                out = []
            if any(s is not None and s.prefill_done >= len(s.prompt)
                   for s in self.slots):
                self._decode_round(out)
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
        self.pool.release(slot.seq_id)
        self.by_seq.pop(slot.seq_id, None)
        self.slots[i] = None

    def _admit_one(self, out: List[StepOutput]):
        """Admit the head-of-line request into a free slot (no prefill yet).
        Returns (slot_idx, slot), "rejected" (popped with an error emitted),
        or "blocked" (no KV capacity right now)."""
        seq_id, req = self.waiting[0]
        prompt = list(req.token_ids)
        over_ctx = len(prompt) >= self.cfg.max_context
        over_pool = (self.pool.pages_needed(len(prompt) + 1)
                     > self.pool.num_pages - 1)
        if over_ctx or over_pool:
            # can NEVER fit, even with an empty pool: reject, don't starve
            self.waiting.popleft()
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
        if req.images:
            self.waiting.popleft()
            out.append(StepOutput(
                seq_id, 0, 0.0, FinishReason.ERROR, error_code=400,
                error="image input is not supported by the torch engine yet"))
            return "rejected"
        if not self.pool.can_admit(len(prompt) + 1):
            return "blocked"  # decode will free KV space eventually
        self.waiting.popleft()
        slot_idx = self.slots.index(None)
        slot = _Slot(seq_id, req, prompt)
        self.slots[slot_idx] = slot
        self.by_seq[seq_id] = slot
        self.pool.create(seq_id)
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
            if admitted == "rejected":
                continue
            chunks.append(admitted)
        if chunks:
            self._prefill_dispatch(chunks, out)

    def _lane_tensors(self, idx: List[int]):
        d = self.device
        return (torch.from_numpy(self.temperature[idx]).to(d),
                torch.from_numpy(self.top_p[idx]).to(d),
                torch.from_numpy(self.top_k[idx]).to(d))

    def _prefill_dispatch(self, chunks: List[Tuple[int, _Slot]],
                          out: List[StepOutput]) -> None:
        """Advance each (slot_idx, slot) by one prompt chunk in a single
        batched dispatch; fetch all lanes' sampled tokens with ONE host
        round-trip and keep results only for lanes whose prompt completed."""
        cfg = self.cfg
        work = []  # (slot_idx, slot, start, count, is_last)
        for i, slot in chunks:
            start = slot.prefill_done
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
        t0 = time.perf_counter()
        d = self.device
        idx = [w[0] for w in work]
        temp, top_p, top_k = self._lane_tensors(idx)
        logits, _, _ = llama.forward(
            self.params, cfg.model, torch.from_numpy(tokens).to(d),
            torch.from_numpy(positions).to(d), self.k_pool, self.v_pool,
            torch.from_numpy(write_idx).to(d), torch.from_numpy(read_idx).to(d),
            torch.from_numpy(read_pos).to(d),
            torch.from_numpy(read_valid).to(d), attn_impl="flash",
            logits_idx=torch.from_numpy(last_i).to(d))
        tok, logp = sample(logits[:, 0], temp, top_p, top_k,
                           torch.from_numpy(uniforms).to(d))
        packed = torch.stack([tok.float(), logp], -1).cpu().numpy()  # 1 fetch
        self.prefill_dispatches += 1
        self.prefill_seconds += time.perf_counter() - t0
        for lane, (i, slot, start, count, is_last) in enumerate(work):
            slot.prefill_done = start + count
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
    def _decode_eligible(self):
        """(slot_idx, slot, phys_len) for every decode-ready slot whose
        dispatch's pages could be reserved; deferred = ready but no pages."""
        N = self.cfg.decode_steps
        active, deferred = [], []
        for i, slot in enumerate(self.slots):
            if slot is None or slot.prefill_done < len(slot.prompt):
                continue
            phys = len(slot.prompt) + slot.generated
            try:
                # reserve room for N speculative tokens up front
                self.pool.ensure_pages(slot.seq_id, phys + N)
            except OutOfPages:
                # pool pressure: batchmates finishing will free pages
                deferred.append((i, slot))
                continue
            active.append((i, slot, phys))
        return active, deferred

    def _decode_round(self, out: List[StepOutput]) -> None:
        """One multi-step decode dispatch over every decode-ready lane:
        ``decode_steps`` forward+sample iterations with the sampled token
        fed straight back in on the device, then ONE packed host fetch.
        Lanes that finish mid-dispatch overshoot harmlessly into their own
        pre-allocated pages; the host trims afterwards."""
        cfg, m = self.cfg, self.cfg.model
        N = cfg.decode_steps
        active, deferred = self._decode_eligible()
        if not active:
            if deferred:
                # every ready lane is blocked on KV capacity: evict the
                # largest consumer so the rest of the system unblocks
                i, slot = max(deferred, key=lambda t: len(
                    self.pool.seqs[t[1].seq_id].pages))
                out.append(StepOutput(
                    slot.seq_id, slot.last_token, slot.cum_logprob,
                    FinishReason.ERROR,
                    error="evicted under KV pool pressure (no capacity to "
                          "continue decoding)"))
                self._free_slot(i)
            return
        t0 = time.perf_counter()
        d = self.device
        idx = [i for i, _, _ in active]
        P = -(-max(phys + N for _, _, phys in active) // self.page_size)
        page_tables = np.stack([self.pool.page_table_row(s.seq_id, P)
                                for _, s, _ in active])
        lengths = np.asarray([phys for _, _, phys in active], np.int32)
        tokens = np.asarray([s.last_token for _, s, _ in active], np.int64)
        lane = torch.as_tensor(idx, device=d)
        for i, slot, _ in active:
            if self._decode_seen.get(i) != slot.seq_id:
                # a sequence entering decode restarts its penalty counts at
                # one-hot(first generated token)
                self._decode_seen[i] = slot.seq_id
                self.gen_counts[i].zero_()
                self.gen_counts[i, slot.last_token] = 1
        temp, top_p, top_k = self._lane_tensors(idx)
        freq = torch.from_numpy(self.freq_pen[idx]).to(d)
        pres = torch.from_numpy(self.pres_pen[idx]).to(d)
        uniforms = draw_uniforms([self.generators[i] for i in idx], N, d)
        tok = torch.from_numpy(tokens).to(d)
        pt = torch.from_numpy(page_tables).to(d)
        ln = torch.from_numpy(lengths).to(d)
        toks, logps = [], []
        for j in range(N):
            logits, _, _ = llama.forward_decode(
                self.params, m, tok, self.k_pool, self.v_pool, pt, ln,
                attn_impl="paged")
            lg = apply_penalties(logits[:, 0], self.gen_counts[lane], freq,
                                 pres)
            tok, logp = sample(lg, temp, top_p, top_k, uniforms[j])
            self.gen_counts[lane, tok] += 1
            toks.append(tok)
            logps.append(logp)
            ln = ln + 1
        packed = torch.stack([torch.stack(toks).float(), torch.stack(logps)],
                             -1).cpu().numpy()          # [N, Ba, 2] 1 fetch
        self.decode_dispatches += 1
        self.decode_steps_run += N
        self.decode_seconds += time.perf_counter() - t0
        for a, (i, slot, _) in enumerate(active):
            for j in range(N):
                t = int(packed[j, a, 0])
                self.pool.account_tokens(slot.seq_id, [t])
                slot.generated += 1
                slot.last_token = t
                tok_lp = float(packed[j, a, 1])
                slot.cum_logprob += tok_lp
                fin = self._finish_reason(slot, t)
                out.append(StepOutput(slot.seq_id, t, slot.cum_logprob, fin,
                                      token_logprob=tok_lp))
                if fin is not None:
                    self._free_slot(i)
                    break


# ---------------------------------------------------------------------------
# Async facade
# ---------------------------------------------------------------------------

class TorchEngine(AsyncEngine[BackendInput, EngineOutput]):
    """AsyncEngine facade: one background engine thread runs EngineCore."""

    def __init__(self, cfg: TorchEngineConfig,
                 params: Optional[Dict[str, Any]] = None):
        self.core = EngineCore(cfg, params)
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
            if not self.core.has_work:
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            try:
                outs = self.core.step(flush=self._deliver_all)
            except Exception as e:  # engine must never die silently
                log.exception("engine step failed")
                outs = [StepOutput(sid, 0, 0.0, FinishReason.ERROR,
                                   error=f"engine step failed: {e}")
                        for sid in list(self.core.by_seq)]
                for sid in list(self.core.by_seq):
                    self.core.cancel(sid)
                self.core._reap_cancelled()
            self._deliver_all(outs)
            if not outs and not self.core.by_seq:
                # waiting requests that can't be admitted yet: don't spin
                self._wake.wait(timeout=0.02)
                self._wake.clear()

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
        self._loop = asyncio.get_running_loop()
        seq_id = context.id
        q: asyncio.Queue = asyncio.Queue()
        self._queues[seq_id] = q
        self._inbox.put(("submit", seq_id, request))
        self._wake.set()

        async def watch_cancel():
            await context.stopped()
            self._inbox.put(("cancel", seq_id, None))
            self._wake.set()

        cancel_task = asyncio.ensure_future(watch_cancel())
        try:
            while True:
                so: StepOutput = await q.get()
                if so.finish == FinishReason.ERROR:
                    yield EngineOutput(token_ids=[],
                                       finish_reason=FinishReason.ERROR,
                                       error=so.error or "engine error",
                                       error_code=so.error_code,
                                       error_stage=so.error_stage,
                                       error_reason=so.error_reason)
                    return
                yield EngineOutput(
                    token_ids=[so.token],
                    cum_log_prob=so.logprob,
                    logprobs=[{str(so.token): so.token_logprob}],
                    finish_reason=so.finish,
                )
                if so.finish is not None:
                    return
        finally:
            cancel_task.cancel()
            self._queues.pop(seq_id, None)
            self._inbox.put(("cancel", seq_id, None))
            self._wake.set()

    # ------------------------------------------------------------------
    def shutdown(self) -> None:
        self._running = False
        self._wake.set()
        self._thread.join(timeout=30)
