"""Speculative decoding for the torch engine: pluggable draft proposers.

Decode is memory-bandwidth-bound: every step streams the whole weight set
to emit one token per lane. Speculative decoding drafts k cheap candidate
tokens per lane and verifies all of them in ONE wider forward pass
(``EngineCore._spec_round``: the flash kernel over k+1 positions a lane),
so each dispatch can commit up to k+1 tokens instead of one. This module
owns the host side of that subsystem, with the JAX package's names and
behaviour:

- :class:`NgramProposer` — prompt-lookup / self-speculation: the draft for
  the next k tokens is the continuation of the most recent earlier
  occurrence of the current suffix n-gram within the request's own
  prompt+generated tokens. No extra weights.
- :class:`DraftModelProposer` — a second, smaller model (sharing the
  tokenizer) that greedily drafts k tokens against its own private paged
  KV pool, through the same CUDA kernels as the target on the card (their
  plain versions on the CPU).

Acceptance (greedy exact-match; rejection sampling for temperature>0) lives
in :mod:`.sampling` (``spec_verify``/``spec_accept``). Rejected tokens roll
back by never being accounted: pages are reserved ahead, block hashes seal
only over accepted tokens, and the next dispatch overwrites the stale KV
slots.

Env knobs (each overridable per engine via ``TorchEngineConfig``):

- ``DYN_SPEC``            "" (off, default) | ``ngram`` | ``draft``
- ``DYN_SPEC_K``          max draft tokens per lane per dispatch (default 4)
- ``DYN_SPEC_K_MIN``      adaptive-k floor (default 1)
- ``DYN_SPEC_ADAPT``      per-lane adaptive k on/off (default 1)
- ``DYN_SPEC_NGRAM_MAX``  longest suffix n-gram to look up (default 3)
- ``DYN_SPEC_NGRAM_MIN``  shortest suffix n-gram to fall back to (default 1)
- ``DYN_SPEC_NGRAM_WINDOW`` lookback tokens the n-gram match scans (2048)
- ``DYN_SPEC_DRAFT``      draft model: a preset name or checkpoint dir
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device, to_device

log = logging.getLogger("dynamo_tpu_torch.engine.spec")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        log.warning("invalid %s=%r; using %d", name, os.environ.get(name),
                    default)
        return default


@dataclass
class SpecConfig:
    """Resolved speculative-decoding configuration (spec is ON)."""

    mode: str                   # "ngram" | "draft"
    k_max: int = 4
    k_min: int = 1
    adapt: bool = True
    ngram_max: int = 3
    ngram_min: int = 1
    ngram_window: int = 2048    # lookback tokens the n-gram match scans
    draft: Optional[str] = None  # preset name or checkpoint dir

    def __post_init__(self):
        self.k_max = max(1, int(self.k_max))
        self.k_min = max(1, min(int(self.k_min), self.k_max))
        self.ngram_min = max(1, int(self.ngram_min))
        self.ngram_max = max(self.ngram_min, int(self.ngram_max))
        self.ngram_window = max(self.ngram_max + 1, int(self.ngram_window))
        # verify widths: powers of two up to k_max (plus k_max itself), as
        # in the JAX engine, so the flash kernel sees a few query shapes
        b, out = 1, []
        while b < self.k_max:
            out.append(b)
            b *= 2
        out.append(self.k_max)
        self.k_buckets: List[int] = sorted(set(out))

    def bucket(self, k: int) -> int:
        """Smallest verify width covering ``k`` drafts (always >= 1: a
        zero-draft round still verifies one position, which IS a plain
        single-token decode step)."""
        for b in self.k_buckets:
            if k <= b:
                return b
        return self.k_buckets[-1]

    def next_k(self, k: int, accepted: int, proposed: int) -> int:
        """Per-lane adaptive draft length: grow on full acceptance, shrink
        on total rejection, hold otherwise."""
        if not self.adapt:
            return k
        if proposed and accepted >= proposed:
            return min(k * 2, self.k_max)
        if proposed and accepted == 0:
            return max(k // 2, self.k_min)
        return k


def resolve_spec(cfg) -> Optional[SpecConfig]:
    """Build a :class:`SpecConfig` from a ``TorchEngineConfig`` and the
    ``DYN_SPEC*`` env knobs. Returns None (spec off, decode path untouched)
    unless explicitly enabled; an unknown mode raises ValueError."""
    mode = cfg.spec if cfg.spec is not None else os.environ.get("DYN_SPEC", "")
    mode = (mode or "").strip().lower()
    if mode in ("", "0", "off", "none", "false"):
        return None
    if mode not in ("ngram", "draft"):
        raise ValueError(f"spec/DYN_SPEC must be ngram|draft, got {mode!r}")
    return SpecConfig(
        mode=mode,
        k_max=(cfg.spec_k if cfg.spec_k is not None
               else _env_int("DYN_SPEC_K", 4)),
        k_min=_env_int("DYN_SPEC_K_MIN", 1),
        adapt=os.environ.get("DYN_SPEC_ADAPT", "1") not in ("0", "false"),
        ngram_max=_env_int("DYN_SPEC_NGRAM_MAX", 3),
        ngram_min=_env_int("DYN_SPEC_NGRAM_MIN", 1),
        ngram_window=_env_int("DYN_SPEC_NGRAM_WINDOW", 2048),
        draft=(cfg.spec_draft if cfg.spec_draft is not None
               else os.environ.get("DYN_SPEC_DRAFT") or None),
    )


@dataclass
class SeqSpecState:
    """Per-sequence speculation state (host side, engine thread)."""

    tokens: List[int]                    # committed prompt + generated
    k: int                               # current adaptive draft length
    # tokens committed since the last verify dispatch, folded into the
    # on-device penalty counts at the start of the next dispatch
    pending: List[int] = field(default_factory=list)


class NgramProposer:
    """Prompt-lookup decoding: self-speculation from the request's own
    context. Looks up the most recent earlier occurrence of the current
    suffix n-gram (longest first) within a bounded lookback window and
    proposes its continuation. numpy-vectorized and window-clipped: it runs
    per lane per verify round on the engine thread."""

    def __init__(self, sc: SpecConfig):
        self.sc = sc

    def propose(self, seq_id: str, st: SeqSpecState, k: int) -> List[int]:
        arr = np.asarray(st.tokens[-self.sc.ngram_window:], dtype=np.int32)
        L = arr.size
        for n in range(self.sc.ngram_max, self.sc.ngram_min - 1, -1):
            if L <= n:
                continue
            pat = arr[-n:]
            # candidate starts j in [0, L-n-1] (the suffix itself excluded)
            m = np.ones(L - n, dtype=bool)
            for o in range(n):
                m &= arr[o:o + L - n] == pat[o]
            idx = np.nonzero(m)[0]
            if idx.size:
                j = int(idx[-1]) + n   # most recent occurrence wins
                # j <= L - 1: at least one continuation token, clipped at
                # the context end
                return [int(t) for t in arr[j:j + k]]
        return []

    def drop(self, seq_id: str) -> None:
        pass


class DraftModelProposer:
    """Greedy drafting from a second, smaller model against its own private
    paged KV pool (one page table per engine sequence), on the engine's
    device and in the target's dtype.

    The draft pool keeps the engine's bookkeeping discipline: pages are
    reserved ahead, only committed tokens are accounted, and drafted KV
    writes overshoot into reserved pages where the next sync chunk
    overwrites them. Per lane and round: sync chunks (``llama.forward``,
    flash) feed the committed tokens the draft KV lacks, then k greedy
    single-token steps (``llama.forward_decode``, paged) are enqueued with
    each argmax fed back on the device, and the k tokens come to the host
    in ONE fetch.

    Weights: ``params`` (the :func:`~dynamo_tpu_torch.models.llama.
    init_params` tree on ``device``, e.g. from ``params_from_jax``) when
    given; else a checkpoint directory's (``sc.draft`` a path), else a
    random init of the preset ``sc.draft`` (default ``tiny-byte``) from
    ``cfg.seed + 101``.
    """

    def __init__(self, sc: SpecConfig, cfg, device=None,
                 params: Optional[Dict[str, Any]] = None):
        from ..models import llama
        from ..ops.attention import check_kernel_support
        from .cache import PagePool

        self.sc = sc
        self.device = resolve_device(device if device is not None
                                     else cfg.device)
        src = sc.draft or "tiny-byte"
        is_dir = os.path.exists(src)
        if is_dir:
            from ..llm.model_card import ModelDeploymentCard

            card = ModelDeploymentCard.from_local_path(src)
            if not card.model_config:
                raise ValueError(f"draft checkpoint {src} has no config")
            mcfg = llama.LlamaConfig.from_hf_config(card.model_config,
                                                    dtype=cfg.model.dtype)
        else:
            mcfg = llama.preset(src, dtype=cfg.model.dtype)
        self.mcfg = mcfg
        if mcfg.vocab_size > cfg.model.vocab_size:
            raise ValueError(
                f"draft model {src!r} has vocab {mcfg.vocab_size}, more than "
                f"the target's {cfg.model.vocab_size}")
        if self.device.type == "cuda":
            check_kernel_support(mcfg.head_dim, mcfg.dtype)
        self.page = cfg.page_size
        pad = -(-(sc.k_max + 1) // self.page) * self.page
        self.pages_per_seq = -(-(cfg.max_context + pad) // self.page)
        self.pool = PagePool(cfg.max_batch * self.pages_per_seq + 1,
                             self.page)
        self.chunk = cfg.prefill_chunk
        with torch.no_grad():
            if params is None and is_dir:
                from .loader import load_llama_params

                params = load_llama_params(src, mcfg, self.device)
            elif params is None:
                gen = torch.Generator(device=self.device).manual_seed(
                    cfg.seed + 101)
                params = llama.init_params(mcfg, gen, self.device)
            self.params = params
            pool_shape = (mcfg.num_layers, mcfg.num_kv_heads,
                          self.pool.num_pages, self.page, mcfg.head_dim)
            self.k_pool = torch.zeros(pool_shape, dtype=mcfg.dtype,
                                      device=self.device)
            self.v_pool = torch.zeros(pool_shape, dtype=mcfg.dtype,
                                      device=self.device)
        self.synced: Dict[str, int] = {}   # committed tokens in draft KV
        # dispatch counters: a run reads them beside the kernel launches
        # (flash: num_layers a sync chunk; paged: num_layers a step)
        self.sync_dispatches = 0
        self.steps_run = 0

    @torch.no_grad()
    def propose(self, seq_id: str, st: SeqSpecState, k: int) -> List[int]:
        from ..models import llama
        from .cache import OutOfPages

        ctx = st.tokens
        if len(ctx) < 2 or k < 1:
            return []
        if seq_id not in self.synced:
            self.pool.create(seq_id, block_hashing=False)
            self.synced[seq_id] = 0
        try:
            self.pool.ensure_pages(seq_id, len(ctx) + self.sc.k_max)
        except OutOfPages:
            return []   # draft pool pressure: skip speculation this round
        # sync committed tokens (all but the last, which feeds the steps)
        n = self.synced[seq_id]
        while n < len(ctx) - 1:
            count = min(len(ctx) - 1 - n, self.chunk)
            self._sync_chunk(seq_id, ctx, n, count)
            n += count
            # accounted tokens never shrink: num_tokens tracks the sync
            # high-water mark, so re-synced (post-rollback) slots are
            # rewritten in place without re-accounting
            sc = self.pool.seqs[seq_id]
            if n > sc.num_tokens:
                sc.num_tokens = n
        self.synced[seq_id] = n
        # k greedy steps from the last committed token, enqueued with no
        # host sync: each step's argmax feeds the next on the device
        d = self.device
        P = -(-(len(ctx) + k) // self.page)
        pt = to_device(self.pool.page_table_row(seq_id, P)[None], d)
        tok = to_device(np.asarray([ctx[-1]], np.int64), d)
        ln = to_device(np.asarray([len(ctx)], np.int32), d)
        toks = []
        for _ in range(k):
            logits, _, _ = llama.forward_decode(
                self.params, self.mcfg, tok, self.k_pool, self.v_pool, pt,
                ln, attn_impl="paged")
            tok = torch.argmax(logits[:, 0], dim=-1)
            toks.append(tok)
            ln = ln + 1
        self.steps_run += k
        # dynalint: ok(host-sync) the draft proposer's designed fetch: one read
        # of the k drafts a round
        return torch.cat(toks).tolist()     # ONE fetch of the k drafts

    def _sync_chunk(self, seq_id: str, ctx: List[int], start: int,
                    count: int) -> None:
        from ..models import llama

        d = self.device
        end = start + count
        positions = np.arange(start, end, dtype=np.int32)[None]
        write_idx = self.pool.write_slots(seq_id, start, count)[None]
        r_s, r_p, r_v = self.pool.read_slots(seq_id, end, end)
        llama.forward(
            self.params, self.mcfg,
            to_device(np.asarray(ctx[start:end], np.int64)[None], d),
            to_device(positions, d), self.k_pool, self.v_pool,
            to_device(write_idx.astype(np.int64), d),
            to_device(r_s[None].astype(np.int64), d),
            to_device(r_p[None], d), to_device(r_v[None], d),
            attn_impl="flash",
            logits_idx=to_device(np.asarray([count - 1], np.int64), d))
        self.sync_dispatches += 1

    def drop(self, seq_id: str) -> None:
        if seq_id in self.synced:
            self.synced.pop(seq_id, None)
            self.pool.release(seq_id)


def build_proposer(sc: SpecConfig, cfg, device=None):
    if sc.mode == "draft":
        return DraftModelProposer(sc, cfg, device)
    return NgramProposer(sc)
