"""The segmented forward of the paged (working-set-bounded) lane.

The dense engine runs attention as ONE pass over the whole context, so
every KV page must be on the card when it runs. These functions split
each layer's attention into *partial* passes with online-softmax
accumulators (the flash-attention recurrence, applied across passes
instead of across kernel tiles):

- :meth:`PagedPrograms.attn_hot` attends over the resident tail, read
  through the pool (causally masked, window-masked on sliding layers);
- :meth:`PagedPrograms.attn_cold` attends over one staged segment of
  demoted blocks per lane, uploaded into a shared ``[2, B, ...]`` staging
  slot (every cold position precedes every query, so causality is free;
  sliding layers also window-mask against each lane's segment positions)
  and merges it into the running accumulators;
- :meth:`PagedPrograms.layer_out` normalizes the merged accumulators and
  finishes the layer (o-proj, residual, FFN).

Between partial passes only the chunk's activations and the f32
``(o, m, d)`` accumulators persist on the card, so the cold tail streams
through a fixed pair of staging slots whatever the context length.
Softmax reassociation is the only difference from the dense path: the
accumulation is f32 throughout. Batching is exact: masked and padded
positions add exactly ``0.0`` to the f32 sums and sampling is
row-independent, so each lane's tokens do not depend on its lanemates.

These are plain tensor functions (the JAX package jits one program per
layer class; here the window span and the rope table are chosen per
layer at call time). ``NEG_INF`` is finite: :func:`_merge` relies on
``exp(m0 - m) == 1`` for two all-masked partials, which ``-inf`` would
make NaN.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ...models import llama
from ...models.llama import NEG_INF


def _merge(o0, m0, d0, o1, m1, d1):
    """Online-softmax merge of two partial-attention accumulators.
    Shapes: o [B, Hkv, G, T, Dh] f32; m, d [B, Hkv, G, T] f32."""
    m = torch.maximum(m0, m1)
    a0 = torch.exp(m0 - m)
    a1 = torch.exp(m1 - m)
    return o0 * a0[..., None] + o1 * a1[..., None], m, d0 * a0 + d1 * a1


def _partial_attend(cfg, q, k, v, mask):
    """Unnormalized attention stats for one KV span.

    q: [B, T, Hq, Dh]; k, v: [B, S, Hkv, Dh]; mask: [B, T, S] bool.
    Returns (o [B,Hkv,G,T,Dh], m [B,Hkv,G,T], d [B,Hkv,G,T]), all f32.
    Scores as :func:`llama.attend` makes them (scale, then softcap, then
    mask). Rows whose mask is all False give (0, NEG_INF, 0): an exact
    no-op under :func:`_merge`, which is what makes padded lanes free."""
    T = q.shape[1]
    return _attend_heads(cfg, _q_heads(cfg, q), k.permute(0, 2, 1, 3),
                         v.permute(0, 2, 1, 3), ~mask[:, None, None], T)


def _q_heads(cfg, q):
    """q [B, T, Hq, Dh] -> head-major f32 [B, Hkv, G*T, Dh] (rows g, t)."""
    B, T, _, Dh = q.shape
    Hkv = cfg.num_kv_heads
    G = cfg.num_heads // Hkv
    return q.reshape(B, T, Hkv, G, Dh).permute(0, 2, 3, 1, 4).reshape(
        B, Hkv, G * T, Dh).float()


def _attend_heads(cfg, qh, kh, vh, off, T: int):
    """:func:`_partial_attend` on head-major operands: qh [B, Hkv, G*T, Dh]
    f32 (:func:`_q_heads`), kh/vh [B, Hkv, S, Dh], ``off`` True where a
    key is masked, broadcastable to [B, 1, 1, T, S]. Two matmuls and the
    softmax statistics in place on one f32 score buffer."""
    B, Hkv, GT, Dh = qh.shape
    G = GT // T
    S = kh.shape[2]
    scores = torch.matmul(qh, kh.float().transpose(-1, -2)).view(
        B, Hkv, G, T, S)
    scores.mul_(cfg.attn_scale)
    if cfg.attn_logit_softcap:
        cap = cfg.attn_logit_softcap
        scores.div_(cap).tanh_().mul_(cap)
    scores.masked_fill_(off, NEG_INF)
    m = scores.amax(dim=-1)                              # [B,Hkv,G,T]
    # exp(scores - m), masked to exactly 0 (all-masked rows included)
    p = scores.sub_(m[..., None]).exp_().masked_fill_(off, 0.0)
    d = p.sum(dim=-1)
    o = torch.matmul(p.view(B, Hkv, GT, S), vh.float()).view(
        B, Hkv, G, T, Dh)
    return o, m, d


class PagedPrograms:
    """The paged path's forward pieces for one engine. Every function
    takes a leading batch dim (1 for a prefill chunk, the lane count for a
    batched decode step). Layer classes (window span, local rope) follow
    the JAX package: :attr:`classes` lists them, :attr:`windows` gives
    each layer's span (None = full attention)."""

    def __init__(self, cfg):
        self.cfg = cfg
        m = cfg.model
        self.page = cfg.page_size
        classes: List[Tuple[Optional[int], bool]] = []
        layer_cls: List[int] = []
        for l in range(m.num_layers):
            if m.layer_sliding(l):
                key = (int(m.sliding_window),
                       m.rope_local_theta is not None)
            else:
                key = (None, False)
            if key not in classes:
                classes.append(key)
            layer_cls.append(classes.index(key))
        self.classes = classes
        self.windows: List[Optional[int]] = [classes[c][0]
                                             for c in layer_cls]
        self._iota: Dict[Any, torch.Tensor] = {}

    # ------------------------------------------------------------------
    def embed(self, params: Dict[str, Any], tokens: torch.Tensor):
        return llama._embed(params, self.cfg.model, tokens)

    def rope(self, positions: torch.Tensor):
        """The (global, local) rope tables of one forward's positions."""
        return llama._rope_all(self.cfg.model, positions)

    def qkv(self, params, l: int, x, rope, k_pool, v_pool, write_idx):
        """Layer ``l``'s q, head-major f32 [B, Hkv, G*T, Dh]
        (:func:`_q_heads`, once a layer for every partial pass), with its
        k/v written into the pools in place at ``write_idx`` [B, T] flat
        slots (padding -> scratch page 0). Torch applies the int ``l`` as
        a plain select, so ``[l, :, wp, wo]`` is [Hkv, B*T, Dh], not
        numpy's [B*T, Hkv, Dh]."""
        m = self.cfg.model
        q, k, v = llama._qkv(x, params["layers"], l, m, rope)
        B, T = write_idx.shape
        flat = write_idx.reshape(-1)
        wp, wo = flat // self.page, flat % self.page
        k_pool[l, :, wp, wo] = k.reshape(B * T, *k.shape[2:]).transpose(0, 1)
        v_pool[l, :, wp, wo] = v.reshape(B * T, *v.shape[2:]).transpose(0, 1)
        return _q_heads(m, q)

    def attn_hot(self, qh, l: int, k_pool, v_pool, read_idx, read_pos,
                 read_valid, positions):
        """Partial attention over each lane's resident slots ``read_idx``
        [B, S] (its own pages of the pool), causal and window-masked."""
        rp, ro = read_idx // self.page, read_idx % self.page
        # [Hkv, B, S, Dh] -> [B, Hkv, S, Dh]: each lane reads its own slots
        k_ctx = k_pool[l, :, rp, ro].transpose(0, 1)
        v_ctx = v_pool[l, :, rp, ro].transpose(0, 1)
        mask = (read_valid[:, None, :]
                & (read_pos[:, None, :] <= positions[:, :, None]))
        window = self.windows[l]
        if window is not None:
            # the dense path's sliding rule: keys strictly within the last
            # ``window`` positions of each query
            mask = mask & (read_pos[:, None, :]
                           > positions[:, :, None] - window)
        return _attend_heads(self.cfg.model, qh, k_ctx, v_ctx,
                             ~mask[:, None, None], positions.shape[1])

    def attn_cold(self, l: int, qh, positions, kv_seg, meta, o, m_, d):
        """Merge one staged cold segment per lane into the accumulators.

        ``kv_seg`` [2, B, Hkv, n, page, Dh] (k over v, head-major: one
        upload, and each head's keys are one contiguous run), ``meta``
        [B, 2] int = (valid blocks, first token position) per lane;
        validity and positions are rebuilt from those two numbers (a cold
        segment is a contiguous run of demoted blocks). A lane with no
        segment at this step rides along with meta (0, 0): all-invalid,
        an exact no-op under :func:`_merge`."""
        B, Hkv, n, page, Dh = kv_seg.shape[1:]
        S = n * page
        k_ctx = kv_seg[0].view(B, Hkv, S, Dh)
        v_ctx = kv_seg[1].view(B, Hkv, S, Dh)
        blk = self._blocks_of(S, page, qh.device)
        T = positions.shape[1]
        window = self.windows[l]
        if window is None:
            off = (blk[None, :] >= meta[:, 0:1])[:, None, None, None, :]
        else:
            # ops/attention.py's dense sliding rule `kp > qp - window`
            seg_pos = meta[:, 1:2] + self._blocks_of(S, 1, qh.device)
            keep = ((blk[None, :] < meta[:, 0:1])[:, None, :]
                    & (seg_pos[:, None, :] > positions[:, :, None] - window))
            off = ~keep[:, None, None]
        o1, m1, d1 = _attend_heads(self.cfg.model, qh, k_ctx, v_ctx, off, T)
        return _merge(o, m_, d, o1, m1, d1)

    def _blocks_of(self, S: int, page: int, device):
        """The block index of each of a segment's S key slots (cached)."""
        key = (S, page, device)
        got = self._iota.get(key)
        if got is None:
            got = self._iota[key] = torch.arange(S, device=device) // page
        return got

    def layer_out(self, params, l: int, x, o, m_, d):
        """Normalize the merged accumulators, then o-proj, residual, FFN."""
        m = self.cfg.model
        lp = params["layers"]
        B, Hkv, G, T, Dh = o.shape
        attn = o / torch.where(d == 0.0, torch.ones_like(d), d)[..., None]
        attn = attn.permute(0, 3, 1, 2, 4).reshape(
            B, T, Hkv * G, Dh).to(x.dtype)
        x = llama._attn_out(x, attn, lp, l, m)
        return llama._ffn_block(x, lp, l, m)

    def head(self, params, x, last_i, temp, top_p, top_k, uniforms, counts,
             freq_pen, pres_pen, active):
        """Sample one token per row at ``x[b, last_i[b]]``: (packed [B, 2]
        f32 = (token, logprob), tokens [B] int64). Penalty ``counts`` [B, V]
        (a view of the lane-persistent rows) gain the sampled token only
        on ``active`` rows, so a padded row counts nothing (its uniform is
        0: it drew nothing either). Token ids < 2^24 are exact in f32."""
        from ...engine.sampling import apply_penalties, sample

        B = x.shape[0]
        rows = torch.arange(B, device=x.device)
        xs = x[rows, last_i][:, None]
        logits = llama._lm_head(xs, params, self.cfg.model)[:, 0]
        lg = apply_penalties(logits, counts, freq_pen, pres_pen)
        tok, logp = sample(lg, temp, top_p, top_k, uniforms)
        counts[rows, tok] += active.to(counts.dtype)
        return torch.stack([tok.float(), logp], -1), tok

    # ------------------------------------------------------------------
    @staticmethod
    def validate(cfg) -> Optional[str]:
        """Why this engine config cannot run the paged path (None = ok).
        Sliding-window and dual-base-rope models are servable; MoE and
        image models stay on the dense path."""
        m = cfg.model
        if m.num_experts:
            return "MoE models"
        if m.vision is not None:
            return "VLM deployments (image spans need the dense path)"
        return None
