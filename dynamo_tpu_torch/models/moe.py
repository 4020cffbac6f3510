"""Mixture-of-Experts FFN in PyTorch (the JAX package's ``models/moe.py``).

Mixtral-style block: a router picks ``top_k`` of ``E`` experts per token;
each expert is a SwiGLU FFN; outputs combine weighted by renormalized
router probabilities. Two exact formulations (no capacity limit, no
dropped tokens), chosen by the JAX package's policy, except that a
one-token step is always dense:

- SORTED dispatch when ``T > 1`` and ``B*T >= 16`` (prefill chunks, and
  speculative verify rounds, which fetch anyway): the (token, k)
  assignments stable-sorted by expert, each expert's contiguous segment
  through ``torch.matmul`` (where JAX has ``lax.ragged_dot``), the weighted
  outputs scatter-added in f32. K-per-token FFN cost. The segment bounds
  are one host read of the E counts per MoE layer and dispatch.
- DENSE dispatch otherwise (every decode step, at any batch): every
  expert sees every token and the one-hot gates zero the unrouted ones.
  E-per-token FFN cost, and no host sync, so a chained decode enqueue
  stays sync-free. JAX keys on ``B*T`` alone because its ``ragged_dot``
  reads no counts on the host; here a decode batch of 16 lanes would
  sync once a layer. At decode batches top-2 of 8 routes to nearly every
  expert anyway, so dense reads the same weights.

Expert parallelism (the JAX package's ``ep`` mesh axis) is not ported.

Reference capability: the reference inherits MoE from its engines (SURVEY
§2.5); on the card the in-tree engine owns it.
"""

from __future__ import annotations

import collections
from typing import Tuple

import torch
import torch.nn.functional as F

#: ``B*T`` at and above which :func:`moe_ffn` takes sorted dispatch
#: (when ``T > 1``)
SORTED_MIN_TOKENS = 16


def _sorted_dispatch(x: torch.Tensor,            # [B, T, D]
                     wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
                     vals: torch.Tensor,          # [B, T, K] renormalized
                     idx: torch.Tensor            # [B, T, K] expert ids
                     ) -> torch.Tensor:
    """Exact sorted dispatch: flatten the (token, k) assignments,
    stable-sort them by expert, run each expert's contiguous segment
    through its FFN, scatter-add the weighted outputs back (f32)."""
    B, T, D = x.shape
    E = wg.shape[0]
    K = idx.shape[-1]
    N = B * T
    xf = x.reshape(N, D)
    flat_e = idx.reshape(N * K)
    flat_g = vals.reshape(N * K)
    order = torch.argsort(flat_e, stable=True)             # [N*K]
    tok = order // K                                       # source token
    xs = xf[tok]                                           # [N*K, D]
    # the one host read of this layer: E segment sizes (a grouped GEMM
    # over device-side counts would drop it; ROADMAP Speed work)
    # dynalint: ok(host-sync) the MoE layer's one host read, E segment sizes
    # (bincount reads the max too); a grouped GEMM over device-side counts
    # would drop it
    counts = torch.bincount(flat_e, minlength=E).tolist()
    y = torch.empty((N * K, D), dtype=x.dtype, device=x.device)
    lo = 0
    for e, n in enumerate(counts):
        if n:
            seg = xs[lo:lo + n]
            g = seg @ wg[e]
            u = seg @ wu[e]
            a = (F.silu(g.float()) * u.float()).to(x.dtype)
            y[lo:lo + n] = a @ wd[e]
            lo += n
    yw = y.float() * flat_g[order][:, None]
    out = torch.zeros((N, D), dtype=torch.float32, device=x.device)
    out.index_add_(0, tok, yw)
    return out.reshape(B, T, D).to(x.dtype)


def route_topk(x: torch.Tensor, wr: torch.Tensor,
               top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Router: renormalized top-k gate values (f32) and expert ids
    ([B, T, K] each)."""
    logits = torch.einsum("btd,de->bte", x, wr.to(x.dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    vals, idx = torch.topk(probs, top_k, dim=-1)           # [B, T, K]
    return vals / vals.sum(dim=-1, keepdim=True), idx


def dense_gates(vals: torch.Tensor, idx: torch.Tensor,
                n_experts: int) -> torch.Tensor:
    """One-hot gate matrix [B, T, E] (f32) for dense dispatch; a scatter,
    so no host sync (``F.one_hot`` checks its indices on the host)."""
    gates = torch.zeros((*idx.shape[:-1], n_experts), dtype=torch.float32,
                        device=idx.device)
    return gates.scatter_add_(-1, idx, vals.float())


def expert_ffn(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
               wd: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """Dense-dispatch expert compute: wg/wu [E, D, F], wd [E, F, D],
    gates [B, T, E] -> [B, T, D]. Batched over the expert axis, so every
    weight is read in place (an einsum over ``edf`` would first copy each
    stack into ``[D, E*F]``)."""
    B, T, D = x.shape
    xf = x.reshape(1, B * T, D)
    g = torch.matmul(xf, wg)                               # [E, BT, F]
    u = torch.matmul(xf, wu)
    y = torch.matmul(F.silu(g) * u, wd)                    # [E, BT, D]
    out = torch.einsum("enD,ne->nD", y, gates.reshape(B * T, -1).to(x.dtype))
    return out.reshape(B, T, D)


def moe_ffn(x: torch.Tensor,           # [B, T, D]
            wr: torch.Tensor,          # [D, E] router
            wg: torch.Tensor,          # [E, D, F] expert gate projections
            wu: torch.Tensor,          # [E, D, F] expert up projections
            wd: torch.Tensor,          # [E, F, D] expert down projections
            top_k: int) -> torch.Tensor:
    """Routed MoE feed-forward. Returns [B, T, D] in x.dtype. Counts each
    call's formulation in ``moe_ffn.dispatches`` ("sorted" / "dense")."""
    E = wr.shape[1]
    vals, idx = route_topk(x, wr, top_k)
    B, T, _ = x.shape
    if T > 1 and B * T >= SORTED_MIN_TOKENS:
        moe_ffn.dispatches["sorted"] += 1
        return _sorted_dispatch(x, wg, wu, wd, vals, idx)
    moe_ffn.dispatches["dense"] += 1
    return expert_ffn(x, wg, wu, wd, dense_gates(vals, idx, E))


moe_ffn.dispatches = collections.Counter()
