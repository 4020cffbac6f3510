"""Attention kernels of the serving engine: CUDA on the card, plain torch on
the CPU.

Two kernels cover the two hot paths, each with a hand-written CUDA C++
kernel for Hopper (``csrc/*.cu``, built by :mod:`._build`) and a plain
PyTorch version of the same function beside it:

- :func:`flash_attention` — blockwise online-softmax attention for prefill
  chunks, with explicit positions and validity so it drops into the engine's
  paged write-then-gather scheme: the [T,S] score matrix never reaches device
  memory.
- :func:`paged_attention` — decode attention that reads KV pages straight
  from the pool through a page table, with no gather into a contiguous
  context.

A wrapper runs the plain version only for tensors on the CPU. A CUDA tensor
always goes to the kernel; a kernel that fails to build or launch raises.
Each wrapper counts its kernel launches in ``<wrapper>.launches``, so a run
can show that the main path went through the kernel, and by head dim in
``<wrapper>.launches_by_head_dim``, so a run that serves two models (a target
and its speculative draft) reads each one's launches apart.

Reference capability: the CUDA paged/flash attention vLLM supplies behind the
reference's engine adapters (SURVEY §2.1 engine rows).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import _build

NEG_INF = -1e30

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_FLASH_ARGS = [_P] * 7 + [_I] * 6 + [_I64] * 9 + [_F, _F, _I, _P]
_PAGED_ARGS = [_P] * 7 + [_I] * 9 + [_F, _F, _I, _P]
KERNEL_HEAD_DIMS = (16, 64, 128, 256)
KERNEL_DTYPE = torch.bfloat16
# the paged kernel's grid aims at this many blocks an SM; about half of them
# exit at once when lanes are shorter than the table
PAGED_BLOCKS_PER_SM = 4


def _masked_softmax_av(s: torch.Tensor, mask: torch.Tensor,
                       v: torch.Tensor, eq: str
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unnormalised (p @ v, sum p) of a softmax over the last axis, with
    masked slots at p = 0, so a fully masked row sums to 0 (the kernels'
    finite-sentinel semantics)."""
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum(eq, p, v)
    return o, l


def check_kernel_support(head_dim: int, dtype: torch.dtype) -> None:
    """Raise ValueError unless both CUDA kernels have an instance for this
    head dim and dtype (the engine checks a model's once, at construction)."""
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {head_dim} has no CUDA attention kernel "
                         f"(kernels: {KERNEL_HEAD_DIMS})")
    if dtype != KERNEL_DTYPE:
        raise ValueError(f"dtype {dtype} has no CUDA attention kernel "
                         f"(kernels: {KERNEL_DTYPE})")


def _check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
                device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")


def _check_rows(name: str, t: torch.Tensor) -> None:
    """16-byte loads: contiguous head dim, 8-element aligned strides and a
    16-byte aligned base."""
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1]) \
            or t.data_ptr() % 16:
        raise ValueError(f"{name} needs a contiguous, 16-byte aligned head "
                         f"dim (strides {t.stride()})")


# ---------------------------------------------------------------------------
# Flash attention (prefill over gathered context)
# ---------------------------------------------------------------------------

def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          q_pos: torch.Tensor, k_pos: torch.Tensor,
                          k_valid: torch.Tensor,
                          scale: Optional[float] = None,
                          softcap: Optional[float] = None,
                          window: Optional[int] = None) -> torch.Tensor:
    """Dense torch version of :func:`flash_attention` (f32 softmax)."""
    B, T, Hq, Dh = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    qg = q.reshape(B, T, Hkv, G, Dh).float()
    s = torch.einsum("bthgd,bshd->bhgts", qg, k.float()) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    mask = k_valid[:, None, :] & (k_pos[:, None, :] <= q_pos[:, :, None])
    if window is not None:
        mask = mask & (k_pos[:, None, :] > q_pos[:, :, None] - window)
    o, l = _masked_softmax_av(s, mask[:, None, None], v.float(),
                              "bhgts,bshd->bhgtd")
    o = o / torch.where(l == 0, torch.ones_like(l), l)
    return o.permute(0, 3, 1, 2, 4).reshape(B, T, Hq, Dh).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, k_pos: torch.Tensor,
                    k_valid: torch.Tensor,
                    scale: Optional[float] = None,
                    softcap: Optional[float] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Blockwise attention with explicit positions.

    q: [B, T, Hq, Dh] ; k, v: [B, S, Hkv, Dh] (gathered context, GQA; any
    strides with a contiguous head dim) ; q_pos: [B, T] int32 ; k_pos:
    [B, S] int32 ; k_valid: [B, S] bool. A query at position p attends to
    context slots with k_pos <= p & valid; with ``window`` additionally
    k_pos > p - window (sliding layers). ``softcap`` tanh-caps scores before
    the softmax; ``scale`` overrides the rsqrt(Dh) default. Returns
    [B, T, Hq, Dh] in q.dtype; a row with nothing to attend to is 0.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_pos, k_pos, k_valid,
                                     scale=scale, softcap=softcap,
                                     window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, T, Hq, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if k.shape != (B, S, Hkv, Dh) or v.shape != k.shape or Hq % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} / k "
                         f"{tuple(k.shape)} / v {tuple(v.shape)} mismatch")
    if Dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {Dh} not in "
                         f"{KERNEL_HEAD_DIMS}")
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_cuda(name, t, KERNEL_DTYPE, dev)
        _check_rows(name, t)
    for name, t, shape, dtype in (("q_pos", q_pos, (B, T), torch.int32),
                                  ("k_pos", k_pos, (B, S), torch.int32),
                                  ("k_valid", k_valid, (B, S), torch.bool)):
        _check_cuda(name, t, dtype, dev)
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous "
                             f"{shape}, got {tuple(t.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    out = torch.empty((B, T, Hq, Dh), dtype=q.dtype, device=dev)
    fn = _build.kernel("flash_attention", "dtt_flash_attention", _FLASH_ARGS)
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
                 k_pos.data_ptr(), k_valid.data_ptr(), out.data_ptr(),
                 B, T, S, Hq, Hkv, Dh,
                 q.stride(0), q.stride(1), q.stride(2),
                 k.stride(0), k.stride(1), k.stride(2),
                 v.stride(0), v.stride(1), v.stride(2),
                 float(scale), float(softcap or 0.0), int(window or 0),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed "
                           f"(cudaError {err})")
    flash_attention.launches += 1
    flash_attention.launches_by_head_dim[Dh] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_head_dim = collections.Counter()


# ---------------------------------------------------------------------------
# Paged attention (decode directly over the page pool)
# ---------------------------------------------------------------------------

def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, page_tables: torch.Tensor,
                          lengths: torch.Tensor,
                          scale: Optional[float] = None,
                          softcap: Optional[float] = None,
                          window: Optional[int] = None) -> torch.Tensor:
    """Dense torch version of :func:`paged_attention`: gathers every
    table page, then masks by token index."""
    B, Hq, Dh = q.shape
    Hkv, _, page, _ = k_pages.shape
    G = Hq // Hkv
    P = page_tables.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    lengths = lengths.clamp(min=1)
    # [Hkv, B, P, page, Dh] -> [B, Hkv, P*page, Dh]
    k = k_pages[:, page_tables].permute(1, 0, 2, 3, 4).reshape(
        B, Hkv, P * page, Dh)
    v = v_pages[:, page_tables].permute(1, 0, 2, 3, 4).reshape(
        B, Hkv, P * page, Dh)
    s = torch.einsum("bhgd,bhsd->bhgs", q.reshape(B, Hkv, G, Dh).float(),
                     k.float()) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    t = torch.arange(P * page, device=q.device)
    mask = t[None] < lengths[:, None]
    if window is not None:
        mask = mask & (t[None] >= lengths[:, None] - window)
    o, l = _masked_softmax_av(s, mask[:, None, None], v.float(),
                              "bhgs,bhsd->bhgd")
    o = o / torch.where(l == 0, torch.ones_like(l), l)
    return o.reshape(B, Hq, Dh).to(q.dtype)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_tables: torch.Tensor,
                    lengths: torch.Tensor,
                    scale: Optional[float] = None,
                    softcap: Optional[float] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Decode attention straight over the paged KV pool.

    q: [B, Hq, Dh] (one new token per sequence, already rope'd)
    k_pages, v_pages: [Hkv, n_pages, page, Dh] — one layer of the pool
    page_tables: [B, P] int32 page ids (rows padded with page 0)
    lengths: [B] int32 — tokens to attend per sequence (including current),
    clamped to >= 1. Sequences attend to tokens [0, length); with ``window``
    only [max(0, length - window), length), and the kernel never touches
    pages below the window. ``softcap`` tanh-caps scores pre-softmax;
    ``scale`` overrides rsqrt(Dh). Returns [B, Hq, Dh].

    On the card the context is split over blocks (:func:`paged_split_plan`)
    and the splits' partials merge in a fixed order in a second kernel, so
    the output is bitwise the same from run to run.
    """
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, page_tables,
                                     lengths, scale=scale, softcap=softcap,
                                     window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    B, Hq, Dh = q.shape
    Hkv, n_pages, page, _ = k_pages.shape
    P = page_tables.shape[1]
    if k_pages.shape != (Hkv, n_pages, page, Dh) \
            or v_pages.shape != k_pages.shape or Hq % Hkv:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} / pools "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)} "
                         f"mismatch")
    if Dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"paged_attention: head dim {Dh} not in "
                         f"{KERNEL_HEAD_DIMS}")
    if P * page == 0:
        raise ValueError("paged_attention: the page table holds no tokens")
    dev = q.device
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        _check_cuda(name, t, KERNEL_DTYPE, dev)
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
        _check_rows(name, t)
    for name, t, shape in (("page_tables", page_tables, (B, P)),
                           ("lengths", lengths, (B,))):
        _check_cuda(name, t, torch.int32, dev)
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be a contiguous "
                             f"{shape}, got {tuple(t.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    split, nsplit = paged_split_plan(B, Hq, Hkv, Dh, P, page,
                                     _sm_count(dev.index))
    out = torch.empty((B, Hq, Dh), dtype=q.dtype, device=dev)
    # per split: acc [Dh] and (m, l), f32; none with one split
    ws = (torch.empty(B * Hq * nsplit * (Dh + 2), dtype=torch.float32,
                      device=dev) if nsplit > 1 else None)
    fn = _build.kernel("paged_attention", "dtt_paged_attention", _PAGED_ARGS)
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 page_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 None if ws is None else ws.data_ptr(),
                 B, Hq, Hkv, Dh, n_pages, page, P, split, nsplit,
                 float(scale), float(softcap or 0.0), int(window or 0),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed "
                           f"(cudaError {err})")
    paged_attention.launches += 1
    paged_attention.launches_by_head_dim[Dh] += 1
    return out


paged_attention.launches = 0
paged_attention.launches_by_head_dim = collections.Counter()


@functools.lru_cache(maxsize=None)
def _sm_count(index: Optional[int]) -> int:
    return torch.cuda.get_device_properties(index or 0).multi_processor_count


@functools.lru_cache(maxsize=None)
def _paged_granule(Dh: int) -> int:
    return _build.kernel("paged_attention", "dtt_paged_granule",
                         [ctypes.c_int])(Dh)


@functools.lru_cache(maxsize=None)
def paged_split_plan(B: int, Hq: int, Hkv: int, Dh: int, P: int, page: int,
                     n_sm: int, granule: Optional[int] = None,
                     blocks_per_sm: int = PAGED_BLOCKS_PER_SM
                     ) -> Tuple[int, int]:
    """(split, nsplit): the paged kernel's tokens per split and its number
    of splits, from host-known shapes only (never from ``lengths``, which
    live on the device), so the launch adds no host sync. The grid
    (nsplit, Hkv x head chunks, B) aims at ``blocks_per_sm`` blocks an SM;
    a split is a whole number of the kernel's block rounds
    (``granule`` tokens, from the built kernel unless given) and the splits
    cover the table's ``P * page`` tokens."""
    if granule is None:
        granule = _paged_granule(Dh)
    G = Hq // Hkv
    chunks = -(-G // 16)          # a block holds up to 16 query heads
    ctx = P * page
    want = -(-blocks_per_sm * n_sm // (B * Hkv * chunks))
    nsplit = max(1, min(want, -(-ctx // granule)))
    split = -(-(-(-ctx // nsplit)) // granule) * granule
    return split, -(-ctx // split)
