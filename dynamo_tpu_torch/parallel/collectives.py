"""The collectives tensor parallelism needs, written out where GSPMD
inserts them for the JAX package: the sum of the row-parallel products'
partial sums over tp, the gather of a vocab-sharded head's logits, and a
broadcast from the leader.

Each runs on three backends: ``gloo`` with CPU tensors, ``gloo`` with
CUDA tensors (ranks sharing one card) and ``nccl``. gloo gives CUDA
tensors ``all_reduce`` and ``broadcast`` but no ``all_gather``, so the
gather is an ``all_reduce`` into a zeroed buffer that each rank fills
with its own columns: every other rank adds exact zeros, so the result
is the shards' bytes, the same on every rank, at the cost of moving the
whole row instead of one shard of it.

KV moves between the ranks and the leader's host tiers through host
collectives over the mesh's gloo ``host_group`` (NCCL has none for host
tensors): :func:`gather_heads` assembles each rank's kv heads of a host
array into the whole array on the leader, and :func:`scatter_heads` gives
each rank its heads of the leader's whole array. Both move raw bytes, so a
bf16 array's ``uint16`` bits arrive as they left.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum the contiguous ``x`` over the group, in place, in its dtype
    (Megatron's reduction of the partial products: each caller passes a
    fresh product that nothing else holds)."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """Concatenate each rank's ``x`` [..., n] along the last axis in rank
    order -> [..., n * world], on every rank."""
    n, r = x.shape[-1], group.rank()
    out = x.new_zeros((*x.shape[:-1], n * group.size()))
    out[..., r * n:(r + 1) * n] = x
    return all_reduce_(out, group)


def broadcast(x: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """``x`` as rank ``src`` (a rank of the group) holds it, on every rank,
    in place."""
    dist.broadcast(x, group_src=src, group=group)
    return x


def _raw(a: np.ndarray) -> torch.Tensor:
    """A contiguous host array's bytes as a flat uint8 tensor sharing its
    memory."""
    return torch.from_numpy(np.ascontiguousarray(a).reshape(-1)
                            .view(np.uint8))


def gather_heads(x: np.ndarray, group, heads: Sequence[range],
                 axis: int = 2, dst: int = 0) -> Optional[np.ndarray]:
    """Rank ``dst``'s whole array of every rank's ``x``, whose ``axis``
    holds the kv heads ``heads[rank]`` (the same count on every rank):
    each kv head is taken once, from the first rank that holds it, so a
    head that ranks replicate (Hkv < tp) is not repeated. None on the
    other ranks."""
    x = np.ascontiguousarray(x)
    mine = _raw(x)
    parts = ([torch.empty_like(mine) for _ in heads]
             if group.rank() == dst else None)
    dist.gather(mine, parts, group=group, group_dst=dst)
    if parts is None:
        return None
    shape = list(x.shape)
    shape[axis] = max(r.stop for r in heads)
    whole = np.empty(shape, x.dtype)
    done = 0
    for r, raw in zip(heads, parts):
        lo = max(r.start, done)
        if lo < r.stop:
            part = raw.numpy().view(x.dtype).reshape(x.shape)
            dst_idx = [slice(None)] * x.ndim
            src_idx = [slice(None)] * x.ndim
            dst_idx[axis] = slice(lo, r.stop)
            src_idx[axis] = slice(lo - r.start, None)
            whole[tuple(dst_idx)] = part[tuple(src_idx)]
            done = r.stop
    return whole


def scatter_heads(whole: Optional[np.ndarray], group, heads: Sequence[range],
                  shape: Tuple[int, ...], dtype, axis: int = 2,
                  src: int = 0, out: Optional[np.ndarray] = None
                  ) -> np.ndarray:
    """This rank's kv heads ``heads[rank]`` on ``axis`` of rank ``src``'s
    ``whole`` array (``whole`` is read on ``src`` only): a host array of
    ``shape`` and ``dtype``, written into ``out`` (contiguous) when
    given."""
    if out is None:
        out = np.empty(shape, dtype)
    parts = None
    if group.rank() == src:
        parts = []
        for r in heads:
            idx = [slice(None)] * whole.ndim
            idx[axis] = slice(r.start, r.stop)
            parts.append(_raw(whole[tuple(idx)]))
    dist.scatter(_raw(out), parts, group=group, group_src=src)
    return out
