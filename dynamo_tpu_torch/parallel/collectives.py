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
"""

from __future__ import annotations

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
