"""Rank layout and the axis conventions of the serving engine.

The axis names are the JAX package's (``parallel/mesh.py``):

- ``dp``  — data parallel (worker replication, not an in-engine axis)
- ``tp``  — tensor parallel: attention heads, the FFN dim and an untied
  head's vocab
- ``sp``  — sequence parallel (ring attention)
- ``ep``  — expert parallel (MoE layers)
- ``pp``  — pipeline stages

The JAX package is single-controller within a host: one process drives
every device of a ``Mesh`` and GSPMD inserts the collectives. PyTorch has
no such controller, so here every rank is a process of its own, with one
device and explicit collectives (:mod:`.collectives`) over a
``torch.distributed`` group; rank 0 leads and the others replay its
dispatches (:mod:`.multihost`). :func:`serving_mesh` describes one rank:
its coordinates, its group for each live axis and its device. Only tp is
ported; the other axes wait for ROADMAP Queue 1 item 11b. With tp the only
live axis the world group is the tp group, so no ``init_device_mesh`` is
built: it would put rank r on card r mod the host's count, where ranks
here may list their cards and share one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

AXIS_DP = "dp"
AXIS_TP = "tp"
AXIS_SP = "sp"
AXIS_EP = "ep"
AXIS_PP = "pp"

#: why an axis other than tp above 1 is refused
OTHER_AXES_GAP = ("pp, sp and ep are not ported to dynamo_tpu_torch yet "
                  "(ROADMAP Queue 1 item 11b)")


@dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.tp * self.sp * self.ep * self.pp


@dataclass
class ServingMesh:
    """One rank's view of the engine's ranks. ``groups`` maps each live
    axis above 1 to its ``torch.distributed`` group; ``host_group`` is the
    tp ranks' group for host tensors (the KV moves between the ranks and
    the leader's tiers): the tp group itself under gloo, a gloo group of
    the same ranks under NCCL."""
    shape: Dict[str, int]
    rank: int
    local_rank: int
    device: torch.device
    groups: Dict[str, Any]
    backend: Optional[str] = None
    host_group: Any = None

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def tp(self) -> int:
        return self.shape.get(AXIS_TP, 1)

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    @property
    def tp_group(self):
        return self.groups.get(AXIS_TP)


def rank_device(device: str, local_rank: int,
                devices: Optional[Sequence[int]] = None) -> torch.device:
    """The device of local rank ``local_rank``: the CPU for ``cpu``, else
    ``cuda:{devices[local_rank]}`` when the caller lists the devices (the
    list may repeat a card: ranks then share it), else
    ``cuda:{local_rank}``. More ranks than cards without such a list
    raises."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}")
    if devices is not None:
        if local_rank >= len(devices):
            raise ValueError(f"local rank {local_rank} has no entry in the "
                             f"device list {list(devices)}")
        index = int(devices[local_rank])
    else:
        index = local_rank
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"rank {local_rank} wants a CUDA device but "
            f"torch.cuda.is_available() is False; pass device='cpu' to run "
            f"the ranks on the CPU")
    count = torch.cuda.device_count()
    if index >= count:
        raise ValueError(
            f"local rank {local_rank} needs cuda:{index} but this host has "
            f"{count} CUDA device(s); list the devices the ranks share "
            f"(e.g. devices 0,0 puts two ranks on one card)")
    return torch.device("cuda", index)


def serving_mesh(tp: int = 1, sp: int = 1, ep: int = 1, pp: int = 1, *,
                 rank: int = 0, local_rank: Optional[int] = None,
                 device: str = "cuda",
                 devices: Optional[Sequence[int]] = None,
                 group: Any = None) -> ServingMesh:
    """This rank's mesh: tp ranks, one process each. ``group`` is the tp
    group (default: the initialised ``torch.distributed`` world, which
    must hold exactly the tp ranks); ``local_rank`` (default ``rank``)
    picks the device as :func:`rank_device` does, and a CUDA device becomes
    the process's current one. Axes other than tp above 1 raise."""
    if sp > 1 or ep > 1 or pp > 1:
        raise NotImplementedError(
            f"serving mesh sp={sp} ep={ep} pp={pp}: {OTHER_AXES_GAP}")
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} outside tp={tp}")
    local = rank if local_rank is None else local_rank
    dev = rank_device(device, local, devices)
    if dev.type == "cuda":
        # what acts on the current device (the allocator's cache, an
        # event's record) must act on this rank's card, not cuda:0
        torch.cuda.set_device(dev)
    groups: Dict[str, Any] = {}
    backend = None
    if tp > 1:
        import torch.distributed as dist

        if group is None:
            if not dist.is_initialized():
                raise RuntimeError(
                    "tp > 1 needs torch.distributed initialised first "
                    "(parallel.multihost.init_distributed)")
            if dist.get_world_size() != tp:
                raise ValueError(f"world of {dist.get_world_size()} ranks "
                                 f"for tp={tp}")
            group = dist.group.WORLD
        groups[AXIS_TP] = group
        backend = str(dist.get_backend(group)) if dist.is_initialized() \
            else None
        if (backend == "nccl" and devices is not None
                and len(set(devices)) < len(devices)):
            raise ValueError(
                "NCCL refuses two ranks on one GPU; share a card over the "
                "gloo backend instead")
        # NCCL moves no host tensors: the same ranks again, over gloo
        host = (dist.new_group(backend="gloo") if backend == "nccl"
                else group)
    else:
        host = None
    return ServingMesh(shape={AXIS_TP: tp}, rank=rank, local_rank=local,
                       device=dev, groups=groups, backend=backend,
                       host_group=host)


def shard_divisible(n: int, mesh: ServingMesh, axis: str) -> bool:
    """Can dimension ``n`` be sharded over mesh axis ``axis``?"""
    if axis not in mesh.axis_names:
        return False
    return n % mesh.shape[axis] == 0
