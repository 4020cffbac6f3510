"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Union

import numpy as np
import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The torch device an entry point runs on: ``cuda`` unless the caller
    asks for the CPU. Asking for CUDA where torch sees no card raises; the
    port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev


def to_device(x: Union[np.ndarray, torch.Tensor],
              device: torch.device) -> torch.Tensor:
    """A host array or tensor on ``device`` without a host sync. To a card
    it goes through pinned memory with ``non_blocking=True``: a copy from
    pageable memory waits for the stream to drain, which would hold a
    chained decode dispatch's setup behind the dispatch before it. The
    pinned block comes from torch's caching host allocator, which records
    the copy on it and reuses it only after the copy completed, so the
    source need not outlive this call."""
    t = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
