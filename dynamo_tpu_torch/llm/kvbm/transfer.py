"""Page copies between the device KV pool and host memory.

Pools are [L, Hkv, n_pages, page, Dh]; host blocks are [n, L, Hkv, page,
Dh] numpy arrays, byte-compatible with the JAX package's (a bf16 pool's
blocks as raw ``uint16`` bits, see :func:`host_dtype`). Gathers and scatters
are torch indexing on the page axis (``index_select`` / ``index_copy_``);
on a card the bytes cross the bus through pinned host buffers.

Ordering on a card, where the JAX package relies on data dependencies:
- ``d2h_pages`` enqueues its gather and copy on the current (compute)
  stream. The engine calls it right before the dispatch that may overwrite
  an evicted page, so that dispatch is ordered after the copy; the pinned
  buffer is handed back only after the copy's event has completed.
- ``h2d_pages`` and ``scatter_blocks`` enqueue on the current stream, so
  the prefill that reads the restored pages is ordered after them. A pinned
  source (``host_blocks``) stays referenced until its copy's event has
  completed.
Pools are updated in place (the JAX package returns new, donated arrays).

Reference capability: block_copy.cu + CopyStream layer triggering
(lib/llm/src/kernels/block_copy.cu:25-80, lib/llm/src/kv/layer.rs:619-1132).
"""

from __future__ import annotations

import time
from typing import List, Sequence, Tuple

import numpy as np
import torch


def host_dtype(dtype: torch.dtype) -> np.dtype:
    """numpy dtype of a host block for a pool of ``dtype``: ``uint16`` raw
    bits for bf16 (numpy has no bfloat16), the same type otherwise."""
    if dtype == torch.bfloat16:
        return np.dtype(np.uint16)
    return torch.empty((), dtype=dtype).numpy().dtype


def to_host_array(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as a numpy array of :func:`host_dtype` (shares memory)."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.uint16)
    return t.numpy()


def from_host_array(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A host block array as a CPU tensor of the pool's ``dtype`` (shares
    memory; a ``uint16`` array is reinterpreted, never converted)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype == torch.bfloat16:
        if t.dtype != torch.uint16:
            raise TypeError(f"bf16 host blocks are uint16 bits, got {a.dtype}")
        return t.view(torch.bfloat16)
    if t.dtype != dtype:
        raise TypeError(f"host blocks are {a.dtype}, the pool is {dtype}")
    return t


class CopyStream:
    """Page gather/scatter between device pools and host blocks, with byte
    and host-clock second counters per direction (each copy ends when its
    data is usable: d2h after the event, h2d once enqueued)."""

    def __init__(self):
        self._inflight: List[Tuple[torch.cuda.Event, list]] = []
        self._param_stream = None       # h2d_param_slab's side stream
        self.d2h_bytes = 0
        self.d2h_seconds = 0.0
        self.h2d_bytes = 0
        self.h2d_seconds = 0.0

    def _retire(self) -> None:
        """Drop staged sources whose copies have completed."""
        self._inflight = [(ev, keep) for ev, keep in self._inflight
                          if not ev.query()]

    def _keep_until_done(self, keep: list) -> None:
        ev = torch.cuda.Event()
        ev.record()
        self._inflight.append((ev, keep))

    @staticmethod
    def host_blocks(n: int, block_shape: Sequence[int], dtype: torch.dtype,
                    pinned: bool) -> Tuple[np.ndarray, np.ndarray]:
        """Empty (k, v) host block arrays [n, *block_shape] of
        :func:`host_dtype`, in pinned memory when ``pinned``: a restore
        fills them straight from the tier and ``h2d_pages`` then uploads
        them with no staging copy."""
        out = []
        for _ in range(2):
            t = torch.empty((n, *block_shape), dtype=dtype, pin_memory=pinned)
            out.append(to_host_array(t))
        return out[0], out[1]

    # ------------------------------------------------------------------
    def d2h_pages(self, k_pool: torch.Tensor, v_pool: torch.Tensor,
                  pages: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
        """Copy pages out to host. Returns (k, v) [n, L, Hkv, page, Dh]."""
        t0 = time.perf_counter()
        # dynalint: ok(host-sync) the batch's page ids uploaded from a list (a
        # small pageable copy); eviction offload waits on the event below
        # anyway
        idx = torch.as_tensor(list(pages), dtype=torch.long,
                              device=k_pool.device)
        out = []
        for pool in (k_pool, v_pool):
            blocks = pool.index_select(2, idx).permute(2, 0, 1, 3, 4)
            if pool.is_cuda:
                host = torch.empty(blocks.shape, dtype=pool.dtype,
                                   pin_memory=True)
                host.copy_(blocks, non_blocking=True)
            else:
                host = blocks.contiguous()
            out.append(host)
        if k_pool.is_cuda:
            ev = torch.cuda.Event()
            ev.record()
            # dynalint: ok(host-sync) the tier reads the pinned buffers after
            # this: one wait an eviction batch (tier offload, never on a
            # chained enqueue without pool pressure)
            ev.synchronize()       # the pinned buffers are read after this
        k, v = to_host_array(out[0]), to_host_array(out[1])
        self.d2h_bytes += k.nbytes + v.nbytes
        self.d2h_seconds += time.perf_counter() - t0
        return k, v

    def h2d_pages(self, k_pool: torch.Tensor, v_pool: torch.Tensor,
                  pages: Sequence[int], k: np.ndarray,
                  v: np.ndarray) -> None:
        """Upload [n, L, Hkv, page, Dh] host blocks into device pages, in
        place, on the current stream."""
        t0 = time.perf_counter()
        # dynalint: ok(host-sync) the batch's page ids uploaded from a list (a
        # small pageable copy) once a tier restore, at admission
        idx = torch.as_tensor(list(pages), dtype=torch.long,
                              device=k_pool.device)
        keep = []
        for pool, arr in ((k_pool, k), (v_pool, v)):
            src = from_host_array(arr, pool.dtype)
            if pool.is_cuda:
                # asynchronous only from pinned memory (``host_blocks``);
                # from pageable memory torch copies synchronously
                keep.append(src)
                src = src.to(pool.device, non_blocking=True)
            pool.index_copy_(2, idx, src.permute(1, 2, 0, 3, 4))
        if k_pool.is_cuda:
            self._retire()
            self._keep_until_done(keep)
        self.h2d_bytes += k.nbytes + v.nbytes
        self.h2d_seconds += time.perf_counter() - t0

    def h2d_param_slab(self, buf: torch.Tensor, start: int,
                       vals: torch.Tensor) -> torch.Tensor:
        """Overwrite the layer group ``buf[start:start + G]`` of a stacked
        ``[L, ...]`` param leaf in place from the host chunk ``vals``
        (``[G, ...]``; pinned on a card), and return ``buf``: no device
        buffer is allocated, the leaf keeps its storage (the JAX package
        donates the old buffer to a ``dynamic_update_slice`` instead).

        On a card the copy runs on this stream's side stream. That stream
        first waits on the compute stream: the chained decode window
        enqueues ahead, so the last dispatch before a drain may still be
        reading the old weights. The compute stream then waits on the
        copy, so the first dispatch enqueued after it reads the new
        weights. The source chunk stays referenced until its copy's event
        has completed."""
        t0 = time.perf_counter()
        dst = buf[start:start + vals.shape[0]]
        if tuple(dst.shape) != tuple(vals.shape):
            raise ValueError(f"param slab {tuple(vals.shape)} does not fit "
                             f"{tuple(buf.shape)} at layer {start}")
        if buf.is_cuda:
            compute = torch.cuda.current_stream(buf.device)
            if self._param_stream is None:
                self._param_stream = torch.cuda.Stream(buf.device)
            side = self._param_stream
            side.wait_stream(compute)
            with torch.cuda.stream(side):
                dst.copy_(vals, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(side)
            compute.wait_event(ev)
            self._retire()
            self._inflight.append((ev, [vals]))
        else:
            dst.copy_(vals)
        self.h2d_bytes += vals.numel() * vals.element_size()
        self.h2d_seconds += time.perf_counter() - t0
        return buf

    def scatter_blocks(self, k_pool: torch.Tensor, v_pool: torch.Tensor,
                       pages: Sequence[int], k_blocks: Sequence[torch.Tensor],
                       v_blocks: Sequence[torch.Tensor]) -> None:
        """Scatter [L, Hkv, page, Dh] blocks already on the pool's device
        into pool pages, in place (device to device)."""
        # dynalint: ok(host-sync) the batch's page ids uploaded from a list (a
        # small pageable copy) once a staged-prefetch restore, at admission
        idx = torch.as_tensor(list(pages), dtype=torch.long,
                              device=k_pool.device)
        k_pool.index_copy_(2, idx, torch.stack(list(k_blocks), 2))
        v_pool.index_copy_(2, idx, torch.stack(list(v_blocks), 2))
