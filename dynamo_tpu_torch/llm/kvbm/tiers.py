"""Host-DRAM and disk KV cache tiers.

Offloaded KV pages park in host DRAM (and optionally spill to an mmap'd
file) keyed by chained sequence hash, so a later request with the same
prefix re-uploads instead of recomputing. Capacity is fixed-slot: each tier
is one preallocated array of block slots + an LRU map, so steady-state
serving does zero host allocation.

Blocks are numpy arrays laid out [L, Hkv, page, Dh], byte-compatible with
the JAX package's host blocks. numpy has no bfloat16 without ``ml_dtypes``
(which the port does not depend on), so a bf16 pool's blocks are stored as
their raw bits in ``uint16`` (:func:`~dynamo_tpu_torch.llm.kvbm.transfer.
host_dtype`); other pools keep their own dtype.

Cross-thread contract: the engine thread owns all tier mutation on the
serving path (offload at eviction flush, lookup at admission); planes that
read or deposit blocks from another thread (cluster sharing, prefetch — not
ported yet) go through the same lock. :class:`TieredKvCache` therefore
guards every access with one internal lock; ``peek`` reads a block without
perturbing LRU order (safe for probes and peer serving), and ``hashes``
snapshots the resident hash sets for a registry publisher.

The tier counts live in :meth:`TieredKvCache.stats` and, as in the JAX
package, in the stage gauges ``dyn_kv_tier_blocks{tier,worker}`` and the
counters ``dyn_kv_tier_hits_total{tier}`` / ``dyn_kv_tier_misses_total``.

Reference capability: the multi-tier KV manager design HBM->CPU->SSD
(docs/kv_cache_manager.md:5-15,39-71, lib/llm/src/kv/storage.rs pinned/system
tiers), host-staged through pinned buffers (``transfer.CopyStream``).
"""

from __future__ import annotations

import collections
import logging
import os
import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ...utils.prometheus import stage_metrics

log = logging.getLogger("dynamo_tpu_torch.kvbm")


class OutOfTierSpace(RuntimeError):
    """A pinned insert found no evictable slot (every resident block is
    pinned) — the paging working set outgrew the tier."""


class _SlotCache:
    """Fixed-capacity LRU of KV blocks in one preallocated array pair.

    ``pinned`` hashes are excluded from LRU eviction: the KV-paging plane
    pins a long sequence's demoted working set so a cluster-traffic burst
    cannot silently drop blocks a live decode still has to read back.
    """

    def __init__(self, num_blocks: int, block_shape: Tuple[int, ...],
                 dtype, k_store: np.ndarray, v_store: np.ndarray):
        self.num_blocks = num_blocks
        self.block_shape = block_shape
        self.dtype = dtype
        self._k = k_store
        self._v = v_store
        self._slot_of: "collections.OrderedDict[int, int]" = \
            collections.OrderedDict()          # seq_hash -> slot, LRU order
        self._free = list(range(num_blocks - 1, -1, -1))
        self.pinned: set = set()

    def __len__(self) -> int:
        return len(self._slot_of)

    def __contains__(self, seq_hash: int) -> bool:
        return seq_hash in self._slot_of

    def _victim(self) -> Optional[int]:
        """Oldest resident hash that is not pinned (None = all pinned)."""
        for h in self._slot_of:                # iterates LRU -> MRU
            if h not in self.pinned:
                return h
        return None

    def put(self, seq_hash: int, k: np.ndarray, v: np.ndarray,
            required: bool = False
            ) -> Optional[Tuple[int, np.ndarray, np.ndarray]]:
        """Insert a block. Returns the evicted (hash, k, v) if the cache was
        full (caller may cascade it to the next tier), else None.

        When full and every resident block is pinned, the incoming block is
        DROPPED (cache semantics; the caller's data was best-effort) unless
        ``required=True`` — then :class:`OutOfTierSpace` is raised, because
        the caller (the paging plane depositing a pinned block) cannot
        tolerate silent loss."""
        evicted = None
        if seq_hash in self._slot_of:
            self._slot_of.move_to_end(seq_hash)
            slot = self._slot_of[seq_hash]
        elif self._free:
            slot = self._free.pop()
            self._slot_of[seq_hash] = slot
        else:
            old_hash = self._victim()
            if old_hash is None:
                if required:
                    raise OutOfTierSpace(
                        f"all {self.num_blocks} tier blocks are pinned; "
                        f"cannot insert block {seq_hash:x}")
                log.warning("KV tier full of pinned blocks; dropping "
                            "offloaded block %x", seq_hash)
                return None
            slot = self._slot_of.pop(old_hash)
            evicted = (old_hash, self._k[slot].copy(), self._v[slot].copy())
            self._slot_of[seq_hash] = slot
        self._k[slot] = k
        self._v[slot] = v
        return evicted

    def get(self, seq_hash: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        slot = self._slot_of.get(seq_hash)
        if slot is None:
            return None
        self._slot_of.move_to_end(seq_hash)
        return self._k[slot], self._v[slot]

    def peek(self, seq_hash: int
             ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Read WITHOUT touching LRU order (probes, peer serving)."""
        slot = self._slot_of.get(seq_hash)
        if slot is None:
            return None
        return self._k[slot], self._v[slot]

    def peek_layer(self, seq_hash: int, layer: int
                   ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """One layer's [Hkv, page, Dh] slice, no LRU touch — the paging
        plane streams cold blocks layer-at-a-time, and copying the whole
        [L, ...] block per layer would multiply the memcpy by L."""
        slot = self._slot_of.get(seq_hash)
        if slot is None:
            return None
        return self._k[slot][layer], self._v[slot][layer]

    def pop(self, seq_hash: int) -> None:
        slot = self._slot_of.pop(seq_hash, None)
        if slot is not None:
            self.pinned.discard(seq_hash)
            self._free.append(slot)


class HostKvTier(_SlotCache):
    """Host-DRAM tier: [n_blocks, L, Hkv, page, Dh] preallocated numpy
    (zero pages are mapped lazily by the OS)."""

    def __init__(self, num_blocks: int, block_shape: Tuple[int, ...], dtype):
        shape = (num_blocks, *block_shape)
        super().__init__(num_blocks, block_shape, dtype,
                         np.zeros(shape, dtype), np.zeros(shape, dtype))


class DiskKvTier(_SlotCache):
    """mmap-backed spill tier (the reference's SSD tier)."""

    def __init__(self, num_blocks: int, block_shape: Tuple[int, ...], dtype,
                 path: str):
        shape = (num_blocks, *block_shape)
        self.path = path
        k = np.memmap(path + ".k", dtype=dtype, mode="w+", shape=shape)
        v = np.memmap(path + ".v", dtype=dtype, mode="w+", shape=shape)
        super().__init__(num_blocks, block_shape, dtype, k, v)
        self._closed = False

    def close(self) -> None:
        """Flush and remove the spill files. ``mode="w+"`` memmaps are
        scratch state: a worker that exits without this leaks two
        block-pool-sized files in the spill directory per engine."""
        if self._closed:
            return
        self._closed = True
        for arr in (self._k, self._v):
            try:
                arr.flush()
            except (OSError, ValueError):
                log.warning("disk tier flush failed for %s", self.path,
                            exc_info=True)
        # drop the memmap references before unlinking so the interpreter
        # can release the mappings promptly
        self._k = self._v = None
        self._slot_of.clear()
        self._free.clear()
        for suffix in (".k", ".v"):
            try:
                os.unlink(self.path + suffix)
            except FileNotFoundError:
                pass
            except OSError:
                log.warning("could not remove KV spill file %s%s",
                            self.path, suffix, exc_info=True)


class TieredKvCache:
    """Host tier with optional disk spill, one lookup/offload surface.

    ``offload`` inserts at the host tier and cascades host-LRU evictions to
    disk; ``lookup`` checks host then disk (promoting disk hits back to
    host). All arrays are [L, Hkv, page, Dh] per block. Thread-safe: every
    method takes the internal lock, so the engine thread and the cluster
    data plane (peer fetch deposit/serve on the asyncio thread) can share
    one instance. ``on_change`` fires (outside the lock) whenever the
    resident hash sets changed — the cluster registry publisher's dirty
    signal.
    """

    def __init__(self, host: HostKvTier, disk: Optional[DiskKvTier] = None):
        self.host = host
        self.disk = disk
        self.hits = 0
        self.misses = 0
        # one lock shared by the engine thread and the asyncio data plane
        self._lock = threading.RLock()
        self.on_change: Optional[Callable[[], None]] = None
        self._worker = str(os.getpid())

    def __contains__(self, seq_hash: int) -> bool:
        with self._lock:
            return seq_hash in self.host or (
                self.disk is not None and seq_hash in self.disk)

    def _set_block_gauges(self) -> None:
        g = stage_metrics().kv_tier_blocks
        g.set("host", self._worker, value=float(len(self.host)))
        if self.disk is not None:
            g.set("disk", self._worker, value=float(len(self.disk)))

    def offload(self, seq_hash: int, k: np.ndarray, v: np.ndarray) -> None:
        with self._lock:
            self._offload_locked(seq_hash, k, v)
        self._fire_change()

    def _offload_locked(self, seq_hash: int, k: np.ndarray,
                        v: np.ndarray) -> None:
        """Insert + cascade under the already-held lock, WITHOUT firing
        ``on_change`` — public entry points fire exactly once after the
        lock drops (a callback that needs the lock must not deadlock)."""
        spilled = self.host.put(seq_hash, k, v)
        if spilled is not None and self.disk is not None:
            self.disk.put(*spilled)
        self._set_block_gauges()

    def lookup(self, seq_hash: int
               ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        stage = stage_metrics()
        promoted = False
        with self._lock:
            got = self.host.get(seq_hash)
            tier = "host" if got is not None else None
            if got is None and self.disk is not None:
                got = self.disk.get(seq_hash)
                if got is not None:   # promote to host (may spill another)
                    tier = "disk"
                    k, v = got[0].copy(), got[1].copy()
                    got = (k, v)
                    if seq_hash in self.disk.pinned:
                        # a pin must never be separated from its data:
                        # promote only if the host can take it as pinned,
                        # else serve from disk and leave it there
                        try:
                            spilled = self.host.put(seq_hash, k, v,
                                                    required=True)
                        except OutOfTierSpace:
                            spilled = None
                        else:
                            if spilled is not None:
                                self.disk.put(*spilled)
                            self.disk.pop(seq_hash)
                            self.host.pinned.add(seq_hash)
                            self._set_block_gauges()
                            promoted = True
                    else:
                        self.disk.pop(seq_hash)
                        self._offload_locked(seq_hash, k, v)
                        promoted = True
            if got is None:
                self.misses += 1
                stage.kv_tier_misses.inc()
            else:
                self.hits += 1
                stage.kv_tier_hits.inc(tier)
        if promoted:
            self._fire_change()
        return got

    def peek(self, seq_hash: int
             ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Copy a resident block without promoting/LRU-touching it — what
        the ``kv_fetch`` donor endpoint serves peers from. Returns fresh
        copies (the slot may be recycled the moment the lock drops)."""
        with self._lock:
            got = self.host.peek(seq_hash)
            if got is None and self.disk is not None:
                got = self.disk.peek(seq_hash)
            if got is None:
                return None
            return got[0].copy(), got[1].copy()

    def peek_layer(self, seq_hash: int, layer: int, out=None
                   ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Copy ONE layer's [Hkv, page, Dh] slice of a resident block, no
        LRU touch — the KV-paging plane's page-in read (streaming cold
        blocks layer-at-a-time must not thrash the reuse order that serves
        admission restores). ``out`` = (k, v) arrays to copy into (the
        pager's segment rows: one copy instead of two)."""
        with self._lock:
            got = self.host.peek_layer(seq_hash, layer)
            if got is None and self.disk is not None:
                got = self.disk.peek_layer(seq_hash, layer)
            if got is None:
                return None
            if out is None:
                return got[0].copy(), got[1].copy()
            np.copyto(out[0], got[0])
            np.copyto(out[1], got[1])
            return out

    # ------------------------------------------------------------------
    # pinning (KV-paging working set)
    # ------------------------------------------------------------------
    def pin(self, seq_hash: int) -> bool:
        """Exclude a resident block from LRU eviction (False = not
        resident anywhere). Pins survive disk->host promotion."""
        with self._lock:
            if seq_hash in self.host:
                self.host.pinned.add(seq_hash)
                return True
            if self.disk is not None and seq_hash in self.disk:
                self.disk.pinned.add(seq_hash)
                return True
            return False

    def unpin(self, seq_hash: int) -> None:
        with self._lock:
            self.host.pinned.discard(seq_hash)
            if self.disk is not None:
                self.disk.pinned.discard(seq_hash)

    def pinned_count(self) -> int:
        with self._lock:
            return len(self.host.pinned) + (
                len(self.disk.pinned) if self.disk is not None else 0)

    def deposit_pinned(self, seq_hash: int, k: np.ndarray,
                       v: np.ndarray) -> None:
        """Insert a block that MUST stick: pinned on arrival, and the
        insert raises :class:`OutOfTierSpace` instead of dropping when the
        host tier is wall-to-wall pinned (a demoted decode working set is
        state, not cache). Host-LRU spill of unpinned neighbors cascades
        to disk as usual."""
        with self._lock:
            self.host.pinned.add(seq_hash)
            try:
                spilled = self.host.put(seq_hash, k, v, required=True)
            except OutOfTierSpace:
                self.host.pinned.discard(seq_hash)
                raise
            if spilled is not None and self.disk is not None:
                self.disk.put(*spilled)
            self._set_block_gauges()
        self._fire_change()

    def hashes(self) -> Tuple[List[int], List[int]]:
        """Snapshot of the resident (host, disk) sequence hashes — the
        cluster registry publisher's record body."""
        with self._lock:
            return (list(self.host._slot_of),
                    list(self.disk._slot_of) if self.disk is not None
                    else [])

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "host_blocks": len(self.host),
                "disk_blocks": len(self.disk) if self.disk is not None
                else 0,
                "pinned_blocks": len(self.host.pinned) + (
                    len(self.disk.pinned) if self.disk is not None else 0),
                "hits": self.hits,
                "misses": self.misses,
            }

    def clear(self) -> None:
        """Drop every resident block (host and disk) and all pins. The
        model-swap cutover calls this: block hashes are content-only
        (tokens + lora salt, no model identity), so KV computed under the
        outgoing model would silently alias same-token prefixes of the
        incoming one if left resident."""
        with self._lock:
            for tier in (self.host, self.disk):
                if tier is None:
                    continue
                for h in list(tier._slot_of):
                    tier.pop(h)
            self._set_block_gauges()
        self._fire_change()

    def close(self) -> None:
        """Release the disk tier's spill files (engine shutdown)."""
        with self._lock:
            if self.disk is not None:
                self.disk.close()
                self.disk = None

    def _fire_change(self) -> None:
        cb = self.on_change
        if cb is not None:
            cb()
