"""Pinned host-RAM weight cache: the prefetch half of model mobility.

One cache per worker process. Candidate sibling checkpoints load off the
serving path (a single daemon thread, safetensors mmap-fed through
:func:`~dynamo_tpu_torch.engine.loader.load_llama_params_host`) into host
param dicts (the engine's stacked ``[L, ...]`` tree as CPU tensors),
LRU-bounded by ``DYN_WEIGHT_CACHE_BYTES``. A hot-swap then pays only the
h2d stream — PRESERVE's observation that prefetching weights while the
incumbent model serves hides nearly all of the load latency.

For a worker on a card (``pinned=True``) every cached leaf lives in
page-locked host memory: a ``non_blocking`` upload from pageable memory is
synchronous, and the swap would then serialize on the host. The budget
counts those page-locked bytes. On the CPU nothing is pinned (pinning
raises without CUDA), the choice ``CopyStream.host_blocks`` makes for KV.

Pinned entries (the incumbent model, an in-progress swap's source) are
excluded from LRU eviction, mirroring the KV tier's pinning contract.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from ...utils.knobs import env_float

log = logging.getLogger("dynamo_tpu_torch.mobility")

#: default cache budget: two 7B-class bf16 checkpoints' worth
DEFAULT_CACHE_BYTES = 32 << 30


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a nested param dict (list/tuple nodes too), in key
    order — the port's counterpart of ``jax.tree.leaves`` for the param
    trees it holds."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def leaf_nbytes(leaf: Any) -> int:
    if hasattr(leaf, "element_size"):           # torch.Tensor
        return int(leaf.numel() * leaf.element_size())
    return int(np.asarray(leaf).nbytes)


def tree_nbytes(tree: Any) -> int:
    """Total host bytes of a param tree (torch tensors or numpy arrays)."""
    return sum(leaf_nbytes(a) for a in tree_leaves(tree))


def pin_tree(tree: Any) -> Any:
    """The tree with every torch leaf (host or device) copied into
    page-locked host memory, one leaf at a time (the transient is one
    leaf, never a second tree)."""
    import torch

    if isinstance(tree, dict):
        return {k: pin_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and not tree.is_pinned():
        buf = torch.empty(tree.shape, dtype=tree.dtype, pin_memory=True)
        buf.copy_(tree)
        return buf
    return tree


class WeightCache:
    """LRU host-RAM cache of model-path -> host param trees.

    Thread-safe: the prefetch thread inserts while the engine thread (or
    the asyncio swap agent) reads. ``loader`` is injected for tests; the
    default reads safetensors via :func:`load_llama_params_host`.
    ``pinned`` (a worker on a card) page-locks every loaded leaf.
    """

    def __init__(self, capacity_bytes: Optional[int] = None,
                 loader: Optional[Callable[[str, Any], Any]] = None,
                 pinned: bool = False):
        if capacity_bytes is None:
            capacity_bytes = int(env_float(
                "DYN_WEIGHT_CACHE_BYTES", float(DEFAULT_CACHE_BYTES),
                minimum=0.0))
        self.capacity_bytes = capacity_bytes
        self._loader = loader or self._default_loader
        self.pinned = pinned
        # path -> (host tree, nbytes), LRU order (oldest first)
        self._entries: "collections.OrderedDict[str, Tuple[Any, int]]" = \
            collections.OrderedDict()
        self._pinned: set = set()
        self._lock = threading.RLock()
        self._queue: "collections.deque[Tuple[str, Any]]" = \
            collections.deque()
        self._queued: set = set()
        self._wake = threading.Event()
        self._running = True
        self._thread: Optional[threading.Thread] = None
        self.loads = 0
        self.load_errors = 0

    @staticmethod
    def _default_loader(path: str, cfg: Any) -> Any:
        from ...engine.loader import load_llama_params_host

        return load_llama_params_host(path, cfg)

    # ------------------------------------------------------------------
    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return sum(n for _, n in self._entries.values())

    def __contains__(self, path: str) -> bool:
        with self._lock:
            return path in self._entries

    def paths(self) -> List[str]:
        with self._lock:
            return list(self._entries)

    def get(self, path: str) -> Optional[Any]:
        """The cached host tree for ``path`` (LRU-touched), or None."""
        with self._lock:
            got = self._entries.get(path)
            if got is None:
                return None
            self._entries.move_to_end(path)
            return got[0]

    def pin(self, path: str) -> None:
        with self._lock:
            self._pinned.add(path)

    def unpin(self, path: str) -> None:
        with self._lock:
            self._pinned.discard(path)

    def drop(self, path: str) -> None:
        with self._lock:
            self._entries.pop(path, None)
            self._pinned.discard(path)
            self._set_gauges_locked()

    # ------------------------------------------------------------------
    def put(self, path: str, tree: Any) -> bool:
        """Insert a loaded tree, evicting unpinned LRU entries to fit.
        Returns False (tree dropped) if it cannot fit even after evicting
        everything unpinned — an over-budget checkpoint must not evict a
        pinned incumbent."""
        nbytes = tree_nbytes(tree)
        with self._lock:
            self._entries.pop(path, None)
            while (self.resident_bytes + nbytes > self.capacity_bytes
                   and self._evict_one_locked()):
                pass
            if self.resident_bytes + nbytes > self.capacity_bytes:
                log.warning("weight cache cannot fit %s (%.1f GiB > "
                            "budget); dropping", path, nbytes / 2**30)
                self._set_gauges_locked()
                return False
            self._entries[path] = (tree, nbytes)
            self._set_gauges_locked()
            return True

    def _evict_one_locked(self) -> bool:
        for path in self._entries:          # LRU -> MRU
            if path not in self._pinned:
                self._entries.pop(path)
                return True
        return False

    def _set_gauges_locked(self) -> None:
        from ...utils.prometheus import stage_metrics

        pinned = sum(n for p, (_, n) in self._entries.items()
                     if p in self._pinned)
        total = sum(n for _, n in self._entries.values())
        g = stage_metrics().weight_cache_bytes
        g.set("pinned", value=float(pinned))
        g.set("unpinned", value=float(total - pinned))

    # ------------------------------------------------------------------
    # background prefetch (the PRESERVE overlap)
    # ------------------------------------------------------------------
    def prefetch(self, path: str, cfg: Any) -> bool:
        """Queue a background load of ``path`` (idempotent while resident
        or already queued). Returns True if a load was queued."""
        with self._lock:
            if path in self._entries or path in self._queued:
                return False
            self._queued.add(path)
            self._queue.append((path, cfg))
        self._ensure_thread()
        self._wake.set()
        return True

    def load_now(self, path: str, cfg: Any) -> Optional[Any]:
        """Synchronous load-through (the swap fallback when the prefetch
        has not landed yet). Returns the host tree, or None on failure."""
        got = self.get(path)
        if got is not None:
            return got
        t0 = time.perf_counter()
        try:
            tree = self._loader(path, cfg)
            if self.pinned:
                tree = pin_tree(tree)
        except Exception:  # noqa: BLE001 - a bad checkpoint must not raise
            log.exception("weight load failed for %s", path)
            self.load_errors += 1
            return None
        self.loads += 1
        # the checkpoint read is a disk->host flow: weight prefetch shows
        # up on the same link telemetry every other byte movement uses
        from ...obs.flows import record_flow
        record_flow("weight_prefetch", tree_nbytes(tree),
                    time.perf_counter() - t0)
        self.put(path, tree)
        return tree

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._prefetch_loop, name="weight-prefetch",
                daemon=True)
            self._thread.start()

    def _prefetch_loop(self) -> None:
        while self._running:
            try:
                path, cfg = self._queue.popleft()
            except IndexError:
                self._wake.wait(timeout=0.5)
                self._wake.clear()
                continue
            try:
                if path not in self:
                    self.load_now(path, cfg)
            finally:
                with self._lock:
                    self._queued.discard(path)

    def close(self) -> None:
        self._running = False
        self._wake.set()
        with self._lock:
            self._entries.clear()
            self._pinned.clear()
            self._queue.clear()
            self._queued.clear()
            self._set_gauges_locked()
