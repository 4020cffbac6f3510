"""KvIndexer: the router-side global prefix index.

A worker-aware radix/prefix tree over chained block hashes: each node is one
KV block (keyed by its sequence hash) and records which workers currently hold
it. ``find_matches`` walks a request's block-hash chain from the root and
scores per-worker overlap. An asyncio actor task owns all mutation (events in
via queue), so no locks — the same single-owner discipline as the reference.

Reference capability: lib/llm/src/kv_router/indexer.rs:172-438 (RadixTree,
OverlapScores, apply_event, remove_worker, expiry) and the sharded variant
(indexer.rs:670-796).
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..tokens import compute_seq_hashes
from .protocols import RouterEvent


@dataclass
class OverlapScores:
    """worker_id -> number of consecutive prefix blocks already cached."""

    scores: Dict[int, int] = field(default_factory=dict)
    # frequency of each matched block across all workers (optional telemetry)
    frequencies: List[int] = field(default_factory=list)

    def best(self) -> Tuple[Optional[int], int]:
        if not self.scores:
            return None, 0
        w = max(self.scores, key=lambda k: self.scores[k])
        return w, self.scores[w]


class _Node:
    __slots__ = ("hash", "parent", "children", "workers", "last_touch")

    def __init__(self, h: int, parent: Optional["_Node"]):
        self.hash = h
        self.parent = parent
        self.children: Dict[int, _Node] = {}
        # worker_id -> refcount: the same prefix block can be stored by
        # several concurrent sequences on one worker; a removal by one must
        # not revoke the worker's claim while others still hold it
        self.workers: Dict[int, int] = {}
        self.last_touch = time.monotonic()


class RadixTree:
    """Single-threaded prefix tree over sequence hashes."""

    def __init__(self):
        self._root = _Node(0, None)
        self._nodes: Dict[int, _Node] = {}          # seq_hash -> node
        self._worker_blocks: Dict[int, Set[int]] = {}  # worker -> seq hashes

    # -- mutation ------------------------------------------------------
    def apply_event(self, ev: RouterEvent) -> None:
        w = ev.worker_id
        e = ev.event
        if e.stored is not None:
            parent = (self._nodes.get(e.stored.parent_hash, self._root)
                      if e.stored.parent_hash is not None else self._root)
            for blk in e.stored.blocks:
                node = self._nodes.get(blk.block_hash)
                if node is None:
                    node = _Node(blk.block_hash, parent)
                    parent.children[blk.block_hash] = node
                    self._nodes[blk.block_hash] = node
                node.workers[w] = node.workers.get(w, 0) + 1
                node.last_touch = time.monotonic()
                self._worker_blocks.setdefault(w, set()).add(blk.block_hash)
                parent = node
        if e.removed is not None:
            for h in e.removed.block_hashes:
                node = self._nodes.get(h)
                if node is None:
                    continue
                n = node.workers.get(w, 0) - 1
                if n > 0:
                    node.workers[w] = n
                else:
                    node.workers.pop(w, None)
                    wb = self._worker_blocks.get(w)
                    if wb:
                        wb.discard(h)
                self._maybe_prune(node)

    def remove_worker(self, worker_id: int) -> None:
        for h in self._worker_blocks.pop(worker_id, set()):
            node = self._nodes.get(h)
            if node is not None:
                node.workers.pop(worker_id, None)
                self._maybe_prune(node)

    def _maybe_prune(self, node: _Node) -> None:
        while (node is not self._root and not node.workers
               and not node.children):
            parent = node.parent
            if parent is not None:
                parent.children.pop(node.hash, None)
            self._nodes.pop(node.hash, None)
            if parent is None or parent is self._root:
                break
            node = parent

    def expire_older_than(self, max_age_s: float) -> int:
        """Drop leaf blocks untouched for max_age_s (frequency/TTL expiry)."""
        cutoff = time.monotonic() - max_age_s
        stale = [n for n in self._nodes.values()
                 if not n.children and n.last_touch < cutoff]
        for n in stale:
            for w in list(n.workers):
                self._worker_blocks.get(w, set()).discard(n.hash)
            n.workers.clear()
            self._maybe_prune(n)
        return len(stale)

    # -- queries -------------------------------------------------------
    def find_matches(self, seq_hashes: Sequence[int]) -> OverlapScores:
        """Walk the chain from the root; a worker's score is the count of
        consecutive blocks it holds from the start."""
        out = OverlapScores()
        node = self._root
        active: Optional[Set[int]] = None
        for h in seq_hashes:
            child = node.children.get(h)
            if child is None:
                break
            child.last_touch = time.monotonic()
            holders = set(child.workers)
            active = holders if active is None else active & holders
            if not active:
                break
            for w in active:
                out.scores[w] = out.scores.get(w, 0) + 1
            out.frequencies.append(len(holders))
            node = child
        return out

    @property
    def num_blocks(self) -> int:
        return len(self._nodes)

    def workers(self) -> Set[int]:
        return set(self._worker_blocks)


class KvIndexer:
    """Asyncio actor owning a RadixTree; events in via queue, queries are
    cheap reads executed on the loop (single-threaded => consistent)."""

    def __init__(self, block_size: int, expiry_s: Optional[float] = None):
        self.block_size = block_size
        self.tree = RadixTree()
        self._queue: asyncio.Queue = asyncio.Queue()
        self._task: Optional[asyncio.Task] = None
        self._expiry_s = expiry_s
        self.events_applied = 0

    async def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._run(), name="kv-indexer")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _run(self) -> None:
        last_expiry = time.monotonic()
        while True:
            try:
                ev = await asyncio.wait_for(self._queue.get(), timeout=1.0)
                self.tree.apply_event(ev)
                self.events_applied += 1
            except asyncio.TimeoutError:
                pass
            if self._expiry_s and time.monotonic() - last_expiry > self._expiry_s:
                self.tree.expire_older_than(self._expiry_s)
                last_expiry = time.monotonic()

    # -- producer side -------------------------------------------------
    def apply(self, ev: RouterEvent) -> None:
        """Enqueue an event (thread-safe only from the loop thread)."""
        self._queue.put_nowait(ev)

    def apply_sync(self, ev: RouterEvent) -> None:
        """Apply immediately (tests / single-threaded callers)."""
        self.tree.apply_event(ev)
        self.events_applied += 1

    def remove_worker(self, worker_id: int) -> None:
        self.tree.remove_worker(worker_id)

    # -- queries --------------------------------------------------------
    def find_matches(self, seq_hashes: Sequence[int]) -> OverlapScores:
        return self.tree.find_matches(seq_hashes)

    def find_matches_for_tokens(self, tokens: Sequence[int],
                                lora_id: int = 0) -> OverlapScores:
        """Match under an adapter: the query chain is salted exactly like
        the publishers' (same tokens + different lora_id → zero overlap)."""
        return self.find_matches(
            compute_seq_hashes(tokens, self.block_size, lora_id=lora_id))


class KvIndexerSharded:
    """Partition workers across N independent trees — bounds per-tree size
    and lets event application parallelize across actors."""

    def __init__(self, block_size: int, num_shards: int = 4):
        self.block_size = block_size
        self.shards = [KvIndexer(block_size) for _ in range(num_shards)]

    def _shard(self, worker_id: int) -> KvIndexer:
        return self.shards[worker_id % len(self.shards)]

    def apply_sync(self, ev: RouterEvent) -> None:
        self._shard(ev.worker_id).apply_sync(ev)

    def remove_worker(self, worker_id: int) -> None:
        self._shard(worker_id).remove_worker(worker_id)

    def find_matches(self, seq_hashes: Sequence[int]) -> OverlapScores:
        out = OverlapScores()
        for sh in self.shards:
            part = sh.find_matches(seq_hashes)
            out.scores.update(part.scores)
        return out

    def find_matches_for_tokens(self, tokens: Sequence[int],
                                lora_id: int = 0) -> OverlapScores:
        return self.find_matches(
            compute_seq_hashes(tokens, self.block_size, lora_id=lora_id))
