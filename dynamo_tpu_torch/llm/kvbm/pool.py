"""Device KV block pool: allocation, sequence-hash reuse, LRU eviction.

The engine's KV pages live in one flat device array; this pool owns the
*states* of those pages:

- ``free``      — unclaimed, contents meaningless.
- ``leased``    — held by >= 1 live sequence (refcounted; a full, sealed
                  block may be shared read-only by several sequences that
                  matched the same prefix).
- ``reusable``  — no live owner, but holds a sealed block addressed by its
                  chained sequence hash; claimable by prefix match, evicted
                  (lowest priority, then least recently used) when the free
                  list runs dry. Eviction fires ``on_evict`` first so a
                  tiered cache can offload the page to host DRAM.

Reference capability: the AvailableBlocks reuse actor + RAII block pool +
reserved-block registry (lib/llm/src/kv/reuse.rs:50-150,
lib/runtime/src/utils/pool.rs:111-241, lib/llm/src/kv/reserved.rs:15-60) —
re-designed as a single synchronous state machine because the engine drives
all KV bookkeeping from one engine thread (no actor mailboxes needed). Page
choices (lease order, LRU eviction order) are those of the JAX package's
pool for the same sequence of operations, so the two engines publish the
same KV events.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple


class OutOfBlocks(RuntimeError):
    pass


@dataclass
class _Block:
    page: int
    state: str = "free"                  # free | leased | reusable
    seq_hash: Optional[int] = None       # set once sealed
    registered: bool = False             # seq_hash -> page map entry is ours
    refs: int = 0
    priority: int = 0
    last_used: int = 0                   # logical clock (deterministic LRU)


class DeviceBlockPool:
    """Page-granularity state machine over the engine's device KV pool.

    Page 0 is reserved as the scratch page (masked lanes write there).
    """

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is scratch)")
        self.num_pages = num_pages
        self._blocks: Dict[int, _Block] = {
            p: _Block(p) for p in range(1, num_pages)}
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._by_hash: Dict[int, int] = {}      # seq_hash -> page
        self._clock = 0
        # (priority, last_used, page) lazy-deleted eviction heap
        self._evict_heap: List[Tuple[int, int, int]] = []
        # incremental count of state == "reusable" blocks: allocatable is
        # probed per page-allocation, an O(num_pages) scan there is the
        # scheduler's hottest host cost
        self._n_reusable = 0
        # offload hook: called with (seq_hash, page) BEFORE the page is
        # recycled; the tiered cache copies it out to host DRAM here
        self.on_evict: Optional[Callable[[int, int], None]] = None

    # ------------------------------------------------------------------
    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def reusable_count(self) -> int:
        return self._n_reusable

    @property
    def allocatable(self) -> int:
        """Pages a new lease could obtain (free + evictable)."""
        return self.free_count + self.reusable_count

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # ------------------------------------------------------------------
    def lease_new(self) -> int:
        """Claim a page for writing (refs=1). Evicts LRU reusable on
        pressure; raises OutOfBlocks when nothing is left."""
        if self._free:
            page = self._free.pop()
        else:
            page = self._evict_one()
        b = self._blocks[page]
        b.state = "leased"
        b.seq_hash = None
        b.registered = False
        b.refs = 1
        b.last_used = self._tick()
        return page

    def _evict_one(self) -> int:
        while self._evict_heap:
            prio, ts, page = heapq.heappop(self._evict_heap)
            b = self._blocks[page]
            if b.state != "reusable" or (b.priority, b.last_used) != (prio, ts):
                continue  # stale heap entry
            if self.on_evict is not None and b.seq_hash is not None:
                self.on_evict(b.seq_hash, page)
            # decrement only after the offload hook: a hook exception must
            # leave the counter consistent with the unchanged state
            self._n_reusable -= 1
            self._unregister(b)
            return page
        raise OutOfBlocks("no free or reusable pages left")

    def _unregister(self, b: _Block) -> None:
        if b.registered and self._by_hash.get(b.seq_hash) == b.page:
            del self._by_hash[b.seq_hash]
        b.registered = False
        b.seq_hash = None

    # ------------------------------------------------------------------
    def seal(self, page: int, seq_hash: int, priority: int = 0) -> bool:
        """Mark a leased page as holding the full block ``seq_hash``; it
        becomes discoverable for prefix matching (first page wins if the
        same content is sealed twice). Returns True iff this page newly
        registered the hash — the signal to publish a router "stored" event
        (exactly one stored per registered block balances the one "removed"
        fired at eviction)."""
        b = self._blocks[page]
        assert b.state == "leased", f"seal on {b.state} page {page}"
        b.seq_hash = seq_hash
        b.priority = priority
        if seq_hash not in self._by_hash:
            self._by_hash[seq_hash] = page
            b.registered = True
            return True
        return False

    def unseal(self, page: int) -> Optional[int]:
        """Withdraw a leased page's sealed block from prefix matching (its
        contents turned out incomplete). Returns the hash it had registered
        (the caller publishes its removed event), else None."""
        b = self._blocks[page]
        assert b.state == "leased", f"unseal on {b.state} page {page}"
        h = b.seq_hash if b.registered else None
        self._unregister(b)
        return h

    def contains(self, seq_hash: int) -> bool:
        """Non-claiming membership probe (disagg router's prefix-hit input)."""
        return seq_hash in self._by_hash

    def match(self, seq_hash: int) -> Optional[int]:
        """Claim the sealed block for ``seq_hash`` if present: a reusable
        block is re-leased; a live shared block gains a reference."""
        page = self._by_hash.get(seq_hash)
        if page is None:
            return None
        b = self._blocks[page]
        b.last_used = self._tick()
        if b.state == "reusable":
            b.state = "leased"
            self._n_reusable -= 1
            b.refs = 1
        else:
            b.refs += 1
        return page

    def release(self, page: int) -> None:
        """Drop one reference. At zero refs a sealed+registered block parks
        as reusable; anything else returns to the free list."""
        b = self._blocks[page]
        assert b.state == "leased" and b.refs > 0, \
            f"release on {b.state}/{b.refs} page {page}"
        b.refs -= 1
        if b.refs:
            return
        if b.seq_hash is not None and b.registered:
            b.state = "reusable"
            self._n_reusable += 1
            b.last_used = self._tick()
            heapq.heappush(self._evict_heap, (b.priority, b.last_used, b.page))
        else:
            b.state = "free"
            self._unregister(b)
            self._free.append(page)

    # ------------------------------------------------------------------
    def flush_reusable(self) -> int:
        """Evict every reusable block (offloading via on_evict); returns the
        number flushed. Used by cache-clear admin ops and tests."""
        n = 0
        while self.reusable_count:
            page = self._evict_one()
            b = self._blocks[page]
            b.state = "free"
            self._free.append(page)
            n += 1
        return n
