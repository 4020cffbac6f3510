"""Device KV block pool: page allocation over the engine's device pool.

The engine's KV pages live in one flat device tensor; this pool owns which
pages are free and which are leased by a live sequence. Page 0 is reserved as
the scratch page (padded lanes write there) and is never leased.

Prefix reuse is not ported yet: there is no sealed/reusable state and no
eviction, so a released page goes straight back to the free list. Reuse comes
with the xxh3-64 block-hash chain shared with the KV router.

Reference capability: the RAII block pool (lib/runtime/src/utils/pool.rs:
111-241), as a single synchronous state machine driven from the engine
thread.
"""

from __future__ import annotations

from typing import List, Set


class DeviceBlockPool:
    """Page-granularity free list over the engine's device KV pool."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is scratch)")
        self.num_pages = num_pages
        # popped from the end: pages lease in ascending order
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._leased: Set[int] = set()

    @property
    def allocatable(self) -> int:
        """Pages a new lease could obtain."""
        return len(self._free)

    def lease_new(self) -> int:
        """Claim a free page (callers check :attr:`allocatable` first)."""
        page = self._free.pop()
        self._leased.add(page)
        return page

    def release(self, page: int) -> None:
        """Return a leased page to the free list."""
        if page not in self._leased:
            raise ValueError(f"release of page {page}, which is not leased")
        self._leased.remove(page)
        self._free.append(page)
