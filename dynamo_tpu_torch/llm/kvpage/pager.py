"""PageScheduler: stages demoted KV blocks back toward the device ahead
of the attention pass that needs them.

The paged forward consumes cold blocks as (layer, segment) items in a
fully deterministic order — the runner publishes that order, PER LANE,
as a :class:`PageinPlan` before each chunk/window forward. A background
thread walks the installed plans, assembling each segment's host staging
buffer (per-layer ``peek_layer`` copies out of the tier — deliberately
NOT ``lookup``, so page-in traffic never perturbs the LRU order that
serves admission restores) up to ``prefetch`` segments ahead of each
lane's consumer cursor.

With several decode lanes active the assembler ROUND-ROBINS one item at
a time across the lanes that still have claimable work: a lane with a
32x-budget context cannot starve a short-context neighbour, because
backpressure is per lane (``claimed - taken < prefetch``) — each lane
keeps its own double-buffer ahead of the forward, no more. The h2d
upload itself is issued by the runner (from pinned staging, on a side
stream), so by the time attention for segment *s* is enqueued, segment
*s+1* is already assembled and its upload enqueued: page-in overlaps
compute, across lanes as well as within one.

``take`` is the fault boundary: an item the thread already finished is
an async page-in (``dyn_kvpage_pageins_total``); an item that has to be
assembled inline on the engine thread — prefetch disabled, or a plan the
thread has not reached — is a *page fault*
(``dyn_kvpage_faults_total``): a counted synchronous upload, never a
crash. Faults are per take and therefore per LANE: one lane missing its
prefetch degrades that lane's take to a synchronous assembly while the
other lanes' prefetched buffers stay valid and their cursors untouched.
Time spent blocked on a scheduled-but-unfinished item lands in the
``dyn_kvpage_pagein_wait_seconds`` histogram; in steady-state decode
both the fault counter and that histogram should sit at zero
(``chip_smoke.py``'s kvpage phase reports both).
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from ...utils.prometheus import stage_metrics

log = logging.getLogger("dynamo_tpu_torch.kvpage")

#: one plan item: (layer, segment index within that layer)
ItemKey = Tuple[int, int]


class KvPageMiss(RuntimeError):
    """A cold block vanished from every tier mid-decode (the pin
    discipline failed) — fatal for the request, not the engine."""


@dataclass
class PageinPlan:
    """The deterministic page-in order of one paged forward: for each
    layer, the cold segments (tuples of block hashes) it will consume."""

    segments: List[List[Tuple[int, ...]]]   # [layer][seg] -> block hashes
    generation: int = 0

    def items(self) -> List[ItemKey]:
        return [(l, s) for l, segs in enumerate(self.segments)
                for s in range(len(segs))]

    def hashes(self, key: ItemKey) -> Tuple[int, ...]:
        return self.segments[key[0]][key[1]]


@dataclass
class _Assembled:
    k: Optional[np.ndarray]       # [seg_pages, Hkv, page, Dh]
    v: Optional[np.ndarray]
    n_valid: int
    ready: threading.Event = field(default_factory=threading.Event)
    error: Optional[Exception] = None
    #: wall seconds the tier->staging assembly took — folded into the
    #: runner's kvpage_pagein flow so the ledger's page-in seconds cover
    #: staging + upload, not just the h2d enqueue
    seconds: float = 0.0


@dataclass
class _LaneSched:
    """One lane's plan walk: the assembler's claim cursor (``next``) and
    the consumer's take cursor (``taken``) bound each other through the
    per-lane prefetch window."""

    plan: Optional[PageinPlan] = None
    order: List[ItemKey] = field(default_factory=list)
    built: Dict[ItemKey, _Assembled] = field(default_factory=dict)
    next: int = 0                 # thread's claim cursor into order
    taken: int = 0                # consumer's cursor (backpressure)


class PageScheduler:
    """Prefetches cold-block staging buffers ahead of the paged forward.

    Single consumer (the engine thread) + one assembler thread shared by
    every lane; the tier handles its own locking (``peek_layer`` copies
    under the tier lock), so the scheduler only guards its plan/ready
    bookkeeping. Lane 0 is the default so single-lane callers never name
    a lane.
    """

    def __init__(self, tiered, seg_pages: int, prefetch: int = 2):
        self.tiered = tiered
        self.seg_pages = int(seg_pages)
        self.prefetch = int(prefetch)
        self.faults = 0
        self.pageins = 0
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._lanes: Dict[int, _LaneSched] = {}
        self._rr = -1                 # last lane the assembler served
        self._gen = 0
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        #: (lane, item) claim order, for interleave tests/debugging
        self.claim_log: Deque[Tuple[int, ItemKey]] = collections.deque(
            maxlen=1024)
        #: assemble seconds of the most recent take() — the runner (the
        #: single consumer) reads this right after each take to price
        #: the page-in flow it is about to upload
        self.last_assemble_s = 0.0
        #: segment buffers handed back by the consumer (:meth:`recycle`):
        #: reused, so an assembly writes warm pages instead of faulting
        #: fresh ones in
        self._spare: List[Tuple[np.ndarray, np.ndarray]] = []

    # ------------------------------------------------------------------
    def begin(self, plan: PageinPlan, lane: int = 0) -> None:
        """Install one lane's next-forward page-in order; the assembler
        starts on it immediately (per-lane prefetch permitting)."""
        with self._wake:
            self._gen += 1
            plan.generation = self._gen
            st = self._lanes.setdefault(lane, _LaneSched())
            st.plan = plan
            st.order = plan.items()
            st.built = {}
            st.next = 0
            st.taken = 0
            self._wake.notify_all()
        if (self.prefetch > 0 and st.order and self._thread is None
                and not self._closed):
            self._thread = threading.Thread(
                target=self._run, name="kvpage-prefetch", daemon=True)
            self._thread.start()

    def end_lane(self, lane: int) -> None:
        """Drop a lane's plan state (its sequence released); in-flight
        assemblies for it finish into discarded entries."""
        with self._wake:
            self._lanes.pop(lane, None)
            self._wake.notify_all()

    def take(self, key: ItemKey, lane: int = 0
             ) -> Tuple[np.ndarray, np.ndarray, int]:
        """The staging buffer for one lane's plan item:
        (k, v, n_valid_blocks). Prefetched items count as page-ins (time
        blocked on an in-flight assembly lands in the wait histogram); an
        item the assembler will never deliver — prefetch disabled, thread
        gone — is assembled inline: a counted synchronous page fault,
        isolated to this lane (no other lane's cursors move)."""
        stage = stage_metrics()
        t0 = time.perf_counter()
        with self._wake:
            st = self._lanes.get(lane)
            ent = st.built.pop(key, None) if st is not None else None
            if (ent is None and st is not None and self.prefetch > 0
                    and self._thread is not None):
                # the assembler claims a lane's items strictly in plan
                # order; if it has not reached this one yet, it is about
                # to — wait for the claim instead of duplicating the
                # work inline
                try:
                    idx = st.order.index(key)
                except ValueError:
                    idx = -1
                while (ent is None and idx >= 0 and not self._closed
                       and st.plan is not None and st.next <= idx):
                    self._wake.wait(0.05)
                    ent = st.built.pop(key, None)
                if ent is None:
                    ent = st.built.pop(key, None)
            if ent is not None:
                st.taken += 1
                self._wake.notify_all()   # a prefetch slot freed up
        if ent is None:
            # the assembler will never deliver this item: synchronous
            # page-in on the engine thread
            self.faults += 1
            stage.kvpage_faults.inc()
            plan = st.plan if st is not None else None
            if plan is None:
                raise KvPageMiss(
                    f"take({key}) on lane {lane} with no active plan")
            ent = self._assemble(plan.hashes(key), layer=key[0])
            stage.kvpage_pagein_wait.observe(
                value=time.perf_counter() - t0)
            with self._wake:
                if st is not None:
                    st.taken += 1
                self._wake.notify_all()
            self.last_assemble_s = ent.seconds
            return ent.k, ent.v, ent.n_valid
        ent.ready.wait()
        if ent.error is not None:
            raise ent.error
        self.pageins += 1
        stage.kvpage_pageins.inc()
        stage.kvpage_pagein_wait.observe(value=time.perf_counter() - t0)
        self.last_assemble_s = ent.seconds
        return ent.k, ent.v, ent.n_valid

    def recycle(self, k: np.ndarray, v: np.ndarray) -> None:
        """Hand a taken segment's buffers back once they were copied out
        (at most ``2 * prefetch + 2`` are kept)."""
        with self._lock:
            if len(self._spare) < 2 * self.prefetch + 2:
                self._spare.append((k, v))

    def close(self) -> None:
        with self._wake:
            self._closed = True
            self._wake.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # ------------------------------------------------------------------
    def _assemble(self, hashes: Tuple[int, ...], layer: int
                  ) -> _Assembled:
        """Stack one segment's per-layer block slices into a fixed-shape
        staging buffer (padded to ``seg_pages``)."""
        t0 = time.perf_counter()
        host = self.tiered.host
        shape = (self.seg_pages,) + tuple(host.block_shape[1:])
        with self._lock:
            spare = self._spare.pop() if self._spare else None
        if spare is not None and spare[0].shape == shape:
            k, v = spare
        else:
            k = np.empty(shape, host.dtype)
            v = np.empty(shape, host.dtype)
        for i, h in enumerate(hashes):
            # straight into the segment's row: one copy out of the tier
            if self.tiered.peek_layer(h, layer, out=(k[i], v[i])) is None:
                raise KvPageMiss(
                    f"cold block {h:x} missing from every tier (layer "
                    f"{layer}); the pin discipline was violated")
        n = len(hashes)
        k[n:] = 0
        v[n:] = 0
        return _Assembled(k, v, n, ready=_DONE,
                          seconds=time.perf_counter() - t0)

    def _claimable(self, st: _LaneSched) -> bool:
        return (st.plan is not None and st.next < len(st.order)
                and st.next - st.taken < self.prefetch)

    def _pick_lane(self) -> Optional[int]:
        """Next lane to assemble for: round-robin starting after the
        last-served lane, skipping lanes that are plan-done or at their
        prefetch ceiling. One item per pick is the fairness unit."""
        lanes = sorted(self._lanes)
        if not lanes:
            return None
        start = 0
        for i, ln in enumerate(lanes):
            if ln > self._rr:
                start = i
                break
        for i in range(len(lanes)):
            ln = lanes[(start + i) % len(lanes)]
            if self._claimable(self._lanes[ln]):
                return ln
        return None

    def _run(self) -> None:
        while True:
            with self._wake:
                ln = self._pick_lane()
                while not self._closed and ln is None:
                    self._wake.wait()
                    ln = self._pick_lane()
                if self._closed:
                    return
                self._rr = ln
                st = self._lanes[ln]
                key = st.order[st.next]
                ent = _Assembled(None, None, 0)  # placeholder until built
                st.built[key] = ent
                st.next += 1
                self.claim_log.append((ln, key))
                self._wake.notify_all()   # a consumer may await the claim
                hashes = st.plan.hashes(key)
            try:
                built = self._assemble(hashes, layer=key[0])
                ent.k, ent.v, ent.n_valid = built.k, built.v, built.n_valid
                ent.seconds = built.seconds
                ent.error = None
            except Exception as e:  # noqa: BLE001 - delivered to take()
                ent.error = e
            finally:
                # if a new plan superseded this one mid-assembly, begin()
                # already discarded the stale entry — setting the
                # orphaned event is harmless
                ent.ready.set()


#: shared always-set event for inline (fault-path) assemblies
_DONE = threading.Event()
_DONE.set()
