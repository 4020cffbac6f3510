"""Host-side paged KV cache bookkeeping for the torch engine.

The device tensors (``k_pool``/``v_pool``: [L, H_kv, n_pages, page, D_h]) are
a head-major pool of fixed-size pages; a flat token slot
``page_id * page_size + offset`` addresses one token's KV. This module owns
the *maps*: per-sequence page tables and the token-slot indices the forward
passes scatter to and gather from. Page states (free/leased) live in
:class:`~dynamo_tpu_torch.llm.kvbm.pool.DeviceBlockPool`.

Prefix reuse is off in this port: released pages go straight back to the
free list. Reuse needs the xxh3-64 block-hash chain that the KV router shares
across workers, which comes with the router.

Reference capability: the engine-side half of the KV block manager
(lib/llm/src/kv/manager.rs:22-138 prepare_prefill_sequence).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..llm.kvbm.pool import DeviceBlockPool


class OutOfPages(RuntimeError):
    pass


@dataclass
class SeqCache:
    """Per-sequence cache state: owned pages + token count."""

    seq_id: str
    pages: List[int] = field(default_factory=list)
    num_tokens: int = 0


class PagePool:
    """Sequence bookkeeping over a :class:`DeviceBlockPool`.

    Page 0 is reserved as the scratch page: padded lanes write there, so
    every dispatch has static shapes with no host branching.
    """

    def __init__(self, num_pages: int, page_size: int):
        self.num_pages = num_pages
        self.page_size = page_size
        self.blocks = DeviceBlockPool(num_pages)
        self.seqs: Dict[str, SeqCache] = {}

    # ------------------------------------------------------------------
    @property
    def free_pages(self) -> int:
        """Pages a new allocation could obtain."""
        return self.blocks.allocatable

    def pages_needed(self, num_tokens: int) -> int:
        return (num_tokens + self.page_size - 1) // self.page_size

    def can_admit(self, prompt_tokens: int) -> bool:
        return self.free_pages >= self.pages_needed(prompt_tokens)

    # ------------------------------------------------------------------
    def create(self, seq_id: str) -> SeqCache:
        if seq_id in self.seqs:
            raise ValueError(f"sequence {seq_id} already exists")
        sc = SeqCache(seq_id)
        self.seqs[seq_id] = sc
        return sc

    def ensure_pages(self, seq_id: str, total_tokens: int) -> None:
        """Pre-allocate pages so the sequence can hold ``total_tokens`` (used
        before a multi-step decode dispatch writes tokens speculatively)."""
        sc = self.seqs[seq_id]
        need = self.pages_needed(total_tokens) - len(sc.pages)
        if need > self.blocks.allocatable:
            raise OutOfPages(
                f"need {need} pages, {self.blocks.allocatable} allocatable")
        for _ in range(need):
            sc.pages.append(self.blocks.lease_new())

    def account_tokens(self, seq_id: str, tokens: Sequence[int]) -> None:
        """Record tokens as present (pages must already exist)."""
        self.seqs[seq_id].num_tokens += len(tokens)

    def extend(self, seq_id: str, tokens: Sequence[int]) -> None:
        """Allocate-and-account in one call (prefill path)."""
        self.ensure_pages(seq_id, self.seqs[seq_id].num_tokens + len(tokens))
        self.account_tokens(seq_id, tokens)

    def release(self, seq_id: str) -> None:
        """Drop the sequence; its pages return to the free list."""
        sc = self.seqs.pop(seq_id, None)
        if sc is None:
            return
        for page in sc.pages:
            self.blocks.release(page)

    # ------------------------------------------------------------------
    # index computation for the forward passes
    # ------------------------------------------------------------------
    def write_slots(self, seq_id: str, start_token: int, count: int) -> np.ndarray:
        """Pool token-slot index for tokens [start, start+count) of a seq."""
        sc = self.seqs[seq_id]
        t = np.arange(start_token, start_token + count)
        pages = np.asarray(sc.pages, dtype=np.int32)
        return pages[t // self.page_size] * self.page_size + t % self.page_size

    def page_table_row(self, seq_id: str, padded_pages: int) -> np.ndarray:
        """This sequence's page ids padded (with scratch page 0) to a static
        width — the page-table row the paged decode kernel reads."""
        sc = self.seqs[seq_id]
        row = np.zeros(padded_pages, dtype=np.int32)
        n = min(len(sc.pages), padded_pages)
        row[:n] = sc.pages[:n]
        return row

    def read_slots(self, seq_id: str, length: int, padded: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(slots, positions, valid) arrays of static length ``padded``
        covering tokens [0, length); padding points at scratch page 0."""
        slots = np.zeros(padded, dtype=np.int32)
        pos = np.zeros(padded, dtype=np.int32)
        valid = np.zeros(padded, dtype=bool)
        n = min(length, padded)
        if n:
            slots[:n] = self.write_slots(seq_id, 0, n)
            pos[:n] = np.arange(n)
            valid[:n] = True
        return slots, pos, valid
