"""CUDA card allocator for the local worker orchestrators.

Assigns each service worker a disjoint, CONTIGUOUS set of cards through
``CUDA_VISIBLE_DEVICES`` (the reference's GPU allocator,
deploy/dynamo/sdk/cli/allocator.py:35-101; the JAX package's counterpart
hands out ``TPU_VISIBLE_DEVICES``). Contiguity keeps a multi-card worker on
neighbouring device ids, which on an NVLink board are the cards one switch
joins.

A CPU grant (``n_chips == 0``, or ``platform='cpu'``) hides every card from
the worker with an empty ``CUDA_VISIBLE_DEVICES``: the worker picks its
device from ``--device``, not from the environment, so the caller passes
``--device`` :meth:`CudaAllocator.device`; a ``cuda`` worker started on a
CPU grant raises, as it must — there is no fallback to the CPU.

Beyond a bump allocator: per-allocation release (a restarted worker's cards
return to the pool instead of leaking until ``release_all``), best-fit
placement over free runs (limits fragmentation under churn), and
per-service placement tracking (``placements()`` — the disjointness
invariant is inspectable, not implicit).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List


class AllocationError(RuntimeError):
    pass


@dataclass
class Allocation:
    """One worker's card grant. ``env`` is what the worker process gets."""

    service: str
    chips: List[int]
    env: Dict[str, str] = field(default_factory=dict)


class CudaAllocator:
    """Hands out contiguous card ranges; ``platform='cpu'`` hands out CPU
    grants instead (no exclusivity needed)."""

    def __init__(self, total_chips: int = 4, platform: str = "cuda"):
        self.total = total_chips
        self.platform = platform
        self._free = set(range(total_chips))
        self._allocs: List[Allocation] = []

    # ------------------------------------------------------------------
    def _free_runs(self) -> List[List[int]]:
        """Maximal runs of contiguous free cards, ascending."""
        runs: List[List[int]] = []
        cur: List[int] = []
        for c in sorted(self._free):
            if cur and c == cur[-1] + 1:
                cur.append(c)
            else:
                if cur:
                    runs.append(cur)
                cur = [c]
        if cur:
            runs.append(cur)
        return runs

    def device(self, n_chips: int) -> str:
        """The ``--device`` of a worker granted ``n_chips`` cards here."""
        return "cpu" if n_chips <= 0 or self.platform == "cpu" else "cuda"

    def allocate(self, n_chips: int, service: str = "") -> Dict[str, str]:
        """Env for a worker needing ``n_chips`` cards (0 => a pure-CPU
        service; it must not initialize a card)."""
        return self.allocate_handle(n_chips, service=service).env

    def allocate_handle(self, n_chips: int, service: str = "") -> Allocation:
        """Like :meth:`allocate` but returns the :class:`Allocation` so the
        caller can :meth:`release` it individually (worker restart)."""
        if self.device(n_chips) == "cpu":
            return Allocation(service, [], {"CUDA_VISIBLE_DEVICES": ""})
        # best-fit: the smallest contiguous run that fits, so large future
        # requests keep a chance at the big runs
        candidates = [r for r in self._free_runs() if len(r) >= n_chips]
        if not candidates:
            raise AllocationError(
                f"need {n_chips} contiguous cards for {service or 'worker'}; "
                f"free runs: {[len(r) for r in self._free_runs()]} "
                f"of {self.total} total")
        run = min(candidates, key=len)
        chips = run[:n_chips]
        self._free.difference_update(chips)
        alloc = Allocation(service, chips, {
            "CUDA_VISIBLE_DEVICES": ",".join(map(str, chips))})
        self._allocs.append(alloc)
        return alloc

    def release(self, alloc: Allocation) -> None:
        """Return one worker's cards to the pool (restart path). Identity
        match, not equality: a re-grant of the same cards produces an
        EQUAL dataclass, and releasing a stale handle twice must not free
        the new owner's live grant."""
        for i, a in enumerate(self._allocs):
            if a is alloc:
                del self._allocs[i]
                self._free.update(alloc.chips)
                return

    def release_all(self) -> None:
        self._free = set(range(self.total))
        self._allocs.clear()

    def placements(self) -> Dict[str, List[List[int]]]:
        """service -> list of card sets currently granted (disjointness and
        contiguity are directly checkable by callers/tests)."""
        out: Dict[str, List[List[int]]] = {}
        for a in self._allocs:
            out.setdefault(a.service or "worker", []).append(list(a.chips))
        return out
