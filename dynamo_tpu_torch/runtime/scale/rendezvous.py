"""Rendezvous (highest-random-weight) hashing: stable worker→owner maps.

The observer tree assigns each worker to exactly one regional aggregator
by rendezvous hash over the live aggregator ids. The property that makes
this the right tool (vs modulo or a ring with few vnodes): when the
member set changes, ONLY the keys owned by the departed member move (a
join steals an even ~1/(n+1) slice from everyone) — so an aggregator
crash re-homes its workers without reshuffling anyone else's region, and
the per-region merged histograms stay continuous for every unaffected
worker.

Pure, stdlib-only, deterministic across processes and Python runs
(sha1, not ``hash()`` — PYTHONHASHSEED must not partition the fleet
differently per process).
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterable, List, Optional, Sequence


def _weight(worker_id: int, member: str) -> int:
    h = hashlib.sha1(f"{worker_id:x}\x00{member}".encode())
    return int.from_bytes(h.digest()[:8], "big")


def rendezvous_owner(worker_id: int,
                     members: Sequence[str]) -> Optional[str]:
    """The member that owns ``worker_id`` — highest hash weight wins,
    ties broken by member name so every process agrees. None when the
    member set is empty."""
    best: Optional[str] = None
    best_w = -1
    for m in members:
        w = _weight(worker_id, m)
        if w > best_w or (w == best_w and (best is None or m < best)):
            best, best_w = m, w
    return best


def rendezvous_shares(worker_ids: Iterable[int],
                      members: Sequence[str]) -> Dict[str, List[int]]:
    """Partition ``worker_ids`` across ``members``: {member: owned ids}.
    Every member appears in the result (possibly with an empty slice)."""
    out: Dict[str, List[int]] = {m: [] for m in members}
    if not members:
        return out
    for wid in worker_ids:
        owner = rendezvous_owner(wid, members)
        out[owner].append(wid)
    return out
