"""Model mobility plane: weight prefetch + in-place hot-swap.

PRESERVE-style (arXiv 2501.08192) seconds-scale model wake: candidate
models' weights prefetch into a pinned host-RAM cache while the current
model serves, and a swap command turns a draining worker into a serving
replica of a sibling model without process restart — and, when the
sibling shares the shape signature, by overwriting the weight tensors in
place: no tensor moves, no kernel is rebuilt, and the device never holds
a second copy of the weights.

- :mod:`.weightcache` — pinned host-RAM LRU over ``DYN_WEIGHT_CACHE_BYTES``
- :mod:`.swap`        — shape-signature gate + engine hot-swap
- :mod:`.agent`       — worker-side store watcher executing swap commands
- :mod:`.keys`        — the ``mobility/`` keyspace family's helpers
"""

from .agent import EngineRef, MobilityAgent
from .keys import (mobility_prefetch_key, mobility_prefix,
                   mobility_swap_key, mobility_wake_key,
                   mobility_wake_prefix)
from .swap import SwapError, SwapOutcome, hot_swap, swap_signature
from .weightcache import WeightCache

__all__ = [
    "EngineRef", "MobilityAgent", "WeightCache", "SwapError",
    "SwapOutcome", "hot_swap", "swap_signature",
    "mobility_prefetch_key", "mobility_prefix", "mobility_swap_key",
    "mobility_wake_key", "mobility_wake_prefix",
]
