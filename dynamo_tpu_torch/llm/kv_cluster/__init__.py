"""Cluster-wide KV cache sharing (the LMCache direction).

Sealed KV blocks were reusable only within one worker's own
device/host/disk tiers; this plane makes the cache a *cluster* resource:

- every worker publishes a lease-bound **registry record** of the sealed
  block hashes resident in its host/disk tiers (``registry.py``) under the
  ``kv-cluster`` keyspace family — dead owners' records vanish with their
  lease;
- every worker serves a ``kv_fetch`` data-plane endpoint streaming a
  requested prefix's blocks host-tier -> peer with the layer-major
  two-part codec (``fetch.py``), and fetches missing prefixes from the
  donor the router stamped on the request, overlapped against its
  dispatch queue with a bounded race that falls back to local recompute
  on timeout/owner death;
- the KV router scores **cluster** hits (local hit > peer hit > miss,
  weighted by measured transfer cost) and stamps the chosen donor on the
  routed request (``kv_router/scheduler.py`` + ``router.py``).

Grounded in LMCache and PRESERVE (PAPERS.md); see
docs/kv_cache_routing.md "Cluster-wide KV sharing".

The port's copy of the JAX package's plane: the same keys, records, wire
and knobs, so JAX and torch workers fetch from each other.
"""

from __future__ import annotations

import os

from .fetch import KV_FETCH_ENDPOINT, ClusterFetcher, fetch_prefix
from .registry import (ClusterOverlap, ClusterRecord, KvClusterIndex,
                       KvClusterPublisher, TransferCostModel, cluster_key,
                       cluster_prefix)
from .service import ClusterPrefetchEngine, KvClusterWorker


def enabled() -> bool:
    """``DYN_KV_CLUSTER=1``: workers publish registry records + serve/
    consume ``kv_fetch``; routers score cluster hits and stamp donors.
    Default off — the plane costs one host-tier mirror copy per sealed
    block and one lease-bound store key per worker."""
    return os.environ.get("DYN_KV_CLUSTER", "0").lower() in (
        "1", "true", "yes", "on")


__all__ = [
    "KV_FETCH_ENDPOINT", "ClusterFetcher", "fetch_prefix",
    "ClusterOverlap", "ClusterRecord", "KvClusterIndex",
    "KvClusterPublisher", "TransferCostModel", "cluster_key",
    "cluster_prefix", "ClusterPrefetchEngine", "KvClusterWorker",
    "enabled",
]
