"""Scale plane: what keeps the coordination layer flat as the fleet grows.

Two parts (docs/observability.md § "Scale plane"):

- :mod:`regions` — the hierarchical observer tree. Regional aggregator
  daemons (``cli/aggregator.py``) each own a rendezvous-hashed slice of
  the fleet's workers, pre-merge their per-worker telemetry, and publish
  ONE lease-bound region record per tick; every observer (planner,
  SLO monitor, dyntop, ``fetch_stage_states``) reads R region records
  instead of N worker dumps, and falls back to the flat scrape when no
  aggregator is running (zero-config single-node behavior unchanged).
- :mod:`shards` — the store itself split by keyspace family.
  :class:`~.shards.ShardedStoreClient` routes every key-bearing call
  through ``keyspace.classify_key()`` to the owning dynstore process
  (static ``DYN_STORE_SHARDS`` map); a shard being down degrades only
  its families.
"""

from .rendezvous import rendezvous_owner, rendezvous_shares  # noqa: F401
from .shards import (  # noqa: F401
    ShardedStoreClient,
    make_store_client,
    parse_shard_map,
)
