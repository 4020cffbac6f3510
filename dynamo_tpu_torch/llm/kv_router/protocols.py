"""KV routing wire protocol: cache events and worker load metrics.

Every worker publishes a ``RouterEvent`` when its engine stores or evicts a
full KV block; routers fold these into a global prefix index. Hashes are the
xxh3 block/sequence hashes from ``dynamo_tpu_torch.llm.tokens``; the dict
forms are the JAX package's, so one router indexes workers of both.

Reference capability: lib/llm/src/kv_router/protocols.rs:42-121 (KvCacheEvent
Stored/Removed, ForwardPassMetrics).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Any, Dict, List, Optional

KV_EVENT_SUBJECT = "kv_events"
KV_HIT_RATE_SUBJECT = "kv-hit-rate"
LOAD_METRICS_ENDPOINT = "load_metrics"


@dataclass
class StoredBlock:
    block_hash: int      # chained sequence hash (globally identifying prefix)
    tokens_hash: int     # content-only hash of the block's tokens


@dataclass
class KvStoredEvent:
    blocks: List[StoredBlock]
    parent_hash: Optional[int] = None  # sequence hash of the preceding block
    # Adapter the blocks were computed under (0 = base model). The hash
    # chain itself is already lora-salted at its root (tokens.py
    # lora_chain_root) so same-tokens/different-adapter cannot alias; the
    # wire field preserves C-ABI parity (ref lib/bindings/c lib.rs:253-283)
    # and lets consumers audit or partition by adapter.
    lora_id: int = 0


@dataclass
class KvRemovedEvent:
    block_hashes: List[int]


@dataclass
class KvCacheEvent:
    event_id: int
    stored: Optional[KvStoredEvent] = None
    removed: Optional[KvRemovedEvent] = None

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"event_id": self.event_id}
        if self.stored is not None:
            d["stored"] = {
                "parent_hash": self.stored.parent_hash,
                "blocks": [asdict(b) for b in self.stored.blocks],
            }
            if self.stored.lora_id:
                d["stored"]["lora_id"] = self.stored.lora_id
        if self.removed is not None:
            d["removed"] = {"block_hashes": self.removed.block_hashes}
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "KvCacheEvent":
        stored = None
        removed = None
        if "stored" in d and d["stored"] is not None:
            stored = KvStoredEvent(
                blocks=[StoredBlock(**b) for b in d["stored"]["blocks"]],
                parent_hash=d["stored"].get("parent_hash"),
                lora_id=int(d["stored"].get("lora_id", 0)),
            )
        if "removed" in d and d["removed"] is not None:
            removed = KvRemovedEvent(block_hashes=list(d["removed"]["block_hashes"]))
        return cls(event_id=d["event_id"], stored=stored, removed=removed)


@dataclass
class RouterEvent:
    worker_id: int
    event: KvCacheEvent

    def to_dict(self) -> Dict[str, Any]:
        return {"worker_id": self.worker_id, "event": self.event.to_dict()}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RouterEvent":
        return cls(worker_id=d["worker_id"],
                   event=KvCacheEvent.from_dict(d["event"]))


@dataclass
class ForwardPassMetrics:
    """Per-worker capacity snapshot, scraped/aggregated by routers."""

    request_active_slots: float = 0.0
    request_total_slots: float = 0.0
    kv_active_blocks: float = 0.0
    kv_total_blocks: float = 0.0
    num_requests_waiting: float = 0.0
    gpu_cache_usage_perc: float = 0.0   # kept name for API familiarity
    gpu_prefix_cache_hit_rate: float = 0.0
    # speculative decoding: drafted-token acceptance rate (0 = spec off or
    # nothing proposed); lets the planner/router see whether a worker's
    # decode throughput is spec-amplified
    spec_accept_rate: float = 0.0
    # goodput (utils/roofline.py): analytic MFU / memory-bandwidth
    # utilization / achieved GB/s over the engine's recent dispatch window
    # — "how close to the hardware" per worker, scraped by the aggregator,
    # planner and dyntop alongside the capacity numbers above
    mfu: float = 0.0
    mbu: float = 0.0
    hbm_gbps: float = 0.0
    # byte-honest KV residency (llm/kvpage/): total KV working set in
    # bytes (device pool in use + the paged lane's pinned host blocks)
    # against device+host capacity. Slots price every request the same;
    # these price a 128k context at its true footprint, so the router's
    # bytes-pressure term steers work away from a worker whose tiers one
    # long request is consuming (0/0 on engines that predate the fields)
    kv_resident_bytes: float = 0.0
    kv_capacity_bytes: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ForwardPassMetrics":
        return cls(**{k: v for k, v in d.items()
                      if k in cls.__dataclass_fields__})

    @property
    def cache_usage(self) -> float:
        if self.kv_total_blocks:
            return self.kv_active_blocks / self.kv_total_blocks
        return self.gpu_cache_usage_perc


@dataclass
class KVHitRateEvent:
    worker_id: int
    isl_blocks: int       # input sequence length in blocks
    overlap_blocks: int   # blocks served from prefix cache

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "KVHitRateEvent":
        return cls(**d)
