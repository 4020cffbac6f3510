"""Global sealed-block registry: who holds which KV prefix, cluster-wide.

Each worker publishes ONE lease-bound record under the ``kv-cluster``
keyspace family (``kv_cluster/{ns}/{component}/{worker_id:x}``): its tier
geometry plus the sealed sequence hashes resident in its host and disk
tiers. Publishing is seal/evict-driven and write-coalesced the same way
stage metrics flow: the tiered cache's ``on_change`` hook marks the
publisher dirty from the engine thread, and the publish loop writes at
most one store put per ``DYN_KV_CLUSTER_PUBLISH_INTERVAL`` — and only
when the record actually changed. Lease binding is the liveness story:
a dead owner's record vanishes with its lease, so readers never chase
KV on a corpse.

Readers (:class:`KvClusterIndex`) watch the prefix and answer "which live
workers hold the first N blocks of this hash chain" — the router's
cluster-hit input. :class:`TransferCostModel` turns the merged
``llm_kv_transfer`` histograms into a peer-block score weight so a cheap
fetch scores close to a local hit and an expensive one close to a miss.

The port's copy of the JAX package's ``llm/kv_cluster/registry.py``: the
same keys and record bytes, so JAX and torch workers share one registry.
A record's ``dtype`` is the wire name of the tier's blocks
(:func:`~..kv_transfer.wire_dtype_name`): the port keeps bf16 host blocks
as ``uint16`` bits and still publishes ``"bfloat16"``, as a JAX worker
does.
"""

from __future__ import annotations

import asyncio
import json
import logging
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from ...utils.knobs import env_float

log = logging.getLogger("dynamo_tpu_torch.kv_cluster")

KV_CLUSTER_PREFIX = "kv_cluster/"


def cluster_prefix(namespace: str) -> str:
    """Watch prefix covering every worker record of a namespace."""
    return f"{KV_CLUSTER_PREFIX}{namespace}/"


def cluster_key(namespace: str, component: str, worker_id: int) -> str:
    """The one record a worker owns (lease-bound; dies with the owner)."""
    return f"{cluster_prefix(namespace)}{component}/{worker_id:x}"


@dataclass
class ClusterRecord:
    """One worker's registry entry: geometry + resident hashes per tier."""

    worker_id: int
    component: str = ""
    #: {"layers", "kv_heads", "page", "head_dim", "dtype"} — what a block
    #: of this owner physically is; fetch receivers validate against it
    geometry: Dict[str, Any] = field(default_factory=dict)
    host: List[int] = field(default_factory=list)
    disk: List[int] = field(default_factory=list)
    seq: int = 0

    def __post_init__(self) -> None:
        self._have = frozenset(self.host) | frozenset(self.disk)
        self._host_set = frozenset(self.host)

    @property
    def block_count(self) -> int:
        return len(self._have)

    def holds(self, seq_hash: int) -> bool:
        return seq_hash in self._have

    def tier_of(self, seq_hash: int) -> Optional[str]:
        if seq_hash in self._host_set:
            return "host"
        if seq_hash in self._have:
            return "disk"
        return None

    def block_bytes(self) -> int:
        """Approximate wire bytes of one block (k + v) from the geometry;
        0 when the geometry is unknown (pre-first-publish or foreign)."""
        from ..kv_transfer import KvStreamError, wire_dtype

        g = self.geometry
        try:
            elems = (int(g["layers"]) * int(g["kv_heads"]) * int(g["page"])
                     * int(g["head_dim"]))
            return 2 * elems * wire_dtype(g["dtype"]).itemsize
        except (KeyError, TypeError, ValueError, KvStreamError):
            return 0

    def to_bytes(self) -> bytes:
        return json.dumps({
            "worker_id": self.worker_id, "component": self.component,
            "geometry": self.geometry, "host": self.host,
            "disk": self.disk, "seq": self.seq}).encode()

    @classmethod
    def from_bytes(cls, b: bytes) -> "ClusterRecord":
        d = json.loads(b.decode())
        return cls(worker_id=int(d["worker_id"]),
                   component=d.get("component", ""),
                   geometry=dict(d.get("geometry") or {}),
                   host=[int(h) for h in d.get("host", [])],
                   disk=[int(h) for h in d.get("disk", [])],
                   seq=int(d.get("seq", 0)))


def tier_geometry(tiered) -> Dict[str, Any]:
    """The record geometry of a :class:`~..kvbm.tiers.TieredKvCache`
    (``dtype`` is the wire name: ``"bfloat16"`` for ``uint16`` blocks)."""
    from ..kv_transfer import wire_dtype_name

    L, H, P, D = tiered.host.block_shape
    return {"layers": int(L), "kv_heads": int(H), "page": int(P),
            "head_dim": int(D), "dtype": wire_dtype_name(tiered.host.dtype)}


class KvClusterPublisher:
    """Worker-side: keep this worker's registry record fresh.

    Seal/evict-driven: the tiered cache's ``on_change`` hook (engine
    thread) marks the publisher dirty; the asyncio loop coalesces writes
    to one put per interval, and only when the record's content changed
    — an idle worker writes nothing. The key rides the worker's liveness
    lease, so no tombstone protocol is needed.
    """

    def __init__(self, store, namespace: str, component: str,
                 worker_id: int, lease: int, tiered,
                 interval: Optional[float] = None):
        self.store = store
        self.namespace = namespace
        self.component = component
        self.worker_id = worker_id
        self.lease = lease
        self.tiered = tiered
        self.interval = env_float("DYN_KV_CLUSTER_PUBLISH_INTERVAL", 1.0,
                                  minimum=0.0) \
            if interval is None else float(interval)
        self._geometry = tier_geometry(tiered)
        self._dirty: Optional[asyncio.Event] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._task: Optional[asyncio.Task] = None
        self._last: Optional[bytes] = None
        self._seq = 0
        self.published = 0

    def _mark_dirty(self) -> None:
        """Engine-thread hook target (tiered.on_change)."""
        loop, ev = self._loop, self._dirty
        if loop is not None and ev is not None:
            try:
                loop.call_soon_threadsafe(ev.set)
            except RuntimeError:
                pass   # loop closed mid-shutdown; nothing left to publish

    async def start(self) -> "KvClusterPublisher":
        self._loop = asyncio.get_running_loop()
        self._dirty = asyncio.Event()
        self.tiered.on_change = self._mark_dirty
        # initial record: peers must see this worker exists (possibly with
        # zero blocks) so donor-death detection is watch-driven
        await self.publish(force=True)
        self._task = asyncio.create_task(self._run(),
                                         name="kv-cluster-publish")
        return self

    async def publish(self, force: bool = False) -> str:
        """One publish beat: ``"put"`` or ``"skipped"`` (unchanged)."""
        host, disk = self.tiered.hashes()
        rec = ClusterRecord(self.worker_id, self.component, self._geometry,
                            host, disk, seq=self._seq + 1)
        payload = rec.to_bytes()
        # compare content minus the seq counter: the seq only advances on
        # a real write, so an unchanged tier set stays genuinely silent
        body = (tuple(sorted(host)), tuple(sorted(disk)))
        if not force and self._last == body:
            return "skipped"
        await self.store.put(
            cluster_key(self.namespace, self.component, self.worker_id),
            payload, lease=self.lease)
        self._last = body
        self._seq += 1
        self.published += 1
        return "put"

    async def _run(self) -> None:
        assert self._dirty is not None
        while True:
            if self.interval > 0:
                try:
                    await asyncio.wait_for(self._dirty.wait(),
                                           timeout=self.interval)
                except asyncio.TimeoutError:
                    continue   # nothing sealed/evicted: no write, no work
            else:
                # interval 0 = no coalescing: publish per change, but park
                # on the event while idle (wait_for(timeout=0) would spin)
                await self._dirty.wait()
            self._dirty.clear()
            try:
                await self.publish()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 - keep the pump alive
                log.debug("kv-cluster publish deferred (%s); retrying", e)
                self._dirty.set()
                # bound the retry rate even at interval=0: a fast-failing
                # store put must not become a hot RPC loop
                await asyncio.sleep(max(self.interval, 0.5))
                continue
            # coalesce: at most one store write per interval even under a
            # seal storm (prefill bursts seal hundreds of blocks/s)
            await asyncio.sleep(self.interval)

    async def stop(self) -> None:
        self.tiered.on_change = None
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        # best-effort: the lease reaps the key anyway, but a worker that
        # exits while its runtime lives on should vanish promptly
        try:
            await self.store.delete(cluster_key(
                self.namespace, self.component, self.worker_id))
        except Exception:  # noqa: BLE001 - cleanup must never mask exit
            log.debug("kv-cluster key cleanup failed", exc_info=True)


@dataclass
class ClusterOverlap:
    """Cluster-wide prefix availability for one request's hash chain.

    ``owners`` maps worker id -> consecutive prefix blocks that worker
    holds in its host/disk tiers (cluster view; a worker's *device*
    blocks are the indexer's ``OverlapScores``, not this). ``weight`` is
    the score value of one peer block relative to one local block
    (:meth:`TransferCostModel.weight`).

    When the router arms the pair-aware cost model, ``pair_weight`` /
    ``pair_seconds`` are callables ``(src_wid, dst_wid, blocks) ->
    float`` over the measured per-(src,dst) bandwidth: donor election
    then maximizes transfer-cost-weighted *gain* instead of raw block
    count (a near donor with fewer blocks can beat a far donor with
    more), and scoring charges the chosen placement its expected
    transfer seconds.
    """

    owners: Dict[int, int] = field(default_factory=dict)
    weight: float = 0.5
    #: (src_wid, dst_wid, blocks) -> per-block score weight for that pair
    pair_weight: Optional[Any] = None
    #: (src_wid, dst_wid, blocks) -> expected transfer seconds
    pair_seconds: Optional[Any] = None
    #: (src_wid, dst_wid) -> ledger provenance of the bandwidth behind
    #: the charged transfer term ("pair"|"into_dst"|"fleet"|"default")
    pair_source: Optional[Any] = None

    @property
    def blocks(self) -> int:
        """Best consecutive prefix length available anywhere."""
        return max(self.owners.values(), default=0)

    def weight_for(self, src: int, dst: Optional[int], blocks: int) -> float:
        if self.pair_weight is not None and dst is not None:
            return float(self.pair_weight(src, dst, blocks))
        return self.weight

    def seconds_for(self, src: int, dst: Optional[int],
                    blocks: int) -> float:
        if self.pair_seconds is not None and dst is not None:
            return float(self.pair_seconds(src, dst, blocks))
        return 0.0

    def source_for(self, src: int, dst: Optional[int]) -> str:
        """Ledger provenance of the bandwidth the charged transfer term
        was priced from ('' without an armed cost model)."""
        if self.pair_source is not None and dst is not None:
            return str(self.pair_source(src, dst))
        return ""

    def donor_for(self, worker_id: Optional[int], local_blocks: int
                  ) -> Tuple[Optional[int], int]:
        """Best donor for ``worker_id``: the OTHER owner whose extra
        consecutive blocks beyond the worker's local coverage are worth
        the most — raw block count without a cost model, transfer-cost-
        weighted gain (``extra x pair_weight``) with one, so the
        election prices the network pair, not just the prefix length."""
        best, best_n, best_gain = None, 0, 0.0
        for wid, n in self.owners.items():
            if wid == worker_id:
                continue
            extra = n - local_blocks
            if extra <= 0:
                continue
            gain = extra * self.weight_for(wid, worker_id, extra)
            if best is None or gain > best_gain + 1e-12:
                best, best_n, best_gain = wid, n, gain
        return best, best_n


class KvClusterIndex:
    """Router/operator-side registry reader: watches the ``kv-cluster``
    prefix and answers prefix-availability queries. Owner records vanish
    with their lease (store watch delivers the delete), so a dead donor
    disappears from scoring within one watch delivery."""

    def __init__(self):
        self.records: Dict[int, ClusterRecord] = {}
        self._key_owner: Dict[str, int] = {}
        # set only during start(): keys touched by live watch events while
        # the watch-registration RPC was in flight
        self._live_touched: Optional[Set[str]] = None

    async def start(self, store, namespace: str) -> "KvClusterIndex":
        # Live watch events can fire DURING the watch_prefix await, before
        # the (older) snapshot is applied — most dangerously a lease-death
        # delete, which has no later event to correct it. Record which keys
        # the live stream touched and never let the stale snapshot
        # overwrite (or resurrect) them.
        self._live_touched = set()
        snapshot = await store.watch_prefix(cluster_prefix(namespace),
                                            self._on_change)
        touched, self._live_touched = self._live_touched, None
        for key, value in snapshot:
            if key in touched:
                continue
            await self._on_change(key, value, False)
        return self

    async def _on_change(self, key: str, value: Optional[bytes],
                         deleted: bool) -> None:
        if self._live_touched is not None:
            self._live_touched.add(key)
        if deleted:
            wid = self._key_owner.pop(key, None)
            if wid is not None:
                self.records.pop(wid, None)
            return
        try:
            rec = ClusterRecord.from_bytes(value)
        except (ValueError, KeyError, TypeError):
            log.warning("malformed kv-cluster record at %s", key)
            return
        self.records[rec.worker_id] = rec
        self._key_owner[key] = rec.worker_id

    def remove_worker(self, worker_id: int) -> None:
        self.records.pop(worker_id, None)

    def find(self, seq_hashes: Sequence[int], weight: float = 0.5,
             component: Optional[str] = None) -> ClusterOverlap:
        """Per-owner consecutive prefix coverage of a hash chain.
        ``component`` restricts owners to one worker component — a donor
        from another component (disagg prefill pool, another model) is
        unreachable through the receiver's fetch client and must not be
        elected or credited in scoring."""
        out = ClusterOverlap(weight=weight)
        for wid, rec in self.records.items():
            if component is not None and rec.component != component:
                continue
            n = 0
            for h in seq_hashes:
                if not rec.holds(h):
                    break
                n += 1
            if n:
                out.owners[wid] = n
        return out

    def block_bytes(self, worker_id: int) -> int:
        rec = self.records.get(worker_id)
        return rec.block_bytes() if rec is not None else 0

    def any_block_bytes(self) -> int:
        for rec in self.records.values():
            b = rec.block_bytes()
            if b:
                return b
        return 0


class TransferCostModel:
    """KV-movement cost estimates from measured transfer bandwidth —
    fleet-wide AND per-(src,dst) worker pair.

    The router already merges every worker's ``llm_kv_transfer_seconds``
    histogram and ``llm_kv_transfer_bytes_total`` counter;
    :meth:`update_from_states` differentiates them into a fleet-wide
    observed bytes/s, and additionally reads the receiver-side
    ``llm_kv_pair_bw_bytes_per_s`` gauges (EWMA per pair, see
    ``kv_transfer.observe_pair_bw``) so a placement can be priced on the
    SPECIFIC network pair it would move bytes over — NetKV's point:
    decode selection must price the pair, not just the load.

    :meth:`weight` discounts a peer block by the estimated fetch time:
    ``base / (1 + est_seconds)`` — a free fetch is worth
    ``DYN_KV_CLUSTER_PEER_WEIGHT`` of a local block, a one-second fetch
    half that, never zero (a peer hit always beats recompute in score).
    :meth:`estimate_seconds` is the raw expected-transfer-seconds term
    ``score_candidates`` folds into the logit.
    """

    #: assumed bandwidth before any transfer has been measured (loopback
    #: host staging comfortably exceeds this; DCN is in the same decade)
    DEFAULT_BYTES_PER_S = 1e9

    def __init__(self, base_weight: Optional[float] = None):
        self.base = env_float("DYN_KV_CLUSTER_PEER_WEIGHT", 0.5,
                              minimum=0.0) \
            if base_weight is None else float(base_weight)
        self.bytes_per_s: Optional[float] = None
        #: (src_hex, dst_hex) -> observed bytes/s; src ``"q"`` is the
        #: anonymous prefill pool (disagg pushes without a worker id)
        self.pair_bw: Dict[Tuple[str, str], float] = {}

    def update_from_states(self, states) -> None:
        """Fold a ``fetch_stage_states`` result into the bandwidth
        estimates (lifetime totals for the fleet-wide rate, last-EWMA
        gauges for the pairs)."""
        secs = 0.0
        byts = 0.0
        pairs: Dict[Tuple[str, str], float] = {}
        for _component, dump in states:
            h = dump.get("llm_kv_transfer_seconds") or {}
            for val in (h.get("series") or {}).values():
                secs += float(val.get("sum", 0.0))
            c = dump.get("llm_kv_transfer_bytes_total") or {}
            for val in (c.get("series") or {}).values():
                byts += float(val)
            g = dump.get("llm_kv_pair_bw_bytes_per_s") or {}
            for skey, val in (g.get("series") or {}).items():
                labels = skey.split("\x1f")
                if len(labels) == 2 and float(val) > 0:
                    pairs[(labels[0], labels[1])] = float(val)
        if secs > 0 and byts > 0:
            self.bytes_per_s = byts / secs
        if pairs:
            self.pair_bw = pairs

    @staticmethod
    def _hex(wid) -> Optional[str]:
        if wid is None:
            return None
        return wid if isinstance(wid, str) else f"{wid:x}"

    def bandwidth_info(self, src=None, dst=None) -> Tuple[float, str]:
        """Best-informed bytes/s for a (src, dst) movement plus its
        ledger provenance: ``"pair"`` (the exact pair's EWMA — fed by
        every flow kind the byte-flow ledger records over that pair),
        ``"into_dst"`` (mean of observed pairs INTO ``dst``; a disagg
        push's source is the anonymous prefill pool), ``"fleet"`` (the
        fleet-wide differentiated rate) or ``"default"`` (nothing
        measured yet). The provenance string is stamped into the
        router's decision ring so a charged transfer term is auditable
        back to what the ledger had actually seen."""
        s, d = self._hex(src), self._hex(dst)
        if s is not None and d is not None:
            bw = self.pair_bw.get((s, d))
            if bw:
                return bw, "pair"
        if d is not None:
            into = [bw for (_, dk), bw in self.pair_bw.items() if dk == d]
            if into:
                return sum(into) / len(into), "into_dst"
        if self.bytes_per_s:
            return self.bytes_per_s, "fleet"
        return self.DEFAULT_BYTES_PER_S, "default"

    def bandwidth(self, src=None, dst=None) -> float:
        return self.bandwidth_info(src, dst)[0]

    def estimate_seconds(self, blocks: int, block_bytes: int,
                         src=None, dst=None) -> float:
        bw = self.bandwidth(src, dst)
        return (blocks * block_bytes) / bw if bw > 0 else 0.0

    def weight(self, blocks: int, block_bytes: int,
               src=None, dst=None) -> float:
        return self.base / (1.0 + self.estimate_seconds(
            blocks, block_bytes, src=src, dst=dst))
