"""Peer-to-peer prefix fetch: the cluster plane's data path.

Donor side: every worker serves ``kv_fetch`` — given a chained-hash list,
it streams the longest *consecutive* prefix of those blocks resident in
its host/disk tiers, using the same layer-major two-part codec as
prefill->decode KV transfer (``llm/kv_transfer.py``): one JSON meta item
(block count + geometry + served hashes) followed by 2·L binary parts —
layer k then layer v, blocks concatenated along the token axis — so the
receiver can deposit layer l while layer l+1 is in flight. Serving reads
through ``TieredKvCache.peek`` (no LRU perturbation, copies under the
tier lock) on the asyncio thread while the engine thread keeps serving.

Receiver side (:class:`ClusterFetcher`): a routed request arrives stamped
with the donor the router elected (``BackendInput.kv_donor``). Before the
request enters the engine, the worker fetches the prefix blocks it is
missing locally into its OWN host tier, racing client-stop, the request
deadline and ``DYN_KV_CLUSTER_FETCH_TIMEOUT`` — the ``await_remote_kv``
shape. On success, admission's normal host-tier restore uploads the pages
with zero prefill recompute of the shared blocks; on timeout/donor
death/error the request simply prefills locally (counted in
``dyn_kv_cluster_fallbacks_total``), never hangs.

The port's copy of the JAX package's ``llm/kv_cluster/fetch.py``, with the
same request, meta and parts on the wire. Blocks travel under their wire
dtype name (:func:`~..kv_transfer.wire_dtype_name`): a bf16 block is
``uint16`` bits on the port's side and ``"bfloat16"`` on the wire, so a JAX
donor feeds a torch receiver and the reverse, byte for byte.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from typing import AsyncIterator, List, Optional, Sequence, Tuple

import numpy as np

from ...obs.flows import record_flow
from ...runtime import deadline as dl
from ...runtime.engine import Context
from ...utils.knobs import env_float
from ...utils.prometheus import stage_metrics
from ...utils.tracing import get_tracer
from ..kv_transfer import LayerStream, wire_dtype, wire_dtype_name

log = logging.getLogger("dynamo_tpu_torch.kv_cluster")

KV_FETCH_ENDPOINT = "kv_fetch"


def max_fetch_blocks() -> int:
    """``DYN_KV_CLUSTER_MAX_BLOCKS``: cap on blocks per peer fetch
    (0 = unlimited). Bounds both the donor's response and the receiver's
    request — one fetch moves at most this much host memory."""
    return int(env_float("DYN_KV_CLUSTER_MAX_BLOCKS", 0, minimum=0.0))


def make_kv_fetch_handler(tiered, worker_id: int = 0):
    """Donor endpoint handler over a :class:`TieredKvCache`.
    ``worker_id`` is the donor's own lease id — the ledger's src
    endpoint for the bytes this handler puts on the wire."""
    src = f"{worker_id:x}" if worker_id else str(os.getpid())

    async def handler(request, ctx: Context) -> AsyncIterator:
        hashes = [int(h) for h in (request or {}).get("hashes", [])]
        # receiver identity rides the request so the donor's tx flow
        # names the pair it served (absent on old callers -> "q")
        receiver = str((request or {}).get("receiver") or "q")
        cap = max_fetch_blocks()
        if cap:
            hashes = hashes[:cap]
        blocks: List[Tuple[int, np.ndarray, np.ndarray]] = []
        for h in hashes:
            got = tiered.peek(h)
            if got is None:
                break   # consecutive-prefix property: stop at first miss
            blocks.append((h, got[0], got[1]))
        if not blocks:
            yield {"blocks": 0}
            return
        L, H, P, D = blocks[0][1].shape
        dtype = blocks[0][1].dtype
        yield {"blocks": len(blocks), "layers": int(L), "kv_heads": int(H),
               "page": int(P), "head_dim": int(D),
               "dtype": wire_dtype_name(dtype),
               "hashes": [h for h, _, _ in blocks]}
        nbytes = 0
        t0 = time.monotonic()
        for layer in range(L):
            for part_idx in (1, 2):   # k then v, layer-major
                arr = np.concatenate(
                    [b[part_idx][layer] for b in blocks], axis=1)
                part = arr.tobytes()
                nbytes += len(part)
                yield part
        stage = stage_metrics()
        elapsed = time.monotonic() - t0
        stage.kv_transfer.observe("cluster_send", value=elapsed)
        stage.kv_transfer_bytes.inc("cluster_send", amount=nbytes)
        record_flow("kv_fetch_tx", nbytes, elapsed,
                    src=src, dst=receiver)

    return handler


async def fetch_prefix(client, donor_id: int, hashes: Sequence[int],
                       context: Optional[Context] = None,
                       receiver_id: Optional[int] = None
                       ) -> List[Tuple[int, np.ndarray, np.ndarray]]:
    """Pull the consecutive prefix of ``hashes`` from ``donor_id``'s
    tiers. Returns ``[(seq_hash, k, v)]`` ([L,Hkv,page,Dh] each); empty
    when the donor no longer holds the first block.

    Arrivals stream through the shared :class:`~..kv_transfer.
    LayerStream` assembler: each layer part is scattered into the
    per-block output arrays the moment it lands (while layer l+1 is
    still in flight), the codec (order/count) is validated by the one
    implementation both receive paths share, and the observed
    (donor → this worker) bandwidth feeds the router's per-pair
    transfer-cost estimate. A bf16 prefix arrives as ``uint16`` bits."""
    stage = stage_metrics()
    t0 = time.monotonic()
    meta = None
    stream: Optional[LayerStream] = None
    blocks_k = blocks_v = None
    nbytes = 0
    async with get_tracer().span("kv_cluster.fetch",
                                 donor=f"{donor_id:x}",
                                 blocks_requested=len(hashes)):
        req = {"hashes": list(hashes)}
        if receiver_id:
            req["receiver"] = f"{receiver_id:x}"
        async for item in client.generate(req, context, mode="direct",
                                          instance_id=donor_id):
            if meta is None:
                meta = item
                if not meta.get("blocks"):
                    return []
                n, L = int(meta["blocks"]), int(meta["layers"])
                H, P, D = (int(meta["kv_heads"]), int(meta["page"]),
                           int(meta["head_dim"]))
                dtype = wire_dtype(meta["dtype"])
                blocks_k = np.empty((n, L, H, P, D), dtype)
                blocks_v = np.empty((n, L, H, P, D), dtype)

                def sink(layer, ka, va, _n=n, _P=P):
                    # one concatenated [H, n*P, D] layer -> that layer's
                    # slice of every per-block output array
                    for i in range(_n):
                        blocks_k[i, layer] = ka[:, i * _P:(i + 1) * _P]
                        blocks_v[i, layer] = va[:, i * _P:(i + 1) * _P]
                stream = LayerStream(L, sink)
            else:
                stream.feed(np.frombuffer(item, dtype).reshape(
                    H, int(meta["blocks"]) * P, D))
                nbytes += len(item)
    if meta is None:
        return []
    stream.close()   # truncated stream -> typed KvStreamError
    out: List[Tuple[int, np.ndarray, np.ndarray]] = []
    for i, h in enumerate(meta["hashes"][:int(meta["blocks"])]):
        out.append((int(h), blocks_k[i], blocks_v[i]))
    elapsed = time.monotonic() - t0
    stage.kv_transfer.observe("cluster_recv", value=elapsed)
    stage.kv_transfer_bytes.inc("cluster_recv", amount=nbytes)
    stage.kv_cluster_fetch_seconds.observe(value=elapsed)
    # ledger feeds observe_pair_bw itself: cluster-fetch traffic prices
    # the (donor -> receiver) pair exactly like disagg streams do
    record_flow("kv_fetch_rx", nbytes, elapsed, src=f"{donor_id:x}",
                dst=f"{receiver_id:x}" if receiver_id else "0",
                trace_id=context.id if context is not None else None)
    return out


class ClusterFetcher:
    """Receiver-side prefix prefetch for donor-stamped requests."""

    def __init__(self, core, client, worker_id: int,
                 timeout: Optional[float] = None):
        self.core = core
        self.client = client
        self.worker_id = worker_id
        self.timeout = env_float("DYN_KV_CLUSTER_FETCH_TIMEOUT", 5.0,
                                 minimum=0.0) \
            if timeout is None else float(timeout)

    def _missing_hashes(self, request) -> List[int]:
        """The chained hashes of the prefix blocks this worker lacks
        locally (device pool + tiers), up to the router's donor stamp."""
        from ..tokens import compute_seq_hashes

        tiered = self.core.tiered
        page = self.core.pool.page_size
        salt = request.kv_salt or request.lora_id
        # read-only probe: pool.contains + the tier's (locked) membership
        local = self.core.pool.probe_prefix(
            request.token_ids,
            (lambda h: h in tiered) if tiered is not None else None,
            lora_id=salt)
        hashes = compute_seq_hashes(request.token_ids, page, lora_id=salt)
        want = min(int(request.kv_donor_blocks) or len(hashes), len(hashes))
        cap = max_fetch_blocks()
        if cap:
            want = min(want, local // page + cap)
        return hashes[local // page:want]

    async def ensure_prefix(self, request, ctx: Context) -> int:
        """Fetch the stamped donor's prefix blocks into the local host
        tier before the request enters the engine. Returns blocks
        deposited (0 = nothing to do / fell back to local prefill).
        Bounded: races client-stop, the request deadline and the fetch
        timeout; every failure mode degrades to local recompute."""
        donor = int(getattr(request, "kv_donor", 0) or 0)
        if (not donor or donor == self.worker_id
                or self.core.tiered is None):
            return 0
        rem = dl.remaining(ctx.deadline)
        if rem is not None and rem <= 0:
            # already expired: the engine path raises the 504 — spawning
            # a doomed fetch would count phantom cluster fallbacks
            return 0
        missing = self._missing_hashes(request)
        if not missing:
            return 0
        stage = stage_metrics()
        fetch = asyncio.ensure_future(
            fetch_prefix(self.client, donor, missing, ctx.child(),
                         receiver_id=self.worker_id))
        stop = asyncio.ensure_future(ctx.stopped())
        try:
            timeout = self.timeout
            rem = dl.remaining(ctx.deadline)
            if rem is not None and rem < timeout:
                # fetching past the caller's deadline helps nobody; the
                # engine path raises the 504 with its own stage name
                timeout = max(rem, 0.0)
            done, _ = await asyncio.wait(
                {fetch, stop}, timeout=timeout,
                return_when=asyncio.FIRST_COMPLETED)
            if stop in done:
                raise asyncio.CancelledError
            if fetch not in done:
                stage.kv_cluster_fallbacks.inc()
                log.warning(
                    "cluster fetch of %d blocks from %x timed out after "
                    "%.2fs; prefilling locally", len(missing), donor,
                    timeout)
                return 0
            try:
                blocks = fetch.result()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 - typed fallback path
                stage.kv_cluster_fallbacks.inc()
                log.warning("cluster fetch from %x failed (%s); "
                            "prefilling locally", donor, e)
                return 0
            if not blocks:
                # donor evicted the prefix between routing and fetch
                stage.kv_cluster_fallbacks.inc()
                return 0
            tiered = self.core.tiered
            want = tuple(tiered.host.block_shape)
            got = blocks[0][1].shape
            # wire dtype names: a bf16 tier holds uint16 bits on this side
            # and ml_dtypes.bfloat16 on a JAX worker's, "bfloat16" on both
            if got != want or wire_dtype_name(blocks[0][1].dtype) \
                    != wire_dtype_name(tiered.host.dtype):
                # geometry mismatch (donor runs a different model/TP
                # sharding than the registry claimed): depositing would
                # corrupt the tier — recompute locally instead
                stage.kv_cluster_fallbacks.inc()
                log.warning("cluster fetch from %x: block geometry %s/%s "
                            "!= local %s/%s; prefilling locally", donor,
                            got, blocks[0][1].dtype, want,
                            tiered.host.dtype)
                return 0
            for h, k, v in blocks:
                tiered.offload(h, k, v)
            stage.kv_cluster_fetches.inc()
            return len(blocks)
        finally:
            stop.cancel()
            if not fetch.done():
                fetch.cancel()
            # reap unconsumed failures quietly — a cancelled-and-abandoned
            # fetch, or one that failed in the same wait round client-stop
            # won — so nothing surfaces as a GC'd "exception never
            # retrieved"
            fetch.add_done_callback(
                lambda t: None if t.cancelled() else t.exception())
