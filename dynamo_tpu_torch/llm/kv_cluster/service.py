"""Worker-side wiring of the cluster KV sharing plane.

:meth:`KvClusterWorker.attach` is everything a worker binary (or test)
needs: serve the ``kv_fetch`` donor endpoint over the engine's tiered
cache, start the registry publisher (lease-bound record under the
``kv-cluster`` keyspace family), and build the peer-fetch client +
:class:`~.fetch.ClusterFetcher`. :class:`ClusterPrefetchEngine` wraps any
core engine so donor-stamped requests prefetch their missing prefix into
the host tier before admission — the engine's normal tier restore then
uploads the pages with zero prefill recompute of the shared blocks.
"""

from __future__ import annotations

import logging
from typing import AsyncIterator, Callable, Optional

from ...runtime.engine import AsyncEngine, Context
from ...utils.aiotasks import spawn_blocking
from .fetch import KV_FETCH_ENDPOINT, ClusterFetcher, make_kv_fetch_handler
from .registry import KvClusterPublisher

log = logging.getLogger("dynamo_tpu_torch.kv_cluster")


class ClusterPrefetchEngine(AsyncEngine):
    """Engine decorator: bounded donor prefetch + local-tier h2d
    prefetch before generation.

    The donor fetch overlaps the engine's in-flight dispatch queue
    (other requests keep dispatching while this one's blocks stream in)
    and degrades to plain local prefill on any failure — the inner
    engine never sees the difference beyond a warmer host tier.

    ``prefetcher`` (the engine's ``prefetch_tiers``, when supported)
    then starts the h2d upload of every matched host/disk-tier prefix
    block — including what the donor fetch just deposited — on an
    executor thread WHILE the request sits in the slot-gate queue the
    wrap encloses: by admission, the blocks are device-staged and the
    restore is a d2d scatter instead of a first-prefill-blocking h2d
    (the PRESERVE direction: the router's placement already committed
    this worker, so the movement its hit implies starts immediately).
    """

    def __init__(self, inner: AsyncEngine, fetcher: ClusterFetcher,
                 prefetcher: Optional[Callable] = None):
        self.inner = inner
        self.fetcher = fetcher
        self.prefetcher = prefetcher

    async def generate(self, request, context: Context) -> AsyncIterator:
        await self.fetcher.ensure_prefix(request, context)
        if self.prefetcher is not None:
            # retained: runs concurrently with the inner engine's queue
            # wait; prefetch_tiers owns its own fallback semantics
            spawn_blocking(self.prefetcher, request, name="h2d-prefetch")
        async for item in self.inner.generate(request, context):
            yield item


class KvClusterWorker:
    """One worker's attachment to the cluster sharing plane."""

    def __init__(self, publisher: KvClusterPublisher,
                 fetcher: ClusterFetcher, client):
        self.publisher = publisher
        self.fetcher = fetcher
        self.client = client

    @classmethod
    async def attach(cls, component, drt, namespace: str, core,
                     publish_interval: Optional[float] = None,
                     fetch_timeout: Optional[float] = None
                     ) -> Optional["KvClusterWorker"]:
        """Serve ``kv_fetch``, start the registry publisher, build the
        peer client. Returns None (with a warning) when the engine has no
        host tier — cluster sharing without somewhere to stage blocks is
        meaningless."""
        if core.tiered is None:
            log.warning("kv-cluster enabled but the engine has no host "
                        "tier (host_cache_blocks=0); cluster KV sharing "
                        "disabled on this worker")
            return None
        endpoint = component.endpoint(KV_FETCH_ENDPOINT)
        await endpoint.serve(make_kv_fetch_handler(
            core.tiered, worker_id=drt.worker_id))
        publisher = await KvClusterPublisher(
            drt.store, namespace, component.name, drt.worker_id, drt.lease,
            core.tiered, interval=publish_interval).start()
        client = await endpoint.client().start()
        fetcher = ClusterFetcher(core, client, drt.worker_id,
                                 timeout=fetch_timeout)
        log.info("kv-cluster attached: worker %x publishing + serving %s",
                 drt.worker_id, KV_FETCH_ENDPOINT)
        return cls(publisher, fetcher, client)

    def wrap(self, engine: AsyncEngine,
             prefetcher: Optional[Callable] = None) -> AsyncEngine:
        return ClusterPrefetchEngine(engine, self.fetcher,
                                     prefetcher=prefetcher)

    async def stop(self) -> None:
        await self.publisher.stop()
