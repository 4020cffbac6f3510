"""KvRouter: composes indexer + metrics aggregation + scheduler into a
routing service over the distributed runtime.

- subscribes the target component's ``kv_events`` subject -> KvIndexer
- scrapes worker ForwardPassMetrics from the store prefix -> scheduler
- tracks the worker endpoint's live instance set (drops dead workers from
  the index)
- serves ``route``: {token_ids} -> {worker_id, overlap_blocks}

Reference capability: lib/llm/src/kv_router.rs (KvRouter), metrics_aggregator.rs,
components/router binary.
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Dict, Optional

from ...runtime.component import Client, Component, DistributedRuntime
from ...runtime.engine import EngineError
from ...utils.aiotasks import cancel_all, spawn
from ..tokens import compute_seq_hashes
from .indexer import KvIndexer
from .protocols import KV_EVENT_SUBJECT, ForwardPassMetrics, RouterEvent
from .scheduler import KvScheduler

log = logging.getLogger("dynamo_tpu_torch.kv_router")


class KvRouterService:
    def __init__(self, drt: DistributedRuntime, namespace: str,
                 worker_component: str, block_size: int = 64,
                 scrape_interval: float = 0.5,
                 model: Optional[str] = None):
        self.drt = drt
        self.namespace = namespace
        self.worker_component = worker_component
        # fleet mode: the model this router instance serves. Candidate
        # sets are per-component BY CONSTRUCTION (the indexer subscribes
        # one component's kv_events, the scrape reads one component's
        # metrics prefix, the cluster index filters by component), so
        # one KvRouterService per model pool IS the model-scoped router;
        # the name here just makes scoring/audit entries attributable.
        self.model = model
        self.indexer = KvIndexer(block_size)
        self.scheduler = KvScheduler(block_size,
                                     on_hit_rate=self._emit_hit_rate,
                                     model=model)
        self.scrape_interval = scrape_interval
        self._scrape_task: Optional[asyncio.Task] = None
        self.worker_client: Optional[Client] = None
        self._hit_events = 0
        self._publish_tasks: set = set()   # in-flight hit-rate publishes
        # cluster KV sharing (DYN_KV_CLUSTER=1): registry reader + transfer
        # cost model; when armed, route() scores cluster hits and stamps
        # the elected donor on the response
        self.cluster_index = None
        self.cost_model = None
        # fleet brownout view (utils/overload.BrownoutState, armed by the
        # router binary): any level above normal turns on scheduler
        # fast-fail — under declared overload, capacity-waiting is doomed
        self.brownout = None

    def _emit_hit_rate(self, ev) -> None:
        self._hit_events += 1
        # retained handle: a failed publish (store outage mid-churn) must
        # log, not vanish as a GC'd "exception never retrieved"
        spawn(self.drt.namespace(self.namespace).publish(
                  "kv-hit-rate", ev.to_dict()),
              name="kv-hit-rate-publish", store=self._publish_tasks)

    # ------------------------------------------------------------------
    async def start(self) -> "KvRouterService":
        ns = self.drt.namespace(self.namespace)
        component = ns.component(self.worker_component)

        async def on_kv_event(payload: Dict) -> None:
            self.indexer.apply_sync(RouterEvent.from_dict(payload))

        await component.subscribe(KV_EVENT_SUBJECT, on_kv_event)

        # live worker set: prune index + scheduler on death
        self.worker_client = await component.endpoint("generate").client().start()
        # breaker visibility for the scheduler's fast-fail: instances THIS
        # process's client currently holds OPEN count as non-candidates
        from ...runtime.circuit_breaker import OPEN

        self.scheduler.breaker_open = lambda: {
            i for i in self.worker_client.instances
            if self.worker_client.breaker.state(i) == OPEN}

        from .. import kv_cluster

        if kv_cluster.enabled():
            self.cluster_index = await kv_cluster.KvClusterIndex().start(
                self.drt.store, self.namespace)
            self.cost_model = kv_cluster.TransferCostModel()

        def on_change():
            live = set(self.worker_client.instances)
            for w in self.indexer.tree.workers() - live:
                self.indexer.remove_worker(w)
            for w in list(self.scheduler.endpoints.workers):
                if w not in live:
                    self.scheduler.remove_worker(w)
            if self.cluster_index is not None:
                # belt over the lease-bound suspenders: a donor whose
                # endpoint registration vanished must stop being scored
                # immediately, even if its registry delete is in flight
                for w in list(self.cluster_index.records):
                    if w not in live:
                        self.cluster_index.remove_worker(w)

        self.worker_client.on_instances_changed = on_change
        self._scrape_task = asyncio.create_task(self._scrape_loop())
        return self

    async def stop(self) -> None:
        if self._scrape_task:
            self._scrape_task.cancel()
        await cancel_all(self._publish_tasks)

    async def _scrape_loop(self) -> None:
        from ..metrics_aggregator import METRICS_PREFIX

        prefix = f"{METRICS_PREFIX}{self.namespace}/{self.worker_component}/"
        beat = 0
        while True:
            try:
                items = await self.drt.store.get_prefix(prefix)
                workers = {}
                live = set(self.worker_client.instances) \
                    if self.worker_client else None
                for key, value in items:
                    wid = int(key.rsplit("/", 1)[1], 16)
                    if live is not None and wid not in live:
                        continue
                    workers[wid] = ForwardPassMetrics.from_dict(
                        json.loads(value.decode()))
                self.scheduler.update_endpoints(workers)
                if self.cost_model is not None and beat % 10 == 0:
                    # refresh the peer-fetch bandwidth estimate from the
                    # merged llm_kv_transfer histograms — every ~10 beats,
                    # the stage merge is heavier than the metrics scrape
                    from ..metrics_aggregator import fetch_stage_states

                    self.cost_model.update_from_states(
                        await fetch_stage_states(self.drt.store,
                                                 self.namespace))
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("metrics scrape failed")
            beat += 1
            await asyncio.sleep(self.scrape_interval)

    def _cluster_overlap(self, seq_hashes):
        """Cluster-wide prefix availability of a request's hash chain
        (None when cluster sharing is off or the registry is empty),
        armed with the pair-aware transfer-cost callables so donor
        election and candidate scoring price the (src,dst) network pair
        the placement would actually move bytes over."""
        if (self.cluster_index is None or not self.cluster_index.records
                or not seq_hashes):
            return None
        index, cm = self.cluster_index, self.cost_model
        weight = cm.weight(len(seq_hashes), index.any_block_bytes())
        # only owners of the routed component: a foreign component's
        # record (disagg prefill pool, another model) is unreachable
        # through the worker's fetch client
        ov = index.find(seq_hashes, weight=weight,
                        component=self.worker_component)

        def _bb(src):
            return index.block_bytes(src) or index.any_block_bytes()

        ov.pair_weight = lambda src, dst, blocks: cm.weight(
            blocks, _bb(src), src=src, dst=dst)
        ov.pair_seconds = lambda src, dst, blocks: cm.estimate_seconds(
            blocks, _bb(src), src=src, dst=dst)
        ov.pair_source = lambda src, dst: cm.bandwidth_info(
            src=src, dst=dst)[1]
        return ov

    # ------------------------------------------------------------------
    async def route(self, token_ids, lora_id: int = 0,
                    exclude=None) -> Dict:
        # hash the prompt chain ONCE; the indexer and the cluster index
        # query the same salted chain
        hashes = compute_seq_hashes(token_ids, self.indexer.block_size,
                                    lora_id=lora_id)
        overlaps = self.indexer.find_matches(hashes)
        cluster = self._cluster_overlap(hashes)
        # brownout level > 0 forces fast-fail regardless of the env knob;
        # None defers to DYN_ROUTER_FAST_FAIL
        fast_fail = True if (self.brownout is not None
                             and self.brownout.level > 0) else None
        wid = await self.scheduler.schedule_or_wait(token_ids, overlaps,
                                                    salt=lora_id,
                                                    fast_fail=fast_fail,
                                                    cluster=cluster,
                                                    exclude=exclude)
        resp = {"worker_id": wid,
                "overlap_blocks": overlaps.scores.get(wid, 0)}
        # stamp the donor score_candidates elected for the chosen worker
        # (scheduler.last_choice is this decision's: schedule_or_wait
        # returns synchronously after its final schedule()) — the worker
        # fetches without a registry round-trip, and the stamp is exactly
        # what the audit ring recorded
        chosen = self.scheduler.last_choice
        if (cluster is not None and chosen is not None
                and chosen["worker_id"] == wid
                and chosen.get("kv_donor") is not None
                # a donor the caller excluded is a dead instance whose
                # registry delete is still in flight: stamping it would
                # burn the fetch timeout on a resume's critical path
                and (not exclude or chosen["kv_donor"] not in exclude)):
            from ...utils.prometheus import stage_metrics

            stage_metrics().kv_cluster_hits.inc()
            resp["kv_donor"] = chosen["kv_donor"]
            resp["kv_donor_blocks"] = chosen["kv_donor_blocks"]
        return resp

    def decisions(self, limit: int = 0):
        """The audit ring: every routed request's full score breakdown."""
        return self.scheduler.decision_log(limit)

    async def serve(self, component: Component,
                    endpoint_name: str = "route") -> None:
        async def handler(request, ctx):
            yield await self.route(request["token_ids"],
                                   int(request.get("lora_id", 0)),
                                   exclude=request.get("exclude"))

        await component.endpoint(endpoint_name).serve(handler)

        # decision audit: the frontend's GET /v1/router/decisions and
        # `tracectl decisions` read the ring over this endpoint
        async def decisions_handler(request, ctx):
            limit = int((request or {}).get("limit", 0) or 0)
            yield {"decisions": self.decisions(limit)}

        await component.endpoint("decisions").serve(decisions_handler)


class FleetKvRouter:
    """One routing service for a whole multi-model fleet.

    The model-scoped candidate set comes for free from the existing
    per-component machinery: each model pool is its own store component,
    so one :class:`KvRouterService` per model *is* the model-scoped
    router — its indexer subscribes only that component's ``kv_events``,
    its scrape reads only that component's metrics prefix, and its
    cluster index already filters donors by component. This class keeps
    the set of inner services in lockstep with the fleet registry
    (``ctl fleet add`` mid-traffic arms routing for the new model within
    a watch delivery) and serves the same ``route``/``decisions``
    endpoints, dispatching on the request's ``model`` field.

    A request for an unregistered model is a typed 503 — the frontend's
    :class:`~..remote.RemoteCoreEngine` catches it and falls back to
    random dispatch over its own (model-correct) worker client, so a
    registry lag costs prefix affinity, never correctness.
    """

    def __init__(self, drt: DistributedRuntime, namespace: str,
                 block_size: int = 64):
        self.drt = drt
        self.namespace = namespace
        self.block_size = block_size
        self.routers: Dict[str, KvRouterService] = {}
        self.registry = None
        self.brownout = None        # shared BrownoutState (cli/router)
        self._sync_tasks: set = set()
        self._sync_lock = asyncio.Lock()

    async def start(self) -> "FleetKvRouter":
        from ...fleet.registry import FleetRegistry

        self.registry = FleetRegistry(self.drt.store, self.namespace)

        def on_change(name, spec):
            # registry hook is sync; the (idempotent, lock-serialized)
            # sync runs as a retained task
            spawn(self._sync_model(name, spec),
                  name=f"fleet-router-sync:{name}",
                  store=self._sync_tasks)

        self.registry.on_change = on_change
        await self.registry.start()
        # the snapshot fired on_change per record; wait for those syncs
        # so start() returns with routing armed for the known fleet
        for t in list(self._sync_tasks):
            await t
        return self

    async def _sync_model(self, name: str, spec) -> None:
        async with self._sync_lock:
            cur = self.routers.get(name)
            if spec is None:
                if cur is not None:
                    del self.routers[name]
                    await cur.stop()
                    log.info("fleet router: dropped model %s", name)
                return
            if cur is not None and cur.worker_component == spec.component:
                return
            if cur is not None:
                await cur.stop()
            svc = KvRouterService(self.drt, self.namespace, spec.component,
                                  block_size=self.block_size, model=name)
            svc.brownout = self.brownout
            await svc.start()
            self.routers[name] = svc
            log.info("fleet router: routing model %s -> component %s",
                     name, spec.component)

    async def stop(self) -> None:
        await cancel_all(self._sync_tasks)
        for svc in list(self.routers.values()):
            await svc.stop()
        self.routers.clear()

    # ------------------------------------------------------------------
    def _pick(self, model: Optional[str]) -> Optional[KvRouterService]:
        if model:
            return self.routers.get(model)
        if len(self.routers) == 1:
            # single-model fleet: legacy clients that send no model
            # field keep working
            return next(iter(self.routers.values()))
        return None

    async def route(self, token_ids, lora_id: int = 0,
                    model: Optional[str] = None, exclude=None) -> Dict:
        svc = self._pick(model)
        if svc is None:
            raise EngineError(
                f"router: model {model!r} has no routing pool "
                f"(fleet registry: {sorted(self.routers) or 'empty'})",
                503, stage="router", reason="unknown_model",
                retry_after=1.0)
        return await svc.route(token_ids, lora_id, exclude=exclude)

    def decisions(self, limit: int = 0, model: Optional[str] = None):
        """Merged audit across models (each entry carries its ``model``
        stamp), or one model's ring when ``model`` is given."""
        if model:
            svc = self.routers.get(model)
            return svc.decisions(limit) if svc else []
        merged = [d for svc in self.routers.values()
                  for d in svc.decisions(0)]
        merged.sort(key=lambda d: d.get("at", 0.0))
        return merged[-limit:] if limit else merged

    async def serve(self, component: Component,
                    endpoint_name: str = "route") -> None:
        async def handler(request, ctx):
            yield await self.route(request["token_ids"],
                                   int(request.get("lora_id", 0)),
                                   model=request.get("model"),
                                   exclude=request.get("exclude"))

        await component.endpoint(endpoint_name).serve(handler)

        async def decisions_handler(request, ctx):
            req = request or {}
            yield {"decisions": self.decisions(
                int(req.get("limit", 0) or 0), model=req.get("model"))}

        await component.endpoint("decisions").serve(decisions_handler)
