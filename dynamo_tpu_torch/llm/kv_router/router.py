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
import os
from typing import Dict, Optional

from ...runtime.component import Client, Component, DistributedRuntime
from ...utils.aiotasks import cancel_all, spawn
from ..tokens import compute_seq_hashes
from .indexer import KvIndexer
from .protocols import KV_EVENT_SUBJECT, ForwardPassMetrics, RouterEvent
from .scheduler import KvScheduler

log = logging.getLogger("dynamo_tpu_torch.kv_router")


def check_kv_cluster_off() -> None:
    """``DYN_KV_CLUSTER=1`` arms cluster KV sharing in the JAX package
    (``llm/kv_cluster``: registry reader, transfer cost model, donor
    stamps). That plane is not ported yet (ROADMAP Queue 1 item 8); the
    port raises rather than route without the scores asked for."""
    if os.environ.get("DYN_KV_CLUSTER", "0").lower() in (
            "1", "true", "yes", "on"):
        raise NotImplementedError(
            "DYN_KV_CLUSTER: cluster KV sharing (llm/kv_cluster) is not "
            "ported to dynamo_tpu_torch yet (ROADMAP Queue 1 item 8)")


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
        check_kv_cluster_off()
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

        def on_change():
            live = set(self.worker_client.instances)
            for w in self.indexer.tree.workers() - live:
                self.indexer.remove_worker(w)
            for w in list(self.scheduler.endpoints.workers):
                if w not in live:
                    self.scheduler.remove_worker(w)

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
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("metrics scrape failed")
            await asyncio.sleep(self.scrape_interval)

    # ------------------------------------------------------------------
    async def route(self, token_ids, lora_id: int = 0,
                    exclude=None) -> Dict:
        hashes = compute_seq_hashes(token_ids, self.indexer.block_size,
                                    lora_id=lora_id)
        overlaps = self.indexer.find_matches(hashes)
        # brownout level > 0 forces fast-fail regardless of the env knob;
        # None defers to DYN_ROUTER_FAST_FAIL
        fast_fail = True if (self.brownout is not None
                             and self.brownout.level > 0) else None
        wid = await self.scheduler.schedule_or_wait(token_ids, overlaps,
                                                    salt=lora_id,
                                                    fast_fail=fast_fail,
                                                    exclude=exclude)
        # the JAX router also stamps the cluster-KV donor here (kv_donor,
        # kv_donor_blocks) when DYN_KV_CLUSTER is on, which the port refuses
        return {"worker_id": wid,
                "overlap_blocks": overlaps.scores.get(wid, 0)}

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
