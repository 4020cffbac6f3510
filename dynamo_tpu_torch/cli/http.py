"""Standalone OpenAI HTTP frontend with live model discovery.

    python -m dynamo_tpu_torch.cli.http --store 127.0.0.1:4222 --port 8080 \
        [--namespace dynamo] [--router-component router]

Watches the store's ``models/`` prefix: every registered model becomes a
served OpenAI model backed by a RemoteCoreEngine over the runtime data plane
(KV-routed when a router component is live). Models appear/disappear live as
workers register/die. Reference capability: components/http/src/main.rs +
lib/llm/src/http/service/discovery.rs.
"""

from __future__ import annotations

import argparse

from ..utils.dynconfig import EnvDefaultsParser
import asyncio
import json
import logging
from typing import Dict, Optional

from ..llm.http_service import HttpService, ModelManager, ServedModel
from ..llm.model_card import ModelDeploymentCard
from ..llm.pipeline import OpenAIChatEngine, OpenAICompletionEngine
from ..llm.remote import MODEL_PREFIX, RemoteCoreEngine, split_model_key
from ..runtime.component import Client, DistributedRuntime

log = logging.getLogger("dynamo_tpu_torch.http")


class DiscoveryFrontend:
    def __init__(self, drt: DistributedRuntime, manager: ModelManager,
                 router_component: Optional[str] = None,
                 namespace: Optional[str] = None):
        self.drt = drt
        self.manager = manager
        self.router_component = router_component
        # configured namespace: the decisions-fetch fallback before any
        # model has registered (discovery would otherwise guess "dynamo")
        self.namespace = namespace
        self._clients: Dict[str, Client] = {}       # endpoint path -> client
        self._router_clients: Dict[str, Client] = {}
        self._decision_clients: Dict[str, Client] = {}  # ns -> audit client
        # (name, mtype) -> live registration store-keys. A model serves as
        # long as ANY registrant lives (replicas register under per-lease
        # keys; one replica dying must not unserve the others).
        self._registrations: Dict[tuple, set] = {}

    async def start(self) -> None:
        await self.drt.store.watch_prefix(MODEL_PREFIX, self._on_change)
        # initial snapshot
        for key, value in await self.drt.store.get_prefix(MODEL_PREFIX):
            await self._on_change(key, value, False)

    async def _client_for(self, endpoint_path: str) -> Client:
        if endpoint_path not in self._clients:
            ns, comp, ep = endpoint_path.split(".")
            cl = await self.drt.namespace(ns).component(comp) \
                .endpoint(ep).client().start()
            self._clients[endpoint_path] = cl
        return self._clients[endpoint_path]

    async def _router_for(self, ns: str) -> Optional[Client]:
        if not self.router_component:
            return None
        if ns not in self._router_clients:
            cl = await self.drt.namespace(ns) \
                .component(self.router_component).endpoint("route") \
                .client().start()
            self._router_clients[ns] = cl
        return self._router_clients[ns]

    async def fetch_router_decisions(self, limit: int = 0):
        """GET /v1/router/decisions backend: read the router's decision-
        audit ring over its ``decisions`` endpoint. Namespaces come from
        the models already discovered (falling back to the default
        namespace before any model registers). None = no live router; a
        LIVE router whose fetch fails raises, so the HTTP layer answers
        502 (router broken) instead of 404 (router absent)."""
        if not self.router_component:
            return None
        last_err: Optional[Exception] = None
        namespaces = (list(self._router_clients)
                      or [self.namespace or "dynamo"])
        for ns in namespaces:
            if ns not in self._decision_clients:
                self._decision_clients[ns] = await self.drt.namespace(ns) \
                    .component(self.router_component).endpoint("decisions") \
                    .client().start()
            cl = self._decision_clients[ns]
            if not cl.instances:
                continue
            try:
                async for resp in cl.generate({"limit": int(limit)}):
                    return resp.get("decisions", [])
            except Exception as e:  # noqa: BLE001 - surfaced as 502 below
                log.exception("router decisions fetch from %s failed", ns)
                last_err = e
        if last_err is not None:
            raise RuntimeError(f"live router failed the decisions fetch: "
                               f"{last_err}") from last_err
        return None

    async def _on_change(self, key: str, value: Optional[bytes],
                         deleted: bool) -> None:
        try:
            mt_name = split_model_key(key)
            if mt_name is None:
                return
            mtype, name = mt_name
            if deleted:
                regs = self._registrations.get((name, mtype))
                if regs is not None:
                    regs.discard(key)
                    if regs:
                        return      # surviving registrants keep serving
                    self._registrations.pop((name, mtype), None)
                served = self.manager.get(name)
                if served is not None:
                    if mtype == "chat":
                        served.chat_engine = None
                    else:
                        served.completion_engine = None
                    if (served.chat_engine is None
                            and served.completion_engine is None):
                        self.manager.remove(name)
                        log.info("model %s removed (no registrants left)",
                                 name)
                return
            d = json.loads(value.decode())
            card = ModelDeploymentCard.from_dict(d["card"])
            worker = await self._client_for(d["endpoint"])
            router = await self._router_for(d["endpoint"].split(".")[0])
            core = RemoteCoreEngine(worker, router, model_name=name)
            served = self.manager.get(name) or ServedModel(card)
            if mtype == "chat":
                served.chat_engine = OpenAIChatEngine(card, core)
            else:
                served.completion_engine = OpenAICompletionEngine(card, core)
            served.card = card
            self.manager.add(served)
            self._registrations.setdefault((name, mtype), set()).add(key)
            log.info("model %s (%s) -> %s", name, mtype, d["endpoint"])
        except Exception:
            log.exception("model discovery update failed for %s", key)


def parse_args(argv=None):
    p = EnvDefaultsParser(prog="dynamo-http")
    p.add_argument("--store", default="127.0.0.1:4222")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--router-component", default=None,
                   help="component name of a KV router to consult")
    p.add_argument("--namespace", default=None,
                   help="scope the /metrics stage scrape to one namespace "
                        "(default: all namespaces in the store)")
    return p.parse_args(argv)


async def run_http(args, *, ready_event=None,
                   drt: Optional[DistributedRuntime] = None
                   ) -> HttpService:
    host, port = args.store.split(":")
    own = drt is None
    if own:
        drt = await DistributedRuntime(store_host=host,
                                       store_port=int(port)).connect()
    manager = ModelManager()
    frontend = DiscoveryFrontend(drt, manager, args.router_component,
                                 namespace=getattr(args, "namespace", None))
    await frontend.start()
    # store-wired service: /v1/traces stitches spans published by workers,
    # /metrics merges their per-stage histograms
    from ..utils.tracing import configure as configure_tracing
    configure_tracing(component="http")
    svc = HttpService(manager, host=args.host, port=args.port,
                      store=drt.store,
                      namespace=getattr(args, "namespace", None),
                      router_decisions=(frontend.fetch_router_decisions
                                        if args.router_component else None))
    # publish this frontend's stage dump (TTFT/ITL histograms recorded at
    # the streaming edge) plus its HTTP request counters to the store —
    # the planner's ttft_p90 signal, the SLO monitor's latency AND
    # availability objectives, and dyntop all read metrics_stage/; a
    # frontend that only *served* /metrics would keep those planes blind
    from ..llm.metrics_aggregator import StagePublisher

    svc.stage_worker_id = drt.worker_id   # /metrics skips our own dump
    pub_ns = getattr(args, "namespace", None) or "dynamo"

    # flight recorder + watchdog + incident coordination: the frontend's
    # rings hold the request-edge spans and its store-health transitions;
    # on a capture beacon it also contributes the router's live decision-
    # ring slice (the frontend already knows how to fetch it)
    from .. import obs

    obs_handle = await obs.start_process(
        "http", store=drt.store, namespace=pub_ns,
        proc_label=f"http:{drt.worker_id:x}")
    if args.router_component:
        obs_handle.manager.add_source("router_decisions",
                                      frontend.fetch_router_decisions)
    svc._obs_handle = obs_handle   # stopped by HttpService.stop()
    # fleet brownout level (utils/overload.py): watch the store key the
    # controller publishes so THIS frontend's admission gate applies the
    # active degradation level — the level is fleet state, not local state
    try:
        await svc.brownout.watch(drt.store, pub_ns)
    except Exception:
        log.warning("brownout watch failed; serving at level 0",
                    exc_info=True)

    # fleet plane (multi-model registry): /v1/models reports per-model
    # state, registered models' 404s get their own (bounded) metric label
    # so the planner can scale them from zero, and the per-tenant quota
    # table follows the registry's per-model tenant tables live
    from ..fleet.registry import FleetRegistry, fetch_fleet_status
    from ..utils.overload import tenant_quotas_from_env

    try:
        fleet_reg = await FleetRegistry(drt.store, pub_ns).start()
    except Exception:
        fleet_reg = None
        log.warning("fleet registry watch failed; serving without the "
                    "fleet view", exc_info=True)
    if fleet_reg is not None:
        svc.known_models = lambda: set(fleet_reg.models)

        async def fleet_status():
            status = await fetch_fleet_status(drt.store, pub_ns)
            for name, spec in fleet_reg.snapshot().items():
                # registered but never reconciled (no planner yet):
                # still listed, state honest about the blind spot
                status.setdefault(name, {"state": "unknown",
                                         "component": spec.component})
            return status

        svc.fleet_status = fleet_status
        env_quotas = tenant_quotas_from_env()

        def refresh_quotas(*_):
            table = dict(env_quotas)
            table.update(fleet_reg.tenant_quotas())
            svc.tenants.set_quotas(table)

        fleet_reg.on_change = refresh_quotas
        refresh_quotas()

    publisher = StagePublisher(drt.store, pub_ns, "http", drt.worker_id,
                               drt.lease)

    async def stage_publish_loop():
        while True:
            try:
                await publisher.publish(
                    extra_metrics=svc.registry.state_dump())
            except Exception:
                log.debug("frontend stage publish skipped", exc_info=True)
            await asyncio.sleep(2.0)

    svc._stage_pub_task = asyncio.create_task(stage_publish_loop())
    actual = await svc.start()
    print(f"dynamo_tpu_torch http frontend on :{actual} (discovery mode)",
          flush=True)
    if ready_event is not None:
        ready_event.set()
    return svc


def main() -> None:
    from ..utils.logging_ext import init_logging
    init_logging()

    async def amain():
        args = parse_args()
        await run_http(args)
        while True:
            await asyncio.sleep(3600)

    try:
        asyncio.run(amain())
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
