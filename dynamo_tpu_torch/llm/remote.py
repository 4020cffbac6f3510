"""Remote engine plumbing: serve a core engine over the runtime's data plane
and call it from a frontend, with optional KV-aware routing.

Wire shape on the ``generate`` endpoint: request = BackendInput.to_dict(),
stream items = EngineOutput.to_dict(). The KV router service serves ``route``:
{token_ids} -> {worker_id, overlap_blocks}.

Reference capability: the dyn:// egress path (launch/dynamo-run in=http
out=dyn://, lib/runtime egress/push.rs) and components/router.
"""

from __future__ import annotations

import logging
import re
from typing import AsyncIterator, Optional, Tuple

from ..runtime.component import Client, Endpoint
from ..runtime.engine import AsyncEngine, Context, EngineError
from .protocols.common import BackendInput, EngineOutput
from .model_card import ModelDeploymentCard

log = logging.getLogger("dynamo_tpu_torch.remote")

# store keys: models/{chat|completion}/{name}[:i-{lease_hex}]
# Lease-bound registrations are per-instance (suffixed with the worker's
# lease id, ref endpoint.rs `{key}:{lease_id_hex}`): replicas of one model
# must not overwrite each other's liveness binding, or the model drops for
# everyone when the LAST registrant dies — not when ALL of them have.
# The ``:i-`` marker keeps the suffix parse unambiguous for model names
# that themselves contain ':' (e.g. ollama-style "llama3:8b").
MODEL_PREFIX = "models/"

_LEASE_SUFFIX = re.compile(r":i-[0-9a-f]+$")


def model_key(model_type: str, name: str,
              lease: Optional[int] = None) -> str:
    base = f"{MODEL_PREFIX}{model_type}/{name}"
    return f"{base}:i-{lease:x}" if lease is not None else base


def split_model_key(key: str) -> Optional[Tuple[str, str]]:
    """``models/chat/m:i-1f`` → ("chat", "m"); None for foreign keys."""
    if not key.startswith(MODEL_PREFIX):
        return None
    parts = key[len(MODEL_PREFIX):].split("/", 1)
    if len(parts) != 2:
        return None
    mtype, rest = parts
    return mtype, _LEASE_SUFFIX.sub("", rest)


class RemoteCoreEngine(AsyncEngine[BackendInput, EngineOutput]):
    """Frontend-side core engine that forwards BackendInput to a remote
    worker endpoint; optionally consults a router endpoint first and pins the
    request to the returned worker (KV-aware routing)."""

    def __init__(self, worker_client: Client,
                 router_client: Optional[Client] = None,
                 model_name: Optional[str] = None):
        self.worker_client = worker_client
        self.router_client = router_client
        # fleet routing: the model this engine serves, carried on every
        # route request so a FleetKvRouter scores the right candidate
        # set (single-model routers ignore the field)
        self.model_name = model_name

    async def generate(self, request: BackendInput,
                       context: Context) -> AsyncIterator[EngineOutput]:
        from . import resume

        if resume.max_attempts() > 0:
            # mid-stream failover: a transport break / inter-frame stall
            # re-enters _dispatch_once with the dead instance excluded and
            # the emitted tokens folded into the resume prefix — the
            # detokenizer above this engine sees one continuous stream
            async for item in resume.run(self._dispatch_once, request,
                                         context,
                                         breaker=self.worker_client.breaker):
                yield item
            return
        async for item in self._dispatch_once(request, context, set(), 0,
                                              None):
            yield item

    async def _dispatch_once(self, request: BackendInput, context: Context,
                             exclude: set, resume_no: int,
                             on_instance) -> AsyncIterator[EngineOutput]:
        """One routed attempt: consult the router (minus ``exclude``), pin
        to the elected worker, stream the response. The resume layer calls
        this repeatedly under one context id; ``resume_no`` rides the wire
        envelope so a zombie context of a lower ordinal yields server-side,
        and ``on_instance`` reports who was chosen (the blame target when
        the stream later breaks)."""
        mode = "random"
        instance_id = None
        if self.router_client is not None and self.router_client.instances:
            try:
                async for resp in self.router_client.generate(
                        # kv_salt (VLM: lora ^ image digest) is the salt the
                        # engine publishes blocks under — score overlap with
                        # it so image prompts get router-side prefix credit
                        {"token_ids": request.token_ids,
                         "lora_id": request.kv_salt or request.lora_id,
                         **({"model": self.model_name}
                            if self.model_name else {}),
                         **({"exclude": sorted(exclude)}
                            if exclude else {})},
                        context.child()):
                    wid = resp.get("worker_id")
                    if wid is not None and wid in self.worker_client.instances:
                        mode, instance_id = "direct", wid
                        # cluster KV sharing: carry the router's donor
                        # election to the worker, which fetches the prefix
                        # peer-to-peer before the request enters its engine
                        if resp.get("kv_donor"):
                            request.kv_donor = int(resp["kv_donor"])
                            request.kv_donor_blocks = int(
                                resp.get("kv_donor_blocks", 0))
                    break
            except EngineError:
                log.warning("router unavailable; falling back to random")
        # the router's scheduler stands down when exclusion would veto the
        # whole pool; the random fallback needs the same stand-down here
        ex = exclude
        if ex and not (set(self.worker_client.instances) - ex):
            ex = set()
        async for item in self.worker_client.generate(
                request.to_dict(), context, mode=mode,
                instance_id=instance_id, exclude=ex, resume=resume_no,
                on_instance=on_instance):
            yield EngineOutput.from_dict(item)


async def serve_core_engine(endpoint: Endpoint, engine: AsyncEngine) -> None:
    """Expose a local core engine (BackendInput->EngineOutput) on an
    endpoint, handling dict (de)serialization."""

    async def handler(request, ctx):
        bi = BackendInput.from_dict(request)
        async for out in engine.generate(bi, ctx):
            yield out.to_dict()

    await endpoint.serve(handler)


async def register_model(store, card: ModelDeploymentCard,
                         endpoint_path: str, model_type: str = "chat",
                         lease: Optional[int] = None) -> None:
    """llmctl add: advertise model -> endpoint mapping for frontends."""
    import json

    payload = json.dumps({"card": card.to_dict(),
                          "endpoint": endpoint_path}).encode()
    await store.put(model_key(model_type, card.name, lease=lease),
                    payload, lease=lease)


async def unregister_model(store, name: str, model_type: str = "chat") -> None:
    """llmctl remove: drop the manual entry and every per-instance one."""
    base = model_key(model_type, name)
    await store.delete(base)
    for key, _ in await store.get_prefix(base + ":i-"):
        if _LEASE_SUFFIX.search(key):   # never sweep a ':'-containing name
            await store.delete(key)


async def list_models(store):
    """One entry per (type, name): N replicas register N lease-suffixed keys
    for the same model — surface them as ``instances: N``, not N duplicate
    rows in llmctl output (ADVICE r4). A manual (lease-less) ``llmctl add``
    entry is not a replica, so it never inflates the count; registrations
    that disagree on the endpoint are surfaced, not silently collapsed."""
    import json

    by_model: dict = {}
    for key, value in await store.get_prefix(MODEL_PREFIX):
        mt_name = split_model_key(key)
        if mt_name is None:
            continue
        d = json.loads(value.decode())
        is_instance = _LEASE_SUFFIX.search(key) is not None
        entry = by_model.get(mt_name)
        if entry is None:
            entry = by_model[mt_name] = {
                "name": mt_name[1], "type": mt_name[0],
                "endpoint": d["endpoint"], "card": d.get("card"),
                "instances": 1 if is_instance else 0}
        else:
            if is_instance:
                entry["instances"] += 1
        if d["endpoint"] != entry["endpoint"]:
            entry.setdefault("conflicting_endpoints", []).append(
                d["endpoint"])
    # a model present only via a manual entry still serves: show 1
    for entry in by_model.values():
        entry["instances"] = entry["instances"] or 1
    return list(by_model.values())
