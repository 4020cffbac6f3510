"""Desired-state model registry: the store is the source of truth for
*which models this namespace serves* and *on what terms*.

Two keyspace families (see ``runtime/keyspace.py``):

``fleet_models/{ns}/{model}`` — **persistent** desired state, mutated by
``ctl fleet add/remove`` (and any operator tooling). One
:class:`FleetModelSpec` per model: the ModelDeploymentCard reference,
worker component + engine + chip shape, min/max replicas, priority, and
the per-tenant quota table. Persistence is deliberate: the registry must
survive every process — a planner restart re-reads the desired fleet, it
does not forget it.

``fleet_status/{ns}/{model}`` — **lease-bound** observed state written by
whichever planner currently reconciles the fleet (replicas, target,
ready/booting/draining/off, chips, worst burn). Dying with the planner's
lease is the point: a stale status is worse than an absent one, and the
frontends rendering ``GET /v1/models`` fall back to "registered but
unobserved" cleanly.

:class:`FleetRegistry` is the live watcher every consumer arms (planner,
fleet router, frontend): a prefix watch + snapshot into a plain dict,
with an ``on_change`` hook for consumers that need to react (the fleet
router adds/removes per-model routing state).
"""

from __future__ import annotations

import json
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ..utils.overload import TenantQuota

log = logging.getLogger("dynamo_tpu_torch.fleet")

FLEET_MODELS_PREFIX = "fleet_models/"
FLEET_STATUS_PREFIX = "fleet_status/"

_NAME_CHARS = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789._-")

#: observed lifecycle states published to fleet_status/
STATE_OFF = "off"              # scaled to zero by design
STATE_BOOTING = "booting"      # target > live replicas (weights loading)
STATE_READY = "ready"          # live replicas match the target
STATE_DRAINING = "draining"    # target < live replicas


def worker_engine(engine: str) -> str:
    """The port's worker ``--engine`` for a registry record's ``engine``: a
    record the JAX package's ``ctl fleet add`` wrote names ``"jax"``, whose
    port counterpart computing the same model is the ``torch`` worker. The
    record itself is never rewritten (it round-trips byte for byte); specs
    the port creates say ``"torch"``."""
    return "torch" if engine == "jax" else engine


def fleet_models_prefix(namespace: str) -> str:
    return f"{FLEET_MODELS_PREFIX}{namespace}/"


def fleet_model_key(namespace: str, model: str) -> str:
    return f"{FLEET_MODELS_PREFIX}{namespace}/{model}"


def fleet_status_prefix(namespace: str) -> str:
    return f"{FLEET_STATUS_PREFIX}{namespace}/"


def fleet_status_key(namespace: str, model: str) -> str:
    return f"{FLEET_STATUS_PREFIX}{namespace}/{model}"


@dataclass
class FleetModelSpec:
    """One model's desired state — everything the planner, router and
    frontend need to serve it, in one record."""

    name: str
    #: store component the model's worker pool registers as; every model
    #: gets its own pool so routing/metrics/KV events stay model-scoped
    component: str = ""
    #: worker engine: torch | echo (a JAX record's "jax" serves on the
    #: torch worker, see :func:`worker_engine`)
    engine: str = "echo"
    model_path: Optional[str] = None
    #: chips one replica occupies — the arbiter's unit of account.
    #: 0 = exempt from the chip budget (CPU echo pools, test fixtures)
    chips_per_replica: int = 1
    min_replicas: int = 0           # 0 = scale-to-zero allowed
    max_replicas: int = 4
    #: arbitration rank: higher-priority models take chips first when the
    #: budget is short, burn breaking ties within a priority class
    priority: int = 0
    #: per-tenant admission quotas enforced at HTTP ingress; merged
    #: across models (max per field) into the frontend's live quota table
    tenants: Dict[str, TenantQuota] = field(default_factory=dict)
    #: serialized ModelDeploymentCard (ctl fleet add --model-path embeds
    #: the resolved card so workers/frontends need no filesystem access)
    card: Optional[Dict[str, Any]] = None
    #: extra worker argv (planner LocalConnector pass-through)
    extra_args: List[str] = field(default_factory=list)
    #: model-mobility swap class: models sharing a non-empty swap_group
    #: are hot-swap siblings — a preemption can hand a victim's chips to
    #: the beneficiary by in-place weight swap instead of spawn + drain,
    #: and workers prefetch siblings' weights into the host cache
    swap_group: str = ""
    #: prewarm hint (``ctl fleet add --prewarm``): every worker in the
    #: namespace stages this model's weights even across swap groups
    prewarm: bool = False

    def __post_init__(self) -> None:
        # the name is a store-key path segment, a metric label, a pool
        # id and a component-name stem — a '/' (HF-style "org/model")
        # would make the registry key's last segment diverge from the
        # spec name and strand the record. Same charset as tenant ids.
        if (not self.name or len(self.name) > 64
                or not set(self.name) <= _NAME_CHARS):
            raise ValueError(
                f"fleet model name {self.name!r}: expected 1-64 chars of "
                f"[A-Za-z0-9._-] (use --model-path for the checkpoint "
                f"location; the name is the serving id)")
        if not self.component:
            self.component = f"backend-{self.name}"
        if self.min_replicas < 0 or self.max_replicas < max(
                self.min_replicas, 1):
            raise ValueError(
                f"model {self.name!r}: bad replica range "
                f"[{self.min_replicas}, {self.max_replicas}]")
        if self.chips_per_replica < 0:
            raise ValueError(f"model {self.name!r}: negative chip shape")

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "component": self.component,
            "engine": self.engine,
            "model_path": self.model_path,
            "chips_per_replica": self.chips_per_replica,
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "priority": self.priority,
            "tenants": {t: q.to_dict() for t, q in self.tenants.items()},
            "card": self.card,
            "extra_args": list(self.extra_args),
            "swap_group": self.swap_group,
            "prewarm": self.prewarm,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FleetModelSpec":
        kw = {k: v for k, v in d.items() if k in cls.__dataclass_fields__}
        kw["tenants"] = {t: TenantQuota.from_dict(q)
                         for t, q in (d.get("tenants") or {}).items()}
        kw["extra_args"] = list(d.get("extra_args") or [])
        return cls(**kw)


# ---------------------------------------------------------------------------
# one-shot accessors (ctl, tests)
# ---------------------------------------------------------------------------
async def put_fleet_model(store, namespace: str,
                          spec: FleetModelSpec) -> None:
    await store.put(fleet_model_key(namespace, spec.name),
                    json.dumps(spec.to_dict()).encode())


async def get_fleet_model(store, namespace: str,
                          model: str) -> Optional[FleetModelSpec]:
    raw = await store.get(fleet_model_key(namespace, model))
    if not raw:
        return None
    return FleetModelSpec.from_dict(json.loads(raw.decode()))


async def remove_fleet_model(store, namespace: str, model: str) -> None:
    """Drop the desired-state record AND the (possibly stale) status —
    the planner's next tick drains the pool to zero."""
    await store.delete(fleet_model_key(namespace, model))
    await store.delete(fleet_status_key(namespace, model))


async def list_fleet_models(store, namespace: str) -> List[FleetModelSpec]:
    out: List[FleetModelSpec] = []
    for key, value in await store.get_prefix(fleet_models_prefix(namespace)):
        try:
            out.append(FleetModelSpec.from_dict(json.loads(value.decode())))
        except (ValueError, json.JSONDecodeError):
            log.warning("skipping malformed fleet record %s", key)
    return sorted(out, key=lambda s: s.name)


async def publish_fleet_status(store, namespace: str, model: str,
                               status: Dict[str, Any],
                               lease: Optional[int] = None) -> None:
    """Lease-bound observed state (dead planner => status expires)."""
    payload = dict(status)
    payload.setdefault("model", model)
    payload["ts"] = time.time()
    await store.put(fleet_status_key(namespace, model),
                    json.dumps(payload).encode(), lease=lease)


async def fetch_fleet_status(store, namespace: str) -> Dict[str, Dict]:
    """{model: status} — whatever statuses a live planner has published."""
    out: Dict[str, Dict] = {}
    for key, value in await store.get_prefix(fleet_status_prefix(namespace)):
        model = key.rsplit("/", 1)[1]
        try:
            out[model] = json.loads(value.decode())
        except (ValueError, json.JSONDecodeError):
            log.warning("skipping malformed fleet status %s", key)
    return out


class FleetRegistry:
    """Live view of the desired fleet: prefix watch + snapshot into
    ``self.models``. ``on_change(name, spec_or_None)`` fires per record
    mutation (None = removed) AFTER the dict is updated."""

    def __init__(self, store, namespace: str):
        self.store = store
        self.namespace = namespace
        self.models: Dict[str, FleetModelSpec] = {}
        self.on_change: Optional[Callable[[str, Optional[FleetModelSpec]],
                                          None]] = None
        self._started = False

    async def start(self) -> "FleetRegistry":
        prefix = fleet_models_prefix(self.namespace)
        # live events win over the snapshot for keys they already touched
        # (same discipline as KvClusterIndex: a delete racing the watch
        # registration must not resurrect the record)
        touched: set = set()

        async def on_event(key: str, value: Optional[bytes],
                           deleted: bool) -> None:
            touched.add(key)
            self._apply(key, value, deleted)

        snapshot = await self.store.watch_prefix(prefix, on_event)
        for key, value in snapshot:
            if key not in touched:
                self._apply(key, value, False)
        self._started = True
        return self

    def _apply(self, key: str, value: Optional[bytes],
               deleted: bool) -> None:
        name = key.rsplit("/", 1)[1]
        if deleted or not value:
            if self.models.pop(name, None) is not None:
                log.info("fleet: model %s removed from registry", name)
                self._notify(name, None)
            return
        try:
            spec = FleetModelSpec.from_dict(json.loads(value.decode()))
        except (ValueError, json.JSONDecodeError):
            log.warning("fleet: ignoring malformed record %s", key)
            return
        self.models[name] = spec
        self._notify(name, spec)

    def _notify(self, name: str, spec: Optional[FleetModelSpec]) -> None:
        if self.on_change is None:
            return
        try:
            self.on_change(name, spec)
        except Exception:  # noqa: BLE001 - consumer hook must not kill watch
            log.exception("fleet on_change hook failed for %s", name)

    def snapshot(self) -> Dict[str, FleetModelSpec]:
        return dict(self.models)

    def tenant_quotas(self) -> Dict[str, TenantQuota]:
        """The fleet-wide tenant quota table: per-model tables merged by
        taking each field's max across models — a tenant's ingress
        allowance is its most generous grant (admission happens before
        the model is known, so the per-model grant cannot be applied
        until routing; the max is the sound pre-body bound)."""
        merged: Dict[str, TenantQuota] = {}
        for spec in self.models.values():
            for tenant, q in spec.tenants.items():
                cur = merged.get(tenant)
                if cur is None:
                    merged[tenant] = TenantQuota(rps=q.rps, burst=q.burst,
                                                 concurrency=q.concurrency)
                else:
                    merged[tenant] = TenantQuota(
                        rps=max(cur.rps, q.rps),
                        burst=max(cur.burst, q.burst),
                        concurrency=max(cur.concurrency, q.concurrency))
        return merged
