"""Deployment resource model — the CRD equivalent.

A ``Deployment`` names a service graph (an SDK ``@service`` entry point or
an artifact in the api-store) plus per-service overrides (replicas, cards,
config). Desired state is stored under ``deploy/deployments/{ns}/{name}``;
the operator writes observed state to ``deploy/status/{ns}/{name}``.

The JAX package's ``dynamo_tpu/deploy/crd.py``: the same store keys, the
same ``apiVersion``/``kind``, the same JSON, so one store can hold both
packages' resources, with two deliberate differences:

- :attr:`ServiceSpec.gpus` is the card count a replica takes (key
  ``gpus``). :meth:`ServiceSpec.from_dict` reads a JAX resource's
  ``tpu_chips`` as the same count, as ``sdk.service.chips_of`` reads a
  ``tpu`` resource, and refuses a resource naming both with different
  values;
- :attr:`DeploymentSpec.platform` takes ``auto``, ``cuda`` or ``cpu``; a
  resource naming ``tpu`` is refused with a :class:`SpecError` that says
  so.

Reference capability: deploy/dynamo/operator/api/v1alpha1/
dynamodeployment_types.go:30-80 (DynamoDeploymentSpec{DynamoNim, Services},
Status{State, Conditions}) and dynamonimdeployment_types.go (per-service
resources/replicas/envs).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

VALID_STATES = ("pending", "deploying", "ready", "degraded", "failed",
                "terminating")
PLATFORMS = ("auto", "cuda", "cpu")


class SpecError(ValueError):
    """Malformed deployment resource."""


@dataclass
class ServiceSpec:
    """Per-service override inside a deployment (DynamoNimDeployment row)."""

    replicas: int = 1
    gpus: int = 0                       # cards per replica (0 = CPU service)
    config: Dict[str, Any] = field(default_factory=dict)  # service YAML config
    envs: Dict[str, str] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"replicas": self.replicas, "gpus": self.gpus,
                "config": self.config, "envs": self.envs}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ServiceSpec":
        replicas = int(d.get("replicas", 1))
        if replicas < 0:
            raise SpecError("replicas must be >= 0")
        # a JAX resource's tpu_chips is the same count (sdk.service.chips_of)
        counts = {int(d[k]) for k in ("gpus", "tpu_chips") if k in d}
        if len(counts) > 1:
            raise SpecError(f"gpus and tpu_chips name different counts: "
                            f"{d['gpus']!r} and {d['tpu_chips']!r}")
        chips = counts.pop() if counts else 0
        if chips < 0:
            raise SpecError("gpus must be >= 0")
        return cls(replicas=replicas, gpus=chips,
                   config=dict(d.get("config", {}) or {}),
                   envs={str(k): str(v)
                         for k, v in (d.get("envs", {}) or {}).items()})


@dataclass
class IngressSpec:
    """External traffic for the graph's HTTP frontend (reference renders
    Ingress + an Envoy header-routed debug/production split,
    deploy/dynamo/operator/internal/envoy/envoy.go)."""

    enabled: bool = False
    host: Optional[str] = None          # None => match-all virtual host
    service: str = "Frontend"           # graph service that serves HTTP
    port: int = 8080
    path: str = "/"
    tls_secret: Optional[str] = None
    annotations: Dict[str, str] = field(default_factory=dict)
    # Envoy sidecar: requests carrying ``debug_header: debug_value`` route
    # to the debug backend; everything else to the frontend service
    envoy: bool = False
    debug_header: str = "x-dynamo-debug"
    debug_value: str = "1"
    debug_service: Optional[str] = None  # None => same service

    def to_dict(self) -> Dict[str, Any]:
        return {"enabled": self.enabled, "host": self.host,
                "service": self.service, "port": self.port,
                "path": self.path, "tls_secret": self.tls_secret,
                "annotations": self.annotations, "envoy": self.envoy,
                "debug_header": self.debug_header,
                "debug_value": self.debug_value,
                "debug_service": self.debug_service}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "IngressSpec":
        port = int(d.get("port", 8080))
        if not (0 < port < 65536):
            raise SpecError(f"ingress.port invalid: {port}")
        return cls(enabled=bool(d.get("enabled", False)),
                   host=d.get("host"),
                   service=str(d.get("service", "Frontend")),
                   port=port,
                   path=str(d.get("path", "/")),
                   tls_secret=d.get("tls_secret"),
                   annotations={str(k): str(v) for k, v in
                                (d.get("annotations", {}) or {}).items()},
                   envoy=bool(d.get("envoy", False)),
                   debug_header=str(d.get("debug_header", "x-dynamo-debug")),
                   debug_value=str(d.get("debug_value", "1")),
                   debug_service=d.get("debug_service"))


@dataclass
class DeploymentSpec:
    graph: str                          # "pkg.module:EntryService" or artifact
    services: Dict[str, ServiceSpec] = field(default_factory=dict)
    store: Optional[str] = None         # host:port of shared dynstore
    platform: str = "auto"              # auto | cuda | cpu
    ingress: Optional[IngressSpec] = None

    def to_dict(self) -> Dict[str, Any]:
        return {"graph": self.graph,
                "services": {k: v.to_dict() for k, v in self.services.items()},
                "store": self.store, "platform": self.platform,
                "ingress": self.ingress.to_dict() if self.ingress else None}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DeploymentSpec":
        graph = d.get("graph")
        if not isinstance(graph, str) or not graph:
            raise SpecError("spec.graph must be a non-empty string")
        platform = d.get("platform", "auto")
        if platform == "tpu":
            raise SpecError("spec.platform 'tpu': this package runs on CUDA "
                            "cards; use 'cuda', 'cpu' or 'auto'")
        if platform not in PLATFORMS:
            raise SpecError(f"spec.platform invalid: {platform!r}")
        return cls(
            graph=graph,
            services={str(k): ServiceSpec.from_dict(v or {})
                      for k, v in (d.get("services", {}) or {}).items()},
            store=d.get("store"),
            platform=platform,
            ingress=(IngressSpec.from_dict(d["ingress"])
                     if d.get("ingress") else None),
        )


@dataclass
class Condition:
    """k8s-style status condition (metav1.Condition shape)."""

    type: str
    status: str                         # "True" | "False"
    reason: str = ""
    message: str = ""
    last_transition: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {"type": self.type, "status": self.status,
                "reason": self.reason, "message": self.message,
                "lastTransition": self.last_transition}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Condition":
        return cls(d.get("type", ""), d.get("status", ""),
                   d.get("reason", ""), d.get("message", ""),
                   float(d.get("lastTransition", 0.0)))


@dataclass
class DeploymentStatus:
    state: str = "pending"
    conditions: List[Condition] = field(default_factory=list)
    ready_replicas: Dict[str, int] = field(default_factory=dict)
    observed_generation: int = 0

    def set_condition(self, ctype: str, status: str, reason: str = "",
                      message: str = "") -> None:
        for c in self.conditions:
            if c.type == ctype:
                if c.status != status:
                    c.last_transition = time.time()
                c.status, c.reason, c.message = status, reason, message
                return
        self.conditions.append(
            Condition(ctype, status, reason, message, time.time()))

    def to_dict(self) -> Dict[str, Any]:
        return {"state": self.state,
                "conditions": [c.to_dict() for c in self.conditions],
                "readyReplicas": self.ready_replicas,
                "observedGeneration": self.observed_generation}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DeploymentStatus":
        return cls(
            state=d.get("state", "pending"),
            conditions=[Condition.from_dict(c)
                        for c in d.get("conditions", [])],
            ready_replicas=dict(d.get("readyReplicas", {})),
            observed_generation=int(d.get("observedGeneration", 0)),
        )


@dataclass
class Deployment:
    name: str
    namespace: str = "default"
    spec: DeploymentSpec = None  # type: ignore[assignment]
    status: DeploymentStatus = field(default_factory=DeploymentStatus)
    generation: int = 1

    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def to_dict(self) -> Dict[str, Any]:
        return {"apiVersion": "dynamo.tpu/v1alpha1",
                "kind": "DynamoDeployment",
                "metadata": {"name": self.name, "namespace": self.namespace,
                             "generation": self.generation},
                "spec": self.spec.to_dict()}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Deployment":
        meta = d.get("metadata") or {}
        name = meta.get("name")
        if not isinstance(name, str) or not name:
            raise SpecError("metadata.name is required")
        kind = d.get("kind", "DynamoDeployment")
        if kind != "DynamoDeployment":
            raise SpecError(f"unsupported kind {kind!r}")
        return cls(name=name,
                   namespace=meta.get("namespace", "default"),
                   spec=DeploymentSpec.from_dict(d.get("spec") or {}),
                   generation=int(meta.get("generation", 1)))

    # serialization on the store wire
    def to_bytes(self) -> bytes:
        return json.dumps(self.to_dict()).encode()

    @classmethod
    def from_bytes(cls, b: bytes) -> "Deployment":
        return cls.from_dict(json.loads(b.decode()))


# store key layout
DEPLOY_PREFIX = "deploy/deployments/"
STATUS_PREFIX = "deploy/status/"


def deploy_key(namespace: str, name: str) -> str:
    return f"{DEPLOY_PREFIX}{namespace}/{name}"


def status_key(namespace: str, name: str) -> str:
    return f"{STATUS_PREFIX}{namespace}/{name}"
