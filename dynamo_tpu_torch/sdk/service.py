"""Service model: decorators, dependency descriptors, graph links.

A ``@service``-decorated class carries a :class:`ServiceSpec` describing its
namespace, component name, resource needs and endpoints. ``depends()``
attributes resolve to live :class:`~dynamo_tpu_torch.runtime.component.Client`
wrappers at bring-up. ``.link()`` records graph edges so the orchestrator
can discover every service reachable from the entry point.

The JAX package's ``dynamo_tpu/sdk/service.py``: the same decorators, specs
and graph order. A service's accelerator need is ``resources={"gpu": n}``
(cards); a JAX graph's or config's ``tpu`` key counts the same, so the
repo's configs run on the port unchanged (:func:`chips_of`).

Reference capability: deploy/dynamo/sdk/src/dynamo/sdk/lib/service.py:32-120
(@service -> DynamoService), decorators.py:26-101 (@dynamo_endpoint),
dependency.py (depends/DynamoClient), LinkedServices (.link()).
"""

from __future__ import annotations

import inspect
import json
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Type

SERVICE_CONFIG_ENV = "DYN_SERVICE_CONFIG"
SERVICE_CONFIG_FILE_ENV = "DYN_SERVICE_CONFIG_FILE"


@dataclass
class ServiceSpec:
    """Deployment metadata attached to a @service class."""

    namespace: str = "dynamo"
    name: str = ""                       # component name (class name default)
    resources: Dict[str, Any] = field(default_factory=dict)  # {"gpu": n}
    workers: int = 1
    links: List[Type] = field(default_factory=list)
    endpoints: Dict[str, str] = field(default_factory=dict)  # name -> attr
    on_start: List[str] = field(default_factory=list)        # hook attrs
    dependencies: Dict[str, "Dependency"] = field(default_factory=dict)


@dataclass
class Dependency:
    """Declared edge to another service: resolves to a client at runtime."""

    target: Type
    endpoint: str = "generate"

    def __set_name__(self, owner, name):
        self._attr = name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        resolved = getattr(obj, "_dyn_clients", {}).get(self._attr)
        if resolved is None:
            raise RuntimeError(
                f"dependency {self._attr!r} not wired — the service is not "
                f"running under `serve` (or bring-up has not finished)")
        return resolved


class BoundClient:
    """What a ``depends()`` attribute resolves to: endpoint-call sugar over
    the runtime Client (``self.backend.generate(req)`` streams results)."""

    def __init__(self, client, endpoint: str):
        self.client = client
        self.endpoint = endpoint

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)

        def call(request, context=None, **kw):
            return self.client.generate(request, context=context, **kw)

        # any attribute name is the endpoint method (the client was built
        # for spec.endpoint already); name kept for call-site readability
        return call


def chips_of(resources: Dict[str, Any]) -> Optional[int]:
    """The cards a ``resources`` mapping asks for: its ``gpu`` count, or a
    JAX config's ``tpu`` count (None when it names neither). A mapping
    naming both with different counts is refused."""
    counts = {int(resources[k]) for k in ("gpu", "tpu") if k in resources}
    if len(counts) > 1:
        raise ValueError(f"resources {resources!r} name gpu and tpu with "
                         f"different counts")
    return counts.pop() if counts else None


def depends(target: Type, endpoint: str = "generate") -> Dependency:
    return Dependency(target, endpoint)


def dynamo_endpoint(name: Optional[str] = None) -> Callable:
    """Mark an ``async def (self, request, ctx)`` generator as a served
    endpoint."""

    def wrap(fn):
        fn._dynamo_endpoint = name or fn.__name__
        return fn

    return wrap


def async_on_start(fn):
    """Mark an ``async def (self)`` to run after the runtime is connected
    and dependencies are wired, before endpoints serve."""
    fn._dynamo_on_start = True
    return fn


def service(namespace: str = "dynamo", name: Optional[str] = None,
            resources: Optional[Dict[str, Any]] = None,
            workers: int = 1) -> Callable[[Type], Type]:
    """Class decorator: attach a ServiceSpec and a .link() that records
    graph edges."""

    def wrap(cls: Type) -> Type:
        spec = ServiceSpec(namespace=namespace,
                           name=(name or cls.__name__.lower()),
                           resources=dict(resources or {}),
                           workers=workers)
        for attr, val in list(vars(cls).items()):
            if callable(val) and hasattr(val, "_dynamo_endpoint"):
                spec.endpoints[val._dynamo_endpoint] = attr
            if callable(val) and getattr(val, "_dynamo_on_start", False):
                spec.on_start.append(attr)
            if isinstance(val, Dependency):
                spec.dependencies[attr] = val
        cls._dynamo_spec = spec

        @classmethod
        def link(kls, other: Type) -> Type:
            kls._dynamo_spec.links.append(other)
            return kls

        cls.link = link
        return cls

    return wrap


def collect_graph(entry: Type) -> List[Type]:
    """Every service reachable from ``entry`` via links + dependencies, in
    dependency-first order (leaves start before the services calling them)."""
    seen: Dict[Type, None] = {}
    visiting: set = set()

    def visit(cls: Type):
        if cls in seen or cls in visiting:
            return   # visiting-guard: cyclic links must not recurse forever
        visiting.add(cls)
        spec: ServiceSpec = cls._dynamo_spec
        for dep in spec.dependencies.values():
            visit(dep.target)
        for other in spec.links:
            visit(other)
        visiting.discard(cls)
        seen[cls] = None

    visit(entry)
    return list(seen)


class ServiceConfig:
    """Per-service config injected by `serve` (YAML section -> env JSON),
    readable inside the service process:

        cfg = ServiceConfig.load()          # whole process config
        port = cfg.get("Frontend", {}).get("port", 8080)

    Reference capability: sdk/lib/config.py (DYN_SERVICE_CONFIG env).
    """

    def __init__(self, data: Dict[str, Any]):
        self.data = data

    @classmethod
    def load(cls) -> "ServiceConfig":
        raw = os.environ.get(SERVICE_CONFIG_ENV, "")
        if raw:
            return cls(json.loads(raw))
        # k8s path: config mounted as a file (deploy/manifests.py ConfigMap)
        path = os.environ.get(SERVICE_CONFIG_FILE_ENV, "")
        if path and os.path.exists(path):
            with open(path) as f:
                return cls(json.load(f))
        return cls({})

    def get(self, section: str, default: Any = None) -> Any:
        return self.data.get(section, default if default is not None else {})

    def for_service(self, cls_or_name) -> Dict[str, Any]:
        name = (cls_or_name if isinstance(cls_or_name, str)
                else cls_or_name.__name__)
        return dict(self.data.get(name, {}))
