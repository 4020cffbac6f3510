"""Render a Deployment resource into Kubernetes manifests.

For a real cluster the operator's job is done by k8s itself: this module
turns one ``Deployment`` into the child resources the reference's Go
controller creates — a ConfigMap carrying per-service config, a k8s
Deployment + Service per graph service, and (once per namespace) the
dynstore coordination service.

The JAX package's ``dynamo_tpu/deploy/manifests.py``, for CUDA nodes: a
worker that takes cards asks for ``nvidia.com/gpu`` (JAX:
``google.com/tpu`` and the GKE TPU node selectors), ``gpu_product``
optionally pins the node's ``nvidia.com/gpu.product`` label (JAX's
``tpu_topology`` argument), and the containers run the port's modules:
``python -m dynamo_tpu_torch.sdk.serve_child`` for a service and, for the
store, ``dynamo_tpu_torch.runtime.store_server --impl native``, which execs
the port's C++ dynstore. YAML is written by ``utils/yamlsubset.dumps`` (the
card's machine has no PyYAML); ``yaml.safe_load`` reads it back as the
same objects.

Reference capability: deploy/dynamo/operator/internal/controller/
dynamonimdeployment_controller.go (Deployments/Services/ConfigMaps from the
CRD) and deploy/Kubernetes charts.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from ..utils.yamlsubset import dumps
from .crd import Deployment, ServiceSpec

DEFAULT_IMAGE = "dynamo-tpu-torch:latest"
STORE_PORT = 4222
GPU_RESOURCE = "nvidia.com/gpu"
GPU_PRODUCT_LABEL = "nvidia.com/gpu.product"


def _meta(name: str, namespace: str, labels: Dict[str, str]) -> Dict[str, Any]:
    return {"name": name, "namespace": namespace, "labels": labels}


def _labels(dep: Deployment, service: str) -> Dict[str, str]:
    return {"app.kubernetes.io/part-of": "dynamo-tpu",
            "dynamo.tpu/deployment": dep.name,
            "dynamo.tpu/service": service}


def store_manifests(namespace: str,
                    image: str = DEFAULT_IMAGE) -> List[Dict[str, Any]]:
    """dynstore (discovery/request/queue planes) as a single-replica
    Deployment + stable Service — the analogue of the reference's
    etcd+NATS dependency charts."""
    labels = {"app.kubernetes.io/part-of": "dynamo-tpu",
              "dynamo.tpu/service": "dynstore"}
    return [
        {"apiVersion": "apps/v1", "kind": "Deployment",
         "metadata": _meta("dynstore", namespace, labels),
         "spec": {
             "replicas": 1,
             "selector": {"matchLabels": labels},
             "template": {
                 "metadata": {"labels": labels},
                 "spec": {"containers": [{
                     "name": "dynstore",
                     "image": image,
                     "command": ["python", "-m",
                                 "dynamo_tpu_torch.runtime.store_server",
                                 "--impl", "native",
                                 "--port", str(STORE_PORT)],
                     "ports": [{"containerPort": STORE_PORT}],
                 }]},
             },
         }},
        {"apiVersion": "v1", "kind": "Service",
         "metadata": _meta("dynstore", namespace, labels),
         "spec": {"selector": labels,
                  "ports": [{"port": STORE_PORT,
                             "targetPort": STORE_PORT}]}},
    ]


def render_manifests(dep: Deployment,
                     services: Dict[str, tuple],
                     image: str = DEFAULT_IMAGE,
                     include_store: bool = True,
                     gpu_product: Optional[str] = None) -> List[Dict[str, Any]]:
    """``services``: name -> (class import spec, default workers, default
    cards), the same mapping Operator._resolve_graph produces.
    ``gpu_product`` (e.g. ``NVIDIA-H100-80GB-HBM3``) selects the nodes
    whose ``nvidia.com/gpu.product`` label names it, for the workers that
    take cards."""
    out: List[Dict[str, Any]] = []
    ns = dep.namespace
    ing0 = dep.spec.ingress
    if ing0 is not None and ing0.enabled and not any(
            n.lower() == ing0.service.lower() for n in services):
        # a typo'd frontend name would render an Ingress to a nonexistent
        # Service and blackhole external traffic with rc=0 — hard-fail
        # like every other config typo in this stack
        raise ValueError(
            f"ingress.service {ing0.service!r} matches no graph service "
            f"(have: {sorted(services)})")
    if include_store:
        out.extend(store_manifests(ns, image))

    config_name = f"{dep.name}-config"
    out.append({
        "apiVersion": "v1", "kind": "ConfigMap",
        "metadata": _meta(config_name, ns, _labels(dep, "config")),
        "data": {"service-config.json": json.dumps(
            {name: (dep.spec.services.get(name) or ServiceSpec()).config
             for name in services}, indent=2)},
    })

    store_addr = dep.spec.store or f"dynstore.{ns}.svc:{STORE_PORT}"
    for name, (class_spec, default_workers, default_chips) in services.items():
        sspec = dep.spec.services.get(name) or ServiceSpec(
            replicas=default_workers, gpus=default_chips)
        labels = _labels(dep, name)
        container: Dict[str, Any] = {
            "name": name.lower(),
            "image": image,
            "command": ["python", "-m", "dynamo_tpu_torch.sdk.serve_child",
                        class_spec, "--store", store_addr],
            "env": [{"name": "DYN_SERVICE_CONFIG_FILE",
                     "value": "/etc/dynamo/service-config.json"}]
            + [{"name": k, "value": v} for k, v in sspec.envs.items()],
            "volumeMounts": [{"name": "config",
                              "mountPath": "/etc/dynamo"}],
        }
        pod_spec: Dict[str, Any] = {
            "containers": [container],
            "volumes": [{"name": "config",
                         "configMap": {"name": config_name}}],
        }
        if sspec.gpus > 0:
            container["resources"] = {"limits": {GPU_RESOURCE: sspec.gpus}}
            if gpu_product:
                pod_spec["nodeSelector"] = {GPU_PRODUCT_LABEL: gpu_product}
        out.append({
            "apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": _meta(f"{dep.name}-{name.lower()}", ns, labels),
            "spec": {
                "replicas": sspec.replicas,
                "selector": {"matchLabels": labels},
                "template": {"metadata": {"labels": labels},
                             "spec": pod_spec},
            },
        })
        ing = dep.spec.ingress
        # graph resolution lowercases service names; specs may carry the
        # class-cased form — match case-insensitively (manifest names are
        # lowercased everywhere anyway)
        is_frontend = (ing is not None and ing.enabled
                       and name.lower() == ing.service.lower())
        if is_frontend:
            # the ingress backend needs a routable port; peers still
            # discover each other through the store, so losing the
            # headless form here costs nothing
            if ing.envoy:
                out.append(_attach_envoy_sidecar(
                    pod_spec, container, dep, name, ing, ns))
            out.append({
                "apiVersion": "v1", "kind": "Service",
                "metadata": _meta(f"{dep.name}-{name.lower()}", ns, labels),
                "spec": {"selector": labels,
                         "ports": [{"name": "http", "port": ing.port,
                                    "targetPort": ing.port}]},
            })
        else:
            out.append({
                "apiVersion": "v1", "kind": "Service",
                "metadata": _meta(f"{dep.name}-{name.lower()}", ns, labels),
                "spec": {"selector": labels, "clusterIP": "None"},
            })
    if dep.spec.ingress is not None and dep.spec.ingress.enabled:
        out.append(render_ingress(dep))
    return out


def render_ingress(dep: Deployment) -> Dict[str, Any]:
    """networking.k8s.io/v1 Ingress for the graph's HTTP frontend
    (reference renders ingress for deployed graphs via its Go operator,
    deploy/dynamo/operator/internal/envoy/envoy.go + controller)."""
    ing = dep.spec.ingress
    ns = dep.namespace
    backend = {"service": {"name": f"{dep.name}-{ing.service.lower()}",
                           "port": {"number": ing.port}}}
    rule: Dict[str, Any] = {
        "http": {"paths": [{"path": ing.path, "pathType": "Prefix",
                            "backend": backend}]}}
    if ing.host:
        rule["host"] = ing.host
    md = _meta(f"{dep.name}-ingress", ns, _labels(dep, "ingress"))
    if ing.annotations:
        md["annotations"] = dict(ing.annotations)
    spec: Dict[str, Any] = {"rules": [rule]}
    if ing.tls_secret:
        spec["tls"] = [{"hosts": [ing.host] if ing.host else [],
                        "secretName": ing.tls_secret}]
    return {"apiVersion": "networking.k8s.io/v1", "kind": "Ingress",
            "metadata": md, "spec": spec}


ENVOY_ADMIN_PORT = 9901


def render_envoy_config(listen_port: int, upstream_host: str,
                        upstream_port: int, debug_header: str,
                        debug_value: str, debug_host: str,
                        debug_port: int) -> Dict[str, Any]:
    """Envoy bootstrap: header-routed debug/production split in front of
    the HTTP frontend — requests carrying ``debug_header: debug_value`` go
    to the debug cluster, the rest to production. Same traffic semantics
    as the reference's template (internal/envoy/envoy.go:42-120),
    generated as a dict so callers can serialize or extend it."""
    def cluster(cname: str, host: str, port: int) -> Dict[str, Any]:
        return {
            "name": cname, "connect_timeout": "0.25s",
            "type": "strict_dns", "dns_lookup_family": "v4_only",
            "lb_policy": "round_robin",
            "load_assignment": {
                "cluster_name": cname,
                "endpoints": [{"lb_endpoints": [{"endpoint": {"address": {
                    "socket_address": {"address": host,
                                       "port_value": port}}}}]}]},
        }

    hcm = {
        "name": "envoy.filters.network.http_connection_manager",
        "typed_config": {
            "@type": ("type.googleapis.com/envoy.extensions.filters."
                      "network.http_connection_manager.v3."
                      "HttpConnectionManager"),
            "stat_prefix": "ingress_http",
            "access_log": [{
                "name": "envoy.access_loggers.stdout",
                "typed_config": {
                    "@type": ("type.googleapis.com/envoy.extensions."
                              "access_loggers.stream.v3."
                              "StdoutAccessLog")}}],
            "http_filters": [{
                "name": "envoy.filters.http.router",
                "typed_config": {
                    "@type": ("type.googleapis.com/envoy.extensions."
                              "filters.http.router.v3.Router")}}],
            "route_config": {
                "name": "local_route",
                "virtual_hosts": [{
                    "name": "backend", "domains": ["*"],
                    "routes": [
                        {"match": {"prefix": "/", "headers": [
                            {"name": debug_header,
                             "string_match": {"exact": debug_value}}]},
                         "route": {"cluster": "service_debug"}},
                        {"match": {"prefix": "/"},
                         "route": {"cluster": "service_production"}},
                    ]}]},
        }}
    return {
        "static_resources": {
            "listeners": [{
                "name": "listener_0",
                "address": {"socket_address": {"address": "0.0.0.0",
                                               "port_value": listen_port}},
                "filter_chains": [{"filters": [hcm]}],
            }],
            "clusters": [cluster("service_debug", debug_host, debug_port),
                         cluster("service_production", upstream_host,
                                 upstream_port)],
        },
        "admin": {"access_log_path": "/dev/null",
                  "address": {"socket_address": {
                      "address": "127.0.0.1",
                      "port_value": ENVOY_ADMIN_PORT}}},
    }


def _attach_envoy_sidecar(pod_spec: Dict[str, Any],
                          container: Dict[str, Any], dep, name: str,
                          ing, ns: str) -> Dict[str, Any]:
    """Front the app container with an Envoy sidecar: the Service port
    lands on Envoy; the app moves to port+1; debug traffic (by header)
    goes to the debug service, the rest to the local app. Returns the
    envoy.yaml ConfigMap manifest to ship alongside."""
    app_port = ing.port + 1
    debug_host = (f"{dep.name}-{ing.debug_service.lower()}.{ns}.svc"
                  if ing.debug_service else "127.0.0.1")
    debug_port = ing.port if ing.debug_service else app_port
    econf = render_envoy_config(ing.port, "127.0.0.1", app_port,
                                ing.debug_header, ing.debug_value,
                                debug_host, debug_port)
    pod_spec.setdefault("volumes", []).append({
        "name": "envoy-config",
        "configMap": {"name": f"{dep.name}-{name.lower()}-envoy"}})
    pod_spec["containers"].append({
        "name": "envoy",
        "image": "envoyproxy/envoy:v1.28-latest",
        "args": ["-c", "/etc/envoy/envoy.yaml"],
        "ports": [{"containerPort": ing.port}],
        "volumeMounts": [{"name": "envoy-config",
                          "mountPath": "/etc/envoy"}],
    })
    container.setdefault("env", []).append(
        {"name": "DYN_HTTP_PORT", "value": str(app_port)})
    return {
        "apiVersion": "v1", "kind": "ConfigMap",
        "metadata": _meta(f"{dep.name}-{name.lower()}-envoy", ns,
                          _labels(dep, name)),
        "data": {"envoy.yaml": dumps(econf)},
    }


def to_yaml(manifests: List[Dict[str, Any]]) -> str:
    """The manifests as one multi-document YAML stream."""
    return "---\n".join(dumps(m) for m in manifests)
