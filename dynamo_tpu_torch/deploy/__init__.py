"""Cluster deployment layer (L7): deployment resources, the reconciling
operator, k8s manifest rendering, and the artifact/api store.

Reference capability: deploy/dynamo/operator (Go CRDs + controllers),
deploy/dynamo/api-store (FastAPI artifact store), deploy/dynamo/helm and
deploy/Kubernetes (charts). Re-designed for this stack: desired state lives
in dynstore (the discovery plane we already run), the operator reconciles it
into local worker processes on granted CUDA cards, and :mod:`kube`
reconciles rendered manifests against a Kubernetes API (server-side apply,
owner-ref GC, conditions). The artifact store is an HTTP service on the
port's own server over pluggable object storage (:mod:`object_store`: local
filesystem or S3-compatible); :mod:`imagebuild` packages graph sources into
OCI build contexts.

The JAX package's ``dynamo_tpu/deploy`` with the same names, store keys and
resource JSON; each module's docstring says where it differs.
"""

from .crd import (Condition, Deployment, DeploymentSpec, DeploymentStatus,
                  IngressSpec, ServiceSpec)
from .kube import FakeKubeApi, KubeReconciler
from .manifests import render_envoy_config, render_ingress, render_manifests
from .object_store import LocalFsStore, MinioStub, ObjectStore, S3Store, open_object_store
from .operator import FakeRunner, LocalRunner, Operator
from .rest_api import KubeApiError, RestKubeApi, register_kind

__all__ = [
    "Condition", "Deployment", "DeploymentSpec", "DeploymentStatus",
    "ServiceSpec", "IngressSpec", "Operator", "LocalRunner", "FakeRunner",
    "KubeReconciler", "FakeKubeApi",
    "RestKubeApi", "KubeApiError", "register_kind",
    "render_manifests", "render_ingress", "render_envoy_config",
    "ObjectStore", "LocalFsStore", "S3Store", "MinioStub",
    "open_object_store",
]
