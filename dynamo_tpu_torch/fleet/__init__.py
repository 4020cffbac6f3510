"""Fleet plane: one cluster, many models, per-tenant SLOs.

The reference serves many models from one deployment — ``llmctl http
add/remove`` makes model membership a *runtime* operation backed by a
``ModelDeploymentCard``. This package is that capability generalized into
a desired-state control plane:

- :mod:`registry` — the store-backed model registry (``fleet_models/``
  desired state written by ``ctl fleet add``, ``fleet_status/`` observed
  state published lease-bound by the planner) plus the live
  :class:`~registry.FleetRegistry` watcher every consumer arms;
- :mod:`arbiter` — the pure chip-arbitration core: N model pools, one
  global chip budget, allocation ordered by (priority, SLO burn) with a
  preemption-hysteresis margin so a borderline burn difference does not
  thrash replicas between models;
- :mod:`plane` — :class:`~plane.FleetPlane`, the binding that turns the
  existing single-pool-pair planner into an N-model-pool reconciler:
  pools/clamps/connector specs follow the registry live, decisions pass
  through the arbiter, scale-ups actuate before scale-downs so a cold
  boot's weight load overlaps the donor pool's drain (PRESERVE's
  overlap argument applied to scale-to-zero).
"""

from .arbiter import ChipArbiter
from .registry import (
    FLEET_MODELS_PREFIX,
    FLEET_STATUS_PREFIX,
    FleetModelSpec,
    FleetRegistry,
    fleet_model_key,
    fleet_models_prefix,
    fleet_status_key,
    fleet_status_prefix,
    get_fleet_model,
    list_fleet_models,
    put_fleet_model,
    remove_fleet_model,
)
from .plane import FleetPlane

__all__ = [
    "ChipArbiter",
    "FLEET_MODELS_PREFIX",
    "FLEET_STATUS_PREFIX",
    "FleetModelSpec",
    "FleetPlane",
    "FleetRegistry",
    "fleet_model_key",
    "fleet_models_prefix",
    "fleet_status_key",
    "fleet_status_prefix",
    "get_fleet_model",
    "list_fleet_models",
    "put_fleet_model",
    "remove_fleet_model",
]
