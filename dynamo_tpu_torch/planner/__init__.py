"""SLA-driven planner: the closed-loop autoscaler for prefill/decode fleets.

The planner is the standing control loop between the observability plane
(cluster metrics aggregation — TTFT/ITL histograms, queue wait, batch
occupancy) and the safe-actuation plane (graceful drain, lease-based
deregistration, circuit breaker). It observes per-pool signals, decides
replica counts under a pluggable policy, and actuates through a connector:

- :mod:`signals`     — what the planner sees (PoolSignals + collectors)
- :mod:`policy`      — how it decides (LoadPolicy, SlaPolicy)
- :mod:`profile`     — the SLA policy's profile table + the sweep that
  produces it (real engine or synthetic mock)
- :mod:`connectors`  — how decisions become replicas (local process spawn /
  graceful drain, Kubernetes CRD patch)
- :mod:`loop`        — the control loop itself (cooldown, flap damping,
  clamps, dry-run, store publishing, dyn_planner_* metrics)

Reference capability: the architecture's "Planner" box ("watches load and
adds/removes prefill and decode workers at runtime") — envisioned in the
reference docs, implemented here.
"""

from .connectors import KubeConnector, LocalConnector, NullConnector
from .loop import Planner, PlannerConfig, decisions_prefix, planner_prefix
from .policy import Decision, LoadPolicy, PlannerCore, SlaPolicy
from .profile import ProfileTable, SyntheticCore, run_profile
from .signals import PoolSignals, SignalCollector

__all__ = [
    "Decision", "KubeConnector", "LoadPolicy", "LocalConnector",
    "NullConnector", "Planner", "PlannerConfig", "PlannerCore",
    "PoolSignals", "ProfileTable", "SignalCollector", "SlaPolicy",
    "SyntheticCore", "decisions_prefix", "planner_prefix", "run_profile",
]
