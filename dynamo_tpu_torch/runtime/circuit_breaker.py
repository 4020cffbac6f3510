"""Per-instance circuit breaker for data-plane clients.

The :class:`Client` failover path used to keep a per-CALL ``failed`` set: an
instance that refused a connection was skipped for the rest of that one
request, then retried from scratch by the next — under churn every request
burned a connect timeout on the same dead worker. The breaker keeps
CROSS-request accounting per instance:

- ``closed``    — healthy, routable.
- ``open``      — >= ``threshold`` consecutive connect/exchange failures;
  not routable until ``cooldown`` seconds pass.
- ``half_open`` — cooldown elapsed; routable so the next request acts as the
  probe. Success closes the circuit, failure re-opens it (fresh cooldown).

Knobs (env, read at construction): ``DYN_CB_THRESHOLD`` (consecutive
failures to open, default 3; ``0`` disables the breaker), ``DYN_CB_COOLDOWN``
(seconds open before the half-open probe, default 5).

State per instance is exported on ``dyn_circuit_state`` (0 closed,
1 half-open, 2 open). Mirrors the reference's NATS-client reconnect-throttle
role; etcd-watch membership remains the authoritative live set — the breaker
only vetoes instances the watch still believes in.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List

from ..utils.knobs import env_float as _env_float

log = logging.getLogger("dynamo_tpu_torch.circuit")

CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
_STATE_VALUE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class _Entry:
    __slots__ = ("failures", "opened_at")

    def __init__(self) -> None:
        self.failures = 0
        self.opened_at = 0.0        # 0 => never opened / currently closed


class InstanceBreaker:
    """Cross-request failure accounting for one Client's instance set."""

    def __init__(self, threshold: int = None, cooldown: float = None):
        self.threshold = int(_env_float("DYN_CB_THRESHOLD", 3)) \
            if threshold is None else threshold
        self.cooldown = _env_float("DYN_CB_COOLDOWN", 5.0) \
            if cooldown is None else cooldown
        self._entries: Dict[int, _Entry] = {}

    # ------------------------------------------------------------------
    def state(self, iid: int) -> str:
        e = self._entries.get(iid)
        if e is None or not e.opened_at:
            return CLOSED
        if time.monotonic() - e.opened_at >= self.cooldown:
            return HALF_OPEN
        return OPEN

    def allow(self, iid: int) -> bool:
        """May a new request be routed to this instance right now?"""
        if self.threshold <= 0:
            return True
        return self.state(iid) is not OPEN

    def filter(self, ids: List[int]) -> List[int]:
        """Routable subset. If the breaker would veto EVERY live instance,
        it stands down (returns ``ids`` unchanged): total unavailability
        must come from the membership plane, never from the breaker."""
        if self.threshold <= 0:
            return ids
        allowed = [i for i in ids if self.allow(i)]
        return allowed or ids

    # ------------------------------------------------------------------
    def record_failure(self, iid: int) -> None:
        if self.threshold <= 0:
            return
        e = self._entries.setdefault(iid, _Entry())
        was = self.state(iid)
        e.failures += 1
        if e.failures >= self.threshold or was is HALF_OPEN:
            # threshold crossed, or the half-open probe failed: (re)open
            e.opened_at = time.monotonic()
            if was is not OPEN:
                log.warning("instance %x circuit OPEN after %d consecutive "
                            "failures (cooldown %.1fs)", iid, e.failures,
                            self.cooldown)
                # breaker trip = incident trigger: freeze fleet rings
                # around the moment the instance went dark (no-op in
                # processes without an incident manager)
                from ..obs import incidents as _incidents

                _incidents.trigger("breaker_trip", instance=f"{iid:x}",
                                   failures=e.failures)
        self._export(iid)

    def record_success(self, iid: int) -> None:
        e = self._entries.get(iid)
        if e is None:
            return
        if e.opened_at:
            log.info("instance %x circuit closed (probe succeeded)", iid)
        e.failures = 0
        e.opened_at = 0.0
        self._export(iid)

    def forget(self, iid: int) -> None:
        """Instance deregistered: drop accounting + its exported series."""
        if self._entries.pop(iid, None) is not None:
            from ..utils.prometheus import stage_metrics

            stage_metrics().circuit_state.clear_label(1, f"{iid:x}")

    # ------------------------------------------------------------------
    def _export(self, iid: int) -> None:
        from ..utils.prometheus import stage_metrics

        stage_metrics().circuit_state.set(
            str(os.getpid()), f"{iid:x}",
            value=_STATE_VALUE[self.state(iid)])
