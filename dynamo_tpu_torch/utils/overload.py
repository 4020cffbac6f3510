"""Overload control: admission, bounded queues, priority shedding, brownout.

Under sustained overload an uncontrolled serving plane exhibits congestion
collapse: every request is accepted, queues grow without bound, and each
request burns its full end-to-end deadline before dying as a 504 — goodput
goes to zero exactly when load peaks. This module is the admit/reject
boundary that prevents that:

- **Admission control** (:class:`AdmissionController`): token-bucket rate
  limit plus in-flight concurrency caps at HTTP ingress, answered with an
  immediate 429 + ``Retry-After`` — shed work costs milliseconds, not a
  deadline.
- **Priority classes**: every request carries ``interactive`` or ``batch``
  (the ``x-priority`` header, propagated on the wire envelope). Shedding
  and queue ordering strictly prefer interactive — batch absorbs the pain
  first at every decision point.
- **Bounded stage queues with predictive shedding**
  (:class:`PriorityGate`, plus the bounds in ``llm/disagg.PrefillQueue``):
  hard depth caps, and reject-at-enqueue when the estimated wait
  (queue depth x observed per-item service time) already exceeds the
  request's remaining deadline.
- **SLO-burn-driven brownout** (:class:`BrownoutController`): a small
  controller watches the ``utils/slo.py`` burn rate and steps through
  degradation levels — shed batch, cap ``max_tokens``, disable speculative
  decoding, shed everything — publishing the active level to the store so
  every frontend/router applies it fleet-wide.

Shed-vs-deadline semantics: a *shed* (429) is the plane refusing work it
predicts it cannot finish — it must be decided in milliseconds and costs
the client only a retry. A *deadline expiry* (504) is admitted work that
ran out of budget mid-pipeline. A healthy overloaded plane converts
would-be 504s into fast 429s; ``scripts/overload_soak.py`` asserts exactly
that conversion.

Grounded in FlowKV's load-aware-scheduling argument (PAPERS.md) extended
to the admit/reject boundary.
"""

from __future__ import annotations

import asyncio
import collections
import json
import logging
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..runtime.engine import EngineError
from .knobs import env_float as _env_float

log = logging.getLogger("dynamo_tpu_torch.overload")

# ---------------------------------------------------------------------------
# priority classes
# ---------------------------------------------------------------------------
PRIORITY_INTERACTIVE = "interactive"
PRIORITY_BATCH = "batch"
PRIORITIES = (PRIORITY_INTERACTIVE, PRIORITY_BATCH)
PRIORITY_HEADER = "x-priority"


def parse_priority(raw: Optional[str]) -> str:
    """Header value -> priority class. Absent/empty => interactive (the
    protective default: unaware clients must not be shed first); an unknown
    value raises ValueError (the client's typo — a 400, not a silent
    demotion to batch)."""
    if not raw:
        return PRIORITY_INTERACTIVE
    p = raw.strip().lower()
    if p not in PRIORITIES:
        raise ValueError(
            f"{PRIORITY_HEADER}: {raw!r} (expected one of {PRIORITIES})")
    return p


# ---------------------------------------------------------------------------
# tenancy: who is asking, and on what terms
# ---------------------------------------------------------------------------
TENANT_HEADER = "x-tenant"
DEFAULT_TENANT = "default"
_TENANT_CHARS = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789._-")


def parse_tenant(raw: Optional[str]) -> str:
    """``x-tenant`` header -> tenant id. Absent/empty => ``default``
    (tenancy-unaware clients share one bucket); a malformed id raises
    ValueError (400 — a typo'd tenant silently pooled into ``default``
    would dodge its quota)."""
    if not raw:
        return DEFAULT_TENANT
    t = raw.strip()
    if not t or len(t) > 64 or not set(t) <= _TENANT_CHARS:
        raise ValueError(
            f"{TENANT_HEADER}: {raw!r} (expected 1-64 chars of "
            f"[A-Za-z0-9._-])")
    return t


class OverloadError(EngineError):
    """Typed shed: the plane refused work it predicts it cannot finish.
    Maps to HTTP 429 with ``Retry-After``; ``stage`` names the decision
    point, ``reason`` the rule that fired."""

    def __init__(self, message: str, stage: str, reason: str,
                 retry_after: Optional[float] = None, code: int = 429):
        super().__init__(message, code, stage=stage, reason=reason,
                         retry_after=retry_after)


# ---------------------------------------------------------------------------
# token bucket + admission control (HTTP ingress)
# ---------------------------------------------------------------------------
class TokenBucket:
    """Classic token bucket with an injectable clock (tests use a virtual
    one). ``floor`` lets a caller class refuse to drain the bucket below a
    reserve — batch traffic keeps ``reserve`` tokens standing for
    interactive arrivals."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst)
        self.clock = clock
        self.tokens = float(burst)
        self._last = clock()

    def _refill(self) -> None:
        now = self.clock()
        self.tokens = min(self.burst,
                          self.tokens + (now - self._last) * self.rate)
        self._last = now

    def take(self, n: float = 1.0, floor: float = 0.0) -> bool:
        self._refill()
        if self.tokens - n >= floor - 1e-12:
            self.tokens -= n
            return True
        return False

    def retry_after(self, n: float = 1.0, floor: float = 0.0) -> float:
        """Seconds until ``take(n, floor)`` could succeed at current drain."""
        self._refill()
        deficit = (floor + n) - self.tokens
        if deficit <= 0 or self.rate <= 0:
            return 1.0
        return deficit / self.rate


@dataclass
class AdmissionConfig:
    """``DYN_ADMIT_*`` knobs. Zero/unset disables the corresponding cap —
    a frontend with no knobs set admits everything (legacy behavior)."""

    rps: float = 0.0            # token-bucket refill rate (req/s); 0 = off
    burst: float = 0.0          # bucket size; default 2 x rps
    concurrency: int = 0        # max in-flight requests; 0 = off
    queue: int = 0              # extra in-flight headroom granted ONLY to
                                # interactive traffic (batch rejects at
                                # ``concurrency``); default concurrency//2
    batch_reserve: float = 0.25  # fraction of burst batch may not drain
    # byte-honest KV dimension: in-flight requests are additionally
    # priced in estimated KV bytes (tokens x kv_token_bytes) against a
    # kv_bytes budget, so ONE 128k-context request consumes its true
    # share of the admission envelope instead of one concurrency slot.
    # Both must be > 0 to arm the dimension.
    kv_bytes: float = 0.0       # in-flight KV byte budget; 0 = off
    kv_token_bytes: float = 0.0  # per-token KV price, bytes

    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None
                 ) -> "AdmissionConfig":
        rps = _env_float("DYN_ADMIT_RPS", 0.0, env)
        burst = _env_float("DYN_ADMIT_BURST", 0.0, env) or 2.0 * rps
        conc = int(_env_float("DYN_ADMIT_CONCURRENCY", 0, env))
        queue = int(_env_float("DYN_ADMIT_QUEUE", -1, env))
        if queue < 0:
            queue = conc // 2
        reserve = _env_float("DYN_ADMIT_BATCH_RESERVE", 0.25, env)
        return cls(rps=rps, burst=burst, concurrency=conc, queue=queue,
                   batch_reserve=min(max(reserve, 0.0), 1.0),
                   kv_bytes=_env_float("DYN_ADMIT_KV_BYTES", 0.0, env),
                   kv_token_bytes=_env_float("DYN_ADMIT_KV_TOKEN_BYTES",
                                             0.0, env))


class AdmissionController:
    """Ingress gatekeeper: rate (token bucket) + in-flight concurrency.

    ``try_admit`` either reserves an in-flight slot (caller MUST
    ``release()`` on every exit path) or returns an :class:`OverloadError`
    describing the shed — it never raises, so the HTTP layer stays in
    control of the response. Batch hits both caps earlier than interactive:
    it cannot drain the token bucket below ``batch_reserve x burst``, and
    it gets no share of the ``queue`` headroom above ``concurrency``."""

    def __init__(self, config: Optional[AdmissionConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.config = config or AdmissionConfig()
        c = self.config
        self.bucket = (TokenBucket(c.rps, max(c.burst, 1.0), clock)
                       if c.rps > 0 else None)
        self.inflight = 0
        self.kv_inflight_bytes = 0.0

    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None
                 ) -> "AdmissionController":
        return cls(AdmissionConfig.from_env(env))

    @property
    def enabled(self) -> bool:
        return self.bucket is not None or self.config.concurrency > 0

    def _metrics(self):
        from .prometheus import stage_metrics

        return stage_metrics()

    def _reject(self, reason: str, priority: str,
                retry_after: float) -> OverloadError:
        self._metrics().admission_rejects.inc(reason, priority)
        return OverloadError(
            f"admission rejected ({reason}; priority={priority}): "
            f"server is at capacity, retry after {retry_after:.2f}s",
            stage="admission", reason=reason, retry_after=retry_after)

    def try_admit(self, priority: str = PRIORITY_INTERACTIVE
                  ) -> Optional[OverloadError]:
        c = self.config
        # concurrency BEFORE the bucket: a request the in-flight cap is
        # going to reject must not consume a rate token, or the retries it
        # provokes drain the budget and admittable requests later eat
        # spurious rate_limit 429s
        if c.concurrency > 0:
            limit = c.concurrency
            if priority != PRIORITY_BATCH:
                limit += c.queue
            if self.inflight >= limit:
                return self._reject("concurrency", priority, 1.0)
        if self.bucket is not None:
            floor = c.batch_reserve * self.bucket.burst \
                if priority == PRIORITY_BATCH else 0.0
            if not self.bucket.take(1.0, floor=floor):
                return self._reject("rate_limit", priority,
                                    self.bucket.retry_after(1.0, floor))
        self.inflight += 1
        self._metrics().admission_depth.set(value=self.inflight)
        return None

    def release(self) -> None:
        self.inflight = max(0, self.inflight - 1)
        self._metrics().admission_depth.set(value=self.inflight)

    # ------------------------------------------------------------------
    # byte-honest KV dimension (second gate, once token counts exist)
    # ------------------------------------------------------------------
    @property
    def kv_enabled(self) -> bool:
        c = self.config
        return c.kv_bytes > 0 and c.kv_token_bytes > 0

    def price_kv(self, est_tokens: float) -> float:
        """A request's KV price in bytes (0 when the dimension is off)."""
        return (est_tokens * self.config.kv_token_bytes
                if self.kv_enabled else 0.0)

    def try_reserve_kv(self, kv_bytes: float,
                       priority: str = PRIORITY_INTERACTIVE
                       ) -> Optional[OverloadError]:
        """Reserve ``kv_bytes`` of the in-flight KV budget or explain the
        shed. Runs AFTER the header-stage gate (token counts only exist
        once the body is read); the caller must :meth:`release_kv` the
        same amount on every exit path after a None return. A request
        larger than the whole budget is a 400-shaped client error, not a
        retryable 429 — retrying cannot ever fit it."""
        if kv_bytes <= 0 or not self.kv_enabled:
            return None
        c = self.config
        if kv_bytes > c.kv_bytes:
            self._metrics().admission_rejects.inc("kv_bytes", priority)
            return OverloadError(
                f"request KV working set of {kv_bytes / 1e6:.0f} MB "
                f"exceeds the whole admission budget "
                f"({c.kv_bytes / 1e6:.0f} MB)", stage="admission",
                reason="kv_bytes", code=400)
        if self.kv_inflight_bytes + kv_bytes > c.kv_bytes:
            return self._reject("kv_bytes", priority, 1.0)
        self.kv_inflight_bytes += kv_bytes
        self._metrics().admission_kv_bytes.set(
            value=self.kv_inflight_bytes)
        return None

    def release_kv(self, kv_bytes: float) -> None:
        if kv_bytes <= 0 or not self.kv_enabled:
            return
        self.kv_inflight_bytes = max(0.0, self.kv_inflight_bytes - kv_bytes)
        self._metrics().admission_kv_bytes.set(
            value=self.kv_inflight_bytes)


# ---------------------------------------------------------------------------
# per-tenant quotas: isolation, not capacity management
# ---------------------------------------------------------------------------
@dataclass
class TenantQuota:
    """One tenant's ingress allowance. Zero fields are *uncapped* (a
    tenant with only an rps quota has unlimited concurrency and vice
    versa); a tenant with no quota record at all is ungoverned — only the
    global admission caps apply to it."""

    rps: float = 0.0            # token-bucket refill (req/s); 0 = uncapped
    burst: float = 0.0          # bucket size; default 2 x rps
    concurrency: int = 0        # max in-flight; 0 = uncapped

    @property
    def enabled(self) -> bool:
        return self.rps > 0 or self.concurrency > 0

    def to_dict(self) -> Dict[str, Any]:
        return {"rps": self.rps, "burst": self.burst,
                "concurrency": self.concurrency}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TenantQuota":
        return cls(rps=float(d.get("rps", 0.0)),
                   burst=float(d.get("burst", 0.0)),
                   concurrency=int(d.get("concurrency", 0)))


def tenant_quotas_from_env(env: Optional[Dict[str, str]] = None
                           ) -> Dict[str, TenantQuota]:
    """``DYN_TENANT_QUOTAS`` — a JSON object mapping tenant id to
    ``{"rps": .., "burst": .., "concurrency": ..}``. A malformed table is
    the operator's typo: logged and ignored (never inflicted on clients
    as spurious 429s)."""
    import os

    raw = (os.environ if env is None else env).get("DYN_TENANT_QUOTAS")
    if not raw:
        return {}
    try:
        table = json.loads(raw)
        return {str(t): TenantQuota.from_dict(q)
                for t, q in table.items()}
    except (ValueError, TypeError, AttributeError, json.JSONDecodeError):
        log.warning("ignoring malformed DYN_TENANT_QUOTAS=%r", raw)
        return {}


class TenantAdmission:
    """Per-tenant token buckets + in-flight caps, layered *under* the
    global :class:`AdmissionController` at HTTP ingress.

    A tenant-quota shed is a different beast from an overload shed: it is
    deliberate *isolation* (this tenant exceeded its contract), not a
    capacity signal — so it counts ``dyn_tenant_admission_rejects_total``
    but NOT ``dyn_admission_rejects_total``, keeping the planner's
    rejected-demand scale-up pressure blind to it by design (scaling the
    fleet up must not be how a tenant escapes its quota).

    Metric label cardinality is bounded by construction: only tenants
    present in the quota table get their own label; everyone else is
    ``other`` (tenant ids are client-controlled strings).

    ``set_quotas`` applies live updates (the fleet registry watch feeds
    it) while *preserving* the bucket level of unchanged quotas — a
    registry refresh must not hand every hog a freshly full bucket."""

    def __init__(self, quotas: Optional[Dict[str, TenantQuota]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.quotas: Dict[str, TenantQuota] = {}
        self._buckets: Dict[str, TokenBucket] = {}
        self._inflight: Dict[str, int] = {}
        self.set_quotas(quotas or {})

    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None
                 ) -> "TenantAdmission":
        return cls(tenant_quotas_from_env(env))

    @property
    def enabled(self) -> bool:
        return any(q.enabled for q in self.quotas.values())

    def label(self, tenant: str) -> str:
        """Bounded-cardinality metric label for ``tenant``: quota-table
        tenants and the built-in default keep their name, every other
        client-controlled string collapses to ``other``."""
        if tenant in self.quotas or tenant == DEFAULT_TENANT:
            return tenant
        return "other"

    def set_quotas(self, quotas: Dict[str, TenantQuota]) -> None:
        for tenant, q in quotas.items():
            old = self.quotas.get(tenant)
            if q.rps > 0 and (old is None or old.rps != q.rps
                              or old.burst != q.burst
                              or tenant not in self._buckets):
                burst = q.burst if q.burst > 0 else 2.0 * q.rps
                self._buckets[tenant] = TokenBucket(
                    q.rps, max(burst, 1.0), clock=self.clock)
            elif q.rps <= 0:
                self._buckets.pop(tenant, None)
        for tenant in list(self._buckets):
            if tenant not in quotas:
                self._buckets.pop(tenant)
        self.quotas = dict(quotas)

    def _reject(self, tenant: str, priority: str, reason: str,
                retry_after: float) -> OverloadError:
        from .prometheus import stage_metrics

        stage_metrics().tenant_rejects.inc(self.label(tenant), reason)
        return OverloadError(
            f"tenant {tenant!r} over quota ({reason}; "
            f"priority={priority}): retry after {retry_after:.2f}s",
            stage="admission", reason=reason, retry_after=retry_after)

    def try_admit(self, tenant: str,
                  priority: str = PRIORITY_INTERACTIVE
                  ) -> Optional[OverloadError]:
        """Reserve a tenant slot or explain the shed. The caller MUST
        :meth:`release` on every exit path after a None return — same
        contract as :class:`AdmissionController`. Unquota'd tenants are
        admitted without bookkeeping (release is a no-op for them)."""
        q = self.quotas.get(tenant)
        if q is None or not q.enabled:
            return None
        held = self._inflight.get(tenant, 0)
        if q.concurrency > 0 and held >= q.concurrency:
            return self._reject(tenant, priority, "tenant_concurrency", 1.0)
        bucket = self._buckets.get(tenant)
        if bucket is not None and not bucket.take(1.0):
            return self._reject(tenant, priority, "tenant_rate",
                                bucket.retry_after(1.0))
        self._inflight[tenant] = held + 1
        from .prometheus import stage_metrics

        stage_metrics().tenant_inflight.set(self.label(tenant),
                                            value=held + 1)
        return None

    def release(self, tenant: str) -> None:
        held = self._inflight.get(tenant)
        if held is None:
            return
        self._inflight[tenant] = max(held - 1, 0)
        from .prometheus import stage_metrics

        stage_metrics().tenant_inflight.set(self.label(tenant),
                                            value=self._inflight[tenant])


def tenant_availability_objective(env: Optional[Dict[str, str]] = None
                                  ) -> Optional[float]:
    """``DYN_TENANT_AVAILABILITY`` — per-tenant good-request fraction
    objective (e.g. 0.99). Unset/invalid = tenant burn not monitored."""
    import os

    raw = (os.environ if env is None else env).get("DYN_TENANT_AVAILABILITY")
    if not raw:
        return None
    try:
        v = float(raw)
    except ValueError:
        log.warning("ignoring malformed DYN_TENANT_AVAILABILITY=%r", raw)
        return None
    return v if 0.0 < v < 1.0 else None


def tenant_request_totals(states) -> Dict[str, Tuple[float, float]]:
    """{tenant: (total, bad)} cumulative request counts from the
    ``dyn_tenant_requests_total{tenant,status}`` series frontends
    publish. bad = 5xx (server-fault); 429s are the tenant's own quota
    and 4xx its own input — neither burns the *server's* budget."""
    out: Dict[str, List[float]] = {}
    for _component, dump in states:
        st = dump.get("dyn_tenant_requests_total")
        if not st or st.get("kind") != "counter":
            continue
        labels = list(st.get("labels") or ())
        try:
            t_pos = labels.index("tenant")
            s_pos = labels.index("status")
        except ValueError:
            continue
        for skey, val in st.get("series", {}).items():
            parts = skey.split("\x1f")
            if len(parts) <= max(t_pos, s_pos):
                continue
            acc = out.setdefault(parts[t_pos], [0.0, 0.0])
            acc[0] += val
            try:
                if int(parts[s_pos]) >= 500:
                    acc[1] += val
            except ValueError:
                pass
    return {t: (v[0], v[1]) for t, v in out.items()}


class TenantBurnTracker:
    """Per-tenant availability error-budget burn over the published
    stage dumps — the tenant-scoped SLO signal the brownout ladder (and
    dyntop) consume. Same cumulative-snapshot-ring recipe as
    ``utils/slo.SloMonitor``, one ring per tenant, worst window wins."""

    def __init__(self, objective: float,
                 windows: Optional[Tuple[float, ...]] = None,
                 clock: Callable[[], float] = time.monotonic):
        from .slo import windows_from_env

        self.objective = objective
        self.budget = max(1.0 - objective, 1e-9)
        self.windows = tuple(windows or windows_from_env())
        self.clock = clock
        self._rings: Dict[str, collections.deque] = {}
        self._last: Dict[str, float] = {}

    def observe(self, states, now: Optional[float] = None
                ) -> Dict[str, float]:
        """{tenant: worst-window burn}; also exports the
        ``dyn_tenant_slo_burn`` gauge per tenant seen."""
        now = self.clock() if now is None else now
        from .prometheus import stage_metrics

        out: Dict[str, float] = {}
        horizon = now - max(self.windows) - 1.0
        for tenant, (total, bad) in tenant_request_totals(states).items():
            ring = self._rings.setdefault(tenant, collections.deque())
            ring.append((now, total, bad))
            while len(ring) > 2 and ring[1][0] < horizon:
                ring.popleft()
            worst = 0.0
            for w in self.windows:
                base_t, base_total, base_bad = ring[0]
                for ts, t_, b_ in ring:
                    if ts <= now - w:
                        base_t, base_total, base_bad = ts, t_, b_
                    else:
                        break
                d_total = total - base_total
                if d_total > 0:
                    worst = max(worst,
                                ((bad - base_bad) / d_total) / self.budget)
            out[tenant] = worst
            stage_metrics().tenant_burn.set(tenant, value=worst)
        self._last = out
        return out

    def worst(self) -> float:
        return max(self._last.values(), default=0.0)


def estimate_request_tokens(oai_req) -> float:
    """Crude ingress-side token estimate for KV-byte pricing: prompt
    characters (exact for the byte tokenizer, a safe overestimate for
    BPE) plus the requested ``max_tokens`` (256 when unset). Runs before
    tokenization, so it is a pricing heuristic, not an accounting truth —
    the engine's paged-admission check re-prices exactly in blocks."""
    chars = 0
    prompt = getattr(oai_req, "prompt", None)
    if isinstance(prompt, str):
        chars = len(prompt)
    elif isinstance(prompt, (list, tuple)):
        chars = sum(len(p) if isinstance(p, str) else 1 for p in prompt)
    for msg in getattr(oai_req, "messages", None) or ():
        content = msg.get("content") if isinstance(msg, dict) else None
        if isinstance(content, str):
            chars += len(content)
        elif isinstance(content, (list, tuple)):
            for part in content:
                if isinstance(part, dict):
                    chars += len(str(part.get("text", "")))
    return float(chars) + float(getattr(oai_req, "max_tokens", None) or 256)


# ---------------------------------------------------------------------------
# predictive shed math
# ---------------------------------------------------------------------------
def predicted_wait(depth: float, service_s: Optional[float],
                   servers: int = 1) -> Optional[float]:
    """Estimated queue wait: ``depth`` items ahead, each costing
    ``service_s`` seconds, drained by ``servers`` parallel consumers. None
    when no service-time observation exists yet (never shed blind)."""
    if service_s is None or service_s <= 0:
        return None
    return depth * service_s / max(servers, 1)


def should_shed(depth: float, service_s: Optional[float],
                remaining_s: Optional[float], servers: int = 1) -> bool:
    """True when the estimated wait alone already exceeds the request's
    remaining deadline budget — the work is doomed; fail it in
    milliseconds instead of letting it burn the deadline in a queue. A
    request with no deadline is never predictively shed (nothing to burn)."""
    if remaining_s is None:
        return False
    wait = predicted_wait(depth, service_s, servers)
    return wait is not None and wait > remaining_s


def histogram_mean(hist) -> Optional[float]:
    """Mean observation of an in-process ``utils.prometheus.Histogram``
    across all its label series (diagnostics helper; the live shed paths
    use their own :class:`ServiceTimeEstimator` EWMAs, which react faster
    than a lifetime-cumulative mean)."""
    st = hist.state()
    total = sum(s.get("total", 0) for s in st.get("series", {}).values())
    if not total:
        return None
    return sum(s.get("sum", 0.0)
               for s in st.get("series", {}).values()) / total


class ServiceTimeEstimator:
    """EWMA of observed per-item service seconds; cheap, process-local,
    and robust to the cold start (None until the first observation)."""

    def __init__(self, alpha: float = 0.2):
        self.alpha = alpha
        self._mean: Optional[float] = None

    def observe(self, seconds: float) -> None:
        if seconds < 0:
            return
        self._mean = seconds if self._mean is None else \
            (1 - self.alpha) * self._mean + self.alpha * seconds

    def mean(self) -> Optional[float]:
        return self._mean


# ---------------------------------------------------------------------------
# worker ingress: bounded slot gate with strict priority wakeup
# ---------------------------------------------------------------------------
class PriorityGate:
    """Counted engine slots with bounded, priority-ordered wait queues.

    ``acquire`` hands out a slot immediately when one is free; otherwise
    the caller waits in its priority's queue — ``release`` ALWAYS wakes an
    interactive waiter before any batch waiter, so batch traffic absorbs
    queueing pain first. Before waiting, two shed rules run:

    - hard depth bound per priority (batch's bound is lower), and
    - predictive shed: estimated wait (position x observed service time /
      slots) already exceeds the remaining deadline.

    Both raise :class:`OverloadError` (stage ``worker_queue``) in
    microseconds and count ``dyn_queue_shed_total``.
    """

    def __init__(self, slots: int, max_queue: int = 0,
                 max_queue_batch: Optional[int] = None,
                 stage: str = "worker_queue"):
        self.slots = max(int(slots), 1)
        self.free = self.slots
        self.max_queue = int(max_queue)
        self.max_queue_batch = (self.max_queue // 2
                                if max_queue_batch is None
                                else int(max_queue_batch))
        self.stage = stage
        self.service = ServiceTimeEstimator()
        self._waiters: Dict[str, collections.deque] = {
            p: collections.deque() for p in PRIORITIES}

    @property
    def waiting(self) -> int:
        return sum(len(q) for q in self._waiters.values())

    def _shed(self, reason: str, priority: str,
              retry_after: float = 1.0) -> OverloadError:
        from .prometheus import stage_metrics

        stage_metrics().queue_shed.inc(self.stage)
        return OverloadError(
            f"{self.stage} shed ({reason}; priority={priority}): "
            f"{self.waiting} waiting on {self.slots} slots",
            stage=self.stage, reason=reason, retry_after=retry_after)

    def check(self, priority: str,
              deadline: Optional[float]) -> Optional[OverloadError]:
        """The shed decision alone (no slot state change): depth bound,
        then predictive wait vs the remaining deadline."""
        if self.free > 0 and self.waiting == 0:
            return None
        # batch's bound is lower but counts TOTAL waiters: interactive
        # backlog alone is enough to close the door on batch — strictly
        # prefer interactive at every decision point
        bound = (self.max_queue_batch if priority == PRIORITY_BATCH
                 else self.max_queue)
        if self.waiting >= bound:
            svc = self.service.mean() or 0.0
            return self._shed("queue_full", priority,
                              retry_after=max(svc, 0.05))
        from ..runtime import deadline as dl

        remaining = dl.remaining(deadline)
        # this request's position in line: everyone already waiting (plus
        # itself) over the parallel slots
        if should_shed(self.waiting + 1, self.service.mean(), remaining,
                       servers=self.slots):
            wait = predicted_wait(self.waiting + 1, self.service.mean(),
                                  self.slots) or 1.0
            return self._shed("predicted_late", priority,
                              retry_after=wait)
        return None

    async def acquire(self, priority: str,
                      deadline: Optional[float]) -> None:
        """Take a slot, waiting (deadline-bounded) in priority order.
        Raises :class:`OverloadError` on shed, ``DeadlineExceeded`` when
        the deadline fires while queued."""
        rej = self.check(priority, deadline)
        if rej is not None:
            raise rej
        if self.free > 0 and self.waiting == 0:
            self.free -= 1
            return
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._waiters[priority].append(fut)
        from ..runtime import deadline as dl

        try:
            await dl.wait_for(fut, deadline, self.stage)
        except BaseException:
            if fut.done() and not fut.cancelled():
                # the slot handoff raced the expiry/cancel: give it back
                self._release_slot()
            else:
                try:
                    self._waiters[priority].remove(fut)
                except ValueError:
                    pass
                fut.cancel()
            raise

    def _release_slot(self) -> None:
        for p in PRIORITIES:            # strict order: interactive first
            q = self._waiters[p]
            while q:
                fut = q.popleft()
                if not fut.done():
                    fut.set_result(None)
                    return
        self.free = min(self.free + 1, self.slots)

    def release(self, service_s: Optional[float] = None) -> None:
        if service_s is not None:
            self.service.observe(service_s)
            from .prometheus import stage_metrics

            stage_metrics().stage_service.observe("worker", value=service_s)
        self._release_slot()


class SlotGatedEngine:
    """AsyncEngine wrapper enforcing a :class:`PriorityGate` around every
    ``generate`` stream — the worker-ingress bound of the overload plane."""

    def __init__(self, engine, gate: PriorityGate):
        self.engine = engine
        self.gate = gate

    async def generate(self, request, context):
        await self.gate.acquire(getattr(context, "priority",
                                        PRIORITY_INTERACTIVE),
                                getattr(context, "deadline", None))
        started = time.monotonic()
        try:
            async for item in self.engine.generate(request, context):
                yield item
        finally:
            self.gate.release(time.monotonic() - started)


def gate_from_env(env: Optional[Dict[str, str]] = None
                  ) -> Optional[PriorityGate]:
    """``DYN_WORKER_SLOTS`` (0/unset = no gate), ``DYN_WORKER_QUEUE_DEPTH``
    (default 2 x slots), ``DYN_WORKER_BATCH_QUEUE_DEPTH`` (default half the
    interactive bound)."""
    slots = int(_env_float("DYN_WORKER_SLOTS", 0, env))
    if slots <= 0:
        return None
    max_q = int(_env_float("DYN_WORKER_QUEUE_DEPTH", 2 * slots, env))
    batch_q = int(_env_float("DYN_WORKER_BATCH_QUEUE_DEPTH", -1, env))
    return PriorityGate(slots, max_queue=max_q,
                        max_queue_batch=None if batch_q < 0 else batch_q)


# ---------------------------------------------------------------------------
# SLO-burn-driven brownout
# ---------------------------------------------------------------------------
LEVEL_NORMAL = 0          # full service
LEVEL_SHED_BATCH = 1      # batch traffic rejected at ingress
LEVEL_CAP_TOKENS = 2      # + max_tokens capped (shrink work per request)
LEVEL_NO_SPEC = 3         # + speculative decoding's extra programs off
LEVEL_SHED_ALL = 4        # all new work rejected (survival mode)
MAX_LEVEL = LEVEL_SHED_ALL

LEVEL_NAMES = {
    LEVEL_NORMAL: "normal",
    LEVEL_SHED_BATCH: "shed_batch",
    LEVEL_CAP_TOKENS: "cap_tokens",
    LEVEL_NO_SPEC: "no_spec",
    LEVEL_SHED_ALL: "shed_all",
}


def sheds_batch(level: int) -> bool:
    return level >= LEVEL_SHED_BATCH


def max_tokens_cap(level: int,
                   env: Optional[Dict[str, str]] = None) -> Optional[int]:
    """The brownout ``max_tokens`` ceiling (``DYN_BROWNOUT_MAX_TOKENS``,
    default 256) — None below the cap level."""
    if level < LEVEL_CAP_TOKENS:
        return None
    return int(_env_float("DYN_BROWNOUT_MAX_TOKENS", 256, env))


def disables_spec(level: int) -> bool:
    return level >= LEVEL_NO_SPEC


def sheds_all(level: int) -> bool:
    return level >= LEVEL_SHED_ALL


def brownout_reject(priority: str, level: int) -> Optional[OverloadError]:
    """The ingress brownout decision: shed everything at L4+, shed batch
    at L1+. Counted as admission rejects (it IS the admission boundary)."""
    if sheds_all(level):
        reason = "brownout_shed_all"
    elif priority == PRIORITY_BATCH and sheds_batch(level):
        reason = "brownout_batch"
    else:
        return None
    from .prometheus import stage_metrics

    stage_metrics().admission_rejects.inc(reason, priority)
    return OverloadError(
        f"brownout level {level} ({LEVEL_NAMES.get(level, '?')}): "
        f"{priority} traffic is being shed until the SLO burn recovers",
        stage="admission", reason=reason, retry_after=5.0)


class BrownoutController:
    """Steps the degradation level on the SLO burn rate, with hysteresis.

    - step UP one level when burn >= ``up_burn`` and ``dwell_up`` seconds
      have passed since the last change (the dwell lets the previous
      level's relief land before escalating);
    - step DOWN one level only when burn <= ``down_burn`` (strictly below
      the up threshold — the hysteresis band) for ``dwell_down`` seconds.

    Deterministic and clock-injected; the store publication / gauge export
    live on :class:`BrownoutMonitor` so this core is unit-testable with a
    virtual clock."""

    def __init__(self, up_burn: float = 2.0, down_burn: float = 0.75,
                 dwell_up: float = 5.0, dwell_down: float = 30.0,
                 max_level: int = MAX_LEVEL,
                 clock: Callable[[], float] = time.monotonic):
        if down_burn >= up_burn:
            raise ValueError(f"hysteresis requires down_burn < up_burn "
                             f"({down_burn} >= {up_burn})")
        self.up_burn = up_burn
        self.down_burn = down_burn
        self.dwell_up = dwell_up
        self.dwell_down = dwell_down
        self.max_level = max_level
        self.clock = clock
        self.level = LEVEL_NORMAL
        self._last_change = float("-inf")
        self._calm_since: Optional[float] = None

    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None,
                 clock: Callable[[], float] = time.monotonic
                 ) -> "BrownoutController":
        return cls(
            up_burn=_env_float("DYN_BROWNOUT_UP_BURN", 2.0, env),
            down_burn=_env_float("DYN_BROWNOUT_DOWN_BURN", 0.75, env),
            dwell_up=_env_float("DYN_BROWNOUT_DWELL_UP", 5.0, env),
            dwell_down=_env_float("DYN_BROWNOUT_DWELL_DOWN", 30.0, env),
            max_level=int(_env_float("DYN_BROWNOUT_MAX_LEVEL",
                                     MAX_LEVEL, env)),
            clock=clock)

    def update(self, burn: float, now: Optional[float] = None) -> int:
        now = self.clock() if now is None else now
        if burn >= self.up_burn:
            self._calm_since = None
            if (self.level < self.max_level
                    and now - self._last_change >= self.dwell_up):
                self.level += 1
                self._last_change = now
                log.warning("brownout step UP -> L%d (%s): burn %.2f",
                            self.level, LEVEL_NAMES[self.level], burn)
        elif burn <= self.down_burn and self.level > LEVEL_NORMAL:
            if self._calm_since is None:
                self._calm_since = now
            if now - self._calm_since >= self.dwell_down:
                self.level -= 1
                self._last_change = now
                self._calm_since = now
                log.info("brownout step DOWN -> L%d (%s): burn %.2f",
                         self.level, LEVEL_NAMES[self.level], burn)
        else:
            # the hysteresis band (down_burn, up_burn): hold, reset calm
            self._calm_since = None
        return self.level


# ---------------------------------------------------------------------------
# brownout store plane: the level is fleet state, not process state
# ---------------------------------------------------------------------------
BROWNOUT_PREFIX = "overload/"


def brownout_key(namespace: str) -> str:
    return f"{BROWNOUT_PREFIX}{namespace}/brownout"


async def publish_brownout(store, namespace: str, level: int,
                           burn: float = 0.0,
                           lease: Optional[int] = None) -> None:
    """Write the active level; lease-bound when the caller passes its lease
    so a dead controller's brownout expires instead of pinning the fleet
    degraded forever."""
    payload = json.dumps({"level": int(level),
                          "name": LEVEL_NAMES.get(int(level), "?"),
                          "burn": round(float(burn), 3),
                          "at": time.time()}).encode()
    await store.put(brownout_key(namespace), payload, lease=lease)


class BrownoutState:
    """A process's view of the fleet brownout level. Plain holder (level 0)
    until :meth:`watch` arms it against the store — frontends and routers
    read ``.level`` on every request with zero RPCs."""

    def __init__(self, level: int = LEVEL_NORMAL):
        self.level = int(level)

    async def watch(self, store, namespace: str) -> "BrownoutState":
        key = brownout_key(namespace)

        def apply(value: Optional[bytes], deleted: bool) -> None:
            if deleted or not value:
                self.level = LEVEL_NORMAL
                return
            try:
                self.level = int(json.loads(value.decode()).get("level", 0))
            except (ValueError, json.JSONDecodeError):
                log.warning("ignoring malformed brownout state: %r", value)

        async def on_change(k: str, value: Optional[bytes], deleted: bool):
            if k == key:
                apply(value, deleted)

        snapshot = await store.watch_prefix(key, on_change)
        for k, value in snapshot:
            if k == key:
                apply(value, False)
        return self


class BrownoutMonitor:
    """The standing controller: each tick reads the fleet's published
    stage-metric dumps, folds them through an ``SloMonitor``, steps the
    :class:`BrownoutController` on the worst burn, and publishes level
    changes to the store. Run it inside the planner (``--brownout``) or
    standalone (the overload soak drives :meth:`tick` directly)."""

    def __init__(self, store, namespace: str,
                 controller: Optional[BrownoutController] = None,
                 slo_monitor=None, lease: Optional[int] = None):
        from .slo import SloMonitor

        self.store = store
        self.namespace = namespace
        self.controller = controller or BrownoutController.from_env()
        # gauge=None: the brownout gauge below is the published series;
        # whoever also exports SLO burn does so via its own monitor
        self.slo = slo_monitor or SloMonitor(registry_gauge=None)
        self.lease = lease
        self._published: Optional[int] = None
        # tenant-scoped burn (DYN_TENANT_AVAILABILITY): one tenant's
        # server-fault failures step the ladder even when the fleet
        # aggregate still looks healthy — per-tenant SLOs are promises,
        # not averages
        obj = tenant_availability_objective()
        self.tenant_burn = TenantBurnTracker(obj) if obj else None

    async def apply(self, burn: float) -> int:
        """Step the controller on ``burn``, export the gauge, publish the
        level to the store when it changed (a failed publish retries on
        the next call). The ONE implementation of the level-publication
        protocol — the planner's ``--brownout`` path feeds its own burn
        signal through here too."""
        level = self.controller.update(burn)
        from .prometheus import stage_metrics

        stage_metrics().brownout_level.set(value=level)
        if level != self._published:
            try:
                await publish_brownout(self.store, self.namespace, level,
                                       burn, lease=self.lease)
                self._published = level
            except Exception:  # noqa: BLE001 - store mid-outage: retry next
                log.warning("brownout publish skipped", exc_info=True)
        return level

    async def tick(self, states=None) -> int:
        if states is None:
            from ..llm.metrics_aggregator import fetch_stage_states

            states = await fetch_stage_states(self.store, self.namespace)
        burns = self.slo.observe(states) if self.slo.objectives else {}
        burn = max((b for per_w in burns.values()
                    for b in per_w.values()), default=0.0)
        if self.tenant_burn is not None:
            self.tenant_burn.observe(states)
            burn = max(burn, self.tenant_burn.worst())
        return await self.apply(burn)

    async def run(self, interval: float = 1.0) -> None:
        while True:
            try:
                await self.tick()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 - one bad tick must not stop
                log.exception("brownout tick failed")
            await asyncio.sleep(interval)


# ---------------------------------------------------------------------------
# cluster-dump readers (dyntop / planner signals)
# ---------------------------------------------------------------------------
def _sum_counter(states, name: str) -> float:
    total = 0.0
    for _component, dump in states:
        st = dump.get(name)
        if not st or st.get("kind") != "counter":
            continue
        total += sum(st.get("series", {}).values())
    return total


def shed_totals(states) -> float:
    """Cumulative shed events across the fleet: admission rejects + stage
    queue sheds, summed over every published dump."""
    return (_sum_counter(states, "dyn_admission_rejects_total")
            + _sum_counter(states, "dyn_queue_shed_total"))


def admission_depth_total(states) -> float:
    """Sum of the per-frontend admission in-flight gauges."""
    total = 0.0
    for _component, dump in states:
        st = dump.get("dyn_admission_queue_depth")
        if not st or st.get("kind") != "gauge":
            continue
        total += sum(st.get("series", {}).values())
    return total


def brownout_level_from_states(states) -> int:
    """Worst published brownout level across dumps (the fleet level is a
    single store key, but each exporter mirrors it as a gauge)."""
    worst = 0
    for _component, dump in states:
        st = dump.get("dyn_brownout_level")
        if not st or st.get("kind") != "gauge":
            continue
        for v in st.get("series", {}).values():
            worst = max(worst, int(v))
    return worst
