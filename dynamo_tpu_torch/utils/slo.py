"""SLO burn-rate monitor: declarative objectives over the merged stage
histograms.

An objective is "fraction of good events >= objective" — e.g.
``DYN_SLO_TTFT_P90=0.5`` declares "90% of requests see TTFT <= 0.5s".
The monitor periodically snapshots the cumulative (total, bad) counts it
can derive from published metric state dumps (the same
``(component, state_dump)`` pairs ``render_states`` and the planner's
quantile estimator already consume), and computes **multi-window burn
rates**:

    burn(window) = bad_fraction(window) / error_budget
    error_budget = 1 - objective

burn == 1 means the error budget is being consumed exactly at the rate
that exhausts it over the SLO period; > 1 is over-budget (alert), >> 1 is
an incident. Multi-window (default 60s/5m/30m) is the standard SRE recipe:
the short window catches incidents fast, the long window stops flapping.

Exported as ``dyn_slo_burn_rate{slo,window}`` gauges on the process stage
registry (so whoever runs the monitor — planner, frontend, dyntop —
publishes it over the existing stage-metrics merge path) plus a bounded
**breach log** the planner's signal collector folds into
``PoolSignals.slo_burn`` as scale-up pressure.

Objectives (all optional; unset = not monitored):

- ``DYN_SLO_TTFT_P90``  — seconds; over ``llm_ttft_seconds``
- ``DYN_SLO_ITL_P90``   — seconds; over ``llm_inter_token_seconds``
- ``DYN_SLO_AVAILABILITY`` — good fraction (e.g. ``0.999``); bad events =
  5xx responses in ``dyn_http_requests_total`` (status label >= 500)
- ``DYN_SLO_WINDOWS``   — comma seconds, default ``60,300,1800``

Latency thresholds should sit on a histogram bucket edge (see
``LATENCY_BUCKETS_*`` in ``utils/prometheus.py``); an off-edge threshold
effectively rounds DOWN to the nearest lower edge — the whole bucket
containing it counts as bad. Over-counting bad events by at most one
bucket's width is the conservative direction: the monitor may over-alert
near the boundary, it never sleeps through a breach.
"""

from __future__ import annotations

import collections
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

DEFAULT_WINDOWS = (60.0, 300.0, 1800.0)


@dataclass(frozen=True)
class SloObjective:
    name: str                    # series label, e.g. "ttft_p90"
    objective: float             # target good fraction in (0, 1)
    metric: str                  # metric name in the state dumps
    threshold: Optional[float] = None   # latency bound (histogram SLOs)

    @property
    def error_budget(self) -> float:
        return max(1.0 - self.objective, 1e-9)


def objectives_from_env(env: Optional[Dict[str, str]] = None
                        ) -> List[SloObjective]:
    e = os.environ if env is None else env
    out: List[SloObjective] = []

    def _f(key: str) -> Optional[float]:
        raw = e.get(key)
        if not raw:
            return None
        try:
            return float(raw)
        except ValueError:
            return None

    ttft = _f("DYN_SLO_TTFT_P90")
    if ttft is not None:
        out.append(SloObjective("ttft_p90", 0.90, "llm_ttft_seconds", ttft))
    itl = _f("DYN_SLO_ITL_P90")
    if itl is not None:
        out.append(SloObjective("itl_p90", 0.90,
                                "llm_inter_token_seconds", itl))
    avail = _f("DYN_SLO_AVAILABILITY")
    if avail is not None and 0.0 < avail < 1.0:
        out.append(SloObjective("availability", avail,
                                "dyn_http_requests_total"))
    return out


def windows_from_env(env: Optional[Dict[str, str]] = None
                     ) -> Tuple[float, ...]:
    raw = (os.environ if env is None else env).get("DYN_SLO_WINDOWS")
    if not raw:
        return DEFAULT_WINDOWS
    try:
        ws = tuple(sorted(float(x) for x in raw.split(",") if x.strip()))
        return ws or DEFAULT_WINDOWS
    except ValueError:
        return DEFAULT_WINDOWS


def _hist_totals(states: Iterable[Tuple[str, Dict]], metric: str,
                 threshold: float) -> Tuple[float, float]:
    """(total, bad) cumulative observation counts for a histogram metric
    across every dump/series: bad = observations above ``threshold``
    (counted from the per-bucket counts; the +Inf tail is total - sum)."""
    total = bad = 0.0
    for _component, dump in states:
        st = dump.get(metric)
        if not st or st.get("kind") != "histogram":
            continue
        buckets = list(st.get("buckets") or ())
        for series in st.get("series", {}).values():
            counts = series.get("counts") or []
            n = float(series.get("total", 0))
            total += n
            good = sum(c for b, c in zip(buckets, counts) if b <= threshold)
            bad += max(n - good, 0.0)
    return total, bad


def _availability_totals(states: Iterable[Tuple[str, Dict]], metric: str
                         ) -> Tuple[float, float]:
    """(total, bad) request counts from a status-labelled counter: bad =
    5xx. 4xx are the client's fault and don't burn the server's budget."""
    total = bad = 0.0
    for _component, dump in states:
        st = dump.get(metric)
        if not st or st.get("kind") != "counter":
            continue
        labels = list(st.get("labels") or ())
        try:
            pos = labels.index("status")
        except ValueError:
            continue
        for skey, val in st.get("series", {}).items():
            parts = skey.split("\x1f")
            if len(parts) <= pos:
                continue
            total += val
            try:
                if int(parts[pos]) >= 500:
                    bad += val
            except ValueError:
                pass
    return total, bad


@dataclass
class Breach:
    slo: str
    window: float
    burn: float
    at: float                     # wall-clock (time.time())

    def to_dict(self) -> Dict:
        return {"slo": self.slo, "window": self.window,
                "burn": round(self.burn, 3), "at": self.at}


_STAGE_GAUGE = object()   # default sentinel: export via stage_metrics()


class SloMonitor:
    """Feed :meth:`observe` one round of state dumps per tick; read burn
    rates from :meth:`burn_rates`, :attr:`breaches`, or the exported
    ``dyn_slo_burn_rate`` gauge. Pass ``registry_gauge=None`` to observe
    WITHOUT exporting (dyntop: a viewer must not write gauges a publishing
    process would then ship)."""

    def __init__(self, objectives: Optional[List[SloObjective]] = None,
                 windows: Optional[Tuple[float, ...]] = None,
                 registry_gauge=_STAGE_GAUGE, max_breaches: int = 256):
        self.objectives = (objectives_from_env() if objectives is None
                           else list(objectives))
        self.windows = tuple(windows or windows_from_env())
        if registry_gauge is _STAGE_GAUGE:
            from .prometheus import stage_metrics

            registry_gauge = stage_metrics().slo_burn
        self.gauge = registry_gauge
        # per-slo ring of (monotonic_ts, total, bad) snapshots, kept one
        # longest-window deep
        self._rings: Dict[str, collections.deque] = {
            o.name: collections.deque() for o in self.objectives}
        self.breaches: collections.deque = collections.deque(
            maxlen=max_breaches)
        self._last_burn: Dict[str, Dict[float, float]] = {}
        self._burning: Dict[Tuple[str, float], bool] = {}

    def observe(self, states: List[Tuple[str, Dict]],
                now: Optional[float] = None) -> Dict[str, Dict[float, float]]:
        """Snapshot cumulative counts from ``states`` and recompute burn
        rates for every (slo, window). Returns {slo: {window: burn}}."""
        now = time.monotonic() if now is None else now
        states = list(states)
        out: Dict[str, Dict[float, float]] = {}
        for o in self.objectives:
            if o.threshold is not None:
                total, bad = _hist_totals(states, o.metric, o.threshold)
            else:
                total, bad = _availability_totals(states, o.metric)
            ring = self._rings[o.name]
            ring.append((now, total, bad))
            horizon = now - max(self.windows) - 1.0
            while len(ring) > 2 and ring[1][0] < horizon:
                ring.popleft()
            out[o.name] = {}
            for w in self.windows:
                burn = self._burn(ring, now - w, total, bad, o)
                out[o.name][w] = burn
                if self.gauge is not None:
                    self.gauge.set(o.name, f"{int(w)}s", value=burn)
                if burn > 1.0:
                    self.breaches.append(
                        Breach(o.name, w, burn, time.time()))
                    # incident trigger on the breach EDGE only (sustained
                    # burn keeps appending breaches but must not re-open
                    # beacons every tick). Passive monitors (dyntop,
                    # gauge=None) observe without triggering.
                    if (self.gauge is not None
                            and not self._burning.get((o.name, w))):
                        from ..obs import incidents as _incidents

                        _incidents.trigger(
                            "slo_burn", slo=o.name, window=w,
                            burn=round(burn, 3))
                    self._burning[(o.name, w)] = True
                else:
                    self._burning[(o.name, w)] = False
        self._last_burn = out
        return out

    @staticmethod
    def _burn(ring, cutoff: float, total: float, bad: float,
              o: SloObjective) -> float:
        # baseline: the newest snapshot at or before the window start
        # (counts are cumulative, so deltas are exact regardless of how
        # often observe() ran). Before the window has history, the oldest
        # snapshot stands in — the burn is then over a shorter, honest span
        base_t, base_total, base_bad = ring[0]
        for ts, t_, b_ in ring:
            if ts <= cutoff:
                base_t, base_total, base_bad = ts, t_, b_
            else:
                break
        d_total = total - base_total
        d_bad = bad - base_bad
        if d_total <= 0:
            return 0.0
        return (d_bad / d_total) / o.error_budget

    def burn_rates(self) -> Dict[str, Dict[float, float]]:
        """The most recent :meth:`observe` result."""
        return self._last_burn

    def max_burn(self) -> Dict[str, float]:
        """Per-slo worst burn across windows — the planner's scale-up
        pressure scalar."""
        return {slo: max(per_w.values()) if per_w else 0.0
                for slo, per_w in self._last_burn.items()}

    def recent_breaches(self, limit: int = 50) -> List[Dict]:
        return [b.to_dict() for b in list(self.breaches)[-limit:]]
