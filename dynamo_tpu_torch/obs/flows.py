"""Cluster byte-flow ledger: the one per-process accounting chokepoint
for every byte the cluster moves.

Every byte-moving site — disagg KV push/receive, cluster ``kv_fetch``
donor/receiver, paged-lane page-in/page-out, admission h2d prefetch,
write-through d2h spill, mobility weight prefetch and hot-swap slab
uploads — records ``(src, dst, kind, bytes, seconds)`` through
:func:`record_flow`. Link identity is unified across the two transport
families the fleet actually has:

- **network pairs**: worker endpoints, hex worker ids (the anonymous
  prefill pool is ``"q"``, matching ``kv_transfer.ANON_SRC``);
- **host↔device / disk edges**: ``host:<id>`` / ``dev:<id>`` /
  ``disk`` per process, where ``<id>`` is the worker hex id when known,
  else the pid — so a worker's PCIe/DMA lanes are links with the same
  telemetry shape as its NICs.

Per link the ledger keeps lifetime byte totals per kind
(``dyn_link_bytes_total{src,dst,kind}``), a windowed transfer rate over
the trailing ``DYN_LINK_WINDOW`` seconds (``dyn_link_bw_bytes_per_s``)
and a utilization estimate against calibrated capacity
(``dyn_link_saturation{link}``): capacity comes from the per-class
``DYN_LINK_CAPACITY_{NET,H2D,D2H,DISK}`` overrides when set, else from
the link's own measured peak instantaneous rate — under that fallback a
throttled pair that stays busy all window saturates toward 1.0 while a
fast bursty pair idles near 0. A rising edge through
``DYN_LINK_SAT_THRESHOLD`` emits a flight-recorder ``link.congested``
event, bumps ``dyn_link_congested_total{link}`` and (when an incident
manager is installed) triggers a ``link_congested`` incident capture.

All series ride the normal :class:`StageMetrics` registry, so they
publish through the existing StagePublisher path and merge cluster-wide
via ``fetch_stage_states`` — :func:`flows_from_states` folds that merged
view back into one link table (the shared backend of ``dyntop links:``,
``GET /v1/flows`` and ``ctl flows``).

Every flow with measured seconds also feeds the per-(src,dst) bandwidth
EWMA behind the router's transfer-cost model
(``llm/kv_transfer.observe_pair_bw``), as in the JAX package; the ledger,
its gauges and its views are the JAX module's.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from ..utils.knobs import env_float
from ..utils.prometheus import stage_metrics
from . import flightrec as _flightrec
from . import incidents as _incidents

#: every flow kind the ledger accepts, mapped to its link class — the
#: class picks which ``DYN_LINK_CAPACITY_*`` override calibrates it
KIND_CLASS: Dict[str, str] = {
    "disagg_push": "net",
    "disagg_stream_rx": "net",
    "kv_fetch_tx": "net",
    "kv_fetch_rx": "net",
    "kvpage_pagein": "h2d",
    "h2d_prefetch": "h2d",
    "swap_slab": "h2d",
    "kvpage_pageout": "d2h",
    "d2h_writethrough": "d2h",
    "weight_prefetch": "disk",
}

#: label-key separator in metric state dumps (StageMetrics convention)
_SEP = "\x1f"


def _class_capacity(klass: str) -> float:
    """Calibrated capacity override for a link class, bytes/s; 0 = unset
    (fall back to the link's measured peak)."""
    if klass == "net":
        return env_float("DYN_LINK_CAPACITY_NET", 0.0, minimum=0.0)
    if klass == "h2d":
        return env_float("DYN_LINK_CAPACITY_H2D", 0.0, minimum=0.0)
    if klass == "d2h":
        return env_float("DYN_LINK_CAPACITY_D2H", 0.0, minimum=0.0)
    if klass == "disk":
        return env_float("DYN_LINK_CAPACITY_DISK", 0.0, minimum=0.0)
    return 0.0


def link_name(src: str, dst: str) -> str:
    """The single-label link identity (`dyn_link_saturation{link}`)."""
    return f"{src}>{dst}"


def split_link(link: str) -> Tuple[str, str]:
    src, _, dst = link.partition(">")
    return src, dst


class _LinkState:
    """Per-(src,dst) accounting: lifetime bytes by kind, a bounded
    trailing window of (end_time, bytes, seconds) samples, the measured
    peak instantaneous rate, and the last published saturation (for
    rising-edge congestion detection)."""

    __slots__ = ("bytes_by_kind", "window", "peak_bw", "last_sat",
                 "congested")

    def __init__(self) -> None:
        self.bytes_by_kind: Dict[str, int] = {}
        self.window: Deque[Tuple[float, int, float]] = deque(maxlen=512)
        self.peak_bw = 0.0
        self.last_sat = 0.0
        self.congested = 0


class FlowLedger:
    """Process-local byte-flow accounting. One instance per process
    (module singleton via :func:`flow_ledger`); ``enabled`` is the
    overhead A/B switch (``DYN_FLOWS``, default on)."""

    def __init__(self, local: Optional[str] = None,
                 now: Optional[Any] = None) -> None:
        self.enabled = os.environ.get("DYN_FLOWS", "1").lower() in (
            "1", "true", "yes", "on")
        #: endpoint id for this process's host/device edges: worker hex
        #: id once known (see :meth:`set_local`), else the pid
        self.local = local or str(os.getpid())
        self._now = now or time.monotonic
        self._lock = threading.Lock()
        self._links: Dict[Tuple[str, str], _LinkState] = {}

    # -- identity -----------------------------------------------------------
    def set_local(self, worker_id: Optional[int]) -> None:
        """Adopt the worker's hex id for host/device link endpoints, the
        same convention the network pairs use — called when the worker
        learns its lease id."""
        if worker_id:
            self.local = f"{worker_id:x}"

    def _default_link(self, kind: str) -> Tuple[str, str]:
        klass = KIND_CLASS.get(kind)
        host, dev = f"host:{self.local}", f"dev:{self.local}"
        if klass == "h2d":
            return host, dev
        if klass == "d2h":
            return dev, host
        if klass == "disk":
            return "disk", host
        # network kinds have no meaningful default; the anonymous pool
        # id keeps an unlabelled site visible rather than dropped
        return "q", self.local

    # -- recording ----------------------------------------------------------
    def record(self, kind: str, nbytes: int, seconds: float = 0.0,
               src: Optional[str] = None, dst: Optional[str] = None,
               trace_id: Optional[str] = None) -> None:
        """Account one movement of ``nbytes`` over the (src,dst) link.

        ``seconds`` is the measured wall time of the movement (0 =
        unknown: bytes still count, rates/EWMA skip the sample). ``src``
        / ``dst`` default from the kind's link class for host↔device and
        disk edges; network kinds should always pass worker endpoints.
        ``trace_id`` additionally drops a ``flow.<kind>`` span into the
        trace so waterfalls show the bytes each stage moved.
        """
        if not self.enabled or nbytes <= 0:
            return
        d_src, d_dst = self._default_link(kind)
        src = src or d_src
        dst = dst or d_dst
        now = self._now()
        window = env_float("DYN_LINK_WINDOW", 10.0, minimum=0.1)
        with self._lock:
            st = self._links.setdefault((src, dst), _LinkState())
            st.bytes_by_kind[kind] = st.bytes_by_kind.get(kind, 0) \
                + int(nbytes)
            st.window.append((now, int(nbytes), float(seconds)))
            if seconds > 0:
                st.peak_bw = max(st.peak_bw, nbytes / seconds)
            cutoff = now - window
            while st.window and st.window[0][0] < cutoff:
                st.window.popleft()
            win_bytes = sum(n for _, n, _ in st.window)
            bw = win_bytes / window
            cap = _class_capacity(KIND_CLASS.get(kind, "net")) \
                or st.peak_bw
            sat = min(bw / cap, 1.0) if cap > 0 else 0.0
            prev_sat = st.last_sat
            st.last_sat = sat
            edge = False
            thr = env_float("DYN_LINK_SAT_THRESHOLD", 0.9, minimum=0.0)
            if sat >= thr > prev_sat:
                st.congested += 1
                edge = True
        stage = stage_metrics()
        stage.link_bytes.inc(src, dst, kind, amount=int(nbytes))
        stage.link_bw.set(src, dst, value=bw)
        link = link_name(src, dst)
        stage.link_saturation.set(link, value=sat)
        if edge:
            stage.link_congested.inc(link)
            _flightrec.note_event("link.congested", link=link,
                                  sat=round(sat, 3), bw=round(bw),
                                  cap=round(cap))
            _incidents.trigger("link_congested", link=link,
                               sat=round(sat, 3), kind=kind)
        if seconds > 0:
            # ALL kinds feed the router's per-pair bandwidth EWMA — the
            # TransferCostModel prices total observed traffic, not just
            # disagg receives (lazy import: kv_transfer imports obs)
            from ..llm.kv_transfer import observe_pair_bw

            observe_pair_bw(src, dst, int(nbytes), float(seconds))
        if trace_id is not None and seconds > 0:
            from ..utils.tracing import get_tracer

            get_tracer().record(f"flow.{kind}", now - seconds, now,
                                trace_id=trace_id, bytes=int(nbytes),
                                src=src, dst=dst)

    # -- views --------------------------------------------------------------
    def snapshot(self) -> List[Dict[str, Any]]:
        """Per-link view of this process's ledger, hottest first."""
        out: List[Dict[str, Any]] = []
        with self._lock:
            for (src, dst), st in self._links.items():
                out.append({
                    "src": src, "dst": dst,
                    "bytes": sum(st.bytes_by_kind.values()),
                    "kinds": dict(st.bytes_by_kind),
                    "peak_bw": st.peak_bw,
                    "saturation": st.last_sat,
                    "congested": st.congested,
                })
        out.sort(key=lambda e: -e["bytes"])
        return out

    def total_bytes(self, kind: Optional[str] = None) -> int:
        with self._lock:
            return sum(n for st in self._links.values()
                       for k, n in st.bytes_by_kind.items()
                       if kind is None or k == kind)

    def reset(self) -> None:
        with self._lock:
            self._links.clear()


# ---------------------------------------------------------------------------
# process singleton + convenience chokepoint
# ---------------------------------------------------------------------------

_ledger: Optional[FlowLedger] = None
_ledger_lock = threading.Lock()


def flow_ledger() -> FlowLedger:
    global _ledger
    if _ledger is None:
        with _ledger_lock:
            if _ledger is None:
                _ledger = FlowLedger()
    return _ledger


def record_flow(kind: str, nbytes: int, seconds: float = 0.0,
                src: Optional[str] = None, dst: Optional[str] = None,
                trace_id: Optional[str] = None) -> None:
    """Module-level chokepoint every byte-moving site calls — the
    dynalint ``flow-accounting`` rule inventories exactly this."""
    flow_ledger().record(kind, nbytes, seconds, src=src, dst=dst,
                         trace_id=trace_id)


def set_local_worker(worker_id: Optional[int]) -> None:
    flow_ledger().set_local(worker_id)


# ---------------------------------------------------------------------------
# cluster-wide fold (pure: dyntop / HTTP / CLI share it)
# ---------------------------------------------------------------------------

def flows_from_states(states) -> List[Dict[str, Any]]:
    """Fold a ``fetch_stage_states`` result into one per-link table,
    hottest link first. Tolerates absent series (a fleet that never
    moved a byte returns ``[]`` — surfaces degrade by omission, never
    crash). Both ends of a network transfer may publish the same pair
    (``disagg_push`` at the sender, ``disagg_stream_rx`` at the
    receiver): bytes accumulate per kind so each view stays intact,
    while rate/saturation take the max across publishers (same wire)."""
    links: Dict[Tuple[str, str], Dict[str, Any]] = {}

    def entry(src: str, dst: str) -> Dict[str, Any]:
        return links.setdefault((src, dst), {
            "src": src, "dst": dst, "bytes": 0, "kinds": {},
            "bw": 0.0, "saturation": 0.0, "congested": 0})

    for _component, dump in states or []:
        series = (dump.get("dyn_link_bytes_total") or {}).get(
            "series") or {}
        for skey, val in series.items():
            parts = skey.split(_SEP)
            if len(parts) != 3:
                continue
            e = entry(parts[0], parts[1])
            e["bytes"] += int(val)
            e["kinds"][parts[2]] = e["kinds"].get(parts[2], 0) + int(val)
        series = (dump.get("dyn_link_bw_bytes_per_s") or {}).get(
            "series") or {}
        for skey, val in series.items():
            parts = skey.split(_SEP)
            if len(parts) != 2:
                continue
            e = entry(parts[0], parts[1])
            e["bw"] = max(e["bw"], float(val))
        series = (dump.get("dyn_link_saturation") or {}).get(
            "series") or {}
        for skey, val in series.items():
            src, dst = split_link(skey)
            e = entry(src, dst)
            e["saturation"] = max(e["saturation"], float(val))
        series = (dump.get("dyn_link_congested_total") or {}).get(
            "series") or {}
        for skey, val in series.items():
            src, dst = split_link(skey)
            e = entry(src, dst)
            e["congested"] += int(val)
    out = list(links.values())
    out.sort(key=lambda e: -e["bytes"])
    return out


def fmt_bytes(n: float) -> str:
    """Human-scale byte count for the CLI surfaces (dyntop / ctl)."""
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024.0 or unit == "TB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024.0
    return f"{n:.1f}TB"  # pragma: no cover - loop always returns
