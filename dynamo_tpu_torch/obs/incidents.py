"""Coordinated incident bundles over the dynstore keyspace.

Any trigger — a watchdog stall, a circuit-breaker trip, a torn disagg
stream, an SLO burn crossing, ``ctl incident capture`` or SIGUSR2 —
publishes a **capture beacon** under ``incidents/{ns}/beacon/{id}``.
Every process runs an :class:`IncidentManager` watching that prefix;
on a new beacon each one freezes a windowed slice of its flight-recorder
rings (obs/flightrec.py) and writes it under
``incidents/{ns}/bundle/{id}/{proc}`` on a TTL lease. The result is ONE
coordinated bundle per incident: the beacon doubles as the manifest,
per-process ring dumps sit under the bundle prefix, and the trace named
by the trigger is retro-assembled (the local span sink force-exports it,
so the store holds the complete trace even at ``DYN_TRACE_SAMPLE=0.01``).

Triggers raised while a beacon younger than ``DYN_INCIDENT_COOLDOWN``
exists *attach* to that incident instead of opening a new one — a torn
stream and the breaker trip it causes are one incident, not a beacon
storm. Bundles expire with their ``DYN_INCIDENT_TTL`` lease; the ring
slice spans ``DYN_INCIDENT_WINDOW`` seconds before the trigger.

Inspect with ``dynctl incident ls/show/export`` and
``tracectl --bundle <file> --chrome <out>``.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
import uuid
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from ..utils.knobs import env_float
from ..utils.prometheus import stage_metrics
from .flightrec import FlightRecorder, flight_recorder

log = logging.getLogger("dynamo_tpu_torch.obs.incidents")

INCIDENT_PREFIX = "incidents/"


def incident_beacon_key(ns: str, incident_id: str) -> str:
    return f"{INCIDENT_PREFIX}{ns}/beacon/{incident_id}"


def incident_beacon_prefix(ns: str) -> str:
    return f"{INCIDENT_PREFIX}{ns}/beacon/"


def incident_dump_key(ns: str, incident_id: str, proc: str) -> str:
    return f"{INCIDENT_PREFIX}{ns}/bundle/{incident_id}/{proc}"


def incident_dump_prefix(ns: str, incident_id: str) -> str:
    return f"{INCIDENT_PREFIX}{ns}/bundle/{incident_id}/"


async def publish_beacon(store, ns: str, reason: str, *,
                         window_s: float = 30.0,
                         trace_id: Optional[str] = None,
                         by: str = "ctl", ttl: float = 3600.0,
                         detail: Optional[Dict[str, Any]] = None
                         ) -> Dict[str, Any]:
    """Create + publish one capture beacon; returns the beacon record.
    Shared by :meth:`IncidentManager.trigger` and ``ctl incident
    capture`` (which has no rings of its own to dump)."""
    now = time.time()
    iid = f"{int(now)}-{reason}-{uuid.uuid4().hex[:6]}"
    beacon = {"id": iid, "reason": reason, "at": now,
              "window": [now - window_s, now],
              "trace_id": trace_id, "detail": detail or {}, "by": by}
    # unbound: the beacon must outlive the (often short-lived) publisher —
    # ctl exits right after capture, a stalled worker may be about to die
    lease = await store.lease_grant(ttl=ttl, auto_keepalive=False,
                                    bind=False)
    await store.put(incident_beacon_key(ns, iid),
                    json.dumps(beacon).encode(), lease=lease)
    stage_metrics().incidents_captured.inc(reason)
    return beacon


class IncidentManager:
    """Per-process incident coordinator: watches the beacon prefix,
    dumps this process's rings into the bundle, and raises beacons for
    locally observed triggers."""

    def __init__(self, store, namespace: str = "dynamo",
                 component: str = "proc",
                 recorder: Optional[FlightRecorder] = None,
                 span_sink=None, proc_label: Optional[str] = None,
                 ttl: Optional[float] = None,
                 cooldown: Optional[float] = None,
                 window: Optional[float] = None):
        self.store = store
        self.namespace = namespace
        self.component = component
        self.recorder = recorder if recorder is not None \
            else flight_recorder()
        self.span_sink = span_sink
        self.proc_label = proc_label or f"{component}:{os.getpid()}"
        self.ttl = env_float("DYN_INCIDENT_TTL", 3600.0, minimum=10.0) \
            if ttl is None else ttl
        self.cooldown = env_float("DYN_INCIDENT_COOLDOWN", 30.0,
                                  minimum=0.0) \
            if cooldown is None else cooldown
        self.window = env_float("DYN_INCIDENT_WINDOW", 30.0, minimum=1.0) \
            if window is None else window
        #: extra bundle sections: name -> () -> JSON-serializable (sync
        #: or async); e.g. the router's decision-ring slice
        self.sources: Dict[str, Callable[[], Any]] = {}
        self._dumped: deque = deque(maxlen=256)       # incident ids done
        self._recent: deque = deque(maxlen=64)        # (mono, beacon)
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._closed = False
        self._signal_installed = False

    # -- lifecycle ----------------------------------------------------------
    async def start(self, install_signal: bool = False
                    ) -> "IncidentManager":
        self._loop = asyncio.get_running_loop()
        snapshot = await self.store.watch_prefix(
            incident_beacon_prefix(self.namespace), self._on_beacon)
        for key, value in snapshot:
            await self._on_beacon(key, value, False)
        if install_signal:
            try:
                import signal

                self._loop.add_signal_handler(
                    signal.SIGUSR2, self.trigger_nowait, "sigusr2")
                self._signal_installed = True
            except (NotImplementedError, ValueError, OSError, RuntimeError):
                log.debug("SIGUSR2 capture handler unavailable",
                          exc_info=True)
        return self

    async def stop(self) -> None:
        self._closed = True
        if self._signal_installed and self._loop is not None:
            try:
                import signal

                self._loop.remove_signal_handler(signal.SIGUSR2)
            except (NotImplementedError, ValueError, OSError, RuntimeError):
                pass
            self._signal_installed = False

    def add_source(self, name: str, fn: Callable[[], Any]) -> None:
        self.sources[name] = fn

    # -- triggers -----------------------------------------------------------
    def _fresh_beacon(self) -> Optional[Dict[str, Any]]:
        now = time.monotonic()
        for seen_at, beacon in reversed(self._recent):
            if now - seen_at <= self.cooldown:
                return beacon
            break
        return None

    async def trigger(self, reason: str, trace_id: Optional[str] = None,
                      **detail: Any) -> Optional[str]:
        """Open (or attach to) an incident. Returns the incident id, or
        None when the manager is closed."""
        if self._closed:
            return None
        existing = self._fresh_beacon()
        if existing is not None:
            # coordinated, not chatty: a trigger inside the cooldown of
            # a live incident joins it — the attach is visible in the
            # events ring, and the re-dump refreshes our slice
            self.recorder.note("incident.attach", incident=existing["id"],
                               reason=reason, trace_id=trace_id, **detail)
            if trace_id and not existing.get("trace_id"):
                existing["trace_id"] = trace_id
            await self._dump(existing, force=True)
            return existing["id"]
        try:
            beacon = await publish_beacon(
                self.store, self.namespace, reason, window_s=self.window,
                trace_id=trace_id, by=self.proc_label, ttl=self.ttl,
                detail=detail)
        except Exception:
            log.warning("incident beacon publish failed", exc_info=True)
            return None
        self._recent.append((time.monotonic(), beacon))
        await self._dump(beacon, force=True)
        return beacon["id"]

    def trigger_nowait(self, reason: str, trace_id: Optional[str] = None,
                       **detail: Any) -> None:
        """Fire-and-forget trigger from sync code (breaker callbacks,
        signal handlers, the SLO monitor tick)."""
        if self._closed or self._loop is None:
            return
        from ..utils.aiotasks import spawn

        def _go() -> None:
            spawn(self.trigger(reason, trace_id=trace_id, **detail),
                  name=f"incident-{reason}")

        self._loop.call_soon_threadsafe(_go)

    # -- beacon fan-in ------------------------------------------------------
    async def _on_beacon(self, key: str, value: Optional[bytes],
                         deleted: bool) -> None:
        if deleted or self._closed or value is None:
            return
        try:
            beacon = json.loads(value.decode())
        except (ValueError, UnicodeDecodeError):
            log.warning("undecodable incident beacon %s", key)
            return
        self._recent.append((time.monotonic(), beacon))
        if beacon["id"] in self._dumped:
            return
        # dump from a task, NOT the watch callback: the dump itself does
        # store I/O and must not re-enter the client's receive path
        from ..utils.aiotasks import spawn
        spawn(self._dump(beacon), name=f"incident-dump-{beacon['id']}")

    # -- the dump -----------------------------------------------------------
    async def _dump(self, beacon: Dict[str, Any],
                    force: bool = False) -> None:
        iid = beacon["id"]
        try:
            t0 = float(beacon.get("window", [time.time() - self.window])[0])
            snap = self.recorder.snapshot(window=(t0, time.time()),
                                          trace_id=beacon.get("trace_id"))
            rings = snap["rings"]
            touched = any(rings[r]["n"] for r in rings)
            if not (touched or force or beacon.get("by") == self.proc_label):
                return      # nothing of ours in the window: stay out
            snap["incident"] = {k: beacon.get(k) for k in
                                ("id", "reason", "at", "trace_id", "by")}
            if self.sources:
                out: Dict[str, Any] = {}
                for name, fn in self.sources.items():
                    try:
                        val = fn()
                        if asyncio.iscoroutine(val):
                            val = await asyncio.wait_for(val, timeout=2.0)
                        out[name] = val
                    except Exception as e:  # noqa: BLE001 - best-effort
                        out[name] = {"error": f"{type(e).__name__}: {e}"}
                snap["sources"] = out
            tid = beacon.get("trace_id")
            if tid and self.span_sink is not None:
                # retro-assemble: force the whole trace into the store
                # export, sampled-out spans included
                self.span_sink.force_trace(tid)
            # unbound: the black box must survive the crash that made it
            # interesting — a dump vanishing with its process is useless
            lease = await self.store.lease_grant(ttl=self.ttl,
                                                 auto_keepalive=False,
                                                 bind=False)
            await self.store.put(
                incident_dump_key(self.namespace, iid, self.proc_label),
                json.dumps(snap).encode(), lease=lease)
            if iid not in self._dumped:
                self._dumped.append(iid)
            stage_metrics().incident_dumps.inc()
        except Exception:
            log.warning("incident ring dump failed for %s", iid,
                        exc_info=True)


# ---------------------------------------------------------------------------
# process-global manager + the trigger hook other subsystems call
# ---------------------------------------------------------------------------
_manager: Optional[IncidentManager] = None


def install_manager(m: Optional[IncidentManager]) -> None:
    global _manager
    _manager = m


def manager() -> Optional[IncidentManager]:
    return _manager


def trigger(reason: str, trace_id: Optional[str] = None,
            **detail: Any) -> None:
    """Raise an incident from anywhere (breaker trip, torn stream, SLO
    burn, watchdog stall). A no-op in processes without a manager — hook
    sites call unconditionally."""
    m = _manager
    if m is not None:
        m.trigger_nowait(reason, trace_id=trace_id, **detail)


# ---------------------------------------------------------------------------
# bundle read side (ctl incident ls/show/export, tracectl, http_service)
# ---------------------------------------------------------------------------
async def list_incidents(store, ns: str) -> List[Dict[str, Any]]:
    """Live (unexpired) incident beacons, newest first."""
    out: List[Dict[str, Any]] = []
    for _key, value in await store.get_prefix(incident_beacon_prefix(ns)):
        try:
            out.append(json.loads(value.decode()))
        except (ValueError, UnicodeDecodeError):
            continue
    out.sort(key=lambda b: b.get("at", 0.0), reverse=True)
    return out


async def fetch_bundle(store, ns: str, incident_id: str
                       ) -> Optional[Dict[str, Any]]:
    """Assemble one incident bundle: manifest (the beacon) + every
    process's ring dump + the trigger's trace retro-assembled from the
    store export merged with the spans the rings preserved."""
    from ..utils.tracing import Span, fetch_trace_spans, merge_spans

    raw = await store.get(incident_beacon_key(ns, incident_id))
    if raw is None:
        return None
    manifest = json.loads(raw.decode())
    processes: Dict[str, Any] = {}
    for key, value in await store.get_prefix(
            incident_dump_prefix(ns, incident_id)):
        proc = key.rsplit("/", 1)[-1]
        try:
            processes[proc] = json.loads(value.decode())
        except (ValueError, UnicodeDecodeError):
            log.warning("undecodable incident dump %s", key)
    trace: List[Dict[str, Any]] = []
    tid = manifest.get("trace_id")
    if tid:
        groups = [await fetch_trace_spans(store, tid)]
        for snap in processes.values():
            ring = snap.get("rings", {}).get("spans", {}).get("items", [])
            groups.append([Span.from_dict(d) for d in ring
                           if d.get("trace_id") == tid])
        trace = [s.to_dict() for s in merge_spans(*groups)]
    return {"manifest": manifest, "processes": processes, "trace": trace}


def bundle_summary(bundle: Dict[str, Any]) -> List[str]:
    """Human-readable summary lines for ``ctl incident show`` — includes
    per-ring eviction loss so "quiet window" and "ring too small" read
    differently."""
    m = bundle["manifest"]
    lines = [f"incident {m['id']}",
             f"  reason   {m['reason']}  (by {m.get('by', '?')})",
             f"  at       {time.strftime('%Y-%m-%d %H:%M:%S', time.localtime(m['at']))}"
             f"  window {m['window'][1] - m['window'][0]:.0f}s"]
    if m.get("trace_id"):
        lines.append(f"  trace    {m['trace_id']} "
                     f"({len(bundle['trace'])} spans retro-assembled)")
    if m.get("detail"):
        lines.append(f"  detail   {json.dumps(m['detail'], sort_keys=True)}")
    lines.append(f"  processes ({len(bundle['processes'])}):")
    for proc in sorted(bundle["processes"]):
        snap = bundle["processes"][proc]
        rings = snap.get("rings", {})
        cells = []
        for name in ("spans", "events", "logtail"):
            r = rings.get(name, {})
            cell = f"{name} {r.get('n', 0)}"
            if r.get("evicted"):
                cell += f" (LOSS: {r['evicted']} evicted, ring too small?)"
            cells.append(cell)
        lines.append(f"    {proc:32s} {'  '.join(cells)}")
        stalls = [e for e in rings.get("events", {}).get("items", [])
                  if e.get("kind") == "watchdog.stall"]
        for st in stalls:
            lines.append(f"      stall: {st.get('name')} wedged "
                         f"{st.get('waited', 0):.2f}s")
    return lines
