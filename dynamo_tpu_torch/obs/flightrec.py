"""Always-on flight recorder: per-process black-box rings.

Every process keeps bounded, high-resolution rings of what it saw over
the last seconds: every finished span (including ones head sampling
dropped from the store export), engine dispatch/step timings, queue
depths and slot-gate waits, transfer-bandwidth EWMA snapshots,
store-client health transitions, and a tail of recent log records.
Recording is a deque append — cheap enough to leave on in production.
The rings exist so a watchdog stall, a torn stream, or a breaker trip
can dump exactly what this process saw around the event into a
coordinated incident bundle (obs/incidents.py) instead of hoping the
interesting trace survived head sampling.

The recorder also keeps **heartbeats**: named liveness records the hang
watchdog (obs/watchdog.py) polls. A heartbeat tracks in-flight depth,
last-activity time, and an EWMA of completed-unit durations, so "a
decode dispatch exceeding N× its EWMA step time" and "a transfer stream
with no layer progress" are one uniform check.

``DYN_FLIGHTREC=0`` disables recording (the API stays a cheap no-op).
Ring capacities: ``DYN_FLIGHTREC_SPANS`` / ``DYN_FLIGHTREC_EVENTS`` /
``DYN_FLIGHTREC_LOGTAIL``. Evictions are counted per ring
(``dyn_flightrec_evicted_total{ring}``) so a bundle consumer can tell a
quiet window from a ring too small to cover it.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ..utils.prometheus import stage_metrics

log = logging.getLogger("dynamo_tpu_torch.obs.flightrec")

#: heartbeat table bound — transient heartbeats (per-stream) whose owner
#: forgot ``hb_end`` must not grow the table forever
MAX_HEARTBEATS = 256

#: EWMA weight of a new completed-unit duration observation
EWMA_ALPHA = 0.2


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        log.warning("ignoring malformed %s=%r", name, raw)
        return default


class Ring:
    """Bounded drop-oldest ring with eviction accounting. Appends may
    come from the engine thread: ``deque.append`` is atomic and the
    eviction counter tolerates a rare racy undercount."""

    __slots__ = ("name", "capacity", "_items", "evicted")

    def __init__(self, name: str, capacity: int):
        self.name = name
        self.capacity = max(1, capacity)
        self._items: deque = deque(maxlen=self.capacity)
        self.evicted = 0

    def append(self, item: Any) -> None:
        if len(self._items) >= self.capacity:
            self.evicted += 1
            stage_metrics().flightrec_evicted.inc(self.name)
        self._items.append(item)

    def snapshot(self) -> List[Any]:
        return list(self._items)

    def __len__(self) -> int:
        return len(self._items)


class Heartbeat:
    """Liveness record for one wedgeable activity. ``depth`` counts
    in-flight units (overlapping decode dispatches pipeline); any unit
    completing or progressing resets ``last_activity`` — a stall is
    "work in flight, nothing moved for too long", judged against an
    explicit ``budget`` (drain grace, transfer no-progress bound) or
    the watchdog's multiple of the completed-unit EWMA."""

    __slots__ = ("name", "stall", "budget", "trace_id", "depth", "ewma",
                 "progress", "fired", "last_activity", "last_wall")

    def __init__(self, name: str, stall: Optional[str] = None,
                 budget: Optional[float] = None,
                 trace_id: Optional[str] = None):
        self.name = name
        self.stall = stall or name
        self.budget = budget
        self.trace_id = trace_id
        self.depth = 0
        self.ewma = 0.0
        self.progress = 0
        self.fired = False
        self.last_activity = time.monotonic()
        self.last_wall = time.time()

    def _touch(self) -> None:
        self.last_activity = time.monotonic()
        self.last_wall = time.time()
        self.fired = False

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "stall": self.stall,
                "depth": self.depth, "ewma": self.ewma,
                "progress": self.progress, "budget": self.budget,
                "fired": self.fired,
                "idle_s": time.monotonic() - self.last_activity}


class FlightRecorder:
    """The per-process black box: three rings + the heartbeat table."""

    def __init__(self, component: str = "proc",
                 enabled: Optional[bool] = None):
        if enabled is None:
            enabled = os.environ.get("DYN_FLIGHTREC", "1") \
                not in ("0", "false")
        self.component = component
        self.enabled = enabled
        self.spans = Ring("spans", _env_int("DYN_FLIGHTREC_SPANS", 2048))
        self.events = Ring("events", _env_int("DYN_FLIGHTREC_EVENTS", 4096))
        self.logtail = Ring("logtail",
                            _env_int("DYN_FLIGHTREC_LOGTAIL", 256))
        self.heartbeats: Dict[str, Heartbeat] = {}
        self._hb_lock = threading.Lock()
        self._log_handler: Optional[logging.Handler] = None
        self._attached_tracers: List[Any] = []

    # -- rings --------------------------------------------------------------
    def on_span(self, span) -> None:
        """Tracer sink: EVERY finished span lands here, including the
        ones trace-id head sampling keeps out of the store export."""
        if self.enabled:
            self.spans.append(span)

    def note(self, kind: str, **fields: Any) -> None:
        """Append one structured event (engine step, gate wait, transfer
        EWMA snapshot, store health transition, ...)."""
        if self.enabled:
            fields["t"] = time.time()
            fields["kind"] = kind
            self.events.append(fields)

    def attach(self, tracer) -> None:
        """Mirror a tracer's finished spans into the span ring."""
        if tracer in self._attached_tracers:
            return
        tracer.add_sink(self.on_span)
        self._attached_tracers.append(tracer)

    def attach_logging(self, level: int = logging.INFO) -> None:
        if self._log_handler is not None:
            return
        self._log_handler = _LogTailHandler(self.logtail)
        self._log_handler.setLevel(level)
        logging.getLogger().addHandler(self._log_handler)

    def detach(self) -> None:
        for tracer in self._attached_tracers:
            tracer.remove_sink(self.on_span)
        self._attached_tracers.clear()
        if self._log_handler is not None:
            logging.getLogger().removeHandler(self._log_handler)
            self._log_handler = None

    # -- heartbeats ---------------------------------------------------------
    def hb(self, name: str, stall: Optional[str] = None,
           budget: Optional[float] = None,
           trace_id: Optional[str] = None) -> Heartbeat:
        with self._hb_lock:
            h = self.heartbeats.get(name)
            if h is None:
                if len(self.heartbeats) >= MAX_HEARTBEATS:
                    # shed an idle transient first; a busy one only if
                    # the table is saturated with busy entries
                    for key, old in self.heartbeats.items():
                        if old.depth <= 0:
                            del self.heartbeats[key]
                            break
                    else:
                        self.heartbeats.pop(next(iter(self.heartbeats)))
                h = Heartbeat(name, stall=stall, budget=budget,
                              trace_id=trace_id)
                self.heartbeats[name] = h
            return h

    def hb_begin(self, name: str, stall: Optional[str] = None,
                 budget: Optional[float] = None,
                 trace_id: Optional[str] = None) -> None:
        if not self.enabled:
            return
        h = self.hb(name, stall=stall, budget=budget, trace_id=trace_id)
        h.depth += 1
        if budget is not None:
            h.budget = budget
        h._touch()

    def hb_done(self, name: str, elapsed: Optional[float] = None) -> None:
        if not self.enabled:
            return
        h = self.heartbeats.get(name)
        if h is None:
            return
        h.depth = max(0, h.depth - 1)
        if elapsed is not None and elapsed >= 0:
            h.ewma = elapsed if h.ewma == 0.0 else \
                (1 - EWMA_ALPHA) * h.ewma + EWMA_ALPHA * elapsed
        h._touch()

    def hb_progress(self, name: str, n: int = 1) -> None:
        if not self.enabled:
            return
        h = self.heartbeats.get(name)
        if h is None:
            return
        h.progress += n
        h._touch()

    def hb_end(self, name: str) -> None:
        with self._hb_lock:
            self.heartbeats.pop(name, None)

    # -- snapshots ----------------------------------------------------------
    def snapshot(self, window: Optional[Tuple[float, float]] = None,
                 trace_id: Optional[str] = None) -> Dict[str, Any]:
        """Serializable dump of the rings, optionally sliced to a
        ``(t0, t1)`` epoch window. Spans of ``trace_id`` are always
        included, window or not — the incident's trace is the point."""
        t0, t1 = window if window is not None else (None, None)

        def in_window(t: float) -> bool:
            return t0 is None or (t0 <= t <= t1)

        spans = [s for s in self.spans.snapshot()
                 if (trace_id is not None and s.trace_id == trace_id)
                 or in_window(s.end or s.start)]
        events = [e for e in self.events.snapshot() if in_window(e["t"])]
        logs = [r for r in self.logtail.snapshot() if in_window(r["t"])]
        with self._hb_lock:
            beats = {n: h.to_dict() for n, h in self.heartbeats.items()}
        return {
            "component": self.component,
            "pid": os.getpid(),
            "captured_at": time.time(),
            "window": [t0, t1],
            "rings": {
                "spans": {"n": len(spans), "capacity": self.spans.capacity,
                          "evicted": self.spans.evicted,
                          "items": [s.to_dict() for s in spans]},
                "events": {"n": len(events),
                           "capacity": self.events.capacity,
                           "evicted": self.events.evicted,
                           "items": events},
                "logtail": {"n": len(logs),
                            "capacity": self.logtail.capacity,
                            "evicted": self.logtail.evicted,
                            "items": logs},
            },
            "heartbeats": beats,
        }


class _LogTailHandler(logging.Handler):
    """Root-logger handler feeding the structured-log tail ring."""

    def __init__(self, ring: Ring):
        super().__init__()
        self.ring = ring

    def emit(self, record: logging.LogRecord) -> None:
        try:
            self.ring.append({"t": record.created,
                              "level": record.levelname,
                              "logger": record.name,
                              "msg": record.getMessage()})
        # dynalint: ok(swallowed-exception) a log-formatting error inside
        # the black box must never recurse into logging or break callers
        except Exception:
            pass


# ---------------------------------------------------------------------------
# process-global recorder + module-level conveniences for hook sites
# ---------------------------------------------------------------------------
_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def flight_recorder() -> FlightRecorder:
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = FlightRecorder()
    return _recorder


def install(component: Optional[str] = None, tracer=None) -> FlightRecorder:
    """Arm the process-global recorder: name it, mirror the (process)
    tracer's spans into the span ring, start the log tail. Idempotent —
    hook sites call the module-level note/hb functions regardless."""
    rec = flight_recorder()
    if component is not None:
        rec.component = component
    if rec.enabled:
        if tracer is None:
            from ..utils.tracing import get_tracer
            tracer = get_tracer()
        rec.attach(tracer)
        rec.attach_logging()
    return rec


def note_event(kind: str, **fields: Any) -> None:
    flight_recorder().note(kind, **fields)


def hb_begin(name: str, stall: Optional[str] = None,
             budget: Optional[float] = None,
             trace_id: Optional[str] = None) -> None:
    flight_recorder().hb_begin(name, stall=stall, budget=budget,
                               trace_id=trace_id)


def hb_done(name: str, elapsed: Optional[float] = None) -> None:
    flight_recorder().hb_done(name, elapsed=elapsed)


def hb_progress(name: str, n: int = 1) -> None:
    flight_recorder().hb_progress(name, n=n)


def hb_end(name: str) -> None:
    flight_recorder().hb_end(name)
