"""Hang watchdog: turns wedged state into never-sampled ``stall:*`` spans.

Polls the flight recorder's heartbeat table every
``DYN_WATCHDOG_INTERVAL`` seconds and fires when work is in flight but
nothing has moved for too long:

- a decode dispatch exceeding ``DYN_WATCHDOG_MULT`` × its EWMA step time
  (with a ``DYN_WATCHDOG_FLOOR`` absolute floor so a noisy EWMA cannot
  produce sub-second false positives);
- a transfer stream with no layer progress inside its explicit budget
  (``DYN_WATCHDOG_TRANSFER`` armed by the KV receiver);
- a drain that outlives its grace budget (armed by the worker shell);
- an event-loop stall: the watchdog's own tick waking more than
  ``DYN_WATCHDOG_LOOP_STALL`` seconds late means something held the loop.

Each detection emits ONE ``stall:<kind>`` span per wedged period
(re-armed the moment the activity moves again) carrying
``force_trace=True`` so head sampling can never drop it, counts
``dyn_watchdog_stalls_total{kind}``, and raises an incident trigger so
every involved process dumps its rings (obs/incidents.py).
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from typing import Any, Dict, List, Optional

from ..utils.knobs import env_float
from ..utils.prometheus import stage_metrics
from .flightrec import FlightRecorder, flight_recorder

log = logging.getLogger("dynamo_tpu_torch.obs.watchdog")


class Watchdog:
    def __init__(self, recorder: Optional[FlightRecorder] = None,
                 tracer=None, interval: Optional[float] = None,
                 mult: Optional[float] = None,
                 floor: Optional[float] = None,
                 loop_stall: Optional[float] = None,
                 enabled: Optional[bool] = None):
        self.recorder = recorder if recorder is not None \
            else flight_recorder()
        self._tracer = tracer
        self.interval = env_float("DYN_WATCHDOG_INTERVAL", 0.25,
                                  minimum=0.01) \
            if interval is None else interval
        self.mult = env_float("DYN_WATCHDOG_MULT", 8.0, minimum=1.0) \
            if mult is None else mult
        self.floor = env_float("DYN_WATCHDOG_FLOOR", 1.0, minimum=0.0) \
            if floor is None else floor
        self.loop_stall = env_float("DYN_WATCHDOG_LOOP_STALL", 1.0,
                                    minimum=0.05) \
            if loop_stall is None else loop_stall
        if enabled is None:
            enabled = os.environ.get("DYN_WATCHDOG", "1") \
                not in ("0", "false")
        self.enabled = enabled
        self.stalls = 0
        self._task: Optional[asyncio.Task] = None

    @property
    def tracer(self):
        if self._tracer is None:
            from ..utils.tracing import get_tracer
            self._tracer = get_tracer()
        return self._tracer

    async def start(self) -> "Watchdog":
        if self.enabled and self._task is None:
            from ..utils.aiotasks import spawn
            self._task = spawn(self._loop(), name="obs-watchdog")
        return self

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    # -- detection (pure against the heartbeat table; unit-testable) --------
    def check(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """One poll over the heartbeat table; returns the stalls fired
        this tick (each wedged period fires once, re-armed on the next
        activity)."""
        if now is None:
            now = time.monotonic()
        fired: List[Dict[str, Any]] = []
        for name, hb in list(self.recorder.heartbeats.items()):
            if hb.depth <= 0 or hb.fired:
                continue
            if hb.budget is not None:
                deadline = hb.budget
            elif hb.ewma > 0.0:
                deadline = max(self.mult * hb.ewma, self.floor)
            else:
                # nothing to judge against yet (first unit may include
                # compilation); the budgetless EWMA path stays silent
                continue
            waited = now - hb.last_activity
            if waited <= deadline:
                continue
            hb.fired = True
            fired.append({"kind": hb.stall, "name": name,
                          "waited": waited, "deadline": deadline,
                          "ewma": hb.ewma, "depth": hb.depth,
                          "progress": hb.progress,
                          "trace_id": hb.trace_id})
        return fired

    def _emit(self, st: Dict[str, Any]) -> None:
        self.stalls += 1
        end = time.time()
        kind = st["kind"]
        # "name" would collide with record()'s span-name parameter: the
        # wedged heartbeat rides as the ``hb`` attribute instead
        attrs = {k: v for k, v in st.items()
                 if k not in ("kind", "trace_id", "name") and v is not None}
        self.tracer.record(f"stall:{kind}", start=end - st["waited"],
                           end=end, trace_id=st.get("trace_id"),
                           status="error", force_trace=True,
                           hb=st["name"], **attrs)
        stage_metrics().watchdog_stalls.inc(kind)
        # the event's own ``kind`` is "watchdog.stall"; the stall kind
        # rides as ``stall_kind``
        self.recorder.note("watchdog.stall", stall_kind=kind,
                           **{k: v for k, v in st.items() if k != "kind"})
        log.warning("watchdog: %s wedged for %.2fs (deadline %.2fs, "
                    "ewma %.3fs, depth %d)", st["name"], st["waited"],
                    st["deadline"], st["ewma"], st["depth"])
        from . import incidents
        incidents.trigger(f"stall_{kind}", trace_id=st.get("trace_id"),
                          name=st["name"], waited=round(st["waited"], 3))

    async def _loop(self) -> None:
        last = time.monotonic()
        while True:
            await asyncio.sleep(self.interval)
            now = time.monotonic()
            lag = now - last - self.interval
            last = now
            if lag > self.loop_stall:
                # the watchdog itself woke late: something held the
                # event loop for the whole lag — report it retroactively
                self._emit({"kind": "event_loop", "name": "event_loop",
                            "waited": lag, "deadline": self.loop_stall,
                            "ewma": 0.0, "depth": 1, "progress": 0,
                            "trace_id": None})
            for st in self.check(now):
                self._emit(st)
