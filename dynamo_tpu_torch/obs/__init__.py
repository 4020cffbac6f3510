"""Flight-recorder observability plane: black-box rings, hang watchdog,
coordinated incident bundles.

One call wires a process in::

    handle = await obs.start_process("decode_worker", store=drt.store,
                                     namespace=ns, span_sink=span_sink)
    ...
    await handle.stop()

which arms the always-on flight recorder (obs/flightrec.py), starts the
hang watchdog (obs/watchdog.py), and — when a store is given — joins the
cluster's incident coordination (obs/incidents.py): the process dumps
its rings whenever any process publishes a capture beacon, and local
triggers (breaker trips, torn streams, watchdog stalls, SLO burn,
SIGUSR2) raise beacons of their own.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from . import incidents
from .flightrec import (FlightRecorder, flight_recorder, hb_begin, hb_done,
                        hb_end, hb_progress, install, note_event)
from .incidents import IncidentManager
from .watchdog import Watchdog

__all__ = ["FlightRecorder", "IncidentManager", "ObsHandle", "Watchdog",
           "flight_recorder", "hb_begin", "hb_done", "hb_end",
           "hb_progress", "incidents", "install", "note_event",
           "start_process"]


@dataclass
class ObsHandle:
    recorder: FlightRecorder
    watchdog: Watchdog
    manager: Optional[IncidentManager]

    async def stop(self) -> None:
        await self.watchdog.stop()
        if self.manager is not None:
            await self.manager.stop()
            if incidents.manager() is self.manager:
                incidents.install_manager(None)


async def start_process(component: str, *, store=None,
                        namespace: str = "dynamo",
                        proc_label: Optional[str] = None,
                        span_sink=None, tracer=None,
                        install_signal: bool = False) -> ObsHandle:
    """Arm the whole plane for this process. ``proc_label`` names this
    process's dump inside incident bundles (default ``component:pid``);
    pass the worker id when several components share a pid (tests)."""
    rec = install(component=component, tracer=tracer)
    wd = await Watchdog(recorder=rec, tracer=tracer,
                        stack_dump=install_signal).start()
    mgr = None
    if store is not None:
        mgr = IncidentManager(store, namespace, component, recorder=rec,
                              span_sink=span_sink, proc_label=proc_label)
        await mgr.start(install_signal=install_signal)
        incidents.install_manager(mgr)
    return ObsHandle(rec, wd, mgr)
