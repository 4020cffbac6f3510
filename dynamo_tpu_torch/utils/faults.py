"""Fault injection for chaos testing the serving plane.

Named fault *points* are compiled into the runtime's network paths (store
connect, store calls, data-plane connect, KV push parts, prefill compute).
Each point is a no-op until armed, so production cost is one dict lookup.

Arming, two ways:

- **Environment** — ``DYN_FAULTS`` at process start, comma-separated:

      DYN_FAULTS="store.connect:refuse,kv.push.part:drop:0.5"

  Entry grammar: ``point:action[:num[:rate]]``. Actions:

  - ``refuse``       raise ``ConnectionRefusedError`` (num = rate)
  - ``drop``         raise ``ConnectionResetError``   (num = rate)
  - ``error``        raise ``RuntimeError``           (num = rate)
  - ``delay``        sleep ``num`` seconds (default 1.0), then proceed
                     (4th field = rate)
  - ``stall``        sleep ``num`` seconds (default 3600) — an effective
                     hang, for exercising deadline enforcement

  ``rate`` in [0,1] fires the fault probabilistically (default 1 = always).

- **Store** — :func:`watch_store_faults` watches the ``faults/`` prefix;
  key ``faults/<point>`` holds the ``action[:num[:rate]]`` tail. Put/delete
  arms/disarms live across the whole cluster — the chaos harness's lever.

Every firing emits a ``fault:<point>`` span (visible in ``/v1/traces``) and
counts ``dyn_faults_injected_total{point,action}``.
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import time
from dataclasses import dataclass
from typing import Dict, Optional

log = logging.getLogger("dynamo_tpu_torch.faults")

FAULTS_PREFIX = "faults/"

_ACTIONS = ("refuse", "drop", "error", "delay", "stall")


@dataclass
class Fault:
    action: str
    num: float          # seconds for delay/stall; unused otherwise
    rate: float = 1.0


# process-global armed table: point -> Fault
_active: Dict[str, Fault] = {}
_env_loaded = False


def _parse_tail(point: str, tail: str) -> Optional[Fault]:
    """``action[:num[:rate]]`` -> Fault (None + log on malformed input)."""
    parts = tail.split(":")
    action = parts[0].strip()
    if action not in _ACTIONS:
        log.warning("ignoring fault %s: unknown action %r", point, action)
        return None
    default_num = 1.0 if action == "delay" else 3600.0
    try:
        if action in ("delay", "stall"):
            num = float(parts[1]) if len(parts) > 1 and parts[1] else \
                default_num
            rate = float(parts[2]) if len(parts) > 2 else 1.0
        else:
            num = 0.0
            rate = float(parts[1]) if len(parts) > 1 and parts[1] else 1.0
    except ValueError:
        log.warning("ignoring fault %s: malformed spec %r", point, tail)
        return None
    return Fault(action, num, min(max(rate, 0.0), 1.0))


def configure(spec: Optional[str] = None) -> Dict[str, Fault]:
    """Parse a ``DYN_FAULTS``-style spec, REPLACING the whole active table
    (``configure("")`` disarms everything, including store-driven entries).
    Called lazily with the env spec on first :func:`fire`."""
    global _env_loaded
    _env_loaded = True
    if spec is None:
        spec = os.environ.get("DYN_FAULTS", "")
    _active.clear()
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        point, _, tail = entry.partition(":")
        f = _parse_tail(point, tail)
        if f is not None:
            _active[point] = f
            log.warning("fault armed: %s -> %s", point, f)
    return _active


def _ensure_loaded() -> None:
    # the env spec loads lazily; it must load BEFORE any programmatic
    # arm/watch so the replace-semantics of configure() can't wipe them
    if not _env_loaded:
        configure()


def arm(point: str, action: str, num: float = 0.0, rate: float = 1.0) -> None:
    _ensure_loaded()
    _active[point] = Fault(action, num, rate)


def disarm(point: Optional[str] = None) -> None:
    if point is None:
        _active.clear()
    else:
        _active.pop(point, None)


def is_active(point: str) -> Optional[Fault]:
    _ensure_loaded()
    return _active.get(point)


async def fire(point: str) -> None:
    """Execute the armed fault at ``point`` (no-op when unarmed). Raises the
    configured connection error, or sleeps for delay/stall."""
    f = is_active(point)
    if f is None:
        return
    if f.rate < 1.0 and random.random() >= f.rate:
        return
    from .prometheus import stage_metrics
    from .tracing import get_tracer

    stage_metrics().faults_injected.inc(point, f.action)
    t0 = time.time()
    log.warning("fault fired: %s -> %s", point, f)
    if f.action in ("delay", "stall"):
        await asyncio.sleep(f.num)
        get_tracer().record(f"fault:{point}", start=t0, end=time.time(),
                            action=f.action, seconds=f.num)
        return
    get_tracer().record(f"fault:{point}", start=t0, end=time.time(),
                        action=f.action)
    if f.action == "refuse":
        raise ConnectionRefusedError(f"fault injection: {point}")
    if f.action == "drop":
        raise ConnectionResetError(f"fault injection: {point}")
    raise RuntimeError(f"fault injection: {point}")


async def watch_store_faults(store) -> None:
    """Arm/disarm faults live from the store's ``faults/`` prefix (value =
    ``action[:num[:rate]]``). The cluster-wide chaos lever: every process
    that calls this follows the same table."""
    _ensure_loaded()

    async def on_change(key: str, value: Optional[bytes], deleted: bool):
        point = key[len(FAULTS_PREFIX):]
        if deleted:
            disarm(point)
            log.warning("fault disarmed (store): %s", point)
            return
        f = _parse_tail(point, value.decode())
        if f is not None:
            _active[point] = f
            log.warning("fault armed (store): %s -> %s", point, f)

    snapshot = await store.watch_prefix(FAULTS_PREFIX, on_change)
    for key, value in snapshot:
        await on_change(key, value, False)
