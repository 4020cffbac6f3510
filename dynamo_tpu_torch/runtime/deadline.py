"""End-to-end request deadlines.

A deadline is an absolute wall-clock instant (``time.time()`` seconds) that
rides the wire envelope next to ``context_id`` and the trace context, so
every hop of a request — HTTP ingress, the client RPC read loop, the prefill
queue, the decode-side KV wait — can answer "is this request still worth
working on?" without coordination. Wall clock (not monotonic) because the
value crosses process and host boundaries; NTP-grade skew is absorbed by the
second-scale timeouts this is meant for.

Every enforcement point raises :class:`DeadlineExceeded` (an
:class:`EngineError` with HTTP code 504) whose message names the stage, and
counts the expiry in ``dyn_deadline_expiries_total{stage=...}`` — an expiry
is always a clean, attributable 504, never a hang.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, AsyncIterator, Awaitable, Optional, TypeVar

from .engine import EngineError

# wire-envelope field (request control header / queue job) carrying the
# absolute deadline; planes that drop unknown fields degrade to no
# deadline. The JAX package declares it in its wire-field registry
# (``runtime/wire.py``) and re-exports it here; the port defines the same
# value until its own ``wire.py`` exists.
DEADLINE_KEY = "deadline"

T = TypeVar("T")


class DeadlineExceeded(EngineError):
    """The request's end-to-end deadline passed at ``stage``. Maps to HTTP
    504; the stage name travels in the message so a timed-out client knows
    WHERE the pipeline stalled."""

    def __init__(self, stage: str, deadline: Optional[float] = None):
        late = f" ({time.time() - deadline:.2f}s past deadline)" \
            if deadline else ""
        super().__init__(
            f"request deadline exceeded at stage {stage!r}{late}", 504,
            stage=stage, reason="deadline")


def expire(stage: str, deadline: Optional[float] = None) -> DeadlineExceeded:
    """Count the expiry and build the exception (callers raise it)."""
    from ..utils.prometheus import stage_metrics

    stage_metrics().deadline_expiries.inc(stage)
    return DeadlineExceeded(stage, deadline)


def expired(deadline: Optional[float]) -> bool:
    return deadline is not None and time.time() >= deadline


def remaining(deadline: Optional[float]) -> Optional[float]:
    """Seconds left, or None for no deadline. Never negative."""
    if deadline is None:
        return None
    return max(0.0, deadline - time.time())


def check(deadline: Optional[float], stage: str) -> None:
    """Raise (and count) if the deadline has passed."""
    if expired(deadline):
        raise expire(stage, deadline)


async def wait_for(aw: Awaitable[T], deadline: Optional[float],
                   stage: str, slack: float = 0.0) -> T:
    """Await ``aw`` bounded by the deadline; no deadline => unbounded.

    ``slack`` loosens OUTER enforcement layers: a hop that has deeper,
    exact enforcement beneath it (HTTP above the rpc client above the
    worker) waits slightly past the deadline so the innermost stage's 504
    — the diagnostic one — propagates up instead of being masked by a
    generic outer expiry. If the inner layer is truly hung, the outer
    guard still fires ``slack`` seconds later: hang-proof either way."""
    if deadline is None:
        return await aw  # unbounded-ok: caller declared no deadline
    rem = remaining(deadline + slack)
    if not rem:
        # cancel rather than leak the un-awaited coroutine/future
        asyncio.ensure_future(aw).cancel()
        raise expire(stage, deadline)
    try:
        return await asyncio.wait_for(aw, rem)
    except asyncio.TimeoutError:
        raise expire(stage, deadline) from None


async def guard_stream(agen: AsyncIterator[Any], deadline: Optional[float],
                       stage: str, slack: float = 0.0
                       ) -> AsyncIterator[Any]:
    """Re-yield ``agen`` enforcing the deadline on every inter-item gap.
    With no deadline this is a plain passthrough (no per-item wait_for).
    ``slack``: see :func:`wait_for`."""
    if deadline is None:
        async for item in agen:
            yield item
        return
    try:
        while True:
            try:
                item = await wait_for(agen.__anext__(), deadline, stage,
                                      slack)
            except StopAsyncIteration:
                return
            yield item
    finally:
        aclose = getattr(agen, "aclose", None)
        if aclose is not None:
            try:
                await aclose()
            except Exception:  # noqa: BLE001 - teardown must not mask
                pass


def from_timeout(timeout: Optional[float]) -> Optional[float]:
    """Absolute deadline ``timeout`` seconds from now (None passthrough)."""
    return None if timeout is None else time.time() + float(timeout)
