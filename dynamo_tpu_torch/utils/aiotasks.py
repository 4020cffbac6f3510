"""Retained background tasks: the sanctioned fire-and-forget pattern.

``asyncio.create_task`` as a bare statement drops the only reference to
the task: its exception is swallowed until GC (then surfaces as an
unactionable "Task exception was never retrieved"), and since the loop
holds tasks only weakly, the work itself can be collected mid-flight.
The dynalint ``fire-and-forget`` rule bans the bare form; this module is
what you call instead when a task really is launch-and-move-on:

    from ..utils.aiotasks import spawn
    spawn(self._publish(ev), name="kv-hit-rate")

:func:`spawn` keeps a strong reference in a registry until the task
settles, and logs any exception (cancellation excluded) so failures leave
a trace. Pass ``store=`` to use an owner-scoped registry you can drain on
shutdown (:func:`cancel_all`).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Coroutine, Optional, Set

log = logging.getLogger("dynamo_tpu_torch.aiotasks")

#: default registry: strong refs for tasks with no owning object
_BACKGROUND: Set["asyncio.Task"] = set()


def spawn(coro: Coroutine[Any, Any, Any], *, name: Optional[str] = None,
          store: Optional[Set["asyncio.Task"]] = None) -> "asyncio.Task":
    """create_task + retention + exception logging, in one call."""
    registry = _BACKGROUND if store is None else store
    task = asyncio.ensure_future(coro)
    if name and hasattr(task, "set_name"):
        task.set_name(name)
    registry.add(task)

    def _done(t: "asyncio.Task") -> None:
        registry.discard(t)
        if t.cancelled():
            return
        exc = t.exception()
        if exc is not None:
            log.error("background task %s died: %r",
                      name or getattr(t, "get_name", lambda: "?")(), exc)

    task.add_done_callback(_done)
    return task


async def cancel_all(store: Set["asyncio.Task"]) -> None:
    """Cancel and await every task in an owner-scoped registry (shutdown
    path: nothing may outlive its owner and log into a torn-down world)."""
    tasks = [t for t in store if not t.done()]
    for t in tasks:
        t.cancel()
    for t in tasks:
        try:
            await t
        # dynalint: ok(swallowed-exception) the done-callback already
        # logged any non-cancel exception; this await only reaps
        except (asyncio.CancelledError, Exception):
            pass


def spawn_blocking(fn, *args, name: Optional[str] = None):
    """Run a blocking callable on the default executor as a RETAINED
    future — concurrent with whatever the caller awaits next — reaping
    (and logging) any failure instead of leaving a GC'd "exception never
    retrieved" warning. The best-effort overlap helper behind the h2d
    prefetch call sites; the callable owns its own fallback semantics."""
    fut = asyncio.get_running_loop().run_in_executor(None, fn, *args)

    def _done(t) -> None:
        if t.cancelled():
            return
        exc = t.exception()
        if exc is not None:
            log.error("blocking task %s died: %r", name or fn, exc)

    fut.add_done_callback(_done)
    return fut
