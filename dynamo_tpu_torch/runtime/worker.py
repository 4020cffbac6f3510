"""Worker lifecycle: signal-driven graceful shutdown over a cancellation
token tree.

``Worker.execute(main)`` is the process entry used by every long-running
binary: it installs SIGINT/SIGTERM handlers that cancel the root
``CancellationToken``; the app receives the token (and usually hands child
tokens to its runtimes/endpoints). On cancellation the worker FIRST makes
itself invisible — endpoint registrations deregister via lease revoke
(``DistributedRuntime.prepare_drain``) so the watch plane stops routing new
work here, and queue-pull loops see the ``draining`` flag — then lets
in-flight streams run to completion for up to ``grace`` seconds
(``DYN_DRAIN_TIMEOUT``), cooperatively stops any stragglers (short flush
window), and hard-kills the rest. A second signal skips the grace period.

Reference capability: lib/runtime/src/worker.rs:60-99,182 (Worker::execute
+ ctrl-c → CancellationToken tree) and the ControlMessage Stop/Kill
semantics of engine.rs:71-85.
"""

from __future__ import annotations

import asyncio
import logging
import signal
from typing import Awaitable, Callable, List, Optional

log = logging.getLogger("dynamo_tpu_torch.worker")


class CancellationToken:
    """Hierarchical cancellation: cancelling a parent cancels all children
    (children cancelling does not propagate up) — the same tree shape the
    reference hangs off its runtime/lease/endpoint layers."""

    def __init__(self, parent: Optional["CancellationToken"] = None):
        self._event = asyncio.Event()
        self._children: List["CancellationToken"] = []
        self._callbacks: List[Callable[[], None]] = []
        self.parent = parent
        if parent is not None:
            parent._children.append(self)
            if parent.cancelled:
                self._event.set()

    def child(self) -> "CancellationToken":
        return CancellationToken(self)

    @property
    def cancelled(self) -> bool:
        return self._event.is_set()

    def cancel(self) -> None:
        if self._event.is_set():
            return
        self._event.set()
        for cb in self._callbacks:
            try:
                cb()
            except Exception:  # noqa: BLE001 - callbacks must not stop fanout
                log.exception("cancellation callback failed")
        for c in self._children:
            c.cancel()

    def on_cancel(self, cb: Callable[[], None]) -> None:
        """Register a sync callback; fires immediately if already cancelled."""
        if self.cancelled:
            cb()
        else:
            self._callbacks.append(cb)

    async def wait(self) -> None:
        await self._event.wait()


class Worker:
    """Process shell: runs an async app under a root cancellation token with
    signal-driven graceful shutdown.

        async def app(token):
            drt = await DistributedRuntime(...).connect()
            worker.add_runtime(drt)
            ...
            await token.wait()          # serve until shutdown

        Worker().execute(app)
    """

    def __init__(self, grace: Optional[float] = None):
        if grace is None:
            # drain budget: how long in-flight streams get to finish after
            # SIGTERM before the cooperative stop escalates to kill
            import os
            try:
                grace = float(os.environ.get("DYN_DRAIN_TIMEOUT", 10.0))
            except ValueError:
                grace = 10.0
        self.grace = grace
        self.token = CancellationToken()
        self._runtimes: List[object] = []
        self._signals = 0
        self._force = False   # second signal: skip the grace window

    def add_runtime(self, drt) -> None:
        """Runtimes registered here get their in-flight requests stopped
        (then killed) and their connections closed during shutdown."""
        self._runtimes.append(drt)

    # ------------------------------------------------------------------
    def _on_signal(self) -> None:
        self._signals += 1
        if self._signals == 1:
            log.info("shutdown signal: draining (grace %.1fs); "
                     "signal again to skip", self.grace)
            self.token.cancel()
        else:
            log.warning("second signal: hard shutdown")
            self._force = True
            for drt in self._runtimes:
                for ctx in list(getattr(drt, "_active", {}).values()):
                    ctx.kill()

    async def _run(self, app: Callable[[CancellationToken], Awaitable]) -> None:
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, self._on_signal)
            except (NotImplementedError, RuntimeError):
                pass   # non-main thread / platform without signal support
        app_task = asyncio.create_task(app(self.token))
        cancel_wait = asyncio.create_task(self.token.wait())
        try:
            done, _ = await asyncio.wait(
                {app_task, cancel_wait},
                return_when=asyncio.FIRST_COMPLETED)
            if app_task in done and not self.token.cancelled:
                # app returned (or raised) on its own, no shutdown signal
                cancel_wait.cancel()
                await app_task
                return
            # a cancelled token ALWAYS takes the shutdown path — even if
            # the app task completed in the same event-loop pass (the
            # documented 'await token.wait(); return' app pattern does),
            # in-flight requests must still be drained and leases revoked
            await self._shutdown(app_task)
        finally:
            cancel_wait.cancel()

    async def _shutdown(self, app_task: asyncio.Task) -> None:
        # flight-recorder heartbeat over the whole drain: a drain that
        # outlives grace*1.25 (natural window + flush window + slack) is a
        # wedged stream, and the watchdog turns it into a stall:drain span
        from ..obs import flightrec as _flightrec

        _flightrec.hb_begin("worker.drain", stall="drain",
                            budget=self.grace * 1.25 + 1.0)
        try:
            await self._shutdown_inner(app_task)
        finally:
            _flightrec.hb_end("worker.drain")

    async def _shutdown_inner(self, app_task: asyncio.Task) -> None:
        # 0. become invisible FIRST: deregister endpoints (lease revoke) so
        # the watch plane routes new work elsewhere, and flag draining so
        # queue-pull loops stop taking jobs — all before any stream is
        # disturbed.
        for drt in self._runtimes:
            prepare = getattr(drt, "prepare_drain", None)
            if prepare is not None:
                try:
                    await prepare()
                except Exception:  # noqa: BLE001 - drain is best-effort
                    log.exception("prepare_drain failed")
        # 1. natural drain: being deregistered, no NEW work arrives — let
        # in-flight streams run to completion within the drain budget
        # (clients get their full responses, not truncations)
        def active() -> int:
            return sum(len(getattr(drt, "_active", {}))
                       for drt in self._runtimes)

        loop = asyncio.get_event_loop()
        deadline = loop.time() + self.grace
        while loop.time() < deadline and not self._force and active():
            await asyncio.sleep(0.05)
        # 2. budget spent: cooperatively stop the stragglers (engines
        # flush what they have and end their streams cleanly) and give
        # them a short flush window
        for drt in self._runtimes:
            for ctx in list(getattr(drt, "_active", {}).values()):
                ctx.stop_generating()
        flush_deadline = loop.time() + min(1.0, self.grace)
        while loop.time() < flush_deadline and not self._force and active():
            await asyncio.sleep(0.05)
        # 3. kill whatever is left
        for drt in self._runtimes:
            for ctx in list(getattr(drt, "_active", {}).values()):
                ctx.kill()
        # 4. close runtimes (revokes leases => endpoints deregister)
        for drt in self._runtimes:
            close = getattr(drt, "close", None)
            if close is not None:
                try:
                    await close()
                except Exception:  # noqa: BLE001 - best-effort teardown
                    log.exception("runtime close failed")
        app_task.cancel()
        try:
            await app_task
        except asyncio.CancelledError:
            pass
        except Exception:
            # the app coroutine failed BEFORE shutdown and nobody awaited
            # it yet — this reap is the last chance to see why
            log.exception("app task failed")

    def execute(self, app: Callable[[CancellationToken], Awaitable]) -> None:
        asyncio.run(self._run(app))
