"""The universal engine abstraction.

Everything that turns a request into a stream of responses — the torch engine,
the echo test engines, remote clients, routers — implements :class:`AsyncEngine`.
Mirrors the capability of the reference's ``AsyncEngine`` trait
(reference: lib/runtime/src/engine.rs:22-145): ``generate(SingleIn<Req>) ->
ManyOut<Resp>`` with a per-request context carrying ``id``, cooperative
``stop_generating`` and hard ``kill`` signals.

Idiomatic Python shape: ``generate()`` is an async function returning an async
iterator of responses; the context travels with the request.
"""

from __future__ import annotations

import asyncio
import uuid
from typing import AsyncIterator, Generic, Optional, TypeVar

Req = TypeVar("Req")
Resp = TypeVar("Resp")


class Context:
    """Per-request lifecycle control.

    Carries the request id and two levels of cancellation:

    - ``stop_generating()`` — cooperative: the engine should finish the current
      step, emit what it has, and end the stream.
    - ``kill()`` — hard: the engine should drop the request immediately.

    Reference capability: ``AsyncEngineContext`` (lib/runtime/src/engine.rs:71-109).
    """

    __slots__ = ("id", "deadline", "priority", "resume_no", "_stopped",
                 "_killed", "_children")

    def __init__(self, id: Optional[str] = None,
                 deadline: Optional[float] = None,
                 priority: str = "interactive"):
        self.id: str = id or uuid.uuid4().hex
        # mid-stream failover attempt ordinal (llm/resume.py): attempt N of
        # a broken stream re-enters the plane under the SAME id with
        # resume_no = N, superseding a zombie context of a lower ordinal
        # at the worker's duplicate-context guard
        self.resume_no: int = 0
        # absolute wall-clock (time.time()) end-to-end deadline; rides the
        # wire envelope so every hop can refuse work nobody awaits anymore
        self.deadline: Optional[float] = deadline
        # overload-control class ("interactive" | "batch", utils/overload):
        # rides the wire envelope too — shedding and queue ordering at
        # every stage strictly prefer interactive
        self.priority: str = priority
        self._stopped = asyncio.Event()
        self._killed = asyncio.Event()
        self._children: list["Context"] = []

    # -- signalling ---------------------------------------------------------
    def stop_generating(self) -> None:
        self._stopped.set()
        for c in self._children:
            c.stop_generating()

    def kill(self) -> None:
        self._killed.set()
        self._stopped.set()
        for c in self._children:
            c.kill()

    # -- queries ------------------------------------------------------------
    @property
    def is_stopped(self) -> bool:
        return self._stopped.is_set()

    @property
    def is_killed(self) -> bool:
        return self._killed.is_set()

    async def stopped(self) -> None:
        await self._stopped.wait()

    async def killed(self) -> None:
        await self._killed.wait()

    def child(self, id: Optional[str] = None) -> "Context":
        """A linked context: signals on self propagate to the child (the
        deadline is inherited — a sub-call cannot outlive its request)."""
        c = Context(id or self.id, deadline=self.deadline,
                    priority=self.priority)
        if self.is_killed:
            c.kill()
        elif self.is_stopped:
            c.stop_generating()
        self._children.append(c)
        return c


class AsyncEngine(Generic[Req, Resp]):
    """Single-in, many-out engine: one request => an async stream of responses."""

    async def generate(self, request: Req, context: Context) -> AsyncIterator[Resp]:
        raise NotImplementedError

    def __call__(self, request: Req, context: Optional[Context] = None):
        return self.generate(request, context or Context())


class EngineError(Exception):
    """An error produced by an engine before or during streaming; carries an
    optional http-ish status code so frontends can map it, plus the typed
    overload/deadline fields every failure response exposes uniformly:
    ``stage`` (which pipeline hop failed), ``reason`` (which rule fired)
    and ``retry_after`` (seconds — the 429/503 Retry-After hint). All three
    survive the wire (error-frame control fields) so a frontend's error
    body names the REMOTE stage that shed or expired the request."""

    def __init__(self, message: str, code: int = 500, *,
                 stage: Optional[str] = None, reason: Optional[str] = None,
                 retry_after: Optional[float] = None):
        super().__init__(message)
        self.code = code
        self.stage = stage
        self.reason = reason
        self.retry_after = retry_after

