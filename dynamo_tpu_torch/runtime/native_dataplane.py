"""ctypes binding for the native (C++) data-plane server.

``DYNAMO_TPU_DATAPLANE=native`` (and ``auto`` where ``g++`` builds it) makes
:class:`DistributedRuntime` serve its endpoints through
``libdynamo_dataplane.so``, built from ``dynamo_tpu_torch/native/dataplane.cpp``
by :mod:`dynamo_tpu_torch.native._build`: connection accept, frame parsing,
write buffering and stop/kill demultiplexing run on a native epoll thread,
and only request EXECUTION crosses into Python — the C side calls back with
(stream id, endpoint, payload), the handler's response items are packed here
by :func:`.wire.pack` and queued back through ``dp_send``.

The callbacks run on the C thread: each copies its bytes out and hands the
work to the asyncio loop with ``call_soon_threadsafe``; no handler ever runs
on the C thread. The callback objects live as long as the plane.

The asyncio server (component.py ``_serve_conn``) keeps identical wire
semantics; this module re-implements the request-runner contract
(prologue, error-before-stream, data/sentinel frames, duplicate-context
guard with resume supersede, streaming request parts, and the envelope's
deadline, priority and trace parent: the ingress expiry check, the
Context's deadline and priority, the server span's parent) against the C
ABI.
Reference capability: lib/runtime/src/pipeline/network ingress +
tcp/server.rs — the reference's native response plane.
"""

from __future__ import annotations

import asyncio
import ctypes
import json
import logging
import math
from typing import Any, Dict, Optional

from .wire import CODE_KEY, KIND_KEY, MESSAGE_KEY, pack
from .engine import Context, EngineError
from ..utils.aiotasks import spawn

log = logging.getLogger("dynamo_tpu_torch.native_dataplane")

_REQUEST_CB = ctypes.CFUNCTYPE(None, ctypes.c_int64, ctypes.c_char_p,
                               ctypes.c_char_p, ctypes.c_char_p,
                               ctypes.POINTER(ctypes.c_uint8),
                               ctypes.c_uint64, ctypes.c_int,
                               ctypes.c_int64, ctypes.c_double,
                               ctypes.c_char_p, ctypes.c_char_p,
                               ctypes.c_char_p)
_PART_CB = ctypes.CFUNCTYPE(None, ctypes.c_int64,
                            ctypes.POINTER(ctypes.c_uint8),
                            ctypes.c_uint64, ctypes.c_int)
_CONTROL_CB = ctypes.CFUNCTYPE(None, ctypes.c_int64, ctypes.c_int)

_STOP, _KILL, _GONE = 0, 1, 2


def _load_lib() -> ctypes.CDLL:
    from ..native._build import build

    lib = ctypes.CDLL(str(build("libdynamo_dataplane.so")))
    lib.dp_start.restype = ctypes.c_void_p
    lib.dp_start.argtypes = [ctypes.c_char_p, ctypes.c_int, _REQUEST_CB,
                             _PART_CB, _CONTROL_CB]
    lib.dp_port.restype = ctypes.c_int
    lib.dp_port.argtypes = [ctypes.c_void_p]
    lib.dp_send.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                            ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64]
    lib.dp_end.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.dp_backlog.restype = ctypes.c_int64
    lib.dp_backlog.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.dp_stop.argtypes = [ctypes.c_void_p]
    return lib


class NativeDataPlane:
    """One per process (like the asyncio data-plane server)."""

    HIGH_WATER = 8 * 1024 * 1024   # pause the producer above this backlog

    def __init__(self, drt):
        self.drt = drt          # handlers + active-context registry live here
        self.lib = _load_lib()
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self.handle: Optional[int] = None
        self.port: int = 0
        self._contexts: Dict[int, Context] = {}
        self._part_queues: Dict[int, asyncio.Queue] = {}
        self._run_tasks: set = set()    # in-flight handler tasks (spawn)
        # keep callback objects alive for the lifetime of the server
        self._cb_request = _REQUEST_CB(self._on_request)
        self._cb_part = _PART_CB(self._on_part)
        self._cb_control = _CONTROL_CB(self._on_control)

    def start(self, host: str = "0.0.0.0", port: int = 0) -> int:
        self.loop = asyncio.get_running_loop()
        self.handle = self.lib.dp_start(host.encode(), port,
                                        self._cb_request, self._cb_part,
                                        self._cb_control)
        if not self.handle:
            raise RuntimeError("native data plane failed to start")
        self.port = self.lib.dp_port(self.handle)
        return self.port

    def stop(self) -> None:
        if self.handle:
            self.lib.dp_stop(self.handle)
            self.handle = None

    # ------------------------------------------------------------------
    # C-thread callbacks: copy data out, hop onto the asyncio loop
    # ------------------------------------------------------------------
    def _on_request(self, sid, endpoint, ctx_id, ctype, payload, length,
                    streaming, resume, deadline, priority, trace_id,
                    trace_parent):
        data = ctypes.string_at(payload, length) if length else b""
        trace = [trace_id.decode(), (trace_parent or b"").decode() or None] \
            if trace_id else None
        self.loop.call_soon_threadsafe(
            self._begin, sid, (endpoint or b"").decode(),
            (ctx_id or b"").decode() or None, (ctype or b"").decode(),
            data, bool(streaming), int(resume),
            None if math.isnan(deadline) else deadline,
            (priority or b"").decode() or "interactive", trace)

    def _on_part(self, sid, data, length, is_end):
        chunk = ctypes.string_at(data, length) if length else b""
        self.loop.call_soon_threadsafe(self._deliver_part, sid,
                                       chunk, bool(is_end))

    def _on_control(self, sid, kind):
        self.loop.call_soon_threadsafe(self._control, sid, kind)

    # ------------------------------------------------------------------
    def _send(self, sid: int, control: Dict[str, Any],
              payload: Optional[bytes]) -> None:
        if not self.handle:
            return   # server stopped with streams in flight: drop
        frame = pack([control, payload])
        buf = (ctypes.c_uint8 * len(frame)).from_buffer_copy(frame)
        self.lib.dp_send(self.handle, sid, buf, len(frame))

    def _end(self, sid: int) -> None:
        if self.handle:
            self.lib.dp_end(self.handle, sid)

    def _backlog(self, sid: int) -> int:
        if not self.handle:
            return 0
        return max(0, self.lib.dp_backlog(self.handle, sid))

    def _deliver_part(self, sid: int, chunk: bytes, is_end: bool) -> None:
        q = self._part_queues.get(sid)
        if q is not None:
            q.put_nowait(None if is_end else chunk)

    def _control(self, sid: int, kind: int) -> None:
        ctx = self._contexts.get(sid)
        if ctx is not None:
            if kind == _KILL:
                ctx.kill()
            else:       # stop, or client gone mid-stream
                ctx.stop_generating()
        if kind in (_KILL, _GONE):
            # a handler blocked on request parts must unblock: the client
            # can never send the 'end' frame now
            self._deliver_part(sid, b"", True)

    # ------------------------------------------------------------------
    def _begin(self, sid: int, endpoint: str, ctx_id: Optional[str],
               ctype: str, payload: bytes, streaming: bool,
               resume: int = 0, deadline: Optional[float] = None,
               priority: str = "interactive",
               trace: Optional[list] = None) -> None:
        if streaming:
            # register the part queue NOW: part/end callbacks already queued
            # behind this one on the loop must find it (the _run coroutine
            # itself only starts a loop tick later)
            self._part_queues[sid] = asyncio.Queue()
        # the Context too: a stop/kill/disconnect control queued right
        # behind this callback must find it, or the control is lost and the
        # handler runs to completion against a dead client
        ctx = Context(ctx_id, deadline=deadline, priority=priority)
        ctx.resume_no = resume
        self._contexts[sid] = ctx
        # retained handle: _run catches transport errors itself, but a bug
        # BEFORE its try (or a cancelled loop) must still surface instead
        # of vanishing with the dropped task
        spawn(self._run(sid, endpoint, ctx, ctype, payload, streaming,
                        trace),
              name=f"native-dp-run-{sid}", store=self._run_tasks)

    async def _run(self, sid: int, endpoint: str, ctx: Context,
                   ctype: str, payload: bytes, streaming: bool,
                   trace: Optional[list] = None) -> None:
        from . import deadline as dl
        from .component import error_control

        drt = self.drt

        def reject(err: EngineError):
            self._part_queues.pop(sid, None)
            self._contexts.pop(sid, None)
            self._send(sid, error_control(err), None)
            self._end(sid)

        handler = drt._handlers.get(endpoint)
        if handler is None:
            reject(EngineError(f"no endpoint {endpoint!r}", 404))
            return
        # the _begin-created Context uses ctx.id == wire ctx_id (or a fresh
        # one); a duplicate in-flight id is a stale-retry double delivery —
        # unless it carries a higher resume ordinal (llm/resume.py): then
        # the active context is a zombie whose stream broke client-side,
        # and the resume attempt supersedes it (same semantics as the
        # asyncio server's guard in component.py)
        stale = drt._active.get(ctx.id)
        if stale is not None:
            if ctx.resume_no > stale.resume_no:
                log.warning("context %s superseded by resume attempt %d "
                            "(stale attempt %d killed)", ctx.id,
                            ctx.resume_no, stale.resume_no)
                stale.kill()
                del drt._active[ctx.id]
            else:
                reject(EngineError(f"context {ctx.id} is already executing "
                                   f"(duplicate delivery)", 409))
                return
        request: Any
        try:
            if ctype == "bin":
                request = payload
            else:
                request = json.loads(payload.decode()) if payload else None
        except (ValueError, UnicodeDecodeError) as e:
            reject(EngineError(f"malformed request payload: {e}", 400))
            return
        if dl.expired(ctx.deadline):
            # died in transit or queueing: refused and counted per stage,
            # as the asyncio plane's ingress does
            reject(dl.expire(f"worker_ingress:{endpoint}", ctx.deadline))
            return
        drt._active[ctx.id] = ctx
        from ..utils.logging_ext import request_id_var
        from ..utils.tracing import current_span_var, extract_wire, get_tracer
        rid_token = request_id_var.set(ctx.id)
        # server span: parented from the wire trace field when present,
        # else a parentless span on trace_id == context id (as the asyncio
        # plane does)
        tracer = get_tracer()
        srv_span = tracer.start_span(
            f"rpc:{endpoint}", parent=extract_wire(trace, ctx.id),
            context_id=ctx.id)
        span_token = current_span_var.set(srv_span.context()) \
            if srv_span is not None else None

        if streaming:
            from .component import StreamingRequest

            q = self._part_queues[sid]

            async def parts_gen():
                while True:
                    chunk = await q.get()
                    if chunk is None:
                        return
                    yield chunk

            request = StreamingRequest(meta=request, parts=parts_gen())

        srv_status = "error"
        try:
            from .component import drive_handler_stream

            async def send(control, payload):
                self._send(sid, control, payload)
                # backpressure: the asyncio path awaited writer.drain();
                # here the native write buffer is polled so a slow client
                # cannot grow it without bound. A killed/stopped context must
                # break out — a stalled-but-connected client would otherwise
                # pin this handler (and its engine slot) forever.
                while self._backlog(sid) > self.HIGH_WATER:
                    if ctx.is_killed or ctx.is_stopped:
                        raise ConnectionResetError(
                            "stream cancelled while backpressured")
                    await asyncio.sleep(0.005)

            if await drive_handler_stream(handler(request, ctx), send):
                srv_status = "ok"
        except Exception as e:  # noqa: BLE001 - transport-level failure
            try:
                self._send(sid, {KIND_KEY: "error", MESSAGE_KEY: str(e),
                                 CODE_KEY: 500}, None)
            except Exception:
                # stream already torn down native-side: the error frame
                # has no one to reach
                log.debug("error frame undeliverable (stream %d gone)",
                          sid, exc_info=True)
        finally:
            drt._active.pop(ctx.id, None)
            self._contexts.pop(sid, None)
            self._part_queues.pop(sid, None)
            if span_token is not None:
                current_span_var.reset(span_token)
            tracer.finish(srv_span, status=srv_status)
            request_id_var.reset(rid_token)
            self._end(sid)
