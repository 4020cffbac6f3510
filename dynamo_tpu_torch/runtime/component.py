"""Distributed runtime: Namespace -> Component -> Endpoint model.

A worker process creates a :class:`DistributedRuntime` (store connection +
lease), names a component, and serves endpoints. Serving an endpoint:

1. starts (once per process) a TCP data-plane server speaking two-part frames,
2. registers ``{namespace}/components/{component}/{endpoint}:{lease_id}`` in
   dynstore bound to the process lease (death => key vanishes => clients
   shrink their live set automatically — the failure-detection plane).

Requests flow DIRECTLY client->worker over TCP (the reference splits NATS
request / TCP response; with no broker in the middle we collapse both onto
one connection, keeping the two-part codec, the error-before-stream prologue
and Stop/Kill control messages of the reference's wire contract,
lib/runtime/src/pipeline/network.rs:44-233).

Reference capability: lib/runtime/src/component.rs, component/endpoint.rs,
component/client.rs, distributed.rs.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import logging
import os
import random
from dataclasses import dataclass
from typing import Any, AsyncIterator, Awaitable, Callable, Dict, List, Optional, Tuple

from ..utils import faults
from . import deadline as dl
from .circuit_breaker import InstanceBreaker
from .engine import AsyncEngine, Context, EngineError
from .wire import (CODE_KEY, CONTEXT_ID_KEY, CTYPE_KEY, ENDPOINT_KEY,
                   KIND_KEY, MESSAGE_KEY, PRIORITY_KEY, REASON_KEY,
                   RESUME_KEY, RETRY_AFTER_KEY, STAGE_KEY, STREAMING_KEY,
                   TRACE_KEY, FrameReader, attach_trace, extract_trace,
                   unpack_two_part, write_frame)

log = logging.getLogger("dynamo_tpu_torch.runtime")

Handler = Callable[[Any, Context], AsyncIterator[Any]]


def error_control(e: Exception, code: Optional[int] = None) -> dict:
    """Error-frame control header for an exception. Typed EngineErrors keep
    their http-ish code AND their overload/deadline fields (stage, reason,
    retry_after) so the far end re-raises an equally typed error — a remote
    shed/expiry must reach the frontend's error body naming its stage."""
    c: dict = {KIND_KEY: "error", MESSAGE_KEY: str(e),
               CODE_KEY: code if code is not None else (
                   e.code if isinstance(e, EngineError) else 500)}
    for k in (STAGE_KEY, REASON_KEY, RETRY_AFTER_KEY):
        v = getattr(e, k, None)
        if v is not None:
            c[k] = v
    return c


def error_from_control(control: dict) -> EngineError:
    """The inverse: re-raise a wire error frame as a typed EngineError."""
    return EngineError(control.get(MESSAGE_KEY, "remote error"),
                       control.get(CODE_KEY, 500),
                       stage=control.get(STAGE_KEY),
                       reason=control.get(REASON_KEY),
                       retry_after=control.get(RETRY_AFTER_KEY))


async def drive_handler_stream(stream, send) -> bool:
    """Drive a handler's response stream through ``await send(control,
    payload)`` — the ONE implementation of the response wire protocol
    (error-before-stream prologue, data / bin frames, sentinel, mid-stream
    error frames) shared by the asyncio and native data planes. Connection
    errors raised by ``send`` propagate to the caller. Returns True on a
    clean full stream, False when a handler error became an error frame
    (the servers mark the request's rpc span accordingly)."""
    try:
        first = await stream.__anext__()
        have_first = True
    except StopAsyncIteration:
        have_first = False
    except EngineError as e:
        await send(error_control(e), None)
        return False
    except Exception as e:  # noqa: BLE001
        await send({KIND_KEY: "error", MESSAGE_KEY: str(e),
                    CODE_KEY: 500}, None)
        return False
    await send({KIND_KEY: "prologue"}, None)

    def enc(item):
        if isinstance(item, (bytes, bytearray)):
            return {KIND_KEY: "data", CTYPE_KEY: "bin"}, bytes(item)
        return {KIND_KEY: "data"}, json.dumps(item).encode()

    try:
        if have_first:
            await send(*enc(first))
            async for item in stream:
                await send(*enc(item))
        await send({KIND_KEY: "sentinel"}, None)
    except (ConnectionResetError, BrokenPipeError):
        raise
    except Exception as e:  # noqa: BLE001 - mid-stream failure
        # typed engine errors (e.g. DeadlineExceeded=504, OverloadError=429)
        # keep their code + stage/reason; everything else is a 500
        try:
            await send(error_control(e), None)
        except Exception:
            # peer is already gone — the error frame has no one to reach
            log.debug("error frame undeliverable (peer gone)",
                      exc_info=True)
        return False
    return True


@dataclass
class StreamingRequest:
    """A client-streamed request: a JSON meta header plus a sequence of raw
    binary parts (the KV-block upload shape). Handlers registered on an
    endpoint receive this when the caller used ``parts=``; they MUST drain
    ``parts`` before yielding responses."""

    meta: Any
    parts: AsyncIterator[bytes]


def endpoint_key(namespace: str, component: str, endpoint: str,
                 lease: int) -> str:
    return f"{namespace}/components/{component}/{endpoint}:{lease:x}"


def endpoint_prefix(namespace: str, component: str, endpoint: str) -> str:
    return f"{namespace}/components/{component}/{endpoint}:"


@dataclass
class EndpointInfo:
    """What a worker publishes to the store for one endpoint instance."""

    host: str
    port: int
    endpoint: str
    lease: int
    worker_id: int
    transport: str = "tcp"

    def to_bytes(self) -> bytes:
        return json.dumps(self.__dict__).encode()

    @classmethod
    def from_bytes(cls, b: bytes) -> "EndpointInfo":
        return cls(**json.loads(b.decode()))


DATAPLANE_MODES = ("auto", "python", "native")


class DistributedRuntime:
    """Per-process handle: store connection, lease, data-plane server."""

    def __init__(self, store_host: str = "127.0.0.1", store_port: int = 4222,
                 advertise_host: Optional[str] = None):
        # DYN_STORE_SHARDS set => a ShardedStoreClient routing each
        # keyspace family to its owning dynstore; unset => the plain
        # single-store client (identical behavior)
        from .scale.shards import make_store_client

        self.store = make_store_client(store_host, store_port)
        self.lease: Optional[int] = None
        self.worker_id: int = 0
        self._advertise_host = advertise_host
        self._dp_server: Optional[asyncio.base_events.Server] = None
        self._native_dp = None   # native (C++) data plane when enabled
        self.dataplane: Optional[str] = None   # "native" | "python"
        self.dp_host: Optional[str] = None
        self.dp_port: Optional[int] = None
        self._handlers: Dict[str, Handler] = {}
        self._active: Dict[str, Context] = {}
        self._conn_writers: set = set()   # live data-plane connections
        # graceful drain: set once the process decided to exit — queue-pull
        # loops and periodic publishers check it to stop taking new work
        self.draining = asyncio.Event()

    async def connect(self) -> "DistributedRuntime":
        await self.store.connect()
        # Liveness TTL (DYN_LEASE_TTL): keepalives fire every ttl/3 from
        # the asyncio loop, so the margin must absorb loop starvation
        # (compile storms, loaded CI boxes). 10s = etcd-typical default;
        # worker-death detection latency is bounded by the same number.
        import math
        raw_ttl = os.environ.get("DYN_LEASE_TTL", "10.0")
        try:
            ttl = float(raw_ttl)
        except ValueError:
            ttl = -1.0
        if not (math.isfinite(ttl) and ttl > 0):
            raise ValueError(f"DYN_LEASE_TTL={raw_ttl!r} (expected a "
                             "positive number of seconds)")
        self.lease = await self.store.lease_grant(ttl=ttl)
        self.worker_id = self.lease
        return self

    async def prepare_drain(self) -> None:
        """First phase of graceful shutdown: make the worker INVISIBLE
        before anything stops serving. Revoking the lease expires every
        lease-bound key (endpoint + model registrations, metrics snapshots)
        server-side, so watchers route new work elsewhere while in-flight
        streams keep completing here. Idempotent; store-unreachable is fine
        (the lease then expires by TTL, which is the same outcome later)."""
        if self.draining.is_set():
            return
        self.draining.set()
        # the deliberate revoke below must not read as a lease LOSS
        self.store.on_lease_lost = None
        if self.lease is not None:
            try:
                await self.store.lease_revoke(self.lease)
            except Exception:  # noqa: BLE001 - store may be mid-outage
                log.info("drain: lease revoke failed (store unreachable); "
                         "lease will expire by TTL", exc_info=True)

    async def close(self) -> None:
        # orderly shutdown: the revoke below would otherwise read as a
        # lease LOSS at the next keepalive beat and fire a spurious
        # shutdown callback
        self.draining.set()
        self.store.on_lease_lost = None
        if self.lease is not None:
            try:
                await self.store.lease_revoke(self.lease)
            except Exception:
                # store likely gone already; TTL expiry reaps the lease
                log.debug("lease revoke failed during close", exc_info=True)
        if self._dp_server:
            self._dp_server.close()
        # established connections must die with the runtime (a dead process
        # would reset them; a merely-closed listener leaves clients hanging
        # on streams forever) — stop in-flight requests, drop sockets
        for ctx in list(self._active.values()):
            ctx.stop_generating()
        for w in list(self._conn_writers):
            try:
                w.close()
            # dynalint: ok(swallowed-exception) best-effort socket
            # teardown while the runtime is exiting; nothing can act on a
            # close() failure and the fd dies with the process
            except Exception:
                pass
        self._conn_writers.clear()
        if self._native_dp is not None:
            self._native_dp.stop()
            self._native_dp = None
        await self.store.close()

    def namespace(self, name: str) -> "Namespace":
        return Namespace(self, name)

    # ------------------------------------------------------------------
    # data plane (one TCP server per process, endpoints multiplexed by name)
    # ------------------------------------------------------------------
    async def _ensure_data_plane(self) -> None:
        if self._dp_server is not None or self._native_dp is not None:
            return
        # DYNAMO_TPU_DATAPLANE: the native C++ epoll plane is the deployed
        # default; "python" forces the asyncio plane, "native" forces
        # native (any failure raises), unset = auto (native when g++
        # builds it, else asyncio, with the reason logged)
        mode = os.environ.get("DYNAMO_TPU_DATAPLANE", "auto")
        if mode not in DATAPLANE_MODES:
            raise ValueError(f"DYNAMO_TPU_DATAPLANE={mode!r} "
                             f"(expected auto|python|native)")
        if mode in ("auto", "native"):
            try:
                from .native_dataplane import NativeDataPlane

                self._native_dp = NativeDataPlane(self)
                self.dp_port = self._native_dp.start("0.0.0.0", 0)
            except Exception:
                self._native_dp = None   # half-started plane must not
                if mode == "native":     # block the asyncio fallback
                    raise
                log.info("native data plane unavailable; using asyncio",
                         exc_info=True)
        if self._native_dp is None:
            self._dp_server = await asyncio.start_server(
                self._serve_conn, "0.0.0.0", 0)
            self.dp_port = self._dp_server.sockets[0].getsockname()[1]
        self.dataplane = "python" if self._native_dp is None else "native"
        self.dp_host = self._advertise_host or _local_ip()
        log.info("data plane: %s on port %d", self.dataplane, self.dp_port)

    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        fr = FrameReader(reader)
        pending = None
        self._conn_writers.add(writer)
        try:
            while True:
                # unbounded-ok: idle server connection awaiting the next
                # request; lives exactly as long as the client keeps it
                frame = pending if pending is not None else await fr.read()
                pending = None
                control, payload = unpack_two_part(frame)
                kind = control.get(KIND_KEY)
                if kind == "request":
                    # one stream at a time per connection; clients pool and
                    # reuse connections for SEQUENTIAL requests. The control
                    # watcher may race ahead and consume the next request
                    # frame — _run_request hands it back as ``pending``.
                    pending = await self._run_request(control, payload, fr,
                                                      writer)
                else:
                    break
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        except ValueError as e:
            # malformed frame (typed by wire.unpack_two_part / MAX_FRAME):
            # this peer speaks a broken protocol — drop the connection
            log.warning("closing data-plane connection: %s", e)
        finally:
            self._conn_writers.discard(writer)
            writer.close()

    async def _run_request(self, control: Dict[str, Any],
                           payload: Optional[bytes], fr: FrameReader,
                           writer: asyncio.StreamWriter):
        """Serve one request stream. Returns a leftover frame if the control
        watcher consumed the NEXT pipelined request off the socket."""
        ep = control.get(ENDPOINT_KEY)
        ctx_id = control.get(CONTEXT_ID_KEY) or None
        handler = self._handlers.get(ep)
        if handler is None:
            await write_frame(writer, [{KIND_KEY: "error",
                                        MESSAGE_KEY: f"no endpoint {ep!r}",
                                        CODE_KEY: 404}, None])
            return None
        if control.get(CTYPE_KEY) == "bin":
            request = payload  # raw bytes pass through untouched (KV plane)
        else:
            request = json.loads(payload.decode()) if payload else None
        resume_no = int(control.get(RESUME_KEY) or 0)
        if ctx_id is not None and ctx_id in self._active:
            stale = self._active[ctx_id]
            if resume_no > stale.resume_no:
                # mid-stream failover (llm/resume.py): the client declared
                # the active context dead (its stream broke) and re-entered
                # with a higher attempt ordinal — possibly on this same
                # worker when it merely wedged. The old handler is a zombie
                # whose output nobody consumes: kill it and serve the
                # resume. Its finally-pop is identity-conditional, so it
                # cannot reap the replacement's _active entry.
                log.warning("context %s superseded by resume attempt %d "
                            "(stale attempt %d killed)", ctx_id, resume_no,
                            stale.resume_no)
                stale.kill()
                del self._active[ctx_id]
            else:
                # duplicate-context guard: a client's stale-connection retry
                # re-sent a request whose original is still executing (the
                # connection died mid-request) — fail cleanly instead of
                # double-executing a non-idempotent handler
                await write_frame(writer, [{
                    KIND_KEY: "error", CODE_KEY: 409,
                    MESSAGE_KEY: f"context {ctx_id} is already executing "
                                 f"(duplicate delivery)"}, None])
                return None
        req_deadline = control.get(dl.DEADLINE_KEY)
        if dl.expired(req_deadline):
            # the request died in transit/queueing: refuse to burn compute
            # on work nobody is waiting for (counted per stage)
            err = dl.expire(f"worker_ingress:{ep}", req_deadline)
            await write_frame(writer, [error_control(err), None])
            return None
        ctx = Context(ctx_id, deadline=req_deadline,
                      priority=control.get(PRIORITY_KEY) or "interactive")
        ctx.resume_no = resume_no
        self._active[ctx.id] = ctx
        from ..utils.logging_ext import request_id_var
        from ..utils.tracing import current_span_var, get_tracer
        rid_token = request_id_var.set(ctx.id)  # span: this request's id
        # server span: covers the whole handler stream; parented from the
        # wire trace field when present, else a fresh parentless span on
        # trace_id == context id (requests keep their id across hops)
        tracer = get_tracer()
        srv_span = tracer.start_span(
            f"rpc:{ep}", parent=extract_trace(control, ctx.id),
            context_id=ctx.id)
        span_token = current_span_var.set(srv_span.context()) \
            if srv_span is not None else None
        leftover: List[Any] = []

        async def watch_control():
            """Stop/Kill control frames arriving mid-stream. A non-control
            frame is the next pipelined request on a reused connection:
            stash it for _serve_conn and stop reading."""
            try:
                while True:
                    # unbounded-ok: control watcher is cancelled when the
                    # request finishes; disconnects stop the context below
                    frame = await fr.read()
                    ctrl, _ = unpack_two_part(frame)
                    if ctrl.get(KIND_KEY) == "stop":
                        ctx.stop_generating()
                    elif ctrl.get(KIND_KEY) == "kill":
                        ctx.kill()
                    else:
                        leftover.append(frame)
                        return
            except (asyncio.IncompleteReadError, ConnectionResetError):
                ctx.stop_generating()
            except ValueError as e:
                # malformed frame mid-request: same broken-protocol policy
                # as _serve_conn — without this, the watcher would die
                # silently in the reap below and stop/kill frames for the
                # rest of the request would be ignored
                log.warning("closing data-plane connection mid-request: %s",
                            e)
                ctx.stop_generating()
                writer.close()

        watcher = None
        if control.get(STREAMING_KEY):
            # the connection keeps carrying request parts; stop/kill frames
            # interleave on the same stream until the "end" marker, after
            # which the normal control watcher takes over the socket
            async def parts_gen():
                nonlocal watcher
                while True:
                    # unbounded-ok: client-streamed body; a disconnect
                    # raises into the handler, which owns the request
                    ctrl, p = unpack_two_part(await fr.read())
                    kind = ctrl.get(KIND_KEY)
                    if kind == "part":
                        yield p
                    elif kind == "end":
                        watcher = asyncio.create_task(watch_control())
                        return
                    elif kind == "stop":
                        ctx.stop_generating()
                    elif kind == "kill":
                        ctx.kill()

            request = StreamingRequest(meta=request, parts=parts_gen())
        else:
            watcher = asyncio.create_task(watch_control())
        srv_status = "error"
        try:
            async def send(control, payload):
                await write_frame(writer, [control, payload])

            if await drive_handler_stream(handler(request, ctx), send):
                srv_status = "ok"
        except (ConnectionResetError, BrokenPipeError):
            ctx.stop_generating()
        finally:
            if watcher is not None:
                watcher.cancel()
                try:
                    # cancel() only schedules: AWAIT the exit so the
                    # watcher's pending read fully releases the stream
                    # before _serve_conn reads the next request frame
                    await watcher
                except asyncio.CancelledError:
                    if not watcher.cancelled():
                        raise   # OUR task was cancelled, not the watcher
                # dynalint: ok(swallowed-exception) reaping our own
                # cancelled control watcher; a watcher error mid-request
                # already surfaced as the request's stop/kill outcome
                except Exception:
                    pass
            if self._active.get(ctx.id) is ctx:
                # identity-conditional: a resume attempt may have superseded
                # this context and installed its own under the same id
                del self._active[ctx.id]
            if span_token is not None:
                current_span_var.reset(span_token)
            tracer.finish(srv_span, status=srv_status)
            # reset: a reused (pipelined) connection must not tag later
            # frames/log lines with a finished request's id
            request_id_var.reset(rid_token)
        return leftover[0] if leftover else None


def _local_ip() -> str:
    """The address a data plane advertises when the caller names none.

    The JAX package finds the host's outbound address by routing a UDP
    socket toward a public address. The port advertises loopback and
    touches no outside address; a worker that other hosts dial (a fleet
    across hosts, a multi-node tensor-parallel leader: ROADMAP Queue 1
    item 11a) names its address with ``--advertise-host`` (the plane
    listens on every interface)."""
    return "127.0.0.1"


class Namespace:
    def __init__(self, drt: DistributedRuntime, name: str):
        self.drt = drt
        self.name = name

    def component(self, name: str) -> "Component":
        return Component(self, name)

    # namespace-scoped event plane
    async def publish(self, event: str, payload: Dict[str, Any]) -> None:
        await self.drt.store.publish(f"{self.name}.{event}",
                                     json.dumps(payload).encode())

    async def subscribe(self, event: str,
                        cb: Callable[[Dict[str, Any]], Awaitable[None]]) -> None:
        async def _cb(subject: str, payload: bytes):
            await cb(json.loads(payload.decode()))

        await self.drt.store.subscribe(f"{self.name}.{event}", _cb)


class Component:
    def __init__(self, ns: Namespace, name: str):
        self.namespace = ns
        self.name = name
        self.drt = ns.drt

    def endpoint(self, name: str) -> "Endpoint":
        return Endpoint(self, name)

    async def publish(self, event: str, payload: Dict[str, Any]) -> None:
        await self.drt.store.publish(
            f"{self.namespace.name}.{self.name}.{event}",
            json.dumps(payload).encode())

    async def subscribe(self, event: str,
                        cb: Callable[[Dict[str, Any]], Awaitable[None]]) -> None:
        async def _cb(subject: str, payload: bytes):
            await cb(json.loads(payload.decode()))

        await self.drt.store.subscribe(
            f"{self.namespace.name}.{self.name}.{event}", _cb)


class Endpoint:
    def __init__(self, component: Component, name: str):
        self.component = component
        self.name = name
        self.drt = component.drt

    @property
    def path(self) -> str:
        return (f"{self.component.namespace.name}."
                f"{self.component.name}.{self.name}")

    async def serve(self, handler: Handler) -> None:
        """Register the handler on the data plane + advertise in the store."""
        drt = self.drt
        await drt._ensure_data_plane()
        drt._handlers[self.name] = handler
        info = EndpointInfo(
            host=drt.dp_host, port=drt.dp_port, endpoint=self.name,
            lease=drt.lease, worker_id=drt.worker_id)
        key = endpoint_key(self.component.namespace.name,
                           self.component.name, self.name, drt.lease)
        await drt.store.put(key, info.to_bytes(), lease=drt.lease)

    async def serve_engine(self, engine: AsyncEngine) -> None:
        async def handler(request, ctx):
            async for item in engine.generate(request, ctx):
                yield item

        await self.serve(handler)

    def client(self) -> "Client":
        return Client(self)


class Client:
    """Watches the endpoint prefix => live instance set; issues requests with
    random / round_robin / direct routing. Data-plane connections are pooled
    per instance and reused for sequential requests (the server keeps the
    connection open across streams), saving a TCP handshake per request on
    the hot path. (Reference: component/client.rs:52-295 + egress/push.rs.)"""

    MAX_POOLED_PER_INSTANCE = 8

    def __init__(self, endpoint: Endpoint):
        self.endpoint = endpoint
        self.drt = endpoint.drt
        self.instances: Dict[int, EndpointInfo] = {}
        self._rr = itertools.count()
        self._watching = False
        # (host, port) -> idle (reader, FrameReader, writer) connections
        self._pool: Dict[Tuple[str, int], List[Any]] = {}
        # cross-request per-instance failure accounting (eject / half-open
        # probe / recover) — the per-call ``failed`` set only ever protected
        # one request from re-picking a dead instance
        self.breaker = InstanceBreaker()
        self.on_instances_changed: Optional[Callable[[], None]] = None

    def _pool_get(self, key):
        conns = self._pool.get(key)
        while conns:
            item = conns.pop()
            if not item[2].is_closing():
                return item
        return None

    def _pool_put(self, key, item) -> None:
        if item[2].is_closing():
            return
        conns = self._pool.setdefault(key, [])
        conns.append(item)
        while len(conns) > self.MAX_POOLED_PER_INSTANCE:
            conns.pop(0)[2].close()

    def _pool_drop(self, key) -> None:
        for item in self._pool.pop(key, []):
            item[2].close()

    async def start(self) -> "Client":
        prefix = endpoint_prefix(self.endpoint.component.namespace.name,
                                 self.endpoint.component.name,
                                 self.endpoint.name)

        async def on_change(key: str, value: Optional[bytes], deleted: bool):
            lease = int(key.rsplit(":", 1)[1], 16)
            if deleted:
                # deregistration must evict pooled sockets too: the next
                # request would otherwise burn its same-instance retry on a
                # connection to a gone worker — and drop the breaker's
                # accounting (a re-registered id starts with a clean slate)
                info = self.instances.pop(lease, None)
                if info is not None:
                    self._pool_drop((info.host, info.port))
                self.breaker.forget(lease)
            else:
                self.instances[lease] = EndpointInfo.from_bytes(value)
            if self.on_instances_changed:
                self.on_instances_changed()

        snapshot = await self.drt.store.watch_prefix(prefix, on_change)
        for key, value in snapshot:
            lease = int(key.rsplit(":", 1)[1], 16)
            self.instances[lease] = EndpointInfo.from_bytes(value)
        self._watching = True
        return self

    async def wait_for_instances(self, n: int = 1, timeout: float = 30.0) -> None:
        deadline = asyncio.get_event_loop().time() + timeout
        while len(self.instances) < n:
            if asyncio.get_event_loop().time() > deadline:
                raise TimeoutError(
                    f"{self.endpoint.path}: {len(self.instances)}/{n} instances")
            await asyncio.sleep(0.05)

    def instance_ids(self) -> List[int]:
        return sorted(self.instances)

    def _pick(self, mode: str, instance_id: Optional[int],
              exclude: Optional[set] = None) -> Tuple[int, EndpointInfo]:
        if not self.instances:
            raise EngineError(f"no live instances of {self.endpoint.path}", 503)
        if mode == "direct":
            if instance_id not in self.instances:
                raise EngineError(
                    f"instance {instance_id} of {self.endpoint.path} is gone",
                    503)
            return instance_id, self.instances[instance_id]
        ids = sorted(i for i in self.instances
                     if not exclude or i not in exclude)
        if not ids:
            raise EngineError(
                f"all live instances of {self.endpoint.path} unreachable", 503)
        # circuit breaker: skip instances currently ejected (open). If that
        # would veto everyone, filter() stands down — the breaker may not
        # manufacture a total outage the membership plane doesn't see.
        ids = self.breaker.filter(ids)
        if mode == "round_robin":
            iid = ids[next(self._rr) % len(ids)]
        else:
            iid = random.choice(ids)
        return iid, self.instances[iid]

    async def generate(self, request: Any, context: Optional[Context] = None,
                       mode: str = "random",
                       instance_id: Optional[int] = None,
                       parts: Optional[AsyncIterator[bytes]] = None,
                       exclude: Optional[set] = None,
                       resume: int = 0,
                       on_instance: Optional[Callable[[int], None]] = None
                       ) -> AsyncIterator[Any]:
        """Issue a request; yields response items (the remote stream).
        With ``parts`` set, streams the binary chunks after the request header
        (server handler receives a :class:`StreamingRequest`).

        ``exclude`` seeds the per-call failed set (instances a resume layer
        already declared dead); ``resume`` stamps the mid-stream-failover
        attempt ordinal on the envelope (``RESUME_KEY``) so a zombie context
        of the same id yields server-side; ``on_instance`` is called with
        the chosen instance id once the first exchange succeeds — the hook a
        resume layer uses to know WHO to blame when the stream later breaks."""
        ctx = context or Context()
        dl.check(ctx.deadline, f"rpc_dispatch:{self.endpoint.name}")
        # serialize BEFORE any socket exists: a non-serializable request
        # must not leak a freshly opened connection
        if isinstance(request, (bytes, bytearray)):
            base_control = {KIND_KEY: "request", CONTEXT_ID_KEY: ctx.id,
                            CTYPE_KEY: "bin"}
            req_payload = bytes(request)
        else:
            base_control = {KIND_KEY: "request", CONTEXT_ID_KEY: ctx.id}
            req_payload = json.dumps(request).encode()
        if ctx.deadline is not None:
            # the deadline rides the envelope next to context_id/trace so
            # every downstream hop can drop work nobody awaits anymore
            base_control[dl.DEADLINE_KEY] = ctx.deadline
        if getattr(ctx, "priority", "interactive") != "interactive":
            # non-default priority rides the envelope so worker-side
            # shedding/queue ordering can prefer interactive (absent =>
            # interactive, the protective default)
            base_control[PRIORITY_KEY] = ctx.priority
        if parts is not None:
            base_control[STREAMING_KEY] = True
        if resume:
            base_control[RESUME_KEY] = int(resume)
        # client span around the whole exchange; its context rides the wire
        # so the server's rpc span parents under it. No ambient span (bare
        # client) => the request id becomes the trace id, matching the
        # server-side fallback.
        from ..utils.tracing import current_span_var, get_tracer
        tracer = get_tracer()
        amb = current_span_var.get()
        call_span = tracer.start_span(
            f"call:{self.endpoint.name}",
            trace_id=None if amb is not None else ctx.id,
            context_id=ctx.id)
        if call_span is not None:
            base_control[TRACE_KEY] = call_span.context().to_wire()
        else:
            attach_trace(base_control)

        # a stop/kill issued while we wait for the first frame (mid-prefill)
        # must reach the server immediately: the stopper lives for the whole
        # exchange and always writes to the CURRENT connection
        live: Dict[str, Any] = {"writer": None}

        async def forward_stop():
            await ctx.stopped()
            # the connect/failover window may have no writer yet — or a
            # just-closed one about to be replaced. Keep trying against the
            # CURRENT writer until a send sticks (or the exchange itself
            # ends and this task is cancelled); a stop must not be lost to
            # a connection that died the same instant, nor abandoned while
            # connect/failover churns longer than any fixed window.
            while True:
                w = live["writer"]
                if w is not None and not w.is_closing():
                    try:
                        await write_frame(w, [{KIND_KEY: "stop"}, None])
                        return
                    # dynalint: ok(swallowed-exception) the exception IS
                    # the retried condition: writer died mid-send, loop
                    # retries against the failover successor writer
                    except Exception:
                        pass
                await asyncio.sleep(0.05)

        stopper = asyncio.create_task(forward_stop())

        # Failover: a worker that died a moment ago may still be in the
        # watched live set. It engages ONLY when the connect itself is
        # refused — then provably no byte reached the peer and a retry on
        # another instance cannot double-execute. Any failure after a
        # connection existed (even a write error: the transport may have
        # delivered the frame before erroring) surfaces, except the
        # same-instance stale-pool retry whose duplicate-context guard
        # de-dupes server-side. direct mode never fails over.
        failed: set = set(exclude or ())
        try:
            while True:
                iid, info = self._pick(mode, instance_id, failed)
                key = (info.host, info.port)

                def _fail(iid=iid, key=key):
                    failed.add(iid)
                    self.breaker.record_failure(iid)
                    self._pool_drop(key)

                # part-streaming requests can't replay their body on a
                # stale pooled connection, so they always open fresh
                pooled = None if parts is not None else self._pool_get(key)
                if pooled is not None:
                    reader, fr, writer = pooled
                else:
                    try:
                        await faults.fire("client.connect")
                        reader, writer = await dl.wait_for(
                            asyncio.open_connection(info.host, info.port),
                            ctx.deadline, f"rpc_connect:{info.endpoint}")
                    except OSError as e:
                        _fail()
                        if mode == "direct":
                            raise EngineError(
                                f"connect to instance {iid:x} at "
                                f"{info.host}:{info.port} failed: {e}",
                                503) from e
                        continue   # _pick raises 503 when none are left
                    fr = FrameReader(reader)
                live["writer"] = writer

                req_control = {**base_control, ENDPOINT_KEY: info.endpoint}
                # First exchange (request out, first frame back). Failures
                # here — before ANY response frame was consumed — get one
                # same-instance retry on a fresh connection: a pooled socket
                # the server closed while idle resends harmlessly, and a
                # server that died mid-request is de-duped by its
                # duplicate-context guard (409) if it is in fact alive.
                # If the retry's CONNECT is refused, the process is gone —
                # a dead process cannot double-execute, and no frame was
                # yielded to the caller — so re-dispatching to another
                # instance is provably safe, mirroring the connect-refused
                # failover above. (Churn soak failure class: without this,
                # every request whose first frame raced a worker death
                # surfaced as a 503 even though another worker could serve
                # it.) parts-streaming requests can't replay a partially
                # consumed body: no retry, no failover.
                attempts = 2 if parts is None else 1
                refused_mid_exchange = False
                for attempt in range(attempts):
                    try:
                        await write_frame(writer, [req_control, req_payload])
                        if parts is not None:
                            async for chunk in parts:
                                await write_frame(
                                    writer,
                                    [{KIND_KEY: "part", CTYPE_KEY: "bin"},
                                     bytes(chunk)])
                            await write_frame(writer,
                                              [{KIND_KEY: "end"}, None])
                        first = await dl.wait_for(
                            fr.read(), ctx.deadline,
                            f"rpc_first_frame:{info.endpoint}", slack=0.25)
                        self.breaker.record_success(iid)
                        break
                    except (ConnectionResetError, BrokenPipeError,
                            asyncio.IncompleteReadError) as e:
                        writer.close()
                        if attempt == attempts - 1:
                            self.breaker.record_failure(iid)
                            raise EngineError(
                                f"connection to {info.host}:{info.port} "
                                f"failed: {e}", 503) from e
                        try:
                            reader, writer = await dl.wait_for(
                                asyncio.open_connection(
                                    info.host, info.port),
                                ctx.deadline,
                                f"rpc_reconnect:{info.endpoint}")
                        except ConnectionRefusedError as e2:
                            # REFUSED specifically proves the process is
                            # gone (closed listening port) — other OSErrors
                            # (fd exhaustion, transient routing) are
                            # client-side and the worker may still be
                            # executing the delivered request, where a
                            # cross-instance re-dispatch could double-
                            # execute. Drop its pooled sockets and — unless
                            # the caller pinned this instance — fail over
                            # like a refused first connect.
                            _fail()
                            if mode == "direct":
                                raise EngineError(
                                    f"instance {iid:x} at {info.host}:"
                                    f"{info.port} unreachable: {e2}",
                                    503) from e2
                            log.debug("failover: instance %x died mid-"
                                      "exchange (reconnect refused), "
                                      "re-dispatching ctx %s", iid, ctx.id)
                            refused_mid_exchange = True
                            break
                        except OSError as e2:
                            _fail()
                            raise EngineError(
                                f"instance {iid:x} at {info.host}:"
                                f"{info.port} unreachable: {e2}",
                                503) from e2
                        fr = FrameReader(reader)
                        live["writer"] = writer
                if refused_mid_exchange:
                    continue
                if on_instance is not None:
                    on_instance(iid)
                break
        except BaseException:
            stopper.cancel()
            w = live["writer"]
            if w is not None:      # e.g. deadline expiry mid-exchange: the
                w.close()          # half-used socket must not leak/pool
            tracer.finish(call_span, status="error")
            raise

        clean = False
        try:
            try:
                try:
                    control, payload = unpack_two_part(first)
                except ValueError as e:
                    # broken protocol, not a broken transport: typed 502,
                    # and the instance takes the breaker hit
                    self.breaker.record_failure(iid)
                    raise EngineError(
                        f"instance {iid:x} sent a malformed frame: {e}",
                        502) from e
                if control.get(KIND_KEY) == "error":
                    raise error_from_control(control)
                # else: prologue
                while True:
                    # inter-frame timeout: a worker that stalls mid-stream
                    # (or dies without RST) becomes a clean 504, not a hang
                    try:
                        control, payload = unpack_two_part(await dl.wait_for(
                            fr.read(), ctx.deadline,
                            f"rpc_stream:{info.endpoint}", slack=0.25))
                    except (asyncio.IncompleteReadError,
                            ConnectionResetError) as e:
                        # worker died mid-stream: a typed 503, never a raw
                        # transport exception leaking to the frontend
                        self.breaker.record_failure(iid)
                        raise EngineError(
                            f"instance {iid:x} dropped the stream "
                            f"mid-response: {type(e).__name__}", 503) from e
                    except ValueError as e:
                        # malformed mid-stream frame: typed 502 + breaker
                        # hit, same policy as the server-side rx loops
                        self.breaker.record_failure(iid)
                        raise EngineError(
                            f"instance {iid:x} sent a malformed frame "
                            f"mid-response: {e}", 502) from e
                    kind = control.get(KIND_KEY)
                    if kind == "data":
                        if control.get(CTYPE_KEY) == "bin":
                            yield payload
                        else:
                            yield json.loads(payload.decode())
                    elif kind == "sentinel":
                        clean = True
                        return
                    elif kind == "error":
                        raise error_from_control(control)
            finally:
                stopper.cancel()
                try:
                    await stopper   # ensure no half-written stop frame races
                except asyncio.CancelledError:
                    if not stopper.cancelled():
                        raise   # OUR task was cancelled, not the stopper
                # dynalint: ok(swallowed-exception) reaping our own
                # cancelled stop-forwarder; its send errors were already
                # retried inside forward_stop until cancellation
                except Exception:
                    pass
        finally:
            tracer.finish(call_span, status="ok" if clean else "error")
            if clean:
                # full exchange completed: the connection sits at a frame
                # boundary and is safe to reuse for the next request
                self._pool_put(key, (reader, fr, writer))
            else:
                writer.close()
