"""OpenAI-compatible HTTP frontend on the standard library's asyncio.

Routes (the JAX package's aiohttp service, ``dynamo_tpu/llm/
http_service.py``): POST /v1/chat/completions, POST /v1/completions, GET
/v1/models, GET /health, GET /metrics (Prometheus), GET
/v1/traces[/{request_id}] (request span timelines; ``?format=chrome``
exports Perfetto-loadable trace-event JSON), GET /v1/router/decisions, GET
/v1/incidents[/{incident_id}] and GET /v1/flows.

HTTP/1.1 as aiohttp serves it: connections stay alive across requests until
the client sends ``Connection: close`` (or speaks HTTP/1.0 without
``keep-alive``) or closes; pipelined requests are answered in order. A
plain response carries ``Content-Length``; an SSE stream goes out with
``Transfer-Encoding: chunked``, one chunk per event. Request bodies may be
chunked. A client that closes its connection stops its request's
:class:`Context`, which the engine turns into a cancel; the close is seen
on the connection's reader without consuming the next request's bytes.

Every request passes the overload plane first (brownout level, tenant
quota, admission gate: ``utils/overload.py``), opens a root span whose
trace id is the request id (echoed as the ``x-request-id`` response
header), and feeds the HTTP registry and the process ``StageMetrics``
(TTFT, inter-token). ``/metrics`` renders both. Without a store
(``store=None``, the single-process CLI) the store-backed views are
local-only: ``/v1/flows`` folds this process's ledger and ``/v1/incidents``
answers 404, as in the JAX service.

Reference capability: lib/llm/src/http/service/{service_v2,openai,metrics,
discovery}.rs — the server, ModelManager, disconnect monitor, Prometheus.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import math
import os
import time
import urllib.parse
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from ..runtime import deadline as dl
from ..runtime.engine import AsyncEngine, Context, EngineError
from ..utils import overload, tracing
from ..utils.logging_ext import request_id_var
from ..utils.prometheus import Registry, render_states, stage_metrics
from .model_card import ModelDeploymentCard
from .protocols.openai import (
    ChatCompletionRequest,
    CompletionRequest,
    ProtocolError,
    SSE_DONE,
    aggregate_chat_chunks,
    aggregate_completion_chunks,
    sse_encode,
)

log = logging.getLogger("dynamo_tpu_torch.http_service")

_REASONS = {200: "OK", 201: "Created", 204: "No Content",
            400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 409: "Conflict",
            413: "Payload Too Large",
            429: "Too Many Requests", 500: "Internal Server Error",
            502: "Bad Gateway", 503: "Service Unavailable",
            504: "Gateway Timeout"}
MAX_BODY = 64 << 20
MAX_HEADER_LINES = 100
KEEPALIVE_TIMEOUT = 75.0       # idle seconds before a kept-alive close
_JSON = "application/json; charset=utf-8"
_TEXT = "text/plain; charset=utf-8"


@dataclass
class ServedModel:
    card: ModelDeploymentCard
    chat_engine: Optional[AsyncEngine] = None
    completion_engine: Optional[AsyncEngine] = None


class ModelManager:
    """Live registry of served models; safe to mutate while serving."""

    def __init__(self):
        self._models: Dict[str, ServedModel] = {}

    def add(self, model: ServedModel) -> None:
        self._models[model.card.name] = model

    def remove(self, name: str) -> None:
        self._models.pop(name, None)

    def get(self, name: str) -> Optional[ServedModel]:
        return self._models.get(name)

    def list(self):
        return list(self._models.values())


# ---------------------------------------------------------------------------
# HTTP/1.1 plumbing: requests, responses, connections
# ---------------------------------------------------------------------------
class _BadRequest(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


class _Headers(dict):
    """Request headers by lower-cased name."""

    def get(self, name: str, default: Optional[str] = None):
        return super().get(name.lower(), default)


class Request:
    """One parsed request, shaped like the parts of ``aiohttp.web.Request``
    the routes read: ``headers``, ``query``, ``match_info`` and a per-
    request state mapping (``req[key]``)."""

    def __init__(self, method: str, path: str, query: Dict[str, str],
                 headers: _Headers, body: bytes, keep_alive: bool):
        self.method = method
        self.path = path
        self.query = query
        self.headers = headers
        self.body = body
        self.keep_alive = keep_alive
        self.match_info: Dict[str, str] = {}
        self.ctx: Optional[Context] = None   # set once the serve has one
        self.disconnected = False
        self.committed = False               # a streamed head went out
        self._state: Dict[str, Any] = {}

    def __getitem__(self, key: str) -> Any:
        return self._state[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self._state[key] = value

    def get(self, key: str, default: Any = None) -> Any:
        return self._state.get(key, default)

    def json(self) -> Any:
        return json.loads(self.body)


class Response:
    """A complete (non-streamed) response."""

    def __init__(self, status: int, body: bytes, content_type: str,
                 headers: Optional[Dict[str, str]] = None):
        self.status = status
        self.body = body
        self.content_type = content_type
        self.headers = headers or {}


def json_response(obj: Any, status: int = 200,
                  headers: Optional[Dict[str, str]] = None) -> Response:
    return Response(status, json.dumps(obj).encode(), _JSON, headers)


def _head(status: int, headers: Dict[str, str], keep_alive: bool) -> bytes:
    lines = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Error')}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    lines.append("Connection: " + ("keep-alive" if keep_alive else "close"))
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


class StreamResponse:
    """An SSE response written as it is produced, one chunk per write
    (``Transfer-Encoding: chunked``), shaped like the parts of
    ``aiohttp.web.StreamResponse`` the stream route uses."""

    def __init__(self, writer: asyncio.StreamWriter, keep_alive: bool,
                 status: int = 200,
                 headers: Optional[Dict[str, str]] = None):
        self.status = status
        self.headers = dict(headers or {})
        self._writer = writer
        self._keep_alive = keep_alive

    async def prepare(self, req: Request) -> None:
        req.committed = True
        self._writer.write(_head(self.status, {
            **self.headers, "Transfer-Encoding": "chunked"},
            self._keep_alive))
        await self._writer.drain()

    async def write(self, data: bytes) -> None:
        if data:
            self._writer.write(b"%x\r\n%s\r\n" % (len(data), data))
            await self._writer.drain()

    async def write_eof(self) -> None:
        self._writer.write(b"0\r\n\r\n")
        await self._writer.drain()


class _ConnReader(asyncio.StreamReader):
    """The connection's reader, which reports the peer's close (EOF or a
    reset) as it arrives: the serve stops its request then, while bytes of
    a pipelined next request stay in the buffer for the next read."""

    on_close: Optional[Callable[[], None]] = None
    closed = False

    def _closed(self) -> None:
        if not self.closed:
            self.closed = True
            if self.on_close is not None:
                self.on_close()

    def feed_eof(self) -> None:
        super().feed_eof()
        self._closed()

    def set_exception(self, exc: BaseException) -> None:
        super().set_exception(exc)
        self._closed()


async def _read_line(reader: asyncio.StreamReader) -> bytes:
    try:
        return await reader.readuntil(b"\n")
    except asyncio.LimitOverrunError:
        raise _BadRequest(400, "header line too long")
    except asyncio.IncompleteReadError as e:
        if e.partial:
            raise ConnectionError("connection closed mid-line")
        return b""


async def _read_chunked(reader: asyncio.StreamReader,
                        max_body: int = MAX_BODY) -> bytes:
    """A ``Transfer-Encoding: chunked`` body, at most ``max_body`` bytes."""
    parts = []
    total = 0
    while True:
        line = (await _read_line(reader)).decode("latin-1").strip()
        if not line:
            raise _BadRequest(400, "truncated chunked body")
        try:
            size = int(line.split(";", 1)[0], 16)
        except ValueError:
            raise _BadRequest(400, f"malformed chunk size {line!r}")
        if size < 0:
            raise _BadRequest(400, f"malformed chunk size {line!r}")
        if size == 0:
            break
        total += size
        if total > max_body:
            raise _BadRequest(413, "request body too large")
        parts.append(await reader.readexactly(size))
        if await reader.readexactly(2) != b"\r\n":
            raise _BadRequest(400, "malformed chunk terminator")
    for _ in range(MAX_HEADER_LINES):          # trailers, then a blank line
        if (await _read_line(reader)) in (b"\r\n", b"\n"):
            return b"".join(parts)
    raise _BadRequest(400, "too many trailer lines")


async def _read_request(reader: asyncio.StreamReader,
                        writer: asyncio.StreamWriter,
                        max_body: int = MAX_BODY) -> Optional[Request]:
    """The next request on the connection, or None at a clean close."""
    line = b""
    while not line.strip():                    # skip stray CRLFs
        try:
            line = await asyncio.wait_for(_read_line(reader),
                                          KEEPALIVE_TIMEOUT)
        except asyncio.TimeoutError:
            return None
        if not line:
            return None
    parts = line.decode("latin-1").split()
    if len(parts) != 3 or not parts[2].startswith("HTTP/"):
        raise _BadRequest(400, f"malformed request line {line!r}")
    method, target, version = parts[0].upper(), parts[1], parts[2]
    headers = _Headers()
    for _ in range(MAX_HEADER_LINES):
        h = (await _read_line(reader)).decode("latin-1")
        if h in ("\r\n", "\n", ""):
            break
        name, sep, value = h.partition(":")
        if not sep:
            raise _BadRequest(400, f"malformed header {h.strip()!r}")
        headers[name.strip().lower()] = value.strip()
    else:
        raise _BadRequest(400, "too many headers")
    conn = headers.get("connection", "").lower()
    keep_alive = ("keep-alive" in conn if version == "HTTP/1.0"
                  else "close" not in conn)
    if headers.get("expect", "").lower() == "100-continue":
        writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
    if "chunked" in headers.get("transfer-encoding", "").lower():
        body = await _read_chunked(reader, max_body)
    else:
        try:
            length = int(headers.get("content-length", "0"))
        except ValueError:
            raise _BadRequest(400, "invalid Content-Length")
        if length < 0:
            raise _BadRequest(400, "negative Content-Length")
        if length > max_body:
            raise _BadRequest(413, "request body too large")
        body = await reader.readexactly(length) if length else b""
    split = urllib.parse.urlsplit(target)
    query: Dict[str, str] = {}
    for k, v in urllib.parse.parse_qsl(split.query, keep_blank_values=True):
        query.setdefault(k, v)                 # aiohttp's query.get: first
    return Request(method, urllib.parse.unquote(split.path), query, headers,
                   body, keep_alive)


# ---------------------------------------------------------------------------
# the server and the service
# ---------------------------------------------------------------------------
class HttpServer:
    """The HTTP/1.1 server under the port's HTTP surfaces: kept-alive
    connections, pipelined requests answered in order, chunked bodies,
    405 with ``Allow`` and 404 as aiohttp answers them. ``routes`` maps
    ``(method, pattern)`` to an ``async (Request) -> Response`` handler; a
    pattern's ``{name}`` segments land in ``req.match_info`` (a last
    ``{name:.+}`` takes the rest of the path). A handler in ``_streaming``
    also takes the connection's writer and may write the response itself
    (returning the :class:`StreamResponse` it wrote). A body over
    ``max_body`` bytes is answered 413."""

    def __init__(self, host: str = "0.0.0.0", port: int = 8080,
                 routes: Optional[Dict] = None, max_body: int = MAX_BODY):
        self.host = host
        self.port = port
        self.max_body = max_body
        self._routes: Dict = dict(routes or {})
        self._streaming: set = set()
        self._server: Optional[asyncio.base_events.Server] = None
        self._conns: set = set()

    async def start(self) -> int:
        """Listen; returns the bound port (``port=0`` picks a free one)."""
        loop = asyncio.get_running_loop()

        def factory():
            reader = _ConnReader(limit=1 << 16, loop=loop)
            return asyncio.StreamReaderProtocol(reader, self._handle,
                                                loop=loop)

        self._server = await loop.create_server(factory, self.host,
                                                self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self) -> None:
        server, self._server = self._server, None
        if server is not None:
            server.close()
        for task in list(self._conns):
            task.cancel()
        for task in list(self._conns):
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await task
        if server is not None:
            await server.wait_closed()

    async def run_forever(self) -> None:
        await self.start()
        while True:
            await asyncio.sleep(3600)

    # ------------------------------------------------------------------
    # connections
    # ------------------------------------------------------------------
    async def _handle(self, reader: _ConnReader,
                      writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        current: Dict[str, Request] = {}

        def on_close() -> None:
            req = current.get("req")
            if req is not None:
                req.disconnected = True
                if req.ctx is not None:
                    req.ctx.stop_generating()

        reader.on_close = on_close
        try:
            while True:
                try:
                    req = await _read_request(reader, writer,
                                              self.max_body)
                except _BadRequest as e:
                    await self._send(writer, _plain(e.code, str(e)), False)
                    return
                except (asyncio.IncompleteReadError, ConnectionError):
                    return
                if req is None:
                    return
                current["req"] = req
                if reader.closed:
                    req.disconnected = True
                try:
                    resp = await self._dispatch(req, writer)
                except ConnectionError:
                    raise
                except Exception:
                    log.exception("http handler failed")
                    if req.committed:       # mid-stream: drop the connection
                        return
                    resp = _plain(500, "500 Internal Server Error\n\n"
                                       "Server got itself in trouble")
                    req.keep_alive = False
                current.pop("req", None)
                if isinstance(resp, Response):
                    await self._send(writer, resp, req.keep_alive)
                if not req.keep_alive or req.disconnected:
                    return
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            self._conns.discard(task)
            writer.close()
            with contextlib.suppress(Exception):
                await writer.wait_closed()

    @staticmethod
    async def _send(writer: asyncio.StreamWriter, resp: Response,
                    keep_alive: bool) -> None:
        headers = {"Content-Type": resp.content_type,
                   "Content-Length": str(len(resp.body)), **resp.headers}
        writer.write(_head(resp.status, headers, keep_alive) + resp.body)
        await writer.drain()

    async def _dispatch(self, req: Request, writer: asyncio.StreamWriter):
        """Route one request. Returns the :class:`Response` to send, or the
        :class:`StreamResponse` the route already wrote."""
        allowed = []
        for (method, pattern), handler in self._routes.items():
            match = _match(pattern, req.path)
            if match is None:
                continue
            if method != req.method:
                allowed.append(method)
                continue
            req.match_info = match
            if handler in self._streaming:
                return await handler(req, writer)
            return await handler(req)
        if allowed:
            return _plain(405, "405: Method Not Allowed",
                          {"Allow": ",".join(allowed)})
        return _plain(404, "404: Not Found")


class HttpService(HttpServer):
    def __init__(self, manager: Optional[ModelManager] = None,
                 host: str = "0.0.0.0", port: int = 8080, store=None,
                 namespace: Optional[str] = None,
                 router_decisions=None, admission=None, tenants=None):
        super().__init__(host, port)
        self.manager = manager or ModelManager()
        # overload control (utils/overload.py): admission gate (DYN_ADMIT_*
        # knobs; inert when none are set) + this process's view of the
        # fleet brownout level
        self.admission = admission if admission is not None \
            else overload.AdmissionController.from_env()
        # per-tenant quotas (x-tenant header): DYN_TENANT_QUOTAS env table.
        # Inert when no tenant has a quota.
        self.tenants = tenants if tenants is not None \
            else overload.TenantAdmission.from_env()
        self.brownout = overload.BrownoutState()
        # fleet plane hooks (the JAX package's discovery-mode frontend
        # wires both): async () -> {model: status_dict} for GET /v1/models,
        # and () -> set of registry model names, whose 404s are labelled
        # and may park until a replica boots (queue-until-boot)
        self.fleet_status = None
        self.known_models = None
        # optional store client: /v1/traces fetches spans published by
        # other processes, /metrics and /v1/flows merge their stage dumps,
        # /v1/incidents reads capture beacons — scoped to ``namespace``.
        # The store-backed helpers arrive with the port's runtime; with
        # store=None (the single-process CLI) every view is local-only.
        self.store = store
        self.namespace = namespace
        # optional async callable ``(limit) -> list | None``: the KV
        # router's decision-audit ring; unset without a router
        self.router_decisions = router_decisions
        # set when this frontend also publishes its own stage dump: the
        # store scrape then skips that key
        self.stage_worker_id: Optional[int] = None
        # queue-until-boot (DYN_BOOT_WAIT): requests parked at ingress
        self._boot_parked = 0
        self.stage = stage_metrics()
        self.registry = Registry()
        m = self.registry
        self.m_requests = m.counter(
            "dyn_http_requests_total", "HTTP requests",
            ("model", "endpoint", "status", "tenant"))
        self.m_inflight = m.gauge(
            "dyn_http_inflight_requests", "In-flight requests", ("model",))
        self.m_duration = m.histogram(
            "dyn_http_request_duration_seconds", "Request duration",
            ("model", "endpoint"))
        self.m_ttft = m.histogram(
            "dyn_http_time_to_first_token_seconds", "Time to first streamed token",
            ("model",))
        self.m_tokens = m.counter(
            "dyn_http_output_tokens_total", "Completion tokens produced", ("model",))
        self._routes = {
            ("POST", "/v1/chat/completions"): self._chat,
            ("POST", "/v1/completions"): self._completions,
            ("GET", "/v1/models"): self._models,
            ("GET", "/v1/traces"): self._list_traces,
            ("GET", "/v1/traces/{request_id}"): self._get_trace,
            ("GET", "/v1/router/decisions"): self._router_decisions,
            ("GET", "/v1/incidents"): self._list_incidents,
            ("GET", "/v1/incidents/{incident_id}"): self._get_incident,
            ("GET", "/v1/flows"): self._list_flows,
            ("GET", "/health"): self._health,
            ("GET", "/metrics"): self._metrics,
        }
        self._streaming = {self._chat, self._completions}

    async def stop(self) -> None:
        pub = getattr(self, "_stage_pub_task", None)
        if pub is not None:          # discovery-mode stage publish loop
            pub.cancel()
        obs_h = getattr(self, "_obs_handle", None)
        if obs_h is not None:        # discovery-mode flight-recorder plane
            await obs_h.stop()
        await super().stop()


    # ------------------------------------------------------------------
    # observability routes
    # ------------------------------------------------------------------
    async def _health(self, _req: Request) -> Response:
        return json_response(
            {"status": "ok", "models": [m.card.name for m in self.manager.list()]}
        )

    async def _stage_states(self, what: str):
        """This process's stage dump, plus — with a store — the dumps other
        processes publish (component-labelled, merged across replicas)."""
        states = [("http", self.stage.registry.state_dump())]
        if self.store is not None:
            try:
                from .metrics_aggregator import fetch_stage_states

                states += await fetch_stage_states(
                    self.store, self.namespace,
                    exclude_worker=self.stage_worker_id)
            except Exception:
                log.exception("stage dump scrape for %s failed", what)
        return states

    async def _metrics(self, _req: Request) -> Response:
        text = self.registry.render()
        text += render_states(await self._stage_states("/metrics"))
        return Response(200, text.encode(), _TEXT)

    async def _list_traces(self, req: Request) -> Response:
        try:
            limit = int(req.query.get("limit", "50"))
        except ValueError:
            return _err(400, "limit must be an integer")
        ids = tracing.get_tracer().recent_trace_ids(limit)
        return json_response({"traces": ids})

    async def _get_trace(self, req: Request) -> Response:
        rid = req.match_info["request_id"]
        local = tracing.get_tracer().spans_for(rid)
        remote = []
        if self.store is not None:
            try:
                remote = await tracing.fetch_trace_spans(self.store, rid)
            except Exception:
                log.exception("trace fetch from store failed")
        spans = tracing.merge_spans(local, remote)
        if not spans:
            return _err(404, f"no trace recorded for request {rid!r}")
        if req.query.get("format") == "chrome":
            return json_response(tracing.to_chrome_trace(spans))
        return json_response(
            {"trace_id": rid, "spans": [s.to_dict() for s in spans]})

    async def _router_decisions(self, req: Request) -> Response:
        """The KV router's decision audit (per-request score breakdowns).
        404 when no router is configured."""
        if self.router_decisions is None:
            return _err(404, "no KV router configured on this frontend")
        try:
            limit = int(req.query.get("limit", "0"))
        except ValueError:
            return _err(400, "limit must be an integer")
        try:
            decisions = await self.router_decisions(limit)
        except Exception as e:  # noqa: BLE001 - surface, don't 500-trace
            log.exception("router decisions fetch failed")
            return _err(502, f"router decisions fetch failed: {e}")
        if decisions is None:
            return _err(404, "router not reachable (no live router "
                             "instance, or none discovered yet)")
        return json_response({"decisions": decisions,
                              "count": len(decisions)})

    async def _list_flows(self, req: Request) -> Response:
        """The byte-flow ledger: per-link totals folded from the stage
        dumps (this process's, plus the store's), hottest link first."""
        from ..obs.flows import flows_from_states

        try:
            limit = int(req.query.get("limit", "0"))
        except ValueError:
            return _err(400, "limit must be an integer")
        links = flows_from_states(await self._stage_states("/v1/flows"))
        if limit > 0:
            links = links[:limit]
        return json_response({"links": links, "count": len(links)})

    async def _list_incidents(self, _req: Request) -> Response:
        """Live incident beacons. 404 without a store."""
        if self.store is None:
            return _err(404, "no store configured on this frontend")
        from ..obs import incidents as _incidents

        ns = self.namespace or "dynamo"
        beacons = await _incidents.list_incidents(self.store, ns)
        return json_response({"incidents": beacons, "count": len(beacons)})

    async def _get_incident(self, req: Request) -> Response:
        """One assembled incident bundle. 404 without a store."""
        if self.store is None:
            return _err(404, "no store configured on this frontend")
        from ..obs import incidents as _incidents

        iid = req.match_info["incident_id"]
        ns = self.namespace or "dynamo"
        bundle = await _incidents.fetch_bundle(self.store, ns, iid)
        if bundle is None:
            return _err(404, f"no incident {iid!r} (expired or never "
                             f"captured)")
        return json_response(bundle)

    async def _models(self, _req: Request) -> Response:
        now = int(time.time())
        rows = {
            m.card.name: {"id": m.card.name, "object": "model",
                          "created": now, "owned_by": "dynamo_tpu_torch",
                          "context_length": m.card.context_length}
            for m in self.manager.list()
        }
        if self.fleet_status is not None:
            try:
                for name, st in (await self.fleet_status()).items():
                    row = rows.setdefault(name, {
                        "id": name, "object": "model", "created": now,
                        "owned_by": "dynamo_tpu_torch"})
                    row["state"] = st.get("state", "unknown")
                    for fld in ("replicas", "target", "component",
                                "chips", "priority", "wake_path",
                                "wake_seconds"):
                        if st.get(fld) is not None:
                            row[fld] = st[fld]
            except Exception:
                log.exception("fleet status fetch failed; serving bare "
                              "model list")
        return json_response({
            "object": "list",
            "data": sorted(rows.values(), key=lambda r: r["id"]),
        })

    # ------------------------------------------------------------------
    # inference routes
    # ------------------------------------------------------------------
    async def _chat(self, req: Request, writer: asyncio.StreamWriter):
        return await self._serve(req, writer, "chat")

    async def _completions(self, req: Request, writer: asyncio.StreamWriter):
        return await self._serve(req, writer, "completions")

    def _count(self, model: str, endpoint: str, status: str,
               tenant: str) -> None:
        """The one request-accounting path: the HTTP counter (tenant label
        bounded to the quota table + 'other') and the per-tenant stage
        counter the tenant burn is computed from."""
        tlabel = self.tenants.label(tenant)
        self.m_requests.inc(model, endpoint, status, tlabel)
        self.stage.tenant_requests.inc(tlabel, status)

    async def _serve(self, req: Request, writer: asyncio.StreamWriter,
                     endpoint: str):
        started = time.monotonic()
        # overload admission, decided from headers alone before the body is
        # parsed. Order: brownout (fleet state), tenant quota (isolation),
        # then the global admission gate.
        tenant = overload.DEFAULT_TENANT
        try:
            priority = overload.parse_priority(
                req.headers.get(overload.PRIORITY_HEADER))
            tenant = overload.parse_tenant(
                req.headers.get(overload.TENANT_HEADER))
        except ValueError as e:
            self._count("unknown", endpoint, "400", tenant)
            return _err(400, str(e))
        level = self.brownout.level
        tenant_held = False
        shed = overload.brownout_reject(priority, level)
        if shed is None:
            shed = self.tenants.try_admit(tenant, priority)
            tenant_held = shed is None
        if shed is None:
            shed = self.admission.try_admit(priority)
            if shed is not None and tenant_held:
                self.tenants.release(tenant)
                tenant_held = False
        if shed is not None:
            self._count("unknown", endpoint, str(shed.code), tenant)
            return _err_engine(shed)
        try:
            return await self._serve_admitted(req, writer, endpoint, started,
                                              priority, level, tenant)
        finally:
            self.admission.release()
            self.admission.release_kv(req.get("dyn_kv_cost", 0.0))
            self.tenants.release(tenant)

    async def _serve_admitted(self, req: Request,
                              writer: asyncio.StreamWriter, endpoint: str,
                              started: float, priority: str, level: int,
                              tenant: str):
        model_name = "unknown"
        try:
            body = req.json()
        except ValueError:             # includes UnicodeDecodeError
            self._count(model_name, endpoint, "400", tenant)
            return _err(400, "invalid JSON body")
        if not isinstance(body, dict):
            self._count(model_name, endpoint, "400", tenant)
            return _err(400, "request body must be a JSON object")
        try:
            if endpoint == "chat":
                oai_req = ChatCompletionRequest.from_dict(body)
            else:
                oai_req = CompletionRequest.from_dict(body)
        except ProtocolError as e:
            self._count("unknown", endpoint, "400", tenant)
            return _err(400, str(e))
        except Exception as e:
            # any other parse failure is still the client's malformed input
            self._count("unknown", endpoint, "400", tenant)
            return _err(400, f"malformed request: {e}")
        try:
            timeout = _request_timeout(req)
        except ValueError as e:
            self._count("unknown", endpoint, "400", tenant)
            return _err(400, str(e))
        # brownout degradation: cap max_tokens, drop speculative decoding
        cap = overload.max_tokens_cap(level)
        if cap is not None:
            oai_req.max_tokens = cap if oai_req.max_tokens is None \
                else min(oai_req.max_tokens, cap)
        if overload.disables_spec(level):
            oai_req.ext["no_spec"] = True
        # byte-honest admission, second gate: price the request's KV
        # working set against the in-flight budget (released in _serve)
        if self.admission.kv_enabled:
            kv_cost = self.admission.price_kv(
                overload.estimate_request_tokens(oai_req))
            shed = self.admission.try_reserve_kv(kv_cost, priority)
            if shed is not None:
                self._count("unknown", endpoint, str(shed.code), tenant)
                return _err_engine(shed)
            req["dyn_kv_cost"] = kv_cost
        model_name = oai_req.model
        engine = self._engine_for(model_name, endpoint)
        if engine is None:
            # label with a constant to keep metric cardinality bounded —
            # except for fleet-registered models, a bounded set whose 404s
            # are the planner's scale-from-zero wake signal
            known = self.known_models() if self.known_models else ()
            label = model_name if model_name in known else "unknown"
            if label != "unknown":
                t_park = time.monotonic()
                engine, shed = await self._queue_until_boot(
                    model_name, endpoint, timeout)
                if shed is not None:
                    self._count(label, endpoint, str(shed.code), tenant)
                    return _err_engine(shed)
                if engine is not None and timeout is not None:
                    timeout = max(timeout - (time.monotonic() - t_park),
                                  0.05)
            if engine is None:
                self._count(label, endpoint, "404", tenant)
                return _err(404, f"model {model_name!r} not found"
                            + (" (registered, no live replica — booting "
                               "or scaled to zero)"
                               if label != "unknown" else ""))

        # end-to-end deadline (x-request-timeout header, DYN_REQUEST_TIMEOUT
        # default) and priority ride the context
        ctx = Context(deadline=dl.from_timeout(timeout), priority=priority)
        req.ctx = ctx
        if req.disconnected:
            ctx.stop_generating()
        # every log line in this async call chain carries the request id
        request_id_var.set(ctx.id)
        # root span: the trace id IS the request id
        tracer = tracing.get_tracer()
        root = tracer.start_span(f"http:{endpoint}", trace_id=ctx.id,
                                 model=model_name)
        root_token = tracing.current_span_var.set(root.context()) \
            if root is not None else None
        self.m_inflight.inc(model_name)
        status = "200"
        try:
            if oai_req.stream:
                try:
                    resp = await self._stream(req, writer, engine, oai_req,
                                              ctx, model_name, started)
                except (ConnectionResetError, asyncio.CancelledError):
                    status = "499"   # client closed mid-stream
                    raise
                status = getattr(resp, "_dyn_error_status",
                                 str(resp.status))
                return resp
            chunks = []
            first = True
            try:
                async for ch in dl.guard_stream(
                        engine.generate(oai_req, ctx), ctx.deadline,
                        "http_aggregate", slack=0.5):
                    if "event" in ch:
                        continue  # annotations only meaningful when streaming
                    if "error" in ch:
                        status = "400"
                        return _err(400, ch["error"]["message"], ctx.id)
                    if first:
                        self.stage.ttft.observe(
                            model_name, value=time.monotonic() - started)
                        first = False
                    chunks.append(ch)
                    u = ch.get("usage")
                    if u:
                        self.m_tokens.inc(model_name,
                                          amount=u["completion_tokens"])
            except ProtocolError as e:
                status = "400"
                return _err(400, str(e), ctx.id)
            except EngineError as e:
                status = str(e.code)
                return _err_engine(e, ctx.id)
            agg = (aggregate_chat_chunks(chunks) if endpoint == "chat"
                   else aggregate_completion_chunks(chunks))
            return json_response(agg, headers={"x-request-id": ctx.id})
        finally:
            if root_token is not None:
                tracing.current_span_var.reset(root_token)
            tracer.finish(root, status="ok" if status == "200" else "error")
            self.m_inflight.dec(model_name)
            self._count(model_name, endpoint, status, tenant)
            self.m_duration.observe(model_name, endpoint,
                                    value=time.monotonic() - started)

    def _engine_for(self, model_name: str,
                    endpoint: str) -> Optional[AsyncEngine]:
        served = self.manager.get(model_name)
        if served is None:
            return None
        return (served.chat_engine if endpoint == "chat"
                else served.completion_engine)

    async def _queue_until_boot(self, model_name: str, endpoint: str,
                                timeout: Optional[float]):
        """Park a request for a fleet-registered model with no live
        replica until one boots: ``(engine, None)`` when a replica
        appeared, ``(None, shed)`` for a typed 503, and ``(None, None)``
        when the feature is off. Inert without the fleet hooks
        (``known_models``)."""
        from ..utils.knobs import env_float

        wait_s = env_float("DYN_BOOT_WAIT", 0.0, minimum=0.0)
        if wait_s <= 0:
            return None, None
        if timeout is not None:
            wait_s = min(wait_s, max(timeout * 0.8, 0.0))
        max_parked = int(env_float("DYN_BOOT_WAIT_QUEUE", 64, minimum=0))
        qub = self.stage.queue_until_boot
        if self._boot_parked >= max_parked:
            qub.inc(model_name, "overflow")
            return None, EngineError(
                f"model {model_name!r} is booting and the park queue is "
                f"full ({max_parked} requests already waiting)", 503,
                stage="ingress", reason="boot_queue_full",
                retry_after=2.0)
        qub.inc(model_name, "parked")
        self._boot_parked += 1
        try:
            deadline = time.monotonic() + wait_s
            while True:
                engine = self._engine_for(model_name, endpoint)
                if engine is not None:
                    qub.inc(model_name, "served")
                    return engine, None
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                await asyncio.sleep(min(0.25, remaining))
        finally:
            self._boot_parked -= 1
        qub.inc(model_name, "expired")
        return None, EngineError(
            f"model {model_name!r} has no live replica after waiting "
            f"{wait_s:.1f}s for boot (registered — scale-from-zero in "
            f"progress)", 503, stage="ingress", reason="booting",
            retry_after=2.0)

    async def _stream(self, req: Request, writer: asyncio.StreamWriter,
                      engine: AsyncEngine, oai_req, ctx: Context, model: str,
                      started: float):
        agen = engine.generate(oai_req, ctx)
        # pull the first item BEFORE committing the 200 so a failure before
        # any token (over-long prompt, bad template, deadline) is still a
        # clean error status
        try:
            first_item = await dl.wait_for(agen.__anext__(), ctx.deadline,
                                           "http_first_token", slack=0.5)
        except StopAsyncIteration:
            first_item = None
        except ProtocolError as e:
            return _err(400, str(e), ctx.id)
        except EngineError as e:
            return _err_engine(e, ctx.id)
        if isinstance(first_item, dict) and "error" in first_item:
            return _err(400, first_item["error"]["message"], ctx.id)

        resp = StreamResponse(
            writer, req.keep_alive, status=200,
            headers={"Content-Type": "text/event-stream",
                     "Cache-Control": "no-cache",
                     "x-request-id": ctx.id},
        )
        await resp.prepare(req)
        first = True
        last_chunk_at: Optional[float] = None
        stage = self.stage
        tracer = tracing.get_tracer()
        sse_span = tracer.start_span("sse.egress", model=model)
        chunks_out = 0

        async def chain():
            if first_item is not None:
                yield first_item
            async for item in agen:
                yield item

        try:
            async for ch in dl.guard_stream(chain(), ctx.deadline,
                                            "http_stream", slack=0.5):
                if "event" in ch:
                    payload = (f"event: {ch['event']}\n"
                               f"data: {json.dumps(ch['data'])}\n\n").encode()
                    await resp.write(payload)
                    continue
                if "error" in ch:
                    # in-band error after the 200 was committed: traces and
                    # metrics must not call this request ok
                    resp._dyn_error_status = "500"
                    await resp.write(sse_encode(json.dumps(ch)))
                    continue
                now = time.monotonic()
                if first:
                    ttft = now - started
                    self.m_ttft.observe(model, value=ttft)
                    stage.ttft.observe(model, value=ttft)
                    first = False
                elif last_chunk_at is not None:
                    stage.inter_token.observe(model,
                                              value=now - last_chunk_at)
                last_chunk_at = now
                chunks_out += 1
                u = ch.get("usage")
                if u:
                    self.m_tokens.inc(model, amount=u["completion_tokens"])
                await resp.write(sse_encode(json.dumps(ch)))
            await resp.write(sse_encode(SSE_DONE))
        except (ConnectionResetError, asyncio.CancelledError):
            # client went away: propagate cancellation into the engine; 499
            # (client closed request) so aborted streams never read as 200s
            resp._dyn_error_status = "499"
            ctx.stop_generating()
            raise
        except ProtocolError as e:
            resp._dyn_error_status = "400"
            await resp.write(sse_encode(json.dumps({"error": {
                "message": str(e), "type": "invalid_request_error"}})))
            await resp.write(sse_encode(SSE_DONE))
        except EngineError as e:
            resp._dyn_error_status = str(e.code)
            await resp.write(sse_encode(json.dumps({"error": {
                "message": str(e), "type": "engine_error", "code": e.code}})))
            await resp.write(sse_encode(SSE_DONE))
        finally:
            if req.disconnected:
                resp._dyn_error_status = "499"
            if sse_span is not None:
                sse_span.attrs["chunks"] = chunks_out
            tracer.finish(sse_span,
                          status="ok" if getattr(resp, "_dyn_error_status",
                                                 "200") == "200" else "error")
            ctx.stop_generating()
        await resp.write_eof()
        return resp


def _match(pattern: str, path: str) -> Optional[Dict[str, str]]:
    """aiohttp's route match for a pattern with ``{name}`` segments (one
    non-empty path segment each) and a last ``{name:.+}`` (the non-empty
    rest of the path): the captured values, or None."""
    if "{" not in pattern:
        return {} if pattern == path else None
    want, got = pattern.split("/"), path.split("/")
    if want[-1].endswith(":.+}") and len(got) >= len(want):
        rest = "/".join(got[len(want) - 1:])
        if not rest:
            return None
        head = _match("/".join(want[:-1]), "/".join(got[:len(want) - 1]))
        if head is None:
            return None
        head[want[-1][1:-4]] = rest
        return head
    if len(want) != len(got):
        return None
    out: Dict[str, str] = {}
    for w, g in zip(want, got):
        if w.startswith("{") and w.endswith("}"):
            if not g:
                return None
            out[w[1:-1]] = g
        elif w != g:
            return None
    return out


def _request_timeout(req: Request) -> Optional[float]:
    """Per-request deadline budget in seconds: the ``x-request-timeout``
    header when present, else the ``DYN_REQUEST_TIMEOUT`` env default, else
    None (no deadline). A malformed HEADER raises ValueError (the client's
    fault — 400); a malformed env default is logged and ignored."""
    raw = req.headers.get("x-request-timeout")
    if raw:
        try:
            t = float(raw)
        except ValueError:
            raise ValueError(f"x-request-timeout: {raw!r} is not a number")
        if not t > 0:
            raise ValueError(f"x-request-timeout must be > 0, got {t}")
        return t
    env = os.environ.get("DYN_REQUEST_TIMEOUT")
    if not env:
        return None
    try:
        t = float(env)
    except ValueError:
        log.warning("ignoring malformed DYN_REQUEST_TIMEOUT=%r", env)
        return None
    return t if t > 0 else None


def _plain(code: int, text: str,
           headers: Optional[Dict[str, str]] = None) -> Response:
    """A text/plain answer for requests no route handles (aiohttp's
    404/405 shape) and for malformed HTTP."""
    return Response(code, text.encode(), _TEXT, headers)


_ERR_TYPES = {400: "invalid_request_error", 404: "not_found_error",
              429: "overloaded_error", 502: "bad_gateway_error",
              503: "service_unavailable_error", 504: "timeout_error"}

# typed-error fallbacks for EngineErrors without stage/reason: every
# 429/503/504 body names a stage and reason even when the thrower didn't
_FALLBACK_STAGE = {429: "admission", 502: "router", 503: "dispatch"}
_FALLBACK_REASON = {429: "overload", 503: "no_capacity", 504: "deadline"}


def _err(code: int, message: str, request_id: Optional[str] = None, *,
         stage: Optional[str] = None, reason: Optional[str] = None,
         retry_after: Optional[float] = None) -> Response:
    """The ONE error-body shape: ``{"error": {message, type, code, stage?,
    reason?, retry_after?}}``. Overload (429) and unavailability (503)
    responses always carry ``Retry-After``; errors for requests that got
    far enough to have an id carry ``x-request-id`` too."""
    err: Dict[str, Any] = {"message": message,
                           "type": _ERR_TYPES.get(code, "internal_error"),
                           "code": code}
    if stage is not None:
        err["stage"] = stage
    if reason is not None:
        err["reason"] = reason
    headers: Dict[str, str] = {}
    if request_id:
        headers["x-request-id"] = request_id
    if retry_after is None and code in (429, 503):
        retry_after = 1.0
    if retry_after is not None:
        err["retry_after"] = round(float(retry_after), 3)
        headers["Retry-After"] = str(max(1, math.ceil(retry_after)))
    return json_response({"error": err}, status=code, headers=headers)


def _err_engine(e: Exception,
                request_id: Optional[str] = None) -> Response:
    """Typed EngineError -> the uniform error response: its stage/reason/
    retry_after land in the body, with per-code fallbacks."""
    code = getattr(e, "code", 500)
    return _err(code, str(e), request_id,
                stage=getattr(e, "stage", None) or _FALLBACK_STAGE.get(code),
                reason=(getattr(e, "reason", None)
                        or _FALLBACK_REASON.get(code)),
                retry_after=getattr(e, "retry_after", None))
