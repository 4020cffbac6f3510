"""OpenAI-compatible HTTP frontend on the standard library's asyncio.

Routes: POST /v1/chat/completions, POST /v1/completions (non-stream, and SSE
streaming ending in ``data: [DONE]``), GET /v1/models, GET /health. Every
response closes its connection, so a streamed body needs no chunked framing.
A client that disconnects stops its request's :class:`Context`, which the
engine turns into a cancel. Malformed requests get an OpenAI-style error body
with status 400.

Admission control, metrics, traces and incidents are not ported yet.

Reference capability: lib/llm/src/http/service/{service_v2,openai}.rs — the
server, ModelManager and disconnect monitor.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from ..runtime.engine import AsyncEngine, Context, EngineError
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

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 413: "Payload Too Large",
            500: "Internal Server Error", 503: "Service Unavailable"}
_ERR_TYPES = {400: "invalid_request_error", 404: "not_found_error",
              503: "service_unavailable_error"}
MAX_BODY = 64 << 20
MAX_HEADER_LINES = 100


@dataclass
class ServedModel:
    card: ModelDeploymentCard
    chat_engine: Optional[AsyncEngine] = None
    completion_engine: Optional[AsyncEngine] = None


class ModelManager:
    """Registry of served models by name."""

    def __init__(self):
        self._models: Dict[str, ServedModel] = {}

    def add(self, model: ServedModel) -> None:
        self._models[model.card.name] = model

    def get(self, name: str) -> Optional[ServedModel]:
        return self._models.get(name)

    def list(self):
        return list(self._models.values())


class _BadRequest(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


def _error_body(code: int, message: str) -> Dict[str, Any]:
    return {"error": {"message": message,
                      "type": _ERR_TYPES.get(code, "internal_error"),
                      "code": code}}


class HttpService:
    def __init__(self, manager: Optional[ModelManager] = None,
                 host: str = "0.0.0.0", port: int = 8080):
        self.manager = manager or ModelManager()
        self.host = host
        self.port = port
        self._server: Optional[asyncio.base_events.Server] = None
        self._conns: set = set()

    async def start(self) -> int:
        """Listen; returns the bound port (``port=0`` picks a free one)."""
        self._server = await asyncio.start_server(self._handle, self.host,
                                                  self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        for task in list(self._conns):
            task.cancel()
        for task in list(self._conns):
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await task

    # ------------------------------------------------------------------
    # HTTP/1.1 plumbing
    # ------------------------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            try:
                method, path, body = await self._read_request(reader)
            except _BadRequest as e:
                await self._send_json(writer, e.code,
                                      _error_body(e.code, str(e)))
                return
            except (asyncio.IncompleteReadError, ConnectionError):
                return
            await self._route(method, path, body, reader, writer)
        except (ConnectionError, asyncio.CancelledError):
            pass
        except Exception:
            log.exception("http handler failed")
            with contextlib.suppress(Exception):
                await self._send_json(writer, 500,
                                      _error_body(500, "internal error"))
        finally:
            self._conns.discard(task)
            writer.close()
            with contextlib.suppress(Exception):
                await writer.wait_closed()

    async def _read_request(self, reader: asyncio.StreamReader
                            ) -> Tuple[str, str, bytes]:
        line = (await reader.readline()).decode("latin-1").strip()
        parts = line.split()
        if len(parts) != 3 or not parts[2].startswith("HTTP/"):
            raise _BadRequest(400, f"malformed request line {line!r}")
        method, target = parts[0].upper(), parts[1]
        headers: Dict[str, str] = {}
        for _ in range(MAX_HEADER_LINES):
            h = (await reader.readline()).decode("latin-1")
            if h in ("\r\n", "\n", ""):
                break
            name, sep, value = h.partition(":")
            if not sep:
                raise _BadRequest(400, f"malformed header {h.strip()!r}")
            headers[name.strip().lower()] = value.strip()
        else:
            raise _BadRequest(400, "too many headers")
        if "chunked" in headers.get("transfer-encoding", "").lower():
            raise _BadRequest(400, "chunked request bodies are not supported")
        try:
            length = int(headers.get("content-length", "0"))
        except ValueError:
            raise _BadRequest(400, "invalid Content-Length")
        if length < 0 or length > MAX_BODY:
            raise _BadRequest(413 if length > 0 else 400,
                              "request body too large or negative")
        body = await reader.readexactly(length) if length else b""
        return method, target.split("?", 1)[0], body

    async def _send(self, writer: asyncio.StreamWriter, code: int,
                    body: bytes, content_type: str) -> None:
        head = (f"HTTP/1.1 {code} {_REASONS.get(code, 'Error')}\r\n"
                f"Content-Type: {content_type}\r\n"
                f"Content-Length: {len(body)}\r\n"
                f"Connection: close\r\n\r\n").encode()
        writer.write(head + body)
        await writer.drain()

    async def _send_json(self, writer: asyncio.StreamWriter, code: int,
                         obj: Any) -> None:
        await self._send(writer, code, json.dumps(obj).encode(),
                         "application/json")

    # ------------------------------------------------------------------
    # routes
    # ------------------------------------------------------------------
    async def _route(self, method: str, path: str, body: bytes,
                     reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        routes = {"/health": ("GET", None), "/v1/models": ("GET", None),
                  "/v1/completions": ("POST", "completions"),
                  "/v1/chat/completions": ("POST", "chat")}
        if path not in routes:
            await self._send_json(writer, 404,
                                  _error_body(404, f"no route {path}"))
            return
        want, endpoint = routes[path]
        if method != want:
            await self._send_json(writer, 405, _error_body(
                405, f"{method} not allowed on {path}"))
            return
        if path == "/health":
            await self._send_json(writer, 200, {
                "status": "ok",
                "models": [m.card.name for m in self.manager.list()]})
        elif path == "/v1/models":
            now = int(time.time())
            await self._send_json(writer, 200, {"object": "list", "data": [
                {"id": m.card.name, "object": "model", "created": now,
                 "owned_by": "dynamo_tpu_torch",
                 "context_length": m.card.context_length}
                for m in sorted(self.manager.list(),
                                key=lambda m: m.card.name)]})
        else:
            await self._serve(endpoint, body, reader, writer)

    async def _serve(self, endpoint: str, body: bytes,
                     reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        try:
            data = json.loads(body)
        except (ValueError, UnicodeDecodeError):
            await self._send_json(writer, 400,
                                  _error_body(400, "invalid JSON body"))
            return
        if not isinstance(data, dict):
            await self._send_json(writer, 400, _error_body(
                400, "request body must be a JSON object"))
            return
        try:
            req = (ChatCompletionRequest.from_dict(data) if endpoint == "chat"
                   else CompletionRequest.from_dict(data))
        except ProtocolError as e:
            await self._send_json(writer, 400, _error_body(400, str(e)))
            return
        except (TypeError, ValueError) as e:
            await self._send_json(writer, 400,
                                  _error_body(400, f"malformed request: {e}"))
            return
        served = self.manager.get(req.model)
        engine = None if served is None else (
            served.chat_engine if endpoint == "chat"
            else served.completion_engine)
        if engine is None:
            await self._send_json(writer, 404, _error_body(
                404, f"model {req.model!r} not found"))
            return
        ctx = Context()
        # a client that goes away stops the request: the only bytes a
        # client sends after its body are none, so EOF means disconnect
        watch = asyncio.ensure_future(self._watch_disconnect(reader, ctx))
        try:
            if req.stream:
                await self._stream(engine, req, ctx, writer)
            else:
                await self._aggregate(endpoint, engine, req, ctx, writer)
        finally:
            watch.cancel()
            ctx.stop_generating()

    @staticmethod
    async def _watch_disconnect(reader: asyncio.StreamReader,
                                ctx: Context) -> None:
        with contextlib.suppress(ConnectionError):
            await reader.read(1)
        ctx.stop_generating()

    async def _aggregate(self, endpoint: str, engine: AsyncEngine, req,
                         ctx: Context, writer: asyncio.StreamWriter) -> None:
        chunks = []
        try:
            async with contextlib.aclosing(engine.generate(req, ctx)) as agen:
                async for ch in agen:
                    if "event" in ch:
                        continue   # annotations only matter when streaming
                    if "error" in ch:
                        await self._send_json(writer, 400, _error_body(
                            400, ch["error"]["message"]))
                        return
                    chunks.append(ch)
        except ProtocolError as e:
            await self._send_json(writer, 400, _error_body(400, str(e)))
            return
        except EngineError as e:
            await self._send_json(writer, e.code, _error_body(e.code, str(e)))
            return
        if not chunks:
            await self._send_json(writer, 500,
                                  _error_body(500, "engine produced nothing"))
            return
        agg = (aggregate_chat_chunks(chunks) if endpoint == "chat"
               else aggregate_completion_chunks(chunks))
        await self._send_json(writer, 200, agg)

    async def _stream(self, engine: AsyncEngine, req, ctx: Context,
                      writer: asyncio.StreamWriter) -> None:
        async with contextlib.aclosing(engine.generate(req, ctx)) as agen:
            # pull the first item BEFORE committing the 200 so a failure
            # before any token (over-long prompt, bad template) is still a
            # clean error status
            try:
                first = await agen.__anext__()
            except StopAsyncIteration:
                first = None
            except ProtocolError as e:
                await self._send_json(writer, 400, _error_body(400, str(e)))
                return
            except EngineError as e:
                await self._send_json(writer, e.code,
                                      _error_body(e.code, str(e)))
                return
            if isinstance(first, dict) and "error" in first:
                await self._send_json(writer, 400, _error_body(
                    400, first["error"]["message"]))
                return
            writer.write(b"HTTP/1.1 200 OK\r\n"
                         b"Content-Type: text/event-stream\r\n"
                         b"Cache-Control: no-cache\r\n"
                         b"Connection: close\r\n\r\n")

            async def emit(ch: Dict[str, Any]) -> None:
                if "event" in ch:
                    writer.write(f"event: {ch['event']}\ndata: "
                                 f"{json.dumps(ch['data'])}\n\n".encode())
                else:
                    writer.write(sse_encode(json.dumps(ch)))
                await writer.drain()

            try:
                if first is not None:
                    await emit(first)
                async for ch in agen:
                    await emit(ch)
            except (ProtocolError, EngineError) as e:
                # the 200 is committed: report in-band, then end the stream
                err = {"message": str(e),
                       "type": ("invalid_request_error"
                                if isinstance(e, ProtocolError)
                                else "engine_error"),
                       "code": getattr(e, "code", 400)}
                writer.write(sse_encode(json.dumps({"error": err})))
            writer.write(sse_encode(SSE_DONE))
            await writer.drain()
