"""OpenAI-compatible protocol types: chat completions + completions, streaming
deltas, and SSE aggregation back into full responses.

Plain dataclasses + dict (de)serialization — the wire format is JSON and the
frontend is asyncio, so pydantic-style machinery buys nothing here.

Reference capability: lib/llm/src/protocols/openai/* (chat_completions.rs,
completions.rs, delta.rs, aggregator.rs) and the ``nvext`` extension field
(annotations / use_raw_prompt), kept here as ``ext``.
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .common import FinishReason


class ProtocolError(ValueError):
    """Malformed client request (maps to HTTP 400)."""


# ---------------------------------------------------------------------------
# Requests
# ---------------------------------------------------------------------------

@dataclass
class ChatCompletionRequest:
    model: str
    messages: List[Dict[str, Any]]
    stream: bool = False
    max_tokens: Optional[int] = None          # also accepts max_completion_tokens
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None               # extension (vLLM-compatible)
    n: int = 1
    stop: List[str] = field(default_factory=list)
    frequency_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
    seed: Optional[int] = None
    logprobs: bool = False
    top_logprobs: Optional[int] = None
    min_tokens: Optional[int] = None          # extension
    ignore_eos: bool = False                  # extension
    tools: Optional[List[Dict[str, Any]]] = None
    tool_choice: Any = None                   # none|auto|required|{function:...}
    ext: Dict[str, Any] = field(default_factory=dict)  # our nvext equivalent
    raw: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ChatCompletionRequest":
        if not isinstance(d.get("model"), str):
            raise ProtocolError("'model' must be a string")
        msgs = d.get("messages")
        if not isinstance(msgs, list) or not msgs:
            raise ProtocolError("'messages' must be a non-empty list")
        for m in msgs:
            if not isinstance(m, dict) or "role" not in m:
                raise ProtocolError("each message needs a 'role'")
        stop = d.get("stop") or []
        if isinstance(stop, str):
            stop = [stop]
        from ..tools import (  # deferred: avoid import cycle
            normalize_tool_choice,
            normalize_tools,
        )

        tools = normalize_tools(d.get("tools"))
        # validate at parse time so a bad tool_choice is a clean 400, not a
        # mid-stream error after the SSE response has committed
        normalize_tool_choice(d.get("tool_choice"), tools)
        return cls(
            model=d["model"],
            messages=msgs,
            stream=bool(d.get("stream", False)),
            max_tokens=d.get("max_tokens", d.get("max_completion_tokens")),
            temperature=d.get("temperature"),
            top_p=d.get("top_p"),
            top_k=d.get("top_k"),
            n=int(d.get("n", 1)),
            stop=list(stop),
            frequency_penalty=d.get("frequency_penalty"),
            presence_penalty=d.get("presence_penalty"),
            seed=d.get("seed"),
            logprobs=bool(d.get("logprobs", False)),
            top_logprobs=d.get("top_logprobs"),
            min_tokens=d.get("min_tokens"),
            ignore_eos=bool(d.get("ignore_eos", False)),
            tools=tools,
            tool_choice=d.get("tool_choice"),
            ext=dict(d.get("ext", d.get("nvext", {}) or {})),
            raw=d,
        )


@dataclass
class CompletionRequest:
    model: str
    prompt: Any  # str | List[str] | List[int]
    stream: bool = False
    max_tokens: Optional[int] = None
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    n: int = 1
    stop: List[str] = field(default_factory=list)
    echo: bool = False
    seed: Optional[int] = None
    logprobs: Optional[int] = None
    min_tokens: Optional[int] = None
    ignore_eos: bool = False
    frequency_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
    ext: Dict[str, Any] = field(default_factory=dict)
    raw: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CompletionRequest":
        if not isinstance(d.get("model"), str):
            raise ProtocolError("'model' must be a string")
        if "prompt" not in d:
            raise ProtocolError("'prompt' is required")
        stop = d.get("stop") or []
        if isinstance(stop, str):
            stop = [stop]
        return cls(
            model=d["model"],
            prompt=d["prompt"],
            stream=bool(d.get("stream", False)),
            max_tokens=d.get("max_tokens"),
            temperature=d.get("temperature"),
            top_p=d.get("top_p"),
            top_k=d.get("top_k"),
            n=int(d.get("n", 1)),
            stop=list(stop),
            echo=bool(d.get("echo", False)),
            seed=d.get("seed"),
            logprobs=d.get("logprobs"),
            min_tokens=d.get("min_tokens"),
            ignore_eos=bool(d.get("ignore_eos", False)),
            frequency_penalty=d.get("frequency_penalty"),
            presence_penalty=d.get("presence_penalty"),
            ext=dict(d.get("ext", d.get("nvext", {}) or {})),
            raw=d,
        )


# ---------------------------------------------------------------------------
# Streaming delta generators
# ---------------------------------------------------------------------------

def _now() -> int:
    return int(time.time())


class ChatDeltaGenerator:
    """Turns backend text deltas into ``chat.completion.chunk`` dicts."""

    def __init__(self, model: str, request_id: Optional[str] = None):
        self.id = request_id or f"chatcmpl-{uuid.uuid4().hex[:24]}"
        self.model = model
        self.created = _now()
        self._sent_role: set = set()

    def _chunk(self, delta: Dict[str, Any], index: int,
               finish_reason: Optional[str] = None,
               usage: Optional[Dict[str, int]] = None) -> Dict[str, Any]:
        out = {
            "id": self.id,
            "object": "chat.completion.chunk",
            "created": self.created,
            "model": self.model,
            "choices": [
                {"index": index, "delta": delta, "finish_reason": finish_reason}
            ],
        }
        if usage is not None:
            out["usage"] = usage
        return out

    def role_chunk(self, index: int = 0) -> Dict[str, Any]:
        self._sent_role.add(index)
        return self._chunk({"role": "assistant", "content": ""}, index)

    def text_chunk(self, text: str, index: int = 0) -> Dict[str, Any]:
        delta: Dict[str, Any] = {"content": text}
        if index not in self._sent_role:
            self._sent_role.add(index)
            delta["role"] = "assistant"
        return self._chunk(delta, index)

    def tool_calls_chunk(self, calls: List[Dict[str, Any]],
                         index: int = 0) -> Dict[str, Any]:
        """One delta carrying complete tool calls (arguments are not split
        across chunks: the matcher only fires on the finished message)."""
        delta: Dict[str, Any] = {
            "tool_calls": [{**c, "index": i} for i, c in enumerate(calls)],
        }
        if index not in self._sent_role:
            self._sent_role.add(index)
            delta["role"] = "assistant"
        return self._chunk(delta, index)

    def finish_chunk(self, finish_reason: FinishReason, index: int = 0,
                     usage: Optional[Dict[str, int]] = None,
                     finish_override: Optional[str] = None) -> Dict[str, Any]:
        return self._chunk({}, index,
                           finish_override or finish_reason.to_openai(), usage)


class CompletionDeltaGenerator:
    """Turns backend text deltas into ``text_completion`` chunk dicts."""

    def __init__(self, model: str, request_id: Optional[str] = None):
        self.id = request_id or f"cmpl-{uuid.uuid4().hex[:24]}"
        self.model = model
        self.created = _now()

    def text_chunk(self, text: str, index: int = 0,
                   finish_reason: Optional[str] = None,
                   logprobs: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        return {
            "id": self.id,
            "object": "text_completion",
            "created": self.created,
            "model": self.model,
            "choices": [
                {
                    "index": index,
                    "text": text,
                    "logprobs": logprobs,
                    "finish_reason": finish_reason,
                }
            ],
        }

    def finish_chunk(self, finish_reason: FinishReason, index: int = 0) -> Dict[str, Any]:
        return self.text_chunk("", index, finish_reason.to_openai())


# ---------------------------------------------------------------------------
# Aggregators (stream of chunks -> one full response)
# ---------------------------------------------------------------------------

def usage_dict(prompt_tokens: int, completion_tokens: int) -> Dict[str, int]:
    return {
        "prompt_tokens": prompt_tokens,
        "completion_tokens": completion_tokens,
        "total_tokens": prompt_tokens + completion_tokens,
    }


def aggregate_chat_chunks(chunks: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold chat.completion.chunk dicts into a full chat.completion response."""
    if not chunks:
        raise ProtocolError("empty stream")
    by_index: Dict[int, Dict[str, Any]] = {}
    usage = None
    for ch in chunks:
        if ch.get("usage"):
            usage = ch["usage"]
        for c in ch.get("choices", []):
            i = c["index"]
            acc = by_index.setdefault(
                i, {"index": i, "message": {"role": "assistant", "content": ""},
                    "finish_reason": None}
            )
            d = c.get("delta", {})
            if d.get("content"):
                acc["message"]["content"] += d["content"]
            for tc in d.get("tool_calls") or []:
                calls = acc["message"].setdefault("tool_calls", [])
                j = tc.get("index", len(calls))
                while len(calls) <= j:
                    calls.append({"id": None, "type": "function",
                                  "function": {"name": "", "arguments": ""}})
                slot = calls[j]
                if tc.get("id"):
                    slot["id"] = tc["id"]
                if tc.get("type"):
                    slot["type"] = tc["type"]
                fn = tc.get("function") or {}
                if fn.get("name"):
                    slot["function"]["name"] = fn["name"]
                if fn.get("arguments"):
                    slot["function"]["arguments"] += fn["arguments"]
            lp = c.get("logprobs")
            if lp and lp.get("content"):
                acc.setdefault("logprobs", {"content": []})["content"] \
                    .extend(lp["content"])
            if c.get("finish_reason"):
                acc["finish_reason"] = c["finish_reason"]
    first = chunks[0]
    out = {
        "id": first["id"],
        "object": "chat.completion",
        "created": first["created"],
        "model": first["model"],
        "choices": [by_index[i] for i in sorted(by_index)],
    }
    if usage:
        out["usage"] = usage
    return out


def aggregate_completion_chunks(chunks: List[Dict[str, Any]]) -> Dict[str, Any]:
    if not chunks:
        raise ProtocolError("empty stream")
    by_index: Dict[int, Dict[str, Any]] = {}
    usage = None
    for ch in chunks:
        if ch.get("usage"):
            usage = ch["usage"]
        for c in ch.get("choices", []):
            i = c["index"]
            acc = by_index.setdefault(
                i, {"index": i, "text": "", "logprobs": None, "finish_reason": None}
            )
            acc["text"] += c.get("text") or ""
            lp = c.get("logprobs")
            if lp and lp.get("tokens"):
                dst = acc["logprobs"] or {"tokens": [], "token_logprobs": [],
                                          "top_logprobs": None,
                                          "text_offset": []}
                dst["tokens"].extend(lp["tokens"])
                dst["token_logprobs"].extend(lp["token_logprobs"])
                acc["logprobs"] = dst
            if c.get("finish_reason"):
                acc["finish_reason"] = c["finish_reason"]
    first = chunks[0]
    out = {
        "id": first["id"],
        "object": "text_completion",
        "created": first["created"],
        "model": first["model"],
        "choices": [by_index[i] for i in sorted(by_index)],
    }
    if usage:
        out["usage"] = usage
    return out


# ---------------------------------------------------------------------------
# SSE codec
# ---------------------------------------------------------------------------

SSE_DONE = "[DONE]"


def sse_encode(data: str) -> bytes:
    return f"data: {data}\n\n".encode()
