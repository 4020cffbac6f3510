"""Pipeline assembly: compose preprocessor + backend + core engine into
OpenAI-level engines that consume request objects and stream chunk dicts.

This is the local (in-process) analogue of the reference's pipeline graph
ServiceFrontend → OpenAIPreprocessor → Backend → ServiceBackend(engine)
(reference: launch/dynamo-run/src/input/http.rs:86, lib/runtime/src/pipeline.rs).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
from typing import Any, AsyncIterator, Dict, List, Optional

from ..runtime.engine import AsyncEngine, Context
from ..utils.tracing import get_tracer
from .backend import Backend
from .engines import EchoCoreEngine, EchoFullEngine
from .model_card import ModelDeploymentCard
from .preprocessor import Preprocessor, has_images
from .protocols.common import BackendInput, EngineOutput, FinishReason
from .protocols.openai import (
    ChatCompletionRequest,
    ChatDeltaGenerator,
    CompletionDeltaGenerator,
    CompletionRequest,
    ProtocolError,
    usage_dict,
)


# Image requests are preprocessed here, one at a time: the PNG decode is
# host work of up to seconds, kept off the event loop; decodes in parallel
# threads contend for the GIL with each other and with the engine thread
# (``scripts/vlm_preprocess_probe.py`` times the choices)
_IMAGE_PREPROCESS = concurrent.futures.ThreadPoolExecutor(
    1, thread_name_prefix="image-preprocess")


class OpenAIChatEngine(AsyncEngine[ChatCompletionRequest, Dict[str, Any]]):
    """ChatCompletionRequest -> stream of chat.completion.chunk dicts."""

    def __init__(self, card: ModelDeploymentCard,
                 core_engine: AsyncEngine[BackendInput, EngineOutput]):
        self.card = card
        self.preprocessor = Preprocessor(card)
        self.backend = Backend(core_engine, self.preprocessor.tokenizer)

    async def generate(self, request: ChatCompletionRequest,
                       context: Context) -> AsyncIterator[Dict[str, Any]]:
        from .tools import ToolCallingMatcher, normalize_tool_choice

        with get_tracer().span("preprocess", trace_id=context.id) as psp:
            if has_images(request.messages):
                pre = await asyncio.get_running_loop().run_in_executor(
                    _IMAGE_PREPROCESS, self.preprocessor.preprocess_chat,
                    request)
            else:
                pre = self.preprocessor.preprocess_chat(request)
            if psp is not None:
                psp.attrs["prompt_tokens"] = len(pre.backend_input.token_ids)
        gen = ChatDeltaGenerator(request.model, request_id=f"chatcmpl-{context.id[:24]}")
        prompt_tokens = len(pre.backend_input.token_ids)
        completion_tokens = 0
        mode, forced = normalize_tool_choice(request.tool_choice, request.tools)
        matcher = ToolCallingMatcher(mode, forced) if mode != "none" else None
        # With tools active the text is buffered: a tool call can only be
        # recognized on the complete message (reference tools.rs matches whole
        # messages), and streaming content that later turns out to be a tool
        # call would hand the client both.
        buffered: List[str] = []
        buffered_lp: List[Dict[str, Any]] = []
        if pre.annotations:
            yield {"event": "annotations", "data": pre.annotations}
        # aclosing: the early return on finish must close the backend (and
        # transitively the core engine) generator immediately
        stream_cm = contextlib.aclosing(
            self.backend.generate(pre.backend_input, context))
        async with stream_cm as stream:
            async for out in stream:
                completion_tokens += len(out.token_ids)
                # with logprobs on, even a token with no visible text (partial
                # UTF-8, stop-jail) must carry its logprob entry downstream
                want_lp = bool(request.logprobs and out.logprobs)
                if out.text or (want_lp and out.token_ids):
                    if matcher is not None:
                        if out.text:
                            buffered.append(out.text)
                        if want_lp:
                            buffered_lp.extend(
                                self._chat_logprobs(out)["content"])
                    else:
                        chunk = gen.text_chunk(out.text or "", out.index)
                        if want_lp:
                            chunk["choices"][0]["logprobs"] = \
                                self._chat_logprobs(out)
                        yield chunk
                if out.finish_reason is not None:
                    finish_override = None
                    if matcher is not None:
                        complete = out.finish_reason in (FinishReason.STOP,
                                                         FinishReason.EOS)
                        try:
                            calls = matcher.get_calls("".join(buffered),
                                                      complete)
                        except ProtocolError as e:
                            # streaming has begun (annotation/role chunks may
                            # be committed): surface as a terminal in-stream
                            # error, not an exception after a 200 header —
                            # parse-time validation already gave clean 400s
                            yield {"error": {"message": str(e),
                                             "type": "invalid_request_error"}}
                            return
                        if calls:
                            yield gen.tool_calls_chunk(calls, out.index)
                            finish_override = "tool_calls"
                        elif buffered:
                            chunk = gen.text_chunk("".join(buffered), out.index)
                            if buffered_lp:
                                chunk["choices"][0]["logprobs"] = \
                                    {"content": buffered_lp}
                            yield chunk
                    yield gen.finish_chunk(
                        out.finish_reason, out.index,
                        usage=usage_dict(prompt_tokens, completion_tokens),
                        finish_override=finish_override,
                    )
                    return

    def _chat_logprobs(self, out: EngineOutput) -> Dict[str, Any]:
        """OpenAI chat logprobs delta: one content entry per token."""
        content = []
        for tid, lp_map in zip(out.token_ids, out.logprobs or []):
            lp = next(iter(lp_map.values())) if lp_map else 0.0
            tok = self.preprocessor.tokenizer.decode([tid])
            content.append({"token": tok, "logprob": lp,
                            "bytes": list(tok.encode())})
        return {"content": content}


class OpenAICompletionEngine(AsyncEngine[CompletionRequest, Dict[str, Any]]):
    """CompletionRequest -> stream of text_completion chunk dicts."""

    def __init__(self, card: ModelDeploymentCard,
                 core_engine: AsyncEngine[BackendInput, EngineOutput]):
        self.card = card
        self.preprocessor = Preprocessor(card)
        self.backend = Backend(core_engine, self.preprocessor.tokenizer)

    async def generate(self, request: CompletionRequest,
                       context: Context) -> AsyncIterator[Dict[str, Any]]:
        with get_tracer().span("preprocess", trace_id=context.id) as psp:
            pre = self.preprocessor.preprocess_completion(request)
            if psp is not None:
                psp.attrs["prompt_tokens"] = len(pre.backend_input.token_ids)
        gen = CompletionDeltaGenerator(request.model, request_id=f"cmpl-{context.id[:24]}")
        prompt_tokens = len(pre.backend_input.token_ids)
        completion_tokens = 0
        if request.echo and pre.formatted_prompt:
            yield gen.text_chunk(pre.formatted_prompt)
        async with contextlib.aclosing(
                self.backend.generate(pre.backend_input,
                                      context)) as stream:
            async for out in stream:
                completion_tokens += len(out.token_ids)
                fin = out.finish_reason.to_openai() if out.finish_reason else None
                want_lp = request.logprobs is not None and bool(out.logprobs)
                if out.text or fin or (want_lp and out.token_ids):
                    lp = None
                    if want_lp:
                        toks = [self.preprocessor.tokenizer.decode([t])
                                for t in out.token_ids]
                        lp = {"tokens": toks,
                              "token_logprobs": [
                                  next(iter(m.values())) if m else 0.0
                                  for m in out.logprobs],
                              "top_logprobs": None,
                              "text_offset": []}
                    chunk = gen.text_chunk(out.text or "", out.index, fin,
                                           logprobs=lp)
                    if fin:
                        chunk["usage"] = usage_dict(prompt_tokens, completion_tokens)
                    yield chunk
                if fin:
                    return


class FullEngineAdapter(AsyncEngine):
    """Adapts a text-level full engine (streams plain text, e.g.
    EchoFullEngine or a pystr user engine) to OpenAI chunk dicts for both
    chat and completions. With a ``tokenizer``, usage counts are derived
    from the request/response text (full engines have no token stream of
    their own)."""

    def __init__(self, model: str, engine: AsyncEngine, kind: str = "chat",
                 tokenizer=None):
        self.model = model
        self.engine = engine
        self.kind = kind
        self.tokenizer = tokenizer

    async def generate(self, request, context: Context):
        if self.kind == "chat":
            gen = ChatDeltaGenerator(self.model, request_id=f"chatcmpl-{context.id[:24]}")
        else:
            gen = CompletionDeltaGenerator(self.model, request_id=f"cmpl-{context.id[:24]}")
        parts = []
        async with contextlib.aclosing(
                self.engine.generate(request, context)) as stream:
            async for text in stream:
                if self.tokenizer is not None:
                    parts.append(text)
                yield gen.text_chunk(text)
        chunk = gen.finish_chunk(FinishReason.STOP)
        if self.tokenizer is not None:
            if self.kind == "chat":
                from .preprocessor import content_text

                prompt_text = "".join(content_text(m.get("content"))
                                      for m in request.messages)
            else:
                prompt_text = (request.prompt
                               if isinstance(request.prompt, str) else "")
            chunk["usage"] = usage_dict(
                len(self.tokenizer.encode(prompt_text)),
                len(self.tokenizer.encode("".join(parts))))
        yield chunk


def build_chat_engine(card: ModelDeploymentCard, kind: str,
                      core_engine: Optional[AsyncEngine] = None) -> AsyncEngine:
    """``kind``: 'echo_core' | 'echo_full' | 'core' (bring your own core
    engine)."""
    if kind == "echo_full":
        return FullEngineAdapter(card.name, EchoFullEngine(), "chat")
    if kind == "echo_core":
        return OpenAIChatEngine(card, EchoCoreEngine())
    if kind == "core":
        assert core_engine is not None
        return OpenAIChatEngine(card, core_engine)
    raise ValueError(f"unknown engine kind {kind!r}")


def build_completion_engine(card: ModelDeploymentCard, kind: str,
                            core_engine: Optional[AsyncEngine] = None) -> AsyncEngine:
    if kind == "echo_full":
        return FullEngineAdapter(card.name, EchoFullEngine(), "completion")
    if kind == "echo_core":
        return OpenAICompletionEngine(card, EchoCoreEngine())
    if kind == "core":
        assert core_engine is not None
        return OpenAICompletionEngine(card, core_engine)
    raise ValueError(f"unknown engine kind {kind!r}")
