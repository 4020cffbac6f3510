"""Bring-your-own Python engines: ``out=pystr:file.py`` / ``out=pytok:file.py``.

The user file defines one coroutine generator::

    async def generate(request, context):
        yield ...

- **pystr** (string level): ``request`` is the fully templated prompt
  string; yields are text chunks streamed straight to the client. The
  framework still does chat templating, SSE framing and usage accounting
  (token counts via the card's tokenizer) around it.
- **pytok** (token level): ``request`` is a ``BackendInput`` (token_ids,
  sampling, stop); yields are token ids (int or list[int]) or complete
  ``EngineOutput`` objects. Detokenization, stop handling and the OpenAI
  layer run on top exactly as for the in-tree engine; ``max_tokens`` is
  enforced regardless of which shape the generator yields.

The JAX package's ``dynamo_tpu/llm/python_engine.py`` on the port's own
preprocessor, backend and tokenizers: the same user file streams the same
chunks and usage through either package. Reference capability:
lib/engines/python (pystr:/pytok: engines loaded from a user Python file
via PyO3); this is the same contract bridged natively.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import os
from typing import AsyncIterator

from ..runtime.engine import AsyncEngine, Context
from .model_card import ModelDeploymentCard
from .preprocessor import Preprocessor
from .protocols.common import BackendInput, EngineOutput, FinishReason
from .protocols.openai import ProtocolError


class PythonEngineError(RuntimeError):
    pass


def _load_generate(path: str):
    if not os.path.isfile(path):
        raise PythonEngineError(f"python engine file not found: {path}")
    spec = importlib.util.spec_from_file_location(
        f"_dynamo_pyengine_{abs(hash(os.path.abspath(path)))}", path)
    if spec is None or spec.loader is None:
        raise PythonEngineError(
            f"{path} is not loadable as a Python module (needs a .py file)")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn = getattr(mod, "generate", None)
    if fn is None:
        raise PythonEngineError(
            f"{path} must define 'async def generate(request, context)'")
    return fn


async def _drive(agen, context: Context):
    """Iterate a user async generator with the FnEngine discipline: stop on
    kill, close the generator on any early exit so its cleanup runs now."""
    try:
        async for item in agen:
            if context.is_killed:
                return
            yield item
    finally:
        with contextlib.suppress(Exception):
            await agen.aclose()


class PyTokCoreEngine(AsyncEngine[BackendInput, EngineOutput]):
    """Token-level user engine: BackendInput -> stream of token ids."""

    def __init__(self, path: str):
        self._fn = _load_generate(path)
        self.path = path

    async def generate(self, request: BackendInput,
                       context: Context) -> AsyncIterator[EngineOutput]:
        emitted = 0
        budget = request.stop.max_tokens
        async with contextlib.aclosing(
                _drive(self._fn(request, context), context)) as agen:
            async for item in agen:
                if context.is_stopped:
                    yield EngineOutput(token_ids=[],
                                       finish_reason=FinishReason.CANCELLED)
                    return
                if isinstance(item, EngineOutput):
                    out = item
                else:
                    ids = [int(item)] if isinstance(item, int) else \
                        [int(t) for t in item]
                    out = EngineOutput(token_ids=ids)
                # the client's max_tokens binds whichever shape the user
                # yields — truncate a multi-token item at the boundary.
                # Copy rather than mutate: a user engine may retain the
                # object it yielded.
                if budget is not None and emitted + len(out.token_ids) >= budget:
                    out = dataclasses.replace(
                        out,
                        token_ids=out.token_ids[:budget - emitted],
                        finish_reason=out.finish_reason or FinishReason.LENGTH)
                emitted += len(out.token_ids)
                yield out
                if out.finish_reason is not None:
                    return
        # generator exhausted — or _drive bailed on kill, which is not a
        # clean completion
        yield EngineOutput(
            token_ids=[],
            finish_reason=(FinishReason.CANCELLED if context.is_killed
                           else FinishReason.STOP))


class _PyStrTextEngine(AsyncEngine):
    """Text-level engine over the user fn: renders the prompt (chat
    template, tool_choice guard) and streams the user's text chunks.
    OpenAI framing is FullEngineAdapter's job — not duplicated here."""

    def __init__(self, fn, card: ModelDeploymentCard, kind: str):
        self._fn = fn
        self.kind = kind
        self._pre = Preprocessor(card)

    def _prompt(self, request) -> str:
        if self.kind == "chat":
            # same tools contract as the in-tree preprocessor: with
            # tool_choice='none' the schemas stay out of the prompt
            tools = (None if getattr(request, "tool_choice", None) == "none"
                     else getattr(request, "tools", None))
            return self._pre.render_chat(request.messages, tools)
        raw = request.prompt
        if not isinstance(raw, str):
            # match preprocess_completion: token-id / batched prompts are
            # rejected, not silently replaced with ""
            raise ProtocolError(
                "pystr engines accept string prompts only")
        return raw

    async def generate(self, request, context: Context):
        prompt = self._prompt(request)
        async with contextlib.aclosing(
                _drive(self._fn(prompt, context), context)) as agen:
            async for text in agen:
                if context.is_stopped:
                    return
                yield str(text)


def build_python_engines(spec: str, card: ModelDeploymentCard):
    """``spec``: 'pystr:path.py' or 'pytok:path.py'. Returns the
    (chat_engine, completion_engine) pair at the OpenAI level."""
    from .pipeline import (
        FullEngineAdapter,
        build_chat_engine,
        build_completion_engine,
    )
    from .tokenizer import load_tokenizer

    kind, _, path = spec.partition(":")
    if not path:
        raise PythonEngineError(f"{kind}: needs a file path ({kind}:file.py)")
    if kind == "pytok":
        core = PyTokCoreEngine(path)
        return (build_chat_engine(card, "core", core),
                build_completion_engine(card, "core", core))
    if kind == "pystr":
        tok = load_tokenizer(card.tokenizer)
        # one module exec shared by both endpoints: a user file that loads
        # a model at module scope must pay that load once
        fn = _load_generate(path)
        return (
            FullEngineAdapter(card.name,
                              _PyStrTextEngine(fn, card, "chat"),
                              "chat", tokenizer=tok),
            FullEngineAdapter(card.name,
                              _PyStrTextEngine(fn, card, "completion"),
                              "completion", tokenizer=tok),
        )
    raise PythonEngineError(f"unknown python engine kind {kind!r}")
