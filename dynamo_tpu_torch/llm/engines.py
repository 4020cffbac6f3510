"""Test/fixture engines: echo backends that need no model at all.

``EchoCoreEngine`` is a token-level core engine (BackendInput ->
EngineOutput) that replays the prompt tokens at a fixed rate; ``echo_full``
operates at the OpenAI level, streaming the last user message back. Every
input mode and the whole pipeline can run against them with no GPU and no
weights, as the reference uses its echo engines as the main fake backend
(reference: lib/llm/src/engines.rs:64-178, env DYN_TOKEN_ECHO_DELAY_MS).
"""

from __future__ import annotations

import asyncio
import os
from typing import AsyncIterator

from ..runtime.engine import AsyncEngine, Context
from .protocols.common import BackendInput, EngineOutput, FinishReason

ECHO_DELAY_ENV = "DYN_TOKEN_ECHO_DELAY_MS"


def _delay_s() -> float:
    return float(os.environ.get(ECHO_DELAY_ENV, "10")) / 1000.0


class EchoCoreEngine(AsyncEngine[BackendInput, EngineOutput]):
    """Echoes the prompt's token ids back one at a time (rate-limited)."""

    def __init__(self, delay_s: float | None = None):
        self._delay = delay_s

    async def generate(self, request: BackendInput,
                       context: Context) -> AsyncIterator[EngineOutput]:
        delay = self._delay if self._delay is not None else _delay_s()
        # a resumed request's tail carries the resume_pos tokens already
        # emitted: echo the original prompt from that position on
        pos = int(request.resume_pos or 0)
        src = request.token_ids[:len(request.token_ids) - pos] if pos \
            else request.token_ids
        budget = request.stop.max_tokens
        if budget is None:
            budget = len(src)
        n = min(pos + budget, len(src))
        if n <= pos:
            yield EngineOutput(token_ids=[], finish_reason=FinishReason.LENGTH)
            return
        for i in range(pos, n):
            if context.is_stopped:
                yield EngineOutput(token_ids=[],
                                   finish_reason=FinishReason.CANCELLED)
                return
            if delay:
                await asyncio.sleep(delay)
            last = i == n - 1
            yield EngineOutput(
                token_ids=[src[i]],
                finish_reason=FinishReason.LENGTH if last else None,
            )


class EchoFullEngine(AsyncEngine):
    """OpenAI-level echo: streams the last user message back as chunks."""

    def __init__(self, delay_s: float | None = None, chunk_chars: int = 4):
        self._delay = delay_s
        self._chunk = chunk_chars

    async def generate(self, request, context: Context):
        delay = self._delay if self._delay is not None else _delay_s()
        if hasattr(request, "messages"):
            text = str(request.messages[-1].get("content", ""))
        else:
            text = request.prompt if isinstance(request.prompt, str) else ""
        for i in range(0, len(text), self._chunk):
            if context.is_stopped:
                return
            if delay:
                await asyncio.sleep(delay)
            yield text[i : i + self._chunk]
