"""Test/fixture engine: an echo backend that needs no model at all.

``echo_full`` operates at the OpenAI level, streaming the last user message
back at a fixed rate. Every input mode can run against it with no GPU and no
weights, as the reference uses its echo engines as the main fake backend
(reference: lib/llm/src/engines.rs:64-178, env DYN_TOKEN_ECHO_DELAY_MS).
"""

from __future__ import annotations

import asyncio
import os

from ..runtime.engine import AsyncEngine, Context

ECHO_DELAY_ENV = "DYN_TOKEN_ECHO_DELAY_MS"


def _delay_s() -> float:
    return float(os.environ.get(ECHO_DELAY_ENV, "10")) / 1000.0


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
