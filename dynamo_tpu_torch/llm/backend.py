"""Backend postprocessor: token stream -> text stream.

Wraps a core (token-in/token-out) engine and performs incremental
detokenization, hidden-stop-token jailing, stop-sequence truncation and
length/EOS finishing — producing clean text deltas for the delta generators.

Reference capability: lib/llm/src/backend.rs:63-479 (Backend.generate, Decoder
step loop, stop jail).
"""

from __future__ import annotations

import contextlib
from typing import AsyncIterator

from ..runtime.engine import AsyncEngine, Context, EngineError
from .protocols.common import BackendInput, EngineOutput, FinishReason
from .tokenizer import DecodeStream, StopSequenceDecoder, Tokenizer


class Backend(AsyncEngine[BackendInput, EngineOutput]):
    """Postprocessing stage layered over a core engine.

    The inner engine streams ``EngineOutput`` with ``token_ids`` only; this
    stage fills in ``text`` and rewrites ``finish_reason`` when a client stop
    sequence fires before the engine's own finish.
    """

    def __init__(self, engine: AsyncEngine[BackendInput, EngineOutput],
                 tokenizer: Tokenizer):
        self.engine = engine
        self.tokenizer = tokenizer

    async def generate(self, request: BackendInput,
                       context: Context) -> AsyncIterator[EngineOutput]:
        decode = DecodeStream(self.tokenizer, request.token_ids)
        # min_tokens suppresses stop-sequence scanning entirely until the
        # minimum is generated (a stop string spanning the boundary is
        # deliberately not matched, mirroring common engine semantics).
        stops = StopSequenceDecoder(request.stop.stop)
        emitted = 0
        min_tokens = request.stop.min_tokens or 0

        # aclosing: an early return (stop sequence, client stop) must close
        # the core engine's generator NOW — its finally blocks release
        # engine-side resources (slot cancel bookkeeping, user-engine
        # cleanup) and deferring them to GC leaves those held
        async with contextlib.aclosing(
                self.engine.generate(request, context)) as stream:
            async for out in stream:
                if out.finish_reason is FinishReason.ERROR:
                    # surface the cause as a typed error: over the wire it
                    # becomes an error frame, at the HTTP edge an SSE error
                    # event — never a silently terminated stream. The
                    # engine's code/stage/reason ride along so an
                    # over-length rejection maps to a 400 body naming the
                    # limit, not a generic 500
                    raise EngineError(out.error or "engine error",
                                      out.error_code or 500,
                                      stage=out.error_stage,
                                      reason=out.error_reason)
                text_parts = []
                finish = out.finish_reason
                for tid in out.token_ids:
                    emitted += 1
                    piece = decode.step(tid)
                    if not piece:
                        continue
                    if emitted <= min_tokens:
                        text_parts.append(piece)
                        continue
                    visible, hit_stop = stops.feed(piece)
                    if visible:
                        text_parts.append(visible)
                    if hit_stop:
                        finish = FinishReason.STOP
                        break
                if finish is not None and finish is not FinishReason.STOP:
                    # engine finished without a client stop: flush held-back text
                    tail = decode.flush()
                    if tail:
                        visible, hit_stop = stops.feed(tail)
                        if visible:
                            text_parts.append(visible)
                        if hit_stop:
                            finish = FinishReason.STOP
                    if finish is not FinishReason.STOP:
                        jail = stops.flush()
                        if jail:
                            text_parts.append(jail)
                text = "".join(text_parts)
                # always yield (even with empty text) so downstream usage
                # accounting sees every generated token id
                if text or finish is not None or out.token_ids:
                    yield EngineOutput(
                        token_ids=out.token_ids,
                        text=text,
                        cum_log_prob=out.cum_log_prob,
                        logprobs=out.logprobs,
                        finish_reason=finish,
                        kv_prefix_hit_tokens=out.kv_prefix_hit_tokens,
                        index=out.index,
                    )
                if finish is not None:
                    if finish is FinishReason.STOP:
                        context.stop_generating()
                    return
        # stream ended without an explicit finish (e.g. cancelled upstream)
        tail = decode.flush() + stops.flush()
        yield EngineOutput(token_ids=[], text=tail,
                          finish_reason=FinishReason.CANCELLED)
