"""Composable pipeline graph: generic Operator nodes over AsyncEngine.

An ``Operator`` owns both directions of one pipeline segment: it transforms
the request on the way *forward* (toward the engine) and the response
stream on the way *backward* (toward the caller) — the bidirectional node
shape of the reference's pipeline graph. Operators compose right-to-left
around a terminal engine:

    engine = compose(OpA(), OpB(), backend)     # A(B(backend))
    # request: A.forward -> B.forward -> backend
    # stream:  backend -> B.backward -> A.backward

``compose`` returns a plain AsyncEngine, so a composed pipeline drops into
every place an engine goes (HTTP service, endpoint server, another
pipeline). The LLM preprocessor/backend chain (llm/pipeline.py) is the
specialized, fused version of this shape; these nodes cover the general
case (custom middleware: routing, annotation, validation, recording).

Reference capability: lib/runtime/src/pipeline.rs:41-68 (ServiceFrontend →
Operator fwd/bwd edges → ServiceBackend), pipeline/nodes.rs.
"""

from __future__ import annotations

from typing import Any, AsyncIterator, Generic, TypeVar

from .engine import AsyncEngine, Context

In = TypeVar("In")
Out = TypeVar("Out")
NextIn = TypeVar("NextIn")
NextOut = TypeVar("NextOut")


class Operator(Generic[In, Out, NextIn, NextOut]):
    """One bidirectional pipeline segment."""

    async def forward(self, request: In, context: Context) -> NextIn:
        """Transform the request for the downstream node."""
        return request  # type: ignore[return-value]

    def backward(self, stream: AsyncIterator[NextOut], request: In,
                 context: Context) -> AsyncIterator[Out]:
        """Transform the downstream response stream for the upstream node.
        Default: pass-through."""
        return stream  # type: ignore[return-value]


class _OperatorEngine(AsyncEngine):
    def __init__(self, op: Operator, inner: AsyncEngine):
        self.op = op
        self.inner = inner

    async def generate(self, request, context: Context):
        fwd = await self.op.forward(request, context)
        stream = self.inner.generate(fwd, context)
        async for item in self.op.backward(stream, request, context):
            yield item


def compose(*nodes: Any) -> AsyncEngine:
    """``compose(op1, op2, ..., engine)``: wrap the terminal engine with
    operators right-to-left. A bare AsyncEngine in operator position is a
    segment boundary error."""
    if not nodes:
        raise ValueError("compose() needs at least a terminal engine")
    engine = nodes[-1]
    if not isinstance(engine, AsyncEngine):
        raise TypeError("last compose() argument must be an AsyncEngine")
    for op in reversed(nodes[:-1]):
        if not isinstance(op, Operator):
            raise TypeError(f"{op!r} is not an Operator")
        engine = _OperatorEngine(op, engine)
    return engine


class SegmentSink(AsyncEngine):
    """Terminal node adapting a plain async function
    ``fn(request, context) -> AsyncIterator`` into an engine (the
    reference's ServiceBackend over a closure engine)."""

    def __init__(self, fn):
        self.fn = fn

    async def generate(self, request, context: Context):
        async for item in self.fn(request, context):
            yield item
