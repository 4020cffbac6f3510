"""Framing + message codec shared by every TCP protocol of the port.

Frame = 4-byte big-endian length || msgpack payload. One codec for the store
protocol, the request/data plane and the C++ implementations to come — a
single place defines the bytes on the wire.

The data plane additionally uses two-part messages: a small control header
(dict) plus an optional raw binary payload, packed as one msgpack array
[control, payload]. This mirrors the reference's TwoPartCodec
(lib/runtime/src/pipeline/network/codec/two_part.rs) so large tensors ride
untouched next to JSON-ish control data.

The codec is the port's own ``_msgpack`` (the card has no ``msgpack``); its
bytes are ``msgpack.packb(obj, use_bin_type=True)``'s, so the JAX package's
processes read every frame this module writes and the other way round.
"""

from __future__ import annotations

import asyncio
import struct
from typing import Any, Optional, Tuple

from . import _msgpack

MAX_FRAME = 256 * 1024 * 1024  # 256 MB: KV block transfers ride this plane

# ---------------------------------------------------------------------------
# control-header field registry
#
# Every field name that may appear in a two-part frame's control header is
# declared HERE and spelled through these constants everywhere else — the
# ``wire-field-drift`` dynalint rule gates it two-way (a literal spelling
# in dataplane code fails the run, a constant nobody reads is stale) and
# docs/keyspace.md renders the table. One misspelled field between a
# producer and a consumer that "drops unknown fields gracefully" is a
# silent protocol fork; the registry makes the field surface reviewable.
# ---------------------------------------------------------------------------

# frame discriminator: request | prologue | data | part | end | sentinel |
# stop | kill | error
KIND_KEY = "kind"
# target endpoint name on request frames
ENDPOINT_KEY = "endpoint"
# request identity, stable across hops (trace_id defaults to it)
CONTEXT_ID_KEY = "context_id"
# payload content type: "bin" passes raw bytes through untouched
CTYPE_KEY = "ctype"
# request body arrives as a client-side stream of "part" frames
STREAMING_KEY = "streaming"
# absolute deadline (unix seconds) riding the envelope (runtime/deadline.py)
DEADLINE_KEY = "deadline"

# Optional span-context field on request control headers: [trace_id,
# parent_span_id]. Rides next to ``context_id`` so one request's spans
# stitch across processes (utils/tracing.py). Both of the port's planes
# read it; a plane that drops it degrades to trace_id == context_id.
TRACE_KEY = "trace"

# Optional overload-priority field on request control headers
# ("interactive" | "batch", utils/overload.py). Absent => interactive, the
# protective default.
PRIORITY_KEY = "priority"

# Optional resume-attempt ordinal on request control headers (llm/resume.py
# mid-stream failover). Attempt N of a broken stream re-enters the plane
# under the SAME context_id with resume = N (first dispatch omits it /
# sends 0): a worker holding a still-active context of that id yields to
# the higher ordinal instead of answering the duplicate-context 409 — the
# original handler is a zombie whose client already gave up on it.
RESUME_KEY = "resume"

# error-frame fields (runtime/component.py error_control/error_from_control)
MESSAGE_KEY = "message"          # human-readable error text
CODE_KEY = "code"                # http-ish status carried by EngineError
STAGE_KEY = "stage"              # pipeline stage that shed/expired
REASON_KEY = "reason"            # machine reason (overload shed class etc.)
RETRY_AFTER_KEY = "retry_after"  # client backoff hint, seconds

#: field name -> description; the registry the drift gate + docs render.
#: (A plain literal dict, as in the JAX package's copy, which its lint
#: rule reads via AST.)
WIRE_FIELDS = {
    "kind": "frame discriminator: request | prologue | data | part | end "
            "| sentinel | stop | kill | error",
    "endpoint": "target endpoint name on request frames",
    "context_id": "request identity, stable across hops; trace_id "
                  "defaults to it",
    "ctype": "payload content type ('bin' = raw bytes pass-through)",
    "streaming": "request body arrives as a stream of 'part' frames",
    "deadline": "absolute end-to-end deadline, unix seconds",
    "trace": "span context [trace_id, parent_span_id] for cross-process "
             "stitching",
    "priority": "overload class: interactive | batch (absent => "
                "interactive)",
    "resume": "mid-stream failover attempt ordinal; a higher ordinal "
              "supersedes an active context of the same id",
    "message": "error frame: human-readable text",
    "code": "error frame: http-ish status code",
    "stage": "error frame: pipeline stage that shed/expired the request",
    "reason": "error frame: machine-readable reason",
    "retry_after": "error frame: client backoff hint, seconds",
}


def attach_trace(control: dict) -> dict:
    """Stamp the ambient span context onto a request control header."""
    from ..utils.tracing import wire_context

    tw = wire_context()
    if tw is not None:
        control[TRACE_KEY] = tw
    return control


def extract_trace(control: dict, default_trace_id=None):
    """SpanContext from a control header (see utils.tracing.extract_wire)."""
    from ..utils.tracing import extract_wire

    return extract_wire(control.get(TRACE_KEY),
                        default_trace_id=default_trace_id)


def pack(obj: Any) -> bytes:
    body = _msgpack.packb(obj)
    return struct.pack(">I", len(body)) + body


def pack_two_part(control: dict, payload: Optional[bytes] = None) -> bytes:
    return pack([control, payload])


def unpack_two_part(obj: Any) -> Tuple[dict, Optional[bytes]]:
    """Split a decoded two-part frame into (control, payload).

    Raises a typed ``ValueError`` on malformed frames (wrong arity, or a
    non-dict control header) instead of leaking a bare unpack
    ``TypeError`` into rx loops — a corrupt or hostile peer must surface
    as a protocol error the connection handlers already classify."""
    if not isinstance(obj, (list, tuple)) or len(obj) != 2:
        raise ValueError(
            f"malformed two-part frame: expected [control, payload], "
            f"got {type(obj).__name__}"
            + (f" of length {len(obj)}"
               if isinstance(obj, (list, tuple)) else ""))
    control, payload = obj
    if not isinstance(control, dict):
        raise ValueError(f"malformed two-part frame: control header is "
                         f"{type(control).__name__}, expected dict")
    return control, payload


class FrameReader:
    """Incremental frame decoder over an asyncio StreamReader.

    ``read()`` is CANCELLATION-SAFE at the frame level: a reader task
    cancelled between the length header and the body (e.g. the data plane's
    control watcher being torn down mid-frame) leaves the parsed length in
    ``_pending_len``, and the next ``read()`` resumes with the body instead
    of desynchronizing the stream. (StreamReader.readexactly itself only
    consumes bytes once all n are buffered, so cancelling it is safe.)"""

    def __init__(self, reader: asyncio.StreamReader):
        self._r = reader
        self._pending_len: Optional[int] = None

    async def read(self) -> Any:
        """Read one frame; raises asyncio.IncompleteReadError on EOF."""
        if self._pending_len is None:
            # unbounded-ok: read() is the framing PRIMITIVE — boundedness
            # is the caller's contract (deadline.wait_for on request paths,
            # connection-lifetime rx loops elsewhere)
            hdr = await self._r.readexactly(4)
            (n,) = struct.unpack(">I", hdr)
            if n > MAX_FRAME:
                raise ValueError(f"frame of {n} bytes exceeds MAX_FRAME")
            self._pending_len = n
        # unbounded-ok: see header read above — callers bound read()
        body = await self._r.readexactly(self._pending_len)
        self._pending_len = None
        return _msgpack.unpackb(body)


async def write_frame(writer: asyncio.StreamWriter, obj: Any) -> None:
    writer.write(pack(obj))
    # unbounded-ok: drain parks only on TCP backpressure from a live peer;
    # a dead peer errors it, and request paths carry their own deadline
    await writer.drain()
