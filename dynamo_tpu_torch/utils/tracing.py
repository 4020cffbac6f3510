"""End-to-end request tracing: per-request span timelines across processes.

A request entering the HTTP frontend opens a **root span** whose trace id is
the request id (``Context.id``) — the same id the wire already propagates as
``context_id`` — so spans recorded in *any* process touched by the request
(frontend, router, decode worker, prefill worker) stitch into one trace with
no extra plumbing. On top of that, the data-plane request envelope carries an
optional ``trace`` field ([trace_id, parent_span_id]) so child spans link to
their cross-process parent, not just to the trace.

Pieces:

- :class:`Tracer` — per-process span factory + bounded ring buffer of
  finished spans. ``tracer.span("name")`` is a context manager (sync *and*
  async) that parents itself from :data:`current_span_var`.
- :func:`wire_context` / :func:`extract_wire` — (de)serialize the span
  context for the data-plane control header and queue payloads.
- :class:`StoreSpanSink` — flushes finished spans to the dynstore under
  ``traces/{trace_id}/{span_id}`` on a TTL lease, which is how the frontend's
  ``GET /v1/traces/{request_id}`` endpoint sees spans from other processes
  (and how traces outlive the workers that produced them, until the TTL).
- :func:`to_chrome_trace` — Chrome trace-event JSON (load in Perfetto /
  ``chrome://tracing``): one track per (component, pid), complete events.

Tracing is on by default (``DYN_TRACING=0`` disables; recording a span is two
``perf_counter`` calls and a deque append). Buffer size: ``DYN_TRACE_BUFFER``
(spans, default 4096).

Reference capability: the reference's request-id span fields + OTel-ish
context propagation (lib/runtime/src/logging.rs spans), trimmed to the
in-process flight-recorder shape this repo needs.
"""

from __future__ import annotations

import contextlib
import contextvars
import hashlib
import json
import logging
import os
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

log = logging.getLogger("dynamo_tpu_torch.tracing")

TRACE_STORE_PREFIX = "traces/"


def trace_store_key(trace_id: str, span_id: str) -> str:
    return f"{TRACE_STORE_PREFIX}{trace_id}/{span_id}"


@dataclass
class SpanContext:
    """What travels across process boundaries: which trace, which parent."""

    trace_id: str
    span_id: Optional[str] = None

    def to_wire(self) -> List[Optional[str]]:
        return [self.trace_id, self.span_id]

    @classmethod
    def from_wire(cls, v: Any) -> Optional["SpanContext"]:
        if (isinstance(v, (list, tuple)) and len(v) == 2
                and isinstance(v[0], str)):
            return cls(v[0], v[1] if isinstance(v[1], str) else None)
        return None


current_span_var: contextvars.ContextVar[Optional[SpanContext]] = \
    contextvars.ContextVar("dynamo_current_span", default=None)


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    component: str
    pid: int
    start: float                 # epoch seconds (cross-process comparable)
    end: float = 0.0
    status: str = "ok"
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return max(0.0, self.end - self.start)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name, "trace_id": self.trace_id,
            "span_id": self.span_id, "parent_id": self.parent_id,
            "component": self.component, "pid": self.pid,
            "start": self.start, "end": self.end, "status": self.status,
            "attrs": self.attrs,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Span":
        return cls(**{k: d.get(k) for k in (
            "name", "trace_id", "span_id", "parent_id", "component", "pid",
            "start", "end", "status")}, attrs=d.get("attrs") or {})

    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)


def _new_span_id() -> str:
    return uuid.uuid4().hex[:16]


# ---------------------------------------------------------------------------
# head sampling (fleet-scale pressure relief for the store span sink)
# ---------------------------------------------------------------------------
def sample_rate() -> float:
    """``DYN_TRACE_SAMPLE``: fraction of traces exported to the store
    sink (1.0 = everything, the default). Clamped to [0, 1]; malformed
    values read as 1.0 — misconfiguration must not silence tracing."""
    raw = os.environ.get("DYN_TRACE_SAMPLE", "")
    if not raw:
        return 1.0
    try:
        return min(max(float(raw), 0.0), 1.0)
    except ValueError:
        log.warning("ignoring malformed DYN_TRACE_SAMPLE=%r", raw)
        return 1.0


def trace_sampled(trace_id: str, rate: float) -> bool:
    """Trace-id-consistent head-sampling decision: a deterministic hash of
    the trace id (NOT Python's randomized ``hash``), so every process a
    request touches makes the SAME keep/drop call with no coordination —
    a sampled trace keeps all its spans, an unsampled one keeps none."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    h = int.from_bytes(
        hashlib.sha1(trace_id.encode("utf-8", "replace")).digest()[:8],
        "big")
    return h < rate * 2.0 ** 64


def force_keep(span: "Span") -> bool:
    """Spans head sampling must NEVER drop: anything that finished in a
    non-ok status (errors, deadline expiries, breaker-driven failovers —
    all recorded as ``status="error"``) and fault-injection markers. The
    whole surrounding trace is then retained best-effort (see
    :class:`StoreSpanSink`)."""
    return (span.status != "ok" or span.name.startswith("fault:")
            or bool(span.attrs.get("force_trace")))


class _SpanScope:
    """Context manager (sync and async) around one span: sets
    :data:`current_span_var` for the body, finishes the span on exit,
    marks status=error when the body raises."""

    __slots__ = ("tracer", "span", "_token")

    def __init__(self, tracer: "Tracer", span: Optional["Span"]):
        self.tracer = tracer
        self.span = span
        self._token = None

    def __enter__(self) -> Optional["Span"]:
        if self.span is not None:
            self._token = current_span_var.set(self.span.context())
        return self.span

    def __exit__(self, exc_type, exc, tb) -> None:
        if self.span is None:
            return
        try:
            current_span_var.reset(self._token)
        except ValueError:
            # an abandoned async generator is finalized in a fresh Context
            # (aclose() after a mid-stream disconnect); the token belongs to
            # the serve task's Context — still record the span
            pass
        self.tracer.finish(
            self.span, status="error" if exc_type is not None else "ok")

    async def __aenter__(self) -> Optional["Span"]:
        return self.__enter__()

    async def __aexit__(self, exc_type, exc, tb) -> None:
        self.__exit__(exc_type, exc, tb)


class Tracer:
    """Per-process span recorder with a bounded ring of finished spans.

    Thread-safe: the engine thread and the asyncio loop both record.
    Finished spans additionally fan out to registered sinks (e.g.
    :class:`StoreSpanSink`); sink callbacks must be cheap and thread-safe.
    """

    def __init__(self, component: str = "proc",
                 capacity: Optional[int] = None,
                 enabled: Optional[bool] = None):
        if capacity is None:
            capacity = int(os.environ.get("DYN_TRACE_BUFFER", "4096"))
        if enabled is None:
            enabled = os.environ.get("DYN_TRACING", "1") not in ("0", "false")
        self.component = component
        self.enabled = enabled
        self._spans: deque = deque(maxlen=max(1, capacity))
        self._lock = threading.Lock()
        self._sinks: List[Callable[[Span], None]] = []

    # -- recording ----------------------------------------------------------
    def start_span(self, name: str, parent: Optional[SpanContext] = None,
                   trace_id: Optional[str] = None,
                   component: Optional[str] = None,
                   start: Optional[float] = None,
                   **attrs: Any) -> Optional[Span]:
        """Open a span. ``parent`` defaults to the ambient context; an
        explicit ``trace_id`` wins over the parent's (used at ingress where
        the request id IS the trace id). Returns None when disabled."""
        if not self.enabled:
            return None
        if parent is None:
            parent = current_span_var.get()
        tid = trace_id or (parent.trace_id if parent else None) \
            or uuid.uuid4().hex
        return Span(
            name=name, trace_id=tid, span_id=_new_span_id(),
            parent_id=parent.span_id if parent else None,
            component=component or self.component, pid=os.getpid(),
            start=time.time() if start is None else start, attrs=attrs)

    def finish(self, span: Optional[Span], status: str = "ok") -> None:
        if span is None or not self.enabled:
            return
        if not span.end:
            span.end = time.time()
        if status != "ok":
            span.status = status
        with self._lock:
            self._spans.append(span)
        for sink in self._sinks:
            try:
                sink(span)
            # dynalint: ok(swallowed-exception) a broken sink must never
            # break the request path; this runs per finished span, and the
            # store sink has its own retrying flush loop that does log
            except Exception:
                pass

    def span(self, name: str, **kw: Any) -> _SpanScope:
        """``with tracer.span("stage"): ...`` / ``async with ...`` sugar."""
        return _SpanScope(self, self.start_span(name, **kw))

    def record(self, name: str, start: float, end: float,
               parent: Optional[SpanContext] = None,
               trace_id: Optional[str] = None,
               component: Optional[str] = None, status: str = "ok",
               **attrs: Any) -> Optional[Span]:
        """Record an already-elapsed interval (e.g. queue wait measured from
        a timestamp stamped in another process)."""
        s = self.start_span(name, parent=parent, trace_id=trace_id,
                            component=component, start=start, **attrs)
        if s is not None:
            s.end = end
            self.finish(s, status=status)
        return s

    def add_sink(self, sink: Callable[[Span], None]) -> None:
        self._sinks.append(sink)

    def remove_sink(self, sink: Callable[[Span], None]) -> None:
        if sink in self._sinks:
            self._sinks.remove(sink)

    # -- queries ------------------------------------------------------------
    def spans_for(self, trace_id: str) -> List[Span]:
        with self._lock:
            return [s for s in self._spans if s.trace_id == trace_id]

    def recent_trace_ids(self, limit: int = 50) -> List[str]:
        """Most-recent-first unique trace ids in the ring."""
        seen: Dict[str, None] = {}
        with self._lock:
            snapshot = list(self._spans)
        for s in reversed(snapshot):
            if s.trace_id not in seen:
                seen[s.trace_id] = None
            if len(seen) >= limit:
                break
        return list(seen)

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


# ---------------------------------------------------------------------------
# process-global tracer
# ---------------------------------------------------------------------------
_tracer: Optional[Tracer] = None
_tracer_lock = threading.Lock()


def get_tracer() -> Tracer:
    global _tracer
    if _tracer is None:
        with _tracer_lock:
            if _tracer is None:
                _tracer = Tracer()
    return _tracer


def configure(component: Optional[str] = None,
              capacity: Optional[int] = None,
              enabled: Optional[bool] = None) -> Tracer:
    """Name this process's tracer (e.g. "http", "decode_worker"). Keeps the
    existing ring buffer when only renaming."""
    t = get_tracer()
    if component is not None:
        t.component = component
    if enabled is not None:
        t.enabled = enabled
    if capacity is not None:
        with t._lock:
            t._spans = deque(t._spans, maxlen=max(1, capacity))
    return t


@contextlib.contextmanager
def current_span_var_scope(ctx: Optional[SpanContext]):
    """Temporarily make ``ctx`` the ambient span context."""
    token = current_span_var.set(ctx)
    try:
        yield
    finally:
        current_span_var.reset(token)


# ---------------------------------------------------------------------------
# wire propagation
# ---------------------------------------------------------------------------
def wire_context() -> Optional[List[Optional[str]]]:
    """Current span context as the compact wire form, or None."""
    cur = current_span_var.get()
    return cur.to_wire() if cur is not None else None


def extract_wire(v: Any, default_trace_id: Optional[str] = None
                 ) -> Optional[SpanContext]:
    """Span context from a wire field; falls back to a parentless context on
    ``default_trace_id`` (the request id) so a request that carries no trace
    field still stitches its spans into the right trace."""
    ctx = SpanContext.from_wire(v)
    if ctx is None and default_trace_id:
        ctx = SpanContext(default_trace_id, None)
    return ctx


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------
def merge_spans(*groups: List[Span]) -> List[Span]:
    """Merge span lists (local ring + store fetch), dedupe by span id,
    order by start time."""
    by_id: Dict[str, Span] = {}
    for g in groups:
        for s in g:
            by_id.setdefault(s.span_id, s)
    return sorted(by_id.values(), key=lambda s: (s.start, s.end))


def to_chrome_trace(spans: List[Span]) -> Dict[str, Any]:
    """Chrome trace-event JSON: complete ("X") events, one pid per
    (component, os pid) so Perfetto renders one track per process."""
    procs: Dict[Tuple[str, int], int] = {}
    events: List[Dict[str, Any]] = []
    for s in spans:
        key = (s.component, s.pid)
        if key not in procs:
            procs[key] = len(procs) + 1
            events.append({"name": "process_name", "ph": "M",
                           "pid": procs[key], "tid": 0,
                           "args": {"name": f"{s.component} (pid {s.pid})"}})
    for s in spans:
        events.append({
            "name": s.name, "cat": "dynamo", "ph": "X",
            "ts": round(s.start * 1e6, 3),
            "dur": round(s.duration * 1e6, 3),
            "pid": procs[(s.component, s.pid)], "tid": 0,
            "args": {"trace_id": s.trace_id, "span_id": s.span_id,
                     "parent_id": s.parent_id, "status": s.status,
                     **s.attrs},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# cross-process span export over the dynstore
# ---------------------------------------------------------------------------
class StoreSpanSink:
    """Batches finished spans and writes them to the store under
    ``traces/{trace_id}/{span_id}``, bound to a fresh no-keepalive TTL lease
    per flush — traces expire after ``ttl`` seconds instead of accumulating,
    and survive the producing worker's death until then.

    Fleet-safe: ``sample`` (default ``DYN_TRACE_SAMPLE``) applies
    trace-id-consistent **head sampling** to what reaches the store —
    at 1000 workers an unsampled span plane is a write-rate DDoS on the
    coordination store. Error/deadline/breaker spans (:func:`force_keep`)
    are exported regardless, and force-retain the rest of their trace:
    spans of that trace still in the local ring are retro-enqueued and
    later spans of it are kept, so ``GET /v1/traces/{id}`` shows the whole
    picture for every failed request. Sampled-out spans stay in the local
    ring (``dyn_spans_sampled_out_total`` counts them); the retain-on-
    outage buffer is bounded drop-oldest with ``dyn_spans_dropped_total``
    counting evictions."""

    def __init__(self, store, ttl: float = 600.0,
                 flush_interval: float = 0.25, max_batch: int = 256,
                 max_pending: int = 8192, sample: Optional[float] = None):
        self.store = store
        self.ttl = ttl
        self.flush_interval = flush_interval
        self.max_batch = max_batch
        self.sample = sample_rate() if sample is None else \
            min(max(float(sample), 0.0), 1.0)
        # bounded, drop-oldest: a store outage must not grow memory forever
        self._pending: deque = deque(maxlen=max_pending)
        # traces force-retained by an error span (bounded FIFO of ids)
        self._forced: Set[str] = set()
        self._forced_order: deque = deque()
        self._task = None
        self._tracer: Optional[Tracer] = None
        self._loop = None
        self._lease: Optional[int] = None
        self._lease_born = 0.0

    FORCED_LIMIT = 1024   # remembered force-retained trace ids

    async def start(self, tracer: Optional[Tracer] = None) -> "StoreSpanSink":
        import asyncio

        self._loop = asyncio.get_running_loop()
        # NOT `tracer or get_tracer()`: Tracer defines __len__, so a
        # tracer with zero recorded spans is falsy and would silently
        # bind the sink to the process-global tracer instead
        self._tracer = tracer if tracer is not None else get_tracer()
        self._tracer.add_sink(self._on_finish)
        self._task = asyncio.create_task(self._flush_loop())
        return self

    async def stop(self) -> None:
        import asyncio

        if self._tracer is not None:
            self._tracer.remove_sink(self._on_finish)
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                if not self._task.cancelled():
                    raise   # OUR task was cancelled, not the flush loop
            # dynalint: ok(swallowed-exception) reaping our own cancelled
            # flush loop; per-flush errors were logged as they happened
            except Exception:
                pass
        # final drain: flush() caps at max_batch per call, so loop until
        # empty — short-lived runs must not lose their tail of spans
        while await self.flush():
            pass

    def _on_finish(self, span: Span) -> None:
        # may fire on the engine thread: deque.append is atomic, the flush
        # loop drains from the asyncio side
        from .prometheus import stage_metrics

        if not trace_sampled(span.trace_id, self.sample) \
                and span.trace_id not in self._forced:
            if not force_keep(span):
                stage_metrics().spans_sampled_out.inc()
                return
            # an error span in an unsampled trace: retain the WHOLE trace
            # from here on, and retro-enqueue what the local ring still
            # holds of it (store writes are keyed by span id — re-sends
            # after a later error are idempotent overwrites, not dupes)
            self._force_trace(span.trace_id, exclude=span.span_id)
        self._enqueue(span)

    def force_trace(self, trace_id: str) -> None:
        """Retro-export ``trace_id`` regardless of the sampling decision:
        spans of it still in the local ring are enqueued now, later ones
        are force-retained. The incident plane (obs/incidents.py) calls
        this so a bundle's trace is complete even at 1% head sampling."""
        self._force_trace(trace_id)

    def _force_trace(self, trace_id: str, exclude: str = "") -> None:
        self._forced.add(trace_id)
        self._forced_order.append(trace_id)
        while len(self._forced_order) > self.FORCED_LIMIT:
            self._forced.discard(self._forced_order.popleft())
        if self._tracer is not None:
            for prior in self._tracer.spans_for(trace_id):
                if prior.span_id != exclude:
                    self._enqueue(prior)

    def _enqueue(self, span: Span) -> None:
        from .prometheus import stage_metrics

        if self._pending.maxlen is not None \
                and len(self._pending) >= self._pending.maxlen:
            # deque drop-oldest is about to evict: a store outage has
            # outlasted the retain buffer — count the loss
            stage_metrics().spans_dropped.inc()
        self._pending.append(span)

    async def flush(self) -> int:
        """Write everything pending; returns the number of spans written."""
        if not self._pending:
            return 0
        # one no-keepalive lease rotated at ttl/2 (not one per flush —
        # steady streaming flushes every interval and would otherwise pile
        # up ~ttl/interval live leases per worker in the store). Spans ride
        # a lease at most ttl/2 old, so they expire within [ttl/2, ttl].
        # Granted BEFORE popping the batch: a failed grant must not cost
        # spans.
        now = time.monotonic()
        if self._lease is None or now - self._lease_born > self.ttl / 2:
            # unbound: exported spans must survive the producing worker's
            # death until their TTL — that is when they matter most
            self._lease = await self.store.lease_grant(ttl=self.ttl,
                                                       auto_keepalive=False,
                                                       bind=False)
            self._lease_born = now
        lease = self._lease
        batch: List[Span] = []
        while self._pending and len(batch) < self.max_batch:
            batch.append(self._pending.popleft())
        if not batch:
            return 0
        written = 0
        try:
            for s in batch:
                await self.store.put(trace_store_key(s.trace_id, s.span_id),
                                     json.dumps(s.to_dict()).encode(),
                                     lease=lease)
                written += 1
        except BaseException as e:
            # transient store failure: put the unwritten tail back at the
            # front (original order) so the next flush retries it. If new
            # spans refilled the deque meanwhile, extendleft on a full
            # deque would silently evict the NEWEST from the right —
            # inverted policy, uncounted loss. Keep drop-oldest instead:
            # shed the head of the tail (the oldest spans overall) and
            # count them.
            from .prometheus import stage_metrics

            tail = batch[written:]
            if self._pending.maxlen is not None:
                overflow = len(tail) - (self._pending.maxlen
                                        - len(self._pending))
                if overflow > 0:
                    stage_metrics().spans_dropped.inc(amount=overflow)
                    tail = tail[overflow:]
            self._pending.extendleft(reversed(tail))
            # a restarted (empty) store no longer knows our no-keepalive
            # lease: drop it so the next flush re-grants instead of
            # stalling spans until the ttl/2 rotation
            if getattr(e, "code", "") in ("lease_not_found", "conn_lost"):
                self._lease = None
            raise
        return written

    async def _flush_loop(self) -> None:
        import asyncio

        while True:
            try:
                await self.flush()
            except asyncio.CancelledError:
                raise
            except Exception:
                # store hiccups must not kill the process; spans are
                # retained and the next tick retries
                log.debug("span flush failed; retrying next tick",
                          exc_info=True)
            await asyncio.sleep(self.flush_interval)


async def fetch_trace_spans(store, trace_id: str) -> List[Span]:
    """All spans of one trace published to the store by any process."""
    out: List[Span] = []
    for _key, value in await store.get_prefix(
            f"{TRACE_STORE_PREFIX}{trace_id}/"):
        try:
            out.append(Span.from_dict(json.loads(value.decode())))
        except Exception:
            # one corrupt span record must not hide the rest of the trace
            log.debug("skipping undecodable span under trace %s",
                      trace_id, exc_info=True)
            continue
    return out
