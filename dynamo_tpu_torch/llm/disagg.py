"""Disaggregated prefill/decode serving: queue, decision router, protocol.

The port's copy of the JAX package's ``llm/disagg.py``, with the same names,
store keys, queue names and JSON. The decode worker receives every request.
For long, cold prompts it enqueues a :class:`RemotePrefillRequest` on the
shared prefill queue (the store's work queue) instead of prefilling
locally; a prefill worker pulls the queue, computes the prompt KV on its
own card and pushes it layer by layer to the decode worker's
``kv_receive`` endpoint over the data plane (``llm/kv_transfer.py``). The
decode worker then enters the sequence straight into its decode batch.
Either package's workers and stores serve either package's queue.

The local-vs-remote decision and its live-reloadable threshold mirror the
reference's DisaggregatedRouter (lib/llm/src/disagg_router.rs:146-262:
``prefill_length - prefix_hit_length > max_local_prefill_length`` and queue
depth below ``max_prefill_queue_size``; etcd-watched config at
lib/llm/src/disagg_router.rs:38-143). The queue protocol mirrors
examples/llm/utils/nats_queue.py:27-150; the request shape mirrors the vLLM
patch's RemotePrefillRequest (patch:3716-3789).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..utils.overload import (OverloadError, PRIORITIES,
                              PRIORITY_INTERACTIVE, ServiceTimeEstimator,
                              should_shed)
from ..utils.prometheus import stage_metrics
from ..utils.tracing import extract_wire, get_tracer, wire_context

log = logging.getLogger("dynamo_tpu_torch.disagg")

DISAGG_CONFIG_PREFIX = "disagg/"  # store key: disagg/{namespace}/{model}


def disagg_config_key(namespace: str, model: str = "default") -> str:
    return f"{DISAGG_CONFIG_PREFIX}{namespace}/{model}"


def prefill_queue_name(namespace: str,
                       priority: str = PRIORITY_INTERACTIVE) -> str:
    """Per-priority queue names: interactive keeps the legacy name (old
    producers/consumers interoperate unchanged), batch gets a sibling."""
    base = f"{namespace}.prefill"
    if priority and priority != PRIORITY_INTERACTIVE:
        return f"{base}.{priority}"
    return base


def prefill_queue_names(namespace: str) -> List[str]:
    """Every priority's queue — depth readers (planner, dyntop) sum these."""
    return [prefill_queue_name(namespace, p) for p in PRIORITIES]


@dataclass
class RemotePrefillRequest:
    """One unit of prefill work handed from a decode worker to the queue.

    ``decode_worker_id`` lets the prefill worker route the computed KV back
    with direct addressing; ``request`` is the full BackendInput dict so the
    prefill engine can honour sampling for the first generated token.
    """

    request_id: str
    decode_worker_id: int
    request: Dict[str, Any]
    prefix_hit_tokens: int = 0
    attempts: int = 0
    # overload-control class: routes the job to its priority's queue;
    # consumers drain interactive strictly first
    priority: str = PRIORITY_INTERACTIVE
    # span context ([trace_id, parent_span_id]) + enqueue wall-clock: the
    # prefill worker parents its spans under the decode worker's and turns
    # the enqueue->dequeue gap into the queue-wait span/histogram
    trace: Optional[List[Optional[str]]] = None
    enqueued_at: float = 0.0
    # end-to-end deadline (absolute time.time()): a job that expires while
    # queued is acked-and-dropped at dequeue — never computed
    deadline: Optional[float] = None

    @property
    def expired(self) -> bool:
        return self.deadline is not None and time.time() >= self.deadline

    def to_bytes(self) -> bytes:
        return json.dumps(self.__dict__).encode()

    @classmethod
    def from_bytes(cls, b: bytes) -> "RemotePrefillRequest":
        return cls(**json.loads(b.decode()))


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        log.warning("ignoring malformed %s=%r", name, os.environ.get(name))
        return default


class PrefillQueue:
    """Shared work queue of RemotePrefillRequests over the store's queue
    plane. Unacked messages are redelivered when a prefill worker dies
    mid-job (at-least-once, like the durable JetStream pull consumer).

    Overload control (utils/overload.py):

    - one queue PER PRIORITY; :meth:`dequeue` drains interactive strictly
      before batch;
    - hard depth bounds (``DYN_PREFILL_QUEUE_MAX``, batch's lower
      ``DYN_PREFILL_QUEUE_MAX_BATCH``; 0 = unbounded) enforced at enqueue;
    - predictive shedding at enqueue: when queue depth x the observed
      per-item remote-prefill service time already exceeds the job's
      remaining deadline, the enqueue raises :class:`OverloadError` in
      milliseconds instead of queueing work that is doomed to expire —
      the decode worker falls back to local prefill.
    """

    def __init__(self, store, namespace: str,
                 max_depth: Optional[int] = None,
                 max_depth_batch: Optional[int] = None):
        self.store = store
        self.namespace = namespace
        self.queue = prefill_queue_name(namespace)   # interactive/legacy
        self.queues = {p: prefill_queue_name(namespace, p)
                       for p in PRIORITIES}
        self.max_depth = _env_int("DYN_PREFILL_QUEUE_MAX", 0) \
            if max_depth is None else int(max_depth)
        if max_depth_batch is None:
            max_depth_batch = _env_int("DYN_PREFILL_QUEUE_MAX_BATCH",
                                       self.max_depth // 2)
        self.max_depth_batch = int(max_depth_batch)
        # observed full remote-prefill turnaround (decode-side), the
        # predictive shed's per-item service estimate
        self.service = ServiceTimeEstimator()
        self._pulls: Dict[str, asyncio.Task] = {}   # parked per-queue pulls
        self._msg_queue: Dict[int, str] = {}        # msg_id -> queue name

    def observe_service(self, seconds: float) -> None:
        self.service.observe(seconds)
        stage_metrics().stage_service.observe("prefill_remote",
                                              value=seconds)

    def _bound(self, priority: str) -> int:
        return self.max_depth_batch if priority != PRIORITY_INTERACTIVE \
            else self.max_depth

    async def enqueue(self, req: RemotePrefillRequest,
                      enforce_bounds: bool = True) -> int:
        qname = self.queues.get(req.priority, self.queue)
        if enforce_bounds:
            depth = await self.store.q_len(qname)
            if req.priority != PRIORITY_INTERACTIVE:
                # batch's (lower) bound counts TOTAL backlog: interactive
                # depth alone closes the door on batch — strictly prefer
                # interactive at every decision point
                depth += await self.store.q_len(self.queue)
            bound = self._bound(req.priority)
            svc = self.service.mean()
            if bound and depth >= bound:
                stage_metrics().queue_shed.inc("prefill_enqueue")
                raise OverloadError(
                    f"prefill queue full ({depth} >= {bound}, "
                    f"priority={req.priority})",
                    stage="prefill_enqueue", reason="queue_full",
                    retry_after=max(svc or 0.0, 0.05))
            remaining = None if req.deadline is None \
                else req.deadline - time.time()
            if should_shed(depth + 1, svc, remaining):
                stage_metrics().queue_shed.inc("prefill_enqueue")
                raise OverloadError(
                    f"prefill queue wait ~{(depth + 1) * (svc or 0):.2f}s "
                    f"exceeds the remaining deadline "
                    f"({remaining:.2f}s); shedding at enqueue",
                    stage="prefill_enqueue", reason="predicted_late",
                    retry_after=svc)
        if req.trace is None:
            req.trace = wire_context()
        if not req.enqueued_at:
            req.enqueued_at = time.time()
        return await self.store.q_push(qname, req.to_bytes())

    async def _pull_any(self) -> Tuple[int, bytes, str]:
        """One message from any priority queue, interactive strictly first.
        Keeps a PARKED pull per queue across calls (never cancelled mid-
        delivery — a cancelled pull could strand a delivered message until
        the connection closes); a message landing on the other queue's
        parked pull is simply returned by the next call."""
        while True:
            for p in PRIORITIES:
                q = self.queues[p]
                if q not in self._pulls:
                    self._pulls[q] = asyncio.ensure_future(
                        self.store.q_pull(q))
            tasks = [self._pulls[self.queues[p]] for p in PRIORITIES]
            # unbounded-ok: queue consumers park until work arrives by
            # design; drain cancels the dequeue() wrapper task
            await asyncio.wait(tasks, return_when=asyncio.FIRST_COMPLETED)
            for p in PRIORITIES:            # strict priority order
                q = self.queues[p]
                t = self._pulls.get(q)
                if t is not None and t.done():
                    del self._pulls[q]
                    exc = t.exception()
                    if exc is not None:
                        raise exc
                    msg_id, payload = t.result()
                    return msg_id, payload, q

    async def dequeue(self) -> tuple:
        """Blocks until work is available. Returns (msg_id, request);
        the caller MUST ack(msg_id) after the KV has been delivered.
        Jobs whose end-to-end deadline expired while queued are acked and
        dropped here — never handed to the engine (counted per stage in
        ``dyn_deadline_expiries_total{stage="prefill_dequeue"}``)."""
        while True:
            msg_id, payload, qname = await self._pull_any()
            self._msg_queue[msg_id] = qname
            req = RemotePrefillRequest.from_bytes(payload)
            if not req.expired:
                break
            await self.ack(msg_id)
            stage_metrics().deadline_expiries.inc("prefill_dequeue")
            log.info("dropping expired prefill job %s "
                     "(deadline passed while queued)", req.request_id)
        if req.enqueued_at:
            # queue wait, measured across processes on wall clocks (skew
            # bounds accuracy; clamp so a skewed clock never goes negative)
            now = time.time()
            wait = max(0.0, now - req.enqueued_at)
            stage_metrics().queue_wait.observe(value=wait)
            get_tracer().record(
                "prefill.queue_wait", start=min(req.enqueued_at, now),
                end=now,
                parent=extract_wire(req.trace,
                                    default_trace_id=req.request_id),
                request_id=req.request_id, attempts=req.attempts)
        return msg_id, req

    async def ack(self, msg_id: int) -> None:
        await self.store.q_ack(self._msg_queue.pop(msg_id, self.queue),
                               msg_id)

    async def size(self) -> int:
        total = 0
        for q in self.queues.values():
            total += await self.store.q_len(q)
        return total

    def close(self) -> None:
        """Cancel parked pulls (worker drain / tests). Any message a
        cancelled pull had already been handed is requeued when this
        client's store connection closes (at-least-once)."""
        for t in self._pulls.values():
            t.cancel()
        self._pulls.clear()

    # ------------------------------------------------------------------
    # cancellation: the submitter gave up (timeout / client gone). A
    # tombstone key lets prefill workers drop the job at dequeue instead of
    # computing KV nobody will accept.
    def _cancel_key(self, request_id: str) -> str:
        return f"{self.queue}/cancelled/{request_id}"

    async def cancel(self, request_id: str, ttl: float = 600.0) -> None:
        # TTL-leased so tombstones for jobs already dequeued (and thus never
        # consumed at dequeue) don't accumulate in the store forever
        lease = await self.store.lease_grant(ttl=ttl, auto_keepalive=False)
        await self.store.put(self._cancel_key(request_id), b"1", lease=lease)

    async def consume_cancelled(self, request_id: str) -> bool:
        """Check-and-clear the tombstone. True => drop the job unprocessed."""
        if await self.store.get(self._cancel_key(request_id)) is not None:
            await self.store.delete(self._cancel_key(request_id))
            return True
        return False


@dataclass
class DisaggConfig:
    max_local_prefill_length: int = 1000
    max_prefill_queue_size: int = 2

    def to_dict(self) -> Dict[str, int]:
        return dict(self.__dict__)


class DisaggRouter:
    """The local-vs-remote prefill decision, with the threshold live-reloaded
    from the store (set via ``dynamo-ctl disagg set``)."""

    def __init__(self, namespace: str, model: str = "default",
                 config: Optional[DisaggConfig] = None):
        self.namespace = namespace
        self.model = model
        self.config = config or DisaggConfig()

    def length_exceeds_local(self, prefill_length: int,
                             prefix_hit_length: int) -> bool:
        """Cheap first-stage check (no queue RPC needed)."""
        return (prefill_length - prefix_hit_length
                > self.config.max_local_prefill_length)

    def should_prefill_remote(self, prefill_length: int,
                              prefix_hit_length: int,
                              queue_size: int) -> bool:
        return (self.length_exceeds_local(prefill_length, prefix_hit_length)
                and queue_size < self.config.max_prefill_queue_size)

    # ------------------------------------------------------------------
    async def start(self, store) -> "DisaggRouter":
        """Load current config and watch the key for live updates."""
        key = disagg_config_key(self.namespace, self.model)

        async def on_change(k: str, value: Optional[bytes], deleted: bool):
            # prefix watch: ignore sibling models whose name extends ours
            if k == key and not deleted and value:
                self._apply(value)

        snapshot = await store.watch_prefix(key, on_change)
        for k, value in snapshot:
            if k == key:
                self._apply(value)
        return self

    def _apply(self, value: bytes) -> None:
        try:
            d = json.loads(value.decode())
            self.config = DisaggConfig(
                max_local_prefill_length=int(
                    d.get("max_local_prefill_length",
                          self.config.max_local_prefill_length)),
                max_prefill_queue_size=int(
                    d.get("max_prefill_queue_size",
                          self.config.max_prefill_queue_size)))
            log.info("disagg config updated: %s", self.config)
        except (ValueError, json.JSONDecodeError):
            log.warning("ignoring malformed disagg config: %r", value)


async def set_disagg_config(store, namespace: str, config: DisaggConfig,
                            model: str = "default") -> None:
    await store.put(disagg_config_key(namespace, model),
                    json.dumps(config.to_dict()).encode())
