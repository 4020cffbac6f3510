"""Mid-stream failover: resumable generation.

A decode worker that dies or wedges mid-stream used to end the request
with a typed 503 — all prefill compute and every decoded token thrown
away. This module makes the stream *resumable*: the frontend-side engine
keeps a per-stream resume record (the prompt, every emitted token id, the
sampling seed, the original deadline) and on a stream break re-enters the
router with the dead instance excluded, up to ``DYN_RESUME_MAX`` attempts
inside the original deadline. The client sees a pause, not a 503.

The resume request carries ``prompt + emitted`` as the effective prefix
with ``resume_pos = len(emitted)``: the new worker reconstructs KV the
cheap way first — admission restores the longest surviving sealed prefix
from its tiers (cluster-fetched from the dead donor's host-tier mirror or
any other owner via :class:`~.kv_cluster.fetch.ClusterFetcher`) and
teacher-forces only the unsealed tail — falling back to full local
prefill when no donor survives. Greedy resume is token-identical to an
unkilled run (the forced prefix pins the argmax chain); sampled requests
replay the emitted prefix verbatim and re-seed their RNG stream at the
resume position (:func:`~..engine.sampling` fold), so a seeded stream
stays deterministic without pretending the dead worker's unreplayable
draws continued.

Break classes that resume (each is a provably-dead or wedged stream whose
re-dispatch cannot double-emit — the worker-side resume-supersede guard
kills a zombie context of the same id):

- transport break — the worker dropped the stream mid-response
  (typed 503, no machine reason) or spoke a malformed frame (502);
- inter-frame stall — no frame for ``DYN_RESUME_STALL`` seconds; the
  stalled instance also takes a circuit-breaker hit here (transport
  breaks are already counted inside ``Client.generate``).

Typed failures (overload sheds, router fast-fail, admission 4xx, deadline
504s) carry a machine ``reason`` and are never resumed — they are
decisions, not deaths. Exhausting the attempt budget raises a typed 503
``reason="resume_exhausted"``; the original deadline expiring mid-retry
raises the standard 504 naming stage ``stream_resume``. Outcomes count in
``dyn_stream_resumes_total{outcome}``; each successful resume observes
its client-visible pause in ``dyn_resume_latency_seconds``; the flight
recorder gets a ``stream.resume`` event per attempt so incident bundles
show the failover timeline.
"""

from __future__ import annotations

import asyncio
import copy
import logging
import time
from typing import AsyncIterator, Callable, List, Optional, Set

from ..obs.flightrec import note_event
from ..runtime import deadline as dl
from ..runtime.engine import Context, EngineError
from ..utils.knobs import env_float
from ..utils.prometheus import stage_metrics
from .protocols.common import BackendInput, EngineOutput, FinishReason

log = logging.getLogger("dynamo_tpu_torch.resume")

#: the stage name resume-layer errors (503 resume_exhausted, 504 expiry)
#: carry in the uniform error body
RESUME_STAGE = "stream_resume"

#: dispatch(request, context, exclude, resume_no, on_instance) -> stream;
#: one routed attempt (RemoteCoreEngine._dispatch_once is the production
#: implementation)
Dispatch = Callable[..., AsyncIterator[EngineOutput]]


def max_attempts() -> int:
    """``DYN_RESUME_MAX``: resume attempts per stream (0 disables
    mid-stream failover entirely — breaks surface as before)."""
    return int(env_float("DYN_RESUME_MAX", 2, minimum=0.0))


def stall_budget() -> float:
    """``DYN_RESUME_STALL``: seconds without a frame before a live
    connection is declared wedged (0 disables the stall detector; breaks
    then require a transport-level failure). Inter-frame, so it bounds the
    longest decode-step gap, not total stream duration — and it must stay
    well above the worst legitimate prefill time."""
    return env_float("DYN_RESUME_STALL", 30.0, minimum=0.0)


def resumable(e: BaseException) -> bool:
    """A break worth resuming: transport-class 502/503 with no machine
    ``reason``. Typed decisions (overload sheds, router fast-fail,
    quota rejects — all reason-carrying) and deadline 504s are final."""
    return (isinstance(e, EngineError)
            and e.code in (502, 503)
            and getattr(e, "reason", None) is None)


def _resume_request(orig: BackendInput, base_tokens: List[int],
                    emitted: List[int], orig_max: Optional[int],
                    orig_min: Optional[int]) -> BackendInput:
    """The re-entry request: prompt + emitted as the effective prefix,
    token budgets re-derived from the ORIGINAL grant (the dead worker's
    output already spent part of it). The stale donor stamp is cleared —
    the re-election routes against the post-death registry."""
    req = copy.copy(orig)
    req.stop = copy.copy(orig.stop)
    req.token_ids = list(base_tokens) + list(emitted)
    req.resume_pos = len(emitted)
    if orig_max is not None:
        req.stop.max_tokens = orig_max - len(emitted)
    if orig_min:
        req.stop.min_tokens = max(0, orig_min - len(emitted))
    req.kv_donor = 0
    req.kv_donor_blocks = 0
    return req


async def _reap(agen) -> None:
    """Close a broken attempt's stream so its socket/tasks release before
    the next attempt dispatches (never let teardown mask the break)."""
    aclose = getattr(agen, "aclose", None)
    if aclose is None:
        return
    try:
        await aclose()
    except Exception:  # noqa: BLE001 - the break already surfaced
        log.debug("broken stream close failed", exc_info=True)


async def run(dispatch: Dispatch, request: BackendInput, context: Context,
              breaker=None) -> AsyncIterator[EngineOutput]:
    """Drive ``dispatch`` to stream completion, transparently re-entering
    it on resumable breaks. ``breaker`` (the worker client's
    :class:`~..runtime.circuit_breaker.InstanceBreaker`) takes the hit
    for stall-class breaks."""
    stage = stage_metrics()
    base_tokens = list(request.token_ids)
    orig_max = request.stop.max_tokens
    orig_min = request.stop.min_tokens
    emitted: List[int] = []
    exclude: Set[int] = set()
    attempt = 0
    limit = max_attempts()
    stall = stall_budget()
    cur = {"iid": None}
    t_break: Optional[float] = None

    while True:
        agen = dispatch(request, context, exclude, attempt,
                        lambda iid: cur.__setitem__("iid", iid))
        broke: Optional[EngineError] = None
        stalled = False
        got_any = False
        try:
            it = agen.__aiter__()
            while True:
                try:
                    if stall:
                        item = await asyncio.wait_for(it.__anext__(), stall)
                    else:
                        # stall detector off: boundedness falls back to the
                        # deadline layer inside Client.generate
                        item = await it.__anext__()
                except StopAsyncIteration:
                    return
                except asyncio.TimeoutError:
                    stalled = True
                    break
                if attempt and not got_any:
                    # the replacement worker's first frame: the resume
                    # worked — the pause the client saw is the metric
                    stage.stream_resumes.inc("resumed")
                    if t_break is not None:
                        stage.resume_latency.observe(
                            value=time.monotonic() - t_break)
                    note_event("stream.resume", context=context.id,
                               attempt=attempt, outcome="resumed",
                               emitted=len(emitted))
                got_any = True
                if item.token_ids:
                    emitted.extend(item.token_ids)
                yield item
                if item.finish_reason is not None:
                    return
        except EngineError as e:
            if not resumable(e):
                await _reap(agen)
                raise
            broke = e

        # ---- the stream broke: decide whether / how to re-enter --------
        await _reap(agen)
        t_break = time.monotonic()
        attempt += 1
        iid = cur["iid"]
        cur["iid"] = None
        why = "stall" if stalled else f"break({broke.code})"
        if stalled and iid is not None and breaker is not None:
            # stall-class breaks feed the per-instance circuit breaker —
            # transport breaks already counted inside Client.generate, but
            # a wedged worker never errors the socket, so without this hit
            # it keeps receiving fresh streams until its lease dies
            breaker.record_failure(iid)
        if iid is not None:
            exclude.add(iid)
        note_event("stream.resume", context=context.id, attempt=attempt,
                   outcome="resuming", why=why, emitted=len(emitted),
                   instance=f"{iid:x}" if iid is not None else "?")
        if attempt > limit:
            stage.stream_resumes.inc("exhausted")
            note_event("stream.resume", context=context.id,
                       attempt=attempt, outcome="exhausted")
            raise EngineError(
                f"stream broke {attempt} time(s) (last: {why}); resume "
                f"budget DYN_RESUME_MAX={limit} exhausted", 503,
                stage=RESUME_STAGE, reason="resume_exhausted") from broke
        if dl.expired(context.deadline):
            # the retry loop re-derives remaining budget from the ORIGINAL
            # wire deadline — a resume never restarts the clock
            stage.stream_resumes.inc("expired")
            note_event("stream.resume", context=context.id,
                       attempt=attempt, outcome="expired")
            raise dl.expire(RESUME_STAGE, context.deadline) from broke
        if orig_max is not None and len(emitted) >= orig_max:
            # the dead worker emitted the full token budget but its finish
            # frame died with the connection: close the stream ourselves
            # instead of dispatching a zero-budget request
            yield EngineOutput(finish_reason=FinishReason.LENGTH)
            return
        log.warning("resuming stream %s (attempt %d/%d, %s on instance "
                    "%s, %d tokens emitted)", context.id, attempt, limit,
                    why, f"{iid:x}" if iid is not None else "?",
                    len(emitted))
        request = _resume_request(request, base_tokens, emitted,
                                  orig_max, orig_min)
