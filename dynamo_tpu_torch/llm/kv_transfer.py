

from __future__ import annotations

import asyncio
import logging
import os
import threading
import time
from typing import AsyncIterator, Callable, Dict, Optional, Tuple

import numpy as np

from ..obs import flightrec as _flightrec
from ..obs import incidents as _incidents
from ..obs.flows import record_flow
from ..runtime.component import Client, StreamingRequest
from ..runtime.engine import Context
from ..utils.knobs import env_float
from ..utils.prometheus import stage_metrics
from ..utils.tracing import extract_wire, get_tracer, wire_context

log = logging.getLogger("dynamo_tpu_torch.kv_transfer")

KV_RECEIVE_ENDPOINT = "kv_receive"

#: per-pair bandwidth source label for senders that are not addressable
#: workers (the anonymous prefill-worker pool behind the queue)
ANON_SRC = "q"


def stream_enabled() -> bool:
    """``DYN_KV_STREAM`` (default on): layer-streamed ingest of disagg KV
    pushes. ``0`` restores the legacy full-arrival import — the bench
    harness's A/B switch."""
    return os.environ.get("DYN_KV_STREAM", "1").lower() in (
        "1", "true", "yes", "on")


#: wire dtype names the codec reads, and the numpy storage of each
_WIRE_DTYPES = {"bfloat16": np.dtype(np.uint16),
                "float32": np.dtype(np.float32),
                "float16": np.dtype(np.float16)}


def wire_dtype(name: str) -> np.dtype:
    """numpy storage of a meta header's ``dtype``: ``uint16`` bits for
    ``"bfloat16"``, the named type for ``"float32"``/``"float16"``."""
    try:
        return _WIRE_DTYPES[name]
    except KeyError:
        raise KvStreamError("bad_dtype",
                            f"unsupported KV dtype {name!r}") from None


def wire_dtype_name(dtype) -> str:
    """The meta header's ``dtype`` for arrays of numpy ``dtype``: a
    ``uint16`` array holds bf16 bits and travels as ``"bfloat16"``."""
    dtype = np.dtype(dtype)
    if dtype == np.uint16:
        return "bfloat16"
    return str(dtype)


# ---------------------------------------------------------------------------
# per-(src,dst) transfer bandwidth (receiver-side EWMA)
# ---------------------------------------------------------------------------

_pair_bw: Dict[Tuple[str, str], float] = {}
_pair_lock = threading.Lock()


def observe_pair_bw(src: str, dst: str, nbytes: int,
                    seconds: float) -> None:
    """Fold one observed transfer into the (src,dst) bandwidth EWMA and
    export it as ``llm_kv_pair_bw_bytes_per_s`` — the series the JAX
    router's transfer-cost model reads back out of the merged stage dumps
    (the port's router gains that term with the KV cluster, ROADMAP Queue
    1 item 8)."""
    if nbytes <= 0 or seconds <= 0:
        return
    alpha = env_float("DYN_KV_BW_ALPHA", 0.3, minimum=0.0)
    alpha = min(alpha, 1.0)
    bw = nbytes / seconds
    with _pair_lock:
        prev = _pair_bw.get((src, dst))
        cur = bw if prev is None else alpha * bw + (1.0 - alpha) * prev
        _pair_bw[(src, dst)] = cur
    stage_metrics().kv_pair_bw.set(src, dst, value=cur)
    # EWMA snapshot into the flight-recorder ring: an incident bundle
    # shows what bandwidth the placement signals were actually seeing
    _flightrec.note_event("kv.pair_bw", src=src, dst=dst,
                          bw=round(cur), sample_bw=round(bw))


# ---------------------------------------------------------------------------
# the layer-major codec assembler (disagg push + cluster fetch share it)
# ---------------------------------------------------------------------------

class RemotePrefillError(RuntimeError):
    pass


class KvStreamError(RemotePrefillError):
    """A KV stream violated the layer-major codec or tore mid-flight.
    Subclasses :class:`RemotePrefillError` so every waiter's existing
    typed-fallback path (local prefill) handles it unchanged."""

    def __init__(self, reason: str, detail: str):
        super().__init__(f"kv stream {reason}: {detail}")
        self.reason = reason


class LayerStream:
    """Incremental assembler for the layer-major two-part codec: 2·L
    parts, layer k then layer v, strictly in layer order. ``sink(layer,
    k, v)`` fires the moment a layer's pair is complete — while later
    layers are still in flight. :meth:`close` enforces completeness;
    every violation is a typed :class:`KvStreamError` naming the reason
    (the fallback counters' label)."""

    def __init__(self, layers: int,
                 sink: Callable[[int, np.ndarray, np.ndarray], None]):
        self.layers = int(layers)
        self.sink = sink
        self._i = 0
        self._k: Optional[np.ndarray] = None

    @property
    def parts_fed(self) -> int:
        return self._i

    @property
    def complete(self) -> bool:
        return self._i == 2 * self.layers

    def feed(self, arr: np.ndarray) -> None:
        """One wire part in arrival order (positional layer index)."""
        layer, is_v = divmod(self._i, 2)
        if layer >= self.layers:
            raise KvStreamError(
                "over_count",
                f"part {self._i} beyond {2 * self.layers} expected")
        if not is_v:
            self._k = arr
        else:
            k, self._k = self._k, None
            self.sink(layer, k, arr)
        self._i += 1

    def feed_layer(self, layer: int, k: np.ndarray,
                   v: np.ndarray) -> None:
        """Explicit-index entry point (sender-declared layer indices):
        the codec is strictly in-order, so a skipped or repeated index is
        a torn stream, not a reordering to tolerate."""
        if self._i % 2 or layer != self._i // 2:
            raise KvStreamError(
                "out_of_order",
                f"layer {layer} arrived at codec position {self._i}")
        self.feed(k)
        self.feed(v)

    def close(self) -> None:
        if not self.complete:
            raise KvStreamError(
                "truncated",
                f"got {self._i}/{2 * self.layers} parts")


def _meta(request_id: str, first_token: int, first_logprob: float,
          k: np.ndarray, src_worker: Optional[int] = None) -> dict:
    L, T, H, D = k.shape
    return {
        "request_id": request_id,
        "first_token": int(first_token),
        "first_logprob": float(first_logprob),
        "layers": int(L), "tokens": int(T),
        "kv_heads": int(H), "head_dim": int(D),
        "dtype": wire_dtype_name(k.dtype),
        # sender identity for the receiver's per-pair bandwidth EWMA
        # (absent/0 = the anonymous prefill pool)
        "src": f"{src_worker:x}" if src_worker else ANON_SRC,
        # span context rides the meta header (not just the wire control) so
        # the receive side stitches even on planes that drop control fields
        "trace": wire_context(),
    }


async def push_kv(client: Client, decode_worker_id: int, request_id: str,
                  first_token: int, first_logprob: float,
                  k: np.ndarray, v: np.ndarray,
                  context: Optional[Context] = None,
                  src_worker: Optional[int] = None) -> dict:
    """Stream a sequence's prompt KV ([L,T,Hkv,Dh] each) to the decode
    worker that owns ``request_id``. Returns the receiver's ack."""
    meta = _meta(request_id, first_token, first_logprob, k, src_worker)
    nbytes = k.nbytes + v.nbytes

    async def parts() -> AsyncIterator[bytes]:
        from ..utils import faults

        for layer in range(k.shape[0]):
            # chaos hook: kill/stall the KV stream mid-flight (per part)
            await faults.fire("kv.push.part")
            yield k[layer].tobytes()
            yield v[layer].tobytes()

    stage = stage_metrics()
    ack = None
    async with get_tracer().span("kv.push", trace_id=request_id,
                                 bytes=nbytes, tokens=meta["tokens"],
                                 layers=meta["layers"]):
        # restamp inside the scope so the receiver's kv.receive span
        # parents under kv.push, not under this function's caller
        meta["trace"] = wire_context()
        t0 = time.monotonic()
        async for resp in client.generate(meta, context, mode="direct",
                                          instance_id=decode_worker_id,
                                          parts=parts()):
            ack = resp
        elapsed = time.monotonic() - t0
        stage.kv_transfer.observe("send", value=elapsed)
        stage.kv_transfer_bytes.inc("send", amount=nbytes)
        record_flow("disagg_push", nbytes, elapsed,
                    src=meta["src"], dst=f"{decode_worker_id:x}",
                    trace_id=request_id)
    return ack or {}


async def _cancel_quietly(queue, request_id: str) -> None:
    """Tombstone a queued job, best-effort: a store mid-outage must not
    mask the caller's own outcome (timeout / client stop)."""
    try:
        await queue.cancel(request_id)
    except Exception:  # noqa: BLE001
        log.debug("prefill cancel tombstone for %s failed (store down?)",
                  request_id)


def _discard_streamed(fut: asyncio.Future) -> None:
    """A future that resolved while its waiter was giving up may hold a
    streamed-ingest handle whose sequence ALREADY entered decode; the
    waiter will never consume it, so the orphan must be cancelled (a
    buffered tuple result needs nothing — it's just host arrays)."""
    if not fut.done() or fut.cancelled() or fut.exception() is not None:
        return
    discard = getattr(fut.result(), "discard", None)
    if discard is not None:
        try:
            discard()
        except Exception:  # noqa: BLE001 - cleanup must not mask outcome
            log.exception("streamed-ingest discard failed")


async def await_remote_kv(ctx: Context, fut: asyncio.Future, queue,
                          receiver: "KvReceiver",
                          remote_timeout: float):
    """Decode-side wait for the remotely computed KV, racing client-stop,
    the request's end-to-end deadline, and the fallback timeout. Returns
    the KV tuple (buffered mode), a streamed-ingest handle (the sequence
    is already entering decode — consume it with
    ``engine.generate_streamed``), or None => fall back to local prefill.
    An expired deadline raises a 504 naming the stage
    (``decode_kv_wait``) — there is no point prefilling locally for a
    caller that already timed out."""
    from ..runtime import deadline as dl

    stop = asyncio.ensure_future(ctx.stopped())
    try:
        timeout = remote_timeout
        rem = dl.remaining(ctx.deadline)
        deadline_first = rem is not None and rem < timeout
        if deadline_first:
            timeout = rem
        done, _ = await asyncio.wait(
            {fut, stop}, timeout=timeout,
            return_when=asyncio.FIRST_COMPLETED)
        if fut in done:
            return fut.result()  # may raise RemotePrefillError
        if stop in done:
            await _cancel_quietly(queue, ctx.id)
            _discard_streamed(fut)
            raise asyncio.CancelledError
        # tombstone the queued job so a prefill worker doesn't burn a
        # full prompt prefill on KV nobody will accept. The await can
        # let the in-flight stream FINISH (and a streamed ingest enter
        # decode): re-check the future after it — a race the outcome
        # branches below must each resolve, never leak
        await _cancel_quietly(queue, ctx.id)
        if deadline_first or dl.expired(ctx.deadline):
            _discard_streamed(fut)
            raise dl.expire("decode_kv_wait", ctx.deadline)
        if fut.done() and not fut.cancelled() \
                and fut.exception() is None:
            # the arrival won the race against the tombstone write:
            # serve the completed transfer instead of discarding it
            return fut.result()
        log.warning("remote prefill for %s timed out after %.0fs; "
                    "prefilling locally", ctx.id, remote_timeout)
        return None
    finally:
        stop.cancel()
        receiver.abandon(ctx.id)


async def push_kv_error(client: Client, decode_worker_id: int,
                        request_id: str, message: str) -> None:
    """Tell the decode worker its remote prefill failed permanently so the
    parked request errors out instead of waiting forever."""
    meta = {"request_id": request_id, "error": message}

    async def no_parts() -> AsyncIterator[bytes]:
        return
        yield  # pragma: no cover

    # dynalint: ok(flow-accounting) zero-byte error signal — the stream
    # carries no KV payload, there are no bytes to meter
    async for _ in client.generate(meta, mode="direct",
                                   instance_id=decode_worker_id,
                                   parts=no_parts()):
        pass


class KvReceiver:
    """Decode-worker side: collects streamed KV for requests this worker
    parked while their prefill ran remotely.

    Two ingest modes per request:

    - **streamed** (``DYN_KV_STREAM`` + an ingest handle registered via
      :meth:`expect`): layer pairs are forwarded to the engine the moment
      they complete, the future resolves to the ingest handle once the
      final scatter is enqueued, and any mid-stream failure aborts the
      engine-side ingest (pool pages released unseen) before the waiter
      is failed over to local prefill;
    - **buffered** (legacy / no handle / handle declined the geometry):
      the full [L,T,Hkv,Dh] arrays assemble in host memory and the future
      resolves to ``(k, v, first_token, first_logprob)`` after the last
      part, exactly the old contract.
    """

    def __init__(self, worker_id: int = 0) -> None:
        self._pending: Dict[str, asyncio.Future] = {}
        self._ingests: Dict[str, object] = {}
        self._dst = f"{worker_id:x}" if worker_id else str(os.getpid())

    def expect(self, request_id: str,
               ingest: Optional[object] = None) -> asyncio.Future:
        """Register interest; the future resolves to
        (k, v, first_token, first_logprob) — or to ``ingest`` itself when
        the arrival was streamed straight into the engine through it."""
        fut = asyncio.get_running_loop().create_future()
        self._pending[request_id] = fut
        if ingest is not None:
            self._ingests[request_id] = ingest
        return fut

    def abandon(self, request_id: str) -> None:
        """Waiter gave up (timeout / deadline / client stop) or is done
        consuming. A BEGUN-but-unfinished ingest must be aborted HERE,
        before the caller's local-prefill fallback resubmits the same
        seq_id: the abort rides the engine's FIFO inbox ahead of the
        resubmit, so the half-streamed pool sequence is released first
        (``KvIngest.abort`` is a no-op for finished/never-begun ingests,
        so the success path's abandon leaves the live stream alone)."""
        ingest = self._ingests.pop(request_id, None)
        if ingest is not None:
            try:
                ingest.abort()
            except Exception:  # noqa: BLE001 - cleanup must not mask
                log.exception("kv ingest abort failed for %s", request_id)
        fut = self._pending.pop(request_id, None)
        if fut is not None and not fut.done():
            fut.cancel()

    def _fail(self, rid: str, ingest, exc: KvStreamError) -> None:
        """Torn-stream cleanup: abort the engine-side ingest FIRST (the
        partially-scattered pool pages release before any waiter can
        race a local prefill into the same engine), then fail the waiter
        over to local prefill and count the reason."""
        if ingest is not None:
            try:
                ingest.abort()
            except Exception:  # noqa: BLE001 - cleanup must not mask
                log.exception("kv ingest abort failed for %s", rid)
        stage_metrics().kv_stream_fallbacks.inc(exc.reason)
        _flightrec.note_event("kv.torn", rid=rid, reason=exc.reason)
        # a torn disagg stream is an incident trigger: every process that
        # touched this request freezes and dumps its rings
        _incidents.trigger("torn_stream", trace_id=rid, cause=exc.reason)
        fut = self._pending.pop(rid, None)
        self._ingests.pop(rid, None)
        if fut is not None and not fut.done():
            fut.set_exception(exc)

    async def handler(self, request: StreamingRequest, ctx: Context):
        meta = request.meta
        rid = meta["request_id"]
        if meta.get("error"):
            async for _ in request.parts:
                pass
            self._ingests.pop(rid, None)
            fut = self._pending.pop(rid, None)
            if fut is not None and not fut.done():
                fut.set_exception(RemotePrefillError(meta["error"]))
            yield {"ok": True}
            return
        L, T = meta["layers"], meta["tokens"]
        H, D = meta["kv_heads"], meta["head_dim"]
        dtype = wire_dtype(meta["dtype"])
        fut = self._pending.get(rid)
        ingest = self._ingests.get(rid) if stream_enabled() else None
        if ingest is not None and (fut is None or fut.done()
                                   or not ingest.begin(meta)):
            # waiter gone, or the engine declined the stream's geometry:
            # assemble buffered (the legacy path validates/fails later)
            ingest = None
        k = v = None
        if ingest is None:
            k = np.empty((L, T, H, D), dtype)
            v = np.empty((L, T, H, D), dtype)

            def sink(layer: int, ka: np.ndarray, va: np.ndarray) -> None:
                k[layer] = ka
                v[layer] = va
        else:
            def sink(layer: int, ka: np.ndarray, va: np.ndarray) -> None:
                ingest.layer(layer, ka, va)
        stream = LayerStream(L, sink)
        nbytes = 0
        t0 = time.monotonic()
        recv_span = get_tracer().start_span(
            "kv.receive", parent=extract_wire(meta.get("trace"), rid),
            request_id=rid, tokens=T, layers=L,
            streamed=ingest is not None)
        # watchdog heartbeat: an in-flight stream making no layer
        # progress inside the budget is a wedged transfer (stall:transfer)
        hb_name = f"kv.recv:{rid}"
        _flightrec.hb_begin(
            hb_name, stall="transfer", trace_id=rid,
            budget=env_float("DYN_WATCHDOG_TRANSFER", 5.0, minimum=0.1))
        try:
            async for part in request.parts:
                if fut is not None and fut.done():
                    # the waiter gave up mid-stream (deadline / client
                    # stop): abort the ingest and drain without feeding —
                    # no further pool writes for a request nobody owns
                    raise KvStreamError("abandoned",
                                        f"waiter for {rid} gone")
                stream.feed(np.frombuffer(part, dtype).reshape(T, H, D))
                nbytes += len(part)
                _flightrec.hb_progress(hb_name)
            stream.close()
        except KvStreamError as e:
            get_tracer().finish(recv_span, status="error")
            self._fail(rid, ingest, e)
            yield {"ok": False, "error": str(e)}
            return
        except BaseException as e:
            # transport tear (donor death mid-push): same cleanup, then
            # propagate so the plane surfaces the broken stream
            get_tracer().finish(recv_span, status="error")
            self._fail(rid, ingest, KvStreamError("torn", str(e)))
            raise
        finally:
            _flightrec.hb_end(hb_name)
        if recv_span is not None:
            recv_span.attrs["bytes"] = nbytes
        get_tracer().finish(recv_span)
        stage = stage_metrics()
        elapsed = time.monotonic() - t0
        stage.kv_transfer.observe("recv", value=elapsed)
        stage.kv_transfer_bytes.inc("recv", amount=nbytes)
        # the ledger feeds the per-pair EWMA (observe_pair_bw) itself —
        # one record accounts the link AND prices the router's pair
        record_flow("disagg_stream_rx", nbytes, elapsed,
                    src=meta.get("src") or ANON_SRC, dst=self._dst,
                    trace_id=rid)
        self._ingests.pop(rid, None)
        fut = self._pending.pop(rid, None)
        if fut is None or fut.done():
            if ingest is not None:
                # fully-arrived stream whose waiter vanished between the
                # last part and here: the ingest must not enter decode
                try:
                    ingest.abort()
                except Exception:  # noqa: BLE001
                    log.exception("kv ingest abort failed for %s", rid)
            log.warning("unexpected KV for request %s (client gone?)", rid)
            yield {"ok": False, "error": "no pending request"}
            return
        if ingest is not None:
            # the final scatter is ENQUEUED (engine thread drains the
            # command queue); resolve now — decode's first step chains on
            # the pool arrays by data dependency, no sync needed here
            ingest.finish(meta["first_token"], meta["first_logprob"])
            stage.kv_stream_ingests.inc()
            fut.set_result(ingest)
        else:
            fut.set_result((k, v, meta["first_token"],
                            meta["first_logprob"]))
        yield {"ok": True, "tokens": T, "streamed": ingest is not None}
