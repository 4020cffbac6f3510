"""Disaggregated prefill and decode in the port, against the JAX package.

Module against module: the local-vs-remote decisions and the queue's JSON,
the prefill queue on either package's store, the layer-major codec's
errors, and the wire bytes of a KV push (f32, and bf16 travelling as
``uint16`` bits on the port's side, as ``ml_dtypes.bfloat16`` on JAX's).
Engine against engine (tiny-byte, f32 for token identity): a prompt
prefilled by ``prefill_extract`` and entered through ``inject_prefilled``
or a layer-streamed ``KvIngest`` streams the port's local greedy tokens,
which are the JAX engine's; a seeded sampled request streams the port's own
local seeded tokens; a bf16 JAX stream lands in the port's pool with the
bits JAX's inject writes into its own. Every torn-stream shape releases
its pages unseen, counts the JAX package's fallback reason, and leaves the
request to a local prefill. Last, the mixed fleet: a JAX prefill worker
feeds a torch decode worker and a torch prefill worker feeds a JAX decode
worker, each in one process on one store.

The engines are built once for the module (one each; the fleet's workers
are handed the same engines), so the file adds little time to the suite.
"""

import asyncio
import contextlib
import importlib
import json
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jl
from dynamo_tpu_torch.models import llama as tl

torch.set_num_threads(2)

J, T = PKGS = ("dynamo_tpu", "dynamo_tpu_torch")
PAGE = 8
# prefix reuse off: every prefill is cold, so streams compare exactly
ENGINE = dict(page_size=PAGE, max_batch=2, max_context=128, prefill_chunk=32,
              decode_steps=4, enable_prefix_reuse=False)
PROMPT = [int(t) for t in np.random.default_rng(10).integers(1, 250, 70)]
MAX_TOKENS = 8


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _bi(pkg, max_tokens=MAX_TOKENS, seed=None, temperature=0.0):
    c = _mod(pkg, "llm.protocols.common")
    return c.BackendInput(
        token_ids=list(PROMPT),
        stop=c.StopConditions(max_tokens=max_tokens, ignore_eos=True),
        sampling=c.SamplingOptions(temperature=temperature, seed=seed))


def _ctx(pkg, rid, **kw):
    return _mod(pkg, "runtime.engine").Context(rid, **kw)


async def _stream(agen):
    toks = []
    async for out in agen:
        assert out.error is None, out.error
        toks += out.token_ids
    return toks


def _parts(k, v, layers=None, extra=0, fail_at=None):
    """The push's 2·L wire parts (layer k then layer v), optionally cut
    after ``layers`` layers, with ``extra`` parts too many, or dying with
    a connection reset after ``fail_at`` parts."""
    async def gen():
        n = 0
        for layer in range(k.shape[0] if layers is None else layers):
            for arr in (k, v):
                if n == fail_at:
                    raise ConnectionResetError("donor died")
                yield arr[layer].tobytes()
                n += 1
        for _ in range(extra):
            yield k[0].tobytes()
    return gen()


async def _drive(pkg, receiver, meta, parts):
    SR = _mod(pkg, "runtime.component").StreamingRequest
    return [a async for a in receiver.handler(SR(meta, parts),
                                              _ctx(pkg, None))]


@pytest.fixture(scope="module")
def engines():
    """One f32 tiny-byte engine each, the port's on the JAX engine's
    weights."""
    from dynamo_tpu.engine.engine import JaxEngine, JaxEngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig

    jeng = JaxEngine(JaxEngineConfig(
        model=jl.preset("tiny-byte", dtype=jnp.float32), warmup=False,
        **ENGINE))
    params = jax.tree.map(np.asarray, jeng.core.params)
    cfg = TorchEngineConfig(model=tl.preset("tiny-byte", dtype=torch.float32),
                            device="cpu", **ENGINE)
    teng = TorchEngine(cfg, tl.params_from_jax(params, cfg.model,
                                               torch.device("cpu")))
    yield {J: jeng, T: teng}
    jeng.shutdown()
    teng.shutdown()


@pytest.fixture(scope="module")
def local(engines):
    """Each engine's local greedy stream of PROMPT."""
    async def go():
        return {pkg: await _stream(eng.generate(_bi(pkg),
                                                _ctx(pkg, f"local-{pkg}")))
                for pkg, eng in engines.items()}

    return asyncio.run(go())


@pytest.fixture(scope="module")
def donor(engines):
    """The port's prefill-worker half: PROMPT's KV and first token."""
    async def go():
        return await engines[T].prefill_extract(_bi(T), _ctx(T, "donor"))

    return asyncio.run(go())


# ---------------------------------------------------------------------------
# decisions, the queue's JSON, the queue on either store
# ---------------------------------------------------------------------------

# (max_local_prefill_length, max_prefill_queue_size, prompt, prefix hit,
#  queue depth, request fields)
DECISIONS = [
    (100, 2, 80, 0, 0, {}),
    (100, 2, 500, 0, 0, {"priority": "batch", "attempts": 2}),
    (100, 2, 500, 450, 0, {"prefix_hit_tokens": 450}),
    (100, 2, 500, 0, 2, {"trace": ["abc", "def"], "enqueued_at": 12.5}),
    (0, 1, 1, 0, 0, {"deadline": 1700000000.25}),
    (0, 1, 1, 1, 0, {"trace": ["abc", None], "priority": "batch"}),
]


@pytest.mark.parametrize("row", DECISIONS, ids=lambda r: f"{r[2]}-{r[3]}"
                         f"-{r[4]}")
def test_decisions_and_request_bytes_match_jax(row):
    mlp, mqs, n, hit, depth, fields = row
    got = {}
    for pkg in PKGS:
        d = _mod(pkg, "llm.disagg")
        r = d.DisaggRouter("ns", "m", config=d.DisaggConfig(mlp, mqs))
        req = d.RemotePrefillRequest(
            f"req-{n}", 0xabc0 + n, {"token_ids": list(range(n % 9)),
                                      "stop": {"max_tokens": 4}}, **fields)
        assert d.RemotePrefillRequest.from_bytes(req.to_bytes()) == req
        got[pkg] = (r.length_exceeds_local(n, hit),
                    r.should_prefill_remote(n, hit, depth), req.to_bytes(),
                    req.expired, d.disagg_config_key("ns", "m"),
                    d.prefill_queue_names("ns"),
                    d.prefill_queue_name("ns", fields.get("priority", "")),
                    d.DisaggConfig(mlp, mqs).to_dict())
    assert got[T] == got[J]


@pytest.mark.parametrize("store_pkg", [T, J], ids=["torch-store/jax-client",
                                                  "jax-store/torch-client"])
async def test_prefill_queue_across_packages(store_pkg):
    """The client package's queue and router against the other package's
    store; the store package's own queue consumes what it produced."""
    client_pkg = J if store_pkg == T else T
    d, o = _mod(client_pkg, "llm.disagg"), _mod(store_pkg, "llm.disagg")
    srv = _mod(store_pkg, "runtime.store_server").PyStoreServer()
    port = await srv.start()
    SC = {p: _mod(p, "runtime.store_client").StoreClient for p in PKGS}
    c1 = await SC[client_pkg](port=port).connect()
    c2 = await SC[store_pkg](port=port).connect()
    c3 = None
    try:
        q = d.PrefillQueue(c1, "ns")
        for rid, prio in (("b1", "batch"), ("i1", "interactive"),
                          ("b2", "batch")):
            await q.enqueue(d.RemotePrefillRequest(
                rid, 7, {"token_ids": [1, 2]}, priority=prio,
                trace=[None, None]))
        assert await q.size() == 3
        assert await o.PrefillQueue(c2, "ns").size() == 3
        # interactive strictly first, then batch in order
        order = []
        for _ in range(2):
            msg_id, job = await asyncio.wait_for(q.dequeue(), 5)
            order.append(job.request_id)
            await q.ack(msg_id)
        q.close()
        # the third job is taken, not acked, and its consumer dies: the
        # store redelivers it to a consumer of the other package
        c3 = await SC[client_pkg](port=port).connect()
        q3 = d.PrefillQueue(c3, "ns")
        _, job = await asyncio.wait_for(q3.dequeue(), 5)
        order.append(job.request_id)
        await c3.close()
        c3 = None
        oq = o.PrefillQueue(c2, "ns")
        msg_id, again = await asyncio.wait_for(oq.dequeue(), 5)
        assert (again.request_id, again.priority) == ("b2", "batch")
        await oq.ack(msg_id)
        oq.close()
        assert order == ["i1", "b1", "b2"]
        assert await q.size() == 0
        # the cancel tombstone, written by one package, read by the other
        await o.PrefillQueue(c2, "ns").cancel("gone")
        assert await q.consume_cancelled("gone") is True
        assert await q.consume_cancelled("gone") is False
        # the router's threshold reloads live from the other's write
        r = await d.DisaggRouter("ns").start(c1)
        assert r.config.max_local_prefill_length == 1000
        await o.set_disagg_config(c2, "ns", o.DisaggConfig(10, 7))
        for _ in range(100):
            if r.config.max_local_prefill_length == 10:
                break
            await asyncio.sleep(0.02)
        assert r.config.to_dict() == {"max_local_prefill_length": 10,
                                      "max_prefill_queue_size": 7}
    finally:
        for c in (c1, c2, c3):
            if c is not None:
                await c.close()
        await srv.stop()


# ---------------------------------------------------------------------------
# the codec and the wire
# ---------------------------------------------------------------------------

def _codec_errors(pkg, case):
    kt = _mod(pkg, "llm.kv_transfer")
    got = []
    ls = kt.LayerStream(2, lambda layer, k, v: got.append(layer))
    try:
        if case == "over_count":
            for p in range(5):
                ls.feed(f"p{p}")
        elif case == "out_of_order":
            ls.feed_layer(0, "k", "v")
            ls.feed_layer(0, "k", "v")
        else:
            ls.feed("k0")
            ls.feed("v0")
            ls.close()
    except kt.KvStreamError as e:
        assert isinstance(e, kt.RemotePrefillError)
        return got, ls.parts_fed, e.reason, str(e)
    return got, ls.parts_fed, None, None


@pytest.mark.parametrize("case", ["over_count", "out_of_order", "truncated"])
def test_layer_stream_errors_match_jax(case):
    got = {pkg: _codec_errors(pkg, case) for pkg in PKGS}
    assert got[T] == got[J]
    assert got[T][2] == case


class _Capture:
    """A client that records what a push sends."""

    async def generate(self, meta, context=None, mode=None,
                       instance_id=None, parts=None):
        self.meta, self.instance = meta, (mode, instance_id)
        self.parts = [p async for p in parts]
        yield {"ok": True}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
async def test_push_wire_bytes_match_jax(dtype):
    rng = np.random.default_rng(3)
    k, v = (rng.standard_normal((2, 13, 2, 16)).astype(np.float32)
            for _ in range(2))
    arrays = {J: (k, v), T: (k, v)}
    if dtype == "bfloat16":
        kb, vb = k.astype(ml_dtypes.bfloat16), v.astype(ml_dtypes.bfloat16)
        arrays = {J: (kb, vb), T: (kb.view(np.uint16), vb.view(np.uint16))}
    sent = {}
    for pkg in PKGS:
        kt = _mod(pkg, "llm.kv_transfer")
        cap = _Capture()
        ack = await kt.push_kv(cap, 0x77, "req-w", 42, -1.25, *arrays[pkg],
                               src_worker=0x99)
        meta = {f: x for f, x in cap.meta.items() if f != "trace"}
        sent[pkg] = (ack, meta, cap.instance, cap.parts,
                     {f: x for f, x in kt._meta("r", 1, 0.5, arrays[pkg][0])
                      .items() if f != "trace"})
    assert sent[T] == sent[J]
    assert sent[T][1]["dtype"] == dtype
    tkt = _mod(T, "llm.kv_transfer")
    np.testing.assert_array_equal(
        np.frombuffer(sent[T][3][2], tkt.wire_dtype(dtype)).reshape(13, 2, 16),
        arrays[T][0][1])
    with pytest.raises(tkt.KvStreamError, match="unsupported"):
        tkt.wire_dtype("int8")


# ---------------------------------------------------------------------------
# the engine: remote prefill streams the local tokens
# ---------------------------------------------------------------------------

async def test_remote_prefill_streams_the_local_greedy_tokens(engines, local,
                                                              donor):
    """prefill_extract -> inject_prefilled, and prefill_extract ->
    streamed KvIngest through the receiver: both stream the port's local
    greedy tokens, which are the JAX engine's."""
    from dynamo_tpu_torch.llm import kv_transfer as kt
    from dynamo_tpu_torch.obs.flows import flow_ledger
    from dynamo_tpu_torch.utils.prometheus import stage_metrics

    assert len(local[T]) == MAX_TOKENS and local[T] == local[J]
    eng = engines[T]
    core = eng.core
    k, v, tok, logp = donor
    L, n, H, D = k.shape
    assert (L, n, H, D, k.dtype) == (2, len(PROMPT), 2, 16, np.float32)
    assert tok == local[T][0]
    # the prefill engine's slot and pages are free again
    assert not core.by_seq and all(s is None for s in core.slots)
    assert core.pool.free_pages == core.pool.num_pages - 1
    # the same KV as the JAX engine's extract, within f32 rounding. Against
    # a float64 forward of the same weights each engine is off by at most
    # about 54 f32 ulps of the array's largest magnitude (|k|, |v| reach
    # 21), so the two may differ by up to twice that: the bound is 128
    # ulps at that magnitude, not an absolute figure a host's BLAS can
    # exceed
    jk, jv, jtok, _ = await engines[J].prefill_extract(_bi(J),
                                                      _ctx(J, "jdonor"))
    assert jtok == tok
    ulp = np.finfo(np.float32).eps
    for got, want in ((k, jk), (v, jv)):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=128 * ulp * np.abs(want).max())
    # one layer's gather is that layer of the whole one
    core.pool.create("one-layer")
    try:
        core.pool.extend("one-layer", PROMPT)
        for layer in range(L):
            lk, lv = core.extract_kv("one-layer", layer=layer, count=9)
            kk, vv = core.extract_kv("one-layer", count=9)
            np.testing.assert_array_equal(lk, kk[layer])
            np.testing.assert_array_equal(lv, vv[layer])
    finally:
        core.pool.release("one-layer")

    toks = await _stream(eng.generate_prefilled(
        _bi(T), _ctx(T, "inject-1"), k, v, tok, logp))
    assert toks == local[T]

    stage = stage_metrics()
    n0 = stage.kv_stream_ingests.get()
    rx0 = flow_ledger().total_bytes("disagg_stream_rx")
    rec = kt.KvReceiver(worker_id=0xd1)
    ctx = _ctx(T, "stream-1")
    ingest = eng.kv_ingest(_bi(T), ctx.id)
    fut = rec.expect(ctx.id, ingest=ingest)
    acks = await _drive(T, rec, kt._meta(ctx.id, tok, logp, k, 0xab),
                        _parts(k, v))
    assert acks == [{"ok": True, "tokens": len(PROMPT), "streamed": True}]
    assert (await fut) is ingest
    assert await _stream(eng.generate_streamed(_bi(T), ctx, ingest)) \
        == local[T]
    assert stage.kv_stream_ingests.get() == n0 + 1
    assert flow_ledger().total_bytes("disagg_stream_rx") \
        == rx0 + k.nbytes + v.nbytes
    # the ledger fed the per-pair bandwidth EWMA
    assert stage.kv_pair_bw.get("ab", "d1") > 0
    assert core.pool.free_pages == core.pool.num_pages - 1


@pytest.mark.parametrize("streamed", [False, True], ids=["inject",
                                                        "streamed"])
async def test_seeded_remote_prefill_streams_the_local_seeded_tokens(
        engines, streamed):
    """The decode engine draws the uniform the prefill engine spent on the
    first token, so a seeded sampled request streams, token for token, what
    a local prefill of it streams."""
    from dynamo_tpu_torch.llm import kv_transfer as kt

    eng = engines[T]
    kw = dict(seed=1234, temperature=0.9, max_tokens=12)
    want = await _stream(eng.generate(_bi(T, **kw), _ctx(T, "seed-local")))
    k, v, tok, logp = await eng.prefill_extract(_bi(T, **kw),
                                                _ctx(T, "seed-x"))
    assert tok == want[0]
    ctx = _ctx(T, f"seed-{streamed}")
    if streamed:
        rec = kt.KvReceiver()
        ingest = eng.kv_ingest(_bi(T, **kw), ctx.id)
        fut = rec.expect(ctx.id, ingest=ingest)
        await _drive(T, rec, kt._meta(ctx.id, tok, logp, k), _parts(k, v))
        got = await _stream(eng.generate_streamed(_bi(T, **kw), ctx,
                                                  await fut))
    else:
        got = await _stream(eng.generate_prefilled(_bi(T, **kw), ctx, k, v,
                                                   tok, logp))
    assert len(got) == 12 and got == want
    # an unseeded sampled request does not reproduce (its own seed source)
    assert want != await _stream(eng.generate(
        _bi(T, seed=1235, temperature=0.9, max_tokens=12),
        _ctx(T, "seed-other")))


def test_injected_slot_breaks_the_chained_window(engines, local, donor):
    """A sequence injected while a decode dispatch is in flight is a
    membership change: the next dispatch is not chained off the one in
    flight (its lane's first token is not on the device), and the
    injected stream is still the local one."""
    from dynamo_tpu_torch.engine.engine import EngineCore

    core = EngineCore(engines[T].core.cfg, engines[T].core.params)
    c = _mod(T, "llm.protocols.common")
    core.submit("busy", c.BackendInput(
        token_ids=list(range(1, 30)),
        stop=c.StopConditions(max_tokens=40, ignore_eos=True)))
    for _ in range(20):
        core.step()
        if len(core._inflight) == 1 and core._can_chain():
            break
    assert core._can_chain()
    k, v, tok, logp = donor
    first = core.inject_prefilled("injected", _bi(T), k, v, tok, logp)
    lane = next(i for i, s in enumerate(core.slots)
                if s is not None and s.seq_id == "injected")
    assert not core._can_chain()
    got, chained = [first.token], []
    while core.has_work:
        for so in core.step():
            if so.seq_id == "injected":
                got.append(so.token)
        rec = core._inflight[-1] if core._inflight else None
        if rec is not None and lane in {i for i, _, _ in rec["active"]} \
                and not chained:
            chained.append(rec["chained"])
    assert chained == [False]
    assert got == local[T]
    assert core.pool.free_pages == core.pool.num_pages - 1


# ---------------------------------------------------------------------------
# bf16 pool bits: a JAX push lands in the port's pool as JAX's inject
# writes it into its own
# ---------------------------------------------------------------------------

class _CoreIngest:
    """The receiver's ingest interface straight onto an EngineCore (no
    engine thread), so the pool is read right after the last layer."""

    def __init__(self, core, request, seq_id):
        self.core, self.request, self.seq_id = core, request, seq_id

    def begin(self, meta):
        self.core.begin_stream_inject(self.seq_id, self.request)
        return True

    def layer(self, layer, k, v):
        self.core.stream_inject_layer(self.seq_id, layer, k, v)

    def finish(self, tok, logp):
        self.first = self.core.finish_stream_inject(self.seq_id, tok, logp)

    def abort(self):
        self.core.abort_stream_inject(self.seq_id)


class _Loopback:
    """A client whose push goes straight into a receiver's handler."""

    def __init__(self, pkg, receiver):
        self.pkg, self.receiver = pkg, receiver

    async def generate(self, meta, context=None, mode=None,
                       instance_id=None, parts=None):
        meta = json.loads(json.dumps(meta))           # as on the wire
        async for ack in self.receiver.handler(
                _mod(self.pkg, "runtime.component").StreamingRequest(
                    meta, parts), _ctx(self.pkg, None)):
            yield ack


@pytest.fixture(scope="module")
def bf16_cores():
    from dynamo_tpu.engine.engine import EngineCore as JaxCore
    from dynamo_tpu.engine.engine import JaxEngineConfig
    from dynamo_tpu_torch.engine.engine import EngineCore, TorchEngineConfig

    jcore = JaxCore(JaxEngineConfig(model=jl.preset("tiny-byte"),
                                    warmup=False, **ENGINE))
    tcore = EngineCore(TorchEngineConfig(model=tl.preset("tiny-byte"),
                                         device="cpu", **ENGINE))
    assert tcore.k_pool.dtype == torch.bfloat16
    yield jcore, tcore
    jcore.close()
    tcore.close()


@pytest.mark.parametrize("streamed", [True, False], ids=["streamed",
                                                        "buffered"])
async def test_bf16_jax_push_lands_with_jax_inject_bits(bf16_cores,
                                                        streamed):
    from dynamo_tpu.llm import kv_transfer as jkt
    from dynamo_tpu_torch.llm import kv_transfer as tkt

    jcore, tcore = bf16_cores
    rng = np.random.default_rng(21)
    k, v = (rng.standard_normal((2, len(PROMPT), 2, 16)).astype(
        ml_dtypes.bfloat16) for _ in range(2))
    sid = f"bits-{streamed}"
    jcore.inject_prefilled(sid, _bi(J), k, v, 5, -0.5)
    jk, jv = (a.view(np.uint16) for a in jcore.extract_kv(sid,
                                                          count=len(PROMPT)))
    np.testing.assert_array_equal(jk, k.view(np.uint16))
    jcore.cancel(sid)
    jcore.step()
    free0 = tcore.pool.free_pages
    rec = tkt.KvReceiver()
    ingest = _CoreIngest(tcore, _bi(T), sid) if streamed else None
    fut = rec.expect(sid, ingest=ingest)
    ack = await jkt.push_kv(_Loopback(T, rec), 1, sid, 5, -0.5, k, v)
    assert ack == {"ok": True, "tokens": len(PROMPT), "streamed": streamed}
    got = await fut
    if streamed:
        assert got is ingest and ingest.first.token == 5
    else:
        tk, tv, tok, logp = got
        assert tk.dtype == np.uint16 and (tok, logp) == (5, -0.5)
        tcore.inject_prefilled(sid, _bi(T), tk, tv, tok, logp)
    pk, pv = tcore.extract_kv(sid, count=len(PROMPT))
    assert pk.dtype == np.uint16
    np.testing.assert_array_equal(pk, jk)
    np.testing.assert_array_equal(pv, jv)
    tcore.cancel(sid)
    tcore.step()
    assert tcore.pool.free_pages == free0 and not tcore.has_work


# ---------------------------------------------------------------------------
# torn streams: pages released unseen, the JAX package's fallback reason,
# and the request left to a local prefill
# ---------------------------------------------------------------------------

class _Queue:
    async def cancel(self, rid):
        pass


async def _torn_case(pkg, eng, case, kv):
    """One torn (or declined, or discarded) stream into ``eng`` through its
    package's receiver. Returns the fallback counter's new series and the
    leftover-state checks; then the request prefills locally."""
    kt = _mod(pkg, "llm.kv_transfer")
    stage = _mod(pkg, "utils.prometheus").stage_metrics()
    core = eng.core
    k, v, tok, logp = kv
    before = dict(stage.kv_stream_fallbacks.state()["series"])
    free0 = core.pool.free_pages
    sealed = []
    core.pool.on_block_sealed = lambda *a: sealed.append(a)
    rec = kt.KvReceiver(worker_id=0xd9)
    ctx = _ctx(pkg, f"torn-{case}")
    ingest = eng.kv_ingest(_bi(pkg), ctx.id)
    fut = rec.expect(ctx.id, ingest=ingest)
    meta = kt._meta(ctx.id, tok, logp, k)
    out = {}
    tokens = None
    if case == "donor_death":
        with pytest.raises(ConnectionResetError):
            await _drive(pkg, rec, meta, _parts(k, v, fail_at=3))
    elif case in ("truncated", "over_count"):
        parts = _parts(k, v, layers=1) if case == "truncated" \
            else _parts(k, v, extra=1)
        out["acks"] = await _drive(pkg, rec, meta, parts)
    elif case == "waiter_timeout":
        release = asyncio.Event()

        async def stalling():
            yield k[0].tobytes()
            yield v[0].tobytes()
            await release.wait()          # unbounded-ok: test stub
            yield k[1].tobytes()
            yield v[1].tobytes()

        drive = asyncio.ensure_future(_drive(pkg, rec, meta, stalling()))
        await asyncio.sleep(0.1)          # meta + layer 0 land
        out["wait"] = await kt.await_remote_kv(ctx, fut, _Queue(), rec,
                                               remote_timeout=0.2)
        out["began"] = ingest.began
        # the worker's fallback under the SAME id, the tail arriving
        # mid-retry
        tokens = []
        async for o in eng.generate(_bi(pkg), ctx):
            tokens += o.token_ids
            release.set()
        out["acks"] = await drive
    elif case == "geometry":
        # a donor of another model: one layer more than this engine's
        k = np.concatenate([k, k[:1]])
        v = np.concatenate([v, v[:1]])
        out["acks"] = await _drive(pkg, rec, kt._meta(ctx.id, tok, logp, k),
                                   _parts(k, v))
        kk, _, t2, _ = await fut          # declined: assembled buffered
        out["buffered"] = (kk.shape, t2)
        if pkg == T:
            # the whole-array import refuses it, leasing no page (the JAX
            # engine's inject leases first and leaks them: not run here)
            errs = [o async for o in eng.generate_prefilled(
                _bi(pkg), ctx, kk, kk, t2, logp)]
            inject = [(o.finish_reason.value, o.error) for o in errs]
    elif case == "discard":
        ingest = eng.kv_ingest(_bi(pkg, max_tokens=200), ctx.id)
        fut = rec.expect(ctx.id, ingest=ingest)
        await _drive(pkg, rec, meta, _parts(k, v))
        assert (await fut) is ingest and ingest.finished
        ingest.discard()
    if case in ("donor_death", "truncated", "over_count"):
        with pytest.raises(kt.KvStreamError) as ei:
            await fut
        out["error"] = ei.value.reason
    for _ in range(100):                  # the engine thread drains
        await asyncio.sleep(0.02)
        if ctx.id not in core.pool.seqs and ctx.id not in core.by_seq \
                and core.pool.free_pages == free0:
            break
    after = stage.kv_stream_fallbacks.state()["series"]
    out["fallbacks"] = {r: after[r] - before.get(r, 0) for r in after
                        if after[r] != before.get(r, 0)}
    out["clean"] = (ctx.id not in core.pool.seqs,
                    ctx.id not in core._stream_injects,
                    ctx.id not in eng._queues,
                    core.pool.free_pages == free0, sealed == [])
    core.pool.on_block_sealed = None
    if tokens is None:
        tokens = await _stream(eng.generate(_bi(pkg), ctx))
    if case == "geometry" and pkg == T:
        return out, tokens, inject
    return out, tokens


@pytest.mark.parametrize("case", ["donor_death", "truncated", "over_count",
                                  "waiter_timeout", "geometry", "discard"])
async def test_torn_streams_release_pages_and_fall_back(engines, local,
                                                        donor, case):
    got = {pkg: await _torn_case(pkg, engines[pkg], case, donor)
           for pkg in PKGS}
    (tout, ttoks, *inject), (jout, jtoks) = got[T], got[J]
    assert tout == jout
    assert tout["clean"] == (True,) * 5
    assert ttoks == local[T] and jtoks == local[J]
    want = {"donor_death": {"torn": 1}, "truncated": {"truncated": 1},
            "over_count": {"over_count": 1},
            "waiter_timeout": {"abandoned": 1}}.get(case, {})
    assert tout["fallbacks"] == want
    if case == "waiter_timeout":
        assert tout["wait"] is None and tout["began"] is False
    if case == "geometry":
        assert tout["buffered"] == ((3, len(PROMPT), 2, 16), donor[2])
        (((reason, err),),) = inject
        assert reason == "error" and err.startswith(
            "KV injection failed: KV geometry (3, 70, 2, 16)")


# ---------------------------------------------------------------------------
# the mixed fleet: JAX prefill -> torch decode, torch prefill -> JAX decode
# ---------------------------------------------------------------------------

class _Shared:
    """A module engine handed to a CLI in place of the one it would build;
    the CLI's shutdown leaves it running for the next test."""

    def __init__(self, engine):
        self._engine = engine

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def shutdown(self):
        pass


async def _start(coro_fn):
    ev = asyncio.Event()
    task = asyncio.create_task(coro_fn(ev))
    waiter = asyncio.create_task(ev.wait())
    done, _ = await asyncio.wait({task, waiter}, timeout=60,
                                 return_when=asyncio.FIRST_COMPLETED)
    if task in done:
        task.result()
        raise AssertionError("service exited before it was ready")
    assert waiter in done, "service not ready within 60 s"
    return task


def _args(pkg, cli, store, *extra):
    argv = ["--store", store, "--kv-block-size", str(PAGE),
            "--extra-engine-args", json.dumps(
                dict(ENGINE, warmup=False) if pkg == J else ENGINE)]
    if pkg == T:
        argv += ["--device", "cpu"]
    return _mod(pkg, f"cli.{cli}").parse_args(argv + list(extra))


@pytest.mark.parametrize("prefill_pkg", [J, T], ids=["jax-prefill/torch-"
                                                     "decode", "torch-"
                                                     "prefill/jax-decode"])
async def test_mixed_fleet_prefills_remotely(engines, local, monkeypatch,
                                             prefill_pkg):
    decode_pkg = T if prefill_pkg == J else J
    for pkg, name in ((J, "JaxEngine"), (T, "TorchEngine")):
        monkeypatch.setattr(_mod(pkg, "engine.engine"), name,
                            lambda cfg, _e=engines[pkg]: _Shared(_e))
    dstage = _mod(decode_pkg, "utils.prometheus").stage_metrics()
    n0 = dstage.kv_stream_ingests.get()
    pre0 = engines[prefill_pkg].core.prefill_dispatches \
        if prefill_pkg == T else None
    srv = _mod(prefill_pkg, "runtime.store_server").PyStoreServer()
    sport = await srv.start()
    store = f"127.0.0.1:{sport}"
    DRT = _mod(decode_pkg, "runtime.component").DistributedRuntime
    cdrt = await DRT(store_port=sport).connect()
    tasks = []
    try:
        w = _mod(decode_pkg, "cli.worker")
        tasks.append(await _start(lambda ev: w.run_worker(
            _args(decode_pkg, "worker", store, "--enable-disagg",
                  "--max-local-prefill-length", "0",
                  "--engine", "jax" if decode_pkg == J else "torch"),
            ready_event=ev)))
        pw = _mod(prefill_pkg, "cli.prefill_worker")
        prefill = await _start(lambda ev: pw.run_prefill_worker(
            _args(prefill_pkg, "prefill_worker", store), ready_event=ev,
            max_jobs=1))
        client = await cdrt.namespace("dynamo").component("backend") \
            .endpoint("generate").client().start()
        await client.wait_for_instances(1, timeout=30)
        (wid,) = client.instance_ids()
        toks = []
        async for item in client.generate(_bi(decode_pkg).to_dict(),
                                          mode="direct", instance_id=wid):
            toks += item.get("token_ids") or []
        assert toks == local[decode_pkg] == local[prefill_pkg]
        await asyncio.wait_for(prefill, 30)      # its one job, then exits
        queue = _mod(decode_pkg, "llm.disagg").PrefillQueue(cdrt.store,
                                                            "dynamo")
        assert await queue.size() == 0
        # the KV went remote and streamed into the decode engine's pool
        assert dstage.kv_stream_ingests.get() == n0 + 1
        if pre0 is not None:
            assert engines[T].core.prefill_dispatches > pre0
    finally:
        for t in tasks:
            t.cancel()
            with contextlib.suppress(BaseException):
                await t
        for eng in engines.values():
            eng.core.pool.on_block_sealed = None
            eng.core.pool.on_blocks_removed = None
        await cdrt.close()
        await srv.stop()
