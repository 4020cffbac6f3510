"""Mid-stream failover (``llm/resume.py``) of the port against the JAX
package's.

The resume loop on scripted dispatchers, each scenario through both
packages' ``resume.run`` with equal attempts, tokens and counters: one and
two kills, the lost finish frame, typed failures never resumed, budget
exhaustion and deadline expiry (their HTTP error bodies byte for byte the
JAX package's), and a stall that resumes and feeds the breaker. Then
``_resume_request`` against JAX's, greedy tokens of the port's engine
(tiny-byte, f32) across one and two kills equal to the unkilled stream and
to the JAX engine's, the worker-side zombie supersede and a worker killed
under ``RemoteCoreEngine`` on both data planes, whose echo stream comes out
byte-identical.
"""

import asyncio
import importlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jl
from dynamo_tpu_torch.models import llama as tl

torch.set_num_threads(2)

J, T = PKGS = ("dynamo_tpu", "dynamo_tpu_torch")
ENGINE = dict(page_size=8, max_batch=2, max_context=64, prefill_chunk=32,
              decode_steps=4, enable_prefix_reuse=False)
PROMPT = [int(t) for t in np.random.default_rng(15).integers(1, 250, 20)]
MAX_TOKENS = 12


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _common(pkg):
    return _mod(pkg, "llm.protocols.common")


def make_dispatch(pkg, source, kills=None, record=None, stalls=None):
    """A dispatch whose attempt N emits ``source[resume_pos:]`` one token per
    frame plus a separate finish frame. ``kills[N]`` breaks attempt N with a
    transport-class 503 after that many frames; ``stalls[N]`` hangs instead.
    ``record`` collects (token_ids, resume_pos, max_tokens, exclude,
    resume_no) per attempt."""
    c = _common(pkg)
    EngineError = _mod(pkg, "runtime.engine").EngineError
    kills = kills or {}
    stalls = stalls or {}

    async def dispatch(request, context, exclude, resume_no, on_instance):
        if record is not None:
            record.append((list(request.token_ids), request.resume_pos,
                           request.stop.max_tokens, set(exclude), resume_no))
        if on_instance is not None:
            on_instance(0xA0 + resume_no)
        pos = int(request.resume_pos or 0)
        budget = request.stop.max_tokens
        end = len(source) if budget is None else min(pos + budget, len(source))
        for n, i in enumerate(range(pos, end)):
            if stalls.get(resume_no) is not None and n >= stalls[resume_no]:
                await asyncio.sleep(60)    # unbounded-ok: wedged-worker stub
            if kills.get(resume_no) is not None and n >= kills[resume_no]:
                raise EngineError("connection reset mid-stream", 503)
            yield c.EngineOutput(token_ids=[source[i]])
        if kills.get(resume_no) is not None and end - pos <= kills[resume_no]:
            # budget spent exactly at the kill point: the finish frame is
            # what dies with the connection
            raise EngineError("connection reset mid-stream", 503)
        yield c.EngineOutput(finish_reason=c.FinishReason.LENGTH)

    return dispatch


async def collect(agen):
    toks, finish = [], None
    async for item in agen:
        toks.extend(item.token_ids)
        if item.finish_reason is not None:
            finish = item.finish_reason.value
    return toks, finish


def req(pkg, n_prompt=8, max_tokens=None, **kw):
    c = _common(pkg)
    return c.BackendInput(token_ids=list(range(100, 100 + n_prompt)),
                          stop=c.StopConditions(max_tokens=max_tokens,
                                                ignore_eos=True), **kw)


def outcome(pkg, name):
    return _mod(pkg, "utils.prometheus").stage_metrics() \
        .stream_resumes.get(name)


async def run_both(scenario):
    """``scenario(pkg)`` for each package; returns {pkg: result}."""
    return {pkg: await scenario(pkg) for pkg in PKGS}


# ---------------------------------------------------------------------------
# the resume loop, each package on the same scripted fleet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kills,positions", [({0: 5}, [0, 5]),
                                             ({0: 4, 1: 3}, [0, 4, 7])],
                         ids=["one-kill", "two-kills"])
async def test_scripted_kills_resume_as_jax(kills, positions):
    source = list(range(16))

    async def scenario(pkg):
        record = []
        resumed0 = outcome(pkg, "resumed")
        got = await collect(_mod(pkg, "llm.resume").run(
            make_dispatch(pkg, source, kills=kills, record=record),
            req(pkg, max_tokens=16), _mod(pkg, "runtime.engine").Context()))
        return got, record, outcome(pkg, "resumed") - resumed0

    res = await run_both(scenario)
    assert res[T] == res[J]
    (toks, finish), record, resumed = res[T]
    assert toks == source and finish == "length"
    assert resumed == len(kills)
    assert [r[1] for r in record] == positions
    # prompt + emitted as the prefix, the spent budget deducted, every
    # dead instance excluded, the attempt ordinal on the wire
    tokens, pos, max_tokens, excl, ordinal = record[-1]
    assert tokens == list(range(100, 108)) + source[:pos]
    assert max_tokens == 16 - pos and ordinal == len(kills)
    assert excl == {0xA0 + i for i in range(len(kills))}


async def test_lost_finish_frame_synthesizes_length():
    async def scenario(pkg):
        record = []
        got = await collect(_mod(pkg, "llm.resume").run(
            make_dispatch(pkg, list(range(8)), kills={0: 4}, record=record),
            req(pkg, max_tokens=4), _mod(pkg, "runtime.engine").Context()))
        return got, len(record)

    res = await run_both(scenario)
    assert res[T] == res[J] == ((list(range(4)), "length"), 1)


async def test_typed_failures_are_never_resumed():
    async def scenario(pkg):
        record = []
        EngineError = _mod(pkg, "runtime.engine").EngineError

        async def shedding(request, context, exclude, resume_no,
                           on_instance):
            record.append(resume_no)
            raise EngineError("saturated", 503, stage="router",
                              reason="fast_fail")
            yield  # pragma: no cover - makes this an async generator

        with pytest.raises(EngineError) as ei:
            await collect(_mod(pkg, "llm.resume").run(
                shedding, req(pkg, max_tokens=4),
                _mod(pkg, "runtime.engine").Context()))
        return ei.value.reason, record

    res = await run_both(scenario)
    assert res[T] == res[J] == ("fast_fail", [0])


@pytest.mark.parametrize("case", ["exhausted", "expired"])
async def test_budget_and_deadline_errors_render_as_jax(case, monkeypatch):
    """Budget exhaustion (typed 503 ``resume_exhausted``) and the original
    deadline expiring mid-retry (504 at stage ``stream_resume``): the
    frontend's error bodies equal the JAX package's byte for byte."""
    monkeypatch.setenv("DYN_RESUME_MAX", "2" if case == "exhausted" else "5")
    # one frozen clock, so the expiry message's lateness is the same text
    monkeypatch.setattr(time, "time", lambda: 1000.0)
    kills = {0: 2, 1: 1, 2: 1} if case == "exhausted" else {0: 3}

    async def scenario(pkg):
        record = []
        EngineError = _mod(pkg, "runtime.engine").EngineError
        ctx = _mod(pkg, "runtime.engine").Context(
            deadline=None if case == "exhausted" else 999.5)
        n0 = outcome(pkg, case)
        with pytest.raises(EngineError) as ei:
            await collect(_mod(pkg, "llm.resume").run(
                make_dispatch(pkg, list(range(12)), kills=kills,
                              record=record),
                req(pkg, max_tokens=12), ctx))
        resp = _mod(pkg, "llm.http_service")._err_engine(ei.value, "rid-1")
        # (aiohttp lists the content type among the headers)
        headers = {k: v for k, v in resp.headers.items()
                   if k != "Content-Type"}
        return (resp.status, resp.body, headers, len(record),
                outcome(pkg, case) - n0)

    res = await run_both(scenario)
    assert res[T] == res[J]
    status, body, _headers, attempts, counted = res[T]
    assert (status, attempts, counted) == (
        (503, 3, 1) if case == "exhausted" else (504, 1, 1))
    assert b'"stage": "stream_resume"' in body


async def test_stall_resumes_and_feeds_breaker(monkeypatch):
    """A wedged worker never errors the socket: the inter-frame stall
    budget declares the break, the instance takes a breaker hit and the
    stream completes elsewhere."""
    from dynamo_tpu_torch.llm import resume
    from dynamo_tpu_torch.runtime.engine import Context

    monkeypatch.setenv("DYN_RESUME_STALL", "0.2")
    hits = []

    class FakeBreaker:
        def record_failure(self, iid):
            hits.append(iid)

    toks, finish = await collect(resume.run(
        make_dispatch(T, list(range(8)), stalls={0: 3}),
        req(T, max_tokens=8), Context(), breaker=FakeBreaker()))
    assert toks == list(range(8)) and finish == "length"
    assert hits == [0xA0]


def test_resume_request_equals_jax():
    def build(pkg):
        c = _common(pkg)
        orig = req(pkg, n_prompt=4, max_tokens=10)
        orig.sampling = c.SamplingOptions(temperature=0.7, seed=123)
        orig.stop.min_tokens = 6
        orig.kv_donor = 0xBEEF
        orig.kv_donor_blocks = 3
        r = _mod(pkg, "llm.resume")._resume_request(
            orig, list(orig.token_ids), [7, 8, 9], 10, 6)
        return r.to_dict(), orig.to_dict()

    (tr, to), (jr, jo) = build(T), build(J)
    assert tr == jr and to == jo
    assert tr["token_ids"] == list(range(100, 104)) + [7, 8, 9]
    assert tr["resume_pos"] == 3
    assert tr["stop"]["max_tokens"] == 7 and tr["stop"]["min_tokens"] == 3
    assert not tr.get("kv_donor") and to["stop"]["max_tokens"] == 10


def test_resumable_classification_and_knobs(monkeypatch):
    from dynamo_tpu_torch.llm import resume
    from dynamo_tpu_torch.runtime.engine import EngineError

    assert resume.resumable(EngineError("reset", 503))
    assert resume.resumable(EngineError("bad frame", 502))
    assert not resume.resumable(EngineError("shed", 503, reason="fast_fail"))
    assert not resume.resumable(EngineError("late", 504, reason="deadline"))
    assert not resume.resumable(EngineError("dup", 409))
    assert not resume.resumable(ValueError("reset"))
    assert (resume.max_attempts(), resume.stall_budget()) == (2, 30.0)
    monkeypatch.setenv("DYN_RESUME_MAX", "0")
    monkeypatch.setenv("DYN_RESUME_STALL", "0")
    assert (resume.max_attempts(), resume.stall_budget()) == (0, 0.0)


# ---------------------------------------------------------------------------
# greedy tokens of the port's engine across kills
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    """One f32 tiny-byte engine each, the port's on the JAX engine's
    weights, and each one's unkilled greedy stream of PROMPT."""
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

    async def unkilled(pkg, eng):
        c = _common(pkg)
        bi = c.BackendInput(token_ids=list(PROMPT), stop=c.StopConditions(
            max_tokens=MAX_TOKENS, ignore_eos=True))
        return await collect(eng.generate(
            bi, _mod(pkg, "runtime.engine").Context()))

    ref = {J: asyncio.run(unkilled(J, jeng)), T: asyncio.run(unkilled(T, teng))}
    jeng.shutdown()
    yield teng, ref
    teng.shutdown()


def engine_dispatch(engine, kills, record):
    """Each attempt runs on the port's engine; attempt N dies with a
    transport-class 503 after ``kills[N]`` tokens."""
    from dynamo_tpu_torch.runtime.engine import Context, EngineError

    async def dispatch(request, context, exclude, resume_no, on_instance):
        record.append((request.resume_pos, len(request.token_ids)))
        on_instance(0xA0 + resume_no)
        agen = engine.generate(request, Context(f"{context.id}-{resume_no}"))
        n = 0
        try:
            async for out in agen:
                if kills.get(resume_no) is not None \
                        and n + len(out.token_ids) > kills[resume_no]:
                    raise EngineError("connection reset mid-stream", 503)
                n += len(out.token_ids)
                yield out
        finally:
            await agen.aclose()

    return dispatch


@pytest.mark.parametrize("kills", [{0: 5}, {0: 4, 1: 3}],
                         ids=["one-kill", "two-kills"])
async def test_engine_greedy_tokens_across_kills(engines, kills):
    from dynamo_tpu_torch.llm import resume
    from dynamo_tpu_torch.llm.protocols.common import (BackendInput,
                                                       StopConditions)
    from dynamo_tpu_torch.runtime.engine import Context

    teng, ref = engines
    record = []
    bi = BackendInput(token_ids=list(PROMPT), stop=StopConditions(
        max_tokens=MAX_TOKENS, ignore_eos=True))
    got = await collect(resume.run(engine_dispatch(teng, kills, record), bi,
                                   Context()))
    assert got == ref[T] == ref[J]
    assert len(got[0]) == MAX_TOKENS and got[1] == "length"
    # each resume re-entered at the tokens emitted so far
    want_pos = [0] + list(np.cumsum([kills[i] for i in sorted(kills)]))
    assert record == [(p, len(PROMPT) + p) for p in want_pos]


# ---------------------------------------------------------------------------
# over the runtime: the supersede guard and a worker killed mid-stream
# ---------------------------------------------------------------------------

async def _runtime(port, n):
    from dynamo_tpu_torch.runtime.component import DistributedRuntime

    return [await DistributedRuntime(store_port=port,
                                     advertise_host="127.0.0.1").connect()
            for _ in range(n)]


@pytest.mark.parametrize("mode", ["native", "python"])
async def test_resume_ordinal_supersedes_zombie_context(mode, monkeypatch):
    """Attempt N+1 re-enters under the SAME context id: a worker still
    holding the wedged attempt kills it and serves; a plain duplicate
    (no higher ordinal) still gets 409."""
    from dynamo_tpu_torch.runtime.engine import Context, EngineError
    from dynamo_tpu_torch.runtime.store_server import PyStoreServer

    monkeypatch.setenv("DYNAMO_TPU_DATAPLANE", mode)
    store = PyStoreServer()
    drts = await _runtime(await store.start(), 2)
    try:
        async def handler(request, ctx):
            for i in range(int(request.get("n", 0))):
                if ctx.is_killed or ctx.is_stopped:
                    return
                yield {"i": i}
                await asyncio.sleep(0.02)

        await drts[0].namespace("dyn").component("backend") \
            .endpoint("generate").serve(handler)
        assert drts[0].dataplane == mode
        client = await drts[1].namespace("dyn").component("backend") \
            .endpoint("generate").client().start()
        await client.wait_for_instances(1)
        agen = client.generate({"n": 1000}, Context(id="ctx-resume"))
        await asyncio.wait_for(agen.__anext__(), 5.0)
        with pytest.raises(EngineError) as ei:
            async for _ in client.generate({"n": 3},
                                           Context(id="ctx-resume")):
                pass
        assert ei.value.code == 409
        got = [f["i"] async for f in client.generate(
            {"n": 3}, Context(id="ctx-resume"), resume=1)]
        assert got == [0, 1, 2]
        await agen.aclose()
    finally:
        for drt in drts:
            await drt.close()
        await store.stop()


def _kill(drt):
    """What a client sees of a SIGKILLed worker: its data-plane sockets
    reset at once while its lease lives on."""
    for ctx in list(drt._active.values()):
        ctx.kill()
    if drt._native_dp is not None:
        drt._native_dp.stop()
        drt._native_dp = None
    else:
        drt._dp_server.close()
        for w in list(drt._conn_writers):
            w.transport.abort()


@pytest.mark.parametrize("mode", ["native", "python"])
async def test_remote_stream_survives_a_killed_worker(mode, monkeypatch):
    """``RemoteCoreEngine`` over two echo workers: the worker serving the
    stream dies after 3 tokens; the stream resumes on the other one and is
    byte-identical to the unkilled stream (and to the JAX echo's)."""
    from dynamo_tpu.llm.engines import EchoCoreEngine as JaxEcho
    from dynamo_tpu_torch.llm.engines import EchoCoreEngine
    from dynamo_tpu_torch.llm.protocols.common import (BackendInput,
                                                       StopConditions)
    from dynamo_tpu_torch.llm.remote import (RemoteCoreEngine,
                                             serve_core_engine)
    from dynamo_tpu_torch.runtime.engine import Context
    from dynamo_tpu_torch.runtime.store_server import PyStoreServer

    monkeypatch.setenv("DYNAMO_TPU_DATAPLANE", mode)
    prompt = list(range(40, 56))
    jbi = req(J)
    jbi.token_ids = list(prompt)
    want = await collect(JaxEcho(delay_s=0).generate(
        jbi, _mod(J, "runtime.engine").Context()))
    store = PyStoreServer()
    drts = await _runtime(await store.start(), 3)
    try:
        for drt in drts[:2]:
            await serve_core_engine(
                drt.namespace("dyn").component("backend")
                .endpoint("generate"), EchoCoreEngine(delay_s=0.01))
        client = await drts[2].namespace("dyn").component("backend") \
            .endpoint("generate").client().start()
        await client.wait_for_instances(2)
        engine = RemoteCoreEngine(client)

        def bi():
            return BackendInput(token_ids=list(prompt),
                                stop=StopConditions(ignore_eos=True))

        assert await collect(engine.generate(bi(), Context())) == want
        resumed0 = outcome(T, "resumed")
        toks, finish = [], None
        async for out in engine.generate(bi(), Context("failover-1")):
            toks += out.token_ids
            finish = out.finish_reason or finish
            if len(toks) == 3:
                (victim,) = [d for d in drts[:2] if d._active]
                _kill(victim)
        assert (toks, finish.value) == want
        assert outcome(T, "resumed") == resumed0 + 1
    finally:
        for drt in drts:
            await drt.close()
        await store.stop()
