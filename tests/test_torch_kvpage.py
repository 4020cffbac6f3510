"""The KV paging lane of the torch port (``dynamo_tpu_torch/llm/kvpage``)
held against the JAX package's (``dynamo_tpu/llm/kvpage``).

- ``_merge`` and ``_partial_attend`` against the JAX functions on the
  same seeded inputs (softcap, window, GQA groups, all-masked rows, which
  are an exact no-op under the merge).
- Greedy tokens of a prompt about 16x the page budget (f32 tiny-byte,
  the same weights): the port's paged lane equals its dense engine and
  the JAX ``PagedEngine``; a repeated prompt reuses the pinned prefix;
  batch 4 equals batch 1 and dense; sliding-window models serve paged.
- ``PageScheduler``: the same segments bit for bit from the same tier,
  the same prefetch and fault counts; misses are fatal, lanes are not
  starved, a fault stays in its lane, ``end_lane`` drops state; the tier
  under concurrent demotion, write-through and donor reads.
- Admission errors, the typed 400/503 HTTP bodies byte for byte, the
  no-paging over-length 400 and the construction refusals, each equal to
  the JAX package's; cancel; a failure kills the request, not the engine;
  ``utilization()`` publishes the lane's bytes; the flow ledger's page-in
  and page-out bytes match the geometry.
"""

import asyncio
import contextlib
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.engine import EngineCore as JaxCore, JaxEngineConfig
from dynamo_tpu.llm.kvpage import programs as jprog
from dynamo_tpu.models import llama as jl
from dynamo_tpu_torch.engine.engine import EngineCore, TorchEngineConfig
from dynamo_tpu_torch.llm.kvbm.tiers import (HostKvTier, OutOfTierSpace,
                                             TieredKvCache)
from dynamo_tpu_torch.llm.kvpage import programs as tprog
from dynamo_tpu_torch.llm.kvpage.pager import (KvPageMiss, PageinPlan,
                                               PageScheduler)
from dynamo_tpu_torch.llm.protocols.common import (BackendInput,
                                                   FinishReason,
                                                   SamplingOptions,
                                                   StopConditions)
from dynamo_tpu_torch.models import llama as tl

torch.set_num_threads(2)

PAGE = 8
BUDGET = 4                              # 32 resident tokens
CHUNK = 16
PROMPT = [(i * 7 + 3) % 251 for i in range(16 * BUDGET * PAGE + 21)]
MAX_NEW = 6
HOST_BLOCKS = len(PROMPT) // PAGE + 32
PAGED = dict(max_batch=2, max_context=64, page_size=PAGE,
             prefill_chunk=CHUNK, decode_steps=4,
             host_cache_blocks=HOST_BLOCKS, kvpage_budget=BUDGET,
             kvpage_seg_pages=4, kvpage_prefetch=2, kvpage_max_context=2048)


def _req(tokens, max_tokens=MAX_NEW, **kw):
    return BackendInput(token_ids=list(tokens),
                        stop=StopConditions(max_tokens=max_tokens), **kw)


def _drain(core, want_err=False, n=20000):
    got = []
    for _ in range(n):
        for so in core.step():
            if not want_err:
                assert so.error is None, so.error
            got.append(so)
        if got and got[-1].finish is not None:
            return got
    raise AssertionError("sequence never finished")


def _drain_multi(core, seq_ids, n=20000):
    """Drain until every id finished: ({seq_id: tokens}, peak lanes)."""
    toks = {s: [] for s in seq_ids}
    done, peak = set(), 0
    for _ in range(n):
        for so in core.step():
            assert so.error is None, so.error
            toks[so.seq_id].append(so.token)
            if so.finish is not None:
                done.add(so.seq_id)
        peak = max(peak, sum(s is not None for s in core.kvpager.lanes))
        if done == set(seq_ids):
            return toks, peak
    raise AssertionError(f"never finished: {set(seq_ids) - done}")


def _tmodel(name="tiny-byte"):
    return tl.preset(name, max_position=4096, dtype=torch.float32)


def _tcore(params=None, model=None, **kw):
    d = dict(PAGED)
    d.update(kw)
    return EngineCore(TorchEngineConfig(model=model or _tmodel(),
                                        device="cpu", **d), params=params)


def _np_tree(seed=0):
    """tiny-byte weights as the JAX package's tree of numpy arrays, drawn
    as its ``init_params`` draws them (normal over the square root of the
    leading dim, the three norms ones), from a numpy seed."""
    rng = np.random.default_rng(seed)
    shapes = tl.param_shapes(_tmodel())

    def draw(name, shape):
        if name in ("ln1", "ln2", "final_norm"):
            return np.ones(shape, np.float32)
        return (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(
            np.float32)

    tree = {n: draw(n, s) for n, s in shapes.items() if n != "layers"}
    tree["layers"] = {n: draw(n, s) for n, s in shapes["layers"].items()}
    return tree


NP_PARAMS = _np_tree()


@contextlib.contextmanager
def _jax_weights():
    """JAX engines built inside take NP_PARAMS (f32 tiny-byte) instead of
    a seeded init, which would compile its random draws first."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jl, "init_params",
                   lambda cfg, key: jax.tree.map(jnp.asarray, NP_PARAMS))
        yield


# ---------------------------------------------------------------------------
# module fixtures: the JAX lane runs once (its compiles are the cost)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_lane():
    """The JAX paged engine's greedy stream of PROMPT on NP_PARAMS and its
    admission errors for the cases the port is held to."""
    with _jax_weights():
        core = JaxCore(JaxEngineConfig(
            model=jl.preset("tiny-byte", max_position=4096,
                            dtype=jnp.float32), **PAGED))
    try:
        core.submit("p", _req(PROMPT))
        toks = [so.token for so in _drain(core)]
        errs = {}
        for name, req in _error_cases(core.tiered.host.num_blocks):
            errs[name] = core.kvpager.try_route(name, req)
        for sid in [s for s, _, _ in core.kvpager.queue]:
            core.kvpager.cancel(sid)
    finally:
        core.close()
    return {"tokens": toks, "errors": errs}


@pytest.fixture(scope="module")
def params():
    return tl.params_from_jax(NP_PARAMS, _tmodel(), torch.device("cpu"))


@pytest.fixture(scope="module")
def dense_tokens(params):
    core = _tcore(params, max_context=1024, prefill_chunk=64,
                  host_cache_blocks=0, kvpage_budget=0)
    core.submit("ref", _req(PROMPT))
    return [so.token for so in _drain(core)]


@pytest.fixture(scope="module")
def paged_core(params):
    core = _tcore(params)
    yield core
    core.close()


def _error_cases(host_blocks):
    return [("huge", _req(range(3000), max_tokens=1)),
            ("fat", _req(PROMPT[:290],
                         max_tokens=(host_blocks + 8) * PAGE)),
            ("ra", _req(PROMPT[:64], max_tokens=(host_blocks // 2) * PAGE)),
            ("rb", _req(PROMPT[:64], max_tokens=(host_blocks // 2) * PAGE))]


# ---------------------------------------------------------------------------
# the plain partners of a fused partial-attention kernel
# ---------------------------------------------------------------------------
class _M:
    """The model fields ``_partial_attend`` reads."""

    def __init__(self, Hq, Hkv, softcap):
        self.num_heads, self.num_kv_heads = Hq, Hkv
        self.attn_logit_softcap = softcap
        self.attn_scale = 0.25


@pytest.mark.parametrize("Hq,Hkv,softcap,window,masked", [
    (4, 2, None, None, False),
    (4, 1, 50.0, 5, False),
    (8, 8, None, 3, True),
    (6, 2, 30.0, None, True)])
def test_merge_and_partial_attend_match_jax(Hq, Hkv, softcap, window,
                                            masked):
    rng = np.random.default_rng(Hq * 10 + Hkv)
    B, T, S, Dh = 2, 5, 12, 8
    q = rng.standard_normal((B, T, Hq, Dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    qp = np.arange(S - T, S)[None, :, None]
    kp = np.arange(S)[None, None, :]
    mask = np.broadcast_to(kp <= qp, (B, T, S)).copy()
    if window is not None:
        mask &= kp > qp - window
    if masked:
        mask[1] = False                 # a padded lane
        mask[0, 2] = False              # one all-masked query row
    cfg = _M(Hq, Hkv, softcap)
    # one compile a case: eager JAX compiles every op on its own
    want = jax.jit(jprog._partial_attend, static_argnums=0)(
        cfg, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(mask))
    got = tprog._partial_attend(cfg, torch.from_numpy(q),
                                torch.from_numpy(k), torch.from_numpy(v),
                                torch.from_numpy(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    if masked:
        assert (got[0][1] == 0).all() and (got[2][1] == 0).all()
        assert (got[1][1] == tl.NEG_INF).all()
    # merging with a second partial, and with an all-masked one
    o2 = rng.standard_normal(got[0].shape).astype(np.float32)
    m2 = rng.standard_normal(got[1].shape).astype(np.float32)
    d2 = rng.random(got[2].shape).astype(np.float32) + 0.5
    want_m = jax.jit(jprog._merge)(*want, jnp.asarray(o2), jnp.asarray(m2),
                                   jnp.asarray(d2))
    got_m = tprog._merge(*got, torch.from_numpy(o2), torch.from_numpy(m2),
                         torch.from_numpy(d2))
    for g, w in zip(got_m, want_m):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    none = (torch.zeros_like(got[0]), torch.full_like(got[1], tl.NEG_INF),
            torch.zeros_like(got[2]))
    for g, w in zip(tprog._merge(*got, *none), got):
        assert torch.equal(g, w)        # an exact no-op


def test_validate_refuses_moe_and_vlm_as_jax():
    class _Cfg:
        pp = sp = 1

        def __init__(self, model):
            self.model = model

    for name in ("tiny-byte", "tiny-gemma2", "tiny-gemma3", "tiny-moe",
                 "tiny-gemma3-vlm"):
        want = jprog.PagedPrograms.validate(_Cfg(jl.preset(name)))
        assert tprog.PagedPrograms.validate(_Cfg(tl.preset(name))) == want
    assert tprog.PagedPrograms.validate(_Cfg(tl.preset("tiny-moe")))


# ---------------------------------------------------------------------------
# tokens: 16x the budget, equal to dense and to the JAX lane
# ---------------------------------------------------------------------------
def test_paged_tokens_match_dense_and_jax(paged_core, dense_tokens,
                                          jax_lane):
    assert len(PROMPT) >= 16 * BUDGET * PAGE
    core = paged_core
    kp = core.kvpager
    g0 = core.goodput.dispatches
    core.submit("p", _req(PROMPT))
    outs = _drain(core)
    toks = [so.token for so in outs]
    assert toks == dense_tokens
    assert toks == jax_lane["tokens"]
    assert outs[0].prompt_tokens == len(PROMPT)
    assert outs[-1].finish == FinishReason.LENGTH
    assert kp.pager.pageins > 0 and kp.pager.faults == 0
    assert kp.active is None                      # released
    assert core.tiered.pinned_count() == 0        # pins dropped at finish
    assert kp.peak_resident <= BUDGET             # the residency bound
    assert core.pool.free_pages == core.pool.num_pages - 1
    assert core.goodput.dispatches > g0


def test_paged_reserve_prefix_reuse(paged_core, dense_tokens):
    """Serving the same long prompt again pins the tier blocks the first
    run left behind: only the final hot window is recomputed."""
    core = paged_core
    core.submit("p2", _req(PROMPT))
    assert [so.token for so in _drain(core)] == dense_tokens
    assert core.last_prefix_hit >= (len(PROMPT) // PAGE - BUDGET - 1) * PAGE


def test_window_host_staging_stays_bounded(paged_core, dense_tokens,
                                           monkeypatch):
    """A decode window keeps its per-(layer, segment) host slots only
    within ``WINDOW_CACHE_BYTES``; past it every step takes its segments
    again through the ring, with the same tokens. Either way the free list
    keeps at most ``STAGE_RING`` slots a batch width afterwards."""
    from dynamo_tpu_torch.llm.kvpage import runner

    core = paged_core
    kp = core.kvpager

    def free_slots():
        return max((len(f) for f in kp._host_free.values()), default=0)

    # the earlier cached windows each held more slots than the ring
    assert kp.stage_slots_made > runner.STAGE_RING
    assert free_slots() <= runner.STAGE_RING
    monkeypatch.setattr(runner, "WINDOW_CACHE_BYTES", 0)
    made, w0, u0 = kp.stage_slots_made, kp.decode_windows, kp.uncached_windows
    core.submit("nocache", _req(PROMPT))
    assert [so.token for so in _drain(core)] == dense_tokens
    assert kp.uncached_windows - u0 == kp.decode_windows - w0 > 0
    assert kp.stage_slots_made - made <= runner.STAGE_RING
    assert free_slots() <= runner.STAGE_RING


def test_paged_cancel(paged_core):
    core = paged_core
    core.submit("gone", _req(PROMPT[:200], max_tokens=64))
    for _ in range(3):
        core.step()
    core.cancel("gone")
    outs = _drain(core, want_err=True)
    assert any(so.seq_id == "gone" and so.finish == FinishReason.CANCELLED
               for so in outs)
    assert core.kvpager.active is None
    assert core.tiered.pinned_count() == 0


def test_paged_failure_kills_request_not_engine(paged_core, monkeypatch):
    core = paged_core

    def boom(*a, **kw):
        raise RuntimeError("synthetic upload failure")

    monkeypatch.setattr(core.kvpager, "_forward", boom)
    core.submit("doomed", _req(PROMPT[:100], max_tokens=4))
    so = next(o for o in _drain(core, want_err=True)
              if o.seq_id == "doomed")
    assert so.finish == FinishReason.ERROR
    assert (so.error_code, so.error_reason) == (500, "kvpage_internal")
    assert core.kvpager.active is None
    assert core.tiered.pinned_count() == 0
    monkeypatch.undo()
    core.submit("after", _req(PROMPT[:90], max_tokens=2))
    outs = [so for so in _drain(core) if so.seq_id == "after"]
    assert outs[-1].finish is not None and outs[-1].error is None


def test_utilization_and_ledger_bytes(paged_core):
    """``utilization()`` counts the lane's pinned host working set as
    resident (ForwardPassMetrics takes it), and the flow ledger's paged
    bytes reconcile with the geometry: page-out = demoted blocks x block
    bytes, page-in = whole lane-stacked staging slots."""
    from dynamo_tpu_torch.llm.kv_router.protocols import ForwardPassMetrics
    from dynamo_tpu_torch.obs.flows import flow_ledger
    from dynamo_tpu_torch.utils.prometheus import stage_metrics

    core = paged_core
    kp = core.kvpager
    ledger, stage = flow_ledger(), stage_metrics()
    in0 = ledger.total_bytes("kvpage_pagein")
    out0 = ledger.total_bytes("kvpage_pageout")
    dem0 = stage.kvpage_demotions.get()
    base = core.utilization()["kv_resident_bytes"]
    # a prompt of its own: PROMPT's blocks are in the tier already
    core.submit("u", _req([(i * 13 + 1) % 251 for i in range(300)],
                          max_tokens=2))
    seen = 0.0
    for _ in range(2000):
        outs = core.step()
        if kp.active is not None:
            u = core.utilization()
            host = kp.resident_bytes()[1]
            assert u["kv_resident_bytes"] >= base + host
            seen = max(seen, host)
            assert ForwardPassMetrics(**u).kv_capacity_bytes == \
                u["kv_capacity_bytes"]
        if outs and outs[-1].finish is not None:
            break
    assert seen > 0
    m = core.cfg.model
    demoted = stage.kvpage_demotions.get() - dem0
    assert demoted > 0
    assert (ledger.total_bytes("kvpage_pageout") - out0
            == int(demoted) * tl.kv_block_bytes(m, PAGE))
    quantum = (2 * 1 * PAGED["kvpage_seg_pages"] * m.num_kv_heads * PAGE
               * m.head_dim * 4)          # [2, B=1, seg, Hkv, page, Dh] f32
    moved = ledger.total_bytes("kvpage_pagein") - in0
    assert moved > 0 and moved % quantum == 0


# ---------------------------------------------------------------------------
# batched lanes and sliding-window models
# ---------------------------------------------------------------------------
BATCH = 4
BPROMPTS = [[(i * 11 + 5 + 37 * j) % 251 for i in range(140 + 23 * j)]
            for j in range(BATCH)]


def test_batched_lanes_match_serial_and_dense(params, paged_core):
    """Four concurrent lanes sharing the pool produce the token streams of
    the dense engine and of the serial lane; a seeded sampled lane's
    stream does not depend on its lanemates."""
    dense = _tcore(params, max_context=1024, prefill_chunk=64,
                   host_cache_blocks=0, kvpage_budget=0)
    ref = []
    for j, p in enumerate(BPROMPTS):
        dense.submit(f"d{j}", _req(p, max_tokens=5))
        ref.append([so.token for so in _drain(dense)])
    core = _tcore(params, host_cache_blocks=160, kvpage_budget=16,
                  kvpage_batch=BATCH)
    try:
        ids = [f"b{j}" for j in range(BATCH)]
        for j, sid in enumerate(ids):
            core.submit(sid, _req(BPROMPTS[j], max_tokens=5))
        toks, peak = _drain_multi(core, ids)
        assert peak == BATCH
        for j, sid in enumerate(ids):
            assert toks[sid] == ref[j], f"lane {j} diverged from dense"
        assert core.kvpager.pager.pageins > 0
        assert core.kvpager.peak_resident <= 16
        assert core.tiered.pinned_count() == 0
        for j in (0, 3):
            paged_core.submit(f"s{j}", _req(BPROMPTS[j], max_tokens=5))
            assert [so.token for so in _drain(paged_core)] == ref[j]
        # sampled: the same seeded request alone and beside three others
        sampled = _req(BPROMPTS[1], max_tokens=9, sampling=SamplingOptions(
            temperature=0.9, top_p=0.9, seed=7))
        core.submit("alone", sampled)
        alone = [so.token for so in _drain(core)]
        ids = ["x0", "x1", "x2"]
        for j, sid in zip((0, 2, 3), ids):
            core.submit(sid, _req(BPROMPTS[j], max_tokens=9))
        core.submit("beside", sampled)
        toks, _ = _drain_multi(core, ids + ["beside"])
        assert toks["beside"] == alone
    finally:
        core.close()


def test_batched_admission_reserves_queued_lanes(paged_core, jax_lane):
    """The admission ledger counts blocks every admitted-but-unpinned
    request will still pin; each error is the JAX lane's, field for
    field."""
    kp = paged_core.kvpager
    host = paged_core.tiered.host.num_blocks
    got = {name: kp.try_route(name, req)
           for name, req in _error_cases(host)}
    assert got["ra"] is None and jax_lane["errors"]["ra"] is None
    for name in ("huge", "fat", "rb"):
        g, w = got[name], jax_lane["errors"][name]
        assert (g.error, g.error_code, g.error_stage, g.error_reason) == \
            (w.error, w.error_code, w.error_stage, w.error_reason), name
    assert "DYN_KVPAGE_MAX_CONTEXT" in got["huge"].error
    assert (got["rb"].error_code, got["rb"].error_reason) == \
        (503, "kvpage_capacity")
    kp.cancel("ra")                                 # reservation released
    assert kp.try_route("rc", _error_cases(host)[3][1]) is None
    kp.cancel("rc")
    assert not kp.has_work


@pytest.mark.parametrize("preset", ["tiny-gemma2", "tiny-gemma3"])
def test_sliding_window_model_serves_paged(preset):
    """Sliding-window layers (and gemma3's local rope) through the batched
    paged lane, token-identical to the dense engine; the plan drops
    segments wholly below the window."""
    m = _tmodel(preset)
    prompts = [[(i * 5 + 11 + 29 * j) % 251 for i in range(90 + 9 * j)]
               for j in range(2)]
    dense = _tcore(model=m, max_context=512, host_cache_blocks=0,
                   kvpage_budget=0)
    ref = []
    for j, p in enumerate(prompts):
        dense.submit(f"d{j}", _req(p, max_tokens=4))
        ref.append([so.token for so in _drain(dense)])
    core = _tcore(params=dense.params, model=m, host_cache_blocks=128,
                  kvpage_budget=8, kvpage_batch=2)
    try:
        assert len(core.kvpager.programs.classes) == 2
        ids = [f"g{j}" for j in range(2)]
        for j, sid in enumerate(ids):
            core.submit(sid, _req(prompts[j], max_tokens=4))
        toks, peak = _drain_multi(core, ids)
        assert peak == 2
        for j, sid in enumerate(ids):
            assert toks[sid] == ref[j], f"sliding lane {j} diverged"
        assert core.kvpager.pager.pageins > 0
    finally:
        core.close()


# ---------------------------------------------------------------------------
# errors and refusals, equal to the JAX package's
# ---------------------------------------------------------------------------
def test_typed_error_bodies_byte_equal_jax(paged_core, jax_lane):
    """StepOutput {code, stage, reason} -> EngineOutput -> the backend's
    EngineError -> the frontend's error body: the same bytes from both
    packages, for the paged lane's 400 and 503 and the no-paging 400."""
    from dynamo_tpu.llm import backend as jb
    from dynamo_tpu.llm import http_service as jh
    from dynamo_tpu.llm.protocols import common as jc
    from dynamo_tpu.llm.tokenizer import ByteTokenizer as JTok
    from dynamo_tpu.runtime.engine import Context as JCtx
    from dynamo_tpu_torch.llm import backend as tb
    from dynamo_tpu_torch.llm import http_service as th
    from dynamo_tpu_torch.llm.protocols import common as tc
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer as TTok
    from dynamo_tpu_torch.runtime.engine import Context as TCtx

    def body(so, b, h, c, tok, ctx):
        class ErrEngine:
            async def generate(self, request, context):
                yield c.EngineOutput(
                    token_ids=[], finish_reason=c.FinishReason.ERROR,
                    error=so.error, error_code=so.error_code,
                    error_stage=so.error_stage,
                    error_reason=so.error_reason)

        async def run():
            stream = b.Backend(ErrEngine(), tok()).generate(
                c.BackendInput(token_ids=[1, 2, 3]), ctx("r1"))
            try:
                async for _ in stream:
                    pass
            except Exception as e:  # noqa: BLE001 - the typed error
                return e
            raise AssertionError("no error")

        resp = h._err_engine(asyncio.run(run()), "r1")
        return resp.status, bytes(resp.body)

    # the no-paging over-length 400 from both engines
    with _jax_weights():
        jcore = JaxCore(JaxEngineConfig(
            model=jl.preset("tiny-byte", dtype=jnp.float32), max_batch=2,
            max_context=128, page_size=PAGE, prefill_chunk=32,
            kvpage_budget=0))
    tcore = _tcore(max_context=128, prefill_chunk=32, host_cache_blocks=0,
                   kvpage_budget=0)
    over = {}
    for name, core in (("jax", jcore), ("torch", tcore)):
        core.submit("big", _req(range(200), max_tokens=1))
        over[name] = next(o for o in _drain(core, want_err=True)
                          if o.seq_id == "big")
    jcore.close()
    assert over["torch"].error == over["jax"].error
    assert "max_context" in over["torch"].error
    pairs = [(over["jax"], over["torch"])]
    host = paged_core.tiered.host.num_blocks
    for name, req in _error_cases(host)[:2]:
        pairs.append((jax_lane["errors"][name],
                      paged_core.kvpager.try_route(name, req)))
    for w, g in pairs:
        jw = body(w, jb, jh, jc, JTok, JCtx)
        tg = body(g, tb, th, tc, TTok, TCtx)
        assert tg == jw
        assert json.loads(tg[1])["error"]["stage"] == "engine_admission"
    assert {p[1].error_code for p in pairs} == {400, 503}


@pytest.mark.parametrize("kw,match", [
    (dict(host_cache_blocks=0), "host tier"),
    (dict(prefill_chunk=64, kvpage_budget=2), "prefill chunk"),
    (dict(prefill_chunk=32, kvpage_budget=16, kvpage_batch=8),
     "prefill chunk"),
    (dict(spec="ngram"), "speculative"),
    (dict(model="tiny-moe"), "MoE"),
    (dict(model="tiny-gemma3-vlm"), "VLM")])
def test_kvpage_construction_refusals(kw, match):
    """The refusals at construction, with the JAX engine's messages (the
    JAX checks run in the same order on the same config)."""
    kw = dict(kw)
    name = kw.pop("model", "tiny-byte")
    cfg = dict(PAGED, max_batch=1, max_context=128)
    cfg.update(kw)
    with pytest.raises(ValueError, match=match) as got:
        EngineCore(TorchEngineConfig(
            model=tl.preset(name, dtype=torch.float32), device="cpu",
            **cfg))
    if name == "tiny-byte" and "spec" not in kw:
        with _jax_weights(), pytest.raises(ValueError, match=match) as want:
            JaxCore(JaxEngineConfig(
                model=jl.preset(name, dtype=jnp.float32), **cfg))
        assert str(got.value) == str(want.value)
    elif "spec" in kw:
        assert str(got.value) == ("KV paging does not compose with "
                                  "speculative decoding")
    else:
        why = jprog.PagedPrograms.validate(
            type("C", (), {"model": jl.preset(name), "pp": 1, "sp": 1})())
        assert str(got.value) == f"KV paging does not support {why}"


def test_engine_args_and_knobs_reach_the_lane(monkeypatch):
    """``kvpage_*`` are engine arguments now (not refused as unported),
    config fields win over the knobs, the knobs fill what is unset."""
    from dynamo_tpu.llm.kvpage.runner import PagedConfig as JCfg
    from dynamo_tpu_torch.engine import engine as te
    from dynamo_tpu_torch.llm.kvpage.runner import PagedConfig as TCfg
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard

    assert not {k for k in te._NOT_PORTED if k.startswith("kvpage")}
    card = ModelDeploymentCard.synthetic()
    cfg = TorchEngineConfig.from_card(card, preset="tiny-byte",
                                      kvpage_budget=12, kvpage_batch=2)
    assert (cfg.kvpage_budget, cfg.kvpage_batch) == (12, 2)
    env = {"DYN_KVPAGE_DEVICE_BUDGET": "9", "DYN_KVPAGE_SEG_PAGES": "3",
           "DYN_KVPAGE_PREFETCH": "0", "DYN_KVPAGE_MAX_CONTEXT": "5000",
           "DYN_KVPAGE_BATCH": "3"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for over in ({}, dict(kvpage_budget=0), dict(kvpage_seg_pages=5,
                                                 kvpage_batch=1)):
        t = TorchEngineConfig(model=tl.preset("tiny-byte"), **over)
        j = JaxEngineConfig(model=jl.preset("tiny-byte"), **over)
        tr, jr = TCfg.resolve(t), JCfg.resolve(j)
        assert (tr and tr.__dict__) == (jr and jr.__dict__)


# ---------------------------------------------------------------------------
# PageScheduler
# ---------------------------------------------------------------------------
BLK = (2, 2, 8, 4)          # [L, Hkv, page, Dh] toy tier-block geometry


def _blk(seed: float):
    k = np.full(BLK, seed, np.float32)
    return k, -k


def _tier(blocks=8, seeds=()):
    t = TieredKvCache(HostKvTier(blocks, BLK, np.float32))
    for h, s in seeds:
        t.offload(h, *_blk(s))
    return t


@pytest.mark.parametrize("prefetch", [0, 2])
def test_pager_segments_and_counts_match_jax(prefetch):
    """The same random blocks in both packages' tiers, the same plans on
    two lanes: every assembled segment equal bit for bit, the same
    page-in and fault counts."""
    from dynamo_tpu.llm.kvbm import tiers as jt
    from dynamo_tpu.llm.kvpage import pager as jp

    rng = np.random.default_rng(prefetch)
    blocks = {h: (rng.standard_normal(BLK).astype(np.float32),
                  rng.standard_normal(BLK).astype(np.float32))
              for h in range(1, 12)}
    tiers = (jt.TieredKvCache(jt.HostKvTier(16, BLK, np.float32)),
             _tier(blocks=16))
    for t in tiers:
        for h, (k, v) in blocks.items():
            t.offload(h, k, v)
    plans = {0: [[(1, 2, 3), (4,)], [(1, 2, 3)]],
             1: [[(5, 6), (7, 8), (9, 10), (11,)], []]}
    got = []
    for mod, tier in zip((jp, None), tiers):
        sched = (mod.PageScheduler if mod else PageScheduler)(
            tier, seg_pages=3, prefetch=prefetch)
        plan_cls = mod.PageinPlan if mod else PageinPlan
        out = []
        try:
            for lane, segs in plans.items():
                sched.begin(plan_cls(segs), lane=lane)
            for lane, segs in plans.items():
                for key in plan_cls(segs).items():
                    out.append(sched.take(key, lane=lane))
            out.append((sched.pageins, sched.faults))
        finally:
            sched.close()
        got.append(out)
    want, mine = got
    assert mine[-1] == want[-1]
    assert mine[-1] == ((0, 7) if prefetch == 0 else (7, 0))
    for (gk, gv, gn), (wk, wv, wn) in zip(mine[:-1], want[:-1]):
        assert gn == wn and gk.dtype == wk.dtype
        assert gk.tobytes() == wk.tobytes() and gv.tobytes() == wv.tobytes()


def test_pager_miss_is_fatal_and_end_lane_drops_state():
    ps = PageScheduler(_tier(seeds=[(1, 1.0)]), seg_pages=2, prefetch=2)
    try:
        ps.begin(PageinPlan([[(99,)]]))
        with pytest.raises(KvPageMiss):
            ps.take((0, 0))
        ps.begin(PageinPlan([[(1,)]]), lane=3)
        assert _wait(lambda: ps._lanes[3].next == 1)
        ps.end_lane(3)                          # sequence released
        assert 3 not in ps._lanes
        with pytest.raises(KvPageMiss):         # no plan -> typed miss
            ps.take((0, 0), lane=3)
    finally:
        ps.close()


def _wait(cond, timeout=5.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if cond():
            return True
        time.sleep(0.005)
    return False


def test_pager_interleaves_lanes_and_isolates_faults():
    """A skewed lane (16 segments against 4) cannot starve its neighbour:
    backpressure is per lane. A missing block faults only its own lane,
    which recovers with a fresh plan."""
    tier = _tier(blocks=32, seeds=[(h, float(h)) for h in range(1, 25)])
    ps = PageScheduler(tier, seg_pages=2, prefetch=2)
    try:
        ps.begin(PageinPlan([[(h,) for h in range(1, 17)]]), lane=0)
        ps.begin(PageinPlan([[(h,) for h in range(21, 25)]]), lane=1)
        assert _wait(lambda: ps._lanes[0].next == 2
                     and ps._lanes[1].next == 2)
        time.sleep(0.05)
        assert ps._lanes[0].next == 2
        for s in range(4):
            k, v, n = ps.take((0, s), lane=1)
            assert n == 1
            np.testing.assert_array_equal(
                k[0], np.full(BLK[1:], float(21 + s), np.float32))
        assert _wait(lambda: ps._lanes[1].next == 4)
        assert ps._lanes[0].next == 2
        assert {ln for ln, _ in list(ps.claim_log)[:4]} == {0, 1}
        for s in range(16):
            ps.take((0, s), lane=0)
        assert ps.faults == 0 and ps.pageins == 20
        # fault isolation
        ps.begin(PageinPlan([[(99,), (1,)]]), lane=0)
        ps.begin(PageinPlan([[(2,), (3,), (4,)]]), lane=1)
        with pytest.raises(KvPageMiss):
            ps.take((0, 0), lane=0)
        for s in range(3):
            k, _, _ = ps.take((0, s), lane=1)
            np.testing.assert_array_equal(
                k[0], np.full(BLK[1:], float(2 + s), np.float32))
        ps.begin(PageinPlan([[(5,), (6,)]]), lane=0)
        k, _, _ = ps.take((0, 0), lane=0)
        np.testing.assert_array_equal(k[0],
                                      np.full(BLK[1:], 5.0, np.float32))
    finally:
        ps.close()


def test_tier_pins_and_concurrency_demote_vs_writethrough_vs_donor():
    """Pinned blocks survive LRU pressure and an all-pinned tier refuses a
    pinned deposit; then demotions, write-through offloads and donor
    peeks hammer one tier from three threads under its lock: no torn
    read, one on_change a deposit, every pin dropped at the end."""
    tier = _tier(blocks=2)
    tier.deposit_pinned(1, *_blk(1.0))
    tier.deposit_pinned(2, *_blk(2.0))
    with pytest.raises(OutOfTierSpace):
        tier.deposit_pinned(3, *_blk(3.0))
    tier.offload(4, *_blk(4.0))             # cache insert: dropped
    assert 4 not in tier and 1 in tier and 2 in tier
    tier = _tier(blocks=64)
    changes, errors = [], []
    tier.on_change = lambda: changes.append(1)
    stop = threading.Event()

    def demoter():
        try:
            for i in range(200):
                tier.deposit_pinned(1000 + i, *_blk(float(i)))
                if i >= 32:
                    tier.unpin(1000 + i - 32)
            for i in range(168, 200):
                tier.unpin(1000 + i)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    def writethrough():
        try:
            for i in range(200):
                tier.offload(2000 + i, *_blk(float(i)))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    def donor():
        try:
            while not stop.is_set():
                for h in (1000, 1050, 2000, 2100):
                    got = tier.peek(h)
                    if got is not None:
                        assert (got[0] == got[0].flat[0]).all(), "torn"
                    got = tier.peek_layer(h, 1)
                    if got is not None:
                        assert (got[0] == got[0].flat[0]).all(), "torn"
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=f)
               for f in (demoter, writethrough, donor)]
    for t in threads:
        t.start()
    threads[0].join(), threads[1].join()
    stop.set()
    threads[2].join()
    assert not errors, errors
    assert len(changes) == 400
    assert tier.pinned_count() == 0
