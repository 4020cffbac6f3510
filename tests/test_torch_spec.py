"""Speculative decoding in the torch port against the JAX package.

- ``engine/spec.py``: ``SpecConfig`` buckets and adaptive k, ``resolve_spec``
  from config and ``DYN_SPEC*`` (with the invalid-mode error), the n-gram
  proposer over seeded token lists, and the draft proposer given the JAX
  proposer's draft weights (``params_from_jax``): equal proposals, sync and
  rollback independent of the path, ``drop`` leaving no state.
- ``engine/sampling.py``: ``spec_verify`` on the JAX function's seeded f32
  logits (greedy tokens equal, probabilities within 1e-5, sampled tokens in
  the masked window, residuals never the draft), ``spec_accept`` equal, and
  the rejection-sampling distribution test of ``tests/test_spec.py``.
- The engine (tiny-byte f32, the JAX engine's weights): greedy streams with
  spec on equal spec off and the JAX engine with spec on; rejected drafts
  seal no block (the same hash chain as spec off, and a sequence that ends
  on a rejected draft's slot gives a cold engine's tokens on its next
  turn); sampled streams do not depend on a drafting batchmate; the accept
  rate rides ``ForwardPassMetrics``; KV injected from a spec-off engine
  decodes the spec-off tokens.

The JAX engine is built once for the module, as ``tests/test_spec.py`` does.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import sampling as js
from dynamo_tpu.engine import spec as jspec
from dynamo_tpu.engine.engine import EngineCore as JaxCore, JaxEngineConfig
from dynamo_tpu.llm.protocols import common as jcommon
from dynamo_tpu.models import llama as jl
from dynamo_tpu_torch.engine import sampling as ts
from dynamo_tpu_torch.engine import spec as tspec
from dynamo_tpu_torch.engine.engine import EngineCore, TorchEngineConfig
from dynamo_tpu_torch.llm.protocols import common as tcommon
from dynamo_tpu_torch.llm.protocols.common import (BackendInput,
                                                   SamplingOptions,
                                                   StopConditions)
from dynamo_tpu_torch.models import llama as tl

torch.set_num_threads(2)

TOL = 1e-5
CPU = torch.device("cpu")
ENGINE = dict(page_size=8, max_batch=2, max_context=128, prefill_chunk=32)
# the JAX test's mix (repetitive, plain, presence penalty) and a prompt
# whose greedy continuation repeats, so drafts are accepted
MIX = {"a": ([5, 6, 7, 8] * 3, 12, {}),
       "b": ([9, 10, 11], 8, {}),
       "c": ([20, 21, 22], 8, {"presence_penalty": 0.5}),
       "r": ([197] * 4, 16, {})}


# ---------------------------------------------------------------------------
# engine/spec.py host units
# ---------------------------------------------------------------------------

def _cfg_ns(spec=None, spec_k=None, spec_draft=None):
    return types.SimpleNamespace(spec=spec, spec_k=spec_k,
                                 spec_draft=spec_draft)


@pytest.mark.parametrize("cfg,env", [
    ({}, {}),
    ({}, {"DYN_SPEC": "ngram", "DYN_SPEC_K": "7"}),
    ({"spec": "off"}, {"DYN_SPEC": "ngram"}),
    ({"spec": "ngram", "spec_k": 2}, {"DYN_SPEC_K": "7"}),
    ({"spec": "NGram "}, {"DYN_SPEC_K_MIN": "3", "DYN_SPEC_ADAPT": "0",
                          "DYN_SPEC_NGRAM_MAX": "5",
                          "DYN_SPEC_NGRAM_MIN": "2",
                          "DYN_SPEC_NGRAM_WINDOW": "3"}),
    ({"spec": "draft"}, {"DYN_SPEC_DRAFT": "tiny-byte", "DYN_SPEC_K": "x"}),
    ({"spec": "draft", "spec_draft": "llama-3.2-1b", "spec_k": 6}, {}),
    ({}, {"DYN_SPEC": "bogus"}),
])
def test_spec_config_and_resolve_match_jax(monkeypatch, cfg, env):
    for name in ("DYN_SPEC", "DYN_SPEC_K", "DYN_SPEC_K_MIN", "DYN_SPEC_ADAPT",
                 "DYN_SPEC_NGRAM_MAX", "DYN_SPEC_NGRAM_MIN",
                 "DYN_SPEC_NGRAM_WINDOW", "DYN_SPEC_DRAFT"):
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = []
    for mod in (jspec, tspec):
        try:
            sc = mod.resolve_spec(_cfg_ns(**cfg))
        except ValueError as e:
            got.append(("error", str(e)))
            continue
        if sc is None:
            got.append(None)
            continue
        k_range = range(0, sc.k_max + 3)
        got.append((dict(sc.__dict__), [sc.bucket(k) for k in k_range],
                    [sc.next_k(k, a, p) for k in range(1, sc.k_max + 1)
                     for p in range(0, 3) for a in range(0, p + 1)]))
    assert got[1] == got[0]
    if env.get("DYN_SPEC") == "bogus":
        assert got[1][0] == "error"
        with pytest.raises(ValueError, match="ngram|draft"):
            EngineCore(_tcfg(spec=None))
        with pytest.raises(ValueError, match="ngram|draft"):
            EngineCore(_tcfg(spec="medusa"))


def _tokens(seed, n, vocab):
    return [int(t) for t in np.random.default_rng(seed).integers(0, vocab,
                                                                  n)]


@pytest.mark.parametrize("seed,n,vocab,ngram_min,ngram_max,window,k", [
    (0, 40, 6, 1, 3, 2048, 4),        # many repeats
    (1, 40, 1000, 1, 3, 2048, 4),     # almost none
    (2, 60, 3, 2, 4, 2048, 3),
    (3, 25, 5, 3, 3, 2048, 5),
    (4, 64, 4, 1, 3, 8, 4),           # the match must lie in the window
    (5, 64, 4, 1, 2, 4, 2),           # the window's smallest size
    (6, 3, 2, 1, 3, 2048, 4),         # shorter than the n-grams
])
def test_ngram_proposals_match_jax(seed, n, vocab, ngram_min, ngram_max,
                                   window, k):
    kw = dict(mode="ngram", k_max=k, ngram_min=ngram_min,
              ngram_max=ngram_max, ngram_window=window)
    jp = jspec.NgramProposer(jspec.SpecConfig(**kw))
    tp = tspec.NgramProposer(tspec.SpecConfig(**kw))
    toks = _tokens(seed, n, vocab)
    for L in range(1, n + 1):
        st_j = jspec.SeqSpecState(tokens=toks[:L], k=k)
        st_t = tspec.SeqSpecState(tokens=toks[:L], k=k)
        for kk in (1, k):
            assert tp.propose("s", st_t, kk) == jp.propose("s", st_j, kk)


# ---------------------------------------------------------------------------
# engine/sampling.py: verify sampling and acceptance
# ---------------------------------------------------------------------------

def _verify_inputs(seed, B=6, K=3, V=300):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, K + 1, V)) * 3.0).astype(np.float32)
    # drafts: the argmax, a window token, and one far outside the window
    drafts = np.zeros((B, K), np.int64)
    for b in range(B):
        for i in range(K):
            order = np.argsort(-logits[b, i])
            drafts[b, i] = order[[0, 3, 200][(b + i) % 3]]
    temp = np.asarray([0.0, 0.7, 1.0, 1.3, 0.9, 1.0], np.float32)[:B]
    top_p = np.asarray([1.0, 0.9, 1.0, 0.5, 1.0, 0.95], np.float32)[:B]
    top_k = np.asarray([0, 0, 10, 0, 1, 40], np.int64)[:B]
    return logits, drafts, temp, top_p, top_k


def _torch_verify(logits, drafts, temp, top_p, top_k, seed=0):
    K = drafts.shape[1]
    gens = [ts.lane_generator(seed + b) for b in range(len(temp))]
    u = torch.from_numpy(ts.spec_uniforms(gens, K, K))
    packed = ts.spec_verify(torch.from_numpy(logits),
                            torch.from_numpy(drafts), torch.from_numpy(temp),
                            torch.from_numpy(top_p), torch.from_numpy(top_k),
                            u)
    assert packed.shape == (len(temp), ts.spec_pack_width(K))
    return ts.spec_unpack(packed.numpy(), K)


def _window_tokens(row, temp, top_p, top_k):
    """The masked sampling window's token set (numpy, sample()'s rule)."""
    order = np.argsort(-row, kind="stable")[:64]
    z = row[order] / max(temp, 1e-6)
    p = np.exp(z - z.max())
    p /= p.sum()
    keep = (np.cumsum(p) - p) < top_p
    if top_k > 0:
        keep[top_k:] = False
    return set(order[keep].tolist())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spec_verify_matches_jax(seed):
    logits, drafts, temp, top_p, top_k = _verify_inputs(seed)
    B, K = drafts.shape
    keys = jax.random.split(jax.random.key(seed), B)
    jp, _ = jax.jit(js.spec_verify)(jnp.asarray(logits),
                           jnp.asarray(drafts.astype(np.int32)),
                           jnp.asarray(temp), jnp.asarray(top_p),
                           jnp.asarray(top_k.astype(np.int32)), keys)
    want = js.spec_unpack(np.asarray(jp), K)
    got = _torch_verify(logits, drafts, temp, top_p, top_k, seed)
    np.testing.assert_array_equal(got["greedy_tok"], want["greedy_tok"])
    for name in ("logp_greedy", "logp_draft", "p_draft"):
        np.testing.assert_allclose(got[name], want[name], atol=TOL, rtol=0)
    assert ((got["u"] >= 0) & (got["u"] < 1)).all()
    resid_checked = 0
    for b in range(B):
        for t in range(K + 1):
            win = _window_tokens(logits[b, t], temp[b], top_p[b], top_k[b])
            assert int(got["full_tok"][b, t]) in win
            if t < K and len(win - {int(drafts[b, t])}):
                assert int(got["resid_tok"][b, t]) in win
                assert int(got["resid_tok"][b, t]) != drafts[b, t]
                resid_checked += 1
    assert resid_checked >= B
    # a draft far outside the window has no target mass
    far = [(b, i) for b in range(B) for i in range(K) if (b + i) % 3 == 2]
    assert all(got["p_draft"][b, i] == 0.0 for b, i in far)


def test_rejection_sampling_preserves_distribution():
    """``tests/test_spec.py``'s bound on the port's sampler: accept-or-
    resample of a point-mass draft reproduces the target distribution."""
    N, K, V, p0 = 4000, 1, ts.STATIC_K, 0.6
    logits = np.full((N, K + 1, V), -1e9, np.float32)
    logits[:, :, 0] = np.log(p0)
    logits[:, :, 1] = np.log(1.0 - p0)
    r = _torch_verify(logits, np.zeros((N, K), np.int64),
                      np.ones(N, np.float32), np.ones(N, np.float32),
                      np.zeros(N, np.int64), seed=1234)
    firsts = np.asarray([
        ts.spec_accept([0], False, {k: v[i] for k, v in r.items()})[0][0]
        for i in range(N)])
    assert set(np.unique(firsts)) <= {0, 1}
    freq0 = float(np.mean(firsts == 0))
    bound = 4 * (p0 * (1 - p0) / N) ** 0.5
    assert abs(freq0 - p0) < bound, f"freq {freq0} vs target {p0} ± {bound}"


@pytest.mark.parametrize("greedy", [True, False])
def test_spec_accept_matches_jax(greedy):
    rng = np.random.default_rng(3)
    K = 4
    for trial in range(60):
        n = int(rng.integers(0, K + 1))
        drafts = [int(t) for t in rng.integers(0, 5, n)]
        lane = {"greedy_tok": rng.integers(0, 5, K + 1).astype(np.float32),
                "logp_greedy": -rng.random(K + 1),
                "full_tok": rng.integers(0, 5, K + 1).astype(np.float32),
                "logp_full": -rng.random(K + 1),
                "resid_tok": rng.integers(0, 5, K).astype(np.float32),
                "logp_resid": -rng.random(K),
                "logp_draft": -rng.random(K),
                "p_draft": rng.random(K), "u": rng.random(K)}
        assert ts.spec_accept(drafts, greedy, lane) == \
            js.spec_accept(drafts, greedy, lane)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _tcfg(**kw):
    d = dict(model=tl.preset("tiny-byte", dtype=torch.float32), device="cpu",
             **ENGINE)
    d.update(kw)
    return TorchEngineConfig(**d)


@pytest.fixture(scope="module")
def jax_spec():
    """The JAX engine with n-gram spec on (f32 tiny-byte), its streams for
    :data:`MIX` and its weights."""
    core = JaxCore(JaxEngineConfig(
        model=jl.preset("tiny-byte", dtype=jnp.float32), tp=1,
        spec="ngram", spec_k=2, **ENGINE))
    streams = _run_mix(core, jcommon)
    assert core.spec_accepted_total > 0
    return streams, jax.tree.map(lambda a: np.array(a), core.params)


def _run_mix(core, pkg, names=None):
    for sid in names or MIX:
        prompt, n, sp = MIX[sid]
        core.submit(sid, pkg.BackendInput(
            token_ids=prompt, stop=pkg.StopConditions(max_tokens=n),
            sampling=pkg.SamplingOptions(**sp)))
    return {sid: [so.token for so in outs]
            for sid, outs in _drain(core, list(names or MIX)).items()}


def _drain(core, want):
    got = {s: [] for s in want}
    done = set()
    for _ in range(800):
        for so in core.step():
            got[so.seq_id].append(so)
            if so.finish is not None:
                done.add(so.seq_id)
        if done >= set(want):
            return got
    raise AssertionError(f"not all finished: {done} vs {want}")


@pytest.fixture(scope="module")
def params(jax_spec):
    return tl.params_from_jax(jax_spec[1], _tcfg().model, CPU)


@pytest.fixture(scope="module")
def base_core(params):
    return EngineCore(_tcfg(spec="off"), params)


@pytest.fixture(scope="module")
def spec_core(params):
    return EngineCore(_tcfg(spec="ngram", spec_k=2), params)


def test_greedy_spec_streams_match_spec_off_and_jax(jax_spec, base_core,
                                                    spec_core):
    want = jax_spec[0]
    assert base_core.spec is None and base_core.proposer is None
    acc0 = spec_core.spec_accepted_total
    assert _run_mix(spec_core, tcommon) == want
    assert _run_mix(base_core, tcommon) == want
    assert spec_core.spec_accepted_total > acc0
    assert spec_core.active == 0 and not spec_core._spec_states
    # no_spec: the lane rides the verify with zero drafts
    before = spec_core.spec_proposed_total
    spec_core.submit("o", BackendInput(token_ids=[197] * 4, no_spec=True,
                                       stop=StopConditions(max_tokens=16)))
    toks = [so.token for so in _drain(spec_core, ["o"])["o"]]
    assert toks == want["r"]
    assert spec_core.spec_proposed_total == before


def _sealed_run(core, sid, prompt, n):
    sealed = []
    core.pool.on_block_sealed = (
        lambda seq, blk, page, lora: sealed.append(blk.sequence_hash))
    try:
        core.submit(sid, BackendInput(token_ids=prompt,
                                      stop=StopConditions(max_tokens=n)))
        toks = [so.token for so in _drain(core, [sid])[sid]]
    finally:
        core.pool.on_block_sealed = None
    return toks, sealed


def test_rollback_seals_the_spec_off_chain(base_core, spec_core):
    prop0, acc0 = spec_core.spec_proposed_total, spec_core.spec_accepted_total
    # non-repetitive prompt: drafts fire and are mostly rejected
    t1, sealed1 = _sealed_run(base_core, "r", [3, 1, 4, 1, 5, 9, 2, 6], 18)
    t2, sealed2 = _sealed_run(spec_core, "r", [3, 1, 4, 1, 5, 9, 2, 6], 18)
    assert t1 == t2
    assert (spec_core.spec_proposed_total - prop0
            > spec_core.spec_accepted_total - acc0)
    assert sealed1 == sealed2 and len(sealed1) >= 2
    for core in (base_core, spec_core):
        assert core.pool.free_pages == core.pool.num_pages - 1


def test_rejected_draft_on_a_blocks_last_slot_is_not_reused(params):
    """A sequence that ends on a correction token whose slot holds a
    rejected draft's KV, at the last slot of a block: the next turn must
    give a cold engine's tokens (the block was unsealed at release)."""
    prompt = [80] * 4
    probe = EngineCore(_tcfg(spec="ngram", spec_k=2), params)
    rounds = []
    real = probe._spec_round

    def spy(out):
        n0 = {s.seq_id: s.generated for s in probe.slots if s is not None}
        a0 = probe.spec_accepted_total
        p0 = probe.spec_proposed_total
        real(out)
        rounds.append((n0.get("p", 0), probe.spec_proposed_total - p0,
                       probe.spec_accepted_total - a0))

    probe._spec_round = spy
    probe.submit("p", BackendInput(token_ids=prompt,
                                   stop=StopConditions(max_tokens=60)))
    _drain(probe, ["p"])
    # the emitted correction token after acc accepted drafts is generated
    # token number g0 + acc + 1, at position len(prompt) + g0 + acc
    ends = [g0 + acc + 1 for g0, d, acc in rounds
            if acc < d and (len(prompt) + g0 + acc + 1) % 8 == 0]
    assert ends, rounds
    m = ends[0]
    warm = EngineCore(_tcfg(spec="ngram", spec_k=2), params)
    cold = EngineCore(_tcfg(spec="ngram", spec_k=2,
                            enable_prefix_reuse=False), params)
    removed = []
    warm.pool.on_blocks_removed = removed.extend
    first, _ = _sealed_run(warm, "a", prompt, m)
    assert len(first) == m and removed        # the stale block unsealed
    turn2 = prompt + first + [50, 51, 52, 53, 54]
    want, _ = _sealed_run(cold, "b", turn2, 6)
    got, _ = _sealed_run(warm, "b", turn2, 6)
    assert got == want
    assert warm.last_prefix_hit == len(prompt) + m - 8


def test_sampled_stream_ignores_a_drafting_batchmate(spec_core):
    sampled = BackendInput(token_ids=[40, 41, 42],
                           stop=StopConditions(max_tokens=20),
                           sampling=SamplingOptions(temperature=0.8, seed=5))
    spec_core.submit("s", sampled)
    alone = [so.token for so in _drain(spec_core, ["s"])["s"]]
    k0 = spec_core.spec_accepted_total
    spec_core.submit("s", sampled)
    spec_core.submit("r", BackendInput(token_ids=[197] * 4,
                                       stop=StopConditions(max_tokens=16)))
    both = _drain(spec_core, ["s", "r"])
    assert [so.token for so in both["s"]] == alone
    assert spec_core.spec_accepted_total > k0    # the batchmate drafted


def test_accept_rate_rides_forward_pass_metrics(spec_core):
    from dynamo_tpu_torch.llm.kv_router.protocols import ForwardPassMetrics

    _run_mix(spec_core, tcommon, ["r"])
    u = spec_core.utilization()
    assert 0.0 < u["spec_accept_rate"] <= 1.0
    assert u["spec_accept_rate"] == (spec_core.spec_accepted_total
                                     / spec_core.spec_proposed_total)
    m = ForwardPassMetrics(**u)
    assert ForwardPassMetrics.from_dict(m.to_dict()).spec_accept_rate == \
        u["spec_accept_rate"]


def test_injected_kv_decodes_the_spec_off_tokens(base_core, spec_core):
    req = BackendInput(token_ids=[197] * 12,
                       stop=StopConditions(max_tokens=16))
    base_core.submit("x", req)
    want = [so.token for so in _drain(base_core, ["x"])["x"]]
    k, v, tok, lp = base_core.prefill_extract("pf", req)
    acc0 = spec_core.spec_accepted_total
    first = spec_core.inject_prefilled("y", req, k, v, tok, lp)
    rest = [so.token for so in _drain(spec_core, ["y"])["y"]]
    assert [first.token] + rest == want
    assert spec_core.spec_accepted_total > acc0


def test_spec_args_reach_the_engine_from_the_cli_and_env(monkeypatch):
    from dynamo_tpu_torch.cli import run, worker
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard

    card = ModelDeploymentCard.synthetic("t")
    cfg = TorchEngineConfig.from_card(card, spec="ngram", spec_k=4,
                                      spec_draft="tiny-byte")
    assert (cfg.spec, cfg.spec_k, cfg.spec_draft) == ("ngram", 4, "tiny-byte")
    args = run.parse_args(["in=http", "out=torch", "--device", "cpu",
                           "--extra-engine-args",
                           '{"spec":"ngram","spec_k":3}'])
    _, _, engine = run.make_engines(args, run.make_card(args))
    try:
        assert engine.core.spec.k_max == 3
    finally:
        engine.shutdown()
    monkeypatch.setenv("DYN_SPEC", "draft")
    monkeypatch.setenv("DYN_SPEC_K", "2")
    wargs = types.SimpleNamespace(extra_engine_args=None, device="cpu")
    core = EngineCore(worker._engine_cfg(wargs, card))
    assert core.spec.mode == "draft" and core.spec.k_max == 2
    assert isinstance(core.proposer, tspec.DraftModelProposer)
    assert core.proposer.mcfg.vocab_size <= core.cfg.model.vocab_size


# ---------------------------------------------------------------------------
# the draft-model proposer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def draft_pair():
    """The JAX draft proposer (f32 tiny-byte, seed + 101) and a port
    factory given its weights."""
    sc_kw = dict(mode="draft", k_max=2)
    jcfg = JaxEngineConfig(model=jl.preset("tiny-byte", dtype=jnp.float32),
                           tp=1, page_size=8, max_batch=1, max_context=64,
                           prefill_chunk=8)
    orig = jl.preset
    jl.preset = lambda name, **kw: orig(name, **{"dtype": jnp.float32, **kw})
    try:
        jp = jspec.DraftModelProposer(jspec.SpecConfig(**sc_kw), jcfg,
                                      s_buckets=[32, 64], c_buckets=[8])
    finally:
        jl.preset = orig
    tcfg = _tcfg(max_batch=1, max_context=64, prefill_chunk=8)
    tparams = tl.params_from_jax(jax.tree.map(np.asarray, jp.params),
                                 tl.preset("tiny-byte", dtype=torch.float32),
                                 CPU)

    def make():
        return tspec.DraftModelProposer(tspec.SpecConfig(**sc_kw), tcfg,
                                        params=tparams)

    return jp, make


def test_draft_proposer_matches_jax_and_rolls_back(draft_pair):
    jp, make = draft_pair
    tp = make()
    ctx = [5, 6, 7, 8, 9] + _tokens(7, 12, 250)      # > one sync chunk
    st_j = jspec.SeqSpecState(tokens=list(ctx), k=2)
    st_t = tspec.SeqSpecState(tokens=list(ctx), k=2)
    d1 = tp.propose("s", st_t, 2)
    assert d1 == jp.propose("s", st_j, 2) and len(d1) == 2
    assert tp.sync_dispatches == 2 and tp.steps_run == 2
    # both drafts rejected, a correction committed instead: the stale
    # drafted KV is overwritten by the next sync
    for st in (st_j, st_t):
        st.tokens += [d1[0] ^ 1, 3]
    d2 = tp.propose("s", st_t, 2)
    assert d2 == jp.propose("s", st_j, 2)
    fresh = make()
    assert fresh.propose("t", tspec.SeqSpecState(tokens=list(st_t.tokens),
                                                 k=2), 2) == d2
    assert tp.propose("s", st_t, 1) == d2[:1]
    tp.drop("s")
    assert tp.synced == {} and not tp.pool.seqs
    assert tp.pool.free_pages == tp.pool.num_pages - 1
    jp.drop("s")
