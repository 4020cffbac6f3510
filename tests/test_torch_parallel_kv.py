"""The KV block manager, disaggregation and speculative decoding at tp=2,
held against the JAX ``EngineCore`` at tp=2 (the virtual mesh) and the
port at tp=1.

Ranks are threads with a gloo group each, and the leader's frames reach
the follower over the dispatch plane on localhost, as in
``tests/test_torch_parallel.py``. f32 presets, so greedy ids are exact.

- (a) A small pool evicts a prompt's blocks to the host tier (or, with a
  two-block host tier, on to the disk tier); a second prompt sharing its
  3-page prefix restores them: greedy ids and ``kv_prefix_hit_tokens``
  equal JAX's.
- (b) The leader's offloaded blocks equal tp=1's whole blocks within 16
  f32 ulps of their largest magnitude (3.8e-5 at |k| = 20), also where the
  ranks replicate the kv head (``tiny-gemma``).
- (c) ``prefill_extract`` at tp=2 injects into tp=1 and the reverse: the
  greedy ids equal JAX's aggregated ids, the KV JAX's extract within 128
  f32 ulps of its largest magnitude, the bound of tp=1's extract in
  ``tests/test_torch_disagg.py``.
- (d) The same KV, layer-streamed through ``KvIngest`` into tp=2.
- (e) Cluster write-through: every sealed block reaches the leader's tier
  whole and equals tp=1's.
- (f) n-gram speculative decoding: greedy ids equal JAX's without spec;
  the follower replays a ``verify`` frame for every round the leader ran.
- (g) A bad inject payload errors its request, sends no KV frame and does
  not end the worker, which then serves JAX's ids.
- (h) Every frame kind the slice adds round-trips through the JAX codec.
- ``cli.prefill_worker --tp 2`` starts its follower process and extracts
  a tp=1 engine's KV.
"""

import asyncio
import collections
import datetime
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from dynamo_tpu.engine.engine import EngineCore as JaxCore, JaxEngineConfig
from dynamo_tpu.llm.protocols.common import (BackendInput as JBI,
                                             StopConditions as JSC)
from dynamo_tpu.models import llama as jl
from dynamo_tpu_torch.engine import engine as eng
from dynamo_tpu_torch.engine.engine import EngineCore, TorchEngineConfig
from dynamo_tpu_torch.llm.protocols.common import (BackendInput,
                                                   FinishReason,
                                                   StopConditions)
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.parallel import multihost as mh
from dynamo_tpu_torch.parallel.mesh import serving_mesh
from dynamo_tpu_torch.runtime.engine import Context

torch.set_num_threads(2)

CPU = torch.device("cpu")
ENGINE = dict(page_size=8, max_batch=2, max_context=64, prefill_chunk=32,
              decode_steps=1)
TOKENS = 5
# (a): an 8-page pool; C's 48 tokens evict every block A parked
TIERS = {"host": dict(num_pages=8, host_cache_blocks=16),
         "disk": dict(num_pages=8, host_cache_blocks=2,
                      disk_cache_blocks=16)}
_rng = np.random.default_rng(7)
BASE = [int(t) for t in _rng.integers(1, 250, 28)]
SCHEDULE = [("a", BASE), ("c", [int(t) for t in _rng.integers(1, 250, 48)]),
            ("b", BASE[:24] + [int(t) for t in _rng.integers(1, 250, 6)])]
PROMPT = [int(t) for t in _rng.integers(1, 250, 40)]     # disagg: 2 chunks
SPEC_PROMPT = [5, 6, 7, 8] * 5                           # n-gram drafts
EPS = np.finfo(np.float32).eps


def _close(got, want, ulps):
    """Within ``ulps`` f32 ulps of ``want``'s largest magnitude. The copies
    move bits, but the values come from forwards that round differently
    (a rank's partial products summed over tp; JAX's XLA against torch),
    and |k|, |v| reach ~25 here, where an f32 ulp is 1.9e-6."""
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ulps * EPS * np.abs(want).max())


def _drive(core, bi, sc, sid, tokens, n=TOKENS):
    """Greedy ids and ``kv_prefix_hit_tokens`` of one request alone."""
    core.submit(sid, bi(token_ids=list(tokens),
                        stop=sc(max_tokens=n, ignore_eos=True)))
    got, hit = [], None
    for _ in range(300):
        for so in core.step():
            assert so.seq_id == sid and so.finish != FinishReason.ERROR, so
            got.append(so.token)
            if so.prefix_hit is not None:
                hit = so.prefix_hit
            if so.finish is not None:
                return got, hit
    raise AssertionError(f"{sid} did not finish")


def _decode(core, sid):
    """The ids of an injected sequence's decode, after its first."""
    got = []
    for _ in range(300):
        for so in core.step():
            got.append(so.token)
            if so.finish is not None:
                return got
    raise AssertionError(f"{sid} did not finish")


def _jax_core(**kw):
    return JaxCore(JaxEngineConfig(
        model=jl.preset("tiny-byte", dtype=jnp.float32), tp=2,
        **{**ENGINE, **kw}), jax.devices()[:2])


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX EngineCore's answers at tp=2, its two engines built at
    once (their compiles dominate this file's time): (a)'s schedule on a
    host tier, and on a plain engine the disagg prompt's extract and
    aggregated ids and the spec prompt's ids."""
    out = {}

    def tiers():
        core = _jax_core(**TIERS["host"])
        try:
            out["schedule"] = {sid: _drive(core, JBI, JSC, sid, toks)
                               for sid, toks in SCHEDULE}
        finally:
            core.close()

    def plain():
        # no reuse: the aggregated run prefills cold, as the disagg one
        core = _jax_core(enable_prefix_reuse=False)
        try:
            k, v, tok, lp = core.prefill_extract("x", JBI(
                token_ids=PROMPT, stop=JSC(max_tokens=TOKENS,
                                           ignore_eos=True)))
            out["extract"] = (np.asarray(k), np.asarray(v), int(tok))
            out["disagg"] = _drive(core, JBI, JSC, "p", PROMPT)[0]
            out["spec"] = _drive(core, JBI, JSC, "s", SPEC_PROMPT, 12)[0]
            out["params"] = jax.tree.map(np.array, core.params)
        finally:
            core.close()

    threads = [threading.Thread(target=f) for f in (tiers, plain)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert {"schedule", "params"} <= set(out)
    return out


@functools.lru_cache(maxsize=None)
def _gemma_params():
    """tiny-gemma (Hkv=1 < tp: both ranks keep kv head 0) weights."""
    cfg = tl.preset("tiny-gemma", dtype=torch.float32)
    return {k: (v.numpy() if not isinstance(v, dict)
                else {n: w.numpy() for n, w in v.items()})
            for k, v in tl.init_params(cfg, torch.Generator().manual_seed(5),
                                       CPU).items()}


def _cfg(name, **kw):
    return tl.preset(name, dtype=torch.float32), {**ENGINE, **kw}


def _tp1(np_params, name="tiny-byte", **kw):
    tcfg, ekw = _cfg(name, **kw)
    return EngineCore(TorchEngineConfig(model=tcfg, device="cpu", **ekw),
                      tl.params_from_jax(np_params, tcfg, CPU))


def _pair(np_params, drive, name="tiny-byte", engine=False, **kw):
    """A tp=2 leader and follower (threads, a gloo group each) on the
    dispatch plane: ``drive(leader)`` on the leader, an ``EngineCore``, or
    with ``engine`` a ``TorchEngine`` whose plane holds the publisher.
    Returns (drive's result, the leader core, the follower core, the
    frames the follower replayed by kind)."""
    tcfg, ekw = _cfg(name, **kw)
    port = mh.free_port()
    ready = threading.Event()
    store = dist.HashStore()
    out, errs = {}, []

    def rank(r):
        try:
            group = dist.ProcessGroupGloo(dist.PrefixStore("tp", store), r,
                                          2, datetime.timedelta(seconds=60))
            mesh = serving_mesh(2, rank=r, device="cpu", group=group)
            cfg = TorchEngineConfig(model=tcfg, device="cpu", tp=2,
                                    mesh=mesh, **ekw)
            params = tl.params_from_jax(np_params, tcfg, CPU, tp=2, rank=r)
            if r == 1:
                core = EngineCore(cfg, params)
                ready.wait(30)
                loop = mh.FollowerLoop(core, "127.0.0.1", port,
                                       connect_timeout=30)
                kinds = collections.Counter()
                replay = core.mirror_dispatch

                def counted(kind, meta, arrs):
                    kinds[kind] += 1
                    replay(kind, meta, arrs)
                core.mirror_dispatch = counted
                loop.run()
                out[1] = (core, kinds)
                return
            pub = mh.DispatchPublisher(port, 1, host="127.0.0.1",
                                       on_lost=lambda: errs.append("lost"))
            ready.set()
            if engine:
                e = eng.TorchEngine(cfg, params, plane=mh.LeaderPlane(
                    mesh, pub, None, wait_timeout=30))
                try:
                    out[0] = (drive(e), e.core)
                finally:
                    e.shutdown()
                return
            core = EngineCore(cfg, params)
            try:
                pub.wait_for_followers(30)
                core.dispatch_hook = pub.hook
                with torch.no_grad():
                    out[0] = (drive(core), core)
            finally:
                pub.close()
                core.close()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errs.append(e)

    threads = [threading.Thread(target=rank, args=(r,), daemon=True)
               for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    if errs:
        raise errs[0] if isinstance(errs[0], BaseException) else \
            AssertionError(errs)
    assert set(out) == {0, 1}, "a rank hung"
    (res, leader), (follower, kinds) = out[0], out[1]
    return res, leader, follower, kinds


def _schedule(core):
    return {sid: _drive(core, BackendInput, StopConditions, sid, toks)
            for sid, toks in SCHEDULE}


def _tier_blocks(core):
    host, disk = core.tiered.hashes()
    return {h: core.tiered.peek(h) for h in host + disk}


# ---------------------------------------------------------------------------
# (a), (b): prefix reuse through the host and disk tiers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tier", sorted(TIERS))
def test_tier_restore_at_tp2_matches_jax(tier, jax_ref):
    """A's blocks go to the tier when C fills the pool; B restores its
    3-page prefix from there. Each rank uploads its kv heads of the
    leader's whole blocks (one ``kv_restore`` frame), so B's ids are
    JAX's."""
    got, leader, follower, kinds = _pair(
        jax_ref["params"], lambda c: (_schedule(c), c.tiered.stats()),
        **TIERS[tier])
    runs, stats = got
    assert runs == jax_ref["schedule"]
    assert runs["b"][1] == 24 and leader.enable_prefix_reuse
    assert stats["hits"] == 3 and kinds["kv_restore"] == 1
    assert stats["disk_blocks" if tier == "disk" else "host_blocks"] > 0
    # the tiers are the leader's; each rank restored its kv head of the
    # three blocks
    assert follower.tiered is None
    block = tl.kv_block_bytes(leader.cfg.model, 8) // 2
    assert follower.kv_restore_bytes == leader.kv_restore_bytes == 3 * block
    assert kinds["kv_offload"] >= 1 and follower.kv_offload_bytes > 0


@pytest.mark.parametrize("name", ["tiny-byte", "tiny-gemma"])
def test_offloaded_blocks_are_tp1s_whole_blocks(name, jax_ref):
    """The blocks the leader's tier holds after the schedule hold every kv
    head, equal to a tp=1 engine's: a head the ranks both keep
    (``tiny-gemma``: Hkv=1) is gathered once."""
    params = jax_ref["params"] if name == "tiny-byte" else _gemma_params()
    whole, _, _, _ = _pair(params, lambda c: (_schedule(c),
                                              _tier_blocks(c)),
                           name=name, **TIERS["host"])
    runs, blocks = whole
    ref = _tp1(params, name, **TIERS["host"])
    try:
        assert _schedule(ref) == runs
        want = _tier_blocks(ref)
    finally:
        ref.close()
    assert set(blocks) == set(want) and len(want) >= 4
    m = ref.cfg.model
    for h, (k, v) in blocks.items():
        assert k.shape == (m.num_layers, m.num_kv_heads, 8, m.head_dim)
        _close(k, want[h][0], 16)
        _close(v, want[h][1], 16)


# ---------------------------------------------------------------------------
# (c), (d): disaggregation between tp=2 and tp=1
# ---------------------------------------------------------------------------

def _bi(tokens=PROMPT, n=TOKENS):
    return BackendInput(token_ids=list(tokens),
                        stop=StopConditions(max_tokens=n, ignore_eos=True))


@pytest.mark.parametrize("direction", ["tp2-to-tp1", "tp1-to-tp2"])
def test_whole_array_disagg_between_tp2_and_tp1(direction, jax_ref):
    """tp=2 ``prefill_extract`` -> tp=1 ``inject_prefilled``, and the
    reverse: the extract is JAX's within 1e-4 and both decodes stream
    JAX's aggregated ids."""
    jk, jv, jtok = jax_ref["extract"]
    want = jax_ref["disagg"]
    ref = _tp1(jax_ref["params"])
    try:
        if direction == "tp2-to-tp1":
            (k, v, tok, lp), _, _, kinds = _pair(
                jax_ref["params"], lambda c: c.prefill_extract("x", _bi()))
            assert kinds["kv_extract"] == 1
            first = ref.inject_prefilled("y", _bi(), k, v, tok, lp)
            ids = [first.token] + _decode(ref, "y")
        else:
            k, v, tok, lp = ref.prefill_extract("x", _bi())

            def inject(c):
                first = c.inject_prefilled("y", _bi(), k, v, tok, lp)
                return [first.token] + _decode(c, "y")
            ids, leader, follower, kinds = _pair(jax_ref["params"], inject)
            assert kinds["kv_inject"] == 1
            assert follower.decode_steps_run == leader.decode_steps_run
    finally:
        ref.close()
    assert tok == jtok and ids == want
    assert k.shape == jk.shape == (2, len(PROMPT), 2, 16)
    # the bound tests/test_torch_disagg.py holds tp=1's extract to
    _close(k, jk, 128)
    _close(v, jv, 128)


def _stream(e, bi, sid, k, v, tok, lp, layers=None):
    """``KvIngest`` layer by layer (``layers`` replaces the arriving
    layers), then the ingested sequence's stream: its ids, or the
    ``RemotePrefillError`` the engine-side ingest failed with."""
    from dynamo_tpu_torch.llm.kv_transfer import RemotePrefillError

    async def go():
        ingest = e.kv_ingest(bi, sid)
        L, T, H, D = k.shape
        assert ingest.begin({"layers": L, "kv_heads": H, "head_dim": D,
                             "tokens": T})
        for layer, (lk, lv) in enumerate(layers or zip(k, v)):
            ingest.layer(layer, lk, lv)
        ingest.finish(tok, lp)
        ids = []
        try:
            async for o in e.generate_streamed(bi, Context(sid), ingest):
                ids += o.token_ids
        except RemotePrefillError as err:
            return err
        return ids

    return asyncio.run(go())


def test_layer_streamed_ingest_at_tp2(jax_ref):
    """tp=1's extract streamed through ``KvIngest`` into a tp=2
    ``TorchEngine``: one ``kv_inject`` frame a group of layers, and the
    decode streams JAX's aggregated ids."""
    ref = _tp1(jax_ref["params"])
    try:
        k, v, tok, lp = ref.prefill_extract("x", _bi())
    finally:
        ref.close()
    ids, leader, follower, kinds = _pair(
        jax_ref["params"], lambda e: _stream(e, _bi(), "s", k, v, tok, lp),
        engine=True)
    assert ids == jax_ref["disagg"]
    assert kinds["kv_inject"] == 1 and leader.frames_done == leader.frames_out
    assert follower.decode_steps_run == leader.decode_steps_run > 0


# ---------------------------------------------------------------------------
# (e): cluster write-through
# ---------------------------------------------------------------------------

def test_cluster_writethrough_mirrors_whole_blocks(jax_ref):
    """Every block the request seals is mirrored to the leader's tier
    (``kv_offload`` frames): whole, and equal to tp=1's."""
    kw = dict(host_cache_blocks=16, cluster_writethrough=True)

    def run(c):
        ids = _drive(c, BackendInput, StopConditions, "w", BASE, 12)[0]
        c.flush_writethrough()
        return ids, _tier_blocks(c), c.writethrough_blocks

    (ids, blocks, n), _, _, kinds = _pair(jax_ref["params"], run, **kw)
    ref = _tp1(jax_ref["params"], **kw)
    try:
        want_ids, want, want_n = run(ref)
    finally:
        ref.close()
    assert ids == want_ids and n == want_n == len(want) >= 4
    assert set(blocks) == set(want) and kinds["kv_offload"] >= 1
    for h, (k, v) in blocks.items():
        _close(k, want[h][0], 16)
        _close(v, want[h][1], 16)


# ---------------------------------------------------------------------------
# (f): speculative decoding
# ---------------------------------------------------------------------------

def test_ngram_spec_at_tp2_streams_jax_ids(jax_ref):
    """n-gram spec at tp=2: the proposals are the leader's, each round a
    ``verify`` frame the follower replays (the flash kernel at K+1
    positions on its heads), and the greedy ids are JAX's without spec."""
    ids, leader, follower, kinds = _pair(
        jax_ref["params"],
        lambda c: _drive(c, BackendInput, StopConditions, "s", SPEC_PROMPT,
                         12)[0], spec="ngram", spec_k=3)
    assert ids == jax_ref["spec"]
    # some round verified drafts: the forward ran at T = K + 1 > 1
    assert max(leader.spec_k_rounds) > 0 and follower.proposer is None
    assert kinds["verify"] == follower.spec_dispatch_total \
        == leader.spec_dispatch_total > 0
    assert kinds["decode"] == 0
    assert dict(follower.spec_k_rounds) == dict(leader.spec_k_rounds)


# ---------------------------------------------------------------------------
# (g): a bad payload errors its request only
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fault", ["geometry", "layer"])
def test_bad_inject_payload_errors_its_request_only(fault, jax_ref,
                                                    monkeypatch):
    """A payload whose KV does not fit the engine is refused before any KV
    frame: the request errors (the streamed one falls back), no rank
    waits, the worker does not exit, and it goes on serving JAX's ids."""
    exits, sent = [], []
    monkeypatch.setattr(eng.os, "_exit", exits.append)
    ref = _tp1(jax_ref["params"])
    try:
        k, v, tok, lp = ref.prefill_extract("x", _bi())
    finally:
        ref.close()

    def drive(e):
        hook = e.core.dispatch_hook

        def recorded(kind, meta, arrs):
            sent.append(kind)
            hook(kind, meta, arrs)
        e.core.dispatch_hook = recorded
        if fault == "geometry":
            async def bad():
                return [o async for o in e.generate_prefilled(
                    _bi(), Context("bad"), k[:, :, :1], v[:, :, :1], tok,
                    lp)]
            outs = asyncio.run(bad())
            err = outs[-1].error
        else:
            layers = list(zip(k, v))
            layers[1] = (k[1][:, :1], v[1][:, :1])
            err = str(_stream(e, _bi(), "bad", k, v, tok, lp, layers))
        ok = _stream(e, _bi(), "good", k, v, tok, lp)
        return err, ok

    (err, ok), leader, _, kinds = _pair(jax_ref["params"], drive,
                                        engine=True)
    assert "does not match this engine" in err
    assert exits == [] and leader.frames_done == leader.frames_out
    # the good stream's group is the one KV frame
    assert sent.count("kv_inject") == kinds["kv_inject"] == 1
    assert ok == jax_ref["disagg"]


def test_prefill_worker_tp2_extracts_the_whole_kv():
    """``cli.prefill_worker --tp 2 --device cpu`` builds a leader that
    starts its follower (a ``cli.worker`` process) and serves
    ``prefill_extract``: the first token and the whole [L, T, Hkv, Dh] KV
    of a tp=1 engine on the same seeded (bf16) weights."""
    import json

    from dynamo_tpu_torch.cli import prefill_worker

    extra = json.dumps(dict(preset="tiny-byte", **ENGINE))
    args = prefill_worker.parse_args(["--tp", "2", "--device", "cpu",
                                      "--extra-engine-args", extra])
    engine = prefill_worker.make_engine(args)
    try:
        assert engine.core.tp == 2 and len(engine.plane.ranks.procs) == 1
        k, v, tok, _ = asyncio.run(engine.prefill_extract(_bi(),
                                                          Context("pw")))
    finally:
        engine.shutdown()
    assert [p.wait(30) for p in engine.plane.ranks.procs] == [0]
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard

    ref = EngineCore(TorchEngineConfig.from_card(
        ModelDeploymentCard.synthetic("prefill"), preset="tiny-byte",
        device="cpu", **ENGINE))
    try:
        rk, rv, rtok, _ = ref.prefill_extract("x", _bi())
    finally:
        ref.close()
    # the preset's bf16: uint16 bits on the wire, compared as values within
    # 4 bf16 ulps of the largest magnitude
    assert tok == rtok and k.dtype == rk.dtype == np.uint16
    assert k.shape == rk.shape == (2, len(PROMPT), 2, 16)
    for got, want in ((k, rk), (v, rv)):
        got, want = (torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).float().numpy() for a in (got, want))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=4 * 2.0 ** -8 * np.abs(want).max())


# ---------------------------------------------------------------------------
# (h): the frames
# ---------------------------------------------------------------------------

NEW_FRAMES = {
    "verify": ({"S": 24, "K": 3}, {
        "lanes": np.array([0, 1]), "fresh": np.array([True, False]),
        "tokens": np.arange(8, dtype=np.int64).reshape(2, 4),
        "uniforms": np.full((2, 10), 0.5, np.float32),
        "upd_mask": np.ones((2, 4), np.int32)}),
    "kv_offload": ({}, {"pages": np.array([3, 5], np.int64)}),
    "kv_restore": ({"staged": 1}, {"pages": np.array([7, 1, 2], np.int64)}),
    "kv_extract": ({"layer": None}, {"slots": np.arange(9, dtype=np.int64)}),
    "kv_inject": ({"l0": 0, "layers": 2},
                  {"slots": np.arange(9, dtype=np.int64) + 16}),
}


@pytest.mark.parametrize("kind", sorted(NEW_FRAMES))
def test_new_frame_kinds_round_trip_through_the_jax_codec(kind):
    import msgpack

    from dynamo_tpu.parallel import multihost as jmh
    from dynamo_tpu.runtime.wire import pack as jax_pack

    meta, arrs = NEW_FRAMES[kind]
    frame = mh.pack_frame(kind, meta, arrs)
    assert frame == jax_pack([kind, meta, jmh._pack_arrays(arrs)])
    k, m, packed = msgpack.unpackb(frame[4:], raw=False)
    back = jmh._unpack_arrays(packed)
    assert (k, m) == (kind, meta)
    for name, a in arrs.items():
        assert back[name].dtype == a.dtype
        np.testing.assert_array_equal(back[name], a)
    # a port-only kind is listed where the channel documents its kinds
    assert f"``{kind}``" in mh.__doc__
