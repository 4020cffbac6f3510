"""KV paging, image models and weight swaps at tp > 1, held against the
JAX package at tp=1 and the port at tp=1.

Ranks are threads with a gloo group each, and the leader's frames reach
the followers over the dispatch plane on localhost, as in
``tests/test_torch_parallel.py``. f32 presets, so greedy ids are exact.
One JAX engine a reference, the three built at once in the module
fixture (their compiles dominate this file's time).

- (a) The paging lane at tp=2 and tp=4 (tiny-byte, Hkv=2: at tp=4 the
  ranks replicate each kv head) streams the JAX paging lane's greedy ids
  for a prompt five times the lane's budget; the leader's demoted tier
  blocks are tp=1's within 16 f32 ulps of their largest magnitude (each
  rank's partial products are summed over tp, so the bits round
  differently); every follower replays the lane's frames and uploads its
  own kv heads.
- (b) ``tiny-gemma3-vlm`` at tp=2: an image request and a text request
  stream the JAX engine's greedy ids; the followers build no tower and
  replay image waves (``prefill`` with ``mm``) on the dense path.
- (c) A hot swap A -> B at tp=2 streams the JAX engine's ids on B's
  weights after it, every rank overwriting its own shard in place; a
  shape-mismatch refusal sends no frame, a cut the ranks cannot load is
  refused by their check, and both ranks keep serving A; a
  cold reload of a paging engine at tp=2 (``cli.worker``'s
  ``_cold_reload``) rebuilds the rank group on B and serves it.
- (d) The new frame kinds round-trip through the JAX codec.
"""

import asyncio
import collections
import dataclasses
import datetime
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from dynamo_tpu.engine.engine import EngineCore as JaxCore, JaxEngineConfig
from dynamo_tpu.llm.protocols.common import (BackendInput as JBI,
                                             StopConditions as JSC)
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models import siglip as jsig
from dynamo_tpu_torch.engine import engine as eng
from dynamo_tpu_torch.engine.engine import EngineCore, TorchEngineConfig
from dynamo_tpu_torch.llm.protocols.common import (BackendInput,
                                                   FinishReason,
                                                   StopConditions)
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models import siglip as tsig
from dynamo_tpu_torch.parallel import multihost as mh
from dynamo_tpu_torch.parallel.mesh import serving_mesh

torch.set_num_threads(2)

CPU = torch.device("cpu")
EPS = np.finfo(np.float32).eps
PAGE = 8
# the lane: 4 device pages (32 tokens) against a 165-token prompt
PAGED = dict(max_batch=2, max_context=64, page_size=PAGE, prefill_chunk=16,
             decode_steps=4, host_cache_blocks=48, kvpage_budget=4,
             kvpage_seg_pages=2, kvpage_prefetch=2, kvpage_max_context=512)
PROMPT = [(i * 7 + 3) % 251 for i in range(5 * 4 * PAGE + 5)]
SHORT = [11, 22, 33, 44, 55]
TOKENS = 5
# tiny-gemma3-vlm: a 4-token image span in a 14-token prompt, and text
IMG, MM_TOK = 250, 4
VLM_ENGINE = dict(page_size=8, max_batch=2, max_context=64, prefill_chunk=8,
                  decode_steps=2)
VLM_PROMPTS = {"img": [3] * 6 + [IMG] * MM_TOK + [8, 9, 10, 11],
               "text": [5, 6, 7, 8, 9]}
VLM_IMAGE = np.random.RandomState(1).randint(0, 256, (40, 50, 3)).astype(
    np.uint8)


def _np_weights(shapes, rng, ones=("ln1", "ln2", "final_norm")):
    """Leaves drawn with numpy, f32: normal / sqrt(leading dim), the named
    ones ones (the JAX init's scales, without its compiles)."""
    return {k: _np_weights(v, rng, ones) if isinstance(v, dict) else (
        np.ones(v, np.float32) if k in ones else
        (rng.standard_normal(v) / np.sqrt(v[0])).astype(np.float32))
        for k, v in shapes.items()}


def _model(name="tiny-byte", mod=tl, dtype=torch.float32):
    return mod.preset(name, max_position=1024, dtype=dtype)


TREES = {
    "a": _np_weights(tl.param_shapes(_model()), np.random.default_rng(1)),
    "b": _np_weights(tl.param_shapes(_model()), np.random.default_rng(2)),
    "vlm": _np_weights(tl.param_shapes(_model("tiny-gemma3-vlm")),
                       np.random.default_rng(3)),
}
_VCFG = tsig.SiglipVisionConfig.from_hf_config(
    _model("tiny-gemma3-vlm").vision, dtype=torch.float32)
TOWER = _np_weights(tsig.param_shapes(_VCFG), np.random.default_rng(4),
                    ones=())
PROJ = {"norm": np.zeros(32, np.float32),
        "proj": (np.random.default_rng(5).standard_normal((32, 64))
                 / np.sqrt(32)).astype(np.float32)}


def _req(tokens, n=TOKENS, **kw):
    return BackendInput(token_ids=list(tokens), stop=StopConditions(
        max_tokens=n, ignore_eos=True), **kw)


def _drive(core, reqs):
    """Greedy ids of ``reqs`` ({seq_id: BackendInput}) served together."""
    for sid, bi in reqs.items():
        core.submit(sid, bi)
    got = {sid: [] for sid in reqs}
    for _ in range(3000):
        for so in core.step():
            assert so.finish != FinishReason.ERROR, so
            got[so.seq_id].append(so.token)
        if not core.has_work:
            return got
    raise AssertionError("did not finish")


# ---------------------------------------------------------------------------
# the JAX references, built at once
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_ref():
    """The JAX EngineCore's greedy ids at tp=1: the paging lane's for
    PROMPT and the dense path's for SHORT on tree "b" (one engine), and
    the VLM engine's image and text streams."""
    out = {}
    trees = {False: TREES["b"], True: TREES["vlm"]}

    def paging():
        core = JaxCore(JaxEngineConfig(
            model=_model(mod=jl, dtype=jnp.float32), **PAGED))
        try:
            out["paged"] = _drive(core, {"p": JBI(
                token_ids=PROMPT, stop=JSC(max_tokens=TOKENS,
                                           ignore_eos=True))})["p"]
            out["short"] = _drive(core, {"s": JBI(
                token_ids=SHORT, stop=JSC(max_tokens=TOKENS,
                                          ignore_eos=True))})["s"]
        finally:
            core.close()

    def vlm():
        core = JaxCore(JaxEngineConfig(
            model=_model("tiny-gemma3-vlm", jl, jnp.float32),
            attn_impl="xla", **VLM_ENGINE))
        out["vlm"] = _drive(core, {
            sid: JBI(token_ids=toks,
                     images=[VLM_IMAGE] if sid == "img" else None,
                     stop=JSC(max_tokens=TOKENS, ignore_eos=True))
            for sid, toks in VLM_PROMPTS.items()})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jl, "init_params",
                   lambda cfg, key: trees[cfg.vision is not None])
        mp.setattr(jsig, "init_params", lambda cfg, key: TOWER)
        mp.setattr(jsig, "init_projector_params", lambda c, d, key: PROJ)
        threads = [threading.Thread(target=f) for f in (paging, vlm)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
    assert {"paged", "short", "vlm"} <= set(out)
    return out


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------

def _params(tree, m, tp=1, rank=0):
    return tl.params_from_jax(tree, m, CPU, tp=tp, rank=rank)


def _vision(m):
    return (tsig.params_from_jax(TOWER, _VCFG, CPU),
            tsig.projector_from_jax(PROJ, _VCFG, m.hidden_size, CPU))


def _ranks(tp, m, ekw, tree, drive, vision=False, timeout=60):
    """``tp`` ranks (threads, a gloo group each) on the dispatch plane:
    ``drive(leader)`` on the leader ``EngineCore``, the followers replaying
    its frames. Returns (drive's result, the leader, [(follower, frames
    it replayed by kind)])."""
    port = mh.free_port()
    ready = threading.Event()
    store = dist.HashStore()
    out, errs = {}, []

    def rank(r):
        try:
            group = dist.ProcessGroupGloo(dist.PrefixStore("tp", store), r,
                                          tp, datetime.timedelta(
                                              seconds=timeout))
            mesh = serving_mesh(tp, rank=r, device="cpu", group=group)
            cfg = TorchEngineConfig(model=m, device="cpu", tp=tp, mesh=mesh,
                                    **ekw)
            vp = _vision(m) if vision and r == 0 else None
            if r == 0:
                pub = mh.DispatchPublisher(port, tp - 1, host="127.0.0.1",
                                           on_lost=lambda: errs.append(
                                               "lost"))
                ready.set()
            core = EngineCore(cfg, _params(tree, m, tp, r), vp)
            if r > 0:
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
                out[r] = (core, kinds)
                return
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
               for r in range(tp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout + 60)
    if errs:
        raise errs[0] if isinstance(errs[0], BaseException) else \
            AssertionError(errs)
    assert set(out) == set(range(tp)), "a rank hung"
    return out[0][0], out[0][1], [out[r] for r in range(1, tp)]


def _tier_blocks(core):
    host, _ = core.tiered.hashes()
    return {h: core.tiered.peek(h) for h in host}


# ---------------------------------------------------------------------------
# (a) the paging lane
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def paged_tp1():
    core = EngineCore(TorchEngineConfig(model=_model(), device="cpu",
                                        **PAGED), _params(TREES["b"],
                                                          _model()))
    try:
        ids = _drive(core, {"p": _req(PROMPT)})["p"]
        return ids, _tier_blocks(core)
    finally:
        core.close()


@pytest.mark.parametrize("tp", [2, 4])
def test_paging_lane_at_tp_streams_jax_ids(tp, jax_ref, paged_tp1):
    def drive(core):
        ids = _drive(core, {"p": _req(PROMPT)})["p"]
        return (ids, _tier_blocks(core), core.refresh_rank_stats(),
                core.kvpager.pager.pageins, core.tiered.pinned_count())

    (ids, blocks, stats, pageins, pinned), leader, followers = _ranks(
        tp, _model(), PAGED, TREES["b"], drive)
    want_ids, want_blocks = paged_tp1
    assert ids == want_ids == jax_ref["paged"]
    assert pageins > 0 and pinned == 0
    # the leader's tier holds whole blocks, every kv head, as tp=1's
    assert blocks.keys() == want_blocks.keys() and len(blocks) > 10
    for h, (k, v) in blocks.items():
        for got, want in ((k, want_blocks[h][0]), (v, want_blocks[h][1])):
            np.testing.assert_allclose(got, want, rtol=0, atol=16 * EPS *
                                       np.abs(want).max())
    # every follower ran the lane's programs and uploaded its own heads
    for follower, kinds in followers:
        assert kinds["kvpage_prefill"] == leader.kvpager.prefill_chunks
        assert kinds["kvpage_decode"] == leader.kvpager.decode_windows
        assert kinds["kv_offload"] >= 1
        assert follower.k_pool.shape[1] == 1
    per_rank = leader.kvpager.pagein_bytes
    assert [s["kvpage_pagein_bytes"] for s in stats] == [per_rank] * tp
    assert all(s["kvpage_pagein_seconds"] > 0 for s in stats)


# ---------------------------------------------------------------------------
# (b) image requests
# ---------------------------------------------------------------------------

def _capture(core, kinds):
    """Wrap the leader's hook: the frames of ``kinds`` it sends, packed as
    the wire carries them."""
    sent, hook = [], core.dispatch_hook

    def capture(kind, meta, arrs):
        if kind in kinds:
            sent.append(mh.pack_frame(kind, meta, arrs))
        hook(kind, meta, arrs)
    core.dispatch_hook = capture
    return sent


def _jax_decoded(frame):
    """A port frame read back through the JAX package's codec."""
    import msgpack

    from dynamo_tpu.parallel import multihost as jmh

    kind, meta, packed = msgpack.unpackb(frame[4:], raw=False)
    return kind, meta, jmh._unpack_arrays(packed)


def test_vlm_at_tp2_streams_jax_ids(jax_ref):
    m = _model("tiny-gemma3-vlm")

    def drive(core):
        sent = _capture(core, ("prefill",))
        got = _drive(core, {sid: _req(toks, images=[VLM_IMAGE]
                                      if sid == "img" else None)
                            for sid, toks in VLM_PROMPTS.items()})
        return got, sent

    (got, sent), leader, [(follower, kinds)] = _ranks(
        2, m, VLM_ENGINE, TREES["vlm"], drive, vision=True)
    assert got == jax_ref["vlm"]
    # the followers built no tower and replayed the image waves
    assert leader.vision_params is not None and follower.vision_params is None
    assert follower.image_waves == leader.image_waves >= 1
    assert kinds["prefill"] == leader.prefill_dispatches
    assert follower.k_pool.shape[1] == 1      # Hkv=2 over two ranks
    # an image wave's frame through the JAX codec: JAX's four arrays, the
    # soft tokens compact (one row an image position)
    waves = [_jax_decoded(f) for f in sent]
    mm = [w for w in waves if w[1]["mm"]]
    assert len(mm) == leader.image_waves
    kind, meta, arrs = mm[0]
    assert kind == "prefill" and {"ov_vals", "ov_mask", "q_span",
                                  "read_span"} <= set(arrs)
    assert arrs["ov_vals"].shape == (int(arrs["ov_mask"].sum()),
                                     m.hidden_size)
    assert not any("ov_vals" in w[2] for w in waves if not w[1]["mm"])


# ---------------------------------------------------------------------------
# (c) weight swaps and the cold reload
# ---------------------------------------------------------------------------
SWAP_ENGINE = dict(page_size=8, max_batch=2, max_context=64,
                   prefill_chunk=16, decode_steps=4, host_cache_blocks=16)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    from dynamo_tpu_torch.engine.loader import save_llama_params

    d = tmp_path_factory.mktemp("lanes")
    out = {}
    for name in ("a", "b"):
        out[name] = str(d / name)
        save_llama_params(out[name], TREES[name], _model())
    # a checkpoint no rank can load
    out["bad"] = str(d / "bad")
    (d / "bad").mkdir()
    (d / "bad" / "model.safetensors").write_bytes(b"not a safetensors file")
    return out


def test_hot_swap_at_tp2_serves_b_after_a_refusal_keeps_a(jax_ref, ckpts):
    from dynamo_tpu_torch.fleet.mobility import SwapError

    m = _model()
    cfg_b = TorchEngineConfig(model=m, device="cpu", params_path=ckpts["b"],
                              **SWAP_ENGINE)

    def leaves(core):
        return {k: v.data_ptr() for k, v in core.params["layers"].items()}

    def drive(core):
        a_ids = _drive(core, {"a": _req(SHORT)})["a"]
        core.prefetch_shards(cfg_b)             # every rank stages its cut
        sent = core.frames_out
        with pytest.raises(SwapError) as ei:
            core.swap_weights(dataclasses.replace(cfg_b, max_batch=4))
        refused = [(ei.value.reason, core.frames_out - sent)]
        # the ranks' check refuses a cut they cannot load: no swap frame
        sent = core.frames_out
        with pytest.raises(SwapError) as ei:
            core.swap_weights(dataclasses.replace(cfg_b,
                                                  params_path=ckpts["bad"]))
        refused.append((ei.value.reason, core.frames_out - sent))
        a_again = _drive(core, {"a2": _req(SHORT)})["a2"]
        ptrs = leaves(core)
        out = core.swap_weights(cfg_b, group_layers=1)
        b_ids = _drive(core, {"b": _req(SHORT)})["b"]
        return (a_ids, refused, a_again, out, b_ids, leaves(core) == ptrs,
                core.refresh_rank_stats())

    (a_ids, refused, a_again, out, b_ids, same_ptrs, stats), leader, \
        [(follower, kinds)] = _ranks(2, m, SWAP_ENGINE, TREES["a"], drive)
    # the gate's refusal sent no frame, the ranks' check one (swap_check),
    # and both ranks kept serving A
    assert refused == [("shape_mismatch", 0), ("weights_unavailable", 1)]
    assert a_again == a_ids
    assert b_ids == jax_ref["short"] != a_ids
    assert out.path == "swap" and same_ptrs       # overwritten in place
    assert out.groups == m.num_layers * len(leader.params["layers"])
    assert leader.cfg.params_path == follower.cfg.params_path == ckpts["b"]
    assert (kinds["swap_prefetch"], kinds["swap_check"], kinds["swap"]) == \
        (1, 2, 1)
    # each rank overwrote its own shard: the same bytes on both ranks
    shard = eng._tree_nbytes(follower.params)
    assert [s["swap_bytes"] for s in stats] == [shard] * 2
    assert all(s["swap_seconds"] > 0 for s in stats)
    from dynamo_tpu_torch.cli.worker import engine_counters

    series = engine_counters(leader, 0)["dyn_weight_swap_bytes_total"][
        "series"]
    assert series == {"0": shard, "0/rank1": shard}
    # the follower holds B's cut of every leaf
    want = _params(TREES["b"], m, 2, 1)
    for k, v in follower.params["layers"].items():
        assert torch.equal(v, want["layers"][k]), k


def test_hot_swap_at_tp2_of_a_cut_the_cache_cannot_keep(jax_ref, ckpts,
                                                        monkeypatch):
    """A rank's cut over ``DYN_WEIGHT_CACHE_BYTES``: the cache drops it
    after the load, and the swap still overwrites from the very tree its
    check passed."""
    monkeypatch.setenv("DYN_WEIGHT_CACHE_BYTES", "1")
    m = _model()
    cfg_b = TorchEngineConfig(model=m, device="cpu", params_path=ckpts["b"],
                              **SWAP_ENGINE)

    def drive(core):
        core.prefetch_shards(cfg_b)             # loaded, then dropped
        out = core.swap_weights(cfg_b)
        return out, _drive(core, {"b": _req(SHORT)})["b"], \
            core._shards.paths()

    (out, b_ids, kept), leader, [(follower, kinds)] = _ranks(
        2, m, SWAP_ENGINE, TREES["a"], drive)
    assert out.path == "swap" and kept == [] == follower._shards.paths()
    assert b_ids == jax_ref["short"]
    assert (kinds["swap_check"], kinds["swap"]) == (1, 1)
    assert leader._swap_tree is None and follower._swap_tree is None


def _follower_threads(tp, cfg_of, store, port, ready, errs, done):
    """Followers 1 .. tp-1 of a group (threads): each builds its core on
    ``cfg_of(mesh)`` and replays the leader's frames until shutdown."""
    def rank(r):
        try:
            group = dist.ProcessGroupGloo(dist.PrefixStore("tp", store), r,
                                          tp, datetime.timedelta(seconds=60))
            core = EngineCore(cfg_of(serving_mesh(tp, rank=r, device="cpu",
                                                  group=group)))
            ready.wait(30)
            mh.FollowerLoop(core, "127.0.0.1", port, connect_timeout=30).run()
            core.close()
            done.append(r)
        except BaseException as e:  # noqa: BLE001 - re-raised by the test
            errs.append(e)

    threads = [threading.Thread(target=rank, args=(r,), daemon=True)
               for r in range(1, tp)]
    for t in threads:
        t.start()
    return threads


async def _serve(engine, tokens):
    from dynamo_tpu_torch.runtime.engine import Context

    ids = []
    async for o in engine.generate(_req(tokens), Context()):
        assert o.finish_reason != FinishReason.ERROR, o.error
        ids += o.token_ids
    return ids


async def test_cold_reload_of_a_paging_engine_at_tp2_rebuilds_the_group(
        jax_ref, ckpts):
    """``cli.worker``'s cold reload at tp=2: the paging engine refuses a
    hot swap, its group ends (the followers take the ``shutdown`` frame
    and return), and a new group serves B's paged stream."""
    from dynamo_tpu_torch.cli.worker import reload_engine
    from dynamo_tpu_torch.fleet.mobility import SwapError

    m = _model()
    errs, groups = [], []

    def start_plane(cfg):
        store, port, ready, done = dist.HashStore(), mh.free_port(), \
            threading.Event(), []
        threads = _follower_threads(2, lambda mesh: dataclasses.replace(
            cfg, tp=2, mesh=mesh), store, port, ready, errs, done)
        pub = mh.DispatchPublisher(port, 1, host="127.0.0.1",
                                   on_lost=lambda: errs.append("lost"))
        ready.set()
        group = dist.ProcessGroupGloo(dist.PrefixStore("tp", store), 0, 2,
                                      datetime.timedelta(seconds=60))
        groups.append((threads, done))
        return mh.LeaderPlane(serving_mesh(2, rank=0, device="cpu",
                                           group=group), pub, None,
                              wait_timeout=30)

    def cfg(name):
        return TorchEngineConfig(model=m, device="cpu",
                                 params_path=ckpts[name], **PAGED)

    loop = asyncio.get_running_loop()

    def build_a():
        plane = start_plane(cfg("a"))
        return eng.TorchEngine(dataclasses.replace(cfg("a"), tp=2,
                                                   mesh=plane.mesh),
                               plane=plane)

    engine = await loop.run_in_executor(None, build_a)
    try:
        assert len(await _serve(engine, SHORT)) == TOKENS
        with pytest.raises(SwapError) as ei:
            await engine.swap_weights(None, cfg("b"))
        assert ei.value.reason == "unsupported"
        old = engine
        engine = await loop.run_in_executor(None, reload_engine, old,
                                            cfg("b"), start_plane)
        # the old group ended in order: its follower returned on shutdown
        threads, done = groups[0]
        for t in threads:
            t.join(30)
        assert done == [1] and old.core.params == {}
        assert await _serve(engine, PROMPT) == jax_ref["paged"]
        assert engine.core.tp == 2 and engine.core.kvpager is not None
    finally:
        engine.shutdown()
    for t in groups[-1][0]:
        t.join(30)
    assert not errs, errs


class _Store:
    """The store calls a mobility agent makes, in memory."""

    def __init__(self):
        self.kv, self.watchers = {}, []

    async def put(self, key, value, lease=None):
        self.kv[key] = value
        for prefix, cb in self.watchers:
            if key.startswith(prefix):
                await cb(key, value, False)

    async def delete(self, key):
        return self.kv.pop(key, None) is not None

    async def watch_prefix(self, prefix, cb):
        self.watchers.append((prefix, cb))
        return []


async def test_agent_swaps_a_tp_engine_through_its_ranks_cuts():
    """A tp engine's swap agent keeps no whole tree: a prefetch hint
    stages each rank's cut (``prefetch_shards``, the ``swap_prefetch``
    frame) and the swap hands no host tree to ``swap_weights``."""
    import json

    from dynamo_tpu_torch.fleet import mobility as mob

    class Engine:
        core, shard_swaps = None, True

        def __init__(self):
            self.staged, self.swapped = [], []

        def prefetch_shards(self, cfg):
            self.staged.append(cfg.params_path)

        async def swap_weights(self, host, cfg):
            self.swapped.append((host, cfg.params_path))
            return mob.SwapOutcome("swap", 0.01, cfg.params_path)

    class Drt:
        _active, worker_id = {}, 0xBEEF

        def __init__(self):
            self.store = _Store()

        async def prepare_drain(self):
            pass

    drt, engine, registered = Drt(), Engine(), []

    async def reregister(payload):
        registered.append(payload["model"])

    def cfg(model, path):
        return dataclasses.replace(
            TorchEngineConfig(model=_model(), device="cpu", **SWAP_ENGINE),
            params_path=path)

    agent = await mob.MobilityAgent(
        drt, "dynamo", "backend-a", mob.EngineRef(engine),
        reregister=reregister, cfg_builder=cfg,
        cache=mob.WeightCache(loader=lambda p, c: pytest.fail(
            "a tp agent loads no whole tree"))).start()
    await drt.store.put(mob.mobility_prefetch_key("dynamo", "backend-a"),
                        json.dumps({"models": [
                            {"model": "b", "model_path": "/ckpt/b"}]}
                        ).encode())
    await drt.store.put(mob.mobility_swap_key("dynamo", "backend-a"),
                        json.dumps({"model": "b", "component": "backend-b",
                                    "model_path": "/ckpt/b"}).encode())
    await asyncio.gather(*agent._tasks)
    agent.cache.close()
    assert engine.staged == ["/ckpt/b"] and agent.cache.paths() == []
    assert engine.swapped == [(None, "/ckpt/b")] and registered == ["b"]
    wake = json.loads(drt.store.kv[mob.mobility_wake_key("dynamo", "b")])
    assert wake["path"] == "swap"


# ---------------------------------------------------------------------------
# (d) the frame kinds this slice adds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["kvpage_prefill", "kvpage_decode",
                                  "swap_prefetch", "swap_check", "swap"])
def test_new_frame_kinds_round_trip_through_the_jax_codec(kind):
    from dynamo_tpu.parallel import multihost as jmh
    from dynamo_tpu.runtime.wire import pack as jax_pack

    rng = np.random.default_rng(0)
    arrs = {"kvpage_prefill": {
        "tokens": rng.integers(0, 250, (1, 16)), "steps": np.arange(2),
        "meta": rng.integers(0, 9, (2, 3, 1, 2)),
        "read_valid": rng.random((1, 24)) > 0.5,
        "uniforms": rng.random(1).astype(np.float32)},
        "kvpage_decode": {
        "uniforms": rng.random((4, 2)).astype(np.float32),
        "active": np.array([True, False]), "hot": np.array([8, 8, 16, 16]),
        "read_idx": rng.integers(0, 99, (4, 2, 16))}}.get(kind, {})
    meta = {"kvpage_decode": {"cached": True}}.get(
        kind, {"key": "/ckpt/b", "params_path": "/ckpt/b", "seed": 0,
               "group_layers": None, "preset": None}
        if kind.startswith("swap") else {})
    frame = mh.pack_frame(kind, meta, arrs)
    assert frame == jax_pack([kind, meta, jmh._pack_arrays(arrs)])
    got_kind, got_meta, got = _jax_decoded(frame)
    assert (got_kind, got_meta) == (kind, meta)
    for k, a in arrs.items():
        assert got[k].dtype == a.dtype and np.array_equal(got[k], a)


def test_cli_worker_tp2_ends_its_follower_in_order_at_sigterm(tmp_path):
    """SIGTERM on a ``cli.worker --tp 2`` leader: the Worker shell closes
    the runtime, and the engine still shuts down after it (a cleanup step
    that fails on the closed runtime no longer skips it), so the follower
    takes the ``shutdown`` frame and both exit 0. Before, the leader's
    interpreter exit terminated the follower 5 s later and the leader
    exited 13 (ROADMAP Queue 3 item 26)."""
    import json
    import os
    import signal
    import subprocess
    import sys
    import time

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, DYNAMO_TPU_DATAPLANE="python", PYTHONPATH=root)
    port = mh.free_port()
    log_path = tmp_path / "worker.log"
    with open(log_path, "w") as log:
        store = subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.runtime.store_server",
             "--host", "127.0.0.1", "--port", str(port), "--impl",
             "python"], env=env, stdout=log, stderr=subprocess.STDOUT)
        leader = subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.cli.worker", "--tp",
             "2", "--device", "cpu", "--store", f"127.0.0.1:{port}",
             "--advertise-host", "127.0.0.1", "--extra-engine-args",
             json.dumps(dict(preset="tiny-byte", **SWAP_ENGINE))],
            env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            deadline = time.monotonic() + 60
            while "serving dynamo.backend.generate" not in \
                    log_path.read_text():
                assert leader.poll() is None and \
                    time.monotonic() < deadline, log_path.read_text()
                time.sleep(0.2)
            leader.send_signal(signal.SIGTERM)
            t0 = time.monotonic()
            rc = leader.wait(20)
            assert rc == 0 and time.monotonic() - t0 < 4, \
                log_path.read_text()[-2000:]
            assert "leader shut down after" in log_path.read_text()
        finally:
            for p in (leader, store):
                if p.poll() is None:
                    p.kill()
                p.wait()
