"""The port's KV block manager against the JAX package's.

- ``DeviceBlockPool`` and ``PagePool`` under one seeded random sequence of
  operations: identical page ids, states, eviction order, ``on_evict``
  calls and stored/removed hook streams.
- ``HostKvTier``/``DiskKvTier``/``TieredKvCache``: identical LRU, cascade
  to disk, promotion, ``peek``, pinning (``OutOfTierSpace`` when the tier
  is wall-to-wall pinned) and stats; bf16 blocks round-trip as raw
  ``uint16`` bits, byte-equal to the JAX package's bf16 host blocks.
- ``CopyStream`` gathers and scatters pages as the JAX package's does.
- KV event dict forms are the JAX package's, both ways.
- Engine parity (f32 tiny-byte, shared weights, page 8, a 12-page pool with
  host and disk tiers, prefix reuse on by default): the same requests give
  identical greedy tokens, ``kv_prefix_hit_tokens``, stored/removed event
  streams through each side's ``KvEventPublisher``, and ``KvIndexer``
  overlap scores. The requests run one after another and each decodes in
  one dispatch: the JAX engine chains a second decode dispatch off the
  first before reading its tokens (the in-flight window the port does not
  have yet), so a request that needs two dispatches seals and evicts in
  another order there. Prompt lengths (4 to 7 mod 8) are chosen so the
  chained window's page reservation fits pages both engines already hold,
  and so that no request ends on a token that completes a block, where the
  port deliberately differs (the last test).
- The JAX package's own engine reuse tests (``tests/test_kvbm.py``),
  mirrored on the port: same-token reuse, a divergent suffix against a
  cold engine, a host-tier round trip, batch invariance.
- A block whose last token's KV was never written (the request ended on
  it) is not reused: the next turn gives the cold engine's tokens.
"""

import asyncio
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.cache import OutOfPages as JOutOfPages
from dynamo_tpu.engine.cache import PagePool as JPagePool
from dynamo_tpu.engine.engine import EngineCore as JaxCore, JaxEngineConfig
from dynamo_tpu.llm.kv_router import protocols as jproto
from dynamo_tpu.llm.kv_router.indexer import KvIndexer as JIndexer
from dynamo_tpu.llm.kv_router.publisher import KvEventPublisher as JPub
from dynamo_tpu.llm.kvbm import tiers as jtiers
from dynamo_tpu.llm.kvbm.pool import DeviceBlockPool as JPool
from dynamo_tpu.llm.kvbm.pool import OutOfBlocks as JOut
from dynamo_tpu.llm.kvbm.transfer import CopyStream as JCopy
from dynamo_tpu.llm.protocols.common import BackendInput as JBI
from dynamo_tpu.llm.protocols.common import StopConditions as JSC
from dynamo_tpu.models import llama as jl
from dynamo_tpu_torch.engine.cache import OutOfPages, PagePool
from dynamo_tpu_torch.engine.engine import EngineCore, TorchEngineConfig
from dynamo_tpu_torch.llm.kv_router import protocols as tproto
from dynamo_tpu_torch.llm.kv_router.indexer import KvIndexer
from dynamo_tpu_torch.llm.kv_router.publisher import KvEventPublisher
from dynamo_tpu_torch.llm.kvbm import tiers as ttiers
from dynamo_tpu_torch.llm.kvbm.pool import DeviceBlockPool, OutOfBlocks
from dynamo_tpu_torch.llm.kvbm.transfer import (CopyStream, from_host_array,
                                                host_dtype, to_host_array)
from dynamo_tpu_torch.llm.protocols.common import (BackendInput,
                                                   StopConditions)
from dynamo_tpu_torch.models import llama as tl

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# DeviceBlockPool / PagePool state machines
# ---------------------------------------------------------------------------

def _pool_trace(pool_cls, out_cls, seed):
    """Run a seeded random op sequence; return every observable result."""
    rng = random.Random(seed)
    pool = pool_cls(14)
    trace, leased = [], []
    pool.on_evict = lambda h, p: trace.append(("evict", h, p))
    for _ in range(700):
        op = rng.random()
        if op < 0.35:
            try:
                page = pool.lease_new()
            except out_cls:
                trace.append(("out",))
                continue
            leased.append(page)
            trace.append(("lease", page))
        elif op < 0.55 and leased:
            page = rng.choice(leased)
            if pool._blocks[page].seq_hash is None:
                trace.append(("seal", page, pool.seal(page, rng.randrange(9),
                                                      rng.randrange(2))))
        elif op < 0.75:
            h = rng.randrange(9)
            page = pool.match(h)
            trace.append(("match", h, page, pool.contains(h)))
            if page is not None:
                leased.append(page)
        elif op < 0.97 and leased:
            page = leased.pop(rng.randrange(len(leased)))
            pool.release(page)
            trace.append(("release", page))
        else:
            trace.append(("flush", pool.flush_reusable()))
        trace.append((pool.free_count, pool.reusable_count,
                      pool.allocatable))
    states = {p: (b.state, b.seq_hash, b.refs, b.registered, b.last_used)
              for p, b in pool._blocks.items()}
    return trace, states


@pytest.mark.parametrize("seed", [0, 1])
def test_device_block_pool_matches_jax(seed):
    want = _pool_trace(JPool, JOut, seed)
    got = _pool_trace(DeviceBlockPool, OutOfBlocks, seed)
    assert got == want
    assert sum(1 for t in want[0] if t[0] == "evict") > 10


def _page_pool_trace(pool_cls, seed):
    rng = random.Random(seed)
    pp = pool_cls(12, 4)
    ev = []
    pp.on_block_sealed = lambda sid, b, page, lora: ev.append(
        ("stored", sid, b.sequence_hash, b.parent_sequence_hash, page, lora))
    pp.on_blocks_removed = lambda hs: ev.append(("removed", list(hs)))
    host = set()          # a host tier that takes every evicted block

    def evicted(h, page):
        ev.append(("evicted", h, page))
        host.add(h)
    pp.on_block_evicted = evicted
    stems = [[rng.randrange(50) for _ in range(12)] for _ in range(3)]
    live, n = [], 0
    for _ in range(160):
        op = rng.random()
        if op < 0.3 and len(live) < 3:
            sid = f"s{n}"
            n += 1
            lora = rng.choice([0, 0, 7])
            pp.create(sid, lora_id=lora)
            prompt = rng.choice(stems)[:rng.randrange(4, 13)] + [
                rng.randrange(50) for _ in range(rng.randrange(3))]
            matched, ups = pp.match_prefix(sid, prompt, len(prompt) - 1,
                                           host.__contains__)
            host.difference_update(h for h, _ in ups)
            ev.append(("match", sid, matched, ups))
            live.append((sid, prompt, matched))
        elif op < 0.7 and live:
            i = rng.randrange(len(live))
            sid, prompt, done = live[i]
            toks = prompt[done:] or [rng.randrange(50)]
            try:
                pp.extend(sid, toks[:rng.randrange(1, 6)])
            except (JOutOfPages, OutOfPages):
                ev.append(("oop", sid))
                continue
            live[i] = (sid, prompt, pp.seqs[sid].num_tokens)
            ev.append(("pages", sid, list(pp.seqs[sid].pages)))
        elif op < 0.95 and live:
            sid, _, _ = live.pop(rng.randrange(len(live)))
            pp.release(sid)
            ev.append(("release", sid))
        else:
            ev.append(("flush", pp.flush_reusable()))
        ev.append(("free", pp.free_pages,
                   pp.probe_prefix(stems[0], host.__contains__)))
    return ev


@pytest.mark.parametrize("seed", [3, 4])
def test_page_pool_matches_jax(seed):
    want = _page_pool_trace(JPagePool, seed)
    got = _page_pool_trace(PagePool, seed)
    assert got == want
    kinds = {e[0] for e in want}
    assert {"stored", "removed", "evicted", "match"} <= kinds
    assert any(e[0] == "match" and e[3] for e in want)   # host uploads


# ---------------------------------------------------------------------------
# host / disk tiers
# ---------------------------------------------------------------------------

def _tier_trace(mod, tmp, seed):
    rng = np.random.default_rng(seed)
    shape = (2, 2, 4, 3)
    host = mod.HostKvTier(3, shape, np.float32)
    disk = mod.DiskKvTier(4, shape, np.float32, str(tmp))
    cache = mod.TieredKvCache(host, disk)
    changes = []
    cache.on_change = lambda: changes.append(1)
    out = []
    for _ in range(160):
        op = rng.random()
        h = int(rng.integers(0, 10))
        k = rng.standard_normal(shape).astype(np.float32)
        if op < 0.4:
            cache.offload(h, k, -k)
            out.append(("offload", h))
        elif op < 0.7:
            got = cache.lookup(h)
            out.append(("lookup", h, None if got is None
                        else (got[0].tobytes(), got[1].tobytes())))
        elif op < 0.8:
            got = cache.peek(h)
            lay = cache.peek_layer(h, 1)
            out.append(("peek", h, h in cache, None if got is None
                        else (got[0].tobytes(), lay[1].tobytes())))
        elif op < 0.88:
            out.append(("pin", h, cache.pin(h)))
        elif op < 0.93:
            cache.unpin(h)
        elif op < 0.99:
            try:
                cache.deposit_pinned(h, k, k)
                out.append(("deposit", h))
            except mod.OutOfTierSpace:
                out.append(("full", h))
        else:
            cache.clear()
        out.append((cache.stats(), cache.hashes(), cache.pinned_count(),
                    len(changes)))
    cache.close()
    return out


def test_tiers_match_jax(tmp_path):
    want = _tier_trace(jtiers, tmp_path / "j", 5)
    got = _tier_trace(ttiers, tmp_path / "t", 5)
    assert got == want
    assert want[-1][0]["disk_blocks"] > 0 and want[-1][0]["hits"] > 0
    assert ("full" in {o[0] for o in want if isinstance(o[0], str)})
    assert not list(tmp_path.iterdir())        # close() removed the files


def test_bf16_blocks_round_trip_as_uint16_bits():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 3, 4, 2, 8)).astype(np.float32)
    t = torch.from_numpy(x).to(torch.bfloat16)
    assert host_dtype(torch.bfloat16) == np.uint16
    bits = to_host_array(t)
    assert bits.dtype == np.uint16
    # byte-compatible with the JAX package's (ml_dtypes) bf16 host blocks
    assert bits.tobytes() == np.asarray(jnp.asarray(x, jnp.bfloat16)) \
        .tobytes()
    cache = ttiers.TieredKvCache(ttiers.HostKvTier(
        4, x.shape[1:], host_dtype(torch.bfloat16)))
    for i in range(2):
        cache.offload(i, bits[i], bits[i])
    for i in range(2):
        k, _ = cache.lookup(i)
        assert torch.equal(from_host_array(k, torch.bfloat16), t[i])
    with pytest.raises(TypeError):
        from_host_array(x[0], torch.bfloat16)


def test_copy_stream_matches_jax():
    rng = np.random.default_rng(7)
    shape = (2, 2, 6, 4, 3)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    cs, jcs = CopyStream(), JCopy()
    got = cs.d2h_pages(tk, tv, [4, 1, 2])
    want = jcs.d2h_pages(jnp.asarray(k), jnp.asarray(v), [4, 1, 2])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert cs.d2h_bytes == sum(a.nbytes for a in want)
    up = rng.standard_normal((2,) + shape[:2] + shape[3:]).astype(np.float32)
    cs.h2d_pages(tk, tv, [5, 3], up, -up)
    jk, jv = jcs.h2d_pages(jnp.asarray(k), jnp.asarray(v), [5, 3], up, -up)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    blocks = [torch.from_numpy(up[i]) for i in range(2)]
    cs.scatter_blocks(tk, tv, [1, 2], blocks, blocks)
    jk, jv = jcs.scatter_blocks(jk, jv, [1, 2], [jnp.asarray(up[i])
                                                for i in range(2)],
                                [jnp.asarray(up[i]) for i in range(2)])
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ---------------------------------------------------------------------------
# KV event wire forms
# ---------------------------------------------------------------------------

def test_event_dicts_match_jax():
    for mod_a, mod_b in ((tproto, jproto), (jproto, tproto)):
        stored = mod_a.RouterEvent(3, mod_a.KvCacheEvent(
            1, stored=mod_a.KvStoredEvent(
                [mod_a.StoredBlock(11, 12), mod_a.StoredBlock(13, 14)],
                parent_hash=10, lora_id=7)))
        removed = mod_a.RouterEvent(3, mod_a.KvCacheEvent(
            2, removed=mod_a.KvRemovedEvent([11, 13])))
        for ev in (stored, removed):
            d = ev.to_dict()
            back = mod_b.RouterEvent.from_dict(d)
            assert back.to_dict() == d
    fpm = tproto.ForwardPassMetrics(kv_active_blocks=3.0, mfu=0.5)
    assert fpm.to_dict() == jproto.ForwardPassMetrics(
        kv_active_blocks=3.0, mfu=0.5).to_dict()


# ---------------------------------------------------------------------------
# engine parity: tokens, prefix hits, KV events, router index
# ---------------------------------------------------------------------------

ENGINE = dict(page_size=8, max_batch=2, max_context=128, prefill_chunk=32,
              decode_steps=4, num_pages=12, host_cache_blocks=6,
              disk_cache_blocks=16)
MAX_TOKENS = 5          # one prefill token + one decode dispatch of 4


def _requests():
    rng = np.random.default_rng(0)
    base = [int(x) for x in rng.integers(1, 250, 44)]

    def rand(n):
        return [int(x) for x in rng.integers(1, 250, n)]
    # prompt lengths are 4..7 mod 8 (see the module docstring)
    return [("a", base), ("b", base[:24] + rand(20)), ("c", rand(52)),
            ("d", base), ("e", rand(46)), ("f", base[:36] + [7] * 8),
            ("g", base[:37]), ("h", rand(31)), ("i", base)]


def _drive(core, bi, sc, sid, tokens, max_tokens=MAX_TOKENS):
    core.submit(sid, bi(token_ids=list(tokens),
                        stop=sc(max_tokens=max_tokens, ignore_eos=True)))
    got, hit = [], None
    for _ in range(300):
        for so in core.step():
            if so.seq_id != sid:
                continue
            got.append(so.token)
            if so.prefix_hit is not None:
                hit = so.prefix_hit
            if so.finish is not None:
                return got, hit
    raise AssertionError(f"{sid} did not finish")


def _serve_all(core, bi, sc, publisher, indexer):
    async def publish(_subject, d):
        indexer.apply_sync(type_of_event(indexer).from_dict(d))

    publisher._publish = publish
    core.pool.on_block_sealed = publisher.block_stored
    core.pool.on_blocks_removed = publisher.blocks_removed
    out, scores, events = {}, [], []
    for sid, toks in _requests():
        out[sid] = _drive(core, bi, sc, sid, toks)
        events.extend(e.to_dict() for e in publisher._buf)
        asyncio.run(publisher.flush())
        scores.append([indexer.find_matches_for_tokens(t).scores
                       for _, t in _requests()])
    return out, events, scores, core.tiered.stats()


def type_of_event(indexer):
    return jproto.RouterEvent if isinstance(indexer, JIndexer) \
        else tproto.RouterEvent


@pytest.fixture(scope="module")
def jax_reference():
    core = JaxCore(JaxEngineConfig(
        model=jl.preset("tiny-byte", dtype=jnp.float32), **ENGINE))
    try:
        run = _serve_all(core, JBI, JSC, JPub(1, None), JIndexer(8))
        return run, jax.tree.map(lambda a: np.array(a), core.params)
    finally:
        core.close()


def _torch_core(np_params=None, **kw):
    cfg = TorchEngineConfig(model=tl.preset("tiny-byte", dtype=torch.float32),
                            device="cpu", **{**ENGINE, **kw})
    params = (None if np_params is None else
              tl.params_from_jax(np_params, cfg.model, torch.device("cpu")))
    return EngineCore(cfg, params)


def test_engine_reuse_matches_jax_engine(jax_reference):
    (want, want_events, want_scores, want_stats), np_params = jax_reference
    core = _torch_core(np_params)
    try:
        got, events, scores, stats = _serve_all(
            core, BackendInput, StopConditions, KvEventPublisher(1, None),
            KvIndexer(8))
    finally:
        core.close()
    assert got == want
    assert events == want_events
    assert scores == want_scores
    assert stats == want_stats
    hits = {sid: hit for sid, (_, hit) in want.items()}
    # reuse from the device, from the host tier and from disk all happened
    assert hits["b"] == 24 and hits["d"] == 40 and hits["i"] == 40
    assert want_stats["hits"] > 0 and want_stats["disk_blocks"] > 0
    assert any("removed" in e for e in want_events)
    assert core.prefix_hit_tokens == sum(hits.values())


def test_engine_prefix_reuse_same_tokens(jax_reference):
    (want, _, _, _), np_params = jax_reference
    core = _torch_core(np_params, num_pages=None, host_cache_blocks=0,
                       disk_cache_blocks=0)
    prompt = _requests()[0][1]
    first, hit0 = _drive(core, BackendInput, StopConditions, "a", prompt)
    assert (first, hit0) == want["a"]
    baseline_free = core.pool.free_pages
    second, hit = _drive(core, BackendInput, StopConditions, "b", prompt)
    assert second == first and hit == 40
    assert core.pool.free_pages == baseline_free


def test_engine_prefix_reuse_divergent_suffix():
    a = list(range(1, 33))
    b = list(range(1, 25)) + [99, 98, 97, 96, 95, 94, 93, 92]
    cold = _torch_core(enable_prefix_reuse=False, host_cache_blocks=0)
    want, hit = _drive(cold, BackendInput, StopConditions, "b", b, 4)
    assert hit == 0
    warm = _torch_core(host_cache_blocks=0)
    _drive(warm, BackendInput, StopConditions, "a", a, 4)
    got, hit = _drive(warm, BackendInput, StopConditions, "b", b, 4)
    assert hit == 24 and got == want


def test_engine_host_offload_round_trip():
    core = _torch_core(num_pages=9, host_cache_blocks=16,
                       disk_cache_blocks=0)
    p1, p2 = list(range(1, 33)), list(range(100, 132))
    first, _ = _drive(core, BackendInput, StopConditions, "a", p1, 4)
    _drive(core, BackendInput, StopConditions, "b", p2, 4)
    assert core.tiered.stats()["host_blocks"] > 0
    again, hit = _drive(core, BackendInput, StopConditions, "a2", p1, 4)
    assert again == first and hit == 24
    assert core.tiered.stats()["hits"] > 0
    assert core.copy_stream.h2d_bytes > 0 and core.copy_stream.d2h_bytes > 0


def test_engine_reuse_respects_batching_invariance():
    core = _torch_core(max_batch=4, num_pages=None, host_cache_blocks=0)
    base = list(range(1, 33))
    solo, _ = _drive(core, BackendInput, StopConditions, "s", base, 4)
    for sid, toks in (("x", base), ("y", list(range(50, 80)))):
        core.submit(sid, BackendInput(token_ids=toks, stop=StopConditions(
            max_tokens=4, ignore_eos=True)))
    got = {"x": [], "y": []}
    done = set()
    for _ in range(300):
        for so in core.step():
            got[so.seq_id].append(so.token)
            if so.finish is not None:
                done.add(so.seq_id)
        if done == {"x", "y"}:
            break
    assert got["x"] == solo


@pytest.mark.parametrize("prompt_len,max_tokens", [
    (7, 1),     # ends on its prefill token, which completes page 0
    (11, 5),    # ends on the last step of a decode dispatch, page 1
])
def test_engine_never_reuses_a_block_with_an_unwritten_slot(prompt_len,
                                                            max_tokens):
    """A request's last sampled token has no KV in the pool (no later step
    fed it back). When it completes a block, that block must not be
    matched later: the next turn (prompt + that token + more) must give
    the cold engine's tokens. The JAX engine parks the stale block in the
    first case (its chained decode dispatch writes the slot in the
    second); the port unseals it and publishes its removed event."""
    warm = _torch_core(num_pages=None, host_cache_blocks=0,
                       disk_cache_blocks=0)
    cold = _torch_core(num_pages=None, host_cache_blocks=0,
                       disk_cache_blocks=0, enable_prefix_reuse=False)
    events = []
    warm.pool.on_block_sealed = lambda sid, b, p, l: events.append(
        ("stored", b.sequence_hash))
    warm.pool.on_blocks_removed = lambda hs: events.extend(
        ("removed", h) for h in hs)
    prompt = list(range(10, 10 + prompt_len))
    got, _ = _drive(warm, BackendInput, StopConditions, "a", prompt,
                    max_tokens)
    assert (prompt_len + max_tokens) % 8 == 0
    stale = events[-1][1]
    assert events[-2:] == [("stored", stale), ("removed", stale)]
    turn2 = prompt + got + [50, 51, 52, 53, 54]
    want, _ = _drive(cold, BackendInput, StopConditions, "b", turn2, 4)
    again, hit = _drive(warm, BackendInput, StopConditions, "b", turn2, 4)
    assert again == want
    assert hit == (prompt_len + max_tokens) - 8
