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
  streams through each side's ``KvEventPublisher``, ``KvIndexer`` overlap
  scores, and the same ``(chained, lanes)`` for every decode dispatch. The
  requests run one after another on two schedules: one decode dispatch a
  request, and three or more under pool pressure (13 tokens each, prompt
  lengths of every residue mod 8), where each dispatch's successor is
  chained off its tokens on the device and the chained dispatch's page
  reservation evicts before the first one's tokens seal, in both engines.
- The JAX package's own engine reuse tests (``tests/test_kvbm.py``),
  mirrored on the port: same-token reuse, a divergent suffix against a
  cold engine, a host-tier round trip, batch invariance.
- A block whose last token's KV was never written (the request ended on
  its prefill token) is not reused: the next turn gives the cold engine's
  tokens. After a decode dispatch the chained dispatch behind it writes
  that slot, and the next turn's prefix hit is the JAX engine's.
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
from dynamo_tpu_torch.llm.tokens import compute_seq_hashes
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


def _requests(schedule="one_dispatch"):
    """(requests, max_tokens) of a schedule. ``one_dispatch``: prompt
    lengths 4..7 mod 8 and one decode dispatch a request. ``chained``: 13
    tokens, three decode dispatches and the chained one behind them, prompt
    lengths of every residue mod 8."""
    if schedule == "one_dispatch":
        rng = np.random.default_rng(0)
        base = [int(x) for x in rng.integers(1, 250, 44)]

        def rand(n):
            return [int(x) for x in rng.integers(1, 250, n)]
        return [("a", base), ("b", base[:24] + rand(20)), ("c", rand(52)),
                ("d", base), ("e", rand(46)), ("f", base[:36] + [7] * 8),
                ("g", base[:37]), ("h", rand(31)), ("i", base)], MAX_TOKENS
    rng = np.random.default_rng(1)
    base = [int(x) for x in rng.integers(1, 250, 41)]

    def rand(n):
        return [int(x) for x in rng.integers(1, 250, n)]
    return [("a", base), ("b", base[:24] + rand(19)), ("c", rand(50)),
            ("d", base), ("e", rand(37)), ("f", base[:33] + [7] * 9),
            ("g", base[:40]), ("h", rand(26)), ("i", base)], 13


# kv_prefix_hit_tokens each schedule must show (from the device pool, the
# host tier and disk)
SCHEDULE_HITS = {"one_dispatch": {"b": 24, "d": 40, "i": 40},
                 "chained": {"b": 24, "d": 40, "f": 32, "g": 32, "i": 40}}


def _record_dispatches(core):
    """(chained, lanes) of every decode dispatch the core enqueues: the JAX
    core's through its dispatch hook, the port's from its in-flight
    record."""
    log = []
    if isinstance(core, JaxCore):
        def hook(kind, meta, arrs):
            if kind == "decode":
                log.append((meta["chain"],
                            tuple(np.flatnonzero(arrs["active_mask"]))))
        core.dispatch_hook = hook
        return log
    dispatch = core._dispatch_decode

    def recorded(*args, **kw):
        n = core.decode_dispatches
        dispatch(*args, **kw)
        if core.decode_dispatches > n:
            rec = core._inflight[-1]
            log.append((rec["chained"],
                        tuple(i for i, _, _ in rec["active"])))
    core._dispatch_decode = recorded
    return log


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


def _serve_all(core, bi, sc, publisher, indexer, schedule):
    async def publish(_subject, d):
        indexer.apply_sync(type_of_event(indexer).from_dict(d))

    publisher._publish = publish
    core.pool.on_block_sealed = publisher.block_stored
    core.pool.on_blocks_removed = publisher.blocks_removed
    dispatches = _record_dispatches(core)
    requests, max_tokens = _requests(schedule)
    out, scores, events = {}, [], []
    for sid, toks in requests:
        out[sid] = _drive(core, bi, sc, sid, toks, max_tokens)
        events.extend(e.to_dict() for e in publisher._buf)
        asyncio.run(publisher.flush())
        scores.append([indexer.find_matches_for_tokens(t).scores
                       for _, t in requests])
    return out, events, scores, core.tiered.stats(), dispatches


def type_of_event(indexer):
    return jproto.RouterEvent if isinstance(indexer, JIndexer) \
        else tproto.RouterEvent


def _jax_core(**kw):
    return JaxCore(JaxEngineConfig(
        model=jl.preset("tiny-byte", dtype=jnp.float32), **{**ENGINE, **kw}))


@pytest.fixture(scope="module")
def jax_reference():
    """Each schedule's run on the JAX engine, and its weights. One core
    serves both schedules (its programs compile once): between them its
    device blocks are flushed, its tiers emptied and their hit counters
    zeroed, so each schedule starts from an empty cache as on a new core."""
    runs = {}
    core = _jax_core()
    try:
        for schedule in SCHEDULE_HITS:
            core.pool.flush_reusable()
            core._flush_evictions()
            core.tiered.clear()
            core.tiered.hits = core.tiered.misses = 0
            core.dispatch_hook = None
            assert not core.has_work and core.pool.free_pages == \
                core.pool.num_pages - 1
            runs[schedule] = _serve_all(core, JBI, JSC, JPub(1, None),
                                        JIndexer(8), schedule)
        params = jax.tree.map(lambda a: np.array(a), core.params)
    finally:
        core.close()
    return runs, params


PLAIN = dict(num_pages=None, host_cache_blocks=0, disk_cache_blocks=0)


@pytest.fixture(scope="module")
def jax_plain():
    """One JAX core without tiers for the tests that drive one (its
    programs compile once for the module); each test takes it with its
    reusable blocks flushed and no dispatch hook."""
    core = _jax_core(**PLAIN)

    def fresh():
        core.dispatch_hook = None
        core.pool.flush_reusable()
        assert not core.has_work
        return core

    yield fresh
    core.close()


def _torch_core(np_params=None, **kw):
    cfg = TorchEngineConfig(model=tl.preset("tiny-byte", dtype=torch.float32),
                            device="cpu", **{**ENGINE, **kw})
    params = (None if np_params is None else
              tl.params_from_jax(np_params, cfg.model, torch.device("cpu")))
    return EngineCore(cfg, params)


@pytest.mark.parametrize("schedule", list(SCHEDULE_HITS))
def test_engine_reuse_matches_jax_engine(jax_reference, schedule):
    runs, np_params = jax_reference
    want, want_events, want_scores, want_stats, want_dispatches = \
        runs[schedule]
    core = _torch_core(np_params)
    try:
        got, events, scores, stats, dispatches = _serve_all(
            core, BackendInput, StopConditions, KvEventPublisher(1, None),
            KvIndexer(8), schedule)
    finally:
        core.close()
    assert got == want
    assert events == want_events
    assert scores == want_scores
    assert stats == want_stats
    assert dispatches == want_dispatches
    hits = {sid: hit for sid, (_, hit) in want.items()}
    # reuse from the device, from the host tier and from disk all happened
    assert {sid: hits[sid] for sid in SCHEDULE_HITS[schedule]} == \
        SCHEDULE_HITS[schedule]
    assert want_stats["hits"] > 0 and want_stats["disk_blocks"] > 0
    assert any("removed" in e for e in want_events)
    assert core.prefix_hit_tokens == sum(hits.values())
    n_requests = len(_requests(schedule)[0])
    if schedule == "chained":
        assert len(dispatches) >= 3 * n_requests
        assert sum(chained for chained, _ in dispatches) >= 2 * n_requests
    else:
        assert len(dispatches) <= 2 * n_requests
    # every page is back: none leased by a finished request
    assert not core.has_work and not core._deferred_release
    assert core.pool.free_pages == core.pool.num_pages - 1


def test_steady_batch_dispatches_match_jax_engine(jax_reference,
                                                  jax_plain):
    """Two requests decoding side by side: the same tokens, and the same
    (chained, lanes) for every decode dispatch as the JAX core's dispatch
    hook records (the window chains while both run, syncs when one
    finishes, and chains again on the survivor)."""
    _, np_params = jax_reference
    plain = PLAIN
    requests = {"x": (list(range(3, 23)), 13), "y": (list(range(40, 45)), 22)}

    def run(core, bi, sc):
        dispatches = _record_dispatches(core)
        for sid, (toks, n) in requests.items():
            core.submit(sid, bi(token_ids=toks,
                                stop=sc(max_tokens=n, ignore_eos=True)))
        got = {sid: [] for sid in requests}
        for _ in range(100):
            for so in core.step():
                got[so.seq_id].append(so.token)
            if not core.has_work:
                return got, dispatches
        raise AssertionError("the batch did not finish")

    ref = jax_plain()
    try:
        want = run(ref, JBI, JSC)
    finally:
        ref.dispatch_hook = None
    got = run(_torch_core(np_params, **plain), BackendInput, StopConditions)
    assert got == want
    tokens, dispatches = got
    assert [len(tokens[sid]) for sid in requests] == [13, 22]
    assert (True, (0, 1)) in dispatches and (True, (1,)) in dispatches


def test_engine_prefix_reuse_same_tokens(jax_reference):
    runs, np_params = jax_reference
    want = runs["one_dispatch"][0]
    core = _torch_core(np_params, num_pages=None, host_cache_blocks=0,
                       disk_cache_blocks=0)
    prompt = _requests()[0][0][1]
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


@pytest.mark.parametrize("prompt_len,max_tokens,slot_written", [
    # ends on its prefill token, which completes page 0
    pytest.param(7, 1, False, id="7-1"),
    # ends on the last step of a decode dispatch, page 1; the dispatch
    # chained behind it writes the slot
    pytest.param(11, 5, True, id="11-5"),
])
def test_engine_never_reuses_a_block_with_an_unwritten_slot(
        jax_reference, jax_plain, prompt_len, max_tokens, slot_written):
    """A request's last sampled token has no KV in the pool until a later
    step feeds it back. When it completes a block and no later step ran
    (the request ended on its prefill token), that block must not be
    matched later: the next turn (prompt + that token + more) must give the
    cold engine's tokens. The port unseals it and publishes its removed
    event, where the JAX engine parks the stale block. After a decode
    dispatch, the dispatch chained behind it writes the slot in both
    engines: the block stays, and the next turn's prefix hit is the JAX
    engine's."""
    _, np_params = jax_reference
    plain = PLAIN
    warm = _torch_core(np_params, **plain)
    cold = _torch_core(np_params, enable_prefix_reuse=False, **plain)
    ref = jax_plain()
    events = []
    warm.pool.on_block_sealed = lambda sid, b, p, l: events.append(
        ("stored", b.sequence_hash))
    warm.pool.on_blocks_removed = lambda hs: events.extend(
        ("removed", h) for h in hs)
    prompt = list(range(10, 10 + prompt_len))
    try:
        got, _ = _drive(warm, BackendInput, StopConditions, "a", prompt,
                        max_tokens)
        assert _drive(ref, JBI, JSC, "a", prompt, max_tokens)[0] == got
        assert (prompt_len + max_tokens) % 8 == 0
        last = compute_seq_hashes(prompt + got, 8)[-1]
        if slot_written:
            assert events[-1] == ("stored", last)
            assert all(kind == "stored" for kind, _ in events)
        else:
            assert events[-2:] == [("stored", last), ("removed", last)]
        turn2 = prompt + got + [50, 51, 52, 53, 54]
        want, _ = _drive(cold, BackendInput, StopConditions, "b", turn2, 4)
        again, hit = _drive(warm, BackendInput, StopConditions, "b", turn2,
                            4)
        ref_again, ref_hit = _drive(ref, JBI, JSC, "b", turn2, 4)
    finally:
        ref.pool.flush_reusable()
    assert again == want
    assert hit == prompt_len + max_tokens - (0 if slot_written else 8)
    if slot_written:
        assert (again, hit) == (ref_again, ref_hit)
    else:
        # the JAX engine reuses the stale block (ROADMAP, Queue 3)
        assert ref_hit == hit + 8
