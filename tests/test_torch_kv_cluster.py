"""Cluster-wide KV sharing in the port, against the JAX package.

Module against module: registry records byte for byte both ways, the
index's prefix coverage and donor election, the transfer-cost model and
the router's cluster scoring on the same inputs, and the publisher's
coalescing and lease death on the port's store. Engine against engine
(tiny-byte, f32 for token identity): a prompt served by one engine is
mirrored to its host tier write-through, fetched peer to peer into another
engine's tier (blocks bitwise equal), and served there prefilling only the
suffix, with the JAX engine's cold greedy tokens. The mixed fleet both
ways: a JAX donor feeds a torch receiver and the reverse, in f32 engines
and in bf16 tiers (geometry strings and bits equal). Donor death and a
slow donor fall back to local prefill. The port's write-through never
mirrors a block whose last slot is unwritten, a pending mirror of an
evicted page is dropped, and a staged prefetch is consumed at admission.
Last, the whole plane through the CLIs: a worker's lease-bound record, the
router's donor stamp, and the stamped fetch on the other worker, with the
donor a torch worker or a JAX worker.

The JAX engine is built once for the module; the port's engines are cheap
and built per test.
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
ENGINE = dict(page_size=PAGE, max_batch=2, max_context=128, prefill_chunk=32,
              decode_steps=4, host_cache_blocks=16, cluster_writethrough=True)
_rng = np.random.default_rng(12)
PROMPT_A = [int(t) for t in _rng.integers(1, 250, 40)]     # 5 full pages
PROMPT_B = [int(t) for t in _rng.integers(1, 250, 40)]
MAX_TOKENS = 8
BLOCK_SHAPE = (2, 2, 4, 8)          # tier-level cases: [L, Hkv, page, Dh]


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _bi(pkg, prompt, **kw):
    c = _mod(pkg, "llm.protocols.common")
    return c.BackendInput(token_ids=list(prompt), stop=c.StopConditions(
        max_tokens=MAX_TOKENS, ignore_eos=True), **kw)


def _ctx(pkg, rid=None):
    return _mod(pkg, "runtime.engine").Context(rid)


async def _stream(engine, pkg, prompt, **kw):
    toks = []
    async for out in engine.generate(_bi(pkg, prompt, **kw), _ctx(pkg)):
        assert out.error is None, out.error
        toks += out.token_ids
    return toks


@pytest.fixture(scope="module")
def jax_side():
    """The JAX engine (host tier, write-through) and its cold greedy
    stream of PROMPT_A, which leaves PROMPT_A's blocks in its tier."""
    from dynamo_tpu.engine.engine import JaxEngine, JaxEngineConfig

    eng = JaxEngine(JaxEngineConfig(
        model=jl.preset("tiny-byte", dtype=jnp.float32), warmup=False,
        **ENGINE))
    cold = asyncio.run(_stream(eng, J, PROMPT_A))
    params = jax.tree.map(np.asarray, eng.core.params)
    yield {"engine": eng, "cold": cold, "params": params}
    eng.shutdown()


def _settle(engine, timeout=10.0):
    """Wait until an engine's thread is idle with its mirrors in the tier
    (the thread flushes them itself once it has no work): the same idle
    reading twice, a few of its idle polls apart."""
    core = engine.core
    deadline = time.monotonic() + timeout
    last = None
    while True:
        busy = core.has_work or core._wt_pending or core._wt_copies
        now = None if busy else core.writethrough_blocks
        if now is not None and now == last:
            return
        assert time.monotonic() < deadline, "the engine never settled"
        last = now
        time.sleep(0.08)


def _torch_engine(params, **kw):
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig

    cfg = TorchEngineConfig(model=tl.preset("tiny-byte", dtype=torch.float32),
                            device="cpu", **dict(ENGINE, **kw))
    return TorchEngine(cfg, tl.params_from_jax(params, cfg.model,
                                               torch.device("cpu")))


@contextlib.asynccontextmanager
async def _drts(*pkgs):
    """A store (the port's) and one runtime of each package named."""
    srv = _mod(T, "runtime.store_server").PyStoreServer()
    port = await srv.start()
    drts = []
    try:
        for pkg in pkgs:
            DRT = _mod(pkg, "runtime.component").DistributedRuntime
            drts.append(await DRT(store_port=port,
                                  advertise_host="127.0.0.1").connect())
        yield drts
    finally:
        for d in drts:
            with contextlib.suppress(Exception):
                await d.close()
        await srv.stop()


async def _serve_fetch(pkg, drt, handler):
    comp = drt.namespace("dyn").component("backend")
    await comp.endpoint("kv_fetch").serve(handler)


async def _fetch_client(drt, donor):
    client = await drt.namespace("dyn").component("backend") \
        .endpoint("kv_fetch").client().start()
    for _ in range(200):
        if donor in client.instances:
            return client
        await asyncio.sleep(0.02)
    raise AssertionError("donor's kv_fetch endpoint never appeared")


# ---------------------------------------------------------------------------
# registry records, index, cost model, scoring: module against module
# ---------------------------------------------------------------------------

RECORDS = [
    dict(worker_id=0xab, component="backend",
         geometry={"layers": 2, "kv_heads": 2, "page": 4, "head_dim": 8,
                   "dtype": "float32"}, host=[11, 22], disk=[33], seq=3),
    dict(worker_id=0x1f2e3d, component="prefill",
         geometry={"layers": 32, "kv_heads": 8, "page": 64, "head_dim": 128,
                   "dtype": "bfloat16"}, host=[2 ** 63 + 5, 7], seq=9),
    dict(worker_id=1),
]


@pytest.mark.parametrize("fields", RECORDS, ids=["f32", "bf16", "empty"])
def test_cluster_record_bytes_equal_jax(fields):
    jr, tr = (_mod(p, "llm.kv_cluster.registry").ClusterRecord for p in PKGS)
    jb, tb = jr(**fields).to_bytes(), tr(**fields).to_bytes()
    assert tb == jb
    for rec in (tr.from_bytes(jb), jr.from_bytes(tb)):
        assert rec.to_bytes() == jb
    t, j = tr.from_bytes(jb), jr.from_bytes(tb)
    assert t.block_bytes() == j.block_bytes()
    assert t.block_count == j.block_count
    for h in (11, 22, 33, 44, 7):
        assert (t.holds(h), t.tier_of(h)) == (j.holds(h), j.tier_of(h))


def test_tier_geometry_names_bf16_blocks_as_jax():
    """The port keeps bf16 host blocks as uint16 bits: its record still
    says "bfloat16", as a JAX worker's does, so a mixed fleet agrees."""
    geo = {}
    for pkg, dt in ((J, ml_dtypes.bfloat16), (T, np.uint16)):
        tiers = _mod(pkg, "llm.kvbm.tiers")
        tiered = tiers.TieredKvCache(tiers.HostKvTier(2, BLOCK_SHAPE, dt))
        geo[pkg] = _mod(pkg, "llm.kv_cluster.registry").tier_geometry(tiered)
    assert geo[T] == geo[J] and geo[T]["dtype"] == "bfloat16"
    recs = [_mod(p, "llm.kv_cluster.registry").ClusterRecord(1, geometry=g)
            for p, g in geo.items()]
    assert recs[0].block_bytes() == recs[1].block_bytes() \
        == 2 * int(np.prod(BLOCK_SHAPE)) * 2


async def test_index_find_and_donor_election_equal_jax():
    idx = {p: _mod(p, "llm.kv_cluster.registry").KvClusterIndex()
           for p in PKGS}
    recs = [dict(worker_id=1, component="backend", host=[101, 102, 103],
                 disk=[104]),
            dict(worker_id=2, component="backend", host=[101, 103]),
            dict(worker_id=3, component="prefill", host=[101, 102]),
            dict(worker_id=4, component="backend", host=[101, 102])]
    events = [(f"kv_cluster/dyn/x/{r['worker_id']:x}",
               _mod(J, "llm.kv_cluster.registry").ClusterRecord(**r)
               .to_bytes(), False) for r in recs]
    events += [("kv_cluster/dyn/x/ff", b"junk", False),
               ("kv_cluster/dyn/x/4", None, True)]
    for p in PKGS:
        for ev in events:
            await idx[p]._on_change(*ev)
    chains = ([101, 102, 103, 104], [101], [999], [101, 103])
    for chain in chains:
        for comp in (None, "backend", "prefill"):
            jo = idx[J].find(chain, weight=0.25, component=comp)
            to = idx[T].find(chain, weight=0.25, component=comp)
            assert (to.owners, to.blocks, to.weight) == \
                (jo.owners, jo.blocks, jo.weight)
            for wid in (1, 2, 3, 99, None):
                for local in (0, 1, 3):
                    assert to.donor_for(wid, local) == \
                        jo.donor_for(wid, local)
    assert idx[T].any_block_bytes() == idx[J].any_block_bytes()
    for p in PKGS:
        idx[p].remove_worker(1)
    assert idx[T].find([101]).owners == idx[J].find([101]).owners == {
        2: 1, 3: 1}


def _pair_states(pairs, secs=2.0, nbytes=2e9):
    series = {f"{s}\x1f{d}": bw for (s, d), bw in pairs.items()}
    return [("backend", {
        "llm_kv_pair_bw_bytes_per_s": {"kind": "gauge", "series": series},
        "llm_kv_transfer_seconds": {"series": {"('h2d',)": {"sum": secs}}},
        "llm_kv_transfer_bytes_total": {"series": {"('h2d',)": nbytes}},
    })]


def test_transfer_cost_model_equal_jax(monkeypatch):
    monkeypatch.setenv("DYN_KV_CLUSTER_PEER_WEIGHT", "0.4")
    models = {p: _mod(p, "llm.kv_cluster.registry").TransferCostModel()
              for p in PKGS}
    for states in (None, _pair_states({("1", "2"): 1e6, ("3", "2"): 3e6,
                                       ("1", "4"): 2e9})):
        if states is not None:
            for m in models.values():
                m.update_from_states(states)
        j, t = models[J], models[T]
        assert (t.base, t.bytes_per_s, t.pair_bw) == \
            (j.base, j.bytes_per_s, j.pair_bw)
        for src, dst in ((1, 2), (3, 2), (None, 2), (9, 9), (1, 4),
                         ("1", "4"), (None, None)):
            assert t.bandwidth_info(src, dst) == j.bandwidth_info(src, dst)
            for n, bb in ((4, 250_000), (23, 8_388_608), (1, 0)):
                assert t.estimate_seconds(n, bb, src, dst) == \
                    j.estimate_seconds(n, bb, src, dst)
                assert t.weight(n, bb, src, dst) == j.weight(n, bb, src, dst)


def _scheduler(pkg, loads):
    proto = _mod(pkg, "llm.kv_router.protocols")
    sched = _mod(pkg, "llm.kv_router.scheduler").KvScheduler(block_size=8)
    sched.update_endpoints({
        w: proto.ForwardPassMetrics(
            request_active_slots=a, request_total_slots=8,
            kv_active_blocks=10 * a, kv_total_blocks=100,
            num_requests_waiting=0)
        for w, a in loads.items()})
    return sched


def _cluster(pkg, case):
    reg = _mod(pkg, "llm.kv_cluster.registry")
    if case == "off":
        return None
    ov = reg.ClusterOverlap(owners={1: 4, 2: 2, 7: 4}, weight=0.5)
    if case == "pair":
        m = reg.TransferCostModel(base_weight=0.5)
        m.update_from_states(_pair_states({("7", "1"): 1e4, ("7", "2"): 1e9,
                                           ("1", "3"): 5e8}))
        ov.pair_weight = lambda s, d, n: m.weight(n, 1_000_000, src=s, dst=d)
        ov.pair_seconds = lambda s, d, n: m.estimate_seconds(
            n, 1_000_000, src=s, dst=d)
        ov.pair_source = lambda s, d: m.bandwidth_info(src=s, dst=d)[1]
    return ov


@pytest.mark.parametrize("case", ["off", "plain", "pair"])
@pytest.mark.parametrize("tw", ["1", "0"], ids=["transfer-on",
                                                "transfer-off"])
def test_score_candidates_cluster_equal_jax(case, tw, monkeypatch):
    monkeypatch.setenv("DYN_ROUTER_TRANSFER_WEIGHT", tw)
    tokens = list(range(32))                 # 4 blocks of 8
    got = {}
    for pkg in PKGS:
        sched = _scheduler(pkg, {1: 6, 2: 1, 3: 0})
        ov = _mod(pkg, "llm.kv_router.indexer").OverlapScores()
        ov.scores = {2: 1}
        cands = _mod(pkg, "llm.kv_router.scheduler").score_candidates(
            tokens, 8, ov, sched.endpoints, cluster=_cluster(pkg, case))
        wid = sched.schedule(tokens, ov, cluster=_cluster(pkg, case))
        got[pkg] = (cands, wid, sched.last_choice)
    assert got[T] == got[J]
    if case != "off":
        assert any(c["kv_donor"] is not None for c in got[T][0])


# ---------------------------------------------------------------------------
# the publisher on the port's store
# ---------------------------------------------------------------------------

def _blk(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(BLOCK_SHAPE).astype(dtype)
                 for _ in range(2))


async def test_publisher_coalesces_and_dies_with_its_lease():
    from dynamo_tpu_torch.llm.kv_cluster import (KvClusterIndex,
                                                 KvClusterPublisher,
                                                 cluster_key)
    from dynamo_tpu_torch.llm.kvbm.tiers import HostKvTier, TieredKvCache

    async with _drts(T, T) as (a, b):
        lease = await a.store.lease_grant(ttl=30.0)
        tiered = TieredKvCache(HostKvTier(4, BLOCK_SHAPE, np.float32))
        tiered.offload(11, *_blk(1))
        pub = await KvClusterPublisher(a.store, "dyn", "backend", 7, lease,
                                       tiered, interval=0.05).start()
        idx = await KvClusterIndex().start(b.store, "dyn")
        # the JAX reader sees the port's record exactly as the port's does
        jidx = await _mod(J, "llm.kv_cluster.registry").KvClusterIndex() \
            .start(b.store, "dyn")
        assert idx.records[7].holds(11)
        assert jidx.records[7].to_bytes() == idx.records[7].to_bytes()
        # a burst of offloads coalesces into one write per interval
        n0 = pub.published
        for h in (22, 33, 44):
            tiered.offload(h, *_blk(h))
        for _ in range(200):
            if idx.records.get(7) and idx.records[7].holds(44):
                break
            await asyncio.sleep(0.01)
        assert idx.records[7].holds(44) and idx.records[7].holds(22)
        assert pub.published - n0 <= 2
        assert await pub.publish() == "skipped"      # unchanged: no write
        # lease death reaps the record, for both readers
        await b.store.lease_revoke(lease)
        for _ in range(200):
            if 7 not in idx.records and 7 not in jidx.records:
                break
            await asyncio.sleep(0.01)
        assert 7 not in idx.records and 7 not in jidx.records
        await pub.stop()
        assert tiered.on_change is None
        assert await a.store.get(cluster_key("dyn", "backend", 7)) is None


# ---------------------------------------------------------------------------
# the donor endpoint and the cap
# ---------------------------------------------------------------------------

async def _drain(handler, pkg, hashes):
    return [item async for item in handler({"hashes": hashes},
                                           _ctx(pkg))]


@pytest.mark.parametrize("cap", ["0", "1"], ids=["uncapped", "max-blocks-1"])
async def test_fetch_handler_bytes_equal_jax_and_cap(cap, monkeypatch):
    """Both packages' donors serve the same consecutive prefix as the same
    meta and parts; ``DYN_KV_CLUSTER_MAX_BLOCKS`` caps the donor's answer
    and the receiver's request alike."""
    monkeypatch.setenv("DYN_KV_CLUSTER_MAX_BLOCKS", cap)
    items = {}
    for pkg in PKGS:
        tiers = _mod(pkg, "llm.kvbm.tiers")
        tiered = tiers.TieredKvCache(tiers.HostKvTier(8, BLOCK_SHAPE,
                                                      np.float32))
        for h in (1, 2, 4):                      # hole at 3
            tiered.offload(h, *_blk(h))
        handler = _mod(pkg, "llm.kv_cluster.fetch").make_kv_fetch_handler(
            tiered, worker_id=0xabc)
        items[pkg] = await _drain(handler, pkg, [1, 2, 3, 4])
    assert items[T] == items[J]
    assert items[T][0]["blocks"] == (1 if cap == "1" else 2)
    # the receiver's side of the cap: the hashes it asks a donor for
    got = {}
    for pkg in PKGS:
        fetch = _mod(pkg, "llm.kv_cluster.fetch")
        tiers = _mod(pkg, "llm.kvbm.tiers")
        core = _FakeCore(tiers.TieredKvCache(tiers.HostKvTier(
            4, BLOCK_SHAPE, np.float32)))
        f = fetch.ClusterFetcher(core, None, 1, timeout=1.0)
        got[pkg] = (f._missing_hashes(_bi(pkg, range(16), kv_donor=2,
                                           kv_donor_blocks=3)),
                    fetch.max_fetch_blocks())
    assert got[T] == got[J] and len(got[T][0]) == (1 if cap == "1" else 3)


class _FakePool:
    page_size = 4

    def probe_prefix(self, tokens, host_lookup=None, lora_id=0):
        return 0


class _FakeCore:
    def __init__(self, tiered):
        self.tiered = tiered
        self.pool = _FakePool()


# ---------------------------------------------------------------------------
# peer fetch between engines
# ---------------------------------------------------------------------------

def _tier_blocks(pkg, tiered, prompt, n):
    hashes = _mod(pkg, "llm.tokens").compute_seq_hashes(prompt, PAGE)[:n]
    return [tiered.peek(h) for h in hashes]


async def test_loopback_fetch_prefills_only_the_suffix(jax_side):
    """Worker A serves PROMPT_A (its prefix blocks mirrored write-through);
    B fetches them peer to peer into its host tier, bitwise, and serves
    PROMPT_A prefilling only the last page: the JAX engine's cold tokens."""
    from dynamo_tpu_torch.llm.kv_cluster import ClusterFetcher
    from dynamo_tpu_torch.llm.kv_cluster.fetch import make_kv_fetch_handler
    from dynamo_tpu_torch.obs.flows import flow_ledger
    from dynamo_tpu_torch.utils.prometheus import stage_metrics

    stage = stage_metrics()
    ea, eb = (_torch_engine(jax_side["params"]) for _ in range(2))
    try:
        assert await _stream(ea, T, PROMPT_A) == jax_side["cold"]
        _settle(ea)
        a_blocks = _tier_blocks(T, ea.core.tiered, PROMPT_A, 5)
        assert all(b is not None for b in a_blocks)
        # the prompt's 5 pages and the page the decode overshoot filled
        assert ea.core.writethrough_blocks == 6
        async with _drts(T, T) as (da, db):
            await _serve_fetch(T, da, make_kv_fetch_handler(
                ea.core.tiered, worker_id=da.worker_id))
            client = await _fetch_client(db, da.worker_id)
            fetcher = ClusterFetcher(eb.core, client, db.worker_id,
                                     timeout=10.0)
            n0 = stage.kv_cluster_fetches.get()
            rx0 = flow_ledger().total_bytes("kv_fetch_rx")
            bi = _bi(T, PROMPT_A, kv_donor=da.worker_id, kv_donor_blocks=5)
            assert await fetcher.ensure_prefix(bi, _ctx(T)) == 5
            assert stage.kv_cluster_fetches.get() == n0 + 1
            wire = 5 * 2 * int(np.prod(eb.core.tiered.host.block_shape)) * 4
            assert flow_ledger().total_bytes("kv_fetch_rx") == rx0 + wire
            for (ka, va), (kb, vb) in zip(
                    a_blocks, _tier_blocks(T, eb.core.tiered, PROMPT_A, 5)):
                assert ka.tobytes() == kb.tobytes()
                assert va.tobytes() == vb.tobytes()
            pre = eb.core.prefill_dispatches
            assert await _stream(eb, T, PROMPT_A) == jax_side["cold"]
            assert eb.core.last_prefix_hit == 32
            assert eb.core.prefill_dispatches == pre + 1   # the last page
            # the blocks are local now: nothing left to fetch
            assert await fetcher.ensure_prefix(bi, _ctx(T)) == 0
    finally:
        ea.shutdown()
        eb.shutdown()


@pytest.mark.parametrize("donor_pkg", [J, T], ids=["jax-donor/torch-receiver",
                                                   "torch-donor/jax-receiver"])
async def test_mixed_fleet_fetch_serves_the_cold_tokens(jax_side, donor_pkg):
    """A JAX engine's mirrored prefix feeds a torch engine, and a torch
    engine's feeds the JAX engine; each receiver streams the donor's cold
    greedy tokens, prefilling only the last page."""
    recv_pkg = T if donor_pkg == J else J
    teng = _torch_engine(jax_side["params"])
    jeng = jax_side["engine"]
    try:
        if donor_pkg == J:
            donor, receiver, prompt = jeng, teng, PROMPT_A
            want = jax_side["cold"]
        else:
            donor, receiver, prompt = teng, jeng, PROMPT_B
            want = await _stream(teng, T, PROMPT_B)
            _settle(teng)
        async with _drts(donor_pkg, recv_pkg) as (dd, dr):
            await _serve_fetch(donor_pkg, dd, _mod(
                donor_pkg, "llm.kv_cluster.fetch").make_kv_fetch_handler(
                    donor.core.tiered, worker_id=dd.worker_id))
            client = await _fetch_client(dr, dd.worker_id)
            fetcher = _mod(recv_pkg, "llm.kv_cluster.fetch").ClusterFetcher(
                receiver.core, client, dr.worker_id, timeout=10.0)
            bi = _bi(recv_pkg, prompt, kv_donor=dd.worker_id,
                     kv_donor_blocks=5)
            assert await fetcher.ensure_prefix(bi, _ctx(recv_pkg)) == 5
            got = [b for b in _tier_blocks(recv_pkg, receiver.core.tiered,
                                           prompt, 5)]
            sent = _tier_blocks(donor_pkg, donor.core.tiered, prompt, 5)
            for (ka, va), (kb, vb) in zip(sent, got):
                assert ka.tobytes() == kb.tobytes()
                assert va.tobytes() == vb.tobytes()
            assert await _stream(receiver, recv_pkg, prompt) == want
            assert receiver.core.last_prefix_hit == 32
    finally:
        teng.shutdown()


@pytest.mark.parametrize("donor_pkg", [J, T], ids=["jax-donor/torch-receiver",
                                                   "torch-donor/jax-receiver"])
async def test_mixed_fleet_bf16_blocks_keep_their_bits(donor_pkg):
    """bf16 tiers: ``ml_dtypes.bfloat16`` on the JAX side, ``uint16`` bits
    on the port's. The geometry strings agree and a fetch either way
    deposits the donor's bits."""
    recv_pkg = T if donor_pkg == J else J
    dtypes = {J: ml_dtypes.bfloat16, T: np.uint16}
    tiered = {}
    for pkg in PKGS:
        tiers = _mod(pkg, "llm.kvbm.tiers")
        tiered[pkg] = tiers.TieredKvCache(tiers.HostKvTier(
            8, BLOCK_SHAPE, dtypes[pkg]))
    tokens = list(range(16))                        # 4 blocks of 4
    hashes = _mod(T, "llm.tokens").compute_seq_hashes(tokens, 4)
    for i, h in enumerate(hashes):
        k, v = _blk(100 + i, ml_dtypes.bfloat16)
        if donor_pkg == T:
            k, v = k.view(np.uint16), v.view(np.uint16)
        tiered[donor_pkg].offload(h, k, v)
    geo = [_mod(p, "llm.kv_cluster.registry").tier_geometry(tiered[p])
           for p in PKGS]
    assert geo[0] == geo[1] and geo[0]["dtype"] == "bfloat16"
    async with _drts(donor_pkg, recv_pkg) as (dd, dr):
        await _serve_fetch(donor_pkg, dd, _mod(
            donor_pkg, "llm.kv_cluster.fetch").make_kv_fetch_handler(
                tiered[donor_pkg], worker_id=dd.worker_id))
        client = await _fetch_client(dr, dd.worker_id)
        fetcher = _mod(recv_pkg, "llm.kv_cluster.fetch").ClusterFetcher(
            _FakeCore(tiered[recv_pkg]), client, dr.worker_id, timeout=10.0)
        bi = _bi(recv_pkg, tokens, kv_donor=dd.worker_id, kv_donor_blocks=4)
        assert await fetcher.ensure_prefix(bi, _ctx(recv_pkg)) == 4
    for h in hashes:
        sk, sv = tiered[donor_pkg].peek(h)
        rk, rv = tiered[recv_pkg].peek(h)
        assert rk.dtype == np.dtype(dtypes[recv_pkg])
        assert sk.tobytes() == rk.tobytes() and sv.tobytes() == rv.tobytes()


@pytest.mark.parametrize("failure", ["donor_death", "timeout"])
async def test_failed_fetch_falls_back_to_local_prefill(jax_side, failure):
    """A donor that dies after its meta frame, or answers too slowly, costs
    one counted fallback within the budget; nothing is deposited and the
    request prefills locally with the cold tokens."""
    from dynamo_tpu_torch.llm.kv_cluster import ClusterFetcher
    from dynamo_tpu_torch.utils.prometheus import stage_metrics

    stage = stage_metrics()
    eng = _torch_engine(jax_side["params"])
    try:
        async with _drts(T, T) as (da, db):
            async def stalling(request, ctx):
                if failure == "donor_death":
                    yield {"blocks": 2, "layers": 2, "kv_heads": 2,
                           "page": PAGE, "head_dim": 16, "dtype": "float32",
                           "hashes": [1, 2]}
                await asyncio.sleep(60)          # unbounded-ok: test stub
                yield {"blocks": 0}

            await _serve_fetch(T, da, stalling)
            client = await _fetch_client(db, da.worker_id)
            fetcher = ClusterFetcher(eng.core, client, db.worker_id,
                                     timeout=0.2 if failure == "timeout"
                                     else 5.0)
            fb0 = stage.kv_cluster_fallbacks.get()
            bi = _bi(T, PROMPT_A, kv_donor=da.worker_id, kv_donor_blocks=5)
            t0 = time.monotonic()
            task = asyncio.create_task(fetcher.ensure_prefix(bi, _ctx(T)))
            if failure == "donor_death":
                await asyncio.sleep(0.1)
                await da.close()                 # the donor dies mid-fetch
            assert await asyncio.wait_for(task, 10.0) == 0
            assert time.monotonic() - t0 < 5.0
            assert stage.kv_cluster_fallbacks.get() == fb0 + 1
            assert eng.core.tiered.stats()["host_blocks"] == 0
        assert await _stream(eng, T, PROMPT_A) == jax_side["cold"]
        assert eng.core.last_prefix_hit == 0
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------------
# the engine's write-through and staged prefetch
# ---------------------------------------------------------------------------

def _pages(core, seq_hashes):
    """Each block's device pages, [L, Hkv, page, Dh] k and v arrays."""
    from dynamo_tpu_torch.llm.kvbm.transfer import to_host_array

    out = []
    for h in seq_hashes:
        page = core.pool.blocks._by_hash[h]
        out.append(tuple(to_host_array(p[:, :, page].contiguous())
                         for p in (core.k_pool, core.v_pool)))
    return out


def _run_core(core, sid, prompt, max_tokens):
    from dynamo_tpu_torch.llm.protocols.common import (BackendInput,
                                                       StopConditions)

    core.submit(sid, BackendInput(token_ids=list(prompt), stop=StopConditions(
        max_tokens=max_tokens, ignore_eos=True)))
    toks = []
    while core.has_work:
        toks += [so.token for so in core.step() if so.seq_id == sid]
    return toks


@pytest.mark.parametrize("case", ["ends-on-prefill", "decodes", "spec"])
def test_writethrough_waits_for_a_blocks_last_slot(jax_side, case):
    """A page seals on its last sampled token, whose KV only a later step
    writes. A request of 23 prompt tokens that ends on its prefill token
    never mirrors its third page (ROADMAP Queue 3 item 2's input); one that
    decodes mirrors it after the decode step. Speculative rounds leave a
    rejected draft's KV in the emitted token's slot until the next round:
    a page sealed there is mirrored only after that round. Every mirror
    equals its device pages bit for bit."""
    from dynamo_tpu_torch.llm.tokens import compute_seq_hashes

    kw = {"spec": "ngram", "spec_k": 4} if case == "spec" else {}
    eng = _torch_engine(jax_side["params"], **kw)
    eng.shutdown()                         # drive its core by hand
    core = eng.core
    prompt = [197] * 23 if case == "spec" else PROMPT_A[:23]
    n = {"ends-on-prefill": 1, "decodes": 8, "spec": 40}[case]
    toks = _run_core(core, "a", prompt, n)
    hashes = compute_seq_hashes(prompt + toks, PAGE)
    core.flush_writethrough()
    mirrored = [h for h in hashes if h in core.tiered]
    if case == "ends-on-prefill":
        assert mirrored == hashes[:2] and len(hashes) == 3
    else:
        assert mirrored == hashes[:len(mirrored)] and len(mirrored) >= 3
    if case == "spec":
        assert core.spec_accepted_total > 0
    assert core.writethrough_blocks == len(mirrored)
    assert not core._wt_pending and not core._wt_copies
    for (dk, dv), h in zip(_pages(core, mirrored), mirrored):
        k, v = core.tiered.peek(h)
        assert k.tobytes() == dk.tobytes() and v.tobytes() == dv.tobytes()


def test_pending_mirror_of_an_evicted_page_is_dropped(jax_side):
    """A request that ends in its prefill leaves its mirrors pending; the
    cache-clear op evicts the pages before the next step boundary. The
    pending entries go, and the eviction's own offload (with the pages'
    still-valid data) fills the tier instead."""
    from dynamo_tpu_torch.llm.tokens import compute_seq_hashes

    eng = _torch_engine(jax_side["params"])
    eng.shutdown()
    core = eng.core
    prompt = PROMPT_A[:24]
    hashes = compute_seq_hashes(prompt, PAGE)
    core.submit("a", _bi(T, prompt))
    core.waiting[-1][1].stop.max_tokens = 1
    core.step()                            # prefill, finish, release
    assert not core.has_work
    assert [e[0] for e in core._wt_pending] == hashes
    pages = _pages(core, hashes)
    assert core.flush_reusable() == 3
    assert core._wt_pending == [] and core.writethrough_blocks == 0
    for (dk, dv), h in zip(pages, hashes):
        k, v = core.tiered.peek(h)
        assert k.tobytes() == dk.tobytes() and v.tobytes() == dv.tobytes()


async def test_staged_prefetch_is_consumed_at_admission(jax_side):
    """PROMPT_A's blocks sit only in the host tier; ``prefetch_tiers``
    stages them while the request would queue, and admission scatters the
    staged blocks (hits counted, no stall): the cold tokens, as the
    synchronous restore gives them."""
    from dynamo_tpu_torch.utils.prometheus import stage_metrics

    stage = stage_metrics()
    got = {}
    for mode in ("sync", "staged"):
        eng = _torch_engine(jax_side["params"])
        try:
            await _stream(eng, T, PROMPT_A)
            _settle(eng)
            assert eng.core.flush_reusable() >= 5   # device copies gone
            hits0 = stage.prefetch_h2d_hits.get()
            stalls0 = stage.prefetch_h2d_stalls.get()
            if mode == "staged":
                assert eng.prefetch_tiers(_bi(T, PROMPT_A)) == 5
            got[mode] = await _stream(eng, T, PROMPT_A)
            assert eng.core.last_prefix_hit == 32
            hits = stage.prefetch_h2d_hits.get() - hits0
            assert hits == (4 if mode == "staged" else 0)
            assert stage.prefetch_h2d_stalls.get() == stalls0
        finally:
            eng.shutdown()
    assert got["staged"] == got["sync"] == jax_side["cold"]


def test_a_staged_block_lost_before_admission_counts_a_stall(jax_side,
                                                            monkeypatch):
    """With room for two staged blocks, a second request's prefetch pushes
    the first's out: the first's admission uploads its two requested
    blocks from the host (two stalls, no hit) and the second's consumes
    its own (two hits). The reference discards a requested hash at its
    lookup, before its stall check, so it would count no stall here."""
    from dynamo_tpu_torch.utils.prometheus import stage_metrics

    monkeypatch.setenv("DYN_H2D_PREFETCH_BLOCKS", "2")
    stage = stage_metrics()
    eng = _torch_engine(jax_side["params"])
    eng.shutdown()
    core = eng.core
    want = {sid: _run_core(core, sid, p, 2)
            for sid, p in (("a", PROMPT_A), ("b", PROMPT_B))}
    core.flush_writethrough()
    assert core.flush_reusable() >= 10
    assert core.stage_prefetch(PROMPT_A) == 2
    assert core.stage_prefetch(PROMPT_B) == 2       # A's two are pushed out
    for sid, prompt, hits, stalls in (("a2", PROMPT_A, 0, 2),
                                      ("b2", PROMPT_B, 2, 0)):
        h0 = stage.prefetch_h2d_hits.get()
        s0 = stage.prefetch_h2d_stalls.get()
        assert _run_core(core, sid, prompt, 2) == want[sid[0]]
        assert core.last_prefix_hit == 32
        assert stage.prefetch_h2d_hits.get() - h0 == hits
        assert stage.prefetch_h2d_stalls.get() - s0 == stalls
    assert want["a"] == jax_side["cold"][:2]


# ---------------------------------------------------------------------------
# the plane through the CLIs: record, donor stamp, stamped fetch
# ---------------------------------------------------------------------------

class _Shared:
    """A prebuilt engine handed to a CLI in place of the one it would
    build; the CLI's shutdown leaves it to the test."""

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


def _worker_args(pkg, store):
    extra = dict(ENGINE, warmup=False) if pkg == J else dict(ENGINE)
    argv = ["--store", store, "--kv-block-size", str(PAGE),
            "--namespace", "dyn", "--metrics-interval", "0.1",
            "--extra-engine-args", json.dumps(extra)]
    argv += ["--engine", "jax"] if pkg == J else ["--engine", "torch",
                                                  "--device", "cpu"]
    return _mod(pkg, "cli.worker").parse_args(argv)


@pytest.mark.parametrize("donor_pkg", [T, J], ids=["torch-donor",
                                                   "jax-donor"])
async def test_router_stamps_the_donor_and_the_worker_fetches(
        jax_side, donor_pkg, monkeypatch):
    """Two workers with ``DYN_KV_CLUSTER=1`` behind the port's router: the
    donor serves PROMPT_A (or, a JAX worker, already holds it), its
    lease-bound record lists the blocks, the router places PROMPT_A on the
    other, idle torch worker with the donor stamped, and that worker
    fetches the prefix before admission: the cold tokens, one fetch, one
    router hit."""
    from dynamo_tpu_torch.llm.kv_cluster import cluster_key
    from dynamo_tpu_torch.llm.kv_router.protocols import ForwardPassMetrics
    from dynamo_tpu_torch.llm.kv_router.router import KvRouterService
    from dynamo_tpu_torch.llm.tokens import compute_seq_hashes
    from dynamo_tpu_torch.utils.prometheus import stage_metrics

    monkeypatch.setenv("DYN_KV_CLUSTER", "1")
    monkeypatch.setenv("DYN_KV_CLUSTER_PUBLISH_INTERVAL", "0.05")
    stage = stage_metrics()
    engines = {"receiver": _torch_engine(jax_side["params"])}
    if donor_pkg == T:
        engines["donor"] = _torch_engine(jax_side["params"])
    built = iter([engines.get("donor"), engines["receiver"]]
                 if donor_pkg == T else [engines["receiver"]])
    monkeypatch.setattr(_mod(T, "engine.engine"), "TorchEngine",
                        lambda cfg: _Shared(next(built)))
    monkeypatch.setattr(_mod(J, "engine.engine"), "JaxEngine",
                        lambda cfg: _Shared(jax_side["engine"]))
    srv = _mod(T, "runtime.store_server").PyStoreServer()
    sport = await srv.start()
    store = f"127.0.0.1:{sport}"
    DRT = _mod(T, "runtime.component").DistributedRuntime
    rdrt = await DRT(store_port=sport).connect()
    tasks, svc = [], None
    try:
        client = await rdrt.namespace("dyn").component("backend") \
            .endpoint("generate").client().start()
        wmod = _mod(donor_pkg, "cli.worker")
        tasks.append(await _start(lambda ev: wmod.run_worker(
            _worker_args(donor_pkg, store), ready_event=ev)))
        await client.wait_for_instances(1, timeout=30)
        (donor,) = client.instance_ids()
        if donor_pkg == T:
            out = []
            async for item in client.generate(
                    _bi(T, PROMPT_A).to_dict(), mode="direct",
                    instance_id=donor):
                out += item.get("token_ids") or []
            assert out == jax_side["cold"]
        tasks.append(await _start(lambda ev: _mod(T, "cli.worker")
                                  .run_worker(_worker_args(T, store),
                                              ready_event=ev)))
        await client.wait_for_instances(2, timeout=30)
        (recv,) = set(client.instance_ids()) - {donor}
        svc = await KvRouterService(rdrt, "dyn", "backend", block_size=PAGE,
                                    scrape_interval=3600).start()
        hashes = compute_seq_hashes(PROMPT_A, PAGE)
        for _ in range(300):
            rec = svc.cluster_index.records.get(donor)
            if rec is not None and all(rec.holds(h) for h in hashes):
                break
            await asyncio.sleep(0.02)
        else:
            raise AssertionError("the donor's record never listed PROMPT_A")
        assert await rdrt.store.get(cluster_key("dyn", "backend", donor))
        # the donor is busy, the receiver idle: placement by load
        svc.scheduler.update_endpoints({
            donor: ForwardPassMetrics(request_active_slots=2,
                                      request_total_slots=2,
                                      kv_active_blocks=90,
                                      kv_total_blocks=100),
            recv: ForwardPassMetrics(request_active_slots=0,
                                     request_total_slots=2,
                                     kv_active_blocks=0,
                                     kv_total_blocks=100)})
        hits0 = stage.kv_cluster_hits.get()
        fetches0 = stage.kv_cluster_fetches.get()
        resp = await svc.route(PROMPT_A)
        assert resp["worker_id"] == recv
        assert (resp["kv_donor"], resp["kv_donor_blocks"]) == (donor, 5)
        assert stage.kv_cluster_hits.get() == hits0 + 1
        entry = svc.decisions(1)[0]
        cand = {c["worker_id"]: c for c in entry["candidates"]}[recv]
        assert cand["kv_donor"] == donor and cand["transfer_seconds"] > 0
        out = []
        async for item in client.generate(
                _bi(T, PROMPT_A, kv_donor=resp["kv_donor"],
                    kv_donor_blocks=resp["kv_donor_blocks"]).to_dict(),
                mode="direct", instance_id=recv):
            out += item.get("token_ids") or []
        assert out == jax_side["cold"]
        assert stage.kv_cluster_fetches.get() == fetches0 + 1
        assert engines["receiver"].core.last_prefix_hit == 32
    finally:
        if svc is not None:
            await svc.stop()
        for t in tasks:
            t.cancel()
            with contextlib.suppress(BaseException):
                await t
        jcore = jax_side["engine"].core
        jcore.pool.on_block_sealed = None
        jcore.pool.on_blocks_removed = None
        await rdrt.close()
        await srv.stop()
        for e in engines.values():
            e.shutdown()
