"""The port's router, metrics plane and workers in a fleet, against the JAX
package's.

Module against module: the KV scheduler's scores and decisions on seeded
snapshots, ``EngineCore.utilization()`` after the same schedule, and the
cluster metrics aggregator's gauges. Then the mixed fleet, both ways: a JAX
store, router and frontend route to a torch worker by the overlap of that
worker's own KV events, and the port's store, router and frontend route to
a JAX worker; both workers load one tiny f32 checkpoint written here with
the JAX loader's writer, so their greedy streams are token-identical. Also
``out=dyn://`` batch mode against a torch worker, and the frontend's store
scrapes (``/metrics``, ``/v1/flows``, the brownout monitor), which needed
the port's ``llm/metrics_aggregator.py``.
"""

import asyncio
import contextlib
import dataclasses
import importlib
import json
import random
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jl
from dynamo_tpu_torch.models import llama as tl

torch.set_num_threads(2)

PKGS = ("dynamo_tpu", "dynamo_tpu_torch")
PAGE = 8
ENGINE = {"max_batch": 2, "max_context": 128, "prefill_chunk": 32,
          "decode_steps": 4}


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


async def until(predicate, timeout: float = 10.0, msg: str = "condition"):
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {msg}")
        await asyncio.sleep(0.02)


# ---------------------------------------------------------------------------
# the KV scheduler on seeded snapshots
# ---------------------------------------------------------------------------

def _snapshot(rng, n_workers):
    workers, scores = {}, {}
    for w in range(n_workers):
        wid = 0x1000 + 7 * w
        total = float(rng.choice([0, 4, 8]))
        active = float(rng.integers(0, 9))
        workers[wid] = dict(
            request_active_slots=active, request_total_slots=total,
            kv_active_blocks=float(rng.integers(0, 100)),
            kv_total_blocks=float(rng.choice([0, 100])),
            num_requests_waiting=float(rng.integers(0, 3)),
            kv_resident_bytes=float(rng.integers(0, 1 << 30)),
            kv_capacity_bytes=float(rng.choice([0, 1 << 30])))
        if rng.random() < 0.7:
            scores[wid] = int(rng.integers(0, 20))
    tokens = [int(t) for t in rng.integers(1, 250, int(rng.integers(1, 200)))]
    return workers, scores, tokens


def _decide(pkg, seed, n_workers):
    sch = _mod(pkg, "llm.kv_router.scheduler")
    proto = _mod(pkg, "llm.kv_router.protocols")
    idx = _mod(pkg, "llm.kv_router.indexer")
    rng = np.random.default_rng(seed)
    events = []
    s = sch.KvScheduler(PAGE, on_hit_rate=lambda e: events.append(
        e.to_dict()))
    out = []
    for _ in range(6):
        workers, scores, tokens = _snapshot(rng, n_workers)
        fpm = {w: proto.ForwardPassMetrics(**m) for w, m in workers.items()}
        s.update_endpoints(fpm)
        ov = idx.OverlapScores(scores=dict(scores))
        cands = sch.score_candidates(tokens, PAGE, ov, s.endpoints)
        pick = sch.default_selector(tokens, PAGE, ov, s.endpoints,
                                    rng=random.Random(seed))
        wid = s.schedule(tokens, ov, salt=seed)
        out.append((cands, pick, wid, s.last_choice))
    log = [{k: v for k, v in d.items() if k != "at"}
           for d in s.decision_log()]
    return out, log, events


@pytest.mark.parametrize("seed", range(4))
def test_scheduler_decisions_match_jax(seed, monkeypatch):
    # ties break at random inside schedule(): seed both packages' draws
    got = {}
    for pkg in PKGS:
        monkeypatch.setattr(_mod(pkg, "llm.kv_router.scheduler").random,
                            "choice", random.Random(seed).choice)
        got[pkg] = _decide(pkg, seed, n_workers=2 + seed)
    assert got["dynamo_tpu_torch"] == got["dynamo_tpu"]
    assert any(wid is not None for _, _, wid, _ in got["dynamo_tpu"][0])


async def test_router_fast_fail_matches_jax():
    async def body():
        for pkg in PKGS:
            sch = _mod(pkg, "llm.kv_router.scheduler")
            proto = _mod(pkg, "llm.kv_router.protocols")
            idx = _mod(pkg, "llm.kv_router.indexer")
            eng = _mod(pkg, "runtime.engine")
            s = sch.KvScheduler(PAGE)
            s.update_endpoints({1: proto.ForwardPassMetrics(
                request_active_slots=4, request_total_slots=4,
                num_requests_waiting=1)})
            with pytest.raises(eng.EngineError) as ei:
                await s.schedule_or_wait([1] * 16, idx.OverlapScores({}),
                                         fast_fail=True)
            assert (ei.value.code, ei.value.stage, ei.value.reason) == \
                (503, "router", "saturated")

    await asyncio.wait_for(body(), 10)


# ---------------------------------------------------------------------------
# EngineCore.utilization() after the same schedule
# ---------------------------------------------------------------------------

GOODPUT = ("mfu", "mbu", "hbm_gbps")


def test_utilization_matches_jax_engine():
    from dynamo_tpu.engine.engine import EngineCore as JaxCore
    from dynamo_tpu.engine.engine import JaxEngineConfig
    from dynamo_tpu.llm.protocols import common as jc
    from dynamo_tpu_torch.engine.engine import EngineCore, TorchEngineConfig
    from dynamo_tpu_torch.llm.protocols import common as tc

    kw = dict(page_size=PAGE, host_cache_blocks=8, **ENGINE)
    jcore = JaxCore(JaxEngineConfig(
        model=jl.preset("tiny-byte", dtype=jnp.float32), **kw))
    params = jax.tree.map(lambda a: np.array(a), jcore.params)
    cfg = TorchEngineConfig(model=tl.preset("tiny-byte",
                                            dtype=torch.float32),
                            device="cpu", **kw)
    tcore = EngineCore(cfg, tl.params_from_jax(params, cfg.model,
                                               torch.device("cpu")))
    rng = np.random.default_rng(0)
    base = [int(x) for x in rng.integers(1, 250, 30)]
    prompts = [base, base[:24] + [5, 6, 7], [int(x) for x in
                                             rng.integers(1, 250, 20)]]
    try:
        seen = {}
        for name, core, m in (("jax", jcore, jc), ("torch", tcore, tc)):
            trace = [core.utilization()]
            for i, p in enumerate(prompts):
                core.submit(f"r{i}", m.BackendInput(
                    token_ids=list(p),
                    stop=m.StopConditions(max_tokens=9, ignore_eos=True)))
                trace.append(core.utilization())     # one waiting
                for _ in range(200):
                    if not core.has_work:
                        break
                    core.step()
                    trace.append(core.utilization())
            seen[name] = trace
        assert len(seen["torch"]) == len(seen["jax"])
        for j, t in zip(seen["jax"], seen["torch"]):
            assert list(t) == list(j)
            assert {k: v for k, v in t.items() if k not in GOODPUT} == \
                {k: v for k, v in j.items() if k not in GOODPUT}
        last = seen["torch"][-1]
        assert last["gpu_prefix_cache_hit_rate"] > 0
        assert last["kv_capacity_bytes"] > last["kv_resident_bytes"] >= 0
        assert any(u["request_active_slots"] == 1 for u in seen["torch"])
        # the goodput keys are each engine's own meter's window
        assert {k: last[k] for k in GOODPUT} == {
            k: tcore.goodput.snapshot()[k] for k in GOODPUT}
        assert last["mfu"] > 0
    finally:
        jcore.close()
        tcore.close()


# ---------------------------------------------------------------------------
# the cluster metrics aggregator
# ---------------------------------------------------------------------------

async def test_cluster_metrics_aggregator_gauges_match_jax():
    """Both aggregators, each on its own package's runtime, scrape the same
    store (worker snapshots published by both packages) and fold the same
    hit-rate events: their rendered gauges are equal."""
    async def body():
        from dynamo_tpu_torch.runtime.store_server import StoreServer

        srv = StoreServer()
        port = await srv.start()
        rts, aggs = [], {}
        try:
            for pkg in PKGS:
                drt = await _mod(pkg, "runtime.component").DistributedRuntime(
                    store_port=port).connect()
                rts.append(drt)
            for pkg, drt in zip(PKGS, rts):
                ma = _mod(pkg, "llm.metrics_aggregator")
                proto = _mod(pkg, "llm.kv_router.protocols")
                m = proto.ForwardPassMetrics(
                    request_active_slots=2 + PKGS.index(pkg),
                    request_total_slots=8, kv_active_blocks=10,
                    kv_total_blocks=100, num_requests_waiting=1,
                    gpu_prefix_cache_hit_rate=0.25, mfu=0.1)
                await drt.store.put(
                    ma.metrics_key("agg", "backend", drt.worker_id),
                    json.dumps(m.to_dict()).encode(), lease=drt.lease)
            for pkg, drt in zip(PKGS, rts):
                ma = _mod(pkg, "llm.metrics_aggregator")
                aggs[pkg] = ma.ClusterMetricsAggregator(
                    drt, "agg", ["backend"], scrape_interval=0.05)
                await aggs[pkg].start()
            # hit-rate events as a router emits them
            ns = rts[0].namespace("agg")
            for wid, isl, ov in ((rts[0].worker_id, 10, 4),
                                 (rts[1].worker_id, 8, 8)):
                await ns.publish("kv-hit-rate", {
                    "worker_id": wid, "isl_blocks": isl,
                    "overlap_blocks": ov})
            await asyncio.sleep(0.4)
            texts = {pkg: a.registry.render() for pkg, a in aggs.items()}
            assert "llm_kv_hit_rate_percent" in texts["dynamo_tpu"]
            assert "llm_requests_active_slots" in texts["dynamo_tpu"]
            assert texts["dynamo_tpu_torch"] == texts["dynamo_tpu"]
        finally:
            for a in aggs.values():
                await a.stop()
            for drt in rts:
                await drt.close()
            await srv.stop()

    await asyncio.wait_for(body(), 20)


# ---------------------------------------------------------------------------
# the frontend's store scrapes (the port once imported a missing module)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("store_pkg", PKGS, ids=["jax-store",
                                                  "torch-store"])
async def test_frontend_merges_other_processes_stage_dumps(store_pkg,
                                                           caplog):
    """The port's ``HttpService(store=...)``, with another process's stage
    dump published to the store: ``/metrics`` and ``/v1/flows`` show the
    merged dump and the port's brownout monitor reads it. Before the port
    had ``llm/metrics_aggregator.py`` these scrapes logged an ImportError
    and showed the local dump only (the jax-store case runs on such a
    tree)."""
    from dynamo_tpu_torch.llm.http_service import HttpService, ModelManager
    from dynamo_tpu_torch.obs.flows import _SEP
    from dynamo_tpu_torch.utils import overload
    from dynamo_tpu_torch.utils.prometheus import StageMetrics
    from dynamo_tpu_torch.utils.slo import SloMonitor, SloObjective

    StoreServer = _mod(store_pkg, "runtime.store_server").PyStoreServer
    DistributedRuntime = _mod(store_pkg,
                              "runtime.component").DistributedRuntime
    agg = _mod(store_pkg, "llm.metrics_aggregator")
    StagePublisher, fetch_stage_states = (agg.StagePublisher,
                                          agg.fetch_stage_states)

    async def body():
        srv = StoreServer()
        port = await srv.start()
        other = await DistributedRuntime(store_port=port).connect()
        front = await DistributedRuntime(store_port=port).connect()
        svc = HttpService(ModelManager(), host="127.0.0.1", port=0,
                          store=front.store, namespace="mx")
        await svc.start()
        try:
            # the other process's stage registry (its own StageMetrics)
            sm = StageMetrics()
            ttft = sm.ttft
            sm.link_bytes.inc("w1", "w2", "kv_fetch", amount=4096)
            pub = StagePublisher(other.store, "mx", "backend",
                                 other.worker_id, other.lease,
                                 dump_fn=sm.registry.state_dump)
            for _ in range(3):
                ttft.observe("m", value=0.01)
            await pub.publish()

            def get(path):
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{svc.port}{path}",
                        timeout=10) as r:
                    return r.read().decode()

            with caplog.at_level("ERROR"):
                text = await asyncio.to_thread(get, "/metrics")
                flows = json.loads(await asyncio.to_thread(get, "/v1/flows"))
            # no scrape failed (on a tree without the module each one
            # logged a ModuleNotFoundError, an ImportError)
            assert not [r for r in caplog.records if r.exc_info]
            assert 'llm_ttft_seconds_count{component="backend",model="m"} 3' \
                in text
            assert any(lk["src"] == "w1" and lk["dst"] == "w2"
                       and lk["kinds"] == {"kv_fetch": 4096}
                       for lk in flows["links"]), flows
            assert _SEP not in json.dumps(flows)
            # the brownout monitor folds the same merged dumps: a burst of
            # slow first tokens in the other process steps the level up
            mon = overload.BrownoutMonitor(
                front.store, "mx",
                controller=overload.BrownoutController(dwell_up=0.0),
                slo_monitor=SloMonitor(
                    objectives=[SloObjective("ttft_p90", 0.9,
                                             "llm_ttft_seconds", 0.5)],
                    registry_gauge=None))
            assert await mon.tick() == 0
            for _ in range(20):
                ttft.observe("m", value=2.0)
            await pub.publish(force_full=True)
            assert await mon.tick() >= 1
            state = overload.BrownoutState()
            await state.watch(front.store, "mx")
            await until(lambda: state.level >= 1, msg="brownout published")
            comps = [c for c, _ in await fetch_stage_states(front.store,
                                                            "mx")]
            assert comps.count("backend") == 1
        finally:
            await svc.stop()
            await front.close()
            await other.close()
            await srv.stop()

    await asyncio.wait_for(body(), 20)


# ---------------------------------------------------------------------------
# the mixed fleet
# ---------------------------------------------------------------------------

HF_CONFIG = {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
             "vocab_size": 272, "hidden_size": 64, "intermediate_size": 128,
             "num_hidden_layers": 2, "num_attention_heads": 4,
             "num_key_value_heads": 2, "max_position_embeddings": 256,
             "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
             "tie_word_embeddings": False}


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A tiny f32 Llama checkpoint (HF layout, byte tokenizer), written with
    the JAX loader's writer from seeded random weights."""
    from dynamo_tpu.engine.loader import save_llama_params

    d = tmp_path_factory.mktemp("fleet") / "mix"
    cfg = jl.LlamaConfig.from_hf_config(HF_CONFIG, dtype=jnp.float32)
    params = jl.init_params(cfg, jax.random.PRNGKey(0))
    save_llama_params(str(d), jax.tree.map(np.asarray, params), cfg)
    (d / "config.json").write_text(json.dumps(HF_CONFIG))
    return str(d)


@pytest.fixture
def f32(monkeypatch):
    """Both packages size checkpoints in f32 (bf16 by default)."""
    for mod, dt in ((jl, jnp.float32), (tl, torch.float32)):
        orig = mod.LlamaConfig.from_hf_config.__func__
        monkeypatch.setattr(mod.LlamaConfig, "from_hf_config", classmethod(
            lambda cls, c, dtype=None, _o=orig, _dt=dt: _o(cls, c,
                                                           dtype=_dt)))


def _worker_args(pkg, store, ckpt):
    w = _mod(pkg, "cli.worker")
    extra = dict(ENGINE)
    argv = ["--store", store, "--model-path", ckpt, "--model-name", "mix",
            "--register-model", "--kv-block-size", str(PAGE),
            "--metrics-interval", "0.1"]
    if pkg == "dynamo_tpu":
        extra["warmup"] = False
        argv += ["--engine", "jax"]
    else:
        argv += ["--engine", "torch", "--device", "cpu"]
    return w.parse_args(argv + ["--extra-engine-args", json.dumps(extra)])


async def _start(coro_fn):
    """Run a CLI's ``run_*(args, ready_event=...)`` until it is ready."""
    ev = asyncio.Event()
    task = asyncio.create_task(coro_fn(ev))
    waiter = asyncio.create_task(ev.wait())
    done, _ = await asyncio.wait({task, waiter}, timeout=60,
                                 return_when=asyncio.FIRST_COMPLETED)
    if task in done:
        task.result()
        raise AssertionError("service exited before it was ready")
    if waiter not in done:
        raise AssertionError("service not ready within 60 s")
    return task


async def _stop(task):
    task.cancel()
    with contextlib.suppress(BaseException):
        await task


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.read().decode()


async def _greedy(pkg, drt, wid, tokens):
    """Token ids of one greedy request sent straight to worker ``wid``."""
    common = _mod(pkg, "llm.protocols.common")
    client = await drt.namespace("dynamo").component("backend") \
        .endpoint("generate").client().start()
    bi = common.BackendInput(token_ids=list(tokens),
                             stop=common.StopConditions(max_tokens=8,
                                                        ignore_eos=True))
    out = []
    async for item in client.generate(bi.to_dict(), mode="direct",
                                      instance_id=wid):
        out += item.get("token_ids") or []
    return out


PREFIX = "The mixed fleet shares one prefix, block by block. "   # 51 bytes


@pytest.mark.parametrize("plane,holder", [
    ("dynamo_tpu", "dynamo_tpu_torch"), ("dynamo_tpu_torch", "dynamo_tpu")],
    ids=["jax-plane/torch-holder", "torch-plane/jax-holder"])
async def test_mixed_fleet_routes_by_the_holders_kv_events(
        plane, holder, checkpoint, f32):
    """``plane`` runs the store, the KV router and the discovery frontend;
    a ``holder`` worker serves prefix A first, then a worker of the other
    package joins. Requests sharing A go to the holder with the overlap
    its own KV events announced."""
    other = PKGS[1 - PKGS.index(holder)]

    async def body():
        srv = _mod(plane, "runtime.store_server").PyStoreServer()
        sport = await srv.start()
        store = f"127.0.0.1:{sport}"
        DRT = _mod(plane, "runtime.component").DistributedRuntime
        rdrt = await DRT(store_port=sport).connect()
        tasks, svc = [], None
        try:
            wmod = {p: _mod(p, "cli.worker") for p in PKGS}
            tasks.append(await _start(lambda ev: wmod[holder].run_worker(
                _worker_args(holder, store, checkpoint), ready_event=ev)))
            router = _mod(plane, "llm.kv_router.router").KvRouterService(
                rdrt, "dynamo", "backend", block_size=PAGE,
                scrape_interval=0.1)
            await router.start()
            await router.serve(rdrt.namespace("dynamo").component("router"))
            http = _mod(plane, "cli.http")
            svc = await http.run_http(http.parse_args(
                ["--store", store, "--port", "0", "--host", "127.0.0.1",
                 "--router-component", "router", "--namespace", "dynamo"]))
            await until(lambda: svc.manager.get("mix") is not None,
                        msg="model discovered")
            hport = svc.port
            a_tokens = list(PREFIX.encode())
            st, body0 = await asyncio.to_thread(_post, hport, {
                "model": "mix", "prompt": PREFIX, "max_tokens": 4,
                "temperature": 0})
            assert st == 200 and body0["usage"]["completion_tokens"] == 4
            (hid,) = router.worker_client.instances
            n_blocks = len(a_tokens) // PAGE
            await until(lambda: router.indexer.find_matches_for_tokens(
                a_tokens).scores.get(hid, 0) >= n_blocks,
                msg="holder's KV events at the router")
            # the holder's metrics reached the frontend through the store
            text = await asyncio.to_thread(_get, hport, "/metrics")
            assert 'component="backend"' in text
            # a worker of the other package joins the pool
            tasks.append(await _start(lambda ev: wmod[other].run_worker(
                _worker_args(other, store, checkpoint), ready_event=ev)))
            await until(lambda: len(router.worker_client.instances) == 2
                        and len(router.scheduler.endpoints.workers) == 2,
                        msg="second worker routable")
            (oid,) = set(router.worker_client.instances) - {hid}
            n0 = len(router.decisions())
            for i in range(3):
                st, out = await asyncio.to_thread(_post, hport, {
                    "model": "mix", "prompt": PREFIX + f"suffix {i}!",
                    "max_tokens": 3, "temperature": 0})
                assert st == 200 and out["usage"]["completion_tokens"] == 3
            dec = router.decisions()[n0:]
            assert [d["worker_id"] for d in dec] == [hid] * 3, dec
            assert all(d["overlap_blocks"] >= n_blocks for d in dec)
            other_c = [c for d in dec for c in d["candidates"]
                       if c["worker_id"] == oid]
            assert other_c and all(c["overlap_blocks"] == 0
                                   for c in other_c)
            # the frontend's audit route serves the same ring
            ring = json.loads(await asyncio.to_thread(
                _get, hport, "/v1/router/decisions"))
            ring = ring.get("decisions", ring)
            assert [d["worker_id"] for d in ring[-3:]] == [hid] * 3
            # one checkpoint, two packages: the same greedy tokens
            toks = a_tokens + list(b"ends")
            got = {p: await _greedy(plane, rdrt, w, toks)
                   for p, w in ((holder, hid), (other, oid))}
            assert len(got[holder]) == 8 and got[holder] == got[other], got
        finally:
            if svc is not None:
                await svc.stop()
            for t in tasks:
                await _stop(t)
            await router.stop()
            await rdrt.close()
            await srv.stop()

    await asyncio.wait_for(body(), 120)


async def test_run_out_dyn_batch_against_a_torch_worker(checkpoint, f32,
                                                        tmp_path, capsys):
    from dynamo_tpu_torch.cli import run, worker
    from dynamo_tpu_torch.runtime.store_server import StoreServer

    batch = tmp_path / "prompts.jsonl"
    batch.write_text("".join(json.dumps({"text": f"prompt number {i}"})
                             + "\n" for i in range(4)))

    async def body():
        srv = StoreServer()
        port = await srv.start()
        store = f"127.0.0.1:{port}"
        task = await _start(lambda ev: worker.run_worker(
            _worker_args("dynamo_tpu_torch", store, checkpoint),
            ready_event=ev))
        try:
            await run.amain([f"in=batch:{batch}",
                             "out=dyn://dynamo.backend.generate",
                             "--store", store, "--model-path", checkpoint,
                             "--max-tokens", "5", "--concurrency", "2"])
        finally:
            await _stop(task)
            await srv.stop()
        with pytest.raises(SystemExit, match="ns.component.endpoint"):
            await run.amain(["in=none", "out=dyn://just.two"])

    await asyncio.wait_for(body(), 90)
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["requests"] == 4 and stats["tokens_out"] == 20


def test_worker_refuses_what_is_not_ported(monkeypatch):
    from dynamo_tpu_torch.cli import router, worker

    with pytest.raises(NotImplementedError, match="item 11"):
        worker.check_ported(worker.parse_args(["--num-nodes", "2"]))
    # disaggregation is ported: a decode worker starts with it
    worker.check_ported(worker.parse_args(["--enable-disagg"]))
    # options of slices not ported at all are not defined: argparse refuses
    with pytest.raises(SystemExit):
        worker.parse_args(["--tp", "2"])
    # cluster KV sharing is ported: a worker starts with it
    monkeypatch.setenv("DYN_KV_CLUSTER", "1")
    worker.check_ported(worker.parse_args([]))
    monkeypatch.delenv("DYN_KV_CLUSTER")
    worker.check_ported(worker.parse_args([]))
    with pytest.raises(SystemExit):
        router.parse_args(["--fleet"])
    # flags default from DYN_* as in the JAX worker (utils/dynconfig.py)
    monkeypatch.setenv("DYN_WORKER_ENGINE", "echo")
    monkeypatch.setenv("DYN_DEVICE", "cpu")
    a = worker.parse_args([])
    assert (a.engine, a.device) == ("echo", "cpu")


def test_model_keys_and_cards_equal_jax():
    jr, tr = _mod("dynamo_tpu", "llm.remote"), _mod("dynamo_tpu_torch",
                                                     "llm.remote")
    for args in (("chat", "m", None), ("completion", "llama3:8b", 0x1f)):
        assert tr.model_key(*args) == jr.model_key(*args)
        k = jr.model_key(*args)
        assert tr.split_model_key(k) == jr.split_model_key(k)
    assert tr.split_model_key("other/x") is None
    jcard = _mod("dynamo_tpu", "llm.model_card").ModelDeploymentCard
    tcard = _mod("dynamo_tpu_torch", "llm.model_card").ModelDeploymentCard
    j = jcard.synthetic("m")
    t = tcard.from_dict(j.to_dict())
    assert t.to_dict() == j.to_dict()
    assert dataclasses.asdict(t) == jcard.from_dict(t.to_dict()).to_dict()
