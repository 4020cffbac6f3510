"""The port's model mobility plane (``dynamo_tpu_torch/fleet/mobility``,
``CopyStream.h2d_param_slab``, ``TorchEngine.swap_weights`` and the
worker's agent) against the JAX package's.

The host weight cache keeps the JAX cache's LRU, pin and budget rules;
the hot swap refuses with the JAX swap's typed reasons, overwrites every
weight tensor in place (``data_ptr()`` unchanged) and then decodes the
greedy tokens the JAX engine decodes after the same swap, which equal a
cold port engine of the target checkpoint; the agents claim commands,
fall back to a counted cold reload and stage prefetch hints alike; the
connectors account swaps alike; and a port worker, on a swap command,
re-registers as the sibling model, which answers the request the frontend
parked for it.
"""

import asyncio
import dataclasses
import importlib
import json
import os
import time
import urllib.request

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.engine import loader as tload
from dynamo_tpu_torch.engine.engine import EngineCore, TorchEngineConfig
from dynamo_tpu_torch.fleet.mobility import (SwapError, WeightCache,
                                             hot_swap, mobility_swap_key,
                                             mobility_wake_key,
                                             swap_signature)
from dynamo_tpu_torch.fleet.mobility.weightcache import tree_nbytes
from dynamo_tpu_torch.llm.protocols.common import (BackendInput,
                                                   StopConditions)
from dynamo_tpu_torch.models import llama as tl

J, T = PKGS = ("dynamo_tpu", "dynamo_tpu_torch")
NS = "mobns"
MB = 1 << 20
PROMPT = [5, 6, 7, 8, 9]


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _tree(fill: float, mb: int = 1):
    """A host param tree of ``mb`` MiB."""
    return {"w": torch.full((mb, 256, 1024), fill)}


# ---------------------------------------------------------------------------
# the host weight cache
# ---------------------------------------------------------------------------
def test_cache_lru_pin_and_budget_rules():
    c = WeightCache(capacity_bytes=2 * MB,
                    loader=lambda p, cfg: _tree(0.0))
    assert c.put("a", _tree(1.0)) and c.put("b", _tree(2.0))
    assert c.get("a") is not None          # touch: a becomes MRU
    assert c.put("c", _tree(3.0))          # evicts b (LRU), not a
    assert "a" in c and "c" in c and "b" not in c
    assert c.resident_bytes == 2 * MB
    c.pin("a")
    # a 2-MiB insert would need the pinned entry's bytes: the NEW tree is
    # dropped, never the pinned incumbent
    assert not c.put("big", _tree(9.0, mb=2))
    assert "a" in c and "big" not in c
    c.unpin("a")
    assert c.put("big", _tree(9.0, mb=2)) and "a" not in c
    # the byte count of a tree is the JAX cache's, numpy or torch leaves
    rng = np.random.default_rng(0)
    tree = {"embed": rng.standard_normal((7, 5), np.float32),
            "layers": {"wq": rng.standard_normal((2, 5, 3), np.float32)}}
    jwc = _mod(J, "fleet.mobility.weightcache")
    assert tree_nbytes(tree) == jwc.tree_nbytes(tree)
    assert tree_nbytes({"embed": torch.from_numpy(tree["embed"]).to(
        torch.bfloat16)}) == 7 * 5 * 2
    # on the CPU nothing is page-locked (pinning needs CUDA)
    assert c.pinned is False


def test_cache_prefetch_in_background_and_load_failures():
    loads = []

    def loader(path, cfg):
        loads.append(path)
        if path == "gone":
            raise FileNotFoundError(path)
        return _tree(4.0)

    c = WeightCache(capacity_bytes=8 * MB, loader=loader)
    try:
        assert c.prefetch("ckpt", cfg=None)
        assert not c.prefetch("ckpt", cfg=None)   # queued: idempotent
        for _ in range(200):
            if "ckpt" in c:
                break
            time.sleep(0.01)
        assert "ckpt" in c and loads == ["ckpt"]
        assert not c.prefetch("ckpt", cfg=None)   # resident: idempotent
        assert c.load_now("ckpt", cfg=None) is not None
        assert loads == ["ckpt"]
        assert c.load_now("gone", cfg=None) is None and c.load_errors == 1
    finally:
        c.close()
    assert c.resident_bytes == 0


# ---------------------------------------------------------------------------
# the swap: refusals, parity with the JAX swap, tensors kept in place
# ---------------------------------------------------------------------------
MODEL = tl.preset("tiny-byte", tie_embeddings=False, dtype=torch.float32)


def _cfg(**kw):
    d = dict(model=MODEL, page_size=8, max_batch=4, max_context=128,
             prefill_chunk=32, device="cpu")
    d.update(kw)
    return TorchEngineConfig(**d)


def _write(path, seed):
    rng = np.random.default_rng(seed)
    shapes = tl.param_shapes(MODEL)

    def draw(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32) / np.sqrt(shape[0]))

    params = {k: draw(v) for k, v in shapes.items() if k != "layers"}
    params["layers"] = {k: draw(v) for k, v in shapes["layers"].items()}
    tload.save_llama_params(path, params, MODEL)
    # the HF config a worker's --model-path reads (tiny-byte's shapes)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"architectures": ["LlamaForCausalLM"],
                   "model_type": "llama", "vocab_size": 259,
                   "hidden_size": 64, "num_hidden_layers": 2,
                   "num_attention_heads": 4, "num_key_value_heads": 2,
                   "head_dim": 16, "intermediate_size": 128,
                   "rope_theta": 10000.0, "max_position_embeddings": 1024,
                   "tie_word_embeddings": False}, f)
    return path


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("mobility")
    return _write(str(d / "a"), 3), _write(str(d / "b"), 7)


def _greedy(core, seq, prompt=PROMPT, n=8):
    core.submit(seq, BackendInput(token_ids=list(prompt),
                                  stop=StopConditions(max_tokens=n)))
    toks = []
    for _ in range(500):
        for so in core.step():
            toks.append(so.token)
            if so.finish is not None:
                return toks
    raise AssertionError("did not finish")


@pytest.fixture(scope="module")
def jax_after_swap(ckpts):
    """The JAX engine of A, swapped to B the JAX way: its greedy tokens
    after the swap, and the typed refusals it gave on the way."""
    import jax.numpy as jnp

    from dynamo_tpu.engine.engine import EngineCore as JCore
    from dynamo_tpu.engine.engine import JaxEngineConfig
    from dynamo_tpu.engine.loader import load_llama_params_host
    from dynamo_tpu.fleet.mobility import SwapError as JSwapError
    from dynamo_tpu.fleet.mobility import hot_swap as jhot_swap
    from dynamo_tpu.models import llama as jl

    path_a, path_b = ckpts

    def cfg(**kw):
        d = dict(model=jl.preset("tiny-byte", tie_embeddings=False,
                                 dtype=jnp.float32),
                 tp=1, page_size=8, max_batch=4, max_context=128,
                 prefill_chunk=32)
        d.update(kw)
        return JaxEngineConfig(**d)

    core = JCore(cfg(params_path=path_a))
    reasons = []
    host_b = load_llama_params_host(path_b, core.cfg.model)
    partial = {k: v for k, v in host_b.items() if k != "lm_head"}
    for host, c in (({}, cfg(max_batch=8, params_path=path_b)),
                    (partial, cfg(params_path=path_b))):
        with pytest.raises(JSwapError) as ei:
            jhot_swap(core, host, c)
        reasons.append(ei.value.reason)
    out = jhot_swap(core, host_b, cfg(params_path=path_b), group_layers=1)
    return {"tokens": _greedy(core, "post"), "reasons": reasons,
            "groups": out.groups}


def test_hot_swap_refuses_typed_then_swaps_in_place_like_jax(
        ckpts, jax_after_swap):
    path_a, path_b = ckpts
    want = _greedy(EngineCore(_cfg(params_path=path_b)), "ref")
    core = EngineCore(_cfg(params_path=path_a))
    assert _greedy(core, "pre") != want   # the checkpoints differ

    # ---- refusals, typed as the JAX swap's ----------------------------
    core.submit("busy", BackendInput(token_ids=[1, 2, 3],
                                     stop=StopConditions(max_tokens=64)))
    core.step()
    with pytest.raises(SwapError) as ei:
        hot_swap(core, {}, _cfg(params_path=path_a))
    assert ei.value.reason == "not_drained"
    core.cancel("busy")
    while core.has_work:
        core.step()
    host_b = tload.load_llama_params_host(path_b, MODEL)
    partial = {k: v for k, v in host_b.items() if k != "lm_head"}
    reasons = []
    for host, cfg in (({}, _cfg(max_batch=8, params_path=path_b)),
                      (partial, _cfg(params_path=path_b))):
        with pytest.raises(SwapError) as ei:
            hot_swap(core, host, cfg)
        reasons.append(ei.value.reason)
    assert reasons == jax_after_swap["reasons"] == ["shape_mismatch"] * 2

    # ---- the swap: every tensor overwritten where it lies -------------
    leaves = {("layers", k): v for k, v in core.params["layers"].items()}
    leaves.update({(k,): v for k, v in core.params.items()
                   if k != "layers"})
    ptrs = {k: v.data_ptr() for k, v in leaves.items()}
    out = hot_swap(core, host_b, _cfg(params_path=path_b), group_layers=1)
    assert out.path == "swap" and core.cfg.params_path == path_b
    # group_layers=1: one copy a layer a stacked leaf, as the JAX scatters
    assert out.groups == jax_after_swap["groups"] == \
        MODEL.num_layers * len(core.params["layers"])
    assert {k: v.data_ptr() for k, v in leaves.items()} == ptrs
    for k, v in leaves.items():
        src = host_b[k[0]] if len(k) == 1 else host_b["layers"][k[1]]
        assert torch.equal(v, src), k
    got = _greedy(core, "post")
    assert got == want == jax_after_swap["tokens"]


def test_swap_signature_and_port_refusals():
    a = _cfg(params_path="/ckpt/a", preset="x", seed=1)
    assert swap_signature(a) == swap_signature(
        _cfg(params_path="/ckpt/b", preset="y", seed=2))
    for kw in (dict(max_batch=8), dict(page_size=16),
               dict(model=tl.preset("tiny-byte", tie_embeddings=False,
                                    dtype=torch.float32, hidden_size=128))):
        assert swap_signature(a) != swap_signature(_cfg(**kw))

    # an engine holding state derived from the weights reloads cold
    def stub(**kw):
        base = dict(by_seq={}, waiting=[], _inflight=[], _stream_injects={},
                    cfg=a, kvpager=None, spec=None)
        base.update(kw)
        return type("Core", (), base)()

    for core, why in (
            (stub(cfg=dataclasses.replace(a, model=dataclasses.replace(
                MODEL, vision={"hidden_size": 8}))), "VLM"),
            (stub(kvpager=object()), "KV paging"),
            (stub(spec=type("S", (), {"mode": "draft"})()), "draft")):
        with pytest.raises(SwapError, match=why) as ei:
            hot_swap(core, {}, core.cfg)
        assert ei.value.reason == "unsupported"


def test_param_slab_copy_keeps_the_tensor_and_counts_bytes():
    from dynamo_tpu_torch.llm.kvbm.transfer import CopyStream

    cs = CopyStream()
    buf = torch.zeros((4, 3, 2))
    ptr = buf.data_ptr()
    assert cs.h2d_param_slab(buf, 2, torch.ones((2, 3, 2))) is buf
    assert buf.data_ptr() == ptr
    assert buf[:2].sum() == 0 and buf[2:].sum() == 12
    assert cs.h2d_bytes == 2 * 3 * 2 * 4
    with pytest.raises(ValueError, match="does not fit"):
        cs.h2d_param_slab(buf, 3, torch.ones((2, 3, 2)))


# ---------------------------------------------------------------------------
# the agents, with stub engines, against the JAX agent
# ---------------------------------------------------------------------------
class FakeStore:
    def __init__(self):
        self.kv, self.deletes, self._watchers = {}, [], []

    async def get(self, key):
        return self.kv.get(key)

    async def put(self, key, value, lease=None):
        self.kv[key] = value
        for prefix, cb in self._watchers:
            if key.startswith(prefix):
                await cb(key, value, False)

    async def delete(self, key):
        self.deletes.append(key)
        return self.kv.pop(key, None) is not None

    async def get_prefix(self, prefix):
        return sorted((k, v) for k, v in self.kv.items()
                      if k.startswith(prefix))

    async def watch_prefix(self, prefix, cb):
        self._watchers.append((prefix, cb))
        return await self.get_prefix(prefix)


class FakeDrt:
    def __init__(self, store):
        self.store, self._active, self.worker_id = store, {}, 0xBEEF
        self.drains = 0

    async def prepare_drain(self):
        self.drains += 1


class StubCfg:
    model = None

    def __init__(self, path):
        self.params_path = path


def _stub_engine(pkg, fail_reason=None):
    mob = _mod(pkg, "fleet.mobility")

    class StubEngine:
        core = None

        def __init__(self):
            self.swapped = []

        async def swap_weights(self, host, new_cfg):
            if fail_reason:
                raise mob.SwapError(fail_reason, "stub")
            self.swapped.append(new_cfg.params_path)
            return mob.SwapOutcome("swap", 0.01, new_cfg.params_path)

    return StubEngine()


async def _agent_run(pkg, scenario):
    mob = _mod(pkg, "fleet.mobility")
    store = FakeStore()
    drt = FakeDrt(store)
    events = {"reregister": [], "reload": []}
    engine = _stub_engine(pkg, "shape_mismatch"
                          if scenario in ("fallback", "no_reload") else None)

    async def reregister(payload):
        events["reregister"].append(payload)

    async def cold_reload(new_cfg):
        events["reload"].append(new_cfg.params_path)
        return _stub_engine(pkg)

    agent = mob.MobilityAgent(
        drt, NS, "backend-a", mob.EngineRef(engine), reregister=reregister,
        cold_reload=None if scenario == "no_reload" else cold_reload,
        cache=mob.WeightCache(capacity_bytes=8 * MB,
                              loader=lambda p, cfg: _tree(1.0)),
        model_name="a", cfg_builder=lambda model, path: StubCfg(path))
    await agent.start()
    if scenario == "prefetch":
        await store.put(mob.mobility_prefetch_key(NS, "backend-a"),
                        json.dumps({"models": [
                            {"model": "b", "model_path": "/ckpt/b"},
                            {"model": "c", "model_path": "/ckpt/c"}]}
                        ).encode())
        for _ in range(200):
            if "/ckpt/b" in agent.cache and "/ckpt/c" in agent.cache:
                break
            await asyncio.sleep(0.01)
    else:
        await store.put(mob.mobility_swap_key(NS, "backend-a"),
                        json.dumps({"model": "b", "component": "backend-b",
                                    "model_path": "/ckpt/b",
                                    "from": "a"}).encode())
        await asyncio.gather(*agent._tasks)
    wake = store.kv.get(mob.mobility_wake_key(NS, "b"))
    wake = json.loads(wake) if wake else None
    if wake:
        assert wake.pop("seconds") >= 0 and wake.pop("at") > 0
    out = dict(drains=drt.drains, events=events, deletes=store.deletes,
               component=agent.component, model=agent.model_name,
               wake=wake, swapped=getattr(engine, "swapped", None),
               cached=sorted(agent.cache.paths()),
               rebound=agent.engine_ref.engine is not engine)
    agent.cache.close()
    return out


@pytest.mark.parametrize("scenario",
                         ["swap", "fallback", "no_reload", "prefetch"])
async def test_agents_claim_fall_back_and_prefetch_like_jax(scenario):
    want = await _agent_run(J, scenario)
    got = await _agent_run(T, scenario)
    assert got == want
    if scenario == "swap":
        assert got["swapped"] == ["/ckpt/b"] and got["drains"] == 1
        assert got["wake"] == {"path": "swap", "worker": "beef"}
        assert got["component"] == "backend-b"
        assert got["deletes"] == [mobility_swap_key(NS, "backend-a")]
    elif scenario == "fallback":
        assert got["events"]["reload"] == ["/ckpt/b"] and got["rebound"]
        assert got["wake"]["path"] == "cold"
    elif scenario == "no_reload":
        assert got["component"] == "backend-a" and got["wake"] is None
    else:
        assert got["cached"] == ["/ckpt/b", "/ckpt/c"]


@pytest.mark.parametrize("where", ["before_drain", "after_drain"])
async def test_agent_ends_the_worker_only_for_a_failure_past_the_drain(
        where):
    """A failure before the drain leaves the worker serving its model; one
    after it (here the reload's engine build) leaves nothing to serve, so
    the agent calls ``on_fatal`` (the JAX agent logs and lives on)."""
    from dynamo_tpu_torch.utils.prometheus import stage_metrics

    mob = _mod(T, "fleet.mobility")
    store = FakeStore()
    drt = FakeDrt(store)
    fatal, reregistered = [], []

    def cfg_builder(model, path):
        if where == "before_drain":
            raise OSError("no such checkpoint")
        return StubCfg(path)

    async def reregister(payload):
        reregistered.append(payload)

    async def cold_reload(new_cfg):
        raise RuntimeError("CUDA out of memory")

    agent = mob.MobilityAgent(
        drt, NS, "backend-a",
        mob.EngineRef(_stub_engine(T, "shape_mismatch")),
        reregister=reregister, cold_reload=cold_reload,
        cache=mob.WeightCache(capacity_bytes=8 * MB,
                              loader=lambda p, cfg: _tree(1.0)),
        model_name="a", cfg_builder=cfg_builder,
        on_fatal=lambda: fatal.append(agent.component))
    await agent.start()
    errors = stage_metrics().model_swaps.get("error")
    await store.put(mob.mobility_swap_key(NS, "backend-a"),
                    json.dumps({"model": "b", "component": "backend-b",
                                "model_path": "/ckpt/b"}).encode())
    await asyncio.gather(*agent._tasks)
    agent.cache.close()
    assert stage_metrics().model_swaps.get("error") == errors + 1
    assert reregistered == [] and agent.component == "backend-a"
    assert store.kv.get(mob.mobility_wake_key(NS, "b")) is None
    if where == "before_drain":
        assert (drt.drains, fatal) == (0, [])
    else:
        assert (drt.drains, fatal) == (1, ["backend-a"])


class FakeProc:
    pid = 0

    def __init__(self):
        self.signals = []

    def poll(self):
        return None

    def wait(self):
        return 0

    def send_signal(self, sig):
        self.signals.append(sig)


@dataclasses.dataclass
class Dec:
    current: int
    swap_out: int = 0


async def _connector_run(pkg):
    conns = _mod(pkg, "planner.connectors")
    c = conns.LocalConnector(
        "127.0.0.1:0", NS, {"a": conns.PoolSpec(component="backend-a"),
                            "b": conns.PoolSpec(component="backend-b")},
        boot_grace=60.0)
    spawned = []
    c._spawn = lambda pool, spec: spawned.append(pool)
    store = FakeStore()
    payload = {"model": "b", "model_path": "/ckpt/b"}
    issued = [await c.swap_pool(store, NS, "a", "backend-a", payload),
              await c.swap_pool(store, NS, "a", "backend-a", payload)]
    old, new = (conns._Owned(FakeProc(), None, "/dev/null", t)
                for t in (10.0, 20.0))
    c.owned["a"] = [old, new]
    c.note_swap("a", "b")
    moved = (c.owned["a"] == [new], old in c.owned["b"])
    await c.apply("a", 1, Dec(current=2, swap_out=1))   # no SIGTERM
    await c.apply("b", 1, Dec(current=0))               # no spawn
    await c.apply("b", 1, Dec(current=1))               # marker spent
    await c.apply("b", 2, Dec(current=1))               # spawns
    stale = c._live_swaps("b")
    c.boot_grace = 0.0
    c.note_swap("a", "b")
    await c.apply("b", 1, Dec(current=0))               # aged out: spawn
    return (issued, moved, old.proc.signals + new.proc.signals, spawned,
            stale, sorted(store.kv))


async def test_connector_swap_accounting_equals_jax():
    got, want = await _connector_run(T), await _connector_run(J)
    assert got == want
    issued, moved, signals, spawned, stale, keys = got
    assert issued == [1, 0] and moved == (True, True) and signals == []
    assert spawned == ["b", "b"] and stale == 0
    assert keys == [mobility_swap_key(NS, "backend-a")]


# ---------------------------------------------------------------------------
# a port worker swapping in place on command, behind the frontend
# ---------------------------------------------------------------------------
def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps(body).encode(),
        headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


async def _until(pred, timeout=30.0, msg=""):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        await asyncio.sleep(0.05)
    raise AssertionError(f"timed out: {msg}")


async def _client_tokens(drt, component, prompt, n):
    from dynamo_tpu_torch.runtime.engine import Context

    client = drt.namespace("dynamo").component(component).endpoint(
        "generate").client()
    await client.start()
    await client.wait_for_instances(1, timeout=10)
    toks = []
    async for out in client.generate(BackendInput(
            token_ids=list(prompt),
            stop=StopConditions(max_tokens=n)).to_dict(),
            Context(deadline=time.time() + 30)):
        toks.extend(out.get("token_ids") or [])
    return toks


async def test_worker_swaps_in_place_and_answers_the_parked_request(
        ckpts, monkeypatch):
    from dynamo_tpu_torch.cli import http, worker
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.fleet.registry import (FleetModelSpec,
                                                 put_fleet_model)
    from dynamo_tpu_torch.planner.connectors import LocalConnector
    from dynamo_tpu_torch.runtime.component import DistributedRuntime
    from dynamo_tpu_torch.runtime.store_server import PyStoreServer
    from dynamo_tpu_torch.utils.prometheus import stage_metrics

    path_a, path_b = ckpts
    monkeypatch.setenv("DYN_BOOT_WAIT", "30")
    monkeypatch.setenv("DYNAMO_TPU_DATAPLANE", "python")
    extra = json.dumps({"max_batch": 4, "max_context": 128,
                        "prefill_chunk": 32})

    def worker_args(path, name):
        return worker.parse_args([
            "--engine", "torch", "--device", "cpu", "--namespace",
            "dynamo", "--component", f"backend-{name}", "--model-path",
            path, "--model-name", name, "--register-model",
            "--kv-block-size", "8", "--extra-engine-args", extra,
            "--metrics-interval", "0.2"])

    # B's cold engine on the worker's own config path (card -> config)
    args_b = worker_args(path_b, "b")
    want = _greedy(EngineCore(worker._engine_cfg(
        args_b, worker._build_card(args_b))), "cold", PROMPT, n=6)

    srv = PyStoreServer()
    sport = await srv.start()
    args = worker_args(path_a, "a")
    args.store = f"127.0.0.1:{sport}"
    svc, wtask = None, None
    try:
        ctl = await DistributedRuntime(store_port=sport).connect()
        for name, path in (("a", path_a), ("b", path_b)):
            await put_fleet_model(ctl.store, "dynamo", FleetModelSpec(
                name=name, engine="torch", model_path=path,
                swap_group="tiny", min_replicas=0))
        engine = await asyncio.to_thread(
            TorchEngine, worker._engine_cfg(args, worker._build_card(args)))
        leaves = engine.core.params["layers"]
        ptrs = {k: v.data_ptr() for k, v in leaves.items()}
        ready = asyncio.Event()
        wdrt = await DistributedRuntime(store_port=sport).connect()
        wtask = asyncio.create_task(worker.run_worker(
            args, drt=wdrt, engine=engine, ready_event=ready))
        await asyncio.wait_for(ready.wait(), 30)
        wid = wdrt.worker_id
        svc = await http.run_http(http.parse_args(
            ["--store", args.store, "--port", "0", "--host", "127.0.0.1",
             "--namespace", "dynamo"]))
        await _until(lambda: svc.manager.get("a") is not None,
                     msg="model a discovered")
        body = {"prompt": "hello", "max_tokens": 6, "temperature": 0}
        out = await asyncio.to_thread(_post, svc.port, dict(body, model="a"))
        assert out["usage"]["completion_tokens"] == 6
        got_a = await _client_tokens(ctl, "backend-a", PROMPT, 6)
        assert got_a != want

        # a request for b parks at the frontend (registered, no replica)
        swaps = stage_metrics().model_swaps
        before = {o: swaps.get(o) for o in ("swap", "reload")}
        parked = asyncio.create_task(asyncio.to_thread(
            _post, svc.port, dict(body, model="b")))
        await asyncio.sleep(0.5)
        assert not parked.done()
        # the planner's swap command, through the connector's write path
        conn = LocalConnector(args.store, "dynamo", {}, platform="cpu")
        assert await conn.swap_pool(ctl.store, "dynamo", "a", "backend-a", {
            "model": "b", "component": "backend-b", "model_path": path_b,
            "from": "a", "issued_at": time.time()}) == 1
        out = await asyncio.wait_for(parked, 60)
        assert out["model"] == "b"
        assert out["usage"]["completion_tokens"] == 6
        wake = json.loads(await ctl.store.get(mobility_wake_key(
            "dynamo", "b")))
        assert wake["path"] == "swap"
        assert swaps.get("swap") == before["swap"] + 1
        assert swaps.get("reload") == before["reload"]
        # the same worker, the same tensors, now serving b's greedy tokens
        assert args.component == "backend-b" and wdrt.worker_id != wid
        assert engine.core.cfg.params_path == path_b
        assert {k: v.data_ptr() for k, v in leaves.items()} == ptrs
        assert await _client_tokens(ctl, "backend-b", PROMPT, 6) == want
        rows = {r["id"] for r in json.loads(await asyncio.to_thread(
            lambda: urllib.request.urlopen(
                f"http://127.0.0.1:{svc.port}/v1/models",
                timeout=10).read()))["data"]}
        assert {"a", "b"} <= rows
        await ctl.close()
    finally:
        if svc is not None:
            await svc.stop()
        if wtask is not None:
            wtask.cancel()
            try:
                await wtask
            except (asyncio.CancelledError, Exception):
                pass
        await srv.stop()


async def test_worker_ends_when_its_swap_fails_after_the_drain(
        ckpts, monkeypatch):
    """The swap falls back to a cold reload whose engine build raises: the
    old engine is gone and the lease revoked, so the worker ends (a
    spawned process exits and its connector releases its cards) instead
    of living on as a zombie."""
    from dynamo_tpu_torch.cli import worker
    from dynamo_tpu_torch.engine import engine as tengine
    from dynamo_tpu_torch.runtime.component import DistributedRuntime
    from dynamo_tpu_torch.runtime.store_server import PyStoreServer
    from dynamo_tpu_torch.utils.prometheus import stage_metrics

    path_a, path_b = ckpts
    monkeypatch.setenv("DYNAMO_TPU_DATAPLANE", "python")
    srv = PyStoreServer()
    sport = await srv.start()
    args = worker.parse_args([
        "--engine", "torch", "--device", "cpu", "--namespace", "dynamo",
        "--component", "backend-a", "--model-path", path_a,
        "--model-name", "a", "--kv-block-size", "8",
        "--extra-engine-args", json.dumps({"max_batch": 2,
                                           "max_context": 64,
                                           "prefill_chunk": 32}),
        "--store", f"127.0.0.1:{sport}"])
    wtask = None
    try:
        engine = await asyncio.to_thread(tengine.TorchEngine,
                                         worker._engine_cfg(
                                             args, worker._build_card(args)))

        async def refuse(host, new_cfg):
            raise SwapError("shape_mismatch", "forced")

        def build_fails(cfg):
            raise RuntimeError("CUDA out of memory")

        engine.swap_weights = refuse
        monkeypatch.setattr(tengine, "TorchEngine", build_fails)
        ready = asyncio.Event()
        wdrt = await DistributedRuntime(store_port=sport).connect()
        wtask = asyncio.create_task(worker.run_worker(
            args, drt=wdrt, engine=engine, ready_event=ready))
        await asyncio.wait_for(ready.wait(), 30)
        swaps = stage_metrics().model_swaps
        before = {o: swaps.get(o)
                  for o in ("shape_mismatch", "reload", "error")}
        await wdrt.store.put(mobility_swap_key("dynamo", "backend-a"),
                             json.dumps({"model": "b",
                                         "component": "backend-b",
                                         "model_path": path_b}).encode())
        await asyncio.wait_for(wtask, 30)
        assert {o: swaps.get(o) - before[o] for o in before} == {
            "shape_mismatch": 1, "reload": 0, "error": 1}
        assert engine.core.params == {}       # its device memory released
        assert await wdrt.store.get(mobility_wake_key("dynamo", "b")) \
            is None
        await wdrt.close()
    finally:
        if wtask is not None and not wtask.done():
            wtask.cancel()
            try:
                await wtask
            except (asyncio.CancelledError, Exception):
                pass
        await srv.stop()
