"""Tensor parallelism of the torch port, held against the JAX package.

- ``param_specs`` equal the JAX package's leaf for leaf (tied, kv
  replicated, and an untied vocab-sharded head).
- JAX parameters carried into a rank (``params_from_jax``, and a
  checkpoint through the loader's shard placement) concatenate back to
  the whole tree bit for bit.
- Two ranks' ``forward`` logits equal JAX ``llama.forward`` within 1e-4.
- Two ranks serving through the dispatch plane (a leader ``EngineCore``
  and a follower replaying its frames, each a thread with its own gloo
  group) stream the greedy ids of the JAX ``EngineCore`` at tp=1 and tp=2
  on the virtual mesh, for a tied head and for a vocab-sharded head.
- Dispatch frames round-trip through the JAX package's codec both ways.
- ``cli.worker --tp 2 --device cpu`` serves one endpoint with two rank
  processes; SIGKILL on its follower makes the leader exit 13.
- What tp > 1 refuses (MoE, straddling GQA groups, other axes) raises,
  naming its ROADMAP item; the KV block manager, disaggregation and
  speculative decoding at tp=2 are ``tests/test_torch_parallel_kv.py``'s,
  KV paging, image models and weight swaps
  ``tests/test_torch_parallel_lanes.py``'s.
"""

import asyncio
import datetime
import functools
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from dynamo_tpu.engine.engine import EngineCore as JaxCore, JaxEngineConfig
from dynamo_tpu.models import llama as jl
from dynamo_tpu_torch.engine.engine import EngineCore, TorchEngineConfig
from dynamo_tpu_torch.llm.protocols.common import (BackendInput,
                                                   FinishReason,
                                                   StopConditions)
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.parallel import multihost as mh
from dynamo_tpu_torch.parallel.mesh import ServingMesh, serving_mesh

torch.set_num_threads(2)

CPU = torch.device("cpu")
TOL = 1e-4
MODELS = {
    "tiny-byte": {},
    # Hkv=1 < tp: k/v replicated in the specs, each rank keeps head 0
    "tiny-gemma": {},
    # untied head, vocab 260 % 2 == 0: the head shards over the vocab
    "untied-260": dict(vocab_size=260, tie_embeddings=False),
}
ENGINE = dict(page_size=8, max_batch=2, max_context=64, prefill_chunk=32,
              decode_steps=1)
PROMPT, TOKENS = [10, 20, 30, 40], 5
_jax_forward = jax.jit(jl.forward, static_argnames=("cfg", "attn_impl"))


def _preset(mod, name, dtype):
    base = "tiny-byte" if name == "untied-260" else name
    return mod.preset(base, dtype=dtype, **MODELS[name])


@functools.lru_cache(maxsize=None)
def _jax_tree(name, seed=3):
    jcfg = _preset(jl, name, jnp.float32)
    return jcfg, jax.tree.map(np.array,
                              jl.init_params(jcfg, jax.random.PRNGKey(seed)))


def _leaves(tree):
    for n, v in tree.items():
        if n == "layers":
            for m, w in v.items():
                yield f"layers.{m}", w
        else:
            yield n, v


def _run_ranks(fn, tp=2, timeout=60):
    """``fn(rank, group)`` on ``tp`` threads, each rank with its own gloo
    group over one in-memory store; returns the results by rank."""
    store = dist.HashStore()
    out, errs = {}, []

    def one(r):
        try:
            pg = dist.ProcessGroupGloo(
                dist.PrefixStore("tp", store), r, tp,
                datetime.timedelta(seconds=timeout))
            out[r] = fn(r, pg)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errs.append(e)

    threads = [threading.Thread(target=one, args=(r,), daemon=True)
               for r in range(tp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout + 30)
    if errs:
        raise errs[0]
    assert len(out) == tp, "a rank hung"
    return out


# ---------------------------------------------------------------------------
# sharding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MODELS))
def test_param_specs_match_jax_leaf_for_leaf(name):
    jcfg, tcfg = _preset(jl, name, jnp.float32), _preset(tl, name,
                                                         torch.float32)
    want = dict(_leaves(jax.tree.map(
        tuple, jl.param_specs(jcfg, 2),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))))
    got = dict(_leaves(tl.param_specs(tcfg, 2)))
    assert got == want
    if name == "untied-260":
        assert got["lm_head"] == (None, "tp")
    if name == "tiny-gemma":
        assert got["layers.wk"] == (None, None, None, None)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_jax_params_shard_and_concatenate_back(name, tmp_path):
    from dynamo_tpu_torch.engine.loader import (load_llama_params,
                                                save_llama_params)

    jcfg, np_tree = _jax_tree(name)
    tcfg = _preset(tl, name, torch.float32)
    shards = [tl.params_from_jax(np_tree, tcfg, CPU, tp=2, rank=r)
              for r in range(2)]
    save_llama_params(str(tmp_path), np_tree, tcfg)
    specs = dict(_leaves(tl.param_specs(tcfg, 2)))
    for r in range(2):
        # the loader places the same shard straight from the checkpoint
        loaded = dict(_leaves(load_llama_params(str(tmp_path), tcfg, CPU,
                                                tp=2, rank=r)))
        for n, t in _leaves(shards[r]):
            assert torch.equal(loaded[n], t), n
    parts = [dict(_leaves(s)) for s in shards]
    for n, whole in _leaves(np_tree):
        spec = specs[n]
        if "tp" in spec:
            back = torch.cat([p[n] for p in parts], dim=spec.index("tp"))
        else:
            # replicated: every rank holds the whole leaf (tiny-gemma's one
            # kv head is the head both ranks' queries read)
            assert torch.equal(parts[0][n], parts[1][n]), n
            back = parts[0][n]
        assert torch.equal(back, torch.from_numpy(whole)), n


def test_gguf_checkpoint_places_each_ranks_shard(tmp_path):
    """The GGUF loader cuts rank shards as the safetensors one does (an
    F32 GGUF of the untied, vocab-sharded model)."""
    from dynamo_tpu_torch.engine.loader import save_llama_params
    from dynamo_tpu_torch.llm import gguf
    from dynamo_tpu_torch.llm.safetensors_io import ShardSet

    _, np_tree = _jax_tree("untied-260")
    cfg = _preset(tl, "untied-260", torch.float32)
    save_llama_params(str(tmp_path), np_tree, cfg)
    hf = ShardSet(str(tmp_path))
    mods = {"input_layernorm": "attn_norm",
            "post_attention_layernorm": "ffn_norm",
            "self_attn.q_proj": "attn_q", "self_attn.k_proj": "attn_k",
            "self_attn.v_proj": "attn_v", "self_attn.o_proj": "attn_output",
            "mlp.gate_proj": "ffn_gate", "mlp.up_proj": "ffn_up",
            "mlp.down_proj": "ffn_down"}
    tensors = {"token_embd.weight": "model.embed_tokens.weight",
               "output_norm.weight": "model.norm.weight",
               "output.weight": "lm_head.weight"}
    for i in range(cfg.num_layers):
        for h, g in mods.items():
            tensors[f"blk.{i}.{g}.weight"] = f"model.layers.{i}.{h}.weight"
    tensors = {g: hf.get_tensor(h).numpy() for g, h in tensors.items()}
    hf.close()
    path = str(tmp_path / "m.gguf")
    gguf.write_gguf(path, {
        "general.architecture": "llama",
        "llama.embedding_length": cfg.hidden_size,
        "llama.block_count": cfg.num_layers,
        "llama.attention.head_count": cfg.num_heads,
        "llama.attention.head_count_kv": cfg.num_kv_heads,
        "llama.attention.key_length": cfg.head_dim,
        "llama.feed_forward_length": cfg.intermediate_size,
        "llama.rope.freq_base": float(cfg.rope_theta),
        "llama.context_length": cfg.max_position,
        "llama.vocab_size": cfg.vocab_size}, tensors)
    for r in range(2):
        _, got = gguf.load_llama_params_gguf(path, cfg=cfg, device=CPU,
                                             dtype=torch.float32, tp=2,
                                             rank=r)
        got = dict(_leaves(got))
        for n, want in _leaves(tl.params_from_jax(np_tree, cfg, CPU, tp=2,
                                                  rank=r)):
            assert torch.equal(got[n], want), n


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", sorted(MODELS) + ["tiny-qwen"])
def test_each_ranks_seeded_init_is_its_cut_of_the_tp1_weights(name, dtype):
    """A rank draws the tp=1 weights from the same seed and keeps its cut,
    bit for bit, so seeded token ids do not depend on tp."""
    cfg = (tl.preset(name, dtype=dtype) if name == "tiny-qwen"
           else _preset(tl, name, dtype))
    whole = tl.init_params(cfg, torch.Generator().manual_seed(7), CPU)
    for r in range(2):
        got = dict(_leaves(tl.init_params(
            cfg, torch.Generator().manual_seed(7), CPU, 2, r)))
        for n, want in _leaves(tl.shard_params(whole, cfg, 2, r)):
            assert got[n].dtype == want.dtype and torch.equal(got[n], want), n


@pytest.mark.parametrize("name", sorted(MODELS))
def test_two_rank_forward_matches_jax(name):
    jcfg, np_tree = _jax_tree(name)
    tcfg = _preset(tl, name, torch.float32)
    page, n_pages, T = 8, 4, 12
    L, Dh = jcfg.num_layers, jcfg.head_dim
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 256, (2, T)).astype(np.int32)
    positions = np.tile(np.arange(T, dtype=np.int32), (2, 1))
    write_idx = np.stack([8 + np.arange(T), 20 + np.arange(T)]).astype(
        np.int32)
    valid = np.ones((2, T), bool)
    jk = jnp.zeros((L, jcfg.num_kv_heads, n_pages, page, Dh), jnp.float32)
    want, _, _ = _jax_forward(
        jax.tree.map(jnp.asarray, np_tree), jcfg, jnp.asarray(tokens),
        jnp.asarray(positions), jk, jk, jnp.asarray(write_idx),
        jnp.asarray(write_idx), jnp.asarray(positions), jnp.asarray(valid),
        attn_impl="xla")

    def rank(r, group):
        params = tl.params_from_jax(np_tree, tcfg, CPU, tp=2, rank=r)
        shape = (L, tl.local_kv_heads(tcfg, 2), n_pages, page, Dh)
        logits, _, _ = tl.forward(
            params, tcfg, torch.from_numpy(tokens),
            torch.from_numpy(positions), torch.zeros(shape),
            torch.zeros(shape), torch.from_numpy(write_idx),
            torch.from_numpy(write_idx), torch.from_numpy(positions),
            torch.from_numpy(valid), attn_impl="flash", group=group)
        return logits

    got = _run_ranks(rank)
    # the reduced logits are the same bytes on both ranks
    assert torch.equal(got[0], got[1])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_replicated_kv_heads_follow_each_ranks_queries():
    """Hq=8, Hkv=2 at tp=4: k/v replicate in the specs, and each rank's
    two query heads read one kv head (0 for ranks 0-1, 1 for ranks 2-3).
    Four ranks' logits equal JAX ``llama.forward``'s on one device (its
    plain path: the JAX package's per-shard flash at this layout pairs a
    shard's second query head with kv head 1, ROADMAP Queue 3)."""
    jcfg = jl.preset("tiny-byte", dtype=jnp.float32, num_heads=8,
                     num_kv_heads=2, hidden_size=128)
    tcfg = tl.preset("tiny-byte", dtype=torch.float32, num_heads=8,
                     num_kv_heads=2, hidden_size=128)
    np_tree = jax.tree.map(lambda t: t.numpy(), tl.init_params(
        tcfg, torch.Generator().manual_seed(5), CPU))
    assert [list(tl.kv_head_range(tcfg, 4, r)) for r in range(4)] == [
        [0], [0], [1], [1]]
    T, page = 8, 8
    tokens = (np.arange(T, dtype=np.int32) + 5)[None]
    pos = np.arange(T, dtype=np.int32)[None]
    w = pos + 8
    valid = np.ones((1, T), bool)
    pool = jnp.zeros((2, 2, 3, page, 16), jnp.float32)
    want, _, _ = _jax_forward(jax.tree.map(jnp.asarray, np_tree), jcfg,
                              jnp.asarray(tokens), jnp.asarray(pos), pool,
                              pool, jnp.asarray(w), jnp.asarray(w),
                              jnp.asarray(pos), jnp.asarray(valid),
                              attn_impl="xla")

    def rank(r, group):
        params = tl.params_from_jax(np_tree, tcfg, CPU, tp=4, rank=r)
        shape = (2, 1, 3, page, 16)
        logits, _, _ = tl.forward(
            params, tcfg, torch.from_numpy(tokens), torch.from_numpy(pos),
            torch.zeros(shape), torch.zeros(shape), torch.from_numpy(w),
            torch.from_numpy(w), torch.from_numpy(pos),
            torch.from_numpy(valid), attn_impl="flash", group=group)
        return logits

    got = _run_ranks(rank, tp=4)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


# ---------------------------------------------------------------------------
# the dispatch plane: a leader and a follower against the JAX engine
# ---------------------------------------------------------------------------

def _jax_ids(name, tp):
    core = JaxCore(JaxEngineConfig(model=_preset(jl, name, jnp.float32),
                                   tp=tp, **ENGINE), jax.devices()[:tp])
    core.submit("x", BackendInput(token_ids=PROMPT,
                                  stop=StopConditions(max_tokens=TOKENS)))
    ids = []
    for _ in range(100):
        for so in core.step():
            ids.append(so.token)
        if len(ids) >= TOKENS:
            break
    return ids, jax.tree.map(np.array, core.params)


@pytest.fixture(scope="module")
def jax_greedy():
    """(name, tp) -> (JAX EngineCore greedy ids, its params), the four
    engines built at once: their compiles dominate this file's time."""
    runs = {(n, tp): None for n in ("tiny-byte", "untied-260")
            for tp in (1, 2)}

    def run(key):
        runs[key] = _jax_ids(*key)

    threads = [threading.Thread(target=run, args=(k,)) for k in runs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert all(v is not None for v in runs.values())
    return runs


def _serve_pair(tcfg, np_params, lost):
    """A leader and a follower EngineCore (threads, a gloo group each) on
    the dispatch plane over localhost: the leader's greedy ids, its core
    and the follower's."""
    port = mh.free_port()
    ready = threading.Event()

    def rank(r, group):
        mesh = serving_mesh(2, rank=r, device="cpu", group=group)
        cfg = TorchEngineConfig(model=tcfg, device="cpu", tp=2, mesh=mesh,
                                **ENGINE)
        if r == 0:
            pub = mh.DispatchPublisher(port, 1, host="127.0.0.1",
                                       on_lost=lambda: lost.append(1))
            ready.set()
        core = EngineCore(cfg, tl.params_from_jax(np_params, tcfg, CPU,
                                                  tp=2, rank=r))
        if r == 1:
            ready.wait(30)
            loop = mh.FollowerLoop(core, "127.0.0.1", port,
                                   connect_timeout=30)
            loop.run()
            return core, loop.frames
        try:
            pub.wait_for_followers(30)
            core.dispatch_hook = pub.hook
            core.submit("x", BackendInput(token_ids=PROMPT,
                                          stop=StopConditions(
                                              max_tokens=TOKENS)))
            ids = []
            with torch.no_grad():
                for _ in range(100):
                    ids += [so.token for so in core.step()]
                    if not core.has_work:
                        break
                stats = core.refresh_rank_stats()
        finally:
            pub.close()      # the follower's loop ends either way
        return core, ids, stats, pub.frames

    return _run_ranks(rank)


@pytest.mark.parametrize("name", ["tiny-byte", "untied-260"])
def test_tp2_greedy_ids_over_the_dispatch_plane_match_jax(name, jax_greedy):
    want1, np_params = jax_greedy[name, 1]
    want2, _ = jax_greedy[name, 2]
    lost = []
    got = _serve_pair(_preset(tl, name, torch.float32), np_params, lost)
    leader, ids, stats, frames = got[0]
    follower, replayed = got[1]
    assert ids == want1 == want2
    assert not lost
    # the follower replayed every program frame (the shutdown aside) and
    # ran the same dispatches and kernel wrappers as the leader
    assert replayed == frames - 1
    assert (follower.prefill_dispatches, follower.decode_steps_run) == (
        leader.prefill_dispatches, leader.decode_steps_run)
    assert [s["prefill_dispatches"] for s in stats] == [
        leader.prefill_dispatches] * 2
    # each rank holds its shard: the vocab-sharded head halves
    if name == "untied-260":
        assert leader.params["lm_head"].shape == (64, 130)
    assert leader.k_pool.shape[1] == 1 and leader.enable_prefix_reuse
    # the gauges price the whole model's blocks, as JAX's global arrays do
    tcfg = leader.cfg.model
    assert leader.utilization()["kv_capacity_bytes"] == (
        leader.pool.num_pages - 1) * tl.kv_block_bytes(tcfg, ENGINE[
            "page_size"])
    assert tl.kv_block_bytes(tcfg, 8) == 2 * tcfg.num_layers * 2 * 8 * 16 * 4


def test_frames_round_trip_through_the_jax_codec():
    import msgpack

    from dynamo_tpu.parallel import multihost as jmh
    from dynamo_tpu.runtime.wire import pack as jax_pack

    arrs = {"tokens": np.arange(12, dtype=np.int64).reshape(3, 4),
            "read_valid": np.array([[True, False]]),
            "temp": np.zeros(3, np.float32), "empty": np.zeros((0, 2),
                                                               np.int32)}
    meta = {"Bp": 3, "C": 4, "S": 16, "seeds": [], "last_lanes": [0, 2],
            "mm": False}
    frame = mh.pack_frame("prefill", meta, arrs)
    assert frame == jax_pack(["prefill", meta, jmh._pack_arrays(arrs)])
    kind, m, packed = msgpack.unpackb(frame[4:], raw=False)
    back = jmh._unpack_arrays(packed)
    assert (kind, m) == ("prefill", meta)
    for k, a in arrs.items():
        assert back[k].dtype == a.dtype and np.array_equal(back[k], a)
    # and the JAX leader's frame through the port's follower side
    a, b = socket.socketpair()
    try:
        a.sendall(jax_pack(["decode", {"S": 8, "chain": True},
                            jmh._pack_arrays(arrs)]))
        kind, m, packed = mh._recv_frame(b)
    finally:
        a.close()
        b.close()
    mine = mh._unpack_arrays(packed)
    assert (kind, m) == ("decode", {"S": 8, "chain": True})
    for k, a in arrs.items():
        assert mine[k].dtype == a.dtype and np.array_equal(mine[k], a)
        assert mine[k].flags.writeable


# ---------------------------------------------------------------------------
# cli.worker --tp 2: one endpoint, two rank processes, the slice's failure
# ---------------------------------------------------------------------------

def _children(pid):
    kids = []
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    if int(f.read().rsplit(")", 1)[1].split()[1]) == pid:
                        kids.append(int(d))
            except (OSError, ValueError, IndexError):
                pass
    return kids


@pytest.fixture(scope="module", autouse=True)
def tp_worker(tmp_path_factory):
    """A store and ``cli.worker --tp 2 --device cpu`` (the leader, which
    starts its follower), launched with the module so that their bring-up
    overlaps the tests before the one that uses them."""
    log_path = tmp_path_factory.mktemp("tp_worker") / "worker.log"
    log = open(log_path, "w")
    port = mh.free_port()
    env = dict(os.environ, DYNAMO_TPU_DATAPLANE="python",
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))))
    store = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.runtime.store_server",
         "--host", "127.0.0.1", "--port", str(port), "--impl", "python"],
        env=env, stdout=log, stderr=subprocess.STDOUT)
    leader = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.cli.worker", "--tp", "2",
         "--device", "cpu", "--store", f"127.0.0.1:{port}",
         "--advertise-host", "127.0.0.1",
         "--extra-engine-args", json.dumps(dict(preset="tiny-byte",
                                                **ENGINE))],
        env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        yield dict(port=port, leader=leader, log=log_path)
    finally:
        followers = _children(leader.pid)
        for p in (leader, store):
            if p.poll() is None:
                p.kill()
            p.wait()
        for pid in followers:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        log.close()


async def test_cli_worker_tp2_serves_one_endpoint_and_dies_with_its_follower(
        tp_worker):
    from dynamo_tpu_torch.runtime.component import DistributedRuntime

    leader = tp_worker["leader"]
    deadline = time.monotonic() + 60
    drt = None
    while drt is None:
        try:
            drt = await DistributedRuntime(
                store_port=tp_worker["port"]).connect()
        except OSError:
            assert time.monotonic() < deadline, "no store within 60 s"
            await asyncio.sleep(0.2)
    try:
        client = await drt.namespace("dynamo").component("backend") \
            .endpoint("generate").client().start()
        while not client.instances:
            assert leader.poll() is None, tp_worker["log"].read_text()
            assert time.monotonic() < deadline, "no instance within 60 s"
            await asyncio.sleep(0.2)
        # exactly one endpoint: the leader's (the follower is silent)
        assert len(client.instances) == 1
        followers = _children(leader.pid)
        assert len(followers) == 1
        bi = BackendInput(token_ids=PROMPT, stop=StopConditions(
            max_tokens=6, ignore_eos=True))
        ids = []
        async for item in client.generate(bi.to_dict()):
            ids += item.get("token_ids") or []
        assert len(ids) == 6 and all(0 <= t < 259 for t in ids)
        # the follower's death ends the leader: exit 13, within seconds
        os.kill(followers[0], signal.SIGKILL)
        t0 = time.monotonic()
        rc = await asyncio.to_thread(leader.wait, 30)
        assert rc == mh.FOLLOWER_LOST_EXIT and time.monotonic() - t0 < 10
    finally:
        await drt.close()


# ---------------------------------------------------------------------------
# what tp > 1 refuses
# ---------------------------------------------------------------------------

def _mesh_stub():
    # the refusals come before any collective: a mesh with no group
    return ServingMesh(shape={"tp": 2}, rank=0, local_rank=0, device=CPU,
                       groups={"tp": None})


def test_model_and_layout_refusals():
    with pytest.raises(NotImplementedError, match="item 11b"):
        EngineCore(TorchEngineConfig(model=tl.preset("tiny-moe"),
                                     device="cpu", tp=2, mesh=_mesh_stub()))
    # a rank's query heads straddling two GQA groups has no kernel layout
    with pytest.raises(ValueError, match="straddle"):
        tl.kv_head_range(tl.preset("tiny-byte", num_heads=6, num_kv_heads=3),
                         2, 0)
    with pytest.raises(NotImplementedError, match="item 11b"):
        serving_mesh(2, pp=2, device="cpu")
    with pytest.raises(NotImplementedError, match="single-controller"):
        EngineCore(TorchEngineConfig(model=tl.preset("tiny-byte"),
                                     device="cpu", tp=2))


def test_worker_flags_refuse_what_tp_does_not_mirror(monkeypatch):
    from dynamo_tpu_torch.cli import worker

    a = worker.parse_args(["--tp", "2", "--device", "cpu"])
    layout = worker.RankLayout.of(a)
    assert (layout.tp, layout.dist_backend, layout.local_ranks) == (
        2, "gloo", 2)
    worker.check_ported(a)
    # disaggregation and cluster KV sharing serve at tp > 1
    worker.check_ported(worker.parse_args(
        ["--tp", "2", "--device", "cpu", "--enable-disagg"]))
    monkeypatch.setenv("DYN_KV_CLUSTER", "1")
    worker.check_ported(a)
    monkeypatch.delenv("DYN_KV_CLUSTER")
    with pytest.raises(NotImplementedError, match="item 11b"):
        worker.check_ported(worker.parse_args(
            ["--tp", "3", "--num-nodes", "2", "--device", "cpu"]))
    worker.check_ported(worker.parse_args(
        ["--tp", "4", "--num-nodes", "2", "--device", "cpu"]))
    # two ranks on one card need gloo: NCCL refuses a duplicate GPU
    with pytest.raises(SystemExit):
        worker.parse_args(["--tp", "2", "--devices", "0,0"])
    assert worker.parse_args(["--tp", "2", "--devices", "0,0",
                              "--dist-backend", "gloo"]).devices == "0,0"


def test_each_rank_makes_its_card_the_current_device(monkeypatch):
    """A rank's mesh device becomes the process's current CUDA device
    (what the allocator's cache or an event's record acts on), and NCCL
    binds its communicator to that card; gloo takes no device id."""
    current, inits = [], []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: inits.append(kw))
    mesh = serving_mesh(1, rank=0, local_rank=1, device="cuda")
    assert current == [mesh.device] == [torch.device("cuda", 1)]
    mh.init_distributed("127.0.0.1:1", 2, 1, "nccl", device=mesh.device)
    mh.init_distributed("127.0.0.1:1", 2, 1, "gloo",
                        device=torch.device("cuda", 0))
    assert current[1:] == [torch.device("cuda", 1), torch.device("cuda", 0)]
    assert inits[0]["device_id"] == torch.device("cuda", 1)
    assert "device_id" not in inits[1]


async def test_a_leader_step_ends_the_worker_only_once_a_frame_went_out(
        monkeypatch):
    """At tp > 1 a step that fails before it sent its followers a frame
    (here in the prefill's host plan) errors its batch and the engine goes
    on, as at tp=1; one that fails after the frame went out (in the device
    program) ends the process (exit 13): the followers may wait in a
    collective the leader will not run again."""
    from dynamo_tpu_torch.engine import engine as eng
    from dynamo_tpu_torch.runtime.engine import Context

    exits, frames, fault = [], [], []
    monkeypatch.setattr(eng.os, "_exit", exits.append)
    engine = eng.TorchEngine(TorchEngineConfig(
        model=tl.preset("tiny-byte", dtype=torch.float32), device="cpu",
        **ENGINE))
    core = engine.core
    plan, program = core.pool.write_slots, core._run_prefill_program

    def failing(where, fn):
        def call(*a, **kw):
            if fault == [where]:
                raise RuntimeError(f"injected fault in the {where}")
            return fn(*a, **kw)
        return call

    async def one():
        outs = []
        async for o in engine.generate(BackendInput(
                token_ids=PROMPT, stop=StopConditions(max_tokens=3)),
                Context()):
            outs.append(o)
        return outs

    # the leader's policy alone: a failing step needs no follower
    monkeypatch.setattr(core, "refresh_rank_stats", lambda: [])
    monkeypatch.setattr(core.pool, "write_slots", failing("plan", plan))
    monkeypatch.setattr(core, "_run_prefill_program",
                        failing("program", program))
    core.tp = 2
    core.dispatch_hook = lambda kind, meta, arrs: frames.append(kind)
    try:
        fault.append("plan")
        outs = await asyncio.wait_for(one(), 30)
        assert outs[-1].finish_reason == FinishReason.ERROR
        assert "in the plan" in outs[-1].error
        assert (exits, frames) == ([], [])
        fault[:] = ["program"]
        await asyncio.wait_for(one(), 30)
        assert (exits, frames) == ([mh.FOLLOWER_LOST_EXIT], ["prefill"])
    finally:
        core.tp, core.dispatch_hook = 1, None
        engine.shutdown()
