"""The torch port's Mixture-of-Experts FFN and MoE serving, held against
the JAX package.

- ``models/moe.py``: sorted and dense dispatch each against the JAX
  ``moe_ffn`` (which picks sorted at ``B*T >= 16``) at ``B*T`` = 4 and 32
  and at a 32-lane decode step, f32, within 1e-5; the port's policy picks
  JAX's dispatch, except that a one-token step stays dense.
- Greedy token streams of the port's engine on ``tiny-moe`` (f32, three
  concurrent prompts) equal the JAX engine's (``attn_impl="xla"``) with the
  same weights, carried across with ``params_from_jax``.
- MoE checkpoints stay refused, by the loader and by ``from_card``, with a
  message that says the expert tensor mapping is missing in both packages.

The JAX engine takes numpy-drawn weights (its own ``jax.random`` init
compiles one program per leaf shape, seconds on the CPU); its serving path
is untouched.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.engine import EngineCore as JaxCore, JaxEngineConfig
from dynamo_tpu.llm.protocols.common import (BackendInput as JBI,
                                             StopConditions as JSC)
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models import moe as jmoe
from dynamo_tpu_torch.engine import loader as tload
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.llm import safetensors_io as sio
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.protocols.common import (BackendInput,
                                                   StopConditions)
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models import moe as tmoe
from dynamo_tpu_torch.runtime.engine import Context

torch.set_num_threads(2)
CPU = torch.device("cpu")
ENGINE = dict(page_size=8, max_batch=4, max_context=128, prefill_chunk=32,
              decode_steps=4)
PROMPTS = {"a": list(range(3, 30)), "b": [5, 6, 7], "c": list(range(40, 60))}
MAX_TOKENS = 8


def np_weights(shapes, rng, ones=("ln1", "ln2", "final_norm")):
    """The JAX tree's leaves drawn with numpy, f32: normal / sqrt(leading
    dim) (the JAX init's scale), the pre-norms ones."""
    return {k: np_weights(v, rng, ones) if isinstance(v, dict) else (
        np.ones(v, np.float32) if k in ones else
        (rng.standard_normal(v) / np.sqrt(v[0])).astype(np.float32))
        for k, v in shapes.items()}


@pytest.mark.parametrize("tokens", [(1, 4), (2, 16), (32, 1)])
def test_moe_ffn_dispatches_match_jax(tokens):
    B, T = tokens
    D, E, F_, K = 24, 4, 40, 2
    rng = np.random.default_rng(B * T)
    # JAX sees the tokens as one row (the FFN is per token): a decode
    # batch of 32 lanes reuses the programs the 2 x 16 chunk compiled
    xj = rng.standard_normal((1, B * T, D)).astype(np.float32)
    x = xj.reshape(B, T, D)
    wr = rng.standard_normal((D, E)).astype(np.float32)
    wg, wu = (rng.standard_normal((E, D, F_)).astype(np.float32) / 5
              for _ in range(2))
    wd = rng.standard_normal((E, F_, D)).astype(np.float32) / 6
    want = np.asarray(jmoe.moe_ffn(*(jnp.asarray(a) for a in
                                     (xj, wr, wg, wu, wd)), K)).reshape(
        B, T, D)
    t = [torch.from_numpy(a) for a in (x, wr, wg, wu, wd)]
    vals, idx = tmoe.route_topk(t[0], t[1], K)
    jv, ji = jmoe.route_topk(jnp.asarray(xj), jnp.asarray(wr), K)
    np.testing.assert_array_equal(idx.numpy(),
                                  np.asarray(ji).reshape(B, T, K))
    np.testing.assert_allclose(vals.numpy(),
                               np.asarray(jv).reshape(B, T, K), atol=1e-6)
    sorted_ = tmoe._sorted_dispatch(t[0], *t[2:], vals, idx)
    dense = tmoe.expert_ffn(t[0], *t[2:], tmoe.dense_gates(vals, idx, E))
    tmoe.moe_ffn.dispatches.clear()
    policy = tmoe.moe_ffn(*t, K)
    for got in (sorted_, dense, policy):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    # the JAX policy, sorted from 16 tokens, except that a one-token step
    # (a decode batch, 32 lanes here) stays dense: no host read of the
    # expert counts inside a chained decode window
    kind = "sorted" if T > 1 and B * T >= 16 else "dense"
    assert dict(tmoe.moe_ffn.dispatches) == {kind: 1}
    np.testing.assert_array_equal(
        policy.numpy(), (sorted_ if kind == "sorted" else dense).numpy())


@pytest.fixture(scope="module")
def jax_moe():
    """Greedy streams of the JAX engine on tiny-moe (f32) and its weights
    as numpy."""
    jcfg = jl.preset("tiny-moe", dtype=jnp.float32)
    tree = np_weights(tl.param_shapes(tl.preset("tiny-moe")),
                      np.random.default_rng(0))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jl, "init_params", lambda cfg, key: tree)
        core = JaxCore(JaxEngineConfig(model=jcfg, attn_impl="xla",
                                       **ENGINE))
    for sid, toks in PROMPTS.items():
        core.submit(sid, JBI(token_ids=toks, stop=JSC(
            max_tokens=MAX_TOKENS, ignore_eos=True)))
    got = {sid: [] for sid in PROMPTS}
    while core.has_work:
        for so in core.step():
            assert so.error is None, so.error
            got[so.seq_id].append(so.token)
    return got, jax.tree.map(np.asarray, core.params)


async def _stream(engine, toks):
    out = []
    async for o in engine.generate(BackendInput(
            token_ids=toks, stop=StopConditions(max_tokens=MAX_TOKENS,
                                                ignore_eos=True)), Context()):
        out.extend(o.token_ids)
    return out


async def test_moe_greedy_streams_match_jax_engine(jax_moe):
    want, np_params = jax_moe
    cfg = TorchEngineConfig(model=tl.preset("tiny-moe", dtype=torch.float32),
                            device="cpu", **ENGINE)
    engine = TorchEngine(cfg, tl.params_from_jax(np_params, cfg.model, CPU))
    try:
        got = await asyncio.wait_for(asyncio.gather(
            *(_stream(engine, t) for t in PROMPTS.values())), 60)
    finally:
        engine.shutdown()
    assert dict(zip(PROMPTS, got)) == want
    assert all(len(v) == MAX_TOKENS for v in want.values())
    assert engine.core.pool.free_pages == engine.core.pool.num_pages - 1


def test_moe_init_draws_the_jax_tree():
    """init_params draws the JAX tree's MoE leaves: wr [L,D,E], wg/wu
    [L,E,D,F], wd [L,E,F,D], at the JAX init's scale."""
    cfg = tl.preset("tiny-moe", dtype=torch.float32)
    p = tl.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    jt = jax.eval_shape(lambda: jl.init_params(
        jl.preset("tiny-moe", dtype=jnp.float32), jax.random.PRNGKey(0)))
    shapes = jax.tree.map(lambda a: tuple(a.shape), jt)
    assert {k: tuple(v.shape) for k, v in p["layers"].items()} \
        == shapes["layers"]
    assert p["layers"]["wr"].shape == (2, 64, 4)
    # 1/sqrt(leading dim L=2): the JAX init's normal scale
    assert float(p["layers"]["wg"].std()) == pytest.approx(2 ** -0.5,
                                                           rel=0.05)


def test_moe_checkpoints_refused_naming_the_missing_mapping(tmp_path):
    moe = tmp_path / "moe"
    moe.mkdir()
    sio.save_file({"model.layers.0.block_sparse_moe.gate.weight":
                   np.zeros((2, 2), np.float32)}, str(moe / "m.safetensors"))
    tc = tl.preset("tiny-byte", dtype=torch.float32)
    with pytest.raises(NotImplementedError,
                       match="expert tensor mapping .* missing in both"):
        tload.load_llama_params_host(str(moe), tc)
    with pytest.raises(NotImplementedError, match="missing in both"):
        tload.place_llama_params(tl.preset("tiny-moe"), lambda k: None, {})
    card = ModelDeploymentCard.synthetic("m")
    card.model_config = {"architectures": ["MixtralForCausalLM"],
                         "num_local_experts": 8}
    with pytest.raises(NotImplementedError,
                       match="MoE checkpoint .*missing in both"):
        TorchEngineConfig.from_card(card)
    # a MoE preset is served (random or converted weights)
    cfg = TorchEngineConfig.from_card(ModelDeploymentCard.synthetic("m"),
                                      preset="tiny-moe", device="cpu")
    assert cfg.model.num_experts == 4
    with pytest.raises(NotImplementedError, match="ep"):
        TorchEngineConfig.from_card(ModelDeploymentCard.synthetic("m"),
                                    preset="tiny-moe", ep=2)
