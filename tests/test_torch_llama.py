"""The torch port's Llama model (``dynamo_tpu_torch.models.llama``) against
the JAX package's (``dynamo_tpu.models.llama``).

Same weights (the JAX random init, converted with ``params_from_jax``), same
inputs, float32 tiny presets: prefill ``forward`` (JAX ``attn_impl="flash"``,
the Pallas kernel in interpret mode; torch the flash wrapper's plain version)
and ``forward_decode`` (JAX ``"pallas"``; torch ``"paged"``). Logits and the
KV pages each side writes must agree to 1e-4 (f32, sums in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jl
from dynamo_tpu_torch.models import llama as tl

torch.set_num_threads(2)

TOL = 1e-4
CPU = torch.device("cpu")
# jitted: the interpret-mode Pallas kernels trace once per call otherwise
_jax_forward = jax.jit(jl.forward, static_argnames=("cfg", "attn_impl"))
_jax_decode = jax.jit(jl.forward_decode, static_argnames=("cfg", "attn_impl"))


def _fields(cfg):
    """Every config field by name, the dtype by its name."""
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    d = cfg.dtype
    out["dtype"] = (str(d).rsplit(".", 1)[-1] if isinstance(d, torch.dtype)
                    else jnp.dtype(d).name)
    return out


def test_presets_have_the_same_names():
    assert set(tl.PRESETS) == set(jl.PRESETS)


@pytest.mark.parametrize("name", sorted(jl.PRESETS))
def test_preset_fields_match(name):
    assert _fields(tl.preset(name)) == _fields(jl.preset(name))
    assert tl.preset(name).attn_scale == jl.preset(name).attn_scale
    L = jl.preset(name).num_layers
    assert ([tl.preset(name).layer_sliding(i) for i in range(L)]
            == [jl.preset(name).layer_sliding(i) for i in range(L)])


@pytest.mark.parametrize("hf", [
    {"architectures": ["LlamaForCausalLM"], "vocab_size": 128256,
     "hidden_size": 2048, "num_hidden_layers": 16,
     "num_attention_heads": 32, "num_key_value_heads": 8,
     "intermediate_size": 8192, "rope_theta": 500000.0,
     "rope_scaling": {"rope_type": "llama3", "factor": 32.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 8192},
     "tie_word_embeddings": True},
    {"architectures": ["Gemma2ForCausalLM"], "vocab_size": 256000,
     "hidden_size": 3584, "num_hidden_layers": 42, "head_dim": 256,
     "num_attention_heads": 16, "num_key_value_heads": 8,
     "intermediate_size": 14336, "attn_logit_softcapping": 50.0,
     "final_logit_softcapping": 30.0, "sliding_window": 4096,
     "query_pre_attn_scalar": 256},
])
def test_from_hf_config_and_rope_match(hf):
    t = tl.LlamaConfig.from_hf_config(hf)
    j = jl.LlamaConfig.from_hf_config(hf)
    assert _fields(t) == _fields(j)
    np.testing.assert_array_equal(tl._rope_inv_freq(t), jl._rope_inv_freq(j))


def _both_params(name):
    jcfg = jl.preset(name, dtype=jnp.float32)
    tcfg = tl.preset(name, dtype=torch.float32)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(3))
    np_tree = jax.tree.map(lambda a: np.array(a), jp)
    tp = tl.params_from_jax(np_tree, tcfg, CPU)
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("name", ["tiny-byte", "tiny-qwen", "tiny-gemma2"])
def test_forward_and_decode_match_jax(name):
    jcfg, tcfg, jp, tp = _both_params(name)
    page, n_pages = 8, 6
    L, Hkv, Dh = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim
    rng = np.random.default_rng(0)
    # lane 0: a 12-token prompt on pages 1-2; lane 1: 5 tokens on page 3,
    # its chunk padded (writes go to scratch page 0, nothing valid to read)
    T, S = 12, 16
    tokens = np.zeros((2, T), np.int32)
    tokens[0] = rng.integers(0, 256, T)
    tokens[1, :5] = rng.integers(0, 256, 5)
    positions = np.zeros((2, T), np.int32)
    positions[0] = np.arange(T)
    positions[1, :5] = np.arange(5)
    write_idx = np.zeros((2, T), np.int32)
    write_idx[0] = np.concatenate([8 + np.arange(8), 16 + np.arange(4)])
    write_idx[1, :5] = 24 + np.arange(5)
    read_idx = np.zeros((2, S), np.int32)
    read_idx[0, :T] = write_idx[0]
    read_idx[1, :5] = write_idx[1, :5]
    read_pos = np.zeros((2, S), np.int32)
    read_pos[0, :T] = np.arange(T)
    read_pos[1, :5] = np.arange(5)
    read_valid = np.zeros((2, S), bool)
    read_valid[0, :T] = True
    read_valid[1, :5] = True
    last_i = np.asarray([T - 1, 4], np.int32)
    pool_shape = (L, Hkv, n_pages, page, Dh)

    jk = jnp.zeros(pool_shape, jnp.float32)
    jv = jnp.zeros(pool_shape, jnp.float32)
    jlog, jk, jv = _jax_forward(
        jp, jcfg, jnp.asarray(tokens), jnp.asarray(positions), jk, jv,
        jnp.asarray(write_idx), jnp.asarray(read_idx), jnp.asarray(read_pos),
        jnp.asarray(read_valid), attn_impl="flash",
        logits_idx=jnp.asarray(last_i))
    tk = torch.zeros(pool_shape)
    tv = torch.zeros(pool_shape)
    tlog, _, _ = tl.forward(
        tp, tcfg, torch.from_numpy(tokens), torch.from_numpy(positions), tk,
        tv, torch.from_numpy(write_idx), torch.from_numpy(read_idx),
        torch.from_numpy(read_pos), torch.from_numpy(read_valid),
        attn_impl="flash", logits_idx=torch.from_numpy(last_i))
    assert tlog.shape == (2, 1, jcfg.vocab_size)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=TOL,
                               rtol=TOL)
    # page 0 is scratch: padded lanes' duplicate writes land there in an
    # implementation-defined order on both sides
    np.testing.assert_allclose(tk[:, :, 1:].numpy(), np.asarray(jk)[:, :, 1:],
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tv[:, :, 1:].numpy(), np.asarray(jv)[:, :, 1:],
                               atol=TOL, rtol=TOL)

    # one decode step for both lanes through their page tables
    page_tables = np.asarray([[1, 2], [3, 0]], np.int32)
    lengths = np.asarray([T + 1, 6], np.int32)
    nxt = np.asarray([65, 66], np.int32)
    jlog, jk, jv = _jax_decode(
        jp, jcfg, jnp.asarray(nxt), jk, jv, jnp.asarray(page_tables),
        jnp.asarray(lengths), attn_impl="pallas")
    tlog, _, _ = tl.forward_decode(
        tp, tcfg, torch.from_numpy(nxt), tk, tv,
        torch.from_numpy(page_tables), torch.from_numpy(lengths),
        attn_impl="paged")
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(tk[:, :, 1:].numpy(), np.asarray(jk)[:, :, 1:],
                               atol=TOL, rtol=TOL)
    # the dense torch paths agree with the kernel paths
    dlog, _, _ = tl.forward_decode(
        tp, tcfg, torch.from_numpy(nxt), tk.clone(), tv.clone(),
        torch.from_numpy(page_tables), torch.from_numpy(lengths),
        attn_impl="dense")
    np.testing.assert_allclose(dlog.numpy(), tlog.numpy(), atol=TOL,
                               rtol=TOL)


def test_params_from_jax_checks_shapes():
    jcfg, tcfg, jp, _ = _both_params("tiny-byte")
    np_tree = jax.tree.map(np.asarray, jp)
    np_tree["layers"]["wq"] = np_tree["layers"]["wq"][:, :, :2]
    with pytest.raises(ValueError, match="wq"):
        tl.params_from_jax(np_tree, tcfg, CPU)


def test_unported_paths_raise():
    cfg = tl.preset("tiny-byte", dtype=torch.float32)
    # MoE and VLM configs are served now; their checkpoints' expert
    # tensors are not (tests/test_torch_moe.py)
    with pytest.raises(NotImplementedError, match="missing in both"):
        from dynamo_tpu_torch.engine.loader import place_llama_params
        place_llama_params(tl.preset("tiny-moe"), lambda k: None, {})
    params = tl.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    z = torch.zeros((1, 1), dtype=torch.int32)
    pool = torch.zeros((2, 2, 2, 8, 16))
    with pytest.raises(NotImplementedError):
        tl.forward(params, cfg, z, z, pool, pool, z, z, z, z.bool(),
                   attn_impl="ring")
