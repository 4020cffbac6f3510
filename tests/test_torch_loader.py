"""The port's checkpoint path against ``safetensors``, ``transformers`` and
the JAX package.

- ``llm/safetensors_io``: the reader equals ``safetensors.numpy`` for
  BF16/F16/F32 and integer tensors; files the port writes (transposed views
  included) read back through ``safetensors``.
- ``engine/loader``: ``load_llama_params_host`` is bitwise equal to the JAX
  loader's tree (bf16 compared as ``uint16``) for llama (untied), qwen2
  (qkv bias, tied), gemma2 (sandwich norms) and gemma3 (q/k norms), from
  one shard and from several, under the VLM prefixes too; the port's own
  writer round-trips.
- ``llm/gguf``: every dequant routine equals the JAX one on random blocks;
  ``llama_config`` matches field by field (linear rope scaling and the
  ``rope_freqs`` factors included) and raises where the JAX one does;
  ``load_llama_params_gguf`` is bitwise equal to the JAX tree.
- ``ModelDeploymentCard.resolve``: the cases of the JAX package's test
  (``tests/test_loader_and_graft.py``), plus a repo id found in a local HF
  cache laid out as ``huggingface_hub`` lays it out.
- Forward parity: a tiny ``transformers`` ``LlamaForCausalLM`` saved with
  ``save_pretrained`` and loaded by the port gives HF's f32 logits within
  1e-4.
- Served parity: ``cli.run in=http out=torch --device cpu --model-path``
  on that directory, and on a GGUF of it with an embedded BPE vocab, gives
  the greedy completions of the JAX CLI's engine on the same files (f32).
- Import guard: in a subprocess that cannot import ``jax``, ``dynamo_tpu``,
  ``regex``, ``tokenizers``, ``transformers``, ``safetensors``,
  ``ml_dtypes``, ``huggingface_hub``, ``xxhash``, ``aiohttp``, ``msgpack``
  or ``PIL`` (all absent on the card's machine), every port module
  imports, the three tokenizer kinds tokenize, a safetensors directory and
  a GGUF file load, and a PNG data URL decodes and normalizes.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import threading
import urllib.request

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as st_load_numpy

from dynamo_tpu.engine import loader as jload
from dynamo_tpu.llm import gguf as jgguf
from dynamo_tpu.llm.model_card import ModelDeploymentCard as JCard
from dynamo_tpu.models import llama as jl
from dynamo_tpu_torch.engine import loader as tload
from dynamo_tpu_torch.engine.engine import TorchEngineConfig
from dynamo_tpu_torch.llm import gguf as tgguf
from dynamo_tpu_torch.llm import safetensors_io as sio
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard as TCard
from dynamo_tpu_torch.models import llama as tl

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
torch.set_num_threads(2)


def _bits(x) -> np.ndarray:
    """A leaf as comparable numpy: bf16 (either side) as its uint16 bits."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _assert_trees_equal(jtree, ttree):
    assert set(jtree) == set(ttree)
    assert set(jtree["layers"]) == set(ttree["layers"])
    pairs = [(k, jtree[k], ttree[k]) for k in jtree if k != "layers"]
    pairs += [(f"layers.{k}", jtree["layers"][k], ttree["layers"][k])
              for k in jtree["layers"]]
    for name, a, b in pairs:
        a, b = _bits(a), _bits(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name


# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------

def test_safetensors_reader_and_writer_match_the_library(tmp_path):
    from safetensors.torch import save_file as st_save_torch

    rng = np.random.default_rng(0)
    tensors = {
        "bf16": torch.from_numpy(rng.standard_normal((5, 7), np.float32)
                                 ).to(torch.bfloat16),
        "f16": torch.from_numpy(rng.standard_normal(9, np.float32)).half(),
        "f32": torch.from_numpy(rng.standard_normal((2, 3, 4), np.float32)),
        "i64": torch.arange(6, dtype=torch.int64),
        "i32": torch.arange(4, dtype=torch.int32).reshape(2, 2),
        "u8": torch.arange(3, dtype=torch.uint8),
    }
    ref_path = str(tmp_path / "ref.safetensors")
    st_save_torch(tensors, ref_path, metadata={"format": "pt"})
    f = sio.SafetensorsFile(ref_path)
    ref = st_load_numpy(ref_path)
    assert sorted(f.keys()) == sorted(ref)
    with open(ref_path, "rb") as fh:
        for k, t in tensors.items():
            assert np.array_equal(f.get_numpy(k), _bits(ref[k])), k
            assert torch.equal(f.get_tensor(k), t), k
            # the loader's path: the bytes read straight from the file
            raw = f.raw(k)
            buf = torch.empty(raw.numel() * raw.element_size(),
                              dtype=torch.uint8)
            raw.read(fh, 0, buf)
            assert torch.equal(buf.view(raw.dtype).view(raw.shape), t), k
    # the port's writer: transposed views keep their transpose
    ours = str(tmp_path / "ours.safetensors")
    written = dict(tensors, bf16_t=tensors["bf16"].T,
                   np_t=np.arange(12, dtype=np.float32).reshape(3, 4).T)
    sio.save_file(written, ours, metadata={"format": "pt"})
    back = st_load_numpy(ours)
    for k, v in written.items():
        want = _bits(v if isinstance(v, np.ndarray) else v.contiguous())
        assert np.array_equal(_bits(back[k]), want), k


# ---------------------------------------------------------------------------
# the loader against the JAX loader
# ---------------------------------------------------------------------------

FAMILIES = {
    "llama-untied": ("tiny-byte", dict(tie_embeddings=False)),
    "qwen2-bias-tied": ("tiny-qwen", {}),
    "gemma2-sandwich": ("tiny-gemma2", {}),
    "gemma3-qk-norm": ("tiny-byte", dict(sandwich_norms=True, qk_norm=True,
                                         tie_embeddings=False)),
}


def _jax_checkpoint(tmp_path, family):
    """A checkpoint written by the JAX package's writer (f32) from a seeded
    numpy tree of the family's shapes."""
    preset, kw = FAMILIES[family]
    jc, tc = jl.preset(preset, **kw), tl.preset(preset, **kw)
    rng = np.random.default_rng(3)
    shapes = tl.param_shapes(tc)
    params = {k: rng.standard_normal(v, np.float32) for k, v in
              shapes.items() if k != "layers"}
    params["layers"] = {k: rng.standard_normal(v, np.float32)
                        for k, v in shapes["layers"].items()}
    d = str(tmp_path / family)
    jload.save_llama_params(d, params, jc)
    return jc, tc, params, d


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_host_tree_is_bitwise_the_jax_tree(tmp_path, family):
    jc, tc, _, d = _jax_checkpoint(tmp_path, family)
    jtree = jload.load_llama_params_host(d, jc)
    _assert_trees_equal(jtree, tload.load_llama_params_host(d, tc))
    # the port's writer, split by layer, reads back to the same tree
    d2 = str(tmp_path / "resaved")
    tload.save_llama_params(d2, tload.load_llama_params_host(d, tc), tc,
                            shards=2)
    assert len(list(pathlib.Path(d2).glob("*.safetensors"))) == 2
    _assert_trees_equal(jtree, tload.load_llama_params(d2, tc, device="cpu"))


@pytest.mark.parametrize("prefix,head", [
    ("language_model.model.", "language_model.lm_head.weight"),
    ("model.language_model.", "lm_head.weight")])
def test_vlm_prefixes_map_like_the_jax_loader(tmp_path, prefix, head):
    jc, tc, _, d = _jax_checkpoint(tmp_path, "llama-untied")
    src = st_load_numpy(os.path.join(d, "model.safetensors"))
    renamed = {}
    for k, v in src.items():
        if k == "lm_head.weight":
            renamed[head] = v
        else:
            renamed[prefix + k[len("model."):]] = v
    vd = tmp_path / "vlm"
    vd.mkdir()
    half = sorted(renamed)[: len(renamed) // 2]     # two shards
    sio.save_file({k: renamed[k] for k in half}, str(vd / "a.safetensors"))
    sio.save_file({k: v for k, v in renamed.items() if k not in half},
                  str(vd / "b.safetensors"))
    _assert_trees_equal(jload.load_llama_params_host(str(vd), jc),
                        tload.load_llama_params_host(str(vd), tc))


def test_loader_refuses_mismatched_and_moe_checkpoints(tmp_path):
    _, tc, _, d = _jax_checkpoint(tmp_path, "llama-untied")
    with pytest.raises(ValueError, match="wq"):
        tload.load_llama_params_host(d, dataclasses.replace(tc, head_dim=8))
    moe = tmp_path / "moe"
    moe.mkdir()
    sio.save_file({"model.layers.0.block_sparse_moe.gate.weight":
                   np.zeros((2, 2), np.float32)}, str(moe / "m.safetensors"))
    with pytest.raises(NotImplementedError, match="MoE"):
        tload.load_llama_params_host(str(moe), tc)


# ---------------------------------------------------------------------------
# GGUF
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["q8_0", "q4_0", "q5_0", "q5_1", "q4_k",
                                  "q5_k", "q6_k"])
def test_dequant_matches_jax(name):
    jfn, tfn = getattr(jgguf, f"_dequant_{name}"), getattr(
        tgguf, f"_dequant_{name}")
    per = 256 if name.endswith("_k") else 32
    ggml = getattr(tgguf, f"_GGML_{name.upper()}")
    nbytes = (tgguf._KQUANT_BYTES[ggml] if name.endswith("_k")
              else tgguf._QBLOCK_FMT[ggml][0])
    rng = np.random.default_rng(len(name))
    raw = bytearray(rng.integers(0, 256, nbytes * 6, dtype=np.uint8))
    # finite f16 scales: clear the exponent's top bit of every half
    for i in range(1, len(raw), 2):
        raw[i] &= 0x3F
    raw = bytes(raw)
    a, b = jfn(raw, per * 6), tfn(memoryview(raw), per * 6)
    assert np.array_equal(a, b)


def _gguf_meta(cfg, **extra):
    return {"general.architecture": "llama",
            "llama.embedding_length": cfg.hidden_size,
            "llama.block_count": cfg.num_layers,
            "llama.attention.head_count": cfg.num_heads,
            "llama.attention.head_count_kv": cfg.num_kv_heads,
            "llama.attention.key_length": cfg.head_dim,
            "llama.feed_forward_length": cfg.intermediate_size,
            "llama.rope.freq_base": float(cfg.rope_theta),
            "llama.context_length": cfg.max_position,
            "llama.vocab_size": cfg.vocab_size, **extra}


def _gguf_tensors(hf: dict, L: int) -> dict:
    """HF-layout tensors under GGUF names (both are [out, in] in numpy)."""
    out = {"token_embd.weight": hf["model.embed_tokens.weight"],
           "output_norm.weight": hf["model.norm.weight"]}
    if "lm_head.weight" in hf:
        out["output.weight"] = hf["lm_head.weight"]
    names = {"input_layernorm": "attn_norm",
             "post_attention_layernorm": "ffn_norm",
             "self_attn.q_proj": "attn_q", "self_attn.k_proj": "attn_k",
             "self_attn.v_proj": "attn_v", "self_attn.o_proj": "attn_output",
             "mlp.gate_proj": "ffn_gate", "mlp.up_proj": "ffn_up",
             "mlp.down_proj": "ffn_down"}
    for i in range(L):
        for hn, gn in names.items():
            for kind in ("weight", "bias"):
                k = f"model.layers.{i}.{hn}.{kind}"
                if k in hf:
                    out[f"blk.{i}.{gn}.{kind}"] = hf[k]
    return out


def _fields(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d.pop("dtype")
    return d


@pytest.mark.parametrize("family", ["llama-untied", "qwen2-bias-tied"])
def test_gguf_config_and_tree_match_jax(tmp_path, family):
    jc, tc, _, d = _jax_checkpoint(tmp_path, family)
    hf = st_load_numpy(os.path.join(d, "model.safetensors"))
    path = str(tmp_path / "m.gguf")
    rope = np.linspace(1.0, 4.0, tc.head_dim // 2).astype(np.float32)
    tgguf.write_gguf(path, _gguf_meta(tc, **{
        "llama.rope.scaling.type": "linear",
        "llama.rope.scaling.factor": 2.0}),
        {**_gguf_tensors(hf, tc.num_layers), "rope_freqs.weight": rope})
    jg, tg = jgguf.read_gguf(path), tgguf.read_gguf(path)
    assert jg.metadata == tg.metadata
    jcfg, tcfg = jg.llama_config(), tg.llama_config()
    assert _fields(tcfg) == _fields(jcfg)
    assert tcfg.rope_scaling["rope_type"] == "ggml_factors"
    jg.close()
    tg.close()
    _, jtree = jgguf.load_llama_params_gguf(path, cfg=jcfg)
    tcfg2, ttree = tgguf.load_llama_params_gguf(path)
    assert _fields(tcfg2) == _fields(jcfg)
    _assert_trees_equal(jax.tree.map(np.asarray, jtree), ttree)
    # the engine sizes a GGUF card from its metadata
    ecfg = TorchEngineConfig.from_card(TCard.resolve(path), device="cpu")
    assert _fields(ecfg.model) == _fields(jcfg)
    assert ecfg.params_path == path


@pytest.mark.parametrize("extra,tensor,match", [
    ({"llama.rope.scaling.type": "yarn"}, None, "yarn"),
    ({}, "rope_factors_long.weight", "longrope"),
])
def test_gguf_config_hard_errors_match_jax(tmp_path, extra, tensor, match):
    cfg = tl.preset("tiny-byte")
    tensors = {"token_embd.weight": np.zeros((4, 4), np.float32)}
    if tensor:
        tensors[tensor] = np.ones(8, np.float32)
    path = str(tmp_path / "bad.gguf")
    tgguf.write_gguf(path, _gguf_meta(cfg, **extra), tensors)
    for mod in (jgguf, tgguf):
        with pytest.raises(NotImplementedError, match=match):
            mod.read_gguf(path).llama_config()


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

def test_card_resolve_paths_match_jax(tmp_path, monkeypatch):
    """The JAX package's resolve cases, on both cards."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    d = tmp_path / "model"
    d.mkdir()
    for Card in (JCard, TCard):
        assert Card.resolve(str(d), "m").path == str(d)
    cfg = tl.preset("tiny-byte", tie_embeddings=False, max_position=777)
    tensors = {"token_embd.weight": np.zeros((cfg.vocab_size, 64),
                                             np.float32)}
    tgguf.write_gguf(str(tmp_path / "m.gguf"), _gguf_meta(cfg), tensors)
    tgguf.write_gguf(str(tmp_path / "m2.gguf"), _gguf_meta(cfg, **{
        "tokenizer.ggml.eos_token_id": 7,
        "tokenizer.ggml.bos_token_id": 5}), tensors)
    for Card in (JCard, TCard):
        g = Card.resolve(str(tmp_path / "m.gguf"))
        assert g.context_length == 777 and g.path.endswith("m.gguf")
        assert g.eos_token_ids == [257]     # the byte tokenizer's eos
        g2 = Card.resolve(str(tmp_path / "m2.gguf"))
        assert (g2.eos_token_ids, g2.bos_token_id) == ([7], 5)
        with pytest.raises(FileNotFoundError, match="local cache"):
            Card.resolve("no-such-org/no-such-model-xyz")
        with pytest.raises(FileNotFoundError, match="does not exist"):
            Card.resolve("/definitely/missing/path")


def test_card_resolve_finds_a_cached_repo(tmp_path, monkeypatch):
    repo = tmp_path / "hf" / "hub" / "models--org--tiny"
    snap = repo / "snapshots" / "abc123"
    snap.mkdir(parents=True)
    (repo / "refs").mkdir()
    (repo / "refs" / "main").write_text("abc123\n")
    (snap / "config.json").write_text(json.dumps(
        {"max_position_embeddings": 96}))
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    card = TCard.resolve("org/tiny")
    assert card.path == str(snap) and card.name == "tiny"
    assert card.context_length == 96
    (repo / "refs" / "main").write_text("gone\n")
    with pytest.raises(FileNotFoundError, match="local cache"):
        TCard.resolve("org/tiny")


# ---------------------------------------------------------------------------
# transformers checkpoints: forward parity, served parity
# ---------------------------------------------------------------------------

LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|"
                r"\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|"
                r"\s+(?!\S)|\s+")
TEMPLATE = ("{% for m in messages %}<|start|>{{ m['role'] }}\n"
            "{{ m['content'] }}<|eot|>{% endfor %}"
            "{% if add_generation_prompt %}<|start|>assistant\n{% endif %}")


def _train_tokenizer():
    from tokenizers import (Regex, Tokenizer, decoders, models,
                            pre_tokenizers, trainers)

    t = Tokenizer(models.BPE(ignore_merges=True))
    t.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(LLAMA3_SPLIT), behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    t.decoder = decoders.ByteLevel()
    text = ["the quick brown fox jumps over the lazy dog 1234 times",
            "a model served from a checkpoint, tokenized without tokenizers",
            "Once upon a time there was a port to the card."] * 40
    t.train_from_iterator(text, trainers.BpeTrainer(
        vocab_size=256 + 3 + 120, show_progress=False,
        special_tokens=["<|start|>", "<|eot|>", "<|end|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    return t


@pytest.fixture(scope="module")
def hf_checkpoint(tmp_path_factory):
    """A tiny random LlamaForCausalLM (f32) saved by transformers, with a
    trained tokenizer.json, generation and tokenizer configs; and a GGUF of
    the same weights with the same vocab embedded as a gpt2 BPE."""
    with pytest.MonkeyPatch.context() as mp:
        # transformers would import TensorFlow (seconds) only to skip it
        mp.setenv("USE_TF", "0")
        mp.setenv("USE_FLAX", "0")
        from transformers import LlamaConfig, LlamaForCausalLM

    root = tmp_path_factory.mktemp("ckpt")
    tok = _train_tokenizer()
    V = tok.get_vocab_size()
    torch.manual_seed(0)
    model = LlamaForCausalLM(LlamaConfig(
        vocab_size=V, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, rope_theta=10000.0,
        tie_word_embeddings=False, bos_token_id=0, eos_token_id=2))
    model.eval()
    d = root / "hf"
    model.save_pretrained(str(d), safe_serialization=True)
    tok.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"chat_template": TEMPLATE, "eos_token": "<|end|>"}))
    (d / "generation_config.json").write_text(json.dumps(
        {"eos_token_id": [2, 1], "bos_token_id": 0}))
    hf = st_load_numpy(str(next(d.glob("*.safetensors"))))
    spec = json.loads(tok.to_str())
    tokens = [None] * V
    for t, i in spec["model"]["vocab"].items():
        tokens[i] = t
    g = root / "gguf"
    g.mkdir()
    cfg = tl.LlamaConfig.from_hf_config(json.loads(
        (d / "config.json").read_text()))
    tgguf.write_gguf(str(g / "m.gguf"), _gguf_meta(cfg, **{
        "llama.attention.layer_norm_rms_epsilon": 1e-6,
        "tokenizer.ggml.model": "gpt2", "tokenizer.ggml.pre": "llama3",
        "tokenizer.ggml.tokens": tokens,
        "tokenizer.ggml.merges": [" ".join(m) for m in
                                  spec["model"]["merges"]],
        "tokenizer.ggml.token_type": [3 if t.startswith("<|") else 1
                                      for t in tokens],
        "tokenizer.ggml.eos_token_id": 2}),
        _gguf_tensors(hf, cfg.num_layers))
    return model, str(d), str(g / "m.gguf")


def test_forward_matches_transformers(hf_checkpoint):
    model, d, _ = hf_checkpoint
    card = TCard.resolve(d)
    cfg = tl.LlamaConfig.from_hf_config(card.model_config,
                                        dtype=torch.float32)
    params = tload.load_llama_params(d, cfg, device="cpu")
    ids = np.asarray([5, 17, 42, 99, 3, 250, 8, 77, 120, 64, 1, 9])
    T, page = len(ids), 8
    with torch.no_grad():
        ref = model(torch.from_numpy(ids)[None]).logits[0].numpy()
        pool = (cfg.num_layers, cfg.num_kv_heads, 4, page, cfg.head_dim)
        slots = torch.arange(page, page + T)[None]
        pos = torch.arange(T, dtype=torch.int32)[None]
        got, _, _ = tl.forward(params, cfg, torch.from_numpy(ids)[None], pos,
                               torch.zeros(pool), torch.zeros(pool), slots,
                               slots, pos, torch.ones((1, T), dtype=torch.bool))
    np.testing.assert_allclose(got[0].numpy(), ref, atol=1e-4, rtol=1e-4)


ENGINE = {"max_batch": 2, "max_context": 96, "page_size": 8,
          "prefill_chunk": 16, "decode_steps": 4}


class _Served:
    """One package's CLI model (``make_card``) behind its own HttpService,
    its engine built as that package's ``cli.run`` builds it, in f32."""

    def __init__(self, pkg: str, model_path: str):
        self.pkg = pkg
        root = "dynamo_tpu" if pkg == "jax" else "dynamo_tpu_torch"
        run = __import__(f"{root}.cli.run", fromlist=["x"])
        hs = __import__(f"{root}.llm.http_service", fromlist=["x"])
        argv = ["in=http", "out=jax" if pkg == "jax" else "out=torch",
                "--model-path", model_path, "--extra-engine-args",
                json.dumps(ENGINE)]
        if pkg == "torch":
            argv += ["--device", "cpu"]
        args = run.parse_args(argv)
        self.card = run.make_card(args)
        engines = run.make_engines(args, self.card)
        chat, comp = engines[0], engines[1]
        manager = hs.ModelManager()
        manager.add(hs.ServedModel(self.card, chat, comp))
        self.loop = asyncio.new_event_loop()
        self.svc = hs.HttpService(manager, host="127.0.0.1", port=0)
        self.port = self.loop.run_until_complete(self.svc.start())
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        self.core = engines[2] if len(engines) > 2 else None

    def post(self, path: str, body: dict) -> dict:
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.port}{path}",
            data=json.dumps(dict(body, model=self.card.name)).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200
            return json.loads(r.read())

    def close(self) -> None:
        asyncio.run_coroutine_threadsafe(self.svc.stop(), self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=30)
        self.loop.close()
        if self.core is not None:
            self.core.shutdown()


def _force_f32(monkeypatch):
    """Both packages size checkpoints in f32 (bf16 by default)."""
    for mod, gmod, dt in ((jl, jgguf, jnp.float32),
                          (tl, tgguf, torch.float32)):
        orig = mod.LlamaConfig.from_hf_config.__func__
        monkeypatch.setattr(mod.LlamaConfig, "from_hf_config", classmethod(
            lambda cls, c, dtype=None, _o=orig, _dt=dt: _o(cls, c, dtype=_dt)))
        orig_g = gmod.GGUFFile.llama_config
        monkeypatch.setattr(gmod.GGUFFile, "llama_config",
                            lambda self, _o=orig_g, _dt=dt: dataclasses.replace(
                                _o(self), dtype=_dt))


@pytest.mark.parametrize("which", ["dir", "gguf"])
def test_served_greedy_completions_match_jax_cli(hf_checkpoint, monkeypatch,
                                                 which):
    _, d, g = hf_checkpoint
    path = d if which == "dir" else g
    _force_f32(monkeypatch)
    reqs = [("/v1/completions", {"prompt": "the quick brown fox",
                                 "max_tokens": 12, "temperature": 0}),
            ("/v1/chat/completions", {
                "messages": [{"role": "user", "content": "Once upon a time"}],
                "max_tokens": 10, "temperature": 0})]
    out = {}
    for pkg in ("jax", "torch"):
        s = _Served(pkg, path)
        try:
            out[pkg] = [s.post(p, b) for p, b in reqs]
            if pkg == "torch":
                kind = ("gguf-bpe:" if which == "gguf" else "")
                assert s.card.tokenizer.startswith(kind or d)
                assert s.core.core.cfg.model.dtype == torch.float32
        finally:
            s.close()
    for j, t in zip(out["jax"], out["torch"]):
        assert t["usage"] == j["usage"]
        jc, tc = j["choices"][0], t["choices"][0]
        assert tc.get("text", tc.get("message")) == jc.get(
            "text", jc.get("message"))
        assert tc["finish_reason"] == jc["finish_reason"]


# ---------------------------------------------------------------------------
# import guard: what the card's machine lacks
# ---------------------------------------------------------------------------

BLOCKED = ("jax", "dynamo_tpu", "regex", "tokenizers", "transformers",
           "safetensors", "ml_dtypes", "huggingface_hub", "xxhash", "aiohttp",
           "msgpack", "PIL", "yaml")

GUARD = r'''
import importlib, importlib.abc, json, pkgutil, sys
BLOCKED = set(sys.argv[1].split(","))

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import dynamo_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(dynamo_tpu_torch.__path__,
                                              "dynamo_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
from dynamo_tpu_torch.llm.tokenizer import load_tokenizer
from dynamo_tpu_torch.engine.loader import load_llama_params_host
from dynamo_tpu_torch.llm.gguf import load_llama_params_gguf
from dynamo_tpu_torch.models import llama
d, gguf_bpe, gguf_sp = sys.argv[2:5]
ids = {k: load_tokenizer(k).encode("the quick brown fox")
       for k in (d, "gguf-bpe:" + gguf_bpe, "gguf-sp:" + gguf_sp)}
cfg = llama.LlamaConfig.from_hf_config(json.load(open(d + "/config.json")))
tree = load_llama_params_host(d, cfg)
_, gtree = load_llama_params_gguf(gguf_bpe, device="cpu")
import base64
import numpy as np
from dynamo_tpu_torch.llm import _png
from dynamo_tpu_torch.llm.preprocessor import _decode_data_url
from dynamo_tpu_torch.engine.multimodal import normalize_image
img = (np.arange(40 * 50 * 3) % 251).astype(np.uint8).reshape(40, 50, 3)
url = "data:image/png;base64," + base64.b64encode(_png.encode(img)).decode()
px = normalize_image(_decode_data_url(url), 56)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print(json.dumps({"modules": len(mods), "ids": ids, "leaked": leaked,
                  "wq": list(tree["layers"]["wq"].shape),
                  "gwq": list(gtree["layers"]["wq"].shape),
                  "px": list(px.shape)}))
'''


def test_port_runs_without_the_libraries_the_card_lacks(hf_checkpoint,
                                                        tmp_path):
    _, d, g = hf_checkpoint
    sp = str(tmp_path / "sp.gguf")
    pieces = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    pieces += ["▁the", "▁quick", "▁brown", "▁fox", "o", "x"]
    tgguf.write_gguf(sp, {
        "general.architecture": "llama", "tokenizer.ggml.model": "llama",
        "tokenizer.ggml.tokens": pieces,
        "tokenizer.ggml.scores": [0.0] * len(pieces),
        "tokenizer.ggml.token_type": [2, 3, 3] + [6] * 256 + [1] * 6},
        {"token_embd.weight": np.zeros((2, 2), np.float32)})
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run(
        [sys.executable, "-c", GUARD, ",".join(BLOCKED), d, g, sp],
        capture_output=True, text=True, timeout=120, cwd=str(ROOT), env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["leaked"] == [] and res["modules"] > 50
    assert res["ids"][f"gguf-sp:{sp}"] == [259, 260, 261, 262]
    assert res["ids"][d] == res["ids"][f"gguf-bpe:{g}"]
    assert res["wq"] == res["gwq"] == [2, 64, 4, 16]
    assert res["px"] == [3, 56, 56]          # an image request, no PIL


ENTRY_GUARD = r'''
import importlib.abc, json, runpy, sys
BLOCKED = set(sys.argv[1].split(","))

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
mod = sys.argv[2]
sys.argv = [mod, "--help"]
try:
    runpy.run_module(mod, run_name="__main__", alter_sys=True)
except SystemExit as e:
    code = e.code
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print(json.dumps({"code": code, "leaked": leaked}))
'''


@pytest.mark.parametrize("module", [
    "dynamo_tpu_torch.runtime.store_server", "dynamo_tpu_torch.cli.worker",
    "dynamo_tpu_torch.cli.router", "dynamo_tpu_torch.cli.http",
    "dynamo_tpu_torch.cli.prefill_worker", "dynamo_tpu_torch.cli.planner",
    "dynamo_tpu_torch.cli.plannerctl", "dynamo_tpu_torch.cli.serve",
    "dynamo_tpu_torch.cli.metrics", "dynamo_tpu_torch.cli.ctl",
    "dynamo_tpu_torch.cli.dyntop", "dynamo_tpu_torch.cli.tracectl",
    "dynamo_tpu_torch.cli.mock_worker", "dynamo_tpu_torch.sdk.serve_child"])
def test_fleet_entry_points_run_without_the_libraries_the_card_lacks(module):
    """Each process of the fleet starts in an interpreter that cannot import
    any of ``BLOCKED`` (``msgpack`` and ``aiohttp`` among them): the module
    imports and its argument parser answers ``--help``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run(
        [sys.executable, "-c", ENTRY_GUARD, ",".join(BLOCKED), module],
        capture_output=True, text=True, timeout=120, cwd=str(ROOT), env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res == {"code": 0, "leaked": []}
    assert "usage:" in r.stdout
