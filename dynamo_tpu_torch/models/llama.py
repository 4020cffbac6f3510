"""Llama model family (Llama 2/3/3.x, Qwen2, Mistral, Gemma 1/2/3 text) in
PyTorch, built for paged-KV serving.

The parameter tree matches the JAX package's (``dynamo_tpu.models.llama``)
name for name and shape for shape: a plain dict of stacked per-layer weights
(``params["layers"]["wq"]`` is [L, D, Hq, Dh], ...), so a checkpoint or a
random init maps between the two one to one (:func:`params_from_jax`).

The KV cache is a head-major paged pool ([L, Hkv, n_pages, page, Dh]); page
0 is the scratch page that padded lanes write to. Unlike JAX's functional
``.at[].set``, the forwards write new K/V into the pool in place.

Prefill attention runs :func:`~dynamo_tpu_torch.ops.attention.
flash_attention` over the gathered context (``attn_impl="flash"``); decode
reads the pool through page tables with :func:`~dynamo_tpu_torch.ops.
attention.paged_attention` (``attn_impl="paged"``). ``attn_impl="dense"``
is the plain masked-softmax path of :func:`attend`; Gemma3 VLM image
chunks take it, with their soft tokens as an embedding override and the
same-image bidirectional or-mask (the JAX package's ``xla`` path).

Mixture-of-Experts models (``num_experts > 0``, Mixtral) run their FFN
through :func:`~dynamo_tpu_torch.models.moe.moe_ffn`.

Tensor parallelism is Megatron's, one process a rank (:mod:`..parallel`):
:func:`param_specs` and :func:`tp_cuts` say how each leaf shards, each
rank holds its cut of the tree and a pool of its kv heads, and the
forwards take the tp group.

Reference capability equivalent: the in-engine model executed by vLLM/TRT-LLM
behind the reference's engine adapters (SURVEY §2.1, §7 step 3).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import to_device
from ..ops.attention import flash_attention, paged_attention
from ..parallel import collectives
from .moe import moe_ffn

# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

_GEMMA_ARCHS = ("GemmaForCausalLM", "Gemma2ForCausalLM",
                "Gemma3ForCausalLM")

_GEMMA_VLM_ARCH = "Gemma3ForConditionalGeneration"

# Gemma3TextConfig defaults (transformers): real hub checkpoints ship sparse
# text_configs that omit these and rely on the class defaults.
_GEMMA3_TEXT_DEFAULTS: Dict[str, Any] = {
    "vocab_size": 262208,
    "hidden_size": 2304,
    "intermediate_size": 9216,
    "num_hidden_layers": 26,
    "num_attention_heads": 8,
    "num_key_value_heads": 4,
    "head_dim": 256,
    "rope_theta": 1e6,
    "rope_local_base_freq": 10000.0,
    "query_pre_attn_scalar": 256,
    "max_position_embeddings": 131072,
    "rms_norm_eps": 1e-6,
    # omitting sliding_window must NOT read as "no sliding attention"
    "sliding_window": 4096,
    # the class default ties the head to the embedding (the hub's Gemma3
    # checkpoints ship no lm_head); the JAX package's table lacks this key
    # and maps them untied (ROADMAP Queue 3 item 10)
    "tie_word_embeddings": True,
}


def _is_gemma(cfg: Dict[str, Any]) -> bool:
    archs = cfg.get("architectures", []) or []
    unsupported = [a for a in archs
                   if "Gemma" in a and a not in _GEMMA_ARCHS
                   and a != _GEMMA_VLM_ARCH]
    if unsupported:
        raise ValueError(f"unsupported architecture {unsupported[0]!r} "
                         f"(text Gemma v1/v2/v3 and Gemma3 VLM are "
                         f"supported)")
    return any(a in _GEMMA_ARCHS for a in archs)


def _is_gemma2(cfg: Dict[str, Any]) -> bool:
    return "Gemma2ForCausalLM" in (cfg.get("architectures", []) or [])


def _is_gemma3(cfg: Dict[str, Any]) -> bool:
    return "Gemma3ForCausalLM" in (cfg.get("architectures", []) or [])


def _map_act(cfg: Dict[str, Any]) -> str:
    """HF activation name -> ours; exact vs tanh-approx GELU matters for
    logits parity, so unknown names raise instead of guessing."""
    if _is_gemma(cfg):
        return "gelu_tanh"
    act = str(cfg.get("hidden_activation")
              or cfg.get("hidden_act") or "silu")
    if act in ("silu", "swish"):
        return "silu"
    if act in ("gelu_pytorch_tanh", "gelu_tanh", "gelu_new",
               "gelu_fast"):
        return "gelu_tanh"
    if act == "gelu":
        return "gelu"
    raise ValueError(f"unsupported hidden_act {act!r}")


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    intermediate_size: int = 14336
    rope_theta: float = 500000.0
    rope_scaling: Optional[Dict[str, Any]] = None
    rms_eps: float = 1e-5
    max_position: int = 8192
    tie_embeddings: bool = False
    # q/k/v projection biases (Qwen2-style attention; Llama/Mistral: False)
    attention_bias: bool = False
    # Gemma-style family knobs: tanh-GELU gating (GeGLU), zero-centered
    # RMSNorm weights (output scales by 1+w), sqrt(D)-scaled embeddings
    hidden_act: str = "silu"            # "silu" | "gelu_tanh" | "gelu"
    norm_offset: bool = False
    embed_scale: bool = False
    # Gemma2-style knobs: sandwich norms, tanh softcapping of attention
    # scores / final logits, sliding-window attention, explicit attention
    # scale (rsqrt(query_pre_attn_scalar) instead of rsqrt(head_dim))
    sandwich_norms: bool = False
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    sliding_window: Optional[int] = None
    query_pre_attn_scalar: Optional[float] = None
    # Gemma3-style knobs: every Nth layer is FULL attention, the rest
    # sliding; sliding layers rope at their own base; per-head q/k RMSNorm
    sliding_pattern: int = 2
    rope_local_theta: Optional[float] = None
    qk_norm: bool = False
    dtype: torch.dtype = torch.bfloat16
    # MoE (0 experts = dense FFN; models/moe.py)
    num_experts: int = 0
    experts_per_token: int = 2
    # Gemma3 VLM vision tower (HF vision_config dict; models/siglip.py
    # builds from it). Image soft tokens replace ``image_token_id``
    # placeholder embeddings at prefill
    vision: Optional[Dict[str, Any]] = None
    mm_tokens_per_image: int = 256
    image_token_id: Optional[int] = None

    def layer_sliding(self, layer: int) -> bool:
        """Every ``sliding_pattern``-th layer is full attention, the rest
        sliding (gemma2: 2 — alternating; gemma3: 6 — five sliding then one
        full)."""
        return (self.sliding_window is not None
                and (layer + 1) % self.sliding_pattern != 0)

    @property
    def attn_scale(self) -> float:
        base = (self.query_pre_attn_scalar
                if self.query_pre_attn_scalar is not None else self.head_dim)
        return 1.0 / math.sqrt(base)

    @classmethod
    def from_hf_config(cls, cfg: Dict[str, Any],
                       dtype: torch.dtype = torch.bfloat16) -> "LlamaConfig":
        """Map a HF ``config.json`` (LlamaForCausalLM family) onto ours.
        Gemma3 VLM configs nest the text model under ``text_config``: the
        text half maps recursively; the vision tower and the mm wiring land
        on the vision fields."""
        if _GEMMA_VLM_ARCH in (cfg.get("architectures", []) or []):
            if "text_config" not in cfg or "vision_config" not in cfg:
                raise ValueError(
                    f"{_GEMMA_VLM_ARCH} config must nest text_config and "
                    f"vision_config; refusing to guess a flat layout")
            text = dict(cfg["text_config"])
            # the nested text config usually omits architectures: restore
            # the family marker so the gemma3 mapping rules fire
            text.setdefault("architectures", ["Gemma3ForCausalLM"])
            base = cls.from_hf_config(text, dtype=dtype)
            return cls(**{
                **base.__dict__,
                "vision": dict(cfg["vision_config"]),
                "mm_tokens_per_image": int(cfg.get("mm_tokens_per_image",
                                                   256)),
                # the hub config spells it image_token_index; newer
                # transformers re-exports *_id: accept both
                "image_token_id": int(
                    cfg.get("image_token_id",
                            cfg.get("image_token_index", 262144))),
            })
        if cfg.get("model_type") == "gemma3_text":
            cfg = {**_GEMMA3_TEXT_DEFAULTS, **cfg}
        return cls(
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            num_layers=cfg["num_hidden_layers"],
            num_heads=cfg["num_attention_heads"],
            num_kv_heads=cfg.get("num_key_value_heads",
                                 cfg["num_attention_heads"]),
            head_dim=cfg.get("head_dim",
                             cfg["hidden_size"] // cfg["num_attention_heads"]),
            intermediate_size=cfg["intermediate_size"],
            rope_theta=cfg.get("rope_theta", 10000.0),
            rope_scaling=cfg.get("rope_scaling"),
            rms_eps=cfg.get("rms_norm_eps", 1e-5),
            max_position=cfg.get("max_position_embeddings", 8192),
            tie_embeddings=cfg.get("tie_word_embeddings", False),
            attention_bias=bool(cfg.get(
                "attention_bias",
                any("Qwen2" in a for a in cfg.get("architectures", []) or []))),
            hidden_act=_map_act(cfg),
            norm_offset=_is_gemma(cfg),
            embed_scale=_is_gemma(cfg),
            sandwich_norms=_is_gemma2(cfg) or _is_gemma3(cfg),
            attn_logit_softcap=(cfg.get("attn_logit_softcapping")
                                if _is_gemma2(cfg) else None),
            final_logit_softcap=(cfg.get("final_logit_softcapping")
                                 if _is_gemma2(cfg) else None),
            sliding_window=(cfg.get("sliding_window")
                            if _is_gemma2(cfg) or _is_gemma3(cfg) else None),
            query_pre_attn_scalar=(cfg.get("query_pre_attn_scalar")
                                   if _is_gemma2(cfg) or _is_gemma3(cfg)
                                   else None),
            sliding_pattern=_sliding_pattern(cfg),
            rope_local_theta=(cfg.get("rope_local_base_freq", 10000.0)
                              if _is_gemma3(cfg) else None),
            qk_norm=_is_gemma3(cfg),
            dtype=dtype,
        )


def _sliding_pattern(cfg: Dict[str, Any]) -> int:
    """Period of the full-attention layers: from ``layer_types`` when the
    config carries it, else the family default (gemma2: 2, gemma3: 6)."""
    lt = cfg.get("layer_types")
    if lt:
        period = None
        for i, t in enumerate(lt):
            if t == "full_attention":
                period = i + 1
                break
        if period is None:
            return len(lt) + 1   # all sliding
        for i, t in enumerate(lt):
            want = ("full_attention" if (i + 1) % period == 0
                    else "sliding_attention")
            if t != want:
                raise ValueError(
                    f"layer_types is not periodic with full every "
                    f"{period} layers (index {i} is {t!r})")
        return period
    return 6 if _is_gemma3(cfg) else 2


# test/bench presets (shapes only; weights are random or loaded) — the same
# table as the JAX package's, so a preset names one model in both
PRESETS: Dict[str, Dict[str, Any]] = {
    "tiny-byte": dict(vocab_size=259, hidden_size=64, num_layers=2, num_heads=4,
                      num_kv_heads=2, head_dim=16, intermediate_size=128,
                      rope_theta=10000.0, max_position=1024),
    "tiny-moe": dict(vocab_size=259, hidden_size=64, num_layers=2, num_heads=4,
                     num_kv_heads=2, head_dim=16, intermediate_size=96,
                     rope_theta=10000.0, max_position=1024, num_experts=4,
                     experts_per_token=2),
    "llama-3.2-1b": dict(vocab_size=128256, hidden_size=2048, num_layers=16,
                         num_heads=32, num_kv_heads=8, head_dim=64,
                         intermediate_size=8192, rope_theta=500000.0,
                         max_position=131072, tie_embeddings=True),
    "llama-3-8b": dict(vocab_size=128256, hidden_size=4096, num_layers=32,
                       num_heads=32, num_kv_heads=8, head_dim=128,
                       intermediate_size=14336, rope_theta=500000.0,
                       max_position=8192),
    "llama-3-70b": dict(vocab_size=128256, hidden_size=8192, num_layers=80,
                        num_heads=64, num_kv_heads=8, head_dim=128,
                        intermediate_size=28672, rope_theta=500000.0,
                        max_position=8192),
    "tiny-qwen": dict(vocab_size=259, hidden_size=64, num_layers=2,
                      num_heads=4, num_kv_heads=2, head_dim=16,
                      intermediate_size=128, rope_theta=10000.0,
                      max_position=1024, attention_bias=True,
                      tie_embeddings=True),
    "qwen2-1.5b": dict(vocab_size=151936, hidden_size=1536, num_layers=28,
                       num_heads=12, num_kv_heads=2, head_dim=128,
                       intermediate_size=8960, rope_theta=1000000.0,
                       max_position=32768, attention_bias=True,
                       tie_embeddings=True, rms_eps=1e-6),
    "qwen2-7b": dict(vocab_size=152064, hidden_size=3584, num_layers=28,
                     num_heads=28, num_kv_heads=4, head_dim=128,
                     intermediate_size=18944, rope_theta=1000000.0,
                     max_position=32768, attention_bias=True, rms_eps=1e-6),
    "mistral-7b": dict(vocab_size=32000, hidden_size=4096, num_layers=32,
                       num_heads=32, num_kv_heads=8, head_dim=128,
                       intermediate_size=14336, rope_theta=10000.0,
                       max_position=32768, rms_eps=1e-5),
    "tiny-gemma": dict(vocab_size=259, hidden_size=64, num_layers=2,
                       num_heads=4, num_kv_heads=1, head_dim=16,
                       intermediate_size=128, rope_theta=10000.0,
                       max_position=1024, tie_embeddings=True,
                       hidden_act="gelu_tanh", norm_offset=True,
                       embed_scale=True, rms_eps=1e-6),
    "tiny-gemma2": dict(vocab_size=259, hidden_size=64, num_layers=2,
                        num_heads=4, num_kv_heads=1, head_dim=16,
                        intermediate_size=128, rope_theta=10000.0,
                        max_position=1024, tie_embeddings=True,
                        hidden_act="gelu_tanh", norm_offset=True,
                        embed_scale=True, rms_eps=1e-6,
                        sandwich_norms=True, attn_logit_softcap=50.0,
                        final_logit_softcap=30.0, sliding_window=8,
                        query_pre_attn_scalar=24.0),
    "gemma2-9b": dict(vocab_size=256000, hidden_size=3584, num_layers=42,
                      num_heads=16, num_kv_heads=8, head_dim=256,
                      intermediate_size=14336, rope_theta=10000.0,
                      max_position=8192, tie_embeddings=True,
                      hidden_act="gelu_tanh", norm_offset=True,
                      embed_scale=True, rms_eps=1e-6,
                      sandwich_norms=True, attn_logit_softcap=50.0,
                      final_logit_softcap=30.0, sliding_window=4096,
                      query_pre_attn_scalar=256.0),
    "gemma2-27b": dict(vocab_size=256000, hidden_size=4608, num_layers=46,
                       num_heads=32, num_kv_heads=16, head_dim=128,
                       intermediate_size=36864, rope_theta=10000.0,
                       max_position=8192, tie_embeddings=True,
                       hidden_act="gelu_tanh", norm_offset=True,
                       embed_scale=True, rms_eps=1e-6,
                       sandwich_norms=True, attn_logit_softcap=50.0,
                       final_logit_softcap=30.0, sliding_window=4096,
                       query_pre_attn_scalar=144.0),
    "tiny-gemma3": dict(vocab_size=259, hidden_size=64, num_layers=6,
                        num_heads=4, num_kv_heads=2, head_dim=16,
                        intermediate_size=128, rope_theta=1000000.0,
                        max_position=1024, tie_embeddings=True,
                        hidden_act="gelu_tanh", norm_offset=True,
                        embed_scale=True, rms_eps=1e-6,
                        sandwich_norms=True, sliding_window=8,
                        sliding_pattern=3, rope_local_theta=10000.0,
                        qk_norm=True, query_pre_attn_scalar=24.0),
    "gemma3-4b": dict(vocab_size=262208, hidden_size=2560, num_layers=34,
                      num_heads=8, num_kv_heads=4, head_dim=256,
                      intermediate_size=10240, rope_theta=1000000.0,
                      rope_scaling={"rope_type": "linear", "factor": 8.0},
                      max_position=131072, tie_embeddings=True,
                      hidden_act="gelu_tanh", norm_offset=True,
                      embed_scale=True, rms_eps=1e-6, sandwich_norms=True,
                      sliding_window=1024, sliding_pattern=6,
                      rope_local_theta=10000.0, qk_norm=True,
                      query_pre_attn_scalar=256.0),
    "gemma3-12b": dict(vocab_size=262208, hidden_size=3840, num_layers=48,
                       num_heads=16, num_kv_heads=8, head_dim=256,
                       intermediate_size=15360, rope_theta=1000000.0,
                       rope_scaling={"rope_type": "linear", "factor": 8.0},
                       max_position=131072, tie_embeddings=True,
                       hidden_act="gelu_tanh", norm_offset=True,
                       embed_scale=True, rms_eps=1e-6, sandwich_norms=True,
                       sliding_window=1024, sliding_pattern=6,
                       rope_local_theta=10000.0, qk_norm=True,
                       query_pre_attn_scalar=256.0),
    "tiny-gemma3-vlm": dict(vocab_size=259, hidden_size=64, num_layers=6,
                            num_heads=4, num_kv_heads=2, head_dim=16,
                            intermediate_size=128, rope_theta=1000000.0,
                            max_position=1024, tie_embeddings=True,
                            hidden_act="gelu_tanh", norm_offset=True,
                            embed_scale=True, rms_eps=1e-6,
                            sandwich_norms=True, sliding_window=8,
                            sliding_pattern=3, rope_local_theta=10000.0,
                            qk_norm=True, query_pre_attn_scalar=24.0,
                            mm_tokens_per_image=4, image_token_id=250,
                            vision=dict(hidden_size=32, num_hidden_layers=2,
                                        num_attention_heads=4,
                                        intermediate_size=48, image_size=56,
                                        patch_size=14)),
    "gemma-2b": dict(vocab_size=256000, hidden_size=2048, num_layers=18,
                     num_heads=8, num_kv_heads=1, head_dim=256,
                     intermediate_size=16384, rope_theta=10000.0,
                     max_position=8192, tie_embeddings=True,
                     hidden_act="gelu_tanh", norm_offset=True,
                     embed_scale=True, rms_eps=1e-6),
    "gemma-7b": dict(vocab_size=256000, hidden_size=3072, num_layers=28,
                     num_heads=16, num_kv_heads=16, head_dim=256,
                     intermediate_size=24576, rope_theta=10000.0,
                     max_position=8192, tie_embeddings=True,
                     hidden_act="gelu_tanh", norm_offset=True,
                     embed_scale=True, rms_eps=1e-6),
}


def preset(name: str, **overrides) -> LlamaConfig:
    d = dict(PRESETS[name])
    d.update(overrides)
    return LlamaConfig(**d)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def param_shapes(cfg: LlamaConfig) -> Dict[str, Any]:
    """Name -> shape of every parameter; the JAX package's tree exactly."""
    D, Hq, Hkv, Dh, F_, L, V = (cfg.hidden_size, cfg.num_heads,
                                cfg.num_kv_heads, cfg.head_dim,
                                cfg.intermediate_size, cfg.num_layers,
                                cfg.vocab_size)
    layers = {
        "ln1": (L, D), "ln2": (L, D),
        "wq": (L, D, Hq, Dh), "wk": (L, D, Hkv, Dh), "wv": (L, D, Hkv, Dh),
        "wo": (L, Hq, Dh, D),
    }
    E = cfg.num_experts
    if E:
        layers.update(wr=(L, D, E), wg=(L, E, D, F_), wu=(L, E, D, F_),
                      wd=(L, E, F_, D))
    else:
        layers.update(wg=(L, D, F_), wu=(L, D, F_), wd=(L, F_, D))
    if cfg.sandwich_norms:
        layers["ln1_post"] = (L, D)
        layers["ln2_post"] = (L, D)
    if cfg.qk_norm:
        layers["ln_q"] = (L, Dh)
        layers["ln_k"] = (L, Dh)
    if cfg.attention_bias:
        layers["bq"] = (L, Hq, Dh)
        layers["bk"] = (L, Hkv, Dh)
        layers["bv"] = (L, Hkv, Dh)
    shapes: Dict[str, Any] = {"embed": (V, D), "layers": layers,
                              "final_norm": (D,)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (D, V)
    return shapes


# norms stay f32 (as in the JAX tree); everything else is cfg.dtype
_F32_PARAMS = ("ln1", "ln2", "ln1_post", "ln2_post", "ln_q", "ln_k",
               "final_norm")


def kv_block_bytes(cfg: LlamaConfig, page_size: int) -> int:
    """Bytes of one KV block (k+v, all layers) at device precision: the
    unit the engine's residency gauges and the router's bytes scoring
    price in (the JAX package's ``kv_block_bytes``)."""
    itemsize = torch.empty((), dtype=cfg.dtype).element_size()
    return (2 * cfg.num_layers * cfg.num_kv_heads * page_size
            * cfg.head_dim * itemsize)


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device: torch.device, tp: int = 1,
                rank: int = 0) -> Dict[str, Any]:
    """Random-init params (testing/benching without checkpoint files), drawn
    as the JAX package draws them: normal scaled by 1/sqrt of the leaf's
    leading dim, in f32 from ``generator`` (which must live on ``device``),
    then cast to ``cfg.dtype``. ``ln1``/``ln2``/``final_norm`` are ones; the
    sandwich and q/k norms are random (rounded through ``cfg.dtype``, kept
    f32) so a parity test would catch a dropped one.

    With ``tp > 1`` the tree is rank ``rank``'s shard of the same weights:
    every rank draws each whole leaf from the same generator and keeps its
    cut (:func:`tp_cuts`) as the leaf is drawn, so its transient peak is
    one whole f32 leaf, not the tree."""
    cuts = tp_cuts(cfg, tp, rank)

    def draw(name: str, shape, c) -> torch.Tensor:
        if name in ("ln1", "ln2", "final_norm"):
            return torch.ones(shape, dtype=torch.float32, device=device)
        t = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device).mul_(1.0 / math.sqrt(shape[0]))
        if c is None:
            t = t.to(cfg.dtype)
        else:
            # a copy of the cut, in cfg.dtype, frees the whole leaf
            t = _cut(t, c)
            t = t.clone() if t.dtype == cfg.dtype else t.to(cfg.dtype)
        return t.float() if name in _F32_PARAMS else t

    shapes = param_shapes(cfg)
    params: Dict[str, Any] = {
        name: draw(name, shape, cuts[name]) for name, shape in shapes.items()
        if name != "layers"}
    params["layers"] = {name: draw(name, shape, cuts["layers"][name])
                        for name, shape in shapes["layers"].items()}
    return params


# ---------------------------------------------------------------------------
# Tensor parallelism (Megatron): heads, the FFN dim and an untied head's
# vocab shard over tp; the row-parallel products (wo, wd) are summed over
# the ranks, the vocab-sharded logits gathered
# ---------------------------------------------------------------------------

#: why MoE is refused at tp > 1
MOE_TP_GAP = ("MoE under tensor parallelism needs the ep axis (ROADMAP "
              "Queue 1 item 11b)")


def param_specs(cfg: LlamaConfig, tp_size: int = 1) -> Dict[str, Any]:
    """Each leaf's sharding as a tuple of axis names (None = replicated),
    one entry a dim: the JAX package's ``param_specs`` at pp=1, leaf for
    leaf. tp shards attention heads, the FFN dim and, when the model is
    untied and the vocab divides tp, the LM head's vocab dim; k/v
    replicate when the kv heads do not divide tp; the embedding stays
    replicated (token gathers need the whole table)."""
    tp = "tp"
    kv = tp if cfg.num_kv_heads % max(tp_size, 1) == 0 else None
    if cfg.num_experts:
        ftp = tp if cfg.intermediate_size % max(tp_size, 1) == 0 else None
        ffn = {"wr": (None, None, None), "wg": (None, "ep", None, ftp),
               "wu": (None, "ep", None, ftp), "wd": (None, "ep", ftp, None)}
    else:
        ffn = {"wg": (None, None, tp), "wu": (None, None, tp),
               "wd": (None, tp, None)}
    layers = {"ln1": (None, None), "ln2": (None, None),
              "wq": (None, None, tp, None), "wk": (None, None, kv, None),
              "wv": (None, None, kv, None), "wo": (None, tp, None, None),
              **ffn}
    if cfg.sandwich_norms:
        layers["ln1_post"] = layers["ln2_post"] = (None, None)
    if cfg.qk_norm:
        layers["ln_q"] = layers["ln_k"] = (None, None)
    if cfg.attention_bias:
        layers["bq"] = (None, tp, None)
        layers["bk"] = layers["bv"] = (None, kv, None)
    specs: Dict[str, Any] = {"embed": (None, None), "layers": layers,
                             "final_norm": (None,)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = (None, tp if cfg.vocab_size % max(tp_size, 1) == 0
                            else None)
    return specs


def validate_tp(cfg: LlamaConfig, tp: int) -> None:
    """The JAX package's ``validate_tp`` at ep=1; MoE at tp > 1 waits for
    the ep axis."""
    if cfg.num_heads % tp:
        raise ValueError(f"num_heads {cfg.num_heads} not divisible by tp={tp}")
    if tp > 1 and cfg.num_experts:
        raise NotImplementedError(MOE_TP_GAP)
    if not cfg.num_experts and cfg.intermediate_size % tp:
        raise ValueError(f"ffn {cfg.intermediate_size} not divisible by tp={tp}")


def kernel_tp_ok(cfg: LlamaConfig, tp: int) -> bool:
    """Can the attention kernels run on one rank's heads at this tp (the
    JAX package's ``pallas_tp_ok``)? Each rank needs an integral GQA group:
    its Hq/tp query heads divisible by the kv heads it keeps."""
    if tp <= 1:
        return True
    if cfg.num_heads % tp:
        return False
    return (cfg.num_heads // tp) % local_kv_heads(cfg, tp) == 0


def local_kv_heads(cfg: LlamaConfig, tp: int) -> int:
    """The kv heads one rank keeps: Hkv/tp when tp divides them, else the
    heads its query heads read (one, when a rank's query heads lie in one
    GQA group)."""
    if tp <= 1 or cfg.num_kv_heads % tp == 0:
        return cfg.num_kv_heads // max(tp, 1)
    return len(kv_head_range(cfg, tp, 0))


def kv_head_range(cfg: LlamaConfig, tp: int, rank: int) -> range:
    """The kv heads rank ``rank`` keeps: its share when tp divides them;
    otherwise (k/v replicated in the JAX package's specs) the heads its
    query heads [rank*Hq/tp, (rank+1)*Hq/tp) read under GQA. A rank whose
    query heads cover part of a group and part of another has no uniform
    kernel layout and raises."""
    Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
    if cfg.num_kv_heads % tp == 0:
        n = Hkv // tp
        return range(rank * n, (rank + 1) * n)
    hq, group = Hq // tp, Hq // Hkv
    q0 = rank * hq
    if hq % group == 0:
        return range(q0 // group, (q0 + hq) // group)
    if group % hq == 0:
        return range(q0 // group, q0 // group + 1)
    raise ValueError(
        f"tp={tp}: a rank's {hq} query heads straddle GQA groups of {group} "
        f"(Hq={Hq}, Hkv={Hkv}); no rank layout runs the kernels")


def tp_cuts(cfg: LlamaConfig, tp: int, rank: int) -> Dict[str, Any]:
    """Where rank ``rank`` cuts each stacked leaf: ``(axis, start, stop)``
    on the leaf's shape (:func:`param_shapes`), or None for a leaf it
    holds whole. Follows :func:`param_specs`, except that a rank keeps
    only the kv heads its query heads read where the specs replicate
    k/v."""
    shapes = param_shapes(cfg)
    if tp <= 1:
        return {n: None for n in shapes if n != "layers"} | {
            "layers": {n: None for n in shapes["layers"]}}
    validate_tp(cfg, tp)
    specs = param_specs(cfg, tp)
    kv = kv_head_range(cfg, tp, rank)

    def cut(name: str, shape, spec):
        if name in ("wk", "wv", "bk", "bv"):
            axis = 2 if name in ("wk", "wv") else 1
            return axis, kv.start, kv.stop
        for axis, ax in enumerate(spec):
            if ax == "tp":
                n = shape[axis] // tp
                return axis, rank * n, (rank + 1) * n
        return None

    out: Dict[str, Any] = {n: cut(n, s, specs[n]) for n, s in shapes.items()
                           if n != "layers"}
    out["layers"] = {n: cut(n, s, specs["layers"][n])
                     for n, s in shapes["layers"].items()}
    return out


def shard_shapes(cfg: LlamaConfig, tp: int = 1,
                 rank: int = 0) -> Dict[str, Any]:
    """:func:`param_shapes` of rank ``rank``'s shard."""
    shapes, cuts = param_shapes(cfg), tp_cuts(cfg, tp, rank)

    def one(shape, c):
        if c is None:
            return shape
        axis, a, b = c
        return shape[:axis] + (b - a,) + shape[axis + 1:]

    out: Dict[str, Any] = {n: one(s, cuts[n]) for n, s in shapes.items()
                           if n != "layers"}
    out["layers"] = {n: one(s, cuts["layers"][n])
                     for n, s in shapes["layers"].items()}
    return out


def _cut(t, c):
    if c is None:
        return t
    axis, a, b = c
    if isinstance(t, np.ndarray):
        return np.take(t, range(a, b), axis=axis)
    return t.narrow(axis, a, b - a)


def shard_params(tree: Dict[str, Any], cfg: LlamaConfig, tp: int,
                 rank: int) -> Dict[str, Any]:
    """Rank ``rank``'s shard of a whole tree (torch tensors or numpy
    arrays), each leaf cut along :func:`tp_cuts` (torch leaves as
    contiguous copies)."""
    cuts = tp_cuts(cfg, tp, rank)

    def one(t, c):
        s = _cut(t, c)
        return s.contiguous() if isinstance(s, torch.Tensor) and c else s

    out: Dict[str, Any] = {n: one(v, cuts[n]) for n, v in tree.items()
                           if n != "layers"}
    out["layers"] = {n: one(v, cuts["layers"][n])
                     for n, v in tree["layers"].items()}
    return out


def _to_torch(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        # dynalint: ok(host-sync) weight placement at construction (tests, JAX
        # trees): a blocking upload, once
        return a.to(device)
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()   # torch.from_numpy shares memory, and needs it writable
    if a.dtype.name == "bfloat16":
        # ml_dtypes bfloat16: same bits as torch.bfloat16
        # dynalint: ok(host-sync) weight placement at construction (tests, JAX
        # trees): a blocking upload, once
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            device)
    # dynalint: ok(host-sync) weight placement at construction (tests, JAX
    # trees): a blocking upload, once
    return torch.from_numpy(a).to(device)


def check_params(tree: Dict[str, Any], cfg: LlamaConfig, tp: int = 1,
                 rank: int = 0) -> None:
    """The tree has exactly :func:`param_shapes`' leaves, at the shapes of
    rank ``rank``'s shard (:func:`shard_shapes`)."""
    shapes = shard_shapes(cfg, tp, rank)
    missing = ({n for n in shapes if n != "layers"} - set(tree)) | {
        f"layers.{n}" for n in set(shapes["layers"])
        - set(tree.get("layers", {}))}
    if missing:
        raise ValueError(f"missing leaves {sorted(missing)}")
    extra = (set(tree) - set(shapes)) | (
        set(tree["layers"]) - set(shapes["layers"]))
    if extra:
        raise ValueError(f"unexpected leaves {sorted(extra)}")
    for name, shape in shapes.items():
        if name == "layers":
            for n, s in shape.items():
                if tuple(tree["layers"][n].shape) != s:
                    raise ValueError(f"layers.{n}: shape "
                                     f"{tuple(tree['layers'][n].shape)} != {s}")
        elif tuple(tree[name].shape) != shape:
            raise ValueError(f"{name}: shape {tuple(tree[name].shape)} != "
                             f"{shape}")


def params_from_jax(np_tree: Dict[str, Any], cfg: LlamaConfig,
                    device: torch.device, tp: int = 1,
                    rank: int = 0) -> Dict[str, Any]:
    """The JAX package's parameter tree (its leaves as numpy arrays, or CPU
    torch tensors where numpy has no dtype for them) -> the port's, on
    ``device``; with ``tp > 1``, rank ``rank``'s shard of it, each leaf
    cut on the host before it is placed. Names and shapes are identical;
    every leaf is checked against :func:`shard_shapes`."""
    shapes = param_shapes(cfg)
    extra = (set(np_tree) - set(shapes)) | (
        set(np_tree["layers"]) - set(shapes["layers"]))
    if extra:
        raise ValueError(f"params_from_jax: unexpected leaves {sorted(extra)}")
    cuts = tp_cuts(cfg, tp, rank)
    out: Dict[str, Any] = {}
    for name in shapes:
        if name == "layers":
            continue
        out[name] = _to_torch(_cut(np_tree[name], cuts[name]), device)
    out["layers"] = {n: _to_torch(_cut(np_tree["layers"][n],
                                       cuts["layers"][n]), device)
                     for n in shapes["layers"]}
    check_params(out, cfg, tp, rank)
    return out


# ---------------------------------------------------------------------------
# Ops
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float,
             offset: bool = False) -> torch.Tensor:
    """RMSNorm; ``offset=True`` = Gemma convention (weights stored
    zero-centered, output scales by 1 + w)."""
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    wf = w.float()
    if offset:
        wf = 1.0 + wf
    return (xf * scale * wf).to(x.dtype)


def _act(cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.hidden_act == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    if cfg.hidden_act == "gelu":
        return F.gelu(x)
    return F.silu(x)


def _embed(params: Dict[str, Any], cfg: LlamaConfig,
           tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens]
    if cfg.embed_scale:
        # Gemma scales inputs by sqrt(D), rounded through the embed dtype
        x = x * torch.tensor(math.sqrt(cfg.hidden_size), dtype=x.dtype)
    return x


def _rope_inv_freq(cfg: LlamaConfig, local: bool = False) -> np.ndarray:
    Dh = cfg.head_dim
    if local:
        # gemma3 sliding layers: own base frequency, NO scaling
        theta = cfg.rope_local_theta or cfg.rope_theta
        return (1.0 / (theta ** (np.arange(0, Dh, 2, dtype=np.float64) / Dh))
                ).astype(np.float32)
    inv = 1.0 / (cfg.rope_theta ** (np.arange(0, Dh, 2, dtype=np.float64) / Dh))
    rs = cfg.rope_scaling or {}
    if rs.get("rope_type") == "linear" or rs.get("type") == "linear":
        inv = inv / rs.get("factor", 1.0)
    if rs.get("rope_type") == "ggml_factors":
        factors = np.asarray(rs["factors"], dtype=np.float64)
        if factors.shape != inv.shape:
            raise ValueError(
                f"rope_freqs tensor has {factors.shape[0]} factors but "
                f"head_dim {Dh} needs {inv.shape[0]}")
        inv = inv / factors
    if rs.get("rope_type") == "llama3" or rs.get("type") == "llama3":
        # llama3 frequency-dependent NTK-style scaling
        factor = rs.get("factor", 8.0)
        lo = rs.get("low_freq_factor", 1.0)
        hi = rs.get("high_freq_factor", 4.0)
        orig = rs.get("original_max_position_embeddings", 8192)
        wavelen = 2 * np.pi / inv
        ratio = orig / wavelen
        smooth = np.clip((ratio - lo) / (hi - lo), 0.0, 1.0)
        inv = np.where(ratio < lo, inv / factor,
                       np.where(ratio > hi, inv,
                                (1 - smooth) * inv / factor + smooth * inv))
    return inv.astype(np.float32)


def rope_tables(cfg: LlamaConfig, positions: torch.Tensor,
                local: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables (f32) for integer positions [...]: -> [..., Dh/2].
    ``local=True`` = the sliding layers' table (gemma3 dual-base rope)."""
    inv = to_device(_rope_inv_freq(cfg, local=local), positions.device)
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: [..., H, Dh]; cos/sin: [..., Dh/2] (broadcast over H)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


NEG_INF = -1e30


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: torch.Tensor, scale: Optional[float] = None,
           softcap: Optional[float] = None) -> torch.Tensor:
    """Dense GQA attention. q: [B,T,Hq,Dh]; k,v: [B,S,Hkv,Dh]; mask:
    [B,T,S] bool (True = attend). Returns [B,T,Hq,Dh]. f32 softmax;
    ``softcap`` applies Gemma2's tanh capping BEFORE masking (HF order)."""
    B, T, Hq, Dh = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, T, Hkv, G, Dh)
    scores = torch.einsum("bthgd,bshd->bhgts", qg.float(), k.float())
    scores = scores * (scale if scale is not None else 1.0 / math.sqrt(Dh))
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    scores = torch.where(mask[:, None, None, :, :], scores,
                         torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgts,bshd->bthgd", w.to(v.dtype), v)
    return out.reshape(B, T, Hq, Dh)


def _qkv(x: torch.Tensor, lp: Dict[str, Any], l: int, cfg: LlamaConfig,
         rope) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pre-norm, q/k/v projections (+bias, +qk-norm) and rope for layer l.
    ``rope`` = (cos, sin, cos_local, sin_local)."""
    B, T, D = x.shape
    # the head counts of this rank's shard (the whole model's at tp=1)
    Hq, Hkv, Dh = lp["wq"].shape[2], lp["wk"].shape[2], cfg.head_dim
    h = rms_norm(x, lp["ln1"][l], cfg.rms_eps, cfg.norm_offset)
    q = (h @ lp["wq"][l].reshape(D, Hq * Dh)).reshape(B, T, Hq, Dh)
    k = (h @ lp["wk"][l].reshape(D, Hkv * Dh)).reshape(B, T, Hkv, Dh)
    v = (h @ lp["wv"][l].reshape(D, Hkv * Dh)).reshape(B, T, Hkv, Dh)
    if cfg.attention_bias:
        q = q + lp["bq"][l]
        k = k + lp["bk"][l]
        v = v + lp["bv"][l]
    if cfg.qk_norm:
        # gemma3: per-head RMSNorm on q/k AFTER projection, BEFORE rope
        q = rms_norm(q, lp["ln_q"][l], cfg.rms_eps, cfg.norm_offset)
        k = rms_norm(k, lp["ln_k"][l], cfg.rms_eps, cfg.norm_offset)
    cos, sin, cos_l, sin_l = rope
    if cfg.rope_local_theta is not None and cfg.layer_sliding(l):
        cos, sin = cos_l, sin_l
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _rope_all(cfg: LlamaConfig, positions: torch.Tensor):
    cos, sin = rope_tables(cfg, positions)
    if cfg.rope_local_theta is not None:
        cos_l, sin_l = rope_tables(cfg, positions, local=True)
    else:
        cos_l, sin_l = cos, sin
    return cos, sin, cos_l, sin_l


def _attn_out(x: torch.Tensor, attn: torch.Tensor, lp: Dict[str, Any],
              l: int, cfg: LlamaConfig, group=None) -> torch.Tensor:
    """Output projection + residual; Gemma2 norms the branch output first.
    Under tp each rank's heads give a partial product, summed over
    ``group`` before the norm and the residual."""
    B, T = attn.shape[:2]
    o = attn.reshape(B, T, -1) @ lp["wo"][l].reshape(-1, cfg.hidden_size)
    if group is not None:
        o = collectives.all_reduce_(o, group)
    if cfg.sandwich_norms:
        o = rms_norm(o, lp["ln1_post"][l], cfg.rms_eps, cfg.norm_offset)
    return x + o


def _ffn_block(x: torch.Tensor, lp: Dict[str, Any], l: int,
               cfg: LlamaConfig, group=None) -> torch.Tensor:
    """Pre-norm FFN (dense or MoE) + residual; Gemma2 adds a post-norm on
    the branch output (sandwich norms). Under tp each rank's FFN columns
    give a partial product, summed over ``group`` before the post-norm."""
    h2 = rms_norm(x, lp["ln2"][l], cfg.rms_eps, cfg.norm_offset)
    if cfg.num_experts:
        out = moe_ffn(h2, lp["wr"][l], lp["wg"][l], lp["wu"][l],
                      lp["wd"][l], cfg.experts_per_token)
    else:
        g = h2 @ lp["wg"][l]
        u = h2 @ lp["wu"][l]
        out = (_act(cfg, g) * u) @ lp["wd"][l]
    if group is not None:
        out = collectives.all_reduce_(out, group)
    if cfg.sandwich_norms:
        out = rms_norm(out, lp["ln2_post"][l], cfg.rms_eps, cfg.norm_offset)
    return x + out


def _lm_head(x: torch.Tensor, params: Dict[str, Any],
             cfg: LlamaConfig, group=None) -> torch.Tensor:
    """Final norm + vocab projection (+ Gemma2 final logit softcap), f32.
    A vocab-sharded head's logit columns are gathered over ``group``
    before the softcap."""
    x = rms_norm(x, params["final_norm"], cfg.rms_eps, cfg.norm_offset)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ head.to(x.dtype)).float()
    if group is not None and logits.shape[-1] != cfg.vocab_size:
        logits = collectives.gather_last(logits, group)
    if cfg.final_logit_softcap:
        cap = cfg.final_logit_softcap
        logits = torch.tanh(logits / cap) * cap
    return logits


def _window(cfg: LlamaConfig, layer: int) -> Optional[int]:
    return cfg.sliding_window if cfg.layer_sliding(layer) else None


def _check_impl(attn_impl: str, allowed: Tuple[str, ...]) -> None:
    if attn_impl in ("ring", "xla", "pallas"):
        raise NotImplementedError(
            f"attn_impl={attn_impl!r} is not ported to torch; use one of "
            f"{allowed}")
    if attn_impl not in allowed:
        raise ValueError(f"attn_impl must be one of {allowed}, got "
                         f"{attn_impl!r}")


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def forward(params: Dict[str, Any], cfg: LlamaConfig,
            tokens: torch.Tensor,        # [B, T] token ids
            positions: torch.Tensor,     # [B, T] int32 position of each token
            k_pool: torch.Tensor,        # [L, Hkv, n_pages, page, Dh] KV pool
            v_pool: torch.Tensor,
            write_idx: torch.Tensor,     # [B, T] pool token-slot per new token
            read_idx: torch.Tensor,      # [B, S] pool token-slots to attend over
            read_pos: torch.Tensor,      # [B, S] int32 position of each slot
            read_valid: torch.Tensor,    # [B, S] bool slot holds a real token
            attn_impl: str = "flash",    # "flash" kernel | "dense"
            logits_idx: Optional[torch.Tensor] = None,  # [B] per-lane position
            embed_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
            attn_spans: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
            group=None,                  # the tp group (None: one rank)
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One forward pass over a token chunk against the paged KV pool.

    The chunk's K/V are written into the pool at ``write_idx`` first (in
    place); attention then gathers ``read_idx`` (which must cover the chunk
    itself) and masks causally by position: a token at position p attends to
    slots with ``read_pos <= p`` (and, on sliding layers, ``> p - window``).

    Returns (logits [B, T, vocab] f32, k_pool, v_pool). With ``logits_idx``
    the LM head runs only on each lane's hidden state at that chunk position
    and logits are [B, 1, vocab] — the prefill fast path.

    Multimodal (Gemma3 VLM, ``attn_impl="dense"`` only):

    - ``embed_override`` = (vals [B,T,D], mask [B,T] bool) replaces the
      masked positions' embeddings AFTER the embed scale (HF's
      masked_scatter of the projected image soft tokens).
    - ``attn_spans`` = (q_span [B,T], read_span [B,S]) int32 image-group
      ids (0 = text): tokens of the same image attend bidirectionally; the
      or-mask goes into the full and the sliding masks alike.

    Under tensor parallelism ``params`` and the pools are one rank's shard
    (:func:`shard_params`; the pools hold its kv heads) and ``group`` is
    the tp group: attention runs on the rank's heads, the row-parallel
    products are summed over the group and a vocab-sharded head's logits
    gathered, so every rank returns the whole logits.
    """
    _check_impl(attn_impl, ("flash", "dense"))
    if attn_spans is not None and attn_impl != "dense":
        raise ValueError(
            "image-span bidirectional attention (Gemma3 VLM) runs on "
            "attn_impl='dense' only; the flash kernel takes no span inputs")
    B, T = tokens.shape
    page = k_pool.shape[3]
    lp = params["layers"]
    x = _embed(params, cfg, tokens)
    if embed_override is not None:
        ov_vals, ov_mask = embed_override
        x = torch.where(ov_mask[..., None], ov_vals.to(x.dtype), x)
    rope = _rope_all(cfg, positions)
    flat_w = write_idx.reshape(-1).long()
    wp, wo = flat_w // page, flat_w % page
    read_idx = read_idx.long()
    rp, ro = read_idx // page, read_idx % page
    if attn_impl == "dense":
        mask = (read_valid[:, None, :]
                & (read_pos[:, None, :] <= positions[:, :, None]))
        if cfg.sliding_window is not None:
            sliding_mask = mask & (read_pos[:, None, :]
                                   > positions[:, :, None] - cfg.sliding_window)
        if attn_spans is not None:
            q_span, read_span = attn_spans
            bidir = ((q_span[:, :, None] > 0)
                     & (q_span[:, :, None] == read_span[:, None, :])
                     & read_valid[:, None, :])
            mask = mask | bidir
            if cfg.sliding_window is not None:
                sliding_mask = sliding_mask | bidir

    for l in range(cfg.num_layers):
        q, k, v = _qkv(x, lp, l, cfg, rope)
        # In-place scatter of the chunk's KV. Torch applies the integer l
        # as a plain select, so [l, :, wp, wo] indexes dims 1-2 of the
        # [Hkv, n_pages, page, Dh] layer and has shape [Hkv, n, Dh] — JAX and
        # numpy put the broadcast index dims first ([n, Hkv, Dh]).
        k_pool[l, :, wp, wo] = k.reshape(B * T, -1, k.shape[-1]).transpose(0, 1)
        v_pool[l, :, wp, wo] = v.reshape(B * T, -1, v.shape[-1]).transpose(0, 1)
        # gather this sequence's context (same rule): [Hkv, B, S, Dh] viewed
        # as [B, S, Hkv, Dh]
        k_ctx = k_pool[l, :, rp, ro].permute(1, 2, 0, 3)
        v_ctx = v_pool[l, :, rp, ro].permute(1, 2, 0, 3)
        if attn_impl == "flash":
            attn = flash_attention(q, k_ctx, v_ctx, positions, read_pos,
                                   read_valid, scale=cfg.attn_scale,
                                   softcap=cfg.attn_logit_softcap,
                                   window=_window(cfg, l))
        else:
            attn = attend(q, k_ctx, v_ctx,
                          sliding_mask if cfg.layer_sliding(l) else mask,
                          scale=cfg.attn_scale,
                          softcap=cfg.attn_logit_softcap)
        x = _attn_out(x, attn, lp, l, cfg, group)
        x = _ffn_block(x, lp, l, cfg, group)

    if logits_idx is not None:
        x = x[torch.arange(B, device=x.device), logits_idx.long()][:, None]
    return _lm_head(x, params, cfg, group), k_pool, v_pool


def forward_decode(params: Dict[str, Any], cfg: LlamaConfig,
                   tokens: torch.Tensor,        # [B] last sampled token
                   k_pool: torch.Tensor,        # [L, Hkv, n_pages, page, Dh]
                   v_pool: torch.Tensor,
                   page_tables: torch.Tensor,   # [B, P] int32 (pad: page 0)
                   lengths: torch.Tensor,       # [B] int32 tokens incl. current
                   attn_impl: str = "paged",    # "paged" kernel | "dense"
                   group=None,                  # the tp group (see forward)
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode step addressed purely by page tables.

    The current token sits at position ``lengths - 1``; its KV is written
    through the page table (in place), then attention covers tokens
    [0, length). With ``attn_impl="paged"`` the paged-attention kernel reads
    pages straight from the pool (no contiguous-context gather at all).

    Returns (logits [B, 1, vocab] f32, k_pool, v_pool).
    """
    _check_impl(attn_impl, ("paged", "dense"))
    B = tokens.shape[0]
    page = k_pool.shape[3]
    lp = params["layers"]
    pos = lengths - 1
    x = _embed(params, cfg, tokens)[:, None]
    rope = _rope_all(cfg, pos[:, None])
    w_page = torch.gather(page_tables, 1,
                          (pos // page)[:, None].long())[:, 0].long()
    w_off = (pos % page).long()
    if attn_impl == "dense":
        S = page_tables.shape[1] * page
        t = torch.arange(S, device=tokens.device)
        rp = torch.gather(page_tables, 1,
                          (t // page)[None].expand(B, S)).long()
        ro = (t % page)[None].expand(B, S)
        mask = (t[None] < lengths[:, None])[:, None, :]   # [B,1,S]
        if cfg.sliding_window is not None:
            sliding_mask = mask & (t[None] > pos[:, None]
                                   - cfg.sliding_window)[:, None, :]

    for l in range(cfg.num_layers):
        q, k, v = _qkv(x, lp, l, cfg, rope)
        # in place; [l, :, w_page, w_off] has shape [Hkv, B, Dh] in torch
        # (see forward)
        k_pool[l, :, w_page, w_off] = k[:, 0].transpose(0, 1)
        v_pool[l, :, w_page, w_off] = v[:, 0].transpose(0, 1)
        if attn_impl == "paged":
            attn = paged_attention(q[:, 0], k_pool[l], v_pool[l], page_tables,
                                   lengths, scale=cfg.attn_scale,
                                   softcap=cfg.attn_logit_softcap,
                                   window=_window(cfg, l))[:, None]
        else:
            k_ctx = k_pool[l, :, rp, ro].permute(1, 2, 0, 3)   # [B,S,Hkv,Dh]
            v_ctx = v_pool[l, :, rp, ro].permute(1, 2, 0, 3)
            attn = attend(q, k_ctx, v_ctx,
                          sliding_mask if cfg.layer_sliding(l) else mask,
                          scale=cfg.attn_scale,
                          softcap=cfg.attn_logit_softcap)
        x = _attn_out(x, attn, lp, l, cfg, group)
        x = _ffn_block(x, lp, l, cfg, group)

    return _lm_head(x, params, cfg, group), k_pool, v_pool

