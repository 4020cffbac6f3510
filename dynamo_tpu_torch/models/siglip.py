"""SigLIP vision tower + Gemma3 multimodal projector in PyTorch (the JAX
package's ``models/siglip.py``, name for name).

Images -> patch embeddings -> ViT encoder -> avg-pooled, RMS-normed,
projected soft tokens that the language model takes in place of the
``<image_soft_token>`` embeddings. Pure functions over a params dict.

The patch conv is an unfold + matmul (patches do not overlap); attention is
full bidirectional over the patches, written as the JAX package's einsums
with an f32 softmax (no SDPA), so the numerics follow the reference.

Reference capability: transformers Gemma3 vision_tower (SiglipVisionModel)
+ Gemma3MultiModalProjector (modeling_gemma3.py:693-726).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping

import torch
import torch.nn.functional as F

from .llama import _to_torch


@dataclass(frozen=True)
class SiglipVisionConfig:
    hidden_size: int = 1152          # SigLIP-400M (Gemma3's tower)
    num_layers: int = 27
    num_heads: int = 16
    intermediate_size: int = 4304
    image_size: int = 896
    patch_size: int = 14
    num_channels: int = 3
    layer_norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16

    @property
    def patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.patches_per_side ** 2

    @classmethod
    def from_hf_config(cls, cfg: Dict[str, Any],
                       dtype: torch.dtype = torch.bfloat16
                       ) -> "SiglipVisionConfig":
        return cls(
            hidden_size=cfg["hidden_size"],
            num_layers=cfg["num_hidden_layers"],
            num_heads=cfg["num_attention_heads"],
            intermediate_size=cfg["intermediate_size"],
            image_size=cfg["image_size"],
            patch_size=cfg["patch_size"],
            num_channels=cfg.get("num_channels", 3),
            layer_norm_eps=cfg.get("layer_norm_eps", 1e-6),
            dtype=dtype,
        )


# leaves drawn at random; the layer norms are f32 ones (weights) and zeros
# (biases), every other leaf (the biases) zeros in the config's dtype
_RANDOM = ("patch_w", "pos_embed", "wq", "wk", "wv", "wo", "fc1", "fc2")
_NORMS = ("ln1_w", "ln1_b", "ln2_w", "ln2_b", "post_ln_w", "post_ln_b")


def param_shapes(cfg: SiglipVisionConfig) -> Dict[str, Any]:
    """Name -> shape of every tower leaf (the JAX package's tree)."""
    D, F_, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    ps, C = cfg.patch_size, cfg.num_channels
    layers = {"ln1_w": (L, D), "ln1_b": (L, D), "ln2_w": (L, D),
              "ln2_b": (L, D)}
    for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv"), ("wo", "bo")):
        layers[w], layers[b] = (L, D, D), (L, D)
    layers.update(fc1=(L, D, F_), fb1=(L, F_), fc2=(L, F_, D), fb2=(L, D))
    return {"patch_w": (ps * ps * C, D), "patch_b": (D,),
            "pos_embed": (cfg.num_patches, D), "layers": layers,
            "post_ln_w": (D,), "post_ln_b": (D,)}


def init_params(cfg: SiglipVisionConfig, generator: torch.Generator,
                device: torch.device) -> Dict[str, Any]:
    """Random tower params, drawn as the JAX package draws them: matrices
    normal / sqrt(leading dim) in f32 from ``generator`` (on ``device``)
    then cast to ``cfg.dtype``; biases zero; layer norms ones and zeros
    (f32). The patch embedding is stored unfolded: [ps*ps*C, D]."""
    def leaf(name: str, shape) -> torch.Tensor:
        if name in _RANDOM:
            t = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device)
            return t.mul_(1.0 / math.sqrt(shape[0])).to(cfg.dtype)
        if name in _NORMS:
            fill = torch.ones if name.endswith("_w") else torch.zeros
            return fill(shape, dtype=torch.float32, device=device)
        return torch.zeros(shape, dtype=cfg.dtype, device=device)

    shapes = param_shapes(cfg)
    out: Dict[str, Any] = {n: leaf(n, s) for n, s in shapes.items()
                           if n != "layers"}
    out["layers"] = {n: leaf(n, s) for n, s in shapes["layers"].items()}
    return out


def _layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * w + b).to(x.dtype)


def patchify(cfg: SiglipVisionConfig, pixels: torch.Tensor) -> torch.Tensor:
    """[N, C, H, W] -> [N, P², ps*ps*C], rows row-major over the patch grid
    and each row in (ph, pw, C) order, so one matmul against the unfolded
    conv kernel is the stride-``ps`` convolution."""
    N, C, H, W = pixels.shape
    ps = cfg.patch_size
    gh, gw = H // ps, W // ps
    x = pixels.reshape(N, C, gh, ps, gw, ps).permute(0, 2, 4, 3, 5, 1)
    return x.reshape(N, gh * gw, ps * ps * C)


def forward(params: Dict[str, Any], cfg: SiglipVisionConfig,
            pixels: torch.Tensor) -> torch.Tensor:
    """Vision tower: [N, C, H, W] (normalized pixels) -> [N, P², D]."""
    lp = params["layers"]
    D, H = cfg.hidden_size, cfg.num_heads
    Dh = D // H
    x = patchify(cfg, pixels.to(cfg.dtype)) @ params["patch_w"] \
        + params["patch_b"]
    x = x + params["pos_embed"][None]
    N, P, _ = x.shape
    scale = 1.0 / math.sqrt(Dh)
    eps = cfg.layer_norm_eps
    for l in range(cfg.num_layers):
        h = _layer_norm(x, lp["ln1_w"][l], lp["ln1_b"][l], eps)
        q = (h @ lp["wq"][l] + lp["bq"][l]).reshape(N, P, H, Dh)
        k = (h @ lp["wk"][l] + lp["bk"][l]).reshape(N, P, H, Dh)
        v = (h @ lp["wv"][l] + lp["bv"][l]).reshape(N, P, H, Dh)
        s = torch.einsum("nqhd,nkhd->nhqk", q, k).float() * scale
        a = torch.softmax(s, dim=-1).to(v.dtype)
        del s
        o = torch.einsum("nhqk,nkhd->nqhd", a, v).reshape(N, P, D)
        x = x + (o @ lp["wo"][l] + lp["bo"][l])
        h2 = _layer_norm(x, lp["ln2_w"][l], lp["ln2_b"][l], eps)
        f = F.gelu(h2 @ lp["fc1"][l] + lp["fb1"][l], approximate="tanh")
        x = x + (f @ lp["fc2"][l] + lp["fb2"][l])
    return _layer_norm(x, params["post_ln_w"], params["post_ln_b"], eps)


# ---------------------------------------------------------------------------
# Gemma3 multimodal projector
# ---------------------------------------------------------------------------

def init_projector_params(cfg: SiglipVisionConfig, text_hidden: int,
                          generator: torch.Generator,
                          device: torch.device) -> Dict[str, Any]:
    proj = torch.randn((cfg.hidden_size, text_hidden), generator=generator,
                       dtype=torch.float32, device=device)
    return {
        # Gemma RMS convention: the stored weight is the offset from 1
        "norm": torch.zeros(cfg.hidden_size, dtype=torch.float32,
                            device=device),
        "proj": proj.mul_(1.0 / math.sqrt(cfg.hidden_size)).to(cfg.dtype),
    }


def project(params: Dict[str, Any], cfg: SiglipVisionConfig,
            vision_out: torch.Tensor, mm_tokens_per_image: int,
            rms_eps: float = None) -> torch.Tensor:
    """[N, P², Dv] -> [N, mm_tokens, Dtext]: avg-pool the patch grid to
    tokens_per_side², Gemma-RMSNorm (weight as a +1 offset), project."""
    N, _, Dv = vision_out.shape
    pps = cfg.patches_per_side
    tps = math.isqrt(mm_tokens_per_image)
    assert tps * tps == mm_tokens_per_image, \
        f"mm_tokens_per_image {mm_tokens_per_image} must be a square"
    kern = pps // tps
    x = vision_out.reshape(N, tps, kern, tps, kern, Dv).mean(dim=(2, 4))
    xf = x.reshape(N, tps * tps, Dv).float()
    nrm = xf * torch.rsqrt(
        xf.square().mean(dim=-1, keepdim=True)
        + (cfg.layer_norm_eps if rms_eps is None else rms_eps))
    nrm = nrm * (1.0 + params["norm"])
    return (nrm @ params["proj"].float()).to(vision_out.dtype)


# ---------------------------------------------------------------------------
# weights from HF checkpoints and from the JAX package
# ---------------------------------------------------------------------------

def params_from_hf(tensors: Mapping[str, Any], cfg: SiglipVisionConfig,
                   device: torch.device,
                   prefix: str = "vision_tower.vision_model."
                   ) -> Dict[str, Any]:
    """HF SiglipVisionModel tensors (name -> CPU tensor or numpy array) ->
    the tower tree on ``device``."""
    D, L = cfg.hidden_size, cfg.num_layers
    ps, C = cfg.patch_size, cfg.num_channels
    dt = cfg.dtype

    def g(name: str) -> torch.Tensor:
        return _to_torch(tensors[prefix + name], torch.device("cpu"))

    def put(t: torch.Tensor, dtype) -> torch.Tensor:
        # dynalint: ok(host-sync) vision-tower weight placement at
        # construction: a blocking upload, once
        return t.to(device=device, dtype=dtype).contiguous()

    # Conv2d weight [D, C, ph, pw] -> unfolded [(ph pw C), D]
    conv = g("embeddings.patch_embedding.weight")
    patch_w = conv.permute(2, 3, 1, 0).reshape(ps * ps * C, D)

    def stack(name: str, dtype, t: bool = False) -> torch.Tensor:
        ws = [g(f"encoder.layers.{i}.{name}") for i in range(L)]
        return put(torch.stack([w.T if t else w for w in ws]), dtype)

    f32 = torch.float32
    layers = {"ln1_w": stack("layer_norm1.weight", f32),
              "ln1_b": stack("layer_norm1.bias", f32),
              "ln2_w": stack("layer_norm2.weight", f32),
              "ln2_b": stack("layer_norm2.bias", f32)}
    for leaf, mod in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                      ("o", "out_proj")):
        # HF Linear stores [out, in]; the tree is [in, out]
        layers[f"w{leaf}"] = stack(f"self_attn.{mod}.weight", dt, t=True)
        layers[f"b{leaf}"] = stack(f"self_attn.{mod}.bias", dt)
    layers.update(fc1=stack("mlp.fc1.weight", dt, t=True),
                  fb1=stack("mlp.fc1.bias", dt),
                  fc2=stack("mlp.fc2.weight", dt, t=True),
                  fb2=stack("mlp.fc2.bias", dt))
    return {
        "patch_w": put(patch_w, dt),
        "patch_b": put(g("embeddings.patch_embedding.bias"), dt),
        "pos_embed": put(g("embeddings.position_embedding.weight"), dt),
        "layers": layers,
        "post_ln_w": put(g("post_layernorm.weight"), f32),
        "post_ln_b": put(g("post_layernorm.bias"), f32),
    }


def projector_from_hf(tensors: Mapping[str, Any], cfg: SiglipVisionConfig,
                      device: torch.device,
                      prefix: str = "multi_modal_projector."
                      ) -> Dict[str, Any]:
    cpu = torch.device("cpu")
    norm = _to_torch(tensors[prefix + "mm_soft_emb_norm.weight"], cpu)
    proj = _to_torch(tensors[prefix + "mm_input_projection_weight"], cpu)
    # dynalint: ok(host-sync) projector weight placement at construction: a
    # blocking upload, once
    return {"norm": norm.to(device=device, dtype=torch.float32),
            # dynalint: ok(host-sync) the same placement, once
            "proj": proj.to(device=device, dtype=cfg.dtype)}


def params_from_jax(np_tree: Dict[str, Any], cfg: SiglipVisionConfig,
                    device: torch.device) -> Dict[str, Any]:
    """The JAX package's tower tree (numpy leaves, or CPU tensors where
    numpy has no dtype) -> the port's on ``device``, shapes checked."""
    shapes = param_shapes(cfg)

    def conv(name: str, a, shape) -> torch.Tensor:
        t = _to_torch(a, device)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
        return t

    out = {n: conv(n, np_tree[n], s) for n, s in shapes.items()
           if n != "layers"}
    out["layers"] = {n: conv(f"layers.{n}", np_tree["layers"][n], s)
                     for n, s in shapes["layers"].items()}
    return out


def projector_from_jax(np_tree: Dict[str, Any], cfg: SiglipVisionConfig,
                       text_hidden: int,
                       device: torch.device) -> Dict[str, Any]:
    """The JAX package's projector tree -> the port's on ``device``."""
    want = {"norm": (cfg.hidden_size,),
            "proj": (cfg.hidden_size, text_hidden)}
    out = {}
    for n, s in want.items():
        t = _to_torch(np_tree[n], device)
        if tuple(t.shape) != s:
            raise ValueError(f"projector {n}: shape {tuple(t.shape)} != {s}")
        out[n] = t
    return out
