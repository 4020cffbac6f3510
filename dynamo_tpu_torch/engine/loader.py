"""Checkpoint loading: HF safetensors (and GGUF) -> the stacked param tree.

Maps the HF ``LlamaForCausalLM`` parameter names onto the stacked-layer
tree of :func:`~dynamo_tpu_torch.models.llama.param_shapes` (the JAX
package's tree, name for name): the VLM prefixes, Gemma2's sandwich norms,
Gemma3's q/k norms, Qwen2's qkv biases, tied and untied heads, and HF
Linear's ``[out, in]`` turned into the tree's ``[in, ...out...]``.

Placement never builds the whole model on the host: every leaf is
allocated once on the target device, and each source tensor goes in by
row blocks of at most :data:`STAGE_BYTES`, read from the file straight
into one of two pinned staging blocks (no mapping, no host copy), uploaded
without a host sync, and cast and transposed on the device. The host holds
the two blocks, whatever the depth (and, for a quantized GGUF tensor, its
dequantized copy while it is placed). The leaves' dtype follows the config
(bf16 by default; the casts are torch's, rounding to nearest even as the
JAX package's numpy casts do); norms stay f32.

Reference capability: the model-weight fast path noted in SURVEY §5.4
(safetensors -> sharded arrays).
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from typing import Any, Callable, Dict, Optional, Union

import torch

from ..device import resolve_device
from ..llm.safetensors_io import RawTensor, ShardSet, save_file
from ..models import llama
from ..models.llama import LlamaConfig

# bytes of source rows a staging block holds (at least one row)
STAGE_BYTES = 64 << 20

# what a leaf is filled from: a host tensor, or a tensor's bytes in a file
Source = Union[torch.Tensor, RawTensor]

#: why MoE checkpoints are refused: the port serves MoE models (random or
#: converted weights), but neither package's loader maps expert tensors
MOE_CHECKPOINT_GAP = ("the expert tensor mapping (HF block_sparse_moe / "
                      "GGUF ffn_*_exps onto wr/wg/wu/wd) is missing in both "
                      "the JAX package's loader and the port's; serve MoE "
                      "models from random or converted weights")

# leaves stored transposed: HF Linear is [out, in], the tree [in, ...out]
_TRANSPOSED = ("wq", "wk", "wv", "wo", "wg", "wu", "wd", "lm_head")
_F32 = ("ln1", "ln2", "ln1_post", "ln2_post", "ln_q", "ln_k", "final_norm")

# GGUF tensor names of each leaf ("{}" is the layer index)
GGUF_NAMES: Dict[str, str] = {
    "embed": "token_embd.weight", "final_norm": "output_norm.weight",
    "lm_head": "output.weight",
    "ln1": "blk.{}.attn_norm.weight", "ln2": "blk.{}.ffn_norm.weight",
    # gemma2/3: post_attention_norm / post_ffw_norm (ffn_norm above is
    # the PRE-ffw norm in this layout)
    "ln1_post": "blk.{}.post_attention_norm.weight",
    "ln2_post": "blk.{}.post_ffw_norm.weight",
    "ln_q": "blk.{}.attn_q_norm.weight", "ln_k": "blk.{}.attn_k_norm.weight",
    "wq": "blk.{}.attn_q.weight", "wk": "blk.{}.attn_k.weight",
    "wv": "blk.{}.attn_v.weight", "wo": "blk.{}.attn_output.weight",
    "wg": "blk.{}.ffn_gate.weight", "wu": "blk.{}.ffn_up.weight",
    "wd": "blk.{}.ffn_down.weight",
    "bq": "blk.{}.attn_q.bias", "bk": "blk.{}.attn_k.bias",
    "bv": "blk.{}.attn_v.bias",
}


def hf_names(cfg: LlamaConfig, keys) -> Dict[str, str]:
    """HF tensor names of each leaf for a checkpoint holding ``keys``."""
    keys = list(keys)
    moe = [k for k in keys if ".block_sparse_moe." in k
           or ".mlp.experts." in k]
    if moe:
        raise NotImplementedError(
            f"MoE checkpoint ({moe[0]}): {MOE_CHECKPOINT_GAP}")
    # Gemma3 VLM checkpoints nest the text model under language_model; the
    # hub's actual naming is "language_model.model." (transformers <4.52
    # export), newer exports flatten to "model.language_model."
    pfx = ""
    for cand in ("model.language_model.", "language_model.model.",
                 "language_model.", "model."):
        if any(k.startswith(cand + "layers.") for k in keys):
            pfx = cand
            break
    lay = pfx + "layers.{}."
    # HF Llama calls the PRE-FFN norm "post_attention_layernorm"; Gemma2's
    # sandwich layout has four norms and names the pre-FFN one
    # "pre_feedforward_layernorm" instead
    ln2 = ("pre_feedforward_layernorm" if cfg.sandwich_norms
           else "post_attention_layernorm")
    # the VLM nesting puts lm_head BESIDE the inner model
    # ("language_model.lm_head.weight"), not under the layer prefix
    head = next((k for k in ("lm_head.weight", f"{pfx}lm_head.weight",
                             pfx.rsplit("model.", 1)[0] + "lm_head.weight")
                 if k in keys), f"{pfx}lm_head.weight")
    names = {
        "embed": f"{pfx}embed_tokens.weight",
        "final_norm": f"{pfx}norm.weight", "lm_head": head,
        "ln1": lay + "input_layernorm.weight", "ln2": lay + f"{ln2}.weight",
        "ln1_post": lay + "post_attention_layernorm.weight",
        "ln2_post": lay + "post_feedforward_layernorm.weight",
        "ln_q": lay + "self_attn.q_norm.weight",
        "ln_k": lay + "self_attn.k_norm.weight",
    }
    for leaf, mod in (("wq", "self_attn.q_proj"), ("wk", "self_attn.k_proj"),
                      ("wv", "self_attn.v_proj"), ("wo", "self_attn.o_proj"),
                      ("wg", "mlp.gate_proj"), ("wu", "mlp.up_proj"),
                      ("wd", "mlp.down_proj")):
        names[leaf] = lay + f"{mod}.weight"
    for leaf, mod in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj")):
        names[leaf] = lay + f"self_attn.{mod}.bias"
    return names


class _Stage:
    """Two host blocks that every source passes through by rows, pinned
    when the target is a card: a block is refilled only once the upload
    that read it has completed, so reading the next rows (from the file,
    or out of a dequantized tensor) overlaps the previous upload, and the
    host holds two blocks whatever the model's size."""

    def __init__(self, device: torch.device):
        self.device = device
        self.blocks = [torch.empty(0, dtype=torch.uint8) for _ in range(2)]
        self.done: list = [None, None]
        self.k = 0

    def _block(self, nbytes: int) -> torch.Tensor:
        k, self.k = self.k, self.k ^ 1
        if self.done[k] is not None:
            # dynalint: ok(host-sync) weight load: a staging block is refilled
            # only once the upload that read it completed (two blocks in
            # flight)
            self.done[k].synchronize()
            self.done[k] = None
        if self.blocks[k].numel() < nbytes:
            self.blocks[k] = torch.empty(
                max(nbytes, STAGE_BYTES), dtype=torch.uint8,
                pin_memory=self.device.type == "cuda")
        return self.blocks[k]

    def rows(self, src: Source, f, r0: int, r1: int,
             row: int) -> torch.Tensor:
        """Rows ``r0:r1`` (``row`` elements each) of ``src`` on the
        target device, in the source's dtype."""
        if isinstance(src, torch.Tensor) and self.device.type == "cpu":
            return src.reshape(-1, row)[r0:r1]
        nbytes = (r1 - r0) * row * src.element_size()
        block = self._block(nbytes)[:nbytes]
        if isinstance(src, RawTensor):
            src.read(f, r0 * row * src.element_size(), block)
        else:
            block.view(src.dtype).copy_(src.reshape(-1)[r0 * row:r1 * row])
        host = block.view(src.dtype).view(r1 - r0, row)
        if self.device.type == "cpu":
            return host
        out = host.to(self.device, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        self.done[self.k ^ 1] = ev
        return out


def _source_cut(name: str, full, cut):
    """A rank's cut ``(axis, start, stop)`` of one source tensor's leaf
    (``full`` = the leaf's whole per-layer shape) as a range of the
    source's rows or columns in its HF/GGUF layout: ``("rows" | "cols",
    lo, hi)``, or None."""
    if cut is None:
        return None
    axis, a, b = cut
    n_in = 2 if name == "wo" else 1
    if name in _TRANSPOSED and axis < n_in:
        # the leaf's "in" dims are the source's columns
        unit = math.prod(full[axis + 1:n_in])
        return "cols", a * unit, b * unit
    unit = math.prod(full[axis + 1:])
    return "rows", a * unit, b * unit


def _place(leaf: torch.Tensor, name: str, src: Source,
           stage: _Stage, full=None, cut=None) -> None:
    """Copy one source tensor (HF/GGUF layout) into ``leaf`` (one layer's
    slice of a stacked leaf, or a whole top-level leaf) by row blocks; the
    cast and the transpose run on the target device. ``full`` is the
    leaf's whole shape and ``cut`` the range of source rows or columns
    (:func:`_source_cut`) that ``leaf``, a tensor-parallel rank's shard,
    holds: only those rows are read, or only those columns kept."""
    shape = tuple(src.shape)
    numel = math.prod(shape)
    full = tuple(leaf.shape) if full is None else tuple(full)
    rows_cut = cut if cut is not None and cut[0] == "rows" else None
    cols_cut = cut if cut is not None and cut[0] == "cols" else None
    if name in _TRANSPOSED:
        # the leaf is [in, ...out]; wo's "in" is its leading (Hq, Dh)
        n_in = 2 if name == "wo" else 1
        fan_in = math.prod(full[:n_in])
        want = (math.prod(full) // fan_in, fan_in)
        ok = shape == want
        # [in, out] = src.T (of the shard's rows or columns)
        dst = leaf.view(math.prod(leaf.shape[:n_in]), -1)
    else:
        want = full
        ok = (shape == want if name == "embed"
              else numel == math.prod(full))
        dst = leaf.view(rows_cut[2] - rows_cut[1] if rows_cut
                        else (shape[0] if shape else 1), -1)
    if not ok:
        raise ValueError(f"{name}: checkpoint tensor of shape {shape} does "
                         f"not fit the model (expected {want})")
    n_rows = shape[0] if shape else 1
    row = numel // n_rows
    lo, hi = (rows_cut[1], rows_cut[2]) if rows_cut else (0, n_rows)
    step = max(1, STAGE_BYTES // max(1, row * src.element_size()))
    with (open(src.path, "rb", buffering=0) if isinstance(src, RawTensor)
          else contextlib.nullcontext()) as f:
        for r0 in range(lo, hi, step):
            r1 = min(hi, r0 + step)
            # dynalint: ok(flow-accounting) the staged upload of one leaf;
            # load_llama_params meters the whole tree as one weight_prefetch
            # flow (a GGUF cold load stays unmetered, as in the JAX package)
            chunk = stage.rows(src, f, r0, r1, row)
            if cols_cut:
                chunk = chunk[:, cols_cut[1]:cols_cut[2]]
            if name in _TRANSPOSED:
                dst[:, r0 - lo:r1 - lo].copy_(chunk.T)
            else:
                dst[r0 - lo:r1 - lo].copy_(chunk)


def place_llama_params(cfg: LlamaConfig,
                       fetch: Callable[[str], Source],
                       names: Dict[str, str],
                       device: Union[str, torch.device] = "cpu",
                       dtype: Optional[torch.dtype] = None,
                       has: Optional[Callable[[str], bool]] = None,
                       tp: int = 1, rank: int = 0) -> Dict[str, Any]:
    """The stacked tree of ``cfg`` on ``device``, each leaf allocated once
    and filled layer by layer from ``fetch(source name)`` (a tensor, or a
    :class:`RawTensor` read from its file). ``names`` maps each leaf to its
    source name (``{}`` = layer index); ``dtype`` (default ``cfg.dtype``)
    is the matrices', norms are f32. With ``tp > 1`` the tree is rank
    ``rank``'s shard (:func:`~dynamo_tpu_torch.models.llama.tp_cuts`):
    each leaf is allocated at its cut and takes only its rows or columns
    of the source, so no rank ever holds a whole sharded leaf."""
    if cfg.num_experts:
        raise NotImplementedError(f"MoE model: {MOE_CHECKPOINT_GAP}")
    device = torch.device(device) if isinstance(device, str) else device
    dt = cfg.dtype if dtype is None else dtype
    shapes = llama.param_shapes(cfg)
    local = llama.shard_shapes(cfg, tp, rank)
    cuts = llama.tp_cuts(cfg, tp, rank)
    stage = _Stage(device)

    def put(leaf: torch.Tensor, name: str, key: str, full, cut) -> None:
        if has is not None and not has(key):
            raise KeyError(f"checkpoint lacks tensor {key!r}")
        _place(leaf, name, fetch(key), stage, full,
               _source_cut(name, full, cut))

    def alloc(name: str, shape) -> torch.Tensor:
        return torch.empty(shape, dtype=torch.float32 if name in _F32
                           else dt, device=device)

    tree: Dict[str, Any] = {}
    with torch.no_grad():
        for name, shape in shapes.items():
            if name == "layers":
                continue
            tree[name] = alloc(name, local[name])
            put(tree[name], name, names[name], shape, cuts[name])
        layers = {n: alloc(n, s) for n, s in local["layers"].items()}
        # a stacked leaf's cut, on one layer's slice (the layer axis off)
        layer_cuts = {n: None if c is None else (c[0] - 1, c[1], c[2])
                      for n, c in cuts["layers"].items()}
        for i in range(cfg.num_layers):
            for n, leaf in layers.items():
                put(leaf[i], n, names[n].format(i), shapes["layers"][n][1:],
                    layer_cuts[n])
        tree["layers"] = layers
    llama.check_params(tree, cfg, tp, rank)
    return tree


def load_llama_params_host(path: str, cfg: LlamaConfig) -> Dict[str, Any]:
    """The stacked tree as CPU tensors from a safetensors dir, WITHOUT any
    device placement (the JAX package pins such trees in host RAM for a
    later hot swap; :func:`load_llama_params` places leaves directly)."""
    return _load(path, cfg, torch.device("cpu"))


def _load(path: str, cfg: LlamaConfig, device: torch.device,
          tp: int = 1, rank: int = 0) -> Dict[str, Any]:
    shards = ShardSet(path)
    keys = set(shards.keys())
    try:
        return place_llama_params(cfg, shards.raw, hf_names(cfg, keys),
                                  device, has=keys.__contains__, tp=tp,
                                  rank=rank)
    finally:
        shards.close()


def load_vision_tensors(path: str) -> Optional[Dict[str, torch.Tensor]]:
    """The Gemma3 vision tower and projector tensors of a safetensors dir
    (CPU tensors, names with the leading ``model.`` stripped when the
    checkpoint nests them as ``model.vision_tower...``, as the JAX engine
    strips them), or None when it holds none."""
    shards = ShardSet(path)
    vnames = [k for k in shards.keys()
              if "vision_tower" in k or "multi_modal_projector" in k]
    if not vnames:
        shards.close()
        return None
    strip = ("model." if any(k.startswith("model.vision_tower")
                             for k in vnames) else "")
    out = {k[len(strip):] if k.startswith(strip) else k:
           shards.get_tensor(k) for k in vnames}
    shards.close()
    return out


def _tree_nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def load_llama_params(path: str, cfg: LlamaConfig,
                      device: Union[str, torch.device] = "cuda",
                      tp: int = 1, rank: int = 0) -> Dict[str, Any]:
    """The tree placed on ``device`` (``cuda`` unless the caller asks for
    the CPU), leaf by leaf through pinned staging (rank ``rank``'s shard
    with ``tp > 1``); one ``weight_prefetch`` flow records the cold load,
    timed to the device's completion."""
    from ..obs.flows import record_flow

    dev = resolve_device(device)
    t0 = time.perf_counter()
    params = _load(path, cfg, dev, tp, rank)
    if dev.type == "cuda":
        # dynalint: ok(host-sync) cold load, once: the weight_prefetch flow is
        # timed to the device's completion
        torch.cuda.synchronize(dev)
    record_flow("weight_prefetch", _tree_nbytes(params),
                time.perf_counter() - t0)
    return params


def save_llama_params(path: str, params: Dict[str, Any],
                      cfg: LlamaConfig, shards: int = 1,
                      dtype: Optional[torch.dtype] = torch.float32) -> None:
    """Write params out in HF layout, as ``model.safetensors`` or, with
    ``shards > 1``, as ``model-0000k-of-0000n.safetensors`` split by layer.
    ``dtype`` casts every tensor (f32 by default, as the JAX package's
    writer does; None keeps each leaf's own)."""
    os.makedirs(path, exist_ok=True)
    L, D, Hq, Hkv, Dh = (cfg.num_layers, cfg.hidden_size, cfg.num_heads,
                         cfg.num_kv_heads, cfg.head_dim)
    lp = params["layers"]

    def t(x) -> torch.Tensor:
        x = llama._to_torch(x, torch.device("cpu"))
        return x if dtype is None else x.to(dtype)

    def lin(x) -> torch.Tensor:
        # [in, ...out] -> HF [out, in]; the writer makes it row-major
        x = t(x)
        return x.reshape(x.shape[0], -1).T

    top: Dict[str, torch.Tensor] = {
        "model.embed_tokens.weight": t(params["embed"]),
        "model.norm.weight": t(params["final_norm"]),
    }
    if "lm_head" in params:
        top["lm_head.weight"] = lin(params["lm_head"])
    per_layer = []
    sandwich = "ln1_post" in lp
    for i in range(L):
        p = f"model.layers.{i}."
        out = {p + "input_layernorm.weight": t(lp["ln1"][i])}
        if sandwich:
            # Gemma2 naming: ln2 is the PRE-ffw norm; post_attention is
            # the attn-branch output norm (see hf_names)
            out[p + "pre_feedforward_layernorm.weight"] = t(lp["ln2"][i])
            out[p + "post_attention_layernorm.weight"] = t(lp["ln1_post"][i])
            out[p + "post_feedforward_layernorm.weight"] = t(
                lp["ln2_post"][i])
        else:
            out[p + "post_attention_layernorm.weight"] = t(lp["ln2"][i])
        out[p + "self_attn.q_proj.weight"] = lin(lp["wq"][i])
        out[p + "self_attn.k_proj.weight"] = lin(lp["wk"][i])
        out[p + "self_attn.v_proj.weight"] = lin(lp["wv"][i])
        out[p + "self_attn.o_proj.weight"] = t(lp["wo"][i]).reshape(
            Hq * Dh, D).T
        out[p + "mlp.gate_proj.weight"] = lin(lp["wg"][i])
        out[p + "mlp.up_proj.weight"] = lin(lp["wu"][i])
        out[p + "mlp.down_proj.weight"] = lin(lp["wd"][i])
        if "ln_q" in lp:
            out[p + "self_attn.q_norm.weight"] = t(lp["ln_q"][i])
            out[p + "self_attn.k_norm.weight"] = t(lp["ln_k"][i])
        if "bq" in lp:
            for b, h in (("bq", Hq), ("bk", Hkv), ("bv", Hkv)):
                out[p + f"self_attn.{b[1]}_proj.bias"] = t(
                    lp[b][i]).reshape(h * Dh)
        per_layer.append(out)
    if shards <= 1:
        save_file({**top, **{k: v for d in per_layer for k, v in d.items()}},
                  os.path.join(path, "model.safetensors"))
        return
    groups = [[per_layer[i] for i in range(L) if i * shards // L == k]
              for k in range(shards)]
    for k, group in enumerate(groups):
        tensors = dict(top) if k == 0 else {}
        for d in group:
            tensors.update(d)
        save_file(tensors, os.path.join(
            path, f"model-{k + 1:05d}-of-{shards:05d}.safetensors"))
