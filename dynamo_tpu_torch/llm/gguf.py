"""GGUF model file support: metadata, config, tokenizer and tensor loading.

Parses the GGUF v2/v3 container format (llama.cpp's model distribution
format): header, string-keyed typed metadata, and the tensor directory. A
llama-family GGUF (llama/mistral/qwen2) maps onto :class:`~dynamo_tpu_torch.
models.llama.LlamaConfig` and the stacked param tree the engine serves;
F32/F16/BF16 tensors load directly; Q8_0/Q4_0/Q5_0/Q5_1 block-quantized and
Q4_K/Q5_K/Q6_K super-block-quantized tensors (the formats stock *_K_M
exports ship) dequantize at load, on the host in numpy as in the JAX
package. The file is memory-mapped: a tensor stored as F32/F16/BF16 loads
as a zero-copy view. :func:`load_llama_params_gguf` places the tree on a
device layer by layer (``engine/loader.py``); :func:`write_gguf` streams a
file out tensor by tensor.

Reference capability: lib/llm/src/gguf/{content,gguf_metadata,
gguf_tokenizer}.rs (~950 LoC: metadata parse, tokenizer build, model
config) — the reference loads GGUF for mistralrs/llamacpp engines and model
cards.
"""

from __future__ import annotations

import mmap
import os
import struct
from dataclasses import dataclass, field
from typing import Any, BinaryIO, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .safetensors_io import RawTensor

GGUF_MAGIC = 0x46554747  # "GGUF" little-endian

# metadata value types (gguf spec)
_U8, _I8, _U16, _I16, _U32, _I32, _F32, _BOOL, _STR, _ARR, _U64, _I64, _F64 \
    = range(13)

_SCALAR_FMT = {_U8: "<B", _I8: "<b", _U16: "<H", _I16: "<h", _U32: "<I",
               _I32: "<i", _F32: "<f", _BOOL: "<?", _U64: "<Q", _I64: "<q",
               _F64: "<d"}

# tensor ggml dtypes
_GGML_F32, _GGML_F16 = 0, 1
_GGML_Q4_0, _GGML_Q8_0, _GGML_BF16 = 2, 8, 16
_GGML_Q5_0, _GGML_Q5_1 = 6, 7
_GGML_Q4_K, _GGML_Q5_K, _GGML_Q6_K = 12, 13, 14
_GGML_NAMES = {0: "F32", 1: "F16", 2: "Q4_0", 3: "Q4_1", 6: "Q5_0",
               7: "Q5_1", 8: "Q8_0", 9: "Q8_1", 10: "Q2_K", 11: "Q3_K",
               12: "Q4_K", 13: "Q5_K", 14: "Q6_K", 16: "BF16"}
_RAW_TYPES = {_GGML_F32: torch.float32, _GGML_F16: torch.float16,
              _GGML_BF16: torch.bfloat16}
_QBLOCK = 32   # values per quant block (Q4_0 / Q8_0)
_QK_K = 256    # values per K-quant super-block


def _dequant_q8_0(raw: bytes, count: int) -> np.ndarray:
    """Q8_0: per 32-value block, one f16 scale + 32 int8 -> w = d * q."""
    nb = count // _QBLOCK
    rec = np.frombuffer(raw, dtype=np.dtype([("d", "<f2"),
                                             ("q", "i1", (_QBLOCK,))]),
                        count=nb)
    return (rec["d"].astype(np.float32)[:, None]
            * rec["q"].astype(np.float32)).reshape(count)


def _dequant_q4_0(raw: bytes, count: int) -> np.ndarray:
    """Q4_0: per 32-value block, one f16 scale + 16 bytes of nibbles ->
    w = d * (q - 8); low nibbles are values 0..15, high nibbles 16..31."""
    nb = count // _QBLOCK
    rec = np.frombuffer(raw, dtype=np.dtype([("d", "<f2"),
                                             ("q", "u1", (_QBLOCK // 2,))]),
                        count=nb)
    lo = (rec["q"] & 0x0F).astype(np.int8) - 8
    hi = (rec["q"] >> 4).astype(np.int8) - 8
    vals = np.concatenate([lo, hi], axis=1).astype(np.float32)
    return (rec["d"].astype(np.float32)[:, None] * vals).reshape(count)


def _q5_bits(qh: np.ndarray) -> np.ndarray:
    """[nb, 4] uint8 -> [nb, 32] the per-value 5th bit (llama.cpp order:
    bit i of the packed u32 belongs to value i; values 0..15 are low
    nibbles, 16..31 high nibbles)."""
    bits32 = qh.view(np.uint32).reshape(-1, 1)          # [nb, 1] LE
    idx = np.arange(32, dtype=np.uint32)[None, :]
    return ((bits32 >> idx) & 1).astype(np.uint8)        # [nb, 32]


def _dequant_q5_0(raw: bytes, count: int) -> np.ndarray:
    """Q5_0: f16 scale + 32 high bits + 16 nibble bytes; w = d*(q-16)."""
    nb = count // _QBLOCK
    rec = np.frombuffer(raw, dtype=np.dtype(
        [("d", "<f2"), ("qh", "u1", (4,)), ("q", "u1", (_QBLOCK // 2,))]),
        count=nb)
    h = _q5_bits(rec["qh"])
    lo = (rec["q"] & 0x0F) | (h[:, :16] << 4)
    hi = (rec["q"] >> 4) | (h[:, 16:] << 4)
    vals = np.concatenate([lo, hi], axis=1).astype(np.float32) - 16.0
    return (rec["d"].astype(np.float32)[:, None] * vals).reshape(count)


def _dequant_q5_1(raw: bytes, count: int) -> np.ndarray:
    """Q5_1: f16 scale + f16 min + 32 high bits + nibbles; w = d*q + m."""
    nb = count // _QBLOCK
    rec = np.frombuffer(raw, dtype=np.dtype(
        [("d", "<f2"), ("m", "<f2"), ("qh", "u1", (4,)),
         ("q", "u1", (_QBLOCK // 2,))]), count=nb)
    h = _q5_bits(rec["qh"])
    lo = (rec["q"] & 0x0F) | (h[:, :16] << 4)
    hi = (rec["q"] >> 4) | (h[:, 16:] << 4)
    vals = np.concatenate([lo, hi], axis=1).astype(np.float32)
    return (rec["d"].astype(np.float32)[:, None] * vals
            + rec["m"].astype(np.float32)[:, None]).reshape(count)


def _kquant_scale_min(scales: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Unpack the 12-byte 6-bit scale/min table of Q4_K/Q5_K super-blocks.
    scales: [nb, 12] uint8 -> (sc [nb, 8], mn [nb, 8]) float32."""
    s = scales.astype(np.uint16)
    sc = np.empty(s.shape[:-1] + (8,), np.uint16)
    mn = np.empty_like(sc)
    sc[..., :4] = s[..., 0:4] & 63
    mn[..., :4] = s[..., 4:8] & 63
    sc[..., 4:] = (s[..., 8:12] & 0x0F) | ((s[..., 0:4] >> 6) << 4)
    mn[..., 4:] = (s[..., 8:12] >> 4) | ((s[..., 4:8] >> 6) << 4)
    return sc.astype(np.float32), mn.astype(np.float32)


def _dequant_q4_k(raw: bytes, count: int) -> np.ndarray:
    """Q4_K: 256-value super-blocks of 8 sub-blocks; w = d*sc*q - dmin*m,
    q in 0..15. Layout per 64 values: 32 bytes, low nibbles -> sub-block
    2j, high nibbles -> sub-block 2j+1 (llama.cpp dequantize_row_q4_K)."""
    nb = count // _QK_K
    rec = np.frombuffer(raw, dtype=np.dtype(
        [("d", "<f2"), ("dmin", "<f2"), ("scales", "u1", (12,)),
         ("qs", "u1", (128,))]), count=nb)
    sc, mn = _kquant_scale_min(rec["scales"])
    d = rec["d"].astype(np.float32)[:, None] * sc       # [nb, 8]
    m = rec["dmin"].astype(np.float32)[:, None] * mn
    qs = rec["qs"].reshape(nb, 4, 32)                   # 4 groups of 64
    lo = (qs & 0x0F).astype(np.float32)                 # sub-block 2j
    hi = (qs >> 4).astype(np.float32)                   # sub-block 2j+1
    q = np.stack([lo, hi], axis=2).reshape(nb, 8, 32)
    out = d[:, :, None] * q - m[:, :, None]
    return out.reshape(count)


def _dequant_q5_k(raw: bytes, count: int) -> np.ndarray:
    """Q5_K: Q4_K's scale scheme + one high bit per value from qh."""
    nb = count // _QK_K
    rec = np.frombuffer(raw, dtype=np.dtype(
        [("d", "<f2"), ("dmin", "<f2"), ("scales", "u1", (12,)),
         ("qh", "u1", (32,)), ("qs", "u1", (128,))]), count=nb)
    sc, mn = _kquant_scale_min(rec["scales"])
    d = rec["d"].astype(np.float32)[:, None] * sc
    m = rec["dmin"].astype(np.float32)[:, None] * mn
    qs = rec["qs"].reshape(nb, 4, 32)
    qh = rec["qh"][:, None, :]                          # [nb, 1, 32]
    group = np.arange(4)[None, :, None]
    lo = (qs & 0x0F) + (((qh >> (2 * group)) & 1) << 4)       # u1 bit
    hi = (qs >> 4) + (((qh >> (2 * group + 1)) & 1) << 4)     # u2 bit
    q = np.stack([lo, hi], axis=2).reshape(nb, 8, 32).astype(np.float32)
    out = d[:, :, None] * q - m[:, :, None]
    return out.reshape(count)


def _dequant_q6_k(raw: bytes, count: int) -> np.ndarray:
    """Q6_K: 256-value super-blocks, 16 int8 scales, 6-bit values
    (4 low bits in ql, 2 high bits in qh); w = d * sc * (q - 32)."""
    nb = count // _QK_K
    rec = np.frombuffer(raw, dtype=np.dtype(
        [("ql", "u1", (128,)), ("qh", "u1", (64,)),
         ("scales", "i1", (16,)), ("d", "<f2")]), count=nb)
    d = rec["d"].astype(np.float32)                 # [nb]
    sc = rec["scales"].astype(np.float32).reshape(nb, 2, 8)  # per 128-half
    ql = rec["ql"].reshape(nb, 2, 64)               # 64 bytes per half
    qh = rec["qh"].reshape(nb, 2, 32)               # 32 bytes per half
    l = np.arange(32)
    out = np.empty((nb, 2, 4, 32), np.float32)      # [nb, half, quarter, l]
    for quarter in range(4):
        src = ql[:, :, 32 * (quarter & 1):32 * (quarter & 1) + 32]
        nib = (src & 0x0F) if quarter < 2 else (src >> 4)
        q = (nib | (((qh >> (2 * quarter)) & 3) << 4)).astype(np.int32) - 32
        scale = sc[:, :, 2 * quarter + l // 16]     # [nb, 2, 32]
        out[:, :, quarter, :] = d[:, None, None] * scale * q
    return out.reshape(count)


_KQUANT_BYTES = {_GGML_Q4_K: 144, _GGML_Q5_K: 176, _GGML_Q6_K: 210}
_KQUANT_FNS = {_GGML_Q4_K: _dequant_q4_k, _GGML_Q5_K: _dequant_q5_k,
               _GGML_Q6_K: _dequant_q6_k}
# 32-value block formats: ggml type -> (bytes per block, dequant fn)
_QBLOCK_FMT = {
    _GGML_Q8_0: (2 + _QBLOCK, _dequant_q8_0),
    _GGML_Q4_0: (2 + _QBLOCK // 2, _dequant_q4_0),
    _GGML_Q5_0: (2 + 4 + _QBLOCK // 2, _dequant_q5_0),
    _GGML_Q5_1: (4 + 4 + _QBLOCK // 2, _dequant_q5_1),
}


@dataclass
class GGUFTensorInfo:
    name: str
    shape: Tuple[int, ...]      # logical shape, row-major (numpy order)
    ggml_type: int
    offset: int                 # within the data section


@dataclass
class GGUFFile:
    version: int
    metadata: Dict[str, Any]
    tensors: Dict[str, GGUFTensorInfo]
    data_start: int
    path: str
    _mm: Optional[mmap.mmap] = field(default=None, repr=False, compare=False)

    # ------------------------------------------------------------------
    def architecture(self) -> str:
        return self.metadata.get("general.architecture", "")

    def llama_config(self):
        """Map llama-family metadata onto LlamaConfig. Covers the
        llama-shaped architectures GGUF ships (llama/mistral identical;
        qwen2 adds qkv bias)."""
        from ..models.llama import LlamaConfig

        md = self.metadata
        arch = self.architecture()
        if arch not in ("llama", "mistral", "qwen2", "gemma", "gemma2",
                        "gemma3"):
            raise ValueError(f"not a llama-family GGUF: {arch!r}")

        def g(key, default=None):
            return md.get(f"{arch}.{key}", default)

        n_heads = int(g("attention.head_count"))
        emb = int(g("embedding_length"))
        vocab = md.get("tokenizer.ggml.tokens")
        vocab_size = (int(md[f"{arch}.vocab_size"])
                      if f"{arch}.vocab_size" in md
                      else len(vocab) if vocab else 32000)
        gemma2 = arch == "gemma2"
        gemma3 = arch == "gemma3"
        gemma_any = arch in ("gemma", "gemma2", "gemma3")
        # rope scaling: gemma3 4b/12b/27b and linear-scaled llamas carry
        # {arch}.rope.scaling.{type,factor}; ignoring them would run rope at
        # unscaled (e.g. 8x-too-fast) frequencies — silently wrong logits at
        # every position. llama3-style NTK scaling is exported by llama.cpp
        # as a rope_freqs.weight tensor of per-frequency divisors instead.
        rope_scaling = None
        scale_type = g("rope.scaling.type")
        if scale_type in (None, "", "none"):
            pass
        elif scale_type == "linear":
            rope_scaling = {"rope_type": "linear",
                            "factor": float(g("rope.scaling.factor", 1.0))}
        else:
            # yarn etc.: refusing beats serving wrong positions for every
            # token (ref lib/llm/src/gguf/* takes the same bail-hard stance
            # on unknown tokenizer models)
            raise NotImplementedError(
                f"GGUF rope scaling type {scale_type!r} is not supported "
                f"(linear and llama3-style rope_freqs factors are); "
                f"serving without it would be silently wrong")
        for tname in ("rope_freqs.weight", "rope_factors_long.weight"):
            if tname in self.tensors:
                if tname != "rope_freqs.weight":
                    raise NotImplementedError(
                        f"GGUF per-position rope factor tensor {tname!r} "
                        f"(longrope) is not supported")
                factors = self.load_tensor(tname).double().numpy().ravel()
                if rope_scaling is not None:
                    # ggml applies freq_scale (linear) AND freq_factors
                    # together (ggml_rope_ext); fold the linear factor into
                    # the per-frequency divisors rather than dropping it
                    factors = factors * rope_scaling["factor"]
                rope_scaling = {"rope_type": "ggml_factors",
                                "factors": factors.tolist()}
        return LlamaConfig(
            tie_embeddings="output.weight" not in self.tensors,
            attention_bias="blk.0.attn_q.bias" in self.tensors,
            hidden_act="gelu_tanh" if gemma_any else "silu",
            # llama.cpp's gemma converter bakes the +1 into norm weights at
            # export, so GGUF files store the EFFECTIVE scale — applying the
            # offset again would compute 2+w
            norm_offset=False,
            embed_scale=gemma_any,
            sandwich_norms=gemma2 or gemma3,
            qk_norm=gemma3,
            sliding_pattern=(6 if gemma3 else 2),
            rope_local_theta=(float(g("rope.local.freq_base", 10000.0))
                              if gemma3 else None),
            attn_logit_softcap=(float(g("attn_logit_softcapping", 50.0))
                                if gemma2 else None),
            final_logit_softcap=(float(g("final_logit_softcapping", 30.0))
                                 if gemma2 else None),
            sliding_window=(int(g("attention.sliding_window",
                                  1024 if gemma3 else 4096))
                            if gemma2 or gemma3 else None),
            # attention scale: rsqrt(head_dim) for gemma2 2b/9b, but 27b
            # uses rsqrt(hidden/heads)=rsqrt(144). GGUF metadata carries no
            # scale key, so mirror llama.cpp's rule: the 27b variant (its
            # unique 46-layer stack) gets hidden/heads; honor an explicit
            # key when an exporter provides one. Serving 27b at the 2b/9b
            # scale would be ~6% off on every attention score — silently.
            # the 27B variants scale by rsqrt(hidden/heads), not
            # rsqrt(head_dim): gemma2-27b = 46 layers, gemma3-27b = 62
            # (llama.cpp hardcodes the same rule; GGUF carries no key)
            query_pre_attn_scalar=(
                float(md[f"{arch}.attention.query_pre_attn_scalar"])
                if f"{arch}.attention.query_pre_attn_scalar" in md
                else float(emb) / n_heads
                if ((gemma2 and int(g("block_count")) == 46)
                    or (gemma3 and int(g("block_count")) == 62))
                else None),
            rope_scaling=rope_scaling,
            vocab_size=vocab_size,
            hidden_size=emb,
            num_layers=int(g("block_count")),
            num_heads=n_heads,
            num_kv_heads=int(g("attention.head_count_kv", n_heads)),
            head_dim=int(g("attention.key_length", emb // n_heads)),
            intermediate_size=int(g("feed_forward_length")),
            rope_theta=float(g("rope.freq_base", 10000.0)),
            rms_eps=float(g("attention.layer_norm_rms_epsilon", 1e-5)),
            max_position=int(g("context_length", 8192)),
        )

    def tokenizer_vocab(self) -> Optional[List[str]]:
        return self.metadata.get("tokenizer.ggml.tokens")

    def load_tensor(self, name: str) -> torch.Tensor:
        """The tensor as a CPU torch tensor in numpy order: F32/F16/BF16 as
        stored (a zero-copy view of the mapping), quantized types
        dequantized to f32."""
        info = self.tensors[name]
        count = int(np.prod(info.shape)) if info.shape else 1
        if info.ggml_type in _QBLOCK_FMT:
            # block-quantized weights dequantize to f32 at load (the engine
            # casts to its compute dtype; on-device quantized matmuls are a
            # separate optimization, this is the loading capability)
            bpb, deq_fn = _QBLOCK_FMT[info.ggml_type]
            raw = self._read(self.data_start + info.offset,
                             count // _QBLOCK * bpb)
            return torch.from_numpy(deq_fn(raw, count).reshape(info.shape))
        if info.ggml_type in _KQUANT_FNS:
            raw = self._read(self.data_start + info.offset,
                             count // _QK_K * _KQUANT_BYTES[info.ggml_type])
            return torch.from_numpy(_KQUANT_FNS[info.ggml_type](raw, count)
                                    .reshape(info.shape))
        if info.ggml_type == _GGML_BF16:
            raw = self._read(self.data_start + info.offset, count * 2)
            return torch.from_numpy(np.frombuffer(raw, dtype="<u2").reshape(
                info.shape)).view(torch.bfloat16)
        if info.ggml_type not in (_GGML_F32, _GGML_F16):
            tname = _GGML_NAMES.get(info.ggml_type, str(info.ggml_type))
            raise NotImplementedError(
                f"tensor {name!r} uses unsupported ggml type {tname}; "
                f"F32/F16/BF16/Q8_0/Q4_0/Q5_0/Q5_1/Q4_K/Q5_K/Q6_K are loadable "
                f"(dequantize or re-export the model)")
        dtype = np.dtype("<f4") if info.ggml_type == _GGML_F32 \
            else np.dtype("<f2")
        raw = self._read(self.data_start + info.offset,
                         count * dtype.itemsize)
        return torch.from_numpy(np.frombuffer(raw, dtype=dtype).reshape(
            info.shape))

    def _read(self, offset: int, size: int) -> memoryview:
        # one copy-on-write mapping for every tensor: views stay zero-copy
        # and writable for torch, and the file is never modified
        if self._mm is None:
            with open(self.path, "rb") as f:
                self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        if offset + size > len(self._mm):
            raise ValueError(f"{self.path}: tensor data {offset}+{size} "
                             f"past the end of the file")
        return memoryview(self._mm)[offset:offset + size]

    def source(self, name: str) -> Union[torch.Tensor, RawTensor]:
        """What a loader reads the tensor from: where its bytes lie for a
        type stored as is (F32/F16/BF16), else the dequantized tensor."""
        info = self.tensors[name]
        if info.ggml_type not in _RAW_TYPES:
            return self.load_tensor(name)
        return RawTensor(self.path, self.data_start + info.offset,
                         _RAW_TYPES[info.ggml_type], info.shape)

    def close(self) -> None:
        # views handed out keep the mapping alive until they are freed
        self._mm = None


# ---------------------------------------------------------------------------
# parse
# ---------------------------------------------------------------------------

def _read_str(f: BinaryIO) -> str:
    (n,) = struct.unpack("<Q", f.read(8))
    return f.read(n).decode("utf-8", errors="replace")


def _read_value(f: BinaryIO, vtype: int) -> Any:
    if vtype in _SCALAR_FMT:
        fmt = _SCALAR_FMT[vtype]
        (v,) = struct.unpack(fmt, f.read(struct.calcsize(fmt)))
        return v
    if vtype == _STR:
        return _read_str(f)
    if vtype == _ARR:
        (etype,) = struct.unpack("<I", f.read(4))
        (count,) = struct.unpack("<Q", f.read(8))
        return [_read_value(f, etype) for _ in range(count)]
    raise ValueError(f"unknown gguf metadata type {vtype}")


def read_gguf(path: str) -> GGUFFile:
    """Parse header + metadata + tensor directory (tensors load lazily)."""
    with open(path, "rb") as f:
        magic, version = struct.unpack("<II", f.read(8))
        if magic != GGUF_MAGIC:
            raise ValueError(f"{path}: not a GGUF file")
        if version not in (2, 3):
            raise ValueError(f"{path}: unsupported GGUF version {version}")
        n_tensors, n_kv = struct.unpack("<QQ", f.read(16))

        metadata: Dict[str, Any] = {}
        for _ in range(n_kv):
            key = _read_str(f)
            (vtype,) = struct.unpack("<I", f.read(4))
            metadata[key] = _read_value(f, vtype)

        tensors: Dict[str, GGUFTensorInfo] = {}
        for _ in range(n_tensors):
            name = _read_str(f)
            (ndim,) = struct.unpack("<I", f.read(4))
            dims = struct.unpack(f"<{ndim}Q", f.read(8 * ndim))
            (ggml_type,) = struct.unpack("<I", f.read(4))
            (offset,) = struct.unpack("<Q", f.read(8))
            # gguf stores dims innermost-first; numpy wants outermost-first
            tensors[name] = GGUFTensorInfo(name, tuple(reversed(dims)),
                                           ggml_type, offset)

        align = int(metadata.get("general.alignment", 32))
        pos = f.tell()
        data_start = (pos + align - 1) // align * align
    return GGUFFile(version, metadata, tensors, data_start, path)


# ---------------------------------------------------------------------------
# llama param mapping (gguf tensor names -> our stacked pytree)
# ---------------------------------------------------------------------------

def load_llama_params_gguf(path: str, cfg=None,
                           device: Union[str, torch.device, None] = None,
                           dtype: Optional[torch.dtype] = None
                           ) -> Tuple[Any, Dict[str, Any]]:
    """Load a llama GGUF into (config, stacked param tree), placed on
    ``device`` (the host when None) layer by layer, in ``dtype`` (the
    config's, bf16 by default) for the matrices and f32 for the norms."""
    from ..engine.loader import GGUF_NAMES, place_llama_params

    g = read_gguf(path)
    try:
        if cfg is None:
            cfg = g.llama_config()
        params = place_llama_params(
            cfg, g.source, GGUF_NAMES,
            device=torch.device("cpu") if device is None else device,
            dtype=dtype, has=lambda key: key in g.tensors)
    finally:
        g.close()
    return cfg, params


def _metadata_value(v: Any) -> bytes:
    def pstr(s: str) -> bytes:
        b = s.encode()
        return struct.pack("<Q", len(b)) + b

    if isinstance(v, bool):
        return struct.pack("<I", _BOOL) + struct.pack("<?", v)
    if isinstance(v, int):
        return struct.pack("<I", _I64) + struct.pack("<q", v)
    if isinstance(v, float):
        return struct.pack("<I", _F64) + struct.pack("<d", v)
    if isinstance(v, str):
        return struct.pack("<I", _STR) + pstr(v)
    if isinstance(v, (list, tuple)):
        head = struct.pack("<I", _ARR)
        if v and isinstance(v[0], str):
            return (head + struct.pack("<I", _STR) + struct.pack("<Q", len(v))
                    + b"".join(pstr(x) for x in v))
        if any(isinstance(x, float) for x in v):
            # scores and the like stay floats (as llama.cpp writes them)
            return (head + struct.pack("<I", _F32) + struct.pack("<Q", len(v))
                    + np.asarray(v, dtype="<f4").tobytes())
        return (head + struct.pack("<I", _I64) + struct.pack("<Q", len(v))
                + np.asarray(v, dtype="<i8").tobytes())
    raise TypeError(f"unsupported metadata value {type(v)}")


def write_gguf(path: str, metadata: Dict[str, Any],
               tensors: Dict[str, Union[np.ndarray, torch.Tensor]]) -> None:
    """Minimal GGUF v3 writer (F32 tensors) — test fixture / export path.
    Integers are written as I64 and floats as F64, as the JAX package's
    writer does; a list holding a float is an F32 array (the JAX writer
    truncates such lists to integers). Tensors stream to the file one at a
    time."""
    def pstr(s: str) -> bytes:
        b = s.encode()
        return struct.pack("<Q", len(b)) + b

    def f32(a) -> np.ndarray:
        if isinstance(a, torch.Tensor):
            a = a.detach().to("cpu", torch.float32).numpy()
        return np.ascontiguousarray(a, dtype=np.float32)

    align = 32
    head = bytearray()
    head += struct.pack("<II", GGUF_MAGIC, 3)
    head += struct.pack("<QQ", len(tensors), len(metadata) + 1)
    head += pstr("general.alignment") + struct.pack("<I", _I64) \
        + struct.pack("<q", align)
    for k, v in metadata.items():
        head += pstr(k) + _metadata_value(v)
    off = 0
    for name, arr in tensors.items():
        shape = tuple(arr.shape)
        head += pstr(name)
        head += struct.pack("<I", len(shape))
        for d in reversed(shape):          # gguf dims innermost-first
            head += struct.pack("<Q", d)
        head += struct.pack("<I", _GGML_F32)
        head += struct.pack("<Q", off)
        nbytes = 4 * int(np.prod(shape, dtype=np.int64))
        off += nbytes + (-nbytes) % align
    head += b"\x00" * ((-len(head)) % align)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(head)
        for arr in tensors.values():
            a = f32(arr)
            f.write(memoryview(a.reshape(-1).view(np.uint8)))
            f.write(b"\x00" * ((-a.nbytes) % align))
    os.replace(tmp, path)
