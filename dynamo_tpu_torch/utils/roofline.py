"""Roofline accounting: how close is each dispatch to the hardware?

Three pieces, consumed by the engine's goodput telemetry
(``dyn_mfu`` / ``dyn_mbu`` / ``dyn_hbm_gbps``):

1. **Peaks** — per-platform peak dense bf16 FLOP/s and HBM bandwidth.
   CUDA cards come from a static table of datasheet figures; on the CPU
   the peaks are *calibrated once* with a short matmul / memcpy
   measurement so MFU/MBU stay meaningful rather than reading 0.0001
   against an imaginary card. ``DYN_PEAK_FLOPS`` / ``DYN_PEAK_GBPS``
   override everything (deployments that know their part better than the
   table).

2. **Analytic cost model** — FLOPs and HBM bytes of one engine dispatch,
   computed from the model config and the dispatch's actual lane lengths.
   Matmul FLOPs count dense projections + MLP (active experts only for
   MoE) + the LM head where the program really computes it; attention
   score/value FLOPs and KV reads are **window-clamped** on sliding-window
   layers (a Gemma-style 5:1 sliding stack reads a fraction of the KV a
   full-attention stack would). Bytes = weights streamed once per
   sequential step + KV read/written. Activations and padding lanes are
   deliberately excluded: the numbers are *useful* work, so bucket padding
   shows up as lost MFU instead of being flattered away.

3. :class:`GoodputMeter` — accumulates (flops, bytes, busy-time) per
   dispatch and answers with windowed MFU / MBU / achieved-GB/s rates plus
   lifetime totals.

The model is an estimate, not a profiler: it exists so "are we 4% or 40%
of the card" is answerable from /metrics on every deployment.

The JAX package also wraps each freshly built program to time its first
(compiling) call (``instrument_compile``); the port traces no programs, so
it has no counterpart until decode-step CUDA-graph capture gives a compile
cost to count. :func:`record_compile` stays for that.
"""

from __future__ import annotations

import collections
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

# lower-cased device-name substring -> (peak dense bf16 FLOP/s, peak HBM
# bytes/s) per card: datasheet figures, not measurements. NVIDIA's H100
# SXM datasheet: 989 TFLOP/s dense bf16 (without sparsity), HBM3 at
# 3.35 TB/s, at the full 700 W power limit.
PEAKS_BY_DEVICE_KIND: Tuple[Tuple[str, float, float], ...] = (
    ("h100", 989e12, 3.35e12),
)


@dataclass(frozen=True)
class Peaks:
    """What the attached hardware could theoretically sustain."""

    flops: float          # dense bf16 FLOP/s
    hbm_bytes: float      # main-memory bytes/s
    source: str           # "datasheet:<kind>" | "calibrated-cpu" | "env"


def _env_peaks() -> Optional[Peaks]:
    f = os.environ.get("DYN_PEAK_FLOPS")
    b = os.environ.get("DYN_PEAK_GBPS")
    if not (f and b):
        return None
    try:
        return Peaks(float(f), float(b) * 1e9, "env")
    except ValueError:
        return None


def _calibrate_cpu() -> Peaks:
    """Measure this host once: matmul FLOP/s (BLAS) and memcpy bandwidth.

    Deliberately short (~tens of ms): the point is a denominator within
    ~2x of the truth, so CPU MFU/MBU read as real percentages instead of
    noise against a card's peak. Best-of-N to shave scheduler jitter."""
    import numpy as np

    n = 384
    a = np.random.default_rng(0).standard_normal((n, n), dtype=np.float32)
    b = np.ascontiguousarray(a.T)
    a @ b                                    # warm the BLAS threads
    flops = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        a @ b
        dt = time.perf_counter() - t0
        flops = max(flops, 2.0 * n * n * n / max(dt, 1e-9))
    src = np.zeros(32 << 20, dtype=np.uint8)  # 32 MiB: past typical LLC
    dst = np.empty_like(src)
    bw = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        np.copyto(dst, src)
        dt = time.perf_counter() - t0
        # a copy moves 2x the buffer (read + write)
        bw = max(bw, 2.0 * src.nbytes / max(dt, 1e-9))
    return Peaks(flops, bw, "calibrated-cpu")


_CAL_CACHE: Dict[str, Peaks] = {}


def detect_peaks(device_kind: Optional[str] = None,
                 platform: Optional[str] = None) -> Peaks:
    """Peaks for the attached device. ``device_kind``/``platform`` default
    to CUDA card 0 (``torch.cuda.get_device_name``, platform ``"cuda"``),
    or the CPU when torch sees no card; passing them explicitly keeps this
    testable without touching a backend. A card missing from the table
    gets the calibrated host figures, as in the JAX package."""
    env = _env_peaks()
    if env is not None:
        return env
    if device_kind is None or platform is None:
        import torch

        if torch.cuda.is_available():
            device_kind, platform = torch.cuda.get_device_name(0), "cuda"
        else:
            device_kind, platform = "cpu", "cpu"
    if platform not in ("cpu",):
        k = device_kind.lower()
        for sub, pf, pb in PEAKS_BY_DEVICE_KIND:
            if sub in k:
                return Peaks(pf, pb, f"datasheet:{sub}")
    if "cpu" not in _CAL_CACHE:
        _CAL_CACHE["cpu"] = _calibrate_cpu()
    return _CAL_CACHE["cpu"]


# ---------------------------------------------------------------------------
# analytic dispatch cost model
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ModelCosts:
    """Per-config constants the dispatch cost functions combine.

    ``window_groups`` collapses the layer stack into ``(window, count)``
    groups — ``None`` = full attention — so the per-token clamped-length
    sum is O(distinct windows), not O(layers), on the engine hot path.
    All FLOP counts use 2 FLOPs per MAC."""

    mat_flops_per_token: float   # dense projections + (active-expert) MLP
    lm_head_flops: float         # 2 * D * V, charged where the head runs
    attn_flops_coef: float       # 4 * Hq * Dh: score+value FLOPs per kv pos
    kv_bytes_per_tok_layer: float  # 2 (k+v) * Hkv * Dh * esize
    num_layers: int
    window_groups: Tuple[Tuple[Optional[int], int], ...]
    weight_bytes: float          # total param bytes streamed per step


def dtype_size(dtype: Any) -> int:
    """Bytes per element of a torch dtype, or of anything numpy reads as
    a dtype."""
    import torch

    if isinstance(dtype, torch.dtype):
        return int(torch.empty((), dtype=dtype).element_size())
    import numpy as np

    return int(np.dtype(dtype).itemsize)


def model_costs(m: Any, weight_bytes: Optional[float] = None) -> ModelCosts:
    """Build :class:`ModelCosts` from a ``LlamaConfig``-shaped object.
    ``weight_bytes`` overrides the analytic parameter count with the exact
    loaded size when the caller has it (the engine does)."""
    D, V = m.hidden_size, m.vocab_size
    Hq, Hkv, Dh = m.num_heads, m.num_kv_heads, m.head_dim
    L, I = m.num_layers, m.intermediate_size
    esize = dtype_size(m.dtype)
    attn_proj = D * Hq * Dh + 2 * D * Hkv * Dh + Hq * Dh * D
    if getattr(m, "num_experts", 0):
        mlp_active = m.experts_per_token * 3 * D * I
        mlp_weights = m.num_experts * 3 * D * I
    else:
        mlp_active = mlp_weights = 3 * D * I
    if weight_bytes is None:
        n_params = V * D + L * (attn_proj + mlp_weights)
        if not getattr(m, "tie_embeddings", False):
            n_params += D * V
        weight_bytes = float(n_params) * esize
    groups: Dict[Optional[int], int] = {}
    for layer in range(L):
        w = m.sliding_window if m.layer_sliding(layer) else None
        groups[w] = groups.get(w, 0) + 1
    return ModelCosts(
        mat_flops_per_token=2.0 * L * (attn_proj + mlp_active),
        lm_head_flops=2.0 * D * V,
        attn_flops_coef=4.0 * Hq * Dh,
        kv_bytes_per_tok_layer=2.0 * Hkv * Dh * esize,
        num_layers=L,
        window_groups=tuple(sorted(groups.items(),
                                   key=lambda kv: (kv[0] is None, kv[0]))),
        weight_bytes=float(weight_bytes),
    )


def _clamped_len_sum(groups: Sequence[Tuple[Optional[int], int]],
                     s: int) -> float:
    """sum over layers of min(s, window): the kv positions one query token
    at kv-length ``s`` actually touches across the layer stack."""
    return float(sum((min(s, w) if w is not None else s) * n
                     for w, n in groups))


def decode_cost(c: ModelCosts, lengths: Iterable[int], steps: int
                ) -> Tuple[float, float, int]:
    """(flops, bytes, tokens) of a multi-step decode dispatch: ``steps``
    scan iterations over the given per-lane kv lengths (active lanes only).
    Weights stream once per scan step; every token computes the LM head."""
    flops = 0.0
    kv_read = 0.0
    lanes = 0
    for s0 in lengths:
        lanes += 1
        for j in range(steps):
            touched = _clamped_len_sum(c.window_groups, s0 + j)
            flops += (c.mat_flops_per_token + c.lm_head_flops
                      + c.attn_flops_coef * touched)
            kv_read += touched * c.kv_bytes_per_tok_layer
    tokens = lanes * steps
    bytes_ = (steps * c.weight_bytes + kv_read
              + tokens * c.num_layers * c.kv_bytes_per_tok_layer)
    return flops, bytes_, tokens


def prefill_cost(c: ModelCosts, spans: Iterable[Tuple[int, int]]
                 ) -> Tuple[float, float, int]:
    """(flops, bytes, tokens) of one batched prefill dispatch over
    ``(start, count)`` prompt spans (per active lane). The program computes
    the LM head once per lane (at ``logits_idx``) regardless of whether the
    host keeps the sample, so it is charged once per lane."""
    flops = 0.0
    kv_read = 0.0
    tokens = 0
    for start, count in spans:
        tokens += count
        flops += count * c.mat_flops_per_token + c.lm_head_flops
        for p in range(start, start + count):
            touched = _clamped_len_sum(c.window_groups, p + 1)
            flops += c.attn_flops_coef * touched
            kv_read += touched * c.kv_bytes_per_tok_layer
    bytes_ = (c.weight_bytes + kv_read
              + tokens * c.num_layers * c.kv_bytes_per_tok_layer)
    return flops, bytes_, tokens


def verify_cost(c: ModelCosts, lengths: Iterable[int], t: int
                ) -> Tuple[float, float, int]:
    """(flops, bytes, tokens) of a speculative verify dispatch: ONE forward
    over ``t = k+1`` positions per active lane, LM head at every position
    (the verify sampler consumes all of them)."""
    flops = 0.0
    kv_read = 0.0
    lanes = 0
    for s0 in lengths:
        lanes += 1
        for j in range(t):
            touched = _clamped_len_sum(c.window_groups, s0 + j)
            flops += (c.mat_flops_per_token + c.lm_head_flops
                      + c.attn_flops_coef * touched)
            kv_read += touched * c.kv_bytes_per_tok_layer
    tokens = lanes * t
    bytes_ = (c.weight_bytes + kv_read
              + tokens * c.num_layers * c.kv_bytes_per_tok_layer)
    return flops, bytes_, tokens


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------
class GoodputMeter:
    """Accumulates dispatch costs and answers utilization questions.

    ``account()`` is called once per *measured* dispatch (dispatch-to-host-
    results wall time; pipelined decode deliberately overlaps, same as the
    ``llm_decode_step_seconds`` convention). ``snapshot()`` rates over a
    sliding window of recent dispatches — what the live gauges and
    ForwardPassMetrics export; ``lifetime()`` over every accounted dispatch
    — what a benchmark records. A dispatch that also paid a one-off
    build cost must NOT be accounted here, or that cost would crater the
    window's MFU."""

    def __init__(self, costs: ModelCosts, peaks: Peaks,
                 window_s: float = 10.0):
        import threading

        self.costs = costs
        self.peaks = peaks
        self.window_s = window_s
        self.flops_total = 0.0
        self.bytes_total = 0.0
        self.busy_s_total = 0.0
        self.tokens_total = 0
        self.dispatches = 0
        self._recent: collections.deque = collections.deque()
        # account() runs on the engine thread; snapshot()/lifetime() on the
        # asyncio metrics loop — iterating the deque mid-append raises and
        # would kill the caller's loop, so every touch takes this lock
        self._lock = threading.Lock()

    def account(self, flops: float, bytes_: float, elapsed_s: float,
                tokens: int = 0) -> None:
        if elapsed_s <= 0:
            return
        now = time.monotonic()
        with self._lock:
            self.flops_total += flops
            self.bytes_total += bytes_
            self.busy_s_total += elapsed_s
            self.tokens_total += tokens
            self.dispatches += 1
            self._recent.append((now, flops, bytes_, elapsed_s))
            cutoff = now - self.window_s
            while self._recent and self._recent[0][0] < cutoff:
                self._recent.popleft()

    def _rates(self, flops: float, bytes_: float, busy: float
               ) -> Dict[str, float]:
        if busy <= 0:
            return {"mfu": 0.0, "mbu": 0.0, "hbm_gbps": 0.0}
        return {
            "mfu": flops / busy / self.peaks.flops,
            "mbu": bytes_ / busy / self.peaks.hbm_bytes,
            "hbm_gbps": bytes_ / busy / 1e9,
        }

    def snapshot(self) -> Dict[str, float]:
        """MFU/MBU/GB/s over the recent window (0.0 when idle)."""
        cutoff = time.monotonic() - self.window_s
        f = b = t = 0.0
        with self._lock:
            recent = list(self._recent)
        for ts, fl, by, el in recent:
            if ts >= cutoff:
                f += fl
                b += by
                t += el
        return self._rates(f, b, t)

    def lifetime(self) -> Dict[str, float]:
        """Cumulative utilization over every accounted dispatch, plus the
        raw totals."""
        with self._lock:
            totals = (self.flops_total, self.bytes_total, self.busy_s_total,
                      self.tokens_total, self.dispatches)
        out = self._rates(totals[0], totals[1], totals[2])
        out.update(flops_total=totals[0],
                   bytes_total=totals[1],
                   busy_s=totals[2],
                   tokens=float(totals[3]),
                   dispatches=float(totals[4]),
                   peak_flops=self.peaks.flops,
                   peak_hbm_gbps=self.peaks.hbm_bytes / 1e9,
                   peak_source=self.peaks.source)
        return out


def record_compile(kind: str, seconds: float) -> None:
    """Fold one program build into the process compile-plane counters
    (``dyn_compile_seconds_total`` / ``dyn_compiled_programs{kind}``)."""
    from .prometheus import stage_metrics

    sm = stage_metrics()
    sm.compile_seconds.inc(kind, amount=seconds)
    sm.compiled_programs.inc(kind)
