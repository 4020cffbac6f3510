"""Host-side multimodal prompt assembly for Gemma3 VLM serving.

The engine keeps its prefill token-shaped; images enter as (a) an
embedding override (projected soft tokens replacing the
``<image_soft_token>`` placeholder embeddings) and (b) per-position image
GROUP ids driving the same-image bidirectional attention mask. This module
computes both from the prompt's token ids, in numpy, as the JAX package's
``engine/multimodal.py`` does, name for name.

:func:`normalize_image` resizes with :func:`resize_bilinear`, a numpy copy
of PIL's two-pass ``BILINEAR`` resample of 8-bit images (``Resample.c``):
the same output bit for bit as ``Image.resize((s, s), Image.BILINEAR)``,
with no PIL on the serving host.

Reference capability: the VLM prompt merge the reference inherits from its
engines (HF masked_scatter + token_type_ids mask,
transformers modeling_gemma3.py:729-953).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def image_spans(prompt: List[int], image_token_id: int) -> np.ndarray:
    """Per-position image-group ids: 0 for text, k>=1 for the k-th
    contiguous run of ``image_token_id`` placeholders."""
    ids = np.asarray(prompt, np.int64)
    is_img = ids == image_token_id
    starts = is_img & ~np.concatenate(([False], is_img[:-1]))
    groups = np.cumsum(starts)
    return np.where(is_img, groups, 0).astype(np.int32)


def validate_mm_prompt(spans: np.ndarray, n_images: int,
                       mm_tokens_per_image: int,
                       prefill_chunk: int) -> Optional[str]:
    """An error string when the prompt's image layout cannot be served,
    else None: the placeholder runs must match the attached images in
    count and length, and each image must fit one prefill chunk (its
    bidirectional attention sees the whole image in one dispatch)."""
    groups = int(spans.max()) if spans.size else 0
    if groups != n_images:
        return (f"prompt has {groups} image placeholder run(s) but "
                f"{n_images} image(s) attached")
    for g in range(1, groups + 1):
        n = int((spans == g).sum())
        if n != mm_tokens_per_image:
            return (f"image {g} placeholder run is {n} tokens; the model "
                    f"expects exactly {mm_tokens_per_image} "
                    f"<image_soft_token>s per image")
        if mm_tokens_per_image > prefill_chunk:
            return (f"mm_tokens_per_image {mm_tokens_per_image} exceeds "
                    f"prefill_chunk {prefill_chunk}: an image span cannot "
                    f"fit one prefill dispatch")
    return None


def chunk_end(spans: np.ndarray, start: int, max_count: int) -> int:
    """Largest count <= max_count such that [start, start+count) does not
    split an image span; the boundary moves back to the span's start
    (:func:`validate_mm_prompt` guarantees a span fits a chunk)."""
    count = min(len(spans) - start, max_count)
    end = start + count
    if end < len(spans) and spans[end] != 0 and spans[end] == spans[end - 1]:
        g = spans[end]
        span_start = int(np.argmax(spans == g))
        if span_start > start:
            return span_start - start
        raise ValueError("image span longer than the prefill chunk")
    return count


def soft_token_rows(spans: np.ndarray, soft: np.ndarray,
                    start: int, count: int) -> Tuple[np.ndarray, np.ndarray]:
    """(vals [count, D], mask [count]) for prompt window [start,
    start+count): each image position takes its row of that image's
    projected soft tokens, in order (HF masked_scatter). ``soft``:
    [n_images, mm_tokens, D]."""
    D = soft.shape[-1]
    window = spans[start:start + count]
    vals = np.zeros((count, D), soft.dtype)
    mask = window > 0
    for g in np.unique(window[mask]):
        pos = np.nonzero(spans == g)[0]
        rows = soft[g - 1]
        sel = (pos >= start) & (pos < start + count)
        vals[pos[sel] - start] = rows[np.nonzero(sel)[0]]
    return vals, mask


# ---------------------------------------------------------------------------
# PIL's BILINEAR resample, 8 bits a channel
# ---------------------------------------------------------------------------

PRECISION_BITS = 32 - 8 - 2          # Resample.c's fixed point


def _coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(first source index [out], fixed-point weights [out, ksize]) of one
    axis, as ``precompute_coeffs`` then ``normalize_coeffs_8bpc`` build
    them for the bilinear filter (support 1, scaled by the reduction)."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = np.array([max(0.0, 1.0 - abs((x + xmin - center + 0.5) * ss))
                      for x in range(xmax)], np.float64)
        ww = 0.0
        for v in w:                 # C's left-to-right double sum
            ww += v
        if ww != 0.0:
            w = w / ww
        # round half away from zero (every weight is >= 0 here)
        kk[xx, :xmax] = (0.5 + w * (1 << PRECISION_BITS)).astype(np.int64)
        first[xx] = xmin
    return first, kk


def _pass(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One resample pass of uint8 ``img`` [H, W, C] along ``axis``."""
    first, kk = _coeffs(img.shape[axis], out_size)
    src = np.moveaxis(img, axis, 0)                      # [in, other, C]
    # Resample.c's int accumulator: the weights sum to about 1 << 22, so
    # 255 times them plus the rounding half stays below 1 << 31
    acc = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1),
                  np.int32)
    kk = kk.astype(np.int32)
    n = src.shape[0]
    for x in range(kk.shape[1]):
        idx = np.minimum(first + x, n - 1)     # padded taps weigh 0
        acc += src[idx] * kk[:, x, None, None]
    # clip8: at or past 256 << 22 -> 255, at or below 0 -> 0
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bilinear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """uint8 [H, W, C] -> uint8 [height, width, C], bit for bit PIL's
    ``Image.resize((width, height), Image.BILINEAR)``: the horizontal pass
    first, then the vertical one, each skipped when its size is kept."""
    img = np.asarray(img, np.uint8)
    if img.shape[1] != width:
        img = _pass(img, 1, width)
    if img.shape[0] != height:
        img = _pass(img, 0, height)
    return np.ascontiguousarray(img)


def normalize_image(pixels: np.ndarray, image_size: int) -> np.ndarray:
    """uint8 HWC (or float CHW already normalized) -> float32 CHW in
    [-1, 1], resized to (image_size, image_size). SigLIP preprocessing:
    rescale 1/255 then normalize mean=std=0.5 (HF SiglipImageProcessor
    defaults)."""
    a = np.asarray(pixels)
    # integer HWC (uint8, or int lists off the wire — BackendInput
    # serializes pixels as nested lists, which round-trip as int64)
    if a.ndim == 3 and a.shape[-1] in (1, 3) and a.dtype.kind in "iu":
        a = np.clip(a, 0, 255).astype(np.uint8)
        if a.shape[-1] == 1:
            a = np.repeat(a, 3, axis=-1)
        a = resize_bilinear(a, image_size, image_size)
        a = a.astype(np.float32) / 255.0
        a = (a - 0.5) / 0.5
        return a.transpose(2, 0, 1)
    a = a.astype(np.float32)
    if a.ndim != 3 or a.shape[0] != 3:
        raise ValueError(f"image must be uint8 HWC or float CHW, "
                         f"got shape {a.shape}")
    if a.shape[1] != image_size or a.shape[2] != image_size:
        raise ValueError(f"float CHW image must already be "
                         f"{image_size}x{image_size}, got {a.shape[1:]}")
    return a
