"""Batched token sampling on the device.

One sampler covers all lanes: per-lane temperature/top-k/top-p vectors
select behaviour lane-wise (greedy lanes take argmax; sampling lanes use
temperature + nucleus/top-k restricted to a static K window — restriction to
the top-K=64 candidates is exact for top-k<=64 and a standard approximation
for pure top-p, since mass beyond the top-64 logits is negligible for LLMs).

Randomness comes from explicit per-lane ``torch.Generator``s on the host
(:func:`draw_uniforms`): each sampled token consumes one uniform of its own
lane's stream, so a request's draws depend only on its seed and never on its
batchmates, and the same ``(seed, resume_pos)`` replays identically on the
CPU and on the card. The draw turns the uniform into a token by inverting
the masked window's CDF.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

STATIC_K = 64


def resume_seed(seed: int, resume_pos: int) -> int:
    """Deterministic per-resume-position seed fold (mid-stream failover). A
    resumed request replays its emitted tokens verbatim as forced prefix,
    but the dead worker's RNG draws at those positions are unreplayable —
    continuing from the ORIGINAL seed's stream would re-issue draws the
    stream already consumed. Folding the resume position in gives the
    continuation a fresh, deterministic stream: the same (seed, resume_pos)
    always resumes identically, and resume_pos == 0 is the identity."""
    if not resume_pos:
        return seed
    # splitmix64-style mix, stable across processes/platforms
    x = (seed ^ (resume_pos * 0x9E3779B97F4A7C15)) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def lane_generator(seed: int) -> torch.Generator:
    """A lane's host-side random stream."""
    return torch.Generator(device="cpu").manual_seed(
        seed & 0xFFFFFFFFFFFFFFFF)


def draw_uniforms(generators: Sequence[torch.Generator], n: int,
                  device: torch.device) -> torch.Tensor:
    """[n, B] uniforms in [0, 1): column b is the next n draws of lane b's
    generator. One host->device copy per call."""
    cols = [torch.rand(n, generator=g) for g in generators]
    return torch.stack(cols, dim=1).to(device)


def apply_penalties(logits: torch.Tensor, counts: torch.Tensor,
                    freq_pen: torch.Tensor,
                    pres_pen: torch.Tensor) -> torch.Tensor:
    """OpenAI frequency/presence penalties over GENERATED-token counts
    (completion text only, the vLLM-compatible reading): zero-penalty lanes
    are a bitwise no-op. logits [B,V] f32, counts [B,V] int."""
    cf = counts.float()
    return (logits - freq_pen[:, None] * cf
            - pres_pen[:, None] * (cf > 0).float())


def sample(logits: torch.Tensor, temperature: torch.Tensor,
           top_p: torch.Tensor, top_k: torch.Tensor,
           uniforms: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [B,V] f32, per-lane temperature/top_p [B] f32, top_k [B] int,
    uniforms [B] in [0, 1) -> (tokens [B] int64, logprob [B] f32).

    Greedy lanes (temperature==0) take argmax; others sample within the
    top-STATIC_K window with temperature, then top-k/top-p masks. The
    logprob is the token's, under the full (unscaled) log-softmax.
    """
    K = min(STATIC_K, logits.shape[-1])
    greedy_tok = torch.argmax(logits, dim=-1)

    vals, idxs = torch.topk(logits, K, dim=-1)             # sorted, [B,K]
    temp = torch.clamp(temperature, min=1e-6)[:, None]
    scaled = vals / temp
    probs = torch.softmax(scaled, dim=-1)
    # top-k mask (0 => off)
    karr = torch.where(top_k[:, None] > 0, top_k[:, None],
                       torch.full_like(top_k[:, None], K))
    kmask = torch.arange(K, device=logits.device)[None, :] < karr
    # top-p (nucleus) mask over the sorted window: keep the smallest prefix
    # with cumulative mass >= top_p (always keep the first candidate)
    cum = torch.cumsum(probs, dim=-1)
    pmask = (cum - probs) < top_p[:, None]
    mask = kmask & pmask                                   # a prefix per lane

    # inverse CDF of the masked, renormalised window
    wp = torch.where(mask, probs, torch.zeros_like(probs))
    cdf = torch.cumsum(wp, dim=-1)
    target = uniforms[:, None].to(cdf.dtype) * cdf[:, -1:]
    draw = (cdf <= target).sum(dim=-1)
    draw = torch.minimum(draw, mask.sum(dim=-1) - 1)
    sampled_tok = torch.gather(idxs, 1, draw[:, None])[:, 0]

    token = torch.where(temperature <= 0.0, greedy_tok, sampled_tok)
    logp_all = torch.log_softmax(logits, dim=-1)
    logprob = torch.gather(logp_all, 1, token[:, None])[:, 0]
    return token, logprob

