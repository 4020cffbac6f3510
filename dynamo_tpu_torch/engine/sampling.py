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
the masked window's CDF. A speculative verify round (:func:`spec_verify`)
draws a fixed :func:`spec_draws` uniforms a lane, by the same rule.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..device import to_device

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


def host_uniforms(generators: Sequence[torch.Generator],
                  n: int) -> np.ndarray:
    """[n, B] f32 uniforms in [0, 1) on the host: column b is the next n
    draws of lane b's generator (a decode dispatch's host input)."""
    cols = [torch.rand(n, generator=g) for g in generators]
    return torch.stack(cols, dim=1).numpy()


def draw_uniforms(generators: Sequence[torch.Generator], n: int,
                  device: torch.device) -> torch.Tensor:
    """:func:`host_uniforms` on ``device``: one host->device copy per
    call, with no host sync."""
    return to_device(host_uniforms(generators, n), device)


def apply_penalties(logits: torch.Tensor, counts: torch.Tensor,
                    freq_pen: torch.Tensor,
                    pres_pen: torch.Tensor) -> torch.Tensor:
    """OpenAI frequency/presence penalties over GENERATED-token counts
    (completion text only, the vLLM-compatible reading): zero-penalty lanes
    are a bitwise no-op. logits [B,V] f32, counts [B,V] int."""
    cf = counts.float()
    return (logits - freq_pen[:, None] * cf
            - pres_pen[:, None] * (cf > 0).float())


def _window(logits: torch.Tensor, temperature: torch.Tensor,
            top_p: torch.Tensor, top_k: torch.Tensor):
    """The masked sampling window over the last axis of ``logits`` [B, ...,
    V]: the top-STATIC_K candidates (sorted), their probabilities at the
    lane's temperature, and the top-k/top-p mask (a prefix per row). The
    per-lane vectors are [B]. Returns (idxs, probs, mask)."""
    K = min(STATIC_K, logits.shape[-1])
    lane = (-1,) + (1,) * (logits.dim() - 1)    # [B] -> broadcast over rows
    vals, idxs = torch.topk(logits, K, dim=-1)             # sorted
    temp = torch.clamp(temperature, min=1e-6).view(lane)
    scaled = vals / temp
    probs = torch.softmax(scaled, dim=-1)
    # top-k mask (0 => off)
    tk = top_k.view(lane)
    karr = torch.where(tk > 0, tk, torch.full_like(tk, K))
    kmask = torch.arange(K, device=logits.device) < karr
    # top-p (nucleus) mask over the sorted window: keep the smallest prefix
    # with cumulative mass >= top_p (always keep the first candidate)
    cum = torch.cumsum(probs, dim=-1)
    pmask = (cum - probs) < top_p.view(lane)
    return idxs, probs, kmask & pmask


def _inverse_cdf(weights: torch.Tensor, uniforms: torch.Tensor,
                 idxs: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """The token whose slot of the renormalised ``weights`` (last axis)
    holds ``uniforms`` (one per row); the draw is clamped to slot
    ``last``."""
    cdf = torch.cumsum(weights, dim=-1)
    target = uniforms[..., None].to(cdf.dtype) * cdf[..., -1:]
    draw = (cdf <= target).sum(dim=-1)
    draw = torch.minimum(draw, last)
    return torch.gather(idxs, -1, draw[..., None])[..., 0]


def sample(logits: torch.Tensor, temperature: torch.Tensor,
           top_p: torch.Tensor, top_k: torch.Tensor,
           uniforms: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [B,V] f32, per-lane temperature/top_p [B] f32, top_k [B] int,
    uniforms [B] in [0, 1) -> (tokens [B] int64, logprob [B] f32).

    Greedy lanes (temperature==0) take argmax; others sample within the
    top-STATIC_K window with temperature, then top-k/top-p masks. The
    logprob is the token's, under the full (unscaled) log-softmax.
    """
    greedy_tok = torch.argmax(logits, dim=-1)
    idxs, probs, mask = _window(logits, temperature, top_p, top_k)
    # inverse CDF of the masked, renormalised window
    wp = torch.where(mask, probs, torch.zeros_like(probs))
    sampled_tok = _inverse_cdf(wp, uniforms, idxs, mask.sum(dim=-1) - 1)

    token = torch.where(temperature <= 0.0, greedy_tok, sampled_tok)
    logp_all = torch.log_softmax(logits, dim=-1)
    logprob = torch.gather(logp_all, 1, token[:, None])[:, 0]
    return token, logprob


# ---------------------------------------------------------------------------
# speculative decoding: verify-side sampling (device) + host-side acceptance
# ---------------------------------------------------------------------------
# The verify dispatch runs one forward over T = K+1 positions per lane
# (position 0 = the last committed token; positions 1..K = draft tokens) and
# hands the host everything acceptance needs in ONE packed fetch:
#
#   greedy_tok[t]   argmax of the target distribution at position t
#   full_tok[t]     a token sampled from the full target distribution
#   resid_tok[i]    a token sampled from the RESIDUAL distribution at draft
#                   position i: the target with the draft token's mass
#                   removed, renormalised
#   p_draft[i]      target probability of draft token i (within the masked
#                   sampling window, the distribution sample() draws from)
#   u[i]            uniform for the accept test
#
# Both proposers are deterministic (a point-mass proposal q), so rejection
# sampling reduces to: accept draft d with probability p(d); on rejection
# emit a token from p with d's mass removed, which preserves the target
# distribution exactly (Leviathan et al., 2023). Greedy lanes accept iff
# d == argmax.
#
# Randomness follows sample()'s rule: uniforms from the lane's own
# generator, turned into tokens by the inverse CDF. Each lane draws
# spec_draws(k_max) uniforms every round, whatever the batch's K bucket, so
# its stream depends only on its own seed and rounds. (The JAX engine
# splits T+K+2 keys by the batch's bucket instead.)


def spec_pack_width(K: int) -> int:
    """Columns in the packed verify output for draft length ``K``."""
    return 4 * (K + 1) + 5 * K


def spec_draws(k_max: int) -> int:
    """Uniforms one lane draws each verify round: k_max+1 full draws,
    k_max residual draws and k_max accept tests."""
    return 3 * k_max + 1


def spec_uniforms(generators: Sequence[torch.Generator], K: int,
                  k_max: int) -> np.ndarray:
    """[B, (K+1) + 2K] f32 uniforms for :func:`spec_verify`, on the host
    (a verify frame carries them to every rank): each lane draws
    :func:`spec_draws` of its generator and gives the first K+1 full, K
    residual and K accept slots of a ``k_max`` round."""
    u = np.stack([torch.rand(spec_draws(k_max), generator=g).numpy()
                  for g in generators])
    cols = (list(range(K + 1)) + list(range(k_max + 1, k_max + 1 + K))
            + list(range(2 * k_max + 1, 2 * k_max + 1 + K)))
    return np.ascontiguousarray(u[:, cols])


def spec_verify(logits: torch.Tensor, drafts: torch.Tensor,
                temperature: torch.Tensor, top_p: torch.Tensor,
                top_k: torch.Tensor, uniforms: torch.Tensor) -> torch.Tensor:
    """Verify sampling on the device. ``logits`` [B, K+1, V] f32 (penalties
    already applied), ``drafts`` [B, K] int, per-lane sampling vectors [B],
    ``uniforms`` [B, (K+1) + 2K] from :func:`spec_uniforms`. Returns packed
    [B, spec_pack_width(K)] f32: token ids < 2^24 are exact in f32, so one
    array carries ids and logprobs (as decode does)."""
    B, T, V = logits.shape
    K = T - 1
    greedy = torch.argmax(logits, dim=-1)                         # [B,T]
    logp_all = torch.log_softmax(logits, dim=-1)                  # [B,T,V]

    def lp_at(tok: torch.Tensor) -> torch.Tensor:
        return torch.gather(logp_all[:, :tok.shape[1]], -1,
                            tok[..., None].long())[..., 0]

    # the masked sampling window, exactly sample()'s
    idxs, probs, mask = _window(logits, temperature, top_p, top_k)
    wp = torch.where(mask, probs, torch.zeros_like(probs))        # [B,T,W]
    # draft-token probability under the target sampling distribution; a
    # draft outside the masked window has p=0 and is always rejected (the
    # non-spec sampler could never have emitted it)
    in_win = (idxs[:, :K] == drafts[:, :, None]) & mask[:, :K]    # [B,K,W]
    win_p = wp[:, :K] / wp[:, :K].sum(dim=-1, keepdim=True)
    p_draft = torch.where(in_win, win_p, torch.zeros_like(win_p)).sum(-1)
    resid = torch.where(in_win, torch.zeros_like(wp[:, :K]), wp[:, :K])
    full_tok = _inverse_cdf(wp, uniforms[:, :T], idxs, mask.sum(dim=-1) - 1)
    # clamped to the last slot with residual mass: never the draft itself
    last = torch.argmax(torch.cumsum((resid > 0).int(), dim=-1), dim=-1)
    resid_tok = _inverse_cdf(resid, uniforms[:, T:T + K], idxs[:, :K], last)
    u = uniforms[:, T + K:]
    return torch.cat([
        greedy.float(), lp_at(greedy),
        full_tok.float(), lp_at(full_tok),
        resid_tok.float(), lp_at(resid_tok),
        lp_at(drafts), p_draft, u.float(),
    ], dim=1)


def spec_unpack(packed: np.ndarray, K: int) -> Dict[str, np.ndarray]:
    """Split the packed verify fetch back into named host arrays [B, ...]."""
    T = K + 1
    cuts = {"greedy_tok": T, "logp_greedy": T, "full_tok": T,
            "logp_full": T, "resid_tok": K, "logp_resid": K,
            "logp_draft": K, "p_draft": K, "u": K}
    out: Dict[str, np.ndarray] = {}
    off = 0
    for name, w in cuts.items():
        out[name] = packed[:, off:off + w]
        off += w
    return out


def spec_accept(drafts: List[int], is_greedy: bool, lane: Dict[str, np.ndarray]
                ) -> Tuple[List[int], List[float], int]:
    """Host-side acceptance for ONE lane. ``lane`` holds that lane's rows of
    :func:`spec_unpack`'s arrays. Returns (tokens, token_logprobs,
    n_accepted_drafts); between 1 and len(drafts)+1 tokens are emitted.

    Greedy: accept drafts while they match argmax; the emitted token at the
    first mismatch IS the argmax (what non-spec decode would have produced),
    so greedy output is token-identical to the non-speculative path.
    Temperature>0: accept draft i iff u_i < p(d_i); on rejection emit the
    residual-distribution token; if every draft is accepted, emit one bonus
    token sampled from the full target distribution at the next position."""
    toks: List[int] = []
    lps: List[float] = []
    acc = 0
    for i, d in enumerate(drafts):
        if is_greedy:
            tgt = int(lane["greedy_tok"][i])
            toks.append(tgt)
            lps.append(float(lane["logp_greedy"][i]))
            if tgt != int(d):
                return toks, lps, acc
            acc += 1
        elif float(lane["u"][i]) < float(lane["p_draft"][i]):
            toks.append(int(d))
            lps.append(float(lane["logp_draft"][i]))
            acc += 1
        else:
            toks.append(int(lane["resid_tok"][i]))
            lps.append(float(lane["logp_resid"][i]))
            return toks, lps, acc
    j = len(drafts)
    if is_greedy:
        toks.append(int(lane["greedy_tok"][j]))
        lps.append(float(lane["logp_greedy"][j]))
    else:
        toks.append(int(lane["full_tok"][j]))
        lps.append(float(lane["logp_full"][j]))
    return toks, lps, acc
