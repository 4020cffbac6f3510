#!/usr/bin/env python3
"""On-card smoke of the PyTorch/H100 port (``dynamo_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order, each printing one JSON line; any failure exits non-zero
with a traceback and prints no result:

1. device    — the card's name and power limit (nvidia-smi).
2. build     — builds the CUDA kernels from ``dynamo_tpu_torch/ops/csrc``
               and, beside them, the native host helpers (the C++ store,
               data plane and KV-event publisher) from
               ``dynamo_tpu_torch/native``; ptxas's registers and spills
               for each kernel instance.
3. kernels   — every kernel of the serving path against its plain torch
               version on the card, in bf16, at Llama-3-8B (Gemma2-9B and
               Gemma3-4B) head shapes, the flash kernel also on a ragged dispatch in
               the serve path's strided gather layout, the paged kernel
               also on one 2048-token stream and on the serve burst's own
               decode shape (``paged_probe.PAGED_CASES``), and both at the
               tiny presets' heads (Dh=16: tiny-byte, and tiny-gemma's one
               kv head for paged); kernel, plain and library times, each
               time's share of its bound, and the paged kernel's split plan.
4. serve     — the OpenAI HTTP service with the torch engine serving
               Llama-3-8B (full width and depth, random weights from the
               seed) answers concurrent completions/chat requests, streamed
               and not; the kernels' launch counters must account for every
               prefill dispatch and decode step. Decode runs through the
               chained in-flight window: decode dispatches and how many of
               them chained, the decode-step reading, tokens/s, TTFT; the
               profile phase gives the device's busy share. The engine runs
               with ``DYN_PROFILE_DIR`` set for its first 8 working steps:
               the Chrome trace it writes must name both CUDA kernels.
   metrics   — ``/metrics`` scraped around the burst: requests, TTFT and
               decode-step counts equal what was sent and dispatched, the
               goodput gauges (MFU, MBU, GB/s) lie in (0, 1.05], every
               request's ``x-request-id`` is in ``/v1/traces`` with the JAX
               service's span tree (``?format=chrome`` too); after the
               reuse phase the KV tier gauges equal ``TieredKvCache.stats()``.
   http      — three requests on one kept-alive connection (one streamed),
               a chunked request body, two pipelined requests: all 200
               with tokens.
   overload  — a second HTTP service on the same engine with an admission
               gate of 2: a burst of 6 gets 2 answers and 4 typed 429s with
               ``Retry-After``, ``dyn_admission_rejects_total`` counts them,
               and every request is admitted again once the burst drained.
5. reference — the served weights' logits through the kernels agree with
               the dense attention path on a small input.
6. reuse     — KV block reuse on the same engine (prefix reuse on by
               default, a 128-block host tier): a seeded 1496-token prompt
               served cold (hit 0), warm from the device pool (hit 1472 =
               23 pages), and, after every reusable block was offloaded,
               warm from the host tier (hit 1472), twice; the warm streams
               are token-identical, the restored pages equal the host copies
               bit for bit, and a warm 24-token prefill over cached pages
               gives the cold chunked prefill's last logits (cosine > 0.99).
               TTFT, dispatches, copy bytes and rates, hashing time.
   ingest    — on the same engine, the reuse prompt's KV from
               ``prefill_extract``, streamed back into its pool through a
               ``KvIngest`` (a disagg decode worker's receive path) with
               ``torch.cuda.set_sync_debug_mode("error")`` on for every
               layer's staging and scatter: no host sync, and the entered
               sequence streams the cold run's tokens.
7. chain     — on an engine sharing the served weights, one chained
               steady-state decode enqueue under
               ``torch.cuda.set_sync_debug_mode("error")``: no host sync,
               with the stage metrics, heartbeats and goodput accounting on.
   lint      — the port's static analysis held against the card:
               ``python -m dynamo_tpu_torch.cli.dynalint`` exits 0 here
               (files, rules, seconds) and gives its ``host-sync``
               inventory; then an engine sharing the served weights runs
               admission, a chunked prefill, unchained and chained decode
               dispatches and the token reads under
               ``torch.cuda.set_sync_debug_mode("warn")``. Every sync the
               card reports, at its innermost frame in
               ``dynamo_tpu_torch/``, must be a site of the inventory; the
               chained enqueue reports none. Syncs per prefill dispatch and
               per decode step, with their sites.
8. default   — the CLI's default model, tiny-byte (Dh=16, no preset
               given), served over HTTP through the same entry point:
               completions and chat, streamed and not, all 200 with tokens
               and a finish reason; the launch counters account for every
               prefill dispatch and decode step.
9. checkpoint — real checkpoint files served through ``--model-path``:
               a HF directory at Llama-3-8B width, depth cut to 4 layers
               (random bf16 weights from the seed in two safetensors
               shards written by the port, a synthetic 128256-entry
               Llama-3-style tokenizer.json, generation and tokenizer
               configs), and an F32 GGUF at Mistral-7B width, depth cut to
               1 layer, with an embedded 32000-piece SPM vocab. Loaded
               leaves equal the written weights bit for bit, prompt counts
               equal the port's own encodings, the launch counters account
               for every dispatch, and a greedy stream equals an engine
               built from the same host tensors. Write, load (s, GB/s,
               host RSS growth), tokenizer load, encode and TTFT.
10. fleet    — the distributed runtime, each piece a process of the
               port's own (``python -m dynamo_tpu_torch...``), every one on
               the native data plane and each store the C++ dynstore (the
               phase reads both back from the children and fails
               otherwise): two stores, the second holding the telemetry
               families (``DYN_STORE_SHARDS``), a regional aggregator,
               two workers serving Llama-3-8B on this card (full width and
               depth, the serve phase's engine arguments, random weights
               from the same seed), the KV-aware router and the discovery
               frontend. A seeded 1024-token prefix A, then four requests
               sharing it: each goes to A's worker with 16+ overlap blocks
               and 1024+ prefix-hit tokens; prefix-B requests sent while
               A's worker is busy go to the other one by load; request A's
               trace holds spans of the frontend, router and worker
               processes; ``/metrics`` shows both workers' stage dumps,
               whose dispatch and kernel-launch counters account for each
               other (both kernels launched in both workers); SIGTERM on
               one worker exits 0, removes its keys, and the next four
               requests answer from the other. The observers' read of the
               stage dumps comes from the aggregator's region record, whose
               counters for each worker equal the frontend's flat scrape;
               a ``stored`` and a ``removed`` event sent through the C-ABI
               publisher come back from the live ``kv_events`` subject.
               Fleet and in-process TTFT and gap between tokens of one lone
               stream, the route span, the codec's µs a frame, both data
               planes' µs an item and GB/s on 64 parts of 3 MB (in turns),
               asyncio items turns in a fresh process and before and after
               the region read (where its stalls come on), each worker's
               ForwardPassMetrics and peak device memory.
11. disagg   — disaggregated prefill and decode, each piece a process of
               the port's own: the store, a decode worker
               (``--enable-disagg --max-local-prefill-length 256``), a
               prefill worker, both Llama-3-8B at full width and depth with
               the serve phase's engine arguments and seed, and the
               discovery frontend. The reuse prompt, sent greedy to the
               decode worker, is prefilled by the prefill worker, its KV
               (196 MB) streamed layer by layer into the decode worker's
               pool: its token ids must equal the serve phase's cold
               stream. The stage dumps must show flash launches only in
               the prefill worker (32 a prefill dispatch) and paged ones
               only in the decode worker (32 a decode step), the KV bytes
               on both sides, and request 1's trace the disagg spans of
               three processes. A 64-token prompt prefills locally, and a
               burst of four 1024-token prompts all goes remote and leaves
               the queue empty. Remote against local TTFT, transfer
               seconds and GB/s, the flows, each worker's peak memory, and
               the data plane's own rate on the same parts. Every child on
               the native plane and store, as in the fleet phase.
11b. cluster — cluster-wide KV sharing, two ``max_batch`` 1 workers with
               ``DYN_KV_CLUSTER=1`` behind the router and frontend, on the
               native plane and store: the stamped donor fetch, the
               router's donor election, the staged restore; then failover:
               a seeded 1024-token greedy request for 128 tokens, served
               cold, then warm (the unkilled run), then warm again with its
               worker SIGKILLed once the stream holds 16 tokens. The
               stream (the frontend's ``RemoteCoreEngine`` in this process,
               for exact token ids) must finish with all 128, its first
               tokens the unkilled run's, one ``resumed`` count, the
               survivor's flash launches one a layer a chunk of the rebuilt
               prefix and paged ones one a layer a decode step, the
               survivor's tokens equal to an in-process engine's cold run
               of the prompt and the emitted tokens, and every token of
               the unkilled and the killed stream within
               FAILOVER_MARGIN_LIMIT of the top logit of a teacher-forced
               prefill over prompt + stream, which two planted wrong
               resume prefixes must break. Whether the stream equals the
               unkilled run (bf16 rebuilds by prefill what the unkilled
               run decoded), and where not, the top-2 gap there; the pause
               from the kill to the survivor's first token, and how the
               survivor rebuilt.

12. spec     — speculative decoding in process on the serve phase's
               weight tensors (Llama-3-8B, full width and depth, its engine
               arguments): an n-gram engine (k=4) with four concurrent
               requests (a 64-token block repeated 8 times and the reuse
               prompt, greedy; one sampled; one presence-penalty lane that
               rides the verify with zero drafts), then a ``no_spec``
               request, and a draft-model engine (llama-3.2-1b, Dh=64,
               random weights from seed + 101) on the two greedy prompts,
               each against a spec-off engine. Every verify dispatch
               launches the flash kernel once a layer and the target no
               paged kernel, the draft's sync chunks and steps launch both
               kernels at Dh=64, a greedy stream equals spec off or first
               differs at a near-tie (top-2 gap under 2e-2 of the top
               logit), the pool drains. Tokens per verify dispatch, accept
               rate, K buckets, host seconds a round, the repeated prompt's
               decode rate and ITL alone with spec on and off. The spec
               counters on ``/metrics`` must equal the engine's: the HTTP
               service in front of the draft engine (which drafts every
               round), then ``cli.run`` serving ``{"spec": "ngram"}``.

13. vlm      — Gemma3-4B-it vision-language serving over HTTP: the
               published config (nested text and vision configs) mapped by
               ``LlamaConfig.from_hf_config``, full width and depth, random
               bf16 weights from the seed and the SigLIP tower (27 layers,
               896-pixel images, 256 soft tokens) from seed + 1. Chat
               requests with PNG data URLs written by ``llm/_png.encode``
               (Paeth on every row; a 1200x900 image downscaled, a 640x480
               one upscaled, both in one request, beside a text-only
               request): all 200 with tokens; the 1200x900 PNG decodes to
               its pixels bit for bit (its decode time reported); no
               prefill chunk splits an image span; every dispatch with an
               image span runs the dense path (``image_waves``) and every
               other one the flash kernel (34 launches a text wave),
               decode the paged kernel (34 a step); a greedy image request
               repeats after the cache is flushed, hits its salted prefix
               when sent again (its warm tokens equal the cold ones) and
               misses it with another image; the tower's bf16 soft tokens
               against the same tower in f32: at a trained tower's scale
               at or above ``VLM_COS_MIN``, which the same tower with its
               attention probabilities in float8_e4m3 falls below; the
               served (seeded) tower's finite, its cosine only reported.
               Tower ms an image, image and text TTFT, peak memory.
14. moe      — Mixtral-8x7B's published widths (E=8, top-2), depth cut to
               4 of 32 layers, through the engine: sorted and dense
               dispatch agree on a 512-token chunk (2e-2 of the output's
               largest value); four concurrent requests prefill through
               sorted dispatch (one host read of the expert counts a layer)
               and decode through dense dispatch (``moe_ffn.dispatches``),
               the kernels launched 4 a prefill dispatch and decode step;
               a chained decode enqueue of 16 lanes (dense: a one-token
               step never reads the expert counts) under sync debug mode
               "error".

15. kvpage   — the KV paging long-context lane (runs right after spec, on
               its weight tensors): Llama-3-8B at full width and depth,
               page 64, chunk 512, dense ``max_context`` 2048, a 20-page
               lane (1280 tokens) with 8-block segments over a 384-block
               host tier. (a) a greedy 10240-token prompt for 16 tokens
               beside (d) a 64-token dense-path request, against a dense
               engine whose pool holds the prompt; (b) the same prompt from
               the pinned prefix; (c) two lanes with the 10240- and
               6144-token prompts at once, each equal to its stream alone;
               (e) ``cli.run`` over HTTP: the long prompt streams a 200,
               and without paging gets the typed 400. Tokens equal or a
               near-tie, the last prefill logits within 2x the plain-vs-
               flash control, at most 20 pages leased, demotions as
               :func:`kvpage_demotions` computes, a reuse hit, no fault;
               prefill seconds and decode ms a step against dense, the
               ``dyn_kvpage_*`` counters, page-in GB/s (assembly, upload),
               peak device memory.

16. fleet_plane — the fleet control plane (runs right after kvpage): (b)
               on an engine holding the served Llama-3-8B weights (32
               layers, 16 GB), A -> B -> A by in-place hot swap from
               page-locked host trees (A copied off the card, B drawn
               from seed + 1 a layer group at a time): every leaf equals
               A's copy after the return and the greedy reuse stream equals
               the serve phase's cold one (a printed depth cut if the host
               cannot hold two copies); (a) the checkpoint phase's 4-layer
               directory A and a sibling B written from seed + 1: the typed
               refusals (busy, geometry, a tree without ``lm_head``), then
               A -> B one layer a copy: B's greedy tokens equal a cold
               engine of B and differ from A's, no tensor moves
               (``data_ptr``), no library is built under ``build/``, peak
               device memory rises by at most one layer group, the kernels
               launch once a layer a prefill dispatch and decode step; (d)
               ``run_profile(engine="torch")`` on A at batches 1 and 4,
               prompts of 128 and 512 tokens, a table the SLA policy
               loads; (c) the native store, ``cli.planner --fleet
               --connector local --platform cuda --total-chips 1``,
               ``cli.router --fleet`` and the discovery frontend, A and B
               registered in one swap group (B of higher priority): a
               request for A parks until the planner spawns A's worker on
               card 0 (``CUDA_VISIBLE_DEVICES=0``), a request for B parks
               until the arbiter hands that card to B by a swap — one
               spawn, the same pid, ``dyn_model_swaps_total{outcome=
               "swap"}`` 1 and ``reload`` 0, the wake record, both
               answers the cold engines' greedy tokens, B's launches under
               its component; swap seconds and GB/s, wake seconds, parked
               and scale-from-zero TTFT, ``fleet_status`` and
               ``/v1/models`` before and after.

17. tp       — tensor parallelism (runs right after deploy, beside the
               serve phase's weights): ``cli.run in=http out=torch
               --tensor-parallel-size 2 --dist-backend gloo --devices 0,0``
               serving Llama-3-8B at full width and depth with the serve
               phase's engine arguments, the leader in this process and its
               follower a ``cli.worker`` process on the same card (NCCL
               refuses two ranks on one GPU; NCCL across two cards is not
               run). An HTTP burst and three greedy requests; each rank's
               flash launches one a layer a prefill dispatch and paged ones
               one a layer a decode step, both ranks the same dispatches,
               the worker's ``dyn_kernel_launches_total`` both kernels for
               both ranks; the greedy streams within TP_MARGIN_LIMIT of a
               tp=1 teacher-forced prefill's top logit, which the streams
               shifted by a token must break; each rank's weight bytes and
               peak memory; the follower exits 0 at the leader's shutdown.
               Then the same server as a process of its own: its follower
               SIGKILLed, the leader exits non-zero within TP_EXIT_S and
               the card's free bytes come back. The kernels phase holds
               both kernels at one rank's heads (Hq=16, Hkv=4).

Then the ``{"kernels": [...]}`` line, the card's ``nvidia-smi`` line, and
last ``{"ok": true, "device": {...}}``. Without a CUDA card it exits 2.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM published HBM3 rate
BF16_FLOPS = 989e12            # H100 SXM published dense bf16 rate
TOL = 2e-2                     # bf16 kernel vs plain, O(1) outputs
DEVICE = "cuda"
PRESET = "llama-3-8b"
ENGINE_ARGS = dict(preset=PRESET, max_batch=8, max_context=2048,
                   page_size=64, prefill_chunk=512, decode_steps=8,
                   host_cache_blocks=128)
REUSE_PROMPT, REUSE_SEED, REUSE_TOKENS = 1496, 1496, 16
PROFILE_STEPS = 8
PROFILE_DIR = os.path.join(ROOT, "build", "dynamo_tpu_torch", "profile")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int) -> float:
    """Mean device time of fn() over iters launches (after a warm-up).

    A spin kernel holds the card while the host enqueues the launches, so
    the events time the card's work back to back and not the wrappers'
    Python overhead (tens of microseconds, more than a fast kernel)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)            # ~25 ms at 1.98 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def flash_inputs(torch, B, T, S, Hq, Hkv, Dh, ragged=True):
    """Contiguous q/k/v; every lane's chunk is the last T positions of its
    S-token context. With ``ragged`` lane 1 instead has a 700-token context
    whose last 32 query rows are padding (position 0, key 0 invalid:
    nothing to attend to, so they must come out exactly 0). Returns the
    inputs and the padded rows as (lane, first row)."""
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16
    q = torch.randn((B, T, Hq, Dh), generator=g, device=dev).to(bf)
    k = torch.randn((B, S, Hkv, Dh), generator=g, device=dev).to(bf)
    v = torch.randn((B, S, Hkv, Dh), generator=g, device=dev).to(bf)
    k_pos = torch.arange(S, dtype=torch.int32, device=dev)[None].repeat(B, 1)
    k_valid = torch.ones((B, S), dtype=torch.bool, device=dev)
    q_pos = torch.arange(S - T, S, dtype=torch.int32, device=dev)[None] \
        .repeat(B, 1)
    pad = []
    if ragged:
        n1 = 700
        k_valid[1, n1:] = False
        k_valid[1, 0] = False
        q_pos[1] = torch.arange(n1 - T, n1, dtype=torch.int32, device=dev)
        q_pos[1, T - 32:] = 0
        pad = [(1, T - 32)]
    return (q, k, v, q_pos, k_pos, k_valid), pad


def serve_layout_inputs(torch, chunks=(512, 200, 37),
                        contexts=(1024, 600, 37), Hq=32, Hkv=8, Dh=128,
                        page=64):
    """A prefill dispatch as ``engine._prefill_dispatch`` builds it: lane b
    prefills its last ``chunks[b]`` tokens of ``contexts[b]``; T and S are
    the longest chunk and context, neither bucketed; pad query rows sit at
    position 0 and pad context slots point at scratch page 0, invalid. k/v
    are the strided [B, S, Hkv, Dh] views of a gather from a shuffled page
    pool that ``models/llama.forward`` passes to the kernel."""
    dev = torch.device(DEVICE)
    B, T, S = len(chunks), max(chunks), max(contexts)
    g = torch.Generator(device=dev).manual_seed(4)
    bf = torch.bfloat16
    n_pages = 1 + sum(-(-n // page) for n in contexts)
    k_pool = torch.randn((Hkv, n_pages, page, Dh), generator=g,
                         device=dev).to(bf)
    v_pool = torch.randn((Hkv, n_pages, page, Dh), generator=g,
                         device=dev).to(bf)
    q = torch.randn((B, T, Hq, Dh), generator=g, device=dev).to(bf)
    pages = (torch.randperm(n_pages - 1, generator=torch.Generator()
                            .manual_seed(4)) + 1).tolist()
    read_idx = torch.zeros((B, S), dtype=torch.int64)
    k_pos = torch.zeros((B, S), dtype=torch.int32)
    k_valid = torch.zeros((B, S), dtype=torch.bool)
    q_pos = torch.zeros((B, T), dtype=torch.int32)
    for b, (c, n) in enumerate(zip(chunks, contexts)):
        own = [pages.pop() for _ in range(-(-n // page))]
        t = torch.arange(n)
        read_idx[b, :n] = torch.tensor(own)[t // page] * page + t % page
        k_pos[b, :n] = t.to(torch.int32)
        k_valid[b, :n] = True
        q_pos[b, :c] = torch.arange(n - c, n, dtype=torch.int32)
    read_idx = read_idx.to(dev)
    rp, ro = read_idx // page, read_idx % page
    k = k_pool[:, rp, ro].permute(1, 2, 0, 3)
    v = v_pool[:, rp, ro].permute(1, 2, 0, 3)
    return (q, k, v, q_pos.to(dev), k_pos.to(dev), k_valid.to(dev)), []


def flash_case(torch, att, name, inputs, pad=(), scale=None, softcap=None,
               window=None, library=True):
    import torch.nn.functional as F

    q, k, v, q_pos, k_pos, k_valid = inputs
    B, T, Hq, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    kw = dict(scale=scale, softcap=softcap, window=window)
    got = att.flash_attention(q, k, v, q_pos, k_pos, k_valid, **kw)
    want = att.flash_attention_plain(q, k, v, q_pos, k_pos, k_valid, **kw)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    pad_max = max([got[b, r:].float().abs().max().item() for b, r in pad],
                  default=0.0)
    finite = bool(torch.isfinite(got.float()).all())
    mask = k_valid[:, None, :] & (k_pos[:, None, :] <= q_pos[:, :, None])
    if window is not None:
        mask = mask & (k_pos[:, None, :] > q_pos[:, :, None] - window)
    visible = int(mask.sum())
    # bytes: q and out once, the K/V rows some query of the lane can see
    # (the kernel loads no other tile), positions and validity once
    keys = int(mask.any(dim=1).sum())
    nbytes = (2 * q.numel() * 2 + 2 * keys * Hkv * Dh * 2
              + q_pos.numel() * 4 + k_pos.numel() * 4 + k_valid.numel())
    flops = 4.0 * visible * Hq * Dh
    b_ms, b_by = bound_ms(nbytes, flops)
    ms = time_ms(torch, lambda: att.flash_attention(
        q, k, v, q_pos, k_pos, k_valid, **kw), 20)
    plain_ms = time_ms(torch, lambda: att.flash_attention_plain(
        q, k, v, q_pos, k_pos, k_valid, **kw), 5)
    lib_ms = None
    if library:
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        am = mask[:, None]
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=am, scale=scale, enable_gqa=True), 20)
    row = dict(case=name, B=B, T=T, S=S, Hq=Hq, Hkv=Hkv, Dh=Dh,
               k_strides=list(k.stride()), softcap=softcap, window=window,
               max_abs_err=err, tol=TOL,
               padded_rows_max=pad_max, finite=finite, ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
               bound_by=b_by, bound_frac=b_ms / ms, bytes=nbytes,
               flops=flops)
    emit({"phase": "kernels", "kernel": "flash_attention", **row})
    if not (finite and err <= TOL and pad_max == 0.0):
        raise AssertionError(f"flash_attention {name} disagrees: {row}")
    return row


def paged_case(torch, att, name, softcap=None, window=None, **shape):
    """The paged kernel against its plain version at one of
    ``paged_probe.PAGED_CASES``: ``shape`` goes to ``paged_inputs``."""
    from dynamo_tpu_torch.ops.paged_probe import paged_inputs

    dev = torch.device(DEVICE)
    q, kp, vp, pt, lengths = paged_inputs(dev, **shape)
    B, Hq, Dh = q.shape
    Hkv, _, page, _ = kp.shape
    P = pt.shape[1]
    lengths_l = lengths.tolist()
    split, nsplit = att.paged_split_plan(B, Hq, Hkv, Dh, P, page,
                                         att._sm_count(dev.index))
    kw = dict(softcap=softcap, window=window)
    got = att.paged_attention(q, kp, vp, pt, lengths, **kw)
    want = att.paged_attention_plain(q, kp, vp, pt, lengths, **kw)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    finite = bool(torch.isfinite(got.float()).all())
    active = sum(min(n, window) if window else n for n in lengths_l)
    nbytes = (2 * q.numel() * 2 + active * Hkv * Dh * 2 * 2 + pt.numel() * 4
              + lengths.numel() * 4)
    flops = 4.0 * active * Hq * Dh
    b_ms, b_by = bound_ms(nbytes, flops)
    ms = time_ms(torch, lambda: att.paged_attention(
        q, kp, vp, pt, lengths, **kw), 50)
    plain_ms = time_ms(torch, lambda: att.paged_attention_plain(
        q, kp, vp, pt, lengths, **kw), 5)
    row = dict(case=name, B=B, P=P, page=page, Hq=Hq, Hkv=Hkv, Dh=Dh,
               lengths=lengths_l, softcap=softcap, window=window,
               split=split, splits=nsplit,
               max_abs_err=err, tol=TOL, finite=finite, ms=ms,
               plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
               bound_by=b_by, bound_frac=b_ms / ms, bytes=nbytes,
               flops=flops)
    emit({"phase": "kernels", "kernel": "paged_attention", **row})
    if not (finite and err <= TOL):
        raise AssertionError(f"paged_attention {name} disagrees: {row}")
    return row


# ---------------------------------------------------------------------------
# phase 4: serve over HTTP
# ---------------------------------------------------------------------------

def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def http_post(port: int, path: str, body: dict, results: dict, key: str):
    t0 = time.perf_counter()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        status = resp.status
        rid = resp.headers.get("x-request-id")
        if body.get("stream"):
            chunks, stamps, done = [], [], False
            text, tokens = [], []
            for raw in resp:
                line = raw.decode().strip()
                if not line.startswith("data:"):
                    continue
                data = line[5:].strip()
                if data == "[DONE]":
                    done = True
                    continue
                stamps.append(time.perf_counter() - t0)
                chunks.append(json.loads(data))
                for c in chunks[-1]["choices"]:
                    text.append(c.get("text")
                                or (c.get("delta") or {}).get("content")
                                or "")
                    tokens += (c.get("logprobs") or {}).get("tokens") or []
            last = chunks[-1]
            results[key] = dict(status=status, done=done, chunks=len(chunks),
                                rid=rid, usage=last.get("usage"),
                                finish=last["choices"][0].get("finish_reason"),
                                ttft_s=stamps[0], last_s=stamps[-1],
                                text="".join(text), tokens=tokens)
        else:
            out = json.loads(resp.read())
            results[key] = dict(status=status, rid=rid,
                                usage=out.get("usage"),
                                finish=out["choices"][0].get("finish_reason"),
                                seconds=time.perf_counter() - t0)


@contextlib.contextmanager
def http_front(card, core):
    """The OpenAI HTTP service in front of the torch engine ``core`` (the
    pipeline ``cli.run`` builds for ``out=torch``) on a free port, its loop
    on a thread of its own: yields (loop, port, ModelManager); stops the
    service after, not the engine."""
    import asyncio

    from dynamo_tpu_torch.llm.http_service import (HttpService, ModelManager,
                                                   ServedModel)
    from dynamo_tpu_torch.llm.pipeline import (build_chat_engine,
                                               build_completion_engine)

    loop = asyncio.new_event_loop()
    manager = ModelManager()
    manager.add(ServedModel(card, build_chat_engine(card, "core", core),
                            build_completion_engine(card, "core", core)))
    svc = HttpService(manager, host="127.0.0.1", port=0)
    port = loop.run_until_complete(svc.start())
    server = threading.Thread(target=loop.run_forever, name="http",
                              daemon=True)
    server.start()
    try:
        yield loop, port, manager
    finally:
        asyncio.run_coroutine_threadsafe(svc.stop(), loop).result(60)
        loop.call_soon_threadsafe(loop.stop)
        server.join(timeout=60)
        loop.close()


@contextlib.contextmanager
def served(argv, env=None):
    """The CLI's torch engine (``cli.run`` arguments ``argv``; ``env`` set
    while it is built) behind the OpenAI HTTP service on a free port, its
    loop on a thread of its own: yields (TorchEngine, loop, port, model id,
    the engine's construction seconds, the ModelManager); stops both
    after."""
    import torch

    from dynamo_tpu_torch.cli.run import make_card, make_engines, parse_args

    t0 = time.perf_counter()
    args = parse_args(["in=http", "out=torch", "--device", DEVICE, *argv])
    card = make_card(args)
    saved = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    try:
        _, _, core = make_engines(args, card)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    try:
        with http_front(card, core) as (loop, port, manager):
            http_post(port, "/v1/completions",
                      {"model": card.name, "prompt": "warm up",
                       "max_tokens": 2}, {}, "warm")
            yield core, loop, port, card.name, init_s, manager
    finally:
        core.shutdown()


def burst(att, core, port: int, reqs: dict, tag: str) -> dict:
    """The requests of ``reqs`` (key -> (path, body)) at once, with the
    kernels' launch counters set to 0 just before. Every request must end
    200 with tokens and a finish reason (a stream with [DONE]), and the
    launches must account for every prefill dispatch and decode step, one
    a layer. Returns the results and the engine counters' deltas."""
    c = core.core
    before = (c.prefill_dispatches, c.decode_steps_run, c.prefill_seconds,
              c.decode_seconds, c.decode_dispatches, c.decode_chained)
    results: dict = {}
    att.flash_attention.launches = 0
    att.paged_attention.launches = 0
    t0 = time.perf_counter()
    threads = [threading.Thread(target=http_post,
                                args=(port, path, body, results, key))
               for key, (path, body) in reqs.items()]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    out = dict(flash_launches=att.flash_attention.launches,
               paged_launches=att.paged_attention.launches)
    after = (c.prefill_dispatches, c.decode_steps_run, c.prefill_seconds,
             c.decode_seconds, c.decode_dispatches, c.decode_chained)
    for name, a, b in zip(("prefill_dispatches", "decode_steps",
                           "prefill_s", "decode_s", "decode_dispatches",
                           "chained_dispatches"), before, after):
        out[name] = b - a
    for key in reqs:
        r = results.get(key)
        if r is None:
            raise AssertionError(f"{tag} request {key} did not complete")
        if r["status"] != 200 or not r["usage"] \
                or r["usage"]["completion_tokens"] < 1 \
                or r["finish"] not in ("length", "stop"):
            raise AssertionError(f"{tag} request {key} failed: {r}")
        if "done" in r and not r["done"]:
            raise AssertionError(f"{tag} stream {key} missed [DONE]: {r}")
    L = c.cfg.model.num_layers
    pre_n, steps_n = out["prefill_dispatches"], out["decode_steps"]
    if not (pre_n > 0 and steps_n > 0
            and out["flash_launches"] == L * pre_n
            and out["paged_launches"] == L * steps_n):
        raise AssertionError(
            f"{tag}: kernel launches do not account for the serving path: "
            f"flash {out['flash_launches']} vs {L}x{pre_n} prefill "
            f"dispatches, paged {out['paged_launches']} vs {L}x{steps_n} "
            f"decode steps")
    tokens_out = sum(r["usage"]["completion_tokens"]
                     for r in results.values())
    return dict(out, requests=len(reqs), wall_s=wall,
                completion_tokens=tokens_out, decode_tok_s=tokens_out / wall,
                results=results)


LONE_STREAM = {"prompt": "Once upon a time", "max_tokens": 64,
               "stream": True, "logprobs": 1, "temperature": 0.0}


def lone_stream(port: int) -> dict:
    """One greedy streamed request alone on the server (one chunk a
    token): its TTFT, mean gap between tokens, and what it streamed (text
    and token strings). The fleet phase sends the same request through the
    frontend, router and a worker process and holds the stream to this
    one."""
    res: dict = {}
    http_post(port, "/v1/completions", dict(LONE_STREAM, model=PRESET),
              res, "s")
    st = res["s"]
    if st["status"] != 200 or st["chunks"] < 2 \
            or len(st["tokens"]) != st["usage"]["completion_tokens"]:
        raise AssertionError(f"lone stream failed: {st}")
    return dict(ttft_s=st["ttft_s"], chunks=st["chunks"],
                itl_ms=1e3 * (st["last_s"] - st["ttft_s"])
                / (st["chunks"] - 1), text=st["text"], tokens=st["tokens"])


GREEDY_SEED, GREEDY_PROMPT, GREEDY_TOKENS = 4242, 40, 32


async def greedy_ids(engine) -> list:
    """The token ids a core engine (in process, or remote through the
    router and the data plane) streams for one seeded greedy request."""
    import numpy as np

    from dynamo_tpu_torch.llm.protocols.common import (BackendInput,
                                                       StopConditions)
    from dynamo_tpu_torch.runtime.engine import Context

    rng = np.random.default_rng(GREEDY_SEED)
    bi = BackendInput(token_ids=[int(t) for t in
                                 rng.integers(1, 256, GREEDY_PROMPT)],
                      stop=StopConditions(max_tokens=GREEDY_TOKENS,
                                          ignore_eos=True))
    ids: list = []
    async for out in engine.generate(bi, Context()):
        ids += out.token_ids
    if len(ids) != GREEDY_TOKENS:
        raise AssertionError(f"greedy request streamed {len(ids)} tokens")
    return ids


def serve_phase(torch, att, smi: str):
    import asyncio
    import shutil

    argv = ["--model-name", PRESET,
            "--extra-engine-args", json.dumps(ENGINE_ARGS)]
    shutil.rmtree(PROFILE_DIR, ignore_errors=True)
    env = {"DYN_PROFILE_DIR": PROFILE_DIR,
           "DYN_PROFILE_STEPS": str(PROFILE_STEPS)}
    launch = {"before_engine": launch_us(torch)}
    with served(argv, env) as (core, loop, port, _, init_s, manager):
        wait_for_profile_trace(core, port)
        launch["after_capture"] = launch_us(torch)
        long_prompt = ("The port serves Llama on the card through two "
                       "hand-written kernels. " * 22)
        reqs = {
            "completion": ("/v1/completions", {
                "model": PRESET, "prompt": "The quick brown fox",
                "max_tokens": 48}),
            "completion_stream": ("/v1/completions", {
                "model": PRESET, "prompt": "Once upon a time",
                "max_tokens": 64, "stream": True, "logprobs": 1}),
            "chat": ("/v1/chat/completions", {
                "model": PRESET, "max_tokens": 48,
                "messages": [{"role": "user", "content": "Say hello."}]}),
            "chat_stream_sampled": ("/v1/chat/completions", {
                "model": PRESET, "max_tokens": 48, "stream": True,
                "temperature": 0.8, "top_p": 0.9, "seed": 7,
                "messages": [{"role": "user", "content": "Tell a story."}]}),
            "long_prompt": ("/v1/completions", {
                "model": PRESET, "prompt": long_prompt, "max_tokens": 32}),
            "completion_topk": ("/v1/completions", {
                "model": PRESET, "prompt": "Paged attention", "max_tokens": 48,
                "temperature": 1.0, "top_k": 20, "seed": 11}),
        }
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        scrape0 = scrape(port)
        b = burst(att, core, port, reqs, "serve")
        peak = torch.cuda.max_memory_allocated()
        scrape1 = scrape(port)
        c = core.core
        if b["results"]["long_prompt"]["usage"]["prompt_tokens"] <= \
                ENGINE_ARGS["prefill_chunk"]:
            raise AssertionError("long prompt did not exceed one chunk")
        st = b["results"]["completion_stream"]
        stream_tok_s = ((st["chunks"] - 1) / (st["last_s"] - st["ttft_s"])
                        if st["chunks"] > 1 else None)
        row = dict(phase="serve", preset=PRESET, engine=ENGINE_ARGS,
                   init_s=init_s, **b, stream_ttft_s=st["ttft_s"],
                   stream_decode_tok_s=stream_tok_s,
                   prefill_ms_per_dispatch=1e3 * b["prefill_s"]
                   / b["prefill_dispatches"],
                   # dispatch to results on the host, per step; chained
                   # dispatches overlap, so this is not a share of the wall
                   decode_step_ms=1e3 * b["decode_s"] / b["decode_steps"],
                   peak_mem_bytes=peak, weight_bytes=_nbytes(c.params),
                   kv_pool_bytes=_nbytes([c.k_pool, c.v_pool]), card=smi)
        emit(row)
        if row["chained_dispatches"] <= 0:
            raise AssertionError(f"no decode dispatch chained: {row}")
        row["metrics"] = metrics_phase(core, port, reqs, b, scrape0, scrape1,
                                       smi)
        row["http"] = http_phase(port)
        row["overload"] = overload_phase(core, loop, manager, smi)
        row["profile"] = profile_phase(torch, port)
        emit({"phase": "goodput", "card": smi,
              "mfu": row["metrics"]["mfu"], "mbu": row["metrics"]["mbu"],
              "hbm_gbps": row["metrics"]["hbm_gbps"],
              "device_busy_share": row["profile"]["device_busy_share"]})
        ref = reference_phase(torch, c)
        row["reuse"] = reuse_phase(torch, att, core, loop)
        row["tiers"] = tier_gauge_check(core, port)
        row["ingest"] = ingest_phase(torch, core, loop,
                                     row["reuse"]["cold_tokens"], smi)
        row["chain"] = chain_sync_phase(torch, c)
        row["chain_writethrough"] = chain_sync_phase(torch, c,
                                                     writethrough=True)
        row["lint"] = lint_phase(torch, att, c, smi)
        row["lone_stream"] = lone_stream(port)
        row["lone_stream"]["greedy_ids"] = asyncio.run_coroutine_threadsafe(
            greedy_ids(core), loop).result(600)
        launch["after_phases"] = launch_us(torch)
        # read the trace only now: loading it builds millions of Python
        # objects, which must not overlap a timed phase
        row["profile_trace"] = profile_trace_check(core, launch)
        params = c.params
    return row, ref, params


# ---------------------------------------------------------------------------
# the observability and overload plane on the served engine
# ---------------------------------------------------------------------------

def http_get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as resp:
        return resp.status, resp.read()


def scrape(port: int) -> dict:
    """``/metrics`` as {sample name with labels: value}."""
    status, text = http_get(port, "/metrics")
    if status != 200:
        raise AssertionError(f"/metrics answered {status}")
    return samples(text.decode())


def samples(text: str) -> dict:
    """Prometheus text as {sample name with labels: value}."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, _, val = line.rpartition(" ")
            out[key] = float(val)
    return out


def _total(sc: dict, name: str, **labels) -> float:
    """Sum of the samples of ``name`` whose labels include ``labels``."""
    want = [f'{k}="{v}"' for k, v in labels.items()]
    return sum(v for k, v in sc.items()
               if k.split("{", 1)[0] == name and all(w in k for w in want))


def launch_us(torch, n: int = 2000) -> float:
    """Host microseconds to enqueue one small elementwise op on the card
    (the unit the decode enqueue is made of), mean over ``n``."""
    x = torch.zeros(64, device=DEVICE)
    x.add_(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1)
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * dt / n


def plane_cost_us(core, reps: int = 200) -> dict:
    """Host microseconds of what the observability plane adds to one
    decode dispatch (heartbeat, two events, the decode-step histogram, the
    cost model and the goodput meter, for six lanes of 8 steps) and to one
    prefill dispatch (a 512-token chunk), on scratch instances of the same
    classes so the served metrics stay untouched."""
    from dynamo_tpu_torch.obs.flightrec import FlightRecorder
    from dynamo_tpu_torch.utils import roofline
    from dynamo_tpu_torch.utils.prometheus import StageMetrics

    c = core.core
    rec, stage = FlightRecorder("smoke", enabled=True), StageMetrics()
    meter = roofline.GoodputMeter(c.costs, c.goodput.peaks)
    lengths, steps = [64, 300, 600, 900, 1200, 1500], c.cfg.decode_steps
    t0 = time.perf_counter()
    for _ in range(reps):
        rec.hb_begin("engine.decode", stall="decode")
        rec.note("engine.dispatch", depth=1, batch=6, steps=steps)
        stage.decode_step.observe(value=0.04)
        rec.hb_done("engine.decode", 0.04)
        rec.note("engine.step", s=0.3, n=steps, compiled=False)
        meter.account(*roofline.decode_cost(c.costs, lengths, steps)[:2],
                      0.3, 48)
        stage.batch_occupancy.set("1", value=6)
    decode = (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fl, by, tk = roofline.prefill_cost(c.costs, [(1024, 512)])
        meter.account(fl, by, 0.06, tk)
    prefill = (time.perf_counter() - t0) / reps
    return dict(decode_dispatch=1e6 * decode, prefill_dispatch=1e6 * prefill)


def wait_for_profile_trace(core, port: int) -> None:
    """``DYN_PROFILE_DIR``: warm requests until the engine has written its
    trace of the first working steps."""
    for i in range(20):
        if core.profile_trace is not None:
            return
        http_post(port, "/v1/completions",
                  {"model": PRESET, "prompt": f"warm {i}", "max_tokens": 16},
                  {}, "warm")


def profile_trace_check(core, launch: dict) -> dict:
    """The ``DYN_PROFILE_DIR`` trace must exist, parse, and name both CUDA
    kernels. ``launch``: the host cost of one small op before the engine,
    after its capture and after the other phases."""
    path = core.profile_trace
    if path is None or not os.path.isfile(path):
        raise AssertionError(f"DYN_PROFILE_DIR wrote no trace under "
                             f"{PROFILE_DIR}")
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    flash = sorted(n for n in names if "flash_kernel<" in n)
    paged = sorted(n for n in names if "paged_split_kernel<" in n)
    row = dict(phase="profile_trace", steps=PROFILE_STEPS, launch_us=launch,
               file=os.path.relpath(path, ROOT),
               bytes=os.path.getsize(path), events=len(trace["traceEvents"]),
               flash_kernels=flash, paged_kernels=paged)
    emit(row)
    if not (flash and paged):
        raise AssertionError(f"the profile trace misses a kernel: {row}")
    return row


def _spans(port: int, rid: str) -> list:
    status, body = http_get(port, f"/v1/traces/{rid}")
    if status != 200:
        raise AssertionError(f"/v1/traces/{rid} answered {status}")
    spans = json.loads(body)["spans"]
    by_id = {s["span_id"]: s["name"] for s in spans}
    return [(s["name"], by_id.get(s["parent_id"])) for s in spans]


def metrics_phase(core, port: int, reqs: dict, b: dict, sc0: dict,
                  sc1: dict, smi: str) -> dict:
    """The serve burst read back from the server: counts against what was
    sent and dispatched, the goodput gauges, and every request's trace."""
    def delta(name, **labels):
        return _total(sc1, name, **labels) - _total(sc0, name, **labels)

    streamed = sum(bool(body.get("stream")) for _, body in reqs.values())
    pid = str(os.getpid())
    row = dict(phase="metrics", card=smi, requests=len(reqs),
               streamed=streamed,
               http_200=delta("dyn_http_requests_total", status="200"),
               ttft_count=delta("llm_ttft_seconds_count"),
               stream_ttft_count=delta(
                   "dyn_http_time_to_first_token_seconds_count"),
               decode_step_count=delta("llm_decode_step_seconds_count"),
               decode_dispatches=b["decode_dispatches"],
               mfu=_total(sc1, "dyn_mfu", worker=pid),
               mbu=_total(sc1, "dyn_mbu", worker=pid),
               hbm_gbps=_total(sc1, "dyn_hbm_gbps", worker=pid),
               gauges_present=all(
                   any(k.startswith(f'{g}{{component="http",worker="{pid}"')
                       for k in sc1) for g in ("dyn_mfu", "dyn_mbu",
                                               "dyn_hbm_gbps")))
    status, body = http_get(port, "/v1/traces?limit=200")
    listed = set(json.loads(body)["traces"])
    trees, missing = {}, []
    for key, (path, body) in reqs.items():
        rid = b["results"][key]["rid"]
        if not rid or rid not in listed:
            missing.append(key)
            continue
        root = "http:chat" if "chat" in path else "http:completions"
        want = [(root, None), ("preprocess", root)]
        if body.get("stream"):
            want.append(("sse.egress", root))
        trees[key] = _spans(port, rid)
        if trees[key] != want:
            missing.append(key)
    status, chrome = http_get(
        port, f"/v1/traces/{b['results']['completion_stream']['rid']}"
              f"?format=chrome")
    row.update(traces_missing=missing, trace_trees=trees,
               chrome_events=len(json.loads(chrome)["traceEvents"]),
               plane_cost_us=plane_cost_us(core))
    emit(row)
    ok = (row["http_200"] == len(reqs) and row["ttft_count"] == len(reqs)
          and row["stream_ttft_count"] == streamed
          and row["decode_step_count"] == b["decode_dispatches"] > 0
          and row["gauges_present"] and 0 < row["mfu"] <= 1.05
          and 0 < row["mbu"] <= 1.05 and row["hbm_gbps"] > 0
          and not missing and row["chrome_events"] > 0)
    if not ok:
        raise AssertionError(f"metrics phase failed: {row}")
    return row


def tier_gauge_check(core, port: int) -> dict:
    """After the reuse phase filled the host tier: the tier gauges and
    counters on /metrics equal ``TieredKvCache.stats()``."""
    st = core.core.tiered.stats()
    sc = scrape(port)
    pid = str(os.getpid())
    row = dict(phase="tiers", stats=st,
               host_blocks=_total(sc, "dyn_kv_tier_blocks", tier="host",
                                  worker=pid),
               hits=_total(sc, "dyn_kv_tier_hits_total"),
               misses=_total(sc, "dyn_kv_tier_misses_total"))
    emit(row)
    if not (st["host_blocks"] > 0 and row["host_blocks"] == st["host_blocks"]
            and row["hits"] == st["hits"] and row["misses"] == st["misses"]):
        raise AssertionError(f"tier gauges disagree with stats(): {row}")
    return row


def _read_responses(raw: bytes) -> list:
    """HTTP/1.1 responses back to back in ``raw`` (Content-Length or
    chunked bodies): [(status, headers, body)]."""
    out = []
    while raw:
        head, _, raw = raw.partition(b"\r\n\r\n")
        lines = head.decode("latin-1").split("\r\n")
        status = int(lines[0].split()[1])
        headers = {k.strip().lower(): v.strip() for k, _, v in
                   (ln.partition(":") for ln in lines[1:])}
        if headers.get("transfer-encoding") == "chunked":
            body = b""
            while True:
                size_line, _, raw = raw.partition(b"\r\n")
                size = int(size_line, 16)
                body += raw[:size]
                raw = raw[size + 2:]
                if size == 0:
                    break
        else:
            n = int(headers.get("content-length", "0"))
            body, raw = raw[:n], raw[n:]
        out.append((status, headers, body))
    return out


def _exchange(port: int, payload: bytes) -> list:
    import socket

    with socket.create_connection(("127.0.0.1", port), timeout=600) as s:
        s.sendall(payload)
        buf = b""
        while True:
            d = s.recv(1 << 16)
            if not d:
                return _read_responses(buf)
            buf += d


def _request_bytes(path: str, body: dict, close=False, chunked=False):
    b = json.dumps(body).encode()
    head = (f"POST {path} HTTP/1.1\r\nHost: x\r\n"
            f"Content-Type: application/json\r\n"
            + ("Connection: close\r\n" if close else ""))
    if chunked:
        parts = [b[:10], b[10:]]
        return (head + "Transfer-Encoding: chunked\r\n\r\n").encode() + \
            b"".join(b"%x\r\n%s\r\n" % (len(p), p) for p in parts) + \
            b"0\r\n\r\n"
    return (head + f"Content-Length: {len(b)}\r\n\r\n").encode() + b


def _tokens_of(resp) -> int:
    status, headers, body = resp
    if status != 200:
        return 0
    if headers.get("content-type", "").startswith("text/event-stream"):
        datas = [ln[5:].strip() for ln in body.decode().splitlines()
                 if ln.startswith("data:")]
        if datas[-1] != "[DONE]":
            return 0
        return json.loads(datas[-2])["usage"]["completion_tokens"]
    return json.loads(body)["usage"]["completion_tokens"]


def http_phase(port: int) -> dict:
    """HTTP/1.1 on the served engine: a kept-alive connection carrying
    three requests (one streamed), a chunked request body, and two
    pipelined requests; each must answer 200 with tokens."""
    comp = {"model": PRESET, "prompt": "Keep the connection", "max_tokens": 8}
    chat = {"model": PRESET, "max_tokens": 8,
            "messages": [{"role": "user", "content": "One socket."}]}
    keep = _exchange(port, _request_bytes("/v1/completions", comp)
                     + _request_bytes("/v1/completions", dict(
                         comp, stream=True, logprobs=1))
                     + _request_bytes("/v1/chat/completions", chat,
                                      close=True))
    chunked = _exchange(port, _request_bytes("/v1/completions", comp,
                                             close=True, chunked=True))
    piped = _exchange(port, _request_bytes("/v1/completions", comp)
                      + _request_bytes("/v1/completions", dict(
                          comp, prompt="pipelined"), close=True))
    row = dict(phase="http",
               keep_alive=[(r[0], _tokens_of(r)) for r in keep],
               keep_alive_streamed=keep[1][1].get("transfer-encoding"),
               chunked=[(r[0], _tokens_of(r)) for r in chunked],
               pipelined=[(r[0], _tokens_of(r)) for r in piped])
    emit(row)
    got = row["keep_alive"] + row["chunked"] + row["pipelined"]
    if not (len(row["keep_alive"]) == 3 and len(row["chunked"]) == 1
            and len(row["pipelined"]) == 2 and row["keep_alive_streamed"]
            == "chunked" and all(st == 200 and n > 0 for st, n in got)):
        raise AssertionError(f"http phase failed: {row}")
    return row


def overload_phase(core, loop, manager, smi: str) -> dict:
    """A second HTTP service on the same engine behind an admission gate of
    two in-flight requests (no queue): six requests at once get two 200s
    with tokens and four typed 429s; the rejects are counted; once the
    burst drained, requests are admitted again."""
    import asyncio

    from dynamo_tpu_torch.llm.http_service import HttpService
    from dynamo_tpu_torch.utils.overload import (AdmissionConfig,
                                                 AdmissionController)

    ctrl = AdmissionController(AdmissionConfig(concurrency=2, queue=0))
    svc = HttpService(manager, host="127.0.0.1", port=0, admission=ctrl)
    port = asyncio.run_coroutine_threadsafe(svc.start(), loop).result(60)
    try:
        sc0 = scrape(port)
        body = {"model": PRESET, "prompt": "Admission", "max_tokens": 24}
        out: dict = {}
        gate = threading.Barrier(6)

        def one(i):
            gate.wait()
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/completions",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=600) as resp:
                    out[i] = (resp.status, None,
                              json.loads(resp.read())["usage"])
            except urllib.error.HTTPError as e:
                out[i] = (e.code, e.headers.get("Retry-After"),
                          json.loads(e.read())["error"])

        threads = [threading.Thread(target=one, args=(i,)) for i in range(6)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        sc1 = scrape(port)
        after = {}
        for i in range(2):
            http_post(port, "/v1/completions", body, after, str(i))
        ok200 = [o for o in out.values() if o[0] == 200]
        shed = [o for o in out.values() if o[0] == 429]
        row = dict(
            phase="overload", card=smi, sent=6, admitted=len(ok200),
            rejected=len(shed),
            tokens=[o[2]["completion_tokens"] for o in ok200],
            retry_after=sorted({o[1] for o in shed}),
            errors=sorted({(o[2]["type"], o[2]["stage"], o[2]["reason"],
                            o[2]["retry_after"]) for o in shed}),
            rejects_counted=_total(sc1, "dyn_admission_rejects_total")
            - _total(sc0, "dyn_admission_rejects_total"),
            after=[r["status"] for r in after.values()],
            inflight_after=ctrl.inflight)
        emit(row)
    finally:
        asyncio.run_coroutine_threadsafe(svc.stop(), loop).result(60)
    if not (row["admitted"] == 2 and row["rejected"] == 4
            and all(n > 0 for n in row["tokens"])
            and row["retry_after"] == ["1"]
            and row["errors"] == [("overloaded_error", "admission",
                                   "concurrency", 1.0)]
            and row["rejects_counted"] == 4 and row["after"] == [200, 200]
            and row["inflight_after"] == 0):
        raise AssertionError(f"overload phase failed: {row}")
    return row


def profile_phase(torch, port: int) -> dict:
    """Where the device time goes while serving: four concurrent 32-token
    completions under torch.profiler (CUDA activity); kernel time by name
    and the device's busy share of the wall time. The profiler's own
    overhead is inside the wall time."""
    from torch.profiler import ProfilerActivity, profile

    results: dict = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=http_post, args=(
            port, "/v1/completions",
            {"model": PRESET, "prompt": f"Request {i} asks for a story.",
             "max_tokens": 32}, results, str(i))) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + us)
    busy_ms = sum(t for _, t in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    row = dict(phase="profile", requests=len(results), wall_ms=wall * 1e3,
               device_busy_ms=busy_ms,
               device_busy_share=busy_ms / (wall * 1e3),
               kernels=[dict(name=k[:90], launches=n, ms=t / 1e3)
                        for k, (n, t) in top],
               # the port's own kernels, whatever their rank
               attention_kernels=[
                   dict(name=k[:90], launches=n, ms=t / 1e3)
                   for k, (n, t) in by_name.items()
                   if "::flash_kernel<" in k or "::paged_" in k])
    emit(row)
    if busy_ms <= 0.0:
        raise AssertionError("the profiler recorded no device time")
    return row


def reference_phase(torch, core):
    """The served weights through the kernel paths against the dense
    attention path, prefill then one decode step, on a 40-token prompt in
    a scratch pool (the engine is idle here)."""
    from dynamo_tpu_torch.models import llama

    m = core.cfg.model
    dev = core.device
    page, T = 64, 40
    shape = (m.num_layers, m.num_kv_heads, 3, page, m.head_dim)
    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, 256, (1, T + 1), generator=g).to(dev)
    pos = torch.arange(T, dtype=torch.int32, device=dev)[None]
    slots = (page + torch.arange(T, device=dev))[None]      # page 1
    out = {}
    for impl, dimpl in (("flash", "paged"), ("dense", "dense")):
        kp = torch.zeros(shape, dtype=m.dtype, device=dev)
        vp = torch.zeros(shape, dtype=m.dtype, device=dev)
        with torch.no_grad():
            lg, _, _ = llama.forward(
                core.params, m, tokens[:, :T], pos, kp, vp, slots, slots, pos,
                torch.ones((1, T), dtype=torch.bool, device=dev),
                attn_impl=impl,
                logits_idx=torch.tensor([T - 1], device=dev))
            dl, _, _ = llama.forward_decode(
                core.params, m, tokens[:, T], kp, vp,
                torch.tensor([[1, 2]], dtype=torch.int32, device=dev),
                torch.tensor([T + 1], dtype=torch.int32, device=dev),
                attn_impl=dimpl)
        out[impl] = (lg[0, 0].float(), dl[0, 0].float())
    row = {"phase": "reference"}
    ok = True
    for i, name in enumerate(("prefill", "decode")):
        a, b = out["flash"][i], out["dense"][i]
        cos = torch.nn.functional.cosine_similarity(a, b, dim=0).item()
        finite = bool(torch.isfinite(a).all())
        row[name] = dict(shape=list(a.shape), finite=finite, cosine=cos,
                         max_abs_diff=(a - b).abs().max().item(),
                         argmax_equal=int(a.argmax()) == int(b.argmax()))
        ok = ok and finite and cos > 0.99 and a.shape[0] == m.vocab_size
    emit(row)
    if not ok:
        raise AssertionError(f"kernel-path logits disagree with dense: {row}")
    return row


# ---------------------------------------------------------------------------
# phase 6: KV block reuse (device pool, host tier)
# ---------------------------------------------------------------------------

def _generate(engine, loop, prompt):
    """One greedy request of ``prompt`` through :func:`_generate_request`:
    (tokens, kv_prefix_hit_tokens, TTFT s, total s)."""
    from dynamo_tpu_torch.llm.protocols.common import (BackendInput,
                                                       StopConditions)

    return _generate_request(engine, loop, BackendInput(
        token_ids=prompt, stop=StopConditions(max_tokens=REUSE_TOKENS,
                                              ignore_eos=True)))


def _generate_request(engine, loop, bi):
    """One request straight through the engine's AsyncEngine entry point
    on the server's loop: (tokens, kv_prefix_hit_tokens, TTFT s, total
    s)."""
    import asyncio

    from dynamo_tpu_torch.llm.protocols.common import FinishReason
    from dynamo_tpu_torch.runtime.engine import Context

    async def go():
        toks, hit, ttft = [], None, None
        t0 = time.perf_counter()
        async for o in engine.generate(bi, Context()):
            if o.finish_reason == FinishReason.ERROR:
                raise AssertionError(f"request failed: {o.error}")
            if ttft is None:
                ttft = time.perf_counter() - t0
                hit = o.kv_prefix_hit_tokens
            toks.extend(o.token_ids)
        return toks, hit, ttft, time.perf_counter() - t0

    return asyncio.run_coroutine_threadsafe(go(), loop).result(600)


def _prefix_logits(torch, core, prompt, warm_tokens: int,
                   attn_impl: str = "flash"):
    """Last-position logits of ``prompt`` through ``llama.forward`` in a
    scratch pool: a cold chunked prefill (chunks of the engine's
    ``prefill_chunk``), then a warm prefill of only the last
    ``warm_tokens`` over the cold pass's cached pages. ``attn_impl``
    "dense" takes the plain attention path instead of the flash kernel."""
    from dynamo_tpu_torch.models import llama

    m, dev, page = core.cfg.model, core.device, core.page_size
    n = len(prompt)
    n_pages = -(-n // page) + 1                  # + scratch page 0
    shape = (m.num_layers, m.num_kv_heads, n_pages, page, m.head_dim)
    kp = torch.zeros(shape, dtype=m.dtype, device=dev)
    vp = torch.zeros(shape, dtype=m.dtype, device=dev)
    toks = torch.tensor(prompt, device=dev)[None]

    def chunk(c0, c1):
        pos = torch.arange(c0, c1, dtype=torch.int32, device=dev)[None]
        ctx = torch.arange(c1, device=dev)[None]
        lg, _, _ = llama.forward(
            core.params, m, toks[:, c0:c1], pos, kp, vp, page + pos.long(),
            page + ctx, ctx.to(torch.int32),
            torch.ones((1, c1), dtype=torch.bool, device=dev),
            attn_impl=attn_impl,
            logits_idx=torch.tensor([c1 - c0 - 1], device=dev))
        return lg[0, 0].float()

    with torch.no_grad():
        step = core.cfg.prefill_chunk
        for c0 in range(0, n, step):
            cold = chunk(c0, min(n, c0 + step))
        warm = chunk(n - warm_tokens, n)
    return cold, warm


def _copy_rates(torch, core, hashes, reps: int = 3) -> dict:
    """The card's copy rates for these host blocks, each copy ending in a
    synchronize: pinned host -> scratch device pages (``h2d_pages``), and
    the pages back (``d2h_pages``: gather, pinned copy, event)."""
    from dynamo_tpu_torch.llm.kvbm.transfer import CopyStream

    tiers = core.tiered
    n = len(hashes)
    blk = tiers.peek(hashes[0])[0].shape
    hk, hv = CopyStream.host_blocks(n, blk, core.k_pool.dtype,
                                    core.k_pool.is_cuda)
    for i, h in enumerate(hashes):
        hk[i], hv[i] = tiers.peek(h)
    L, Hkv, page, Dh = blk
    pools = [torch.empty((L, Hkv, n, page, Dh), dtype=core.k_pool.dtype,
                         device=core.device) for _ in range(2)]
    cs = CopyStream()
    out = {"blocks": n, "bytes": hk.nbytes + hv.nbytes}
    for name, fn in (("h2d", lambda: cs.h2d_pages(*pools, range(n), hk, hv)),
                     ("d2h", lambda: cs.d2h_pages(*pools, range(n)))):
        fn()                                   # warm-up (pinned allocation)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()
        s = (time.perf_counter() - t0) / reps
        out[f"{name}_s"] = s
        out[f"{name}_gb_s"] = out["bytes"] / s / 1e9
    return out


def reuse_prompt(vocab: int) -> list:
    """The seeded 1496-token prompt of the reuse, ingest and disagg
    phases."""
    import numpy as np

    return np.random.default_rng(REUSE_SEED).integers(
        0, vocab, REUSE_PROMPT).tolist()


def reuse_phase(torch, att, engine, loop) -> dict:
    """KV block reuse on the serving engine (idle between requests)."""
    import numpy as np

    from dynamo_tpu_torch.llm.tokens import compute_seq_hashes

    core = engine.core
    page = core.page_size
    L = core.cfg.model.num_layers
    cs, tiers = core.copy_stream, core.tiered
    prompt = reuse_prompt(core.cfg.model.vocab_size)
    t0 = time.perf_counter()
    for _ in range(10):
        hashes = compute_seq_hashes(prompt, page)
    hash_ms = 1e3 * (time.perf_counter() - t0) / 10
    n_blocks = (REUSE_PROMPT - 1) // page          # the match stops at n-1
    expect_hit = n_blocks * page

    def run(tag):
        att.flash_attention.launches = 0
        att.paged_attention.launches = 0
        pre0, steps0 = core.prefill_dispatches, core.decode_steps_run
        restore0 = core.restore_seconds
        d2h0, h2d0 = (cs.d2h_bytes, cs.d2h_seconds), (cs.h2d_bytes,
                                                      cs.h2d_seconds)
        hits0 = tiers.stats()["hits"]
        toks, hit, ttft, total = _generate(engine, loop, prompt)
        torch.cuda.synchronize()
        r = dict(run=tag, tokens=len(toks), kv_prefix_hit_tokens=hit,
                 ttft_s=ttft, total_s=total,
                 prefill_dispatches=core.prefill_dispatches - pre0,
                 decode_steps=core.decode_steps_run - steps0,
                 flash_launches=att.flash_attention.launches,
                 paged_launches=att.paged_attention.launches,
                 tier_hits=tiers.stats()["hits"] - hits0,
                 d2h_bytes=cs.d2h_bytes - d2h0[0],
                 d2h_s=cs.d2h_seconds - d2h0[1],
                 h2d_bytes=cs.h2d_bytes - h2d0[0],
                 h2d_enqueue_s=cs.h2d_seconds - h2d0[1],
                 restore_s=core.restore_seconds - restore0)
        emit({"phase": "reuse", **r})
        if not (r["flash_launches"] == L * r["prefill_dispatches"] > 0
                and r["paged_launches"] == L * r["decode_steps"] > 0):
            raise AssertionError(f"reuse run {tag}: kernel launches do not "
                                 f"account for its dispatches: {r}")
        return toks, r

    cold_toks, cold = run("cold")
    warm_toks, warm = run("warm_device")
    # offload every reusable device block to the host tier
    d2h0 = (cs.d2h_bytes, cs.d2h_seconds)
    flushed = core.flush_reusable()
    flush = dict(blocks=flushed, d2h_bytes=cs.d2h_bytes - d2h0[0],
                 d2h_s=cs.d2h_seconds - d2h0[1], tier=tiers.stats())
    flush["d2h_gb_s"] = flush["d2h_bytes"] / flush["d2h_s"] / 1e9
    emit({"phase": "reuse", "run": "flush", **flush})
    resident = sum(h in tiers for h in hashes[:n_blocks])
    host_toks, host = run("warm_host")
    # once more from the host: the first restore in a process also pays
    # for its pinned upload buffers, which the allocator then keeps
    core.flush_reusable()
    again_toks, again = run("warm_host_again")
    # the restored pages hold exactly the host tier's bytes
    pages = [core.pool.blocks._by_hash[h] for h in hashes[:n_blocks]]
    idx = torch.tensor(pages, device=core.device)
    bitwise = True
    for pool, which in ((core.k_pool, 0), (core.v_pool, 1)):
        dev_bits = (pool.index_select(2, idx).permute(2, 0, 1, 3, 4)
                    .view(torch.int16).cpu().numpy().view(np.uint16))
        host_bits = np.stack([tiers.peek(h)[which]
                              for h in hashes[:n_blocks]])
        bitwise = bitwise and np.array_equal(dev_bits, host_bits)
    # placement-driven prefetch: the same host-tier restore with the
    # blocks staged on the side stream before admission (what a worker
    # does while a request waits at its slot gate)
    from dynamo_tpu_torch.llm.protocols.common import BackendInput

    core.flush_reusable()
    stage = core.stage
    hits0 = stage.prefetch_h2d_hits.get()
    stalls0 = stage.prefetch_h2d_stalls.get()
    t0 = time.perf_counter()
    staged_n = engine.prefetch_tiers(BackendInput(token_ids=prompt))
    stage_s = time.perf_counter() - t0
    staged_toks, staged = run("warm_host_staged")
    prefetch = dict(staged_blocks=staged_n, stage_s=stage_s,
                    h2d_hits=stage.prefetch_h2d_hits.get() - hits0,
                    h2d_stalls=stage.prefetch_h2d_stalls.get() - stalls0,
                    ttft_s=staged["ttft_s"], restore_s=staged["restore_s"],
                    tokens_equal_sync=staged_toks == host_toks,
                    kv_prefix_hit_tokens=staged["kv_prefix_hit_tokens"])
    emit({"phase": "reuse", "run": "prefetch", **prefetch})
    if not (staged_n == prefetch["h2d_hits"] == n_blocks
            and prefetch["h2d_stalls"] == 0
            and prefetch["tokens_equal_sync"]
            and staged["kv_prefix_hit_tokens"] == expect_hit):
        raise AssertionError(f"staged prefetch: {prefetch}")
    rates = _copy_rates(torch, core, hashes[:n_blocks])
    cold_lg, warm_lg = _prefix_logits(torch, core, prompt,
                                      REUSE_PROMPT - expect_hit)
    cos = torch.nn.functional.cosine_similarity(cold_lg, warm_lg,
                                                dim=0).item()
    row = dict(phase="reuse", prompt_tokens=REUSE_PROMPT, page=page,
               blocks=n_blocks, hash_ms_per_prompt=hash_ms,
               hits=[cold["kv_prefix_hit_tokens"],
                     warm["kv_prefix_hit_tokens"],
                     host["kv_prefix_hit_tokens"]],
               ttft_s=dict(cold=cold["ttft_s"], warm_device=warm["ttft_s"],
                           warm_host=host["ttft_s"],
                           warm_host_again=again["ttft_s"]),
               restore_s=dict(warm_host=host["restore_s"],
                              warm_host_again=again["restore_s"]),
               host_resident_after_flush=resident,
               warm_streams_equal=warm_toks == host_toks == again_toks,
               restored_bitwise_equal=bitwise, copy_rates=rates,
               logits=dict(cosine=cos,
                           max_abs_diff=(cold_lg - warm_lg).abs().max().item(),
                           argmax_equal=int(cold_lg.argmax())
                           == int(warm_lg.argmax()),
                           finite=bool(torch.isfinite(warm_lg).all())),
               block_bytes=2 * int(core.k_pool[:, :, 0].numel())
               * core.k_pool.element_size())
    emit(row)
    ok = (row["hits"] == [0, expect_hit, expect_hit]
          and again["kv_prefix_hit_tokens"] == expect_hit
          and resident == n_blocks and host["tier_hits"] >= n_blocks
          and row["warm_streams_equal"] and bitwise
          and row["logits"]["finite"] and cos > 0.99
          and cold["tokens"] == warm["tokens"] == REUSE_TOKENS)
    if not ok:
        raise AssertionError(f"reuse phase failed: {row}")
    # the prompt's blocks as a cold prefill wrote them (the host tier's
    # bits): the cluster phase holds a worker's write-through mirrors to
    # them
    block_bits = [np.stack([tiers.peek(h)[which] for h in hashes[:n_blocks]])
                  for which in (0, 1)]
    return dict(row, runs=[cold, warm, host, again, staged], flush=flush,
                prefetch=prefetch, cold_tokens=cold_toks,
                warm_host_tokens=host_toks, block_bits=block_bits)


# ---------------------------------------------------------------------------
# phase 6b: a layer-streamed KV ingest on the served engine takes no sync
# ---------------------------------------------------------------------------

def ingest_phase(torch, engine, loop, want: list, smi: str) -> dict:
    """On the served engine, idle and with its own weights: the reuse
    prompt's KV from ``prefill_extract``, streamed back into the same
    engine's pool through a ``KvIngest`` (the decode worker's receive
    path) while ``torch.cuda.set_sync_debug_mode("error")`` is on for
    every layer's staging and grouped scatter; the entered sequence must
    stream the reuse phase's cold tokens."""
    import asyncio

    from dynamo_tpu_torch.llm.kv_transfer import _meta
    from dynamo_tpu_torch.llm.protocols.common import (BackendInput,
                                                       StopConditions)
    from dynamo_tpu_torch.runtime.engine import Context

    core = engine.core
    L = core.cfg.model.num_layers
    prompt = reuse_prompt(core.cfg.model.vocab_size)
    bi = BackendInput(token_ids=prompt, stop=StopConditions(
        max_tokens=REUSE_TOKENS, ignore_eos=True))

    async def go():
        t0 = time.perf_counter()
        k, v, tok, logp = await engine.prefill_extract(bi,
                                                       Context("ingest-x"))
        extract_s = time.perf_counter() - t0
        ctx = Context("ingest-1")
        ingest = engine.kv_ingest(bi, ctx.id)
        if not ingest.begin(_meta(ctx.id, tok, logp, k)):
            raise AssertionError("the ingest declined its own geometry")
        while ctx.id not in core._stream_injects:
            await asyncio.sleep(0.001)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for layer in range(L):
                ingest.layer(layer, k[layer], v[layer])
            # the engine thread stages and scatters them (a sync there
            # raises, and the ingest fails over with a typed error)
            while True:
                st = core._stream_injects.get(ctx.id)
                if st is None or (st["layers_done"] == L and not st["n"]):
                    break
                await asyncio.sleep(0.001)
            layers_s = time.perf_counter() - t1
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ingest.finish(tok, logp)
        toks = []
        async for out in engine.generate_streamed(bi, ctx, ingest):
            toks += out.token_ids
        return dict(kv_bytes=k.nbytes + v.nbytes, extract_s=extract_s,
                    layers_enqueue_s=layers_s, tokens=toks)

    r = asyncio.run_coroutine_threadsafe(go(), loop).result(600)
    row = dict(phase="ingest", sync_debug_mode="error", layers=L,
               prompt_tokens=len(prompt), kv_bytes=r["kv_bytes"],
               extract_s=r["extract_s"],
               layers_enqueue_s=r["layers_enqueue_s"],
               tokens_equal=r["tokens"] == want, card=smi)
    emit(row)
    if r["tokens"] != want:
        raise AssertionError(f"the streamed ingest streamed {r['tokens']}, "
                             f"the served cold stream {want}")
    return row


# ---------------------------------------------------------------------------
# phase 7: a chained decode enqueue makes no host sync
# ---------------------------------------------------------------------------

def _ready_mirrors(core) -> list:
    """A core's pending write-through entries whose KV is written (what
    the next step boundary gathers), without taking them."""
    out = []
    for seq_hash, page, seq_id, end in core._wt_pending:
        written = core._kv_written(seq_id)
        if core.pool.blocks.sealed_hash(page) == seq_hash and (
                written is None or written >= end):
            out.append(seq_hash)
    return out


def chain_sync_phase(torch, served, writethrough: bool = False,
                     lanes: int = 2) -> dict:
    """On a second engine core that shares the served weights (the serving
    core belongs to its engine thread), ``lanes`` requests decode until the
    next dispatch can chain off the one in flight; that enqueue then runs
    under ``torch.cuda.set_sync_debug_mode("error")``, where any host sync
    (a pageable copy, ``.item()``, a stream sync) raises.

    With ``writethrough`` the core has a host tier and cluster
    write-through, the requests run until a sealed block's mirror is ready
    at a chainable step, and the step boundary's mirror gather runs under
    the same mode before the chained enqueue; every mirrored block must
    then equal its device pages bit for bit."""
    import dataclasses

    import numpy as np

    from dynamo_tpu_torch.engine.engine import EngineCore
    from dynamo_tpu_torch.llm.protocols.common import (BackendInput,
                                                       StopConditions)

    cfg = dataclasses.replace(served.cfg, max_batch=lanes, num_pages=None,
                              host_cache_blocks=32 if writethrough else 0,
                              cluster_writethrough=writethrough)
    core = EngineCore(cfg, served.params)
    # with write-through, a's 60-token prompt fills its first page on the
    # fourth decoded token: that block seals inside the chained window
    prompts = {"a": list(range(1, 61 if writethrough else 65)),
               "b": [7] * 40}
    prompts.update({f"l{k}": [k + 9] * (24 + k) for k in range(2, lanes)})
    for sid, prompt in prompts.items():
        core.submit(sid, BackendInput(token_ids=prompt, stop=StopConditions(
            max_tokens=48, ignore_eos=True)))
    for _ in range(20):
        core.step()
        if len(core._inflight) == 1 and core._can_chain() and len(
                core._inflight[0]["active"]) == lanes and (
                not writethrough or _ready_mirrors(core)):
            break
    else:
        raise AssertionError("the window never became chainable"
                             + (" with a mirror ready" if writethrough
                                else ""))
    n = core.decode_dispatches
    ready = set(_ready_mirrors(core))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        if writethrough:
            core._advance_writethrough()
        t1 = time.perf_counter()
        core._dispatch_decode()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    enqueue_s = time.perf_counter() - t1
    mirror_enqueue_s = t1 - t0
    chained = core.decode_dispatches == n + 1 and core._inflight[-1]["chained"]
    window_lanes = len(core._inflight[-1]["active"])
    moving = {h for r in core._wt_copies for h, _ in r["entries"]}
    tokens = 0
    for _ in range(40):
        tokens += len(core.step())
        if not core.has_work:
            break
    row = dict(phase="chain", sync_debug_mode="error", chained=chained,
               writethrough=writethrough, lanes=window_lanes,
               enqueue_s=enqueue_s, decode_steps=core.cfg.decode_steps,
               decode_step_ms=1e3 * core.decode_seconds
               / core.decode_steps_run,
               tokens_after=tokens, drained=not core.has_work,
               pages_free=core.pool.free_pages == core.pool.num_pages - 1)
    ok = (chained and window_lanes == lanes and row["drained"]
          and row["pages_free"])
    if writethrough:
        core.flush_writethrough()
        host, _ = core.tiered.hashes()
        bitwise = True
        for h in host:
            page = core.pool.blocks._by_hash[h]
            for which, pool in enumerate((core.k_pool, core.v_pool)):
                dev = pool[:, :, page].view(torch.int16).cpu().numpy()
                bitwise = bitwise and np.array_equal(
                    core.tiered.peek(h)[which].view(np.int16), dev)
        row.update(mirror_enqueue_s=mirror_enqueue_s,
                   mirrors_ready=len(ready),
                   mirrors_in_the_gather=len(ready & moving),
                   mirrored_blocks=core.writethrough_blocks,
                   tier_blocks=len(host),
                   mirror_bytes=core.writethrough_bytes,
                   mirror_s=core.writethrough_seconds,
                   mirror_host_enqueue_s=core.writethrough_enqueue_seconds,
                   mirror_gb_s=core.writethrough_bytes
                   / core.writethrough_seconds / 1e9
                   if core.writethrough_seconds else None,
                   mirrors_bitwise_equal=bitwise)
        ok = ok and bool(ready) and ready <= moving | set(host) \
            and bitwise and len(host) == core.writethrough_blocks >= 2
    emit(row)
    if not ok:
        raise AssertionError(f"chained enqueue check failed: {row}")
    return row


# ---------------------------------------------------------------------------
# lint: the port's static analysis against the card's own sync report
# ---------------------------------------------------------------------------

SYNC_WARNING = "called a synchronizing CUDA operation"
LINT_PROMPTS = {"long": 1100, "short": 40}     # 3 chunks of 512, and 1
LINT_TOKENS = 32                                # 4 dispatches of 8 steps


def dynalint(*args: str) -> dict:
    """``python -m dynamo_tpu_torch.cli.dynalint --json *args`` in a child
    process; its JSON, with the child's exit code and wall seconds."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "dynamo_tpu_torch.cli.dynalint",
                        "--json", *args], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    if r.returncode != 0:
        raise AssertionError(f"dynalint {' '.join(args)} exited "
                             f"{r.returncode}:\n{r.stdout[-4000:]}\n"
                             f"{r.stderr[-4000:]}")
    out = json.loads(r.stdout)
    out["wall_s"] = time.perf_counter() - t0
    return out


def innermost_port_frame(frame) -> str:
    """``path:line`` of the innermost frame under ``dynamo_tpu_torch/``
    (repo-relative), or "" when no frame of the port is on the stack."""
    pkg = os.path.join(ROOT, "dynamo_tpu_torch") + os.sep
    while frame is not None:
        path = os.path.abspath(frame.f_code.co_filename)
        if path.startswith(pkg):
            return f"{os.path.relpath(path, ROOT)}:{frame.f_lineno}"
        frame = frame.f_back
    return ""


@contextlib.contextmanager
def card_sync_report(torch, on_sync):
    """``torch.cuda.set_sync_debug_mode("warn")``, each report handed to
    ``on_sync(site)`` from a ``warnings.showwarning`` hook (``always``, so
    no repeat is folded), the site being the innermost port frame."""
    import warnings

    def hook(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING in str(message):
            on_sync(innermost_port_frame(sys._getframe(1)))
        else:
            shown(message, category, filename, lineno, file, line)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        shown = warnings.showwarning
        warnings.showwarning = hook
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")


def lint_phase(torch, att, served, smi: str) -> dict:
    """(a) The port's dynalint on this machine: exit 0, and the
    ``host-sync`` inventory. (b) On a core sharing the served weights, two
    requests through admission, a chunked prefill (a 1100-token prompt in
    three 512-token chunks), unchained and chained decode dispatches and
    the token reads, with the card reporting every sync. Each report is
    charged to the core method it ran under and to its innermost frame in
    ``dynamo_tpu_torch/``; a site the inventory lacks is a false negative
    of the ``host-sync`` rule, and fails the phase."""
    import collections
    import dataclasses

    import numpy as np

    from dynamo_tpu_torch.engine.engine import EngineCore
    from dynamo_tpu_torch.llm.protocols.common import (BackendInput,
                                                       StopConditions)

    t_phase = time.perf_counter()
    lint = dynalint()
    if lint["failed"] or lint["findings"] or lint["grandfathered"]:
        raise AssertionError(f"dynalint is not clean here: {lint}")
    inv = dynalint("--report", "host-sync")
    sites = {f"{s['path']}:{s['line']}": s for s in inv["sites"]}

    cfg = dataclasses.replace(served.cfg, max_batch=2, num_pages=None,
                              host_cache_blocks=0,
                              cluster_writethrough=False)
    core = EngineCore(cfg, served.params)
    rng = np.random.default_rng(19)
    for sid, n in LINT_PROMPTS.items():
        core.submit(sid, BackendInput(
            token_ids=[int(t) for t in rng.integers(1000, 30000, n)],
            stop=StopConditions(max_tokens=LINT_TOKENS, ignore_eos=True)))
    # each sync is charged to the core method it ran under
    where = ["step"]
    syncs = collections.defaultdict(collections.Counter)

    def charged(name, fn, kind=None):
        def run(*a, **kw):
            outer = where[0]
            where[0] = kind(core) if kind else name
            try:
                return fn(*a, **kw)
            finally:
                where[0] = outer
        return run

    core._admit_one = charged("admission", core._admit_one)
    core._prefill_dispatch = charged("prefill", core._prefill_dispatch)
    core._dispatch_decode = charged(
        "", core._dispatch_decode,
        lambda c: "decode_chained" if c._inflight else "decode_unchained")
    core._process_oldest_inflight = charged("token_read",
                                            core._process_oldest_inflight)
    _reset_launches(att)
    n0 = (core.prefill_dispatches, core.decode_dispatches,
          core.decode_chained, core.decode_steps_run)
    tokens = collections.Counter()
    t0 = time.perf_counter()
    with card_sync_report(torch, lambda site: syncs[where[0]].update(
            [site])):
        for _ in range(200):
            for so in core.step():
                tokens[so.seq_id] += 1
            if not core.has_work:
                break
    drive_s = time.perf_counter() - t0
    launches = dict(flash=att.flash_attention.launches,
                    paged=att.paged_attention.launches)
    prefill_n = core.prefill_dispatches - n0[0]
    decode_n = core.decode_dispatches - n0[1]
    chained_n = core.decode_chained - n0[2]
    steps_n = core.decode_steps_run - n0[3]
    L = cfg.model.num_layers
    by_kind = {k: dict(v) for k, v in syncs.items()}
    reported = collections.Counter()
    for v in syncs.values():
        reported.update(v)
    unknown = sorted(s for s in reported if s not in sites)
    decode_syncs = sum(sum(syncs[k].values()) for k in (
        "decode_unchained", "decode_chained", "token_read"))
    row = dict(
        phase="lint", card=smi, dynalint_s=lint["elapsed_s"],
        dynalint_wall_s=lint["wall_s"], files=lint["files"],
        rules=len(lint["rules"]), suppressed=len(lint["suppressed"]),
        host_sync_sites=len(sites), host_sync_open=inv["open"],
        prefill_dispatches=prefill_n, decode_dispatches=decode_n,
        chained_dispatches=chained_n, decode_steps=steps_n,
        tokens=dict(tokens), drive_s=drive_s, launches=launches,
        syncs=by_kind,
        syncs_per_prefill_dispatch=sum(syncs["prefill"].values())
        / max(1, prefill_n),
        syncs_per_decode_step=decode_syncs / max(1, steps_n),
        sites={s: {"count": n, "key": sites[s]["key"] if s in sites
                   else None,
                   "reason": sites[s]["reason"] if s in sites else None}
               for s, n in sorted(reported.items())},
        not_in_inventory=unknown, phase_s=time.perf_counter() - t_phase)
    emit(row)
    if unknown:
        raise AssertionError(
            f"the card reported syncs the host-sync inventory lacks (a "
            f"false negative of the rule): {unknown}")
    if "" in reported:
        raise AssertionError("a sync the card reported had no frame of "
                             "the port on its stack")
    if syncs["decode_chained"]:
        raise AssertionError(f"the chained enqueue synced: "
                             f"{dict(syncs['decode_chained'])}")
    if not (prefill_n >= 3 and chained_n >= 1 and decode_n > chained_n
            and tokens == {k: LINT_TOKENS for k in LINT_PROMPTS}
            and not core.has_work):
        raise AssertionError(f"the lint drive did not cover its path: {row}")
    if not (launches["flash"] == L * prefill_n > 0
            and launches["paged"] == L * steps_n > 0):
        raise AssertionError(f"lint: kernel launches do not account for the "
                             f"dispatches: {launches}, {L} layers, "
                             f"{prefill_n} prefill, {steps_n} decode steps")
    return row


# ---------------------------------------------------------------------------
# phase 8: the CLI's default model (tiny-byte, Dh=16) over HTTP
# ---------------------------------------------------------------------------

def serve_default_phase(torch, att, smi: str) -> dict:
    """``in=http out=torch`` with no preset: the synthetic card falls back
    to tiny-byte, whose head dim 16 runs the kernels' Dh=16 instances.
    ``min_tokens`` keeps a random model's early EOS from ending a request
    with no tokens."""
    with served([]) as (core, _, port, model, _, _):
        c = core.core
        m = c.cfg.model
        if (m.head_dim, m.num_heads, m.num_kv_heads, m.vocab_size) != \
                (16, 4, 2, 259):
            raise AssertionError(f"the CLI default is not tiny-byte: {m}")
        common = {"model": model, "min_tokens": 4}
        reqs = {
            "completion": ("/v1/completions", {
                **common, "prompt": "The quick brown fox", "max_tokens": 40}),
            "completion_stream": ("/v1/completions", {
                **common, "prompt": "Once upon a time", "max_tokens": 64,
                "stream": True, "logprobs": 1}),
            "chat": ("/v1/chat/completions", {
                **common, "max_tokens": 40,
                "messages": [{"role": "user", "content": "Say hello."}]}),
            "chat_stream_sampled": ("/v1/chat/completions", {
                **common, "max_tokens": 48, "stream": True,
                "temperature": 0.8, "top_p": 0.9, "seed": 7, "logprobs": 1,
                "messages": [{"role": "user", "content": "Tell a story."}]}),
            "long_prompt": ("/v1/completions", {
                **common, "prompt": "tiny byte model " * 40,
                "max_tokens": 24}),
        }
        b = burst(att, core, port, reqs, "default")
        row = dict(phase="default", model=model, preset="tiny-byte",
                   head_dim=m.head_dim, dtype=str(m.dtype),
                   engine=dict(page_size=c.page_size,
                               max_batch=c.cfg.max_batch,
                               decode_steps=c.cfg.decode_steps),
                   **b, stream_ttft_s=b["results"]["completion_stream"][
                       "ttft_s"], card=smi)
        emit(row)
    return row


# ---------------------------------------------------------------------------
# phase 9: real checkpoints — a HF directory and a GGUF file
# ---------------------------------------------------------------------------

CKPT_DIR = os.path.join(ROOT, "build", "dynamo_tpu_torch", "ckpt")
CKPT_SEED = 8
# Llama-3-8B at full width, depth cut to 4 layers (~3.9 GB of bf16)
CKPT_HF = dict(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
               num_hidden_layers=4, num_attention_heads=32,
               num_key_value_heads=8, head_dim=128, rope_theta=500000.0,
               max_position_embeddings=8192, rms_norm_eps=1e-5,
               tie_word_embeddings=False)
CKPT_SPECIALS = 256                 # ids 128000..128255, as Llama-3's
CKPT_EOS = [128001, 128009]
# Mistral-7B at full width (V=32000), depth cut to 1 layer (~1.9 GB f32)
CKPT_GGUF = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                 num_layers=1, num_heads=32, num_kv_heads=8, head_dim=128,
                 rope_theta=1000000.0, max_position=32768)
CKPT_ENGINE = dict(max_batch=8, max_context=2048, page_size=64,
                   prefill_chunk=512, decode_steps=8)
CKPT_LONG_TOKENS = 1500
LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|"
                r"\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|"
                r"\s+(?!\S)|\s+")
LLAMA3_TEMPLATE = (
    "{% for message in messages %}{{ '<|start_header_id|>' + message['role']"
    " + '<|end_header_id|>\n\n' + message['content'] | trim + '<|eot_id|>' }}"
    "{% endfor %}{% if add_generation_prompt %}"
    "{{ '<|start_header_id|>assistant<|end_header_id|>\n\n' }}{% endif %}")
COMMON_WORDS = (
    "the of and to in is was for on that with as by at from his her it an "
    "were are which this be or has had not but first one their its new "
    "after who they have two been other when there all during into school "
    "time may years more most only over city some world would where later "
    "up such used many can state about national out known university "
    "united then made year people model serve token card weight port load "
    "request stream prefix cache kernel page decode prefill layer head "
    "attention batch memory host device first last quick brown fox jumps "
    "lazy dog once upon story hello say tell").split()


def _words(rng, n: int) -> list:
    """Seeded English-like words: the common words, then syllable words."""
    cons, vows = "bcdfghjklmnprstvwz", "aeiou"
    out = list(COMMON_WORDS)
    while len(out) < n:
        out.append("".join(rng.choice(cons) + rng.choice(vows)
                           for _ in range(rng.randint(1, 4))))
    return out


def llama3_tokenizer_json(seed: int, model_vocab: int, n_special: int):
    """A synthetic Llama-3-style ``tokenizer.json``: the 256 ByteLevel byte
    tokens, merges built from seeded words (each word's prefixes, with and
    without a leading space) until the model vocab holds ``model_vocab``
    entries, ``n_special`` added special tokens after it (Llama-3's
    names), Llama-3's ``Split`` pattern, ``ByteLevel`` and
    ``ignore_merges``. Returns (spec, words)."""
    import random

    from dynamo_tpu_torch.llm.tokenizer_json import BYTES_CHAR

    rng = random.Random(seed)
    vocab = {BYTES_CHAR[b]: b for b in range(256)}
    merges = []
    words = _words(rng, 4 * model_vocab)

    def grow() -> None:
        for w in words:
            for form in ("Ġ" + w, w, "Ġ" + w.capitalize()):
                for k in range(1, len(form)):
                    if form[:k + 1] not in vocab:
                        vocab[form[:k + 1]] = len(vocab)
                        merges.append([form[:k], form[k]])
                        if len(vocab) == model_vocab:
                            return
        raise AssertionError("too few words for the vocab")

    grow()
    names = ["<|begin_of_text|>", "<|end_of_text|>"] + [
        f"<|reserved_special_token_{i}|>" for i in range(4)] + [
        "<|start_header_id|>", "<|end_header_id|>",
        "<|reserved_special_token_4|>", "<|eot_id|>"]
    names += [f"<|reserved_special_token_{i}|>"
              for i in range(5, 5 + n_special - len(names))]
    added = [dict(id=model_vocab + i, content=c, single_word=False,
                  lstrip=False, rstrip=False, normalized=False, special=True)
             for i, c in enumerate(names)]
    byte_level = {"type": "ByteLevel", "add_prefix_space": False,
                  "trim_offsets": True, "use_regex": False}
    spec = {"version": "1.0", "truncation": None, "padding": None,
            "added_tokens": added, "normalizer": None,
            "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
                {"type": "Split", "pattern": {"Regex": LLAMA3_SPLIT},
                 "behavior": "Isolated", "invert": False}, byte_level]},
            "post_processor": dict(byte_level, use_regex=True),
            "decoder": dict(byte_level, use_regex=True),
            "model": {"type": "BPE", "dropout": None, "unk_token": None,
                      "continuing_subword_prefix": None,
                      "end_of_word_suffix": None, "fuse_unk": False,
                      "byte_fallback": False, "ignore_merges": True,
                      "vocab": vocab, "merges": merges}}
    return spec, words


def spm_vocab(seed: int, n: int) -> dict:
    """GGUF metadata of a synthetic SPM vocab of ``n`` pieces: <unk>, <s>,
    </s>, the 256 ``<0xNN>`` byte pieces, then seeded word pieces with and
    without ``▁``, scored by rank."""
    import random

    rng = random.Random(seed)
    pieces = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    types = [2, 3, 3] + [6] * 256
    seen = set(pieces)
    for w in _words(rng, 2 * n):
        for p in ("▁" + w, w, w[:2], w[2:]):
            if len(pieces) < n and p and p not in seen:
                seen.add(p)
                pieces.append(p)
                types.append(1)
        if len(pieces) >= n:
            break
    scores = [0.0] * 259 + [-1.0 - i / 1000.0 for i in range(n - 259)]
    return {"tokenizer.ggml.model": "llama", "tokenizer.ggml.tokens": pieces,
            "tokenizer.ggml.scores": scores,
            "tokenizer.ggml.token_type": types,
            "tokenizer.ggml.bos_token_id": 1,
            "tokenizer.ggml.eos_token_id": 2,
            "tokenizer.ggml.add_bos_token": True}


class RssPeak:
    """Peak growth of this process's resident set while the block runs,
    sampled from /proc/self/status every 2 ms: anonymous memory (a host
    copy of the model would show here), file-backed pages (the mapped
    checkpoint) and shared memory, in bytes."""

    FIELDS = ("VmRSS", "RssAnon", "RssFile", "RssShmem")

    def _read(self) -> dict:
        # a kernel may lack the split fields: only VmRSS is sure
        out = {}
        with open("/proc/self/status") as f:
            for line in f:
                k, _, v = line.partition(":")
                if k in self.FIELDS:
                    out[k] = int(v.split()[0]) * 1024
        if "VmRSS" not in out:
            raise AssertionError("/proc/self/status has no VmRSS")
        return out

    def __enter__(self):
        self.start = self._read()
        self.peak = dict(self.start)
        self._stop = threading.Event()

        def poll():
            while not self._stop.wait(0.002):
                for k, v in self._read().items():
                    self.peak[k] = max(self.peak[k], v)
        self._t = threading.Thread(target=poll, daemon=True)
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join()
        for k, v in self._read().items():
            self.peak[k] = max(self.peak[k], v)
        self.growth = {k: self.peak[k] - self.start[k] for k in self.start}
        return False


@contextlib.contextmanager
def measured_load(torch, module, name: str, out: dict):
    """Wrap ``module.name`` (the engine's loader entry) to record its
    seconds, to the device's completion, and its peak host RSS growth."""
    orig = getattr(module, name)

    def wrapped(*a, **kw):
        with RssPeak() as rss:
            t0 = time.perf_counter()
            res = orig(*a, **kw)
            if DEVICE == "cuda":
                torch.cuda.synchronize()
            out["load_s"] = time.perf_counter() - t0
        out["host_rss_growth_bytes"] = rss.growth
        return res

    setattr(module, name, wrapped)
    try:
        yield out
    finally:
        setattr(module, name, orig)


def _leaf_bits(torch, t):
    t = t.detach().to("cpu").contiguous()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _same_bits(torch, a, b) -> bool:
    return a.shape == b.shape and torch.equal(_leaf_bits(torch, a),
                                              _leaf_bits(torch, b))


def checkpoint_hf_case(torch, att, smi: str) -> dict:
    """Llama-3-8B widths at 4 layers as a HF directory: random bf16 weights
    from the seed in two shards (the port's writer), config, generation and
    tokenizer configs, and a synthetic 128256-entry tokenizer.json; served
    through ``cli.run --model-path``; leaves, prompt counts, launches and a
    greedy stream checked against the written weights."""
    import shutil

    from dynamo_tpu_torch.engine import loader
    from dynamo_tpu_torch.llm.preprocessor import Preprocessor
    from dynamo_tpu_torch.llm.tokenizer import load_tokenizer
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.obs.flows import flow_ledger

    d = os.path.join(CKPT_DIR, "llama3-8b-4l")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    hf = dict(architectures=["LlamaForCausalLM"], model_type="llama",
              torch_dtype="bfloat16", bos_token_id=CKPT_HF["vocab_size"]
              - CKPT_SPECIALS, eos_token_id=CKPT_EOS, **CKPT_HF)
    cfg = llama.LlamaConfig.from_hf_config(hf)
    dev = torch.device(DEVICE)
    # the weights: the seeded init on the card, kept on the host as the
    # tree to compare against
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(CKPT_SEED)
    dev_tree = llama.init_params(cfg, gen, dev)
    host = {k: (v.to("cpu") if k != "layers" else
                {n: x.to("cpu") for n, x in v.items()})
            for k, v in dev_tree.items()}
    del dev_tree
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loader.save_llama_params(d, host, cfg, shards=2, dtype=None)
    write_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(hf, f)
    with open(os.path.join(d, "generation_config.json"), "w") as f:
        json.dump({"bos_token_id": hf["bos_token_id"],
                   "eos_token_id": CKPT_EOS}, f)
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"chat_template": LLAMA3_TEMPLATE,
                   "bos_token": "<|begin_of_text|>",
                   "eos_token": "<|eot_id|>"}, f)
    spec, words = llama3_tokenizer_json(
        CKPT_SEED, CKPT_HF["vocab_size"] - CKPT_SPECIALS, CKPT_SPECIALS)
    with open(os.path.join(d, "tokenizer.json"), "w") as f:
        json.dump(spec, f)
    t0 = time.perf_counter()
    tok = load_tokenizer(d)
    tok_load_ms = 1e3 * (time.perf_counter() - t0)
    if tok.vocab_size != CKPT_HF["vocab_size"]:
        raise AssertionError(f"tokenizer vocab {tok.vocab_size}")
    # a ~1.5k-token prompt of seeded words
    import random

    rng = random.Random(CKPT_SEED)
    parts, n = [], 0
    while n < CKPT_LONG_TOKENS:
        chunk = " ".join(rng.choice(words[:5000]) for _ in range(40))
        parts.append(chunk.capitalize() + ".")
        n = len(tok.encode(" ".join(parts)))
    long_prompt = " ".join(parts)
    t0 = time.perf_counter()
    long_ids = tok.encode(long_prompt)
    encode_ms = 1e3 * (time.perf_counter() - t0)

    load: dict = {}
    wp0 = flow_ledger().total_bytes("weight_prefetch")
    argv = ["--model-path", d, "--extra-engine-args", json.dumps(CKPT_ENGINE)]
    with measured_load(torch, loader, "load_llama_params", load), \
            served(argv) as (core, loop, port, model, init_s, manager):
        c = core.core
        if c.cfg.model.num_layers != CKPT_HF["num_hidden_layers"] or \
                c.cfg.model.vocab_size != CKPT_HF["vocab_size"]:
            raise AssertionError(f"served model is not the checkpoint: "
                                 f"{c.cfg.model}")
        leaves = {
            "embed": (c.params["embed"], host["embed"]),
            "layers.wq[0]": (c.params["layers"]["wq"][0],
                             host["layers"]["wq"][0]),
            "layers.wd[3]": (c.params["layers"]["wd"][3],
                             host["layers"]["wd"][3]),
            "lm_head": (c.params["lm_head"], host["lm_head"]),
        }
        bitwise = {k: _same_bits(torch, a, b) for k, a, b in
                   ((k, *v) for k, v in leaves.items())}
        if not all(bitwise.values()):
            raise AssertionError(f"loaded leaves differ: {bitwise}")
        pre = Preprocessor(manager.get(model).card, tok)
        msgs = {"chat": [{"role": "user", "content": "Say hello."}],
                "chat_stream": [{"role": "user",
                                 "content": "Tell a story."}]}
        reqs = {
            "completion": ("/v1/completions", {
                "model": model, "prompt": "The quick brown fox",
                "max_tokens": 32}),
            "completion_stream": ("/v1/completions", {
                "model": model, "prompt": "Once upon a time",
                "max_tokens": 32, "stream": True, "logprobs": 1}),
            "chat": ("/v1/chat/completions", {
                "model": model, "max_tokens": 32,
                "messages": msgs["chat"]}),
            "chat_stream": ("/v1/chat/completions", {
                "model": model, "max_tokens": 32, "stream": True,
                "messages": msgs["chat_stream"]}),
            "long_prompt": ("/v1/completions", {
                "model": model, "prompt": long_prompt, "max_tokens": 16}),
        }
        b = burst(att, core, port, reqs, "checkpoint")
        want = {"completion": len(tok.encode("The quick brown fox")),
                "completion_stream": len(tok.encode("Once upon a time")),
                "long_prompt": len(long_ids)}
        for k, m in msgs.items():
            want[k] = len(tok.encode(pre.render_chat(m)))
        got = {k: r["usage"]["prompt_tokens"]
               for k, r in b["results"].items()}
        if got != want:
            raise AssertionError(f"prompt_tokens {got} != the port's own "
                                 f"encodings {want}")
        rid = b["results"]["long_prompt"]["rid"]
        status, body = http_get(port, f"/v1/traces/{rid}")
        spans = {s["name"]: s for s in json.loads(body)["spans"]}
        pre_ms = 1e3 * (spans["preprocess"]["end"]
                        - spans["preprocess"]["start"])
        # loading changed nothing: one greedy stream against an engine
        # built from the same host tensors through params_from_jax
        from dynamo_tpu_torch.engine.engine import TorchEngine

        prompt = long_ids[:64]
        loaded_toks, _, ttft, _ = _generate(core, loop, prompt)
        direct = TorchEngine(c.cfg, params=llama.params_from_jax(
            host, c.cfg.model, dev))
        try:
            direct_toks, _, _, _ = _generate(direct, loop, prompt)
        finally:
            direct.shutdown()
        if loaded_toks != direct_toks:
            raise AssertionError(f"loaded {loaded_toks} != direct "
                                 f"{direct_toks}")
        st = b["results"]["completion_stream"]
    # the cold load's one weight_prefetch flow (obs/flows)
    flow_bytes = flow_ledger().total_bytes("weight_prefetch") - wp0
    if flow_bytes != _nbytes(host):
        raise AssertionError(f"weight_prefetch flow {flow_bytes} bytes != "
                             f"the tree's {_nbytes(host)}")
    row = dict(phase="checkpoint", case="hf-dir", model="llama-3-8b",
               layers=CKPT_HF["num_hidden_layers"], reduced="depth 32 -> 4",
               shards=2, dtype="bf16", checkpoint_bytes=nbytes,
               gen_s=gen_s, write_s=write_s, load_s=load["load_s"],
               load_gb_s=nbytes / load["load_s"] / 1e9,
               host_rss_growth_bytes=load["host_rss_growth_bytes"],
               weight_prefetch_bytes=flow_bytes, engine_init_s=init_s,
               tokenizer_load_ms=tok_load_ms,
               long_prompt_tokens=len(long_ids), encode_ms=encode_ms,
               preprocess_span_ms=pre_ms, bitwise_leaves=bitwise,
               prompt_tokens=got, greedy_tokens=loaded_toks,
               greedy_equal_direct=True, ttft_s=ttft,
               stream_ttft_s=st["ttft_s"],
               **{k: v for k, v in b.items() if k != "results"}, card=smi)
    emit(row)
    return row


def checkpoint_gguf_case(torch, att, smi: str) -> dict:
    """Mistral-7B widths at 1 layer as an F32 GGUF with an embedded SPM
    vocab, served through ``cli.run --model-path m.gguf``."""
    import shutil

    from dynamo_tpu_torch.llm import gguf
    from dynamo_tpu_torch.llm.tokenizer import load_tokenizer

    d = os.path.join(CKPT_DIR, "mistral-7b-1l")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    path = os.path.join(d, "m.gguf")
    g = CKPT_GGUF
    D, V, F, L = (g["hidden_size"], g["vocab_size"], g["intermediate_size"],
                  g["num_layers"])
    q, kv = g["num_heads"] * g["head_dim"], g["num_kv_heads"] * g["head_dim"]
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(CKPT_SEED + 1)

    def w(out_f, in_f):
        return (torch.randn((out_f, in_f), generator=gen, device=dev)
                / in_f ** 0.5).to("cpu")

    t0 = time.perf_counter()
    tensors = {"token_embd.weight": w(V, D), "output_norm.weight":
               torch.ones(D), "output.weight": w(V, D)}
    for i in range(L):
        tensors.update({
            f"blk.{i}.attn_norm.weight": torch.ones(D),
            f"blk.{i}.ffn_norm.weight": torch.ones(D),
            f"blk.{i}.attn_q.weight": w(q, D),
            f"blk.{i}.attn_k.weight": w(kv, D),
            f"blk.{i}.attn_v.weight": w(kv, D),
            f"blk.{i}.attn_output.weight": w(D, q),
            f"blk.{i}.ffn_gate.weight": w(F, D),
            f"blk.{i}.ffn_up.weight": w(F, D),
            f"blk.{i}.ffn_down.weight": w(D, F)})
    gen_s = time.perf_counter() - t0
    meta = {"general.architecture": "llama",
            "llama.embedding_length": D, "llama.block_count": L,
            "llama.attention.head_count": g["num_heads"],
            "llama.attention.head_count_kv": g["num_kv_heads"],
            "llama.attention.key_length": g["head_dim"],
            "llama.feed_forward_length": F,
            "llama.rope.freq_base": g["rope_theta"],
            "llama.context_length": g["max_position"],
            "llama.attention.layer_norm_rms_epsilon": 1e-5,
            **spm_vocab(CKPT_SEED, V)}
    t0 = time.perf_counter()
    gguf.write_gguf(path, meta, tensors)
    write_s = time.perf_counter() - t0
    nbytes = os.path.getsize(path)
    load: dict = {}
    argv = ["--model-path", path, "--extra-engine-args",
            json.dumps(CKPT_ENGINE)]
    with measured_load(torch, gguf, "load_llama_params_gguf", load), \
            served(argv) as (core, _, port, model, init_s, manager):
        c = core.core
        card = manager.get(model).card
        if not card.tokenizer.startswith("gguf-sp:"):
            raise AssertionError(f"GGUF card tokenizer {card.tokenizer}")
        bf = torch.bfloat16
        p = c.params
        leaves = {
            "embed": (p["embed"], tensors["token_embd.weight"].to(bf)),
            "layers.wq[0]": (p["layers"]["wq"][0], tensors[
                "blk.0.attn_q.weight"].to(bf).T.reshape(
                D, g["num_heads"], g["head_dim"])),
            "layers.wd[0]": (p["layers"]["wd"][0],
                             tensors["blk.0.ffn_down.weight"].to(bf).T),
            "lm_head": (p["lm_head"], tensors["output.weight"].to(bf).T),
        }
        bitwise = {k: _same_bits(torch, a, b) for k, (a, b) in
                   leaves.items()}
        if not all(bitwise.values()):
            raise AssertionError(f"GGUF leaves differ: {bitwise}")
        reqs = {
            "completion": ("/v1/completions", {
                "model": model, "prompt": "The quick brown fox jumps",
                "max_tokens": 24}),
            "chat_stream": ("/v1/chat/completions", {
                "model": model, "max_tokens": 24, "stream": True,
                "logprobs": 1,
                "messages": [{"role": "user", "content": "Say hello."}]}),
        }
        b = burst(att, core, port, reqs, "checkpoint-gguf")
        tok_ids = len(load_tokenizer(card.tokenizer).encode(
            "The quick brown fox jumps"))
        if b["results"]["completion"]["usage"]["prompt_tokens"] != tok_ids:
            raise AssertionError("GGUF prompt tokens differ from the "
                                 "port's own SPM encoding")
    row = dict(phase="checkpoint", case="gguf", model="mistral-7b",
               layers=L, reduced="depth 32 -> 1", dtype="f32 -> bf16",
               checkpoint_bytes=nbytes, gen_s=gen_s, write_s=write_s,
               load_s=load["load_s"],
               load_gb_s=nbytes / load["load_s"] / 1e9,
               host_rss_growth_bytes=load["host_rss_growth_bytes"],
               engine_init_s=init_s, tokenizer=card.tokenizer.split(":")[0],
               bitwise_leaves=bitwise,
               **{k: v for k, v in b.items() if k != "results"}, card=smi)
    emit(row)
    return row


def checkpoint_phase(torch, att, smi: str) -> dict:
    hf = checkpoint_hf_case(torch, att, smi)
    gg = checkpoint_gguf_case(torch, att, smi)
    return dict(hf=hf, gguf=gg,
                flash_launches=hf["flash_launches"] + gg["flash_launches"],
                paged_launches=hf["paged_launches"] + gg["paged_launches"])


# ---------------------------------------------------------------------------
# the fleet: the port's store, two torch workers, router and frontend
# ---------------------------------------------------------------------------

FLEET_DIR = os.path.join(ROOT, "build", "dynamo_tpu_torch", "fleet")
FLEET_PREFIX_TOKENS, FLEET_SUFFIX_TOKENS, FLEET_SEED = 1024, 64, 1024
FLEET_START_S = 600          # the slowest start: two 8B workers at once
FLEET_METRICS_S = 0.25       # the workers' metrics interval
FLEET_LONG_TOKENS = 384      # keeps A's worker busy while B is routed
FLEET_REGION_S = 0.5         # the regional aggregator's merge interval
# the plane probe's request: 64 parts of one layer's K or V of the
# 1496-token reuse prompt (Llama-3-8B: 8 kv heads x 128 x bf16), as the
# disagg push moves them
PROBE_PARTS, PROBE_PART_BYTES = 64, REUSE_PROMPT * 8 * 128 * 2
PROBE_ITEMS = 2000
# a turn's items stream stops here: on the card an asyncio turn has read
# 8-40 ms an item (not understood), which would cost the phase minutes
PROBE_ITEMS_S = 3.0
# the C-ABI publisher's throwaway worker id (no worker has it)
CABI_WORKER = 0xC0FFEE


class Fleet:
    """Child processes of the port's own entry points
    (``python -m dynamo_tpu_torch...``), each logging to a file under
    ``root`` (``FLEET_DIR`` by default). Never forks: every child is a
    fresh interpreter, on the native data plane and, for a store, the
    C++ dynstore (the CLI execs it in its own place), so a broken native
    build fails the phase. ``stop`` kills whatever is still running."""

    def __init__(self, root: str = FLEET_DIR):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.procs: dict = {}
        # the children run with the default liveness lease TTL (10 s)
        self.env = dict(os.environ, PYTHONPATH=ROOT, PYTHONUNBUFFERED="1",
                        DYNAMO_TPU_DATAPLANE="native",
                        DYNAMO_TPU_STORE="native")

    def planes(self, serving=()) -> dict:
        """What each child serves on: a store child's program (the C++
        dynstore or the asyncio server), every other child's data plane
        as its ``data plane: <kind> on port`` log line names it (None for
        a child that serves no endpoint). Fails unless every store and
        every named ``serving`` child is native."""
        import re

        out = {}
        for name, (proc, _) in self.procs.items():
            if name.startswith("store"):
                try:
                    exe = os.path.basename(os.readlink(f"/proc/{proc.pid}/exe"))
                except OSError:
                    exe = "gone"
                out[name] = "native" if exe.startswith("dynstore-") else exe
            else:
                kinds = re.findall(r"data plane: (\w+) on port",
                                   self.log(name))
                out[name] = kinds[-1] if kinds else None
        bad = {n: k for n, k in out.items()
               if k not in ("native", None)
               or (k is None and (n.startswith("store") or n in serving))}
        if bad:
            raise AssertionError(f"children not on the native plane and "
                                 f"store: {bad} (all: {out})")
        return out

    def start(self, name: str, module: str, *args: str):
        log = open(os.path.join(self.root, f"{name}.log"), "w")
        proc = subprocess.Popen([sys.executable, "-m", module, *args],
                                stdout=log, stderr=subprocess.STDOUT,
                                cwd=ROOT, env=self.env,
                                start_new_session=True)
        self.procs[name] = (proc, log)
        return proc

    def log(self, name: str) -> str:
        with open(os.path.join(self.root, f"{name}.log")) as f:
            return f.read()

    def wait_line(self, name: str, pattern: str, timeout: float) -> str:
        """The first log line of ``name`` matching ``pattern`` (a regex);
        fails if the process exits or the line is not there in time."""
        import re

        proc = self.procs[name][0]
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            m = re.search(pattern, self.log(name))
            if m:
                return m.group(0)
            if proc.poll() is not None:
                raise AssertionError(f"fleet {name} exited {proc.returncode}"
                                     f":\n{self.log(name)[-3000:]}")
            time.sleep(0.1)
        raise AssertionError(f"fleet {name}: no {pattern!r} in {timeout} s:"
                             f"\n{self.log(name)[-3000:]}")

    def wedges(self) -> dict:
        """Each child's event-loop stalls as its watchdog logged them
        ("event_loop wedged for X s"), in seconds."""
        import re

        return {name: [float(x) for x in re.findall(
            r"event_loop wedged for ([0-9.]+)s", self.log(name))]
            for name in self.procs}

    def stop(self) -> None:
        for name, (proc, log) in self.procs.items():
            if proc.poll() is None:
                proc.terminate()
        for name, (proc, log) in self.procs.items():
            try:
                proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=20)
            log.close()


def _fleet_stage(port: int) -> dict:
    """The frontend's ``/metrics`` samples of the workers' stage dumps
    (``component="backend"``)."""
    return {k: v for k, v in scrape(port).items()
            if 'component="backend"' in k}


def _per_worker(sc: dict, name: str, label: str = "") -> dict:
    """{worker hex: {label value: sample}} of a worker-labelled series
    (label value "" for a series with no label but ``worker``)."""
    import re

    out: dict = {}
    for key, val in sc.items():
        if key.startswith(name + "{"):
            w = re.search(r'worker="([0-9a-f]+)"', key).group(1)
            lv = re.search(label + r'="([^"]+)"', key) if label else None
            out.setdefault(w, {})[lv.group(1) if lv else ""] = val
    return out


async def _fleet_async(fleet: Fleet, store_port: int, http_port: int,
                       smi: str) -> dict:
    import asyncio

    import numpy as np

    from dynamo_tpu_torch.llm.kv_router.indexer import KvIndexer
    from dynamo_tpu_torch.llm.kv_router.protocols import (KV_EVENT_SUBJECT,
                                                          RouterEvent)
    from dynamo_tpu_torch.llm.protocols.common import (BackendInput,
                                                       EngineOutput,
                                                       StopConditions)
    from dynamo_tpu_torch.llm.remote import RemoteCoreEngine
    from dynamo_tpu_torch.runtime import _msgpack, wire
    from dynamo_tpu_torch.runtime.component import DistributedRuntime
    from dynamo_tpu_torch.runtime.engine import Context

    page = ENGINE_ARGS["page_size"]
    drt = await DistributedRuntime(store_port=store_port).connect()
    try:
        backend = drt.namespace("dynamo").component("backend")
        workers = await backend.endpoint("generate").client().start()
        await workers.wait_for_instances(2, timeout=60)
        router = await drt.namespace("dynamo").component("router") \
            .endpoint("route").client().start()
        await router.wait_for_instances(1, timeout=60)
        # the router's view of the KV events, rebuilt here from the same
        # subject it subscribes to
        index = KvIndexer(page)

        async def on_event(payload):
            index.apply_sync(RouterEvent.from_dict(payload))

        await backend.subscribe(KV_EVENT_SUBJECT, on_event)

        async def post(body, path="/v1/completions"):
            res: dict = {}
            await asyncio.to_thread(http_post, http_port, path, body, res,
                                    "r")
            return res["r"]

        async def decisions():
            st, raw = await asyncio.to_thread(http_get, http_port,
                                              "/v1/router/decisions")
            if st != 200:
                raise AssertionError(f"/v1/router/decisions answered {st}")
            d = json.loads(raw)
            return d.get("decisions", d)

        async def metrics_of(wid):
            raw = await drt.store.get(f"metrics/dynamo/backend/{wid:x}")
            return json.loads(raw.decode())

        sc0 = await asyncio.to_thread(_fleet_stage, http_port)
        # warm-up: one request per worker, then a lone stream timed
        # through the fleet (frontend -> router -> worker)
        for i in range(2):
            await post({"model": PRESET, "prompt": f"warm up {i}",
                        "max_tokens": 4})
        lone = await asyncio.to_thread(lone_stream, http_port)
        engine = RemoteCoreEngine(workers, router, model_name=PRESET)
        lone["greedy_ids"] = await greedy_ids(engine)

        # 1. prefix A, then four requests sharing it
        rng = np.random.default_rng(FLEET_SEED)
        letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz     ", np.uint8)
        a_text = bytes(rng.choice(letters, FLEET_PREFIX_TOKENS)).decode()
        a_tokens = list(a_text.encode())
        n_blocks = FLEET_PREFIX_TOKENS // page
        ra = await post({"model": PRESET, "prompt": a_text,
                         "max_tokens": 8})
        dec = await decisions()
        wa = dec[-1]["worker_id"]
        (wb,) = set(workers.instances) - {wa}
        t0 = time.monotonic()
        while index.find_matches_for_tokens(a_tokens).scores.get(wa, 0) \
                < n_blocks:
            if time.monotonic() - t0 > 30:
                raise AssertionError("prefix A's KV events did not arrive")
            await asyncio.sleep(0.02)
        events_s = time.monotonic() - t0
        await asyncio.sleep(0.2)
        hits, shared = [], []
        n0 = len(await decisions())
        for i in range(4):
            suffix = bytes(rng.choice(letters, FLEET_SUFFIX_TOKENS)).decode()
            bi = BackendInput(token_ids=a_tokens + list(suffix.encode()),
                              stop=StopConditions(max_tokens=8,
                                                  ignore_eos=True))
            hit, n_tok = None, 0
            async for out in engine.generate(bi, Context()):
                if hit is None and out.kv_prefix_hit_tokens is not None:
                    hit = out.kv_prefix_hit_tokens
                n_tok += len(out.token_ids)
            hits.append(hit)
            shared.append(n_tok)
        dec = await decisions()
        shared_dec = dec[n0:]
        bad = [d for d in shared_dec if d["worker_id"] != wa
               or d["overlap_blocks"] < n_blocks]
        if len(shared_dec) != 4 or bad or shared != [8] * 4 \
                or any(h is None or h < FLEET_PREFIX_TOKENS for h in hits):
            raise AssertionError(
                f"prefix-A requests not routed by overlap: hits {hits}, "
                f"tokens {shared}, decisions {shared_dec}")

        # 2. prefix B while A's worker is busy: placed by load
        long_bi = BackendInput(token_ids=a_tokens + [32] * 8,
                               stop=StopConditions(
                                   max_tokens=FLEET_LONG_TOKENS,
                                   ignore_eos=True))

        async def drain_long():
            n = 0
            async for out in engine.generate(long_bi, Context()):
                n += len(out.token_ids)
            return n

        long_task = asyncio.ensure_future(drain_long())
        t0 = time.monotonic()
        while (await metrics_of(wa))["request_active_slots"] < 1:
            if long_task.done() or time.monotonic() - t0 > 30:
                raise AssertionError("A's worker never reported busy")
            await asyncio.sleep(0.05)
        await asyncio.sleep(1.2)       # two router scrapes
        n0 = len(await decisions())
        # each B request on a prefix of its own: no worker holds any of it,
        # so overlap cannot place it
        rb = []
        for i in range(2):
            if i:
                # the first B request's slot must show free at the router
                # (published, then scraped) before the second is placed
                t0 = time.monotonic()
                while (await metrics_of(wb))["request_active_slots"] > 0:
                    if time.monotonic() - t0 > 30:
                        raise AssertionError("B's worker never went idle")
                    await asyncio.sleep(0.05)
                await asyncio.sleep(1.2)       # two router scrapes
            rb.append(await post({
                "model": PRESET, "max_tokens": 8,
                "prompt": bytes(rng.choice(letters, 256)).decode()}))
        b_dec = (await decisions())[n0:]
        busy_at_b = not long_task.done()
        long_tokens = await asyncio.wait_for(long_task, 300)
        b_terms = []
        for d in b_dec:
            cands = {c["worker_id"]: c for c in d["candidates"]}
            a, b = cands.get(wa), cands.get(wb)
            if a is None or b is None:
                raise AssertionError(f"prefix-B decision lacks a worker: {d}")
            for c in (a, b):
                # the audit's logit is the default cost of its own terms
                want = 2.0 * c["overlap_norm"] - c["cache_usage"] \
                    - c["load"] - c["kv_bytes_frac"]
                if abs(c["logit"] - want) > 1e-3:
                    raise AssertionError(f"audited logit {c} is not the "
                                         f"cost of its terms ({want})")
            b_terms.append(dict(
                overlap_blocks=[a["overlap_blocks"], b["overlap_blocks"]],
                load=[a["load"], b["load"]],
                cache_usage=[a["cache_usage"], b["cache_usage"]],
                kv_bytes_frac=[a["kv_bytes_frac"], b["kv_bytes_frac"]],
                lead=b["logit"] - a["logit"],
                lead_without_load=(b["logit"] + b["load"])
                - (a["logit"] + a["load"])))
        # placed by load: no overlap on either worker, A's worker audited
        # busier, and the other worker's lead holds at least that load gap
        if long_tokens != FLEET_LONG_TOKENS or not busy_at_b \
                or [d["worker_id"] for d in b_dec] != [wb, wb] \
                or any(t["overlap_blocks"] != [0, 0]
                       or not t["load"][0] > t["load"][1]
                       or t["lead"] < t["load"][0] - t["load"][1] - 1e-3
                       for t in b_terms):
            raise AssertionError(f"prefix-B requests not placed by load: "
                                 f"busy {busy_at_b}, {b_terms}, {b_dec}")

        # 3. one trace across processes: request A's
        await asyncio.sleep(1.0)           # span sinks flush every 0.25 s
        stc, raw = await asyncio.to_thread(http_get, http_port,
                                           f"/v1/traces/{ra['rid']}")
        spans = json.loads(raw)["spans"] if stc == 200 else []
        pids = {s["pid"] for s in spans}
        comps = {s["component"] for s in spans}
        route_ms = [1e3 * (s["end"] - s["start"]) for s in spans
                    if s["name"] == "rpc:route"]
        if len(pids) < 3 or not {"http", "router",
                                 "decode_worker"} <= comps:
            raise AssertionError(f"trace {ra['rid']} spans {len(spans)} "
                                 f"from pids {pids}, components {comps}")
        # the router's own audit: every decision's time in the route span
        route_decisions_ms = sorted(route_ms)

        # 4. the stage dumps: both workers' dispatches and kernel launches
        await asyncio.sleep(4 * FLEET_METRICS_S)
        sc1 = await asyncio.to_thread(_fleet_stage, http_port)
        disp0 = _per_worker(sc0, "dyn_engine_dispatches_total", "kind")
        disp1 = _per_worker(sc1, "dyn_engine_dispatches_total", "kind")
        kern0 = _per_worker(sc0, "dyn_kernel_launches_total", "kernel")
        kern1 = _per_worker(sc1, "dyn_kernel_launches_total", "kernel")
        peak = _per_worker(sc1, "dyn_device_memory_peak_bytes")
        from dynamo_tpu_torch.models.llama import preset

        L = preset(PRESET).num_layers
        on_card = DEVICE == "cuda"     # the wrappers count card launches
        per_worker = {}
        for w in (f"{wa:x}", f"{wb:x}"):
            d = {k: disp1[w][k] - disp0.get(w, {}).get(k, 0.0)
                 for k in disp1[w]}
            k = {n: kern1[w][n] - kern0.get(w, {}).get(n, 0.0)
                 for n in kern1[w]}
            per_worker[w] = dict(dispatches=d, launches=k,
                                 peak_mem_bytes=peak.get(w, {}).get(""),
                                 forward_pass_metrics=await metrics_of(
                                     int(w, 16)))
            if not (d["prefill"] > 0 and d["decode"] > 0
                    and k["flash_attention"] == L * d["prefill"] * on_card
                    and k["paged_attention"]
                    == L * d["decode_step"] * on_card):
                raise AssertionError(f"worker {w}: kernel launches do not "
                                     f"account for its dispatches: {d} {k}")

        # 5. the codec: one EngineOutput frame, packed and read back
        out_dict = EngineOutput(token_ids=[12345], cum_log_prob=-1.5,
                                kv_prefix_hit_tokens=1024).to_dict()
        frame = [{wire.KIND_KEY: "data"}, json.dumps(out_dict).encode()]
        body = wire.pack(frame)[4:]
        n = 20000
        t0 = time.perf_counter()
        for _ in range(n):
            _msgpack.packb(frame)
        pack_us = 1e6 * (time.perf_counter() - t0) / n
        t0 = time.perf_counter()
        for _ in range(n):
            _msgpack.unpackb(body)
        unpack_us = 1e6 * (time.perf_counter() - t0) / n

        # asyncio items turns around the region read and the C-ABI
        # publisher, and one in a fresh process: where the asyncio plane's
        # stalls (an item in milliseconds with the CPU idle) come on
        stall = {"fresh_process": await asyncio.to_thread(
            probe_turn_fresh, store_port)}
        stall["before_region"] = await probe_turn(
            store_port, "python", "stall0", parts_too=False)

        # 6. the region plane: the aggregator's record, read as every
        # observer reads stage dumps, against the frontend's flat scrape
        # (through the sharded client) of the same quiet moment
        region = await region_check(drt.store, http_port)
        stall["after_region"] = await probe_turn(
            store_port, "python", "stall1", parts_too=False)

        # 7. KV events through the C ABI, read back from the live subject
        cabi = await cabi_check(backend, store_port, index, page)

        # 8. the data plane's own cost, each plane in turn (its first turn
        # is the asyncio one after the C-ABI publisher)
        probe = await plane_probe(store_port)
        stall["after_cabi"] = dict(probe["python"][0], plane="python")
        if any(r["plane"] != "python" for r in stall.values()):
            raise AssertionError(f"stall turns off the asyncio plane: "
                                 f"{stall}")
        return dict(
            holder=f"{wa:x}", other=f"{wb:x}", prefix_tokens=len(a_tokens),
            kv_events_s=events_s, prefix_hits=hits,
            shared_overlap_blocks=[d["overlap_blocks"] for d in shared_dec],
            b_workers=[f"{d['worker_id']:x}" for d in b_dec],
            b_terms=b_terms, b_status=[r["status"] for r in rb],
            trace_spans=len(spans), trace_pids=len(pids),
            trace_components=sorted(comps),
            route_span_ms=route_decisions_ms,
            fleet_lone_stream=lone,
            engine_output_pack_us=pack_us,
            engine_output_unpack_us=unpack_us, frame_bytes=len(body),
            dataplane_us_per_item_native=[r["us_per_item"]
                                          for r in probe["native"]],
            dataplane_us_per_item_asyncio=[r["us_per_item"]
                                           for r in probe["python"]],
            plane_probe=probe, asyncio_stall_turns=stall, region=region,
            cabi=cabi,
            workers=per_worker, card=smi)
    finally:
        await drt.close()


async def probe_turn(store_port: int, mode: str, name: str,
                     parts_too: bool = True) -> dict:
    """One turn of the plane probe on plane ``mode`` ("python" is the
    asyncio plane), both ends on this process's one loop: µs an item of a
    stream of EngineOutput frames (PROBE_ITEMS, or as many as arrive in
    PROBE_ITEMS_S) with this process's CPU time over them, and with
    ``parts_too`` GB/s of PROBE_PARTS parts of PROBE_PART_BYTES pushed
    through an endpoint that drains them. Returns the row with the plane
    the runtime served on."""
    from dynamo_tpu_torch.runtime.component import DistributedRuntime

    saved = os.environ.get("DYNAMO_TPU_DATAPLANE")
    os.environ["DYNAMO_TPU_DATAPLANE"] = mode    # read at the first serve
    try:
        drt = await DistributedRuntime(store_port=store_port).connect()
        try:
            return await _probe_turn(drt, name, mode, parts_too)
        finally:
            await drt.close()
    finally:
        if saved is None:
            os.environ.pop("DYNAMO_TPU_DATAPLANE", None)
        else:
            os.environ["DYNAMO_TPU_DATAPLANE"] = saved


async def _probe_turn(drt, name: str, mode: str, parts_too: bool) -> dict:
    from dynamo_tpu_torch.llm.protocols.common import EngineOutput

    item = EngineOutput(token_ids=[12345], cum_log_prob=-1.5,
                        kv_prefix_hit_tokens=1024).to_dict()
    part = bytes(PROBE_PART_BYTES)

    async def items(request, ctx):
        for _ in range(request["n"]):
            yield item

    async def drain(request, ctx):
        n = 0
        async for p in request.parts:
            n += len(p)
        yield {"bytes": n}

    async def parts():
        for _ in range(PROBE_PARTS):
            yield part

    comp = drt.namespace("probe").component(name)
    await comp.endpoint("items").serve(items)
    ci = await comp.endpoint("items").client().start()
    await ci.wait_for_instances(1, timeout=30)
    for n in (20, PROBE_ITEMS):                     # warm-up, then timed
        t0 = last = time.perf_counter()
        c0 = time.process_time()
        got, capped, gaps = 0, False, []
        stream = ci.generate({"n": n})
        async for _ in stream:
            got += 1
            now = time.perf_counter()
            gaps.append(now - last)
            last = now
            if now - t0 > PROBE_ITEMS_S:
                capped = True
                break
        await stream.aclose()
        item_s = time.perf_counter() - t0
        # this process's CPU seconds over the same items: a wall far above
        # them means the loop waited
        item_cpu_s = time.process_time() - c0
    if got != PROBE_ITEMS and not capped:
        raise AssertionError(f"{mode} plane probe: {got} items")
    # the item gaps over 1 ms, and TCP_NODELAY on this process's ends of
    # the plane's sockets (the asyncio server's and the client's pooled
    # ones): a stall of about 40 ms an item is the delayed-ACK timer
    # meeting Nagle's algorithm
    import socket

    def nodelay(writers):
        return [w.get_extra_info("socket").getsockopt(
            socket.IPPROTO_TCP, socket.TCP_NODELAY) for w in writers
            if w.get_extra_info("socket") is not None]

    row = dict(plane=drt.dataplane, us_per_item=1e6 * item_s / got,
               cpu_us_per_item=1e6 * item_cpu_s / got, items=got,
               gaps_over_1ms=sum(g > 1e-3 for g in gaps),
               gaps_over_1ms_s=sum(g for g in gaps if g > 1e-3),
               max_gap_ms=1e3 * max(gaps),
               nodelay=dict(server=nodelay(drt._conn_writers),
                            client=nodelay(e[2] for conns in
                                           ci._pool.values()
                                           for e in conns)))
    if parts_too:
        await comp.endpoint("kv").serve(drain)
        ck = await comp.endpoint("kv").client().start()
        await ck.wait_for_instances(1, timeout=30)
        for _ in range(2):                          # warm-up, then timed
            t0 = time.perf_counter()
            async for ack in ck.generate({}, parts=parts()):
                moved = ack["bytes"]
            part_s = time.perf_counter() - t0
        if moved != PROBE_PARTS * PROBE_PART_BYTES:
            raise AssertionError(f"{mode} plane probe: {moved} bytes")
        row["gb_s"] = moved / part_s / 1e9
    return row


async def plane_probe(store_port: int) -> dict:
    """The data plane's own cost on each plane, in turns (asyncio, native,
    native, asyncio), each a :func:`probe_turn`. {plane: [row, ...]}."""
    rows: dict = {}
    for turn, mode in enumerate(("python", "native", "native", "python")):
        row = await probe_turn(store_port, mode, f"plane{turn}")
        rows.setdefault(row.pop("plane"), []).append(row)
    if sorted(rows) != ["native", "python"]:
        raise AssertionError(f"plane probe ran on {sorted(rows)}")
    return rows


def probe_turn_fresh(store_port: int) -> dict:
    """An asyncio items turn of :func:`probe_turn` in a fresh Python
    process (this script's environment, no state of this process)."""
    code = ("import asyncio, json, sys; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke as s; print(json.dumps(asyncio.run("
            "s.probe_turn(int(sys.argv[2]), 'python', 'fresh', False))))")
    out = subprocess.run([sys.executable, "-c", code, ROOT, str(store_port)],
                         capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        raise AssertionError(f"fresh probe turn: {out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


async def region_check(store, http_port: int) -> dict:
    """The stage states every observer reads (``fetch_stage_states_ex``,
    which the router's cost model calls) must come from a region record
    while the aggregator runs, and each worker's dispatch and kernel-launch
    counters there must equal the frontend's flat scrape (its own
    ``/metrics``, which excludes its dump and so always scrapes flat)
    taken around the read, unchanged across it."""
    import asyncio

    from dynamo_tpu_torch.llm.metrics_aggregator import fetch_stage_states_ex
    from dynamo_tpu_torch.utils.prometheus import render_states

    def counters(sc):
        return {n: _per_worker(sc, n, label) for n, label in (
            ("dyn_engine_dispatches_total", "kind"),
            ("dyn_kernel_launches_total", "kernel"))}

    for _ in range(5):
        # the workers publish every FLEET_METRICS_S, the aggregator merges
        # every FLEET_REGION_S
        await asyncio.sleep(2 * FLEET_REGION_S + 2 * FLEET_METRICS_S)
        before = counters(await asyncio.to_thread(_fleet_stage, http_port))
        t0 = time.perf_counter()
        states, read = await fetch_stage_states_ex(store, "dynamo")
        read_s = time.perf_counter() - t0
        after = counters(await asyncio.to_thread(_fleet_stage, http_port))
        if before == after:
            break
    if read is None:
        raise AssertionError("no fresh region record: the observers' read "
                             "fell back to the flat scrape")
    got = counters({k: v for k, v in samples(render_states(states)).items()
                    if 'component="backend"' in k})
    if before != after or got != after:
        raise AssertionError(f"region counters {got} against the flat "
                             f"scrape {before} / {after}")
    return dict(aggregators=read.meta["aggregators"],
                workers=read.meta["workers"], read_s=read_s,
                age_max_s=read.meta["age_max_s"],
                merge_p50_s=read.meta["merge_p50_s"],
                counters_equal_flat=True,
                backend_workers=sorted(f"{w:x}" for w in
                                       read.ids.get("backend", ())))


async def cabi_check(backend, store_port: int, index, page: int) -> dict:
    """One ``stored`` and one ``removed`` event through the C-ABI publisher
    under a throwaway worker id, read back from the live ``kv_events``
    subject: dict for dict the Python protocol's events, and applied by
    the smoke's own index (the router's view) like a worker's."""
    import asyncio

    from dynamo_tpu_torch.llm.kv_router.native import NativeKvPublisher
    from dynamo_tpu_torch.llm.kv_router.protocols import (KV_EVENT_SUBJECT,
                                                          KvCacheEvent,
                                                          KvRemovedEvent,
                                                          KvStoredEvent,
                                                          RouterEvent,
                                                          StoredBlock)
    from dynamo_tpu_torch.llm.tokens import compute_seq_hashes

    got: list = []
    arrived: list = []
    both = asyncio.Event()

    async def on_event(payload):
        if payload.get("worker_id") == CABI_WORKER:
            got.append(payload)
            arrived.append(time.perf_counter())
            if len(got) == 2:
                both.set()

    await backend.subscribe(KV_EVENT_SUBJECT, on_event)
    tokens = list(range(page))
    (h,) = compute_seq_hashes(tokens, page)
    pub = await asyncio.to_thread(NativeKvPublisher, "127.0.0.1",
                                  store_port, "dynamo", "backend",
                                  CABI_WORKER)
    try:
        t0 = time.perf_counter()
        pub.publish_stored([(h, 0xABC)])
        await asyncio.sleep(0.2)
        held = index.find_matches_for_tokens(tokens).scores.get(CABI_WORKER)
        pub.publish_removed([h])
        await asyncio.wait_for(both.wait(), 10)
        read_ms = 1e3 * (arrived[0] - t0)
    finally:
        pub.shutdown()
    want = [RouterEvent(CABI_WORKER, KvCacheEvent(1, stored=KvStoredEvent(
                [StoredBlock(h, 0xABC)]))).to_dict(),
            RouterEvent(CABI_WORKER, KvCacheEvent(2, removed=KvRemovedEvent(
                [h]))).to_dict()]
    left = index.find_matches_for_tokens(tokens).scores.get(CABI_WORKER)
    if got != want or held != 1 or left:
        raise AssertionError(f"C-ABI events {got}, want {want}; indexed "
                             f"{held} then {left}")
    return dict(events=len(got), read_back_ms=read_ms,
                equal_python_protocol=True)


async def _fleet_drain(fleet: Fleet, store_port: int, http_port: int,
                       victim: str, keep: int) -> dict:
    """SIGTERM worker ``victim``: it exits 0, its endpoint key and model
    registrations vanish, and the next four requests answer 200 from
    worker ``keep``."""
    import asyncio
    import signal

    from dynamo_tpu_torch.runtime.store_client import StoreClient

    proc = fleet.procs[victim][0]
    lease = int(fleet.wait_line(victim, r"worker [0-9a-f]+ serving",
                                1).split()[1], 16)
    store = await StoreClient(port=store_port).connect()
    try:
        # dynalint: ok(store-key-drift) the smoke lists every endpoint
        # registration of the namespace: a namespace-wide scan that no single-
        # endpoint keyspace helper builds
        keys = [k for k, _ in await store.get_prefix("dynamo/components/")]
        keys += [k for k, _ in await store.get_prefix("models/")]
        mine = [k for k in keys if k.endswith(f":{lease:x}")
                or k.endswith(f":i-{lease:x}")]
        if len(mine) != 3:                  # generate + chat + completion
            raise AssertionError(f"worker {lease:x} keys before drain: "
                                 f"{keys}")
        t0 = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        rc = await asyncio.to_thread(proc.wait, 120)
        exit_s = time.monotonic() - t0
        await asyncio.sleep(0.5)      # the deletes reach every watcher
        # dynalint: ok(store-key-drift) the same namespace-wide endpoint scan
        # after the drain
        keys = [k for k, _ in await store.get_prefix("dynamo/components/")]
        keys += [k for k, _ in await store.get_prefix("models/")]
        left = [k for k in keys if f"{lease:x}" in k]
        st, raw = await asyncio.to_thread(http_get, http_port,
                                          "/v1/router/decisions")
        n0 = len(json.loads(raw).get("decisions", []))
        res: dict = {}
        for i in range(4):
            await asyncio.to_thread(
                http_post, http_port, "/v1/completions",
                {"model": PRESET, "prompt": f"after the drain {i}",
                 "max_tokens": 8}, res, i)
        st, raw = await asyncio.to_thread(http_get, http_port,
                                          "/v1/router/decisions")
        after = [d["worker_id"] for d in json.loads(raw)["decisions"][n0:]]
        if rc != 0 or left or [r["status"] for r in res.values()] != \
                [200] * 4 or after != [keep] * 4:
            raise AssertionError(
                f"drain of {lease:x}: rc {rc}, keys left {left}, "
                f"statuses {res}, placed on {after}:\n"
                f"{fleet.log(victim)[-3000:]}")
        return dict(worker=f"{lease:x}", rc=rc, exit_s=exit_s,
                    keys_removed=len(mine), after_workers=len(set(after)))
    finally:
        await store.close()


def fleet_phase(torch, smi: str, serve_lone: dict) -> dict:
    """Two Llama-3-8B torch workers behind the port's store, KV-aware
    router and discovery frontend, each a process of its own on this
    card, on the native data plane, over a store split in two C++
    dynstores (``DYN_STORE_SHARDS``: the telemetry families on the second)
    with a regional aggregator beside them: routing by the overlap of the
    workers' own KV events, routing by load, one trace across processes,
    the workers' stage dumps (dispatches and kernel launches) through the
    sharded client and from a region record, KV events through the C ABI,
    the codec's and both data planes' cost, and a SIGTERM drain."""
    import asyncio
    import re

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    fleet = Fleet()
    saved = os.environ.get("DYN_STORE_SHARDS")
    try:
        ports = []
        for name in ("store", "store_telemetry"):
            fleet.start(name, "dynamo_tpu_torch.runtime.store_server",
                        "--host", "127.0.0.1", "--port", "0")
            line = fleet.wait_line(name, r"listening on \S+:\d+", 60)
            ports.append(int(line.rsplit(":", 1)[1]))
        store_port = ports[0]
        store = f"127.0.0.1:{store_port}"
        # every process of the fleet, this one too, routes the telemetry
        # families (metrics, stage dumps, regions) to the second store
        shards = f"telemetry=127.0.0.1:{ports[1]}"
        fleet.env["DYN_STORE_SHARDS"] = os.environ["DYN_STORE_SHARDS"] = \
            shards
        t0 = time.perf_counter()
        for name in ("worker0", "worker1"):
            fleet.start(name, "dynamo_tpu_torch.cli.worker", "--engine",
                        "torch", "--device", DEVICE, "--store", store,
                        "--register-model", "--model-name", PRESET,
                        "--kv-block-size", str(ENGINE_ARGS["page_size"]),
                        "--metrics-interval", str(FLEET_METRICS_S),
                        "--extra-engine-args", json.dumps(ENGINE_ARGS))
        ids = {}
        for name in ("worker0", "worker1"):
            line = fleet.wait_line(name, r"worker [0-9a-f]+ serving",
                                   FLEET_START_S)
            ids[name] = int(line.split()[1], 16)
        workers_start_s = time.perf_counter() - t0
        fleet.start("router", "dynamo_tpu_torch.cli.router", "--store",
                    store, "--block-size", str(ENGINE_ARGS["page_size"]))
        fleet.wait_line("router", r"kv router serving", 120)
        fleet.start("aggregator", "dynamo_tpu_torch.cli.aggregator",
                    "--store", store, "--interval", str(FLEET_REGION_S))
        fleet.wait_line("aggregator", r"regional aggregator serving", 120)
        fleet.start("http", "dynamo_tpu_torch.cli.http", "--store", store,
                    "--host", "127.0.0.1", "--port", "0",
                    "--router-component", "router", "--namespace",
                    "dynamo")
        line = fleet.wait_line("http", r"http frontend on :\d+", 120)
        http_port = int(re.search(r":(\d+)", line).group(1))
        t0 = time.monotonic()
        while PRESET not in http_get(http_port, "/v1/models")[1].decode():
            if time.monotonic() - t0 > 60:
                raise AssertionError("frontend never discovered the model")
            time.sleep(0.1)
        planes = fleet.planes(serving=("worker0", "worker1", "router"))
        row = asyncio.run(_fleet_async(fleet, store_port, http_port, smi))
        # the same greedy requests on the same seeded weights: the fleet
        # must stream what the in-process server streamed, through the
        # frontend (text and token strings) and through the router and the
        # data plane (token ids)
        lone = row["fleet_lone_stream"]
        for key in ("text", "tokens", "greedy_ids"):
            if lone[key] != serve_lone[key]:
                raise AssertionError(
                    f"the fleet streamed {key} {lone[key]!r}, the "
                    f"in-process server {serve_lone[key]!r}")
        victim = next(n for n, w in ids.items() if f"{w:x}" == row["other"])
        row["drain"] = asyncio.run(_fleet_drain(
            fleet, store_port, http_port, victim, int(row["holder"], 16)))
        row.update(phase="fleet", preset=PRESET, engine=ENGINE_ARGS,
                   workers_start_s=workers_start_s, planes=planes,
                   store_shards=shards,
                   serve_lone_stream=serve_lone,
                   fleet_added_ttft_ms=1e3 * (
                       row["fleet_lone_stream"]["ttft_s"]
                       - serve_lone["ttft_s"]),
                   dataplane_added_ms_per_token=(
                       row["fleet_lone_stream"]["itl_ms"]
                       - serve_lone["itl_ms"]),
                   loop_wedges_s=fleet.wedges(),
                   phase_s=time.perf_counter() - t_phase)
        row["flash_launches"] = sum(w["launches"]["flash_attention"]
                                    for w in row["workers"].values())
        row["paged_launches"] = sum(w["launches"]["paged_attention"]
                                    for w in row["workers"].values())
        emit(row)
        return row
    finally:
        fleet.stop()
        if saved is None:
            os.environ.pop("DYN_STORE_SHARDS", None)
        else:
            os.environ["DYN_STORE_SHARDS"] = saved


# ---------------------------------------------------------------------------
# phase 11: disaggregated prefill and decode, each worker a process
# ---------------------------------------------------------------------------

DISAGG_DIR = os.path.join(ROOT, "build", "dynamo_tpu_torch", "disagg")
DISAGG_LOCAL_MAX = 256          # the decode worker's --max-local-prefill-length
DISAGG_BURST, DISAGG_BURST_TOKENS = 4, 1024
DISAGG_LOCAL_TOKENS = 64


def _component(sc: dict, component: str) -> dict:
    return {k: v for k, v in sc.items() if f'component="{component}"' in k}


def _counts(sc: dict, wid: str) -> dict:
    """A worker's dispatch and kernel-launch counters from a scrape."""
    d = _per_worker(sc, "dyn_engine_dispatches_total", "kind").get(wid, {})
    k = _per_worker(sc, "dyn_kernel_launches_total", "kernel").get(wid, {})
    return {"prefill": d.get("prefill", 0.0),
            "decode_step": d.get("decode_step", 0.0),
            "flash": k.get("flash_attention", 0.0),
            "paged": k.get("paged_attention", 0.0)}


def _delta(a: dict, b: dict) -> dict:
    return {n: b[n] - a.get(n, 0.0) for n in b}


async def _disagg_async(fleet: Fleet, store_port: int, http_port: int,
                        want: list) -> dict:
    import asyncio

    import numpy as np

    from dynamo_tpu_torch.llm.disagg import PrefillQueue
    from dynamo_tpu_torch.llm.protocols.common import (BackendInput,
                                                       StopConditions)
    from dynamo_tpu_torch.models.llama import preset
    from dynamo_tpu_torch.runtime.component import DistributedRuntime
    from dynamo_tpu_torch.runtime.engine import Context
    from dynamo_tpu_torch.utils import tracing

    L = preset(PRESET).num_layers
    # the wrappers count launches on the card only
    Lk = L * (DEVICE == "cuda")
    drt = await DistributedRuntime(store_port=store_port).connect()
    # this process's client spans join request 1's trace in the store
    tracing.configure(component="smoke")
    sink = await tracing.StoreSpanSink(drt.store).start()
    try:
        client = await drt.namespace("dynamo").component("backend") \
            .endpoint("generate").client().start()
        await client.wait_for_instances(1, timeout=60)
        (wid,) = client.instance_ids()
        dwid = f"{wid:x}"
        queue = PrefillQueue(drt.store, "dynamo")

        async def direct(tokens, rid, max_tokens):
            """One greedy streamed request straight to the decode
            worker's ``generate`` endpoint: (ids, TTFT s, total s)."""
            bi = BackendInput(token_ids=list(tokens), stop=StopConditions(
                max_tokens=max_tokens, ignore_eos=True))
            ids, ttft = [], None
            t0 = time.perf_counter()
            async for item in client.generate(bi.to_dict(), Context(rid),
                                              mode="direct",
                                              instance_id=wid):
                if item.get("finish_reason") == "error":
                    raise AssertionError(f"{rid} failed: {item}")
                if ttft is None and item.get("token_ids"):
                    ttft = time.perf_counter() - t0
                ids += item.get("token_ids") or []
            return ids, ttft, time.perf_counter() - t0

        async def stage(settle=2.5):
            # the decode worker publishes every FLEET_METRICS_S, the
            # prefill worker every second
            await asyncio.sleep(settle)
            return await asyncio.to_thread(scrape, http_port)

        async def post(body):
            res: dict = {}
            await asyncio.to_thread(http_post, http_port, "/v1/completions",
                                    body, res, "r")
            return res["r"]

        rng = np.random.default_rng(REUSE_SEED + 1)
        vocab = preset(PRESET).vocab_size
        # warm-up: one remote request on another prompt (first pinned
        # allocations and connections of both workers)
        await direct(rng.integers(0, vocab, DISAGG_BURST_TOKENS).tolist(),
                     "disagg-warm", 4)
        sc0 = await stage()
        prefill_ids = [w for w in _per_worker(
            sc0, "dyn_engine_dispatches_total", "kind") if w != dwid]
        if len(prefill_ids) != 1:
            raise AssertionError(f"prefill worker's dump not found: "
                                 f"{prefill_ids}; its log:\n"
                                 f"{fleet.log('prefill')[-3000:]}")
        (pwid,) = prefill_ids

        # 1. the lone remote request: the serve phase's cold stream
        prompt = reuse_prompt(vocab)
        ids, ttft, total = await direct(prompt, "disagg-remote-1",
                                        REUSE_TOKENS)
        sc1 = await stage()
        if ids != want:
            raise AssertionError(f"the remote-prefilled request streamed "
                                 f"{ids}, the served cold stream {want}")
        remote = dict(ttft_s=ttft, total_s=total, tokens=len(ids),
                      decode=_delta(_counts(sc0, dwid), _counts(sc1, dwid)),
                      prefill=_delta(_counts(sc0, pwid),
                                     _counts(sc1, pwid)))
        dp, pp = remote["decode"], remote["prefill"]
        if not (pp["prefill"] > 0 and pp["flash"] == Lk * pp["prefill"]
                and pp["paged"] == 0 and dp["prefill"] == 0
                and dp["flash"] == 0 and dp["decode_step"] > 0
                and dp["paged"] == Lk * dp["decode_step"]):
            raise AssertionError(f"request 1's launches by process: "
                                 f"decode {dp}, prefill {pp}")
        ingests = _total(_component(sc1, "backend"),
                         "dyn_kv_stream_ingests_total") - _total(
            _component(sc0, "backend"), "dyn_kv_stream_ingests_total")
        xfer = {}
        for comp, direction in (("prefill", "send"), ("backend", "recv")):
            a, b = _component(sc0, comp), _component(sc1, comp)
            n = _total(b, "llm_kv_transfer_bytes_total",
                       direction=direction) - _total(
                a, "llm_kv_transfer_bytes_total", direction=direction)
            sec = _total(b, "llm_kv_transfer_seconds_sum",
                         direction=direction) - _total(
                a, "llm_kv_transfer_seconds_sum", direction=direction)
            xfer[direction] = dict(bytes=n, seconds=sec,
                                   gb_s=n / sec / 1e9 if sec else None)
        kv_bytes = REUSE_PROMPT * 2 * L * preset(PRESET).num_kv_heads \
            * preset(PRESET).head_dim * 2
        if ingests != 1 or xfer["send"]["bytes"] != kv_bytes \
                or xfer["recv"]["bytes"] != kv_bytes:
            raise AssertionError(f"request 1's KV: {ingests} streamed "
                                 f"ingests, {xfer}, want {kv_bytes} bytes")
        st, raw = await asyncio.to_thread(http_get, http_port, "/v1/flows")
        flows = [lk for lk in json.loads(raw)["links"]
                 if {"disagg_push", "disagg_stream_rx"} & set(lk["kinds"])]

        # 2. a short prompt prefills on the decode worker
        local = await post({"model": PRESET, "max_tokens": 8,
                            "prompt": bytes(rng.choice(
                                np.frombuffer(b"abcdefgh ", np.uint8),
                                DISAGG_LOCAL_TOKENS)).decode()})
        sc2 = await stage()
        lp = _delta(_counts(sc1, dwid), _counts(sc2, dwid))
        if local["status"] != 200 or local["usage"]["prompt_tokens"] \
                > DISAGG_LOCAL_MAX or not (lp["prefill"] > 0
                                           and lp["flash"]
                                           == Lk * lp["prefill"]) \
                or _delta(_counts(sc1, pwid), _counts(sc2, pwid))[
                    "prefill"] != 0:
            raise AssertionError(f"the local request: {local}, decode "
                                 f"worker {lp}")

        # 3. a burst of long prompts, all remote
        letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz     ",
                                np.uint8)
        burst_t0 = time.perf_counter()
        res = await asyncio.gather(*[post({
            "model": PRESET, "max_tokens": 16,
            "prompt": bytes(rng.choice(letters,
                                       DISAGG_BURST_TOKENS)).decode()})
            for _ in range(DISAGG_BURST)])
        burst_s = time.perf_counter() - burst_t0
        depth = await queue.size()
        sc3 = await stage()
        bd = _delta(_counts(sc2, dwid), _counts(sc3, dwid))
        bp = _delta(_counts(sc2, pwid), _counts(sc3, pwid))
        b_ingests = _total(_component(sc3, "backend"),
                           "dyn_kv_stream_ingests_total") - _total(
            _component(sc2, "backend"), "dyn_kv_stream_ingests_total")
        if [r["status"] for r in res] != [200] * DISAGG_BURST \
                or any(r["usage"]["completion_tokens"] != 16 for r in res) \
                or depth != 0 or b_ingests != DISAGG_BURST \
                or bd["flash"] != 0 or bp["paged"] != 0 \
                or bp["flash"] != Lk * bp["prefill"] \
                or bd["paged"] != Lk * bd["decode_step"]:
            raise AssertionError(f"burst: {res}, queue depth {depth}, "
                                 f"{b_ingests} ingests, decode {bd}, "
                                 f"prefill {bp}")

        # 5. request 1's trace, across processes
        await asyncio.sleep(1.5)          # span sinks flush every 0.25 s
        st, raw = await asyncio.to_thread(http_get, http_port,
                                          "/v1/traces/disagg-remote-1")
        spans = json.loads(raw)["spans"] if st == 200 else []
        names = {s["name"] for s in spans}
        pids = {s["pid"] for s in spans}
        need = {"prefill.remote_wait", "prefill.compute", "kv.push",
                "kv.receive", "decode.stream"}
        if not need <= names or len(pids) < 3:
            raise AssertionError(f"request 1's trace: {sorted(names)} from "
                                 f"{len(pids)} processes")
        span_ms = {n: 1e3 * sum(s["end"] - s["start"] for s in spans
                                if s["name"] == n) for n in sorted(need)}
        peak = _per_worker(sc3, "dyn_device_memory_peak_bytes")

        # the data plane alone: request 1's 2·L parts of one layer's k or
        # v each, pushed through an endpoint of this process that only
        # drains them (both ends on this process's one loop)
        async def drain(request, ctx):
            n = 0
            async for part in request.parts:
                n += len(part)
            yield {"bytes": n}

        ep = drt.namespace("probe").component("plane").endpoint("kv")
        await ep.serve(drain)
        plane = await ep.client().start()
        await plane.wait_for_instances(1, timeout=30)
        part = bytes(kv_bytes // (2 * L))

        async def parts():
            for _ in range(2 * L):
                yield part

        for _ in range(2):                  # warm-up, then timed
            t0 = time.perf_counter()
            async for ack in plane.generate({}, parts=parts()):
                got = ack["bytes"]
            plane_s = time.perf_counter() - t0
        if got != kv_bytes:
            raise AssertionError(f"the plane probe moved {got} bytes")
        return dict(
            decode_worker=dwid, prefill_worker=pwid,
            remote=remote, kv_bytes=kv_bytes, kv_transfer=xfer,
            flows=flows, local=dict(status=local["status"],
                                    prompt_tokens=local["usage"][
                                        "prompt_tokens"],
                                    decode=lp),
            burst=dict(requests=DISAGG_BURST, wall_s=burst_s,
                       prompt_tokens=[r["usage"]["prompt_tokens"]
                                      for r in res],
                       queue_depth_after=depth, ingests=b_ingests,
                       decode=bd, prefill=bp),
            trace=dict(spans=len(spans), processes=len(pids),
                       span_ms=span_ms),
            peak_mem_bytes={"decode": peak.get(dwid, {}).get(""),
                            "prefill": peak.get(pwid, {}).get("")},
            plane_probe=dict(plane=drt.dataplane, bytes=kv_bytes,
                             parts=2 * L, seconds=plane_s,
                             gb_s=kv_bytes / plane_s / 1e9),
            flash_launches=pp["flash"] + bp["flash"],
            paged_launches=dp["paged"] + bd["paged"])
    finally:
        await sink.stop()
        await drt.close()


def disagg_phase(torch, smi: str, serve: dict) -> dict:
    """Disaggregated prefill and decode on this card, each piece a process
    of the port's own: the store, a decode worker (``--enable-disagg``,
    prompts over 256 tokens prefilled remotely), a prefill worker with the
    same seeded weights, and the discovery frontend. The reuse prompt,
    sent greedy to the decode worker, is prefilled by the prefill worker
    (flash kernel), streamed layer by layer into the decode worker's pool
    and decoded there (paged kernel): its tokens must be the serve phase's
    cold stream. Then a short prompt prefills locally, and a burst of
    long prompts all goes remote and drains the queue."""
    import asyncio
    import re

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    fleet = Fleet(DISAGG_DIR)
    try:
        fleet.start("store", "dynamo_tpu_torch.runtime.store_server",
                    "--host", "127.0.0.1", "--port", "0")
        line = fleet.wait_line("store", r"listening on \S+:\d+", 60)
        store_port = int(line.rsplit(":", 1)[1])
        store = f"127.0.0.1:{store_port}"
        common = ("--device", DEVICE, "--store", store, "--model-name",
                  PRESET, "--kv-block-size", str(ENGINE_ARGS["page_size"]),
                  "--extra-engine-args", json.dumps(ENGINE_ARGS))
        t0 = time.perf_counter()
        fleet.start("decode", "dynamo_tpu_torch.cli.worker", "--engine",
                    "torch", "--register-model", "--metrics-interval",
                    str(FLEET_METRICS_S), "--enable-disagg",
                    "--max-local-prefill-length", str(DISAGG_LOCAL_MAX),
                    "--max-prefill-queue-size", str(2 * DISAGG_BURST),
                    *common)
        fleet.start("prefill", "dynamo_tpu_torch.cli.prefill_worker",
                    *common)
        fleet.wait_line("decode", r"worker [0-9a-f]+ serving",
                        FLEET_START_S)
        fleet.wait_line("prefill", r"prefill worker pulling", FLEET_START_S)
        workers_start_s = time.perf_counter() - t0
        fleet.start("http", "dynamo_tpu_torch.cli.http", "--store", store,
                    "--host", "127.0.0.1", "--port", "0", "--namespace",
                    "dynamo")
        line = fleet.wait_line("http", r"http frontend on :\d+", 120)
        http_port = int(re.search(r":(\d+)", line).group(1))
        t0 = time.monotonic()
        while PRESET not in http_get(http_port, "/v1/models")[1].decode():
            if time.monotonic() - t0 > 60:
                raise AssertionError("frontend never discovered the model")
            time.sleep(0.1)
        planes = fleet.planes(serving=("decode",))
        row = asyncio.run(_disagg_async(fleet, store_port, http_port,
                                        serve["reuse"]["cold_tokens"]))
        local_ttft = serve["reuse"]["ttft_s"]["cold"]
        xfer = row["kv_transfer"]
        row.update(phase="disagg", preset=PRESET, engine=ENGINE_ARGS,
                   workers_start_s=workers_start_s, planes=planes,
                   remote_ttft_s=row["remote"]["ttft_s"],
                   local_ttft_s=local_ttft,
                   remote_added_ttft_ms=1e3 * (row["remote"]["ttft_s"]
                                               - local_ttft),
                   send_gb_s=xfer["send"]["gb_s"],
                   recv_gb_s=xfer["recv"]["gb_s"],
                   ingest=serve["ingest"], card=smi,
                   loop_wedges_s=fleet.wedges(),
                   phase_s=time.perf_counter() - t_phase)
        emit(row)
        return row
    finally:
        fleet.stop()


# ---------------------------------------------------------------------------
# phase 11b: cluster-wide KV sharing, each worker a process
# ---------------------------------------------------------------------------

CLUSTER_DIR = os.path.join(ROOT, "build", "dynamo_tpu_torch", "cluster")
CLUSTER_SEED = 1497             # the router step's shared prefix
CLUSTER_PUBLISH_S = 0.25        # the workers' registry publish interval
CLUSTER_COST_S = 6.0            # the router refreshes its cost model every 5 s
CLUSTER_BUSY_TOKENS = 128       # B's request that the staged one waits behind
# one request at a time a worker: a running and a waiting request saturate
# one, and a worker's pool (33 pages) holds about one 1496-token prompt
CLUSTER_MAX_BATCH = 1


async def _cluster_async(fleet: Fleet, store_port: int, http_port: int,
                         ids: dict, reuse: dict) -> dict:
    import asyncio

    import numpy as np

    from dynamo_tpu_torch.llm.kv_cluster import KvClusterIndex
    from dynamo_tpu_torch.llm.kv_cluster.fetch import fetch_prefix
    from dynamo_tpu_torch.llm.protocols.common import (BackendInput,
                                                       StopConditions)
    from dynamo_tpu_torch.llm.tokens import compute_seq_hashes
    from dynamo_tpu_torch.models.llama import preset
    from dynamo_tpu_torch.runtime.component import DistributedRuntime
    from dynamo_tpu_torch.runtime.engine import Context

    m = preset(PRESET)
    Lk = m.num_layers * (DEVICE == "cuda")   # the wrappers count on a card
    page = ENGINE_ARGS["page_size"]
    wa, wb = ids["A"], ids["B"]
    ha, hb = f"{wa:x}", f"{wb:x}"
    n_blocks = (REUSE_PROMPT - 1) // page            # the match stops at n-1
    drt = await DistributedRuntime(store_port=store_port).connect()
    try:
        backend = drt.namespace("dynamo").component("backend")
        workers = await backend.endpoint("generate").client().start()
        await workers.wait_for_instances(2, timeout=60)
        fetcher = await backend.endpoint("kv_fetch").client().start()
        await fetcher.wait_for_instances(2, timeout=60)
        index = await KvClusterIndex().start(drt.store, "dynamo")

        async def direct(wid, tokens, max_tokens, rid, **stamp):
            """One greedy request straight to worker ``wid``."""
            bi = BackendInput(token_ids=list(tokens), stop=StopConditions(
                max_tokens=max_tokens, ignore_eos=True), **stamp)
            out = dict(ids=[], ttft_s=None, prefix_hit=None)
            t0 = time.perf_counter()
            async for item in workers.generate(bi.to_dict(), Context(rid),
                                               mode="direct",
                                               instance_id=wid):
                if item.get("finish_reason") == "error":
                    raise AssertionError(f"{rid} failed: {item}")
                if out["ttft_s"] is None and item.get("token_ids"):
                    out["ttft_s"] = time.perf_counter() - t0
                if out["prefix_hit"] is None:
                    out["prefix_hit"] = item.get("kv_prefix_hit_tokens")
                out["ids"] += item.get("token_ids") or []
            out["total_s"] = time.perf_counter() - t0
            return out

        async def record_holds(wid, hashes, timeout=30.0):
            t0 = time.monotonic()
            while True:
                rec = index.records.get(wid)
                if rec is not None and all(rec.holds(h) for h in hashes):
                    return time.monotonic() - t0
                if time.monotonic() - t0 > timeout:
                    raise AssertionError(
                        f"worker {wid:x}'s registry record never listed "
                        f"{len(hashes)} blocks: "
                        f"{rec.block_count if rec else None} listed")
                await asyncio.sleep(0.02)

        async def stage(settle=4 * FLEET_METRICS_S):
            await asyncio.sleep(settle)
            return await asyncio.to_thread(scrape, http_port)

        def total(sc, name, component="backend", **labels):
            return _total(_component(sc, component), name, **labels)

        async def metrics_of(wid):
            raw = await drt.store.get(f"metrics/dynamo/backend/{wid:x}")
            return json.loads(raw.decode())

        # warm-up, on a prompt of the reuse prompt's length: A prefills it
        # cold, and B fetches it stamped and restores it (each path's first
        # pinned allocations, handles and connections in each process)
        rng = np.random.default_rng(CLUSTER_SEED)
        warm_up = rng.integers(0, m.vocab_size, REUSE_PROMPT).tolist()
        await direct(wa, warm_up, 4, "cluster-warm-up-a")
        await record_holds(wa, compute_seq_hashes(warm_up, page)[:n_blocks])
        await direct(wb, warm_up, 4, "cluster-warm-up-b", kv_donor=wa,
                     kv_donor_blocks=n_blocks)

        # 1. the donor fetch, stamped directly: A serves the reuse prompt
        # cold, mirrors its 23 blocks write-through and lists them in its
        # registry record; B, stamped with A as donor, fetches them and
        # prefills only the last 24 tokens
        prompt = reuse_prompt(m.vocab_size)
        hashes = compute_seq_hashes(prompt, page)[:n_blocks]
        sc0 = await stage(0)
        cold = await direct(wa, prompt, REUSE_TOKENS, "cluster-cold")
        listed_s = await record_holds(wa, hashes)
        sc1 = await stage()
        warm = await direct(wb, prompt, REUSE_TOKENS, "cluster-fetch",
                            kv_donor=wa, kv_donor_blocks=n_blocks)
        sc2 = await stage()
        t_fetched = time.monotonic()

        def moved(a, b, direction):
            return dict(
                bytes=total(b, "llm_kv_transfer_bytes_total",
                            direction=direction)
                - total(a, "llm_kv_transfer_bytes_total",
                        direction=direction),
                seconds=total(b, "llm_kv_transfer_seconds_sum",
                              direction=direction)
                - total(a, "llm_kv_transfer_seconds_sum",
                        direction=direction))

        recv, send = moved(sc1, sc2, "cluster_recv"), moved(sc1, sc2,
                                                            "cluster_send")
        want_bytes = n_blocks * reuse["block_bytes"]
        fetch = dict(
            fetches=total(sc2, "dyn_kv_cluster_fetches_total")
            - total(sc1, "dyn_kv_cluster_fetches_total"),
            fallbacks=total(sc2, "dyn_kv_cluster_fallbacks_total")
            - total(sc1, "dyn_kv_cluster_fallbacks_total"),
            recv_bytes=recv["bytes"], send_bytes=send["bytes"],
            want_bytes=want_bytes, seconds=recv["seconds"],
            gb_s=recv["bytes"] / recv["seconds"] / 1e9
            if recv["seconds"] else None,
            fetch_seconds_sum=total(sc2, "dyn_kv_cluster_fetch_seconds_sum")
            - total(sc1, "dyn_kv_cluster_fetch_seconds_sum"),
            # B's staged upload of the deposited prefix, racing admission
            prefetch_hits=total(sc2, "dyn_prefetch_h2d_hits_total")
            - total(sc1, "dyn_prefetch_h2d_hits_total"),
            prefetch_stalls=total(sc2, "dyn_prefetch_h2d_stalls_total")
            - total(sc1, "dyn_prefetch_h2d_stalls_total"))
        b1 = _delta(_counts(sc1, hb), _counts(sc2, hb))
        a1 = _delta(_counts(sc0, ha), _counts(sc1, ha))
        step1 = dict(cold=dict(ttft_s=cold["ttft_s"],
                               prefix_hit=cold["prefix_hit"], launches=a1),
                     warm=dict(ttft_s=warm["ttft_s"],
                               prefix_hit=warm["prefix_hit"], launches=b1),
                     cold_equals_in_process=cold["ids"]
                     == reuse["cold_tokens"],
                     warm_equals_warm_host=warm["ids"]
                     == reuse["warm_host_tokens"],
                     warm_equals_cold=warm["ids"] == reuse["cold_tokens"],
                     # the first position where a restored prefix's stream
                     # (its last chunk at 24 rows, not 472) left the cold one
                     warm_leaves_cold_at=next(
                         (i for i, (a, b) in enumerate(zip(
                             warm["ids"], reuse["cold_tokens"])) if a != b),
                         None),
                     record_listed_s=listed_s, fetch=fetch)
        emit({"phase": "cluster", "step": "donor_fetch", **step1})
        if not (step1["cold_equals_in_process"]
                and step1["warm_equals_warm_host"]
                and cold["prefix_hit"] == 0
                and warm["prefix_hit"] == n_blocks * page
                and fetch["fetches"] == 1 and fetch["fallbacks"] == 0
                and recv["bytes"] == send["bytes"] == want_bytes
                and b1["prefill"] == 1 and b1["flash"] == Lk
                and b1["decode_step"] > 0
                and b1["paged"] == Lk * b1["decode_step"]):
            raise AssertionError(f"the stamped donor fetch: {step1}")
        # A's mirrors, as its kv_fetch endpoint serves them, against the
        # blocks a cold prefill of the same prompt wrote in process
        got = await fetch_prefix(fetcher, wa, hashes)
        bits = reuse["block_bits"]
        mirrors_equal = len(got) == n_blocks and all(
            np.array_equal(k, bits[0][i]) and np.array_equal(v, bits[1][i])
            for i, (_, k, v) in enumerate(got))
        if not mirrors_equal:
            raise AssertionError("A's write-through mirrors differ from the "
                                 "in-process cold prefill's blocks")

        # 2. through the router: A holds a second prefix but is saturated
        # (max_batch 1, one request running and one waiting), so the
        # router places that prefix on B and stamps A as its donor
        letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz     ", np.uint8)
        p2_text = bytes(rng.choice(letters, REUSE_PROMPT)).decode()
        p2 = list(p2_text.encode())
        await direct(wa, p2, 4, "cluster-p2-on-a")
        await record_holds(wa, compute_seq_hashes(p2, page)[:n_blocks])
        # a cost-model refresh since the fetch (the router prices the pair)
        await asyncio.sleep(max(0.0, CLUSTER_COST_S
                                - (time.monotonic() - t_fetched)))
        busy = asyncio.ensure_future(direct(
            wa, rng.integers(0, m.vocab_size, 64).tolist(), FLEET_LONG_TOKENS,
            "cluster-busy"))
        t0 = time.monotonic()
        while (await metrics_of(wa))["request_active_slots"] < 1:
            if busy.done() or time.monotonic() - t0 > 30:
                raise AssertionError("A's worker never reported busy")
            await asyncio.sleep(0.05)
        queued = asyncio.ensure_future(direct(
            wa, rng.integers(0, m.vocab_size, 64).tolist(), 8,
            "cluster-queued"))
        t0 = time.monotonic()
        while (await metrics_of(wa))["num_requests_waiting"] < 1:
            if busy.done() or time.monotonic() - t0 > 30:
                raise AssertionError("A's worker never reported a queue")
            await asyncio.sleep(0.05)
        await asyncio.sleep(1.2)           # two router scrapes
        st, raw = await asyncio.to_thread(http_get, http_port,
                                          "/v1/router/decisions")
        n0 = len(json.loads(raw)["decisions"])
        sc3 = await stage(0)
        res: dict = {}
        await asyncio.to_thread(http_post, http_port, "/v1/completions",
                                {"model": PRESET, "prompt": p2_text,
                                 "max_tokens": REUSE_TOKENS}, res, "r")
        busy_at_route = not busy.done()
        st, raw = await asyncio.to_thread(http_get, http_port,
                                          "/v1/router/decisions")
        decisions = json.loads(raw)["decisions"]
        dec = decisions[n0:]
        await asyncio.wait_for(asyncio.gather(busy, queued), 300)
        sc4 = await stage()
        stamps = sum(1 for d in decisions for c in d["candidates"]
                     if c["worker_id"] == d["worker_id"]
                     and c.get("kv_donor") is not None)
        t0 = time.monotonic()
        while total(sc4, "dyn_kv_cluster_hits_total", "router") < stamps \
                and time.monotonic() - t0 < 10:
            sc4 = await stage(0.5)   # the router publishes every 2 s
        cands = {c["worker_id"]: c for c in dec[0]["candidates"]} \
            if len(dec) == 1 else {}
        cb = cands.get(wb, {})
        routed = dict(
            status=res["r"]["status"],
            completion_tokens=res["r"].get("usage", {}).get(
                "completion_tokens"),
            busy_at_route=busy_at_route,
            decisions=len(dec),
            worker=f"{dec[0]['worker_id']:x}" if dec else None,
            kv_donor=f"{cb['kv_donor']:x}" if cb.get("kv_donor") else None,
            kv_donor_blocks=cb.get("kv_donor_blocks"),
            transfer_seconds=cb.get("transfer_seconds"),
            transfer_src=cb.get("transfer_src"),
            a_saturated=cands.get(wa, {}).get("saturated"),
            router_hits=total(sc4, "dyn_kv_cluster_hits_total", "router"),
            stamps=stamps,
            fetches=total(sc4, "dyn_kv_cluster_fetches_total")
            - total(sc3, "dyn_kv_cluster_fetches_total"),
            b_prefill=_delta(_counts(sc3, hb), _counts(sc4, hb)))
        emit({"phase": "cluster", "step": "routed", **routed})
        if not (routed["status"] == 200
                and routed["completion_tokens"] == REUSE_TOKENS
                and routed["a_saturated"] and len(dec) == 1
                and dec[0]["worker_id"] == wb and cb.get("kv_donor") == wa
                and cb.get("kv_donor_blocks") == n_blocks
                and cb.get("transfer_seconds", 0) > 0
                and routed["router_hits"] == stamps == 1
                and routed["fetches"] == 1):
            raise AssertionError(f"the routed cluster request: {routed}, "
                                 f"{dec}")

        # 3. a prefix in B's host tier and not on its device (B's pool of
        # 33 pages gave the reuse prompt's pages up to the second prefix):
        # sent while B is busy, it waits in B's queue and its blocks stage
        # on the side stream meanwhile; admission then scatters them
        b_host = set(index.records[wb].host) if wb in index.records else set()
        busy_b = asyncio.ensure_future(direct(
            wb, rng.integers(0, m.vocab_size, 64).tolist(),
            CLUSTER_BUSY_TOKENS, "cluster-busy-b"))
        t0 = time.monotonic()
        while (await metrics_of(wb))["request_active_slots"] < 1:
            if busy_b.done() or time.monotonic() - t0 > 30:
                raise AssertionError("B's worker never reported busy")
            await asyncio.sleep(0.05)
        sc5 = await stage(0)
        busy_at_send = not busy_b.done()
        queued_b = await direct(wb, prompt, REUSE_TOKENS, "cluster-staged")
        await asyncio.wait_for(busy_b, 300)
        sc6 = await stage()
        staged = dict(
            ttft_s=queued_b["ttft_s"], prefix_hit=queued_b["prefix_hit"],
            in_b_host_tier=len(b_host & set(hashes)),
            busy_at_send=busy_at_send,
            h2d_hits=total(sc6, "dyn_prefetch_h2d_hits_total")
            - total(sc5, "dyn_prefetch_h2d_hits_total"),
            h2d_stalls=total(sc6, "dyn_prefetch_h2d_stalls_total")
            - total(sc5, "dyn_prefetch_h2d_stalls_total"),
            tokens_equal_sync_restore=queued_b["ids"]
            == reuse["warm_host_tokens"])
        emit({"phase": "cluster", "step": "staged_on_b", **staged})
        if not (staged["tokens_equal_sync_restore"] and staged["h2d_hits"] > 0
                and busy_at_send and staged["in_b_host_tier"] == n_blocks
                and queued_b["prefix_hit"] == n_blocks * page):
            raise AssertionError(f"the staged restore on B: {staged}")

        # 4. readings: the write-through mirrors, memory, launches
        wt = {w: {n: _per_worker(sc6, f"dyn_kv_writethrough_{n}_total")
                  .get(w, {}).get("", 0.0)
                  for n in ("blocks", "bytes", "seconds", "enqueue_seconds")}
              for w in (ha, hb)}
        for w in wt.values():
            w["gb_s"] = w["bytes"] / w["seconds"] / 1e9 if w["seconds"] \
                else None
            w["ms_per_block"] = 1e3 * w["seconds"] / w["blocks"] \
                if w["blocks"] else None
            w["enqueue_ms_per_block"] = 1e3 * w["enqueue_seconds"] \
                / w["blocks"] if w["blocks"] else None
        peak = _per_worker(sc6, "dyn_device_memory_peak_bytes")
        launches = {w: _delta(_counts(sc0, w), _counts(sc6, w))
                    for w in (ha, hb)}

        # 5. failover: the workers are expendable now
        failover = await _failover(fleet, drt, workers, http_port, ids,
                                   m.vocab_size)
        return dict(
            donor=ha, receiver=hb, prompt_tokens=REUSE_PROMPT,
            blocks=n_blocks, step1=step1,
            ttft_s=dict(cold_local=cold["ttft_s"],
                        cluster_warm=warm["ttft_s"],
                        warm_host_in_process=reuse["ttft_s"][
                            "warm_host_again"]),
            a_mirrors_bitwise_equal_cold_blocks=mirrors_equal,
            routed=routed, staged_on_b=staged, writethrough=wt,
            peak_mem_bytes={w: peak.get(w, {}).get("") for w in (ha, hb)},
            launches=launches, failover=failover,
            flash_launches=sum(v["flash"] for v in launches.values())
            + failover["survivor_launches"]["flash"],
            paged_launches=sum(v["paged"] for v in launches.values())
            + failover["survivor_launches"]["paged"])
    finally:
        await drt.close()


FAILOVER_SEED, FAILOVER_PROMPT, FAILOVER_TOKENS = 1152, 1024, 128
FAILOVER_KILL_AT = 16           # tokens the client holds before the kill
# the most a token of the unkilled or the killed stream may sit below the
# top logit of a teacher-forced prefill over prompt + stream (absolute).
# A token another bf16 path chose sits at most twice that path's largest
# logit difference below the top: the kvpage phase reads up to 0.664
# between two bf16 paths of this model, so 1.33. On an H100 the sound
# streams read 0.1875 (unkilled) and 0.375 (killed), both planted wrong
# resume prefixes 6.34-6.42.
FAILOVER_MARGIN_LIMIT = 1.5
SURVIVOR_COUNTERS = ("dyn_kv_cluster_fallbacks_total",
                     "dyn_kv_cluster_fetches_total",
                     "dyn_resume_kv_reattach_blocks_total")


async def worker_counters(store, wid: int, names) -> dict:
    """Label-less counters of one worker's own stage dump, read from the
    store (the frontend's ``/metrics`` sums them over the workers, and a
    dead worker's dump leaves with its lease)."""
    from dynamo_tpu_torch.llm.metrics_aggregator import (merge_stage_items,
                                                         stage_base_key,
                                                         stage_slice_of,
                                                         stage_slice_prefix)

    items = [(k, v) for k, v in await store.get_prefix(
        stage_slice_prefix("dynamo", stage_slice_of(wid)))
        if stage_base_key(k).endswith(f"/backend/{wid:x}")]
    ((_doc, metrics),) = merge_stage_items(items).values()
    return {n: sum((metrics.get(n) or {}).get("series", {}).values())
            for n in names}


async def _failover(fleet: Fleet, drt, workers, http_port: int, ids: dict,
                    vocab: int) -> dict:
    """Mid-stream failover through the frontend's own engine class
    (``RemoteCoreEngine``, which wraps ``llm/resume.py``) in this process,
    so the stream's token ids are exact (a random-weight model's ids past
    the byte range detokenize to empty text). A seeded greedy request is
    served cold, then again (warm, the unkilled reference), then a third
    time: its worker is SIGKILLed once the stream holds FAILOVER_KILL_AT
    tokens. The stream must finish with every token, its tokens before
    the break those of the unkilled run, one ``resumed`` count, the dead
    worker excluded, and the survivor's launches covering the rebuild
    (flash, one a layer a prefill chunk) and the rest of the decode
    (paged)."""
    import asyncio
    import signal

    import numpy as np

    from dynamo_tpu_torch.llm.protocols.common import (BackendInput,
                                                       FinishReason,
                                                       StopConditions)
    from dynamo_tpu_torch.llm.remote import RemoteCoreEngine
    from dynamo_tpu_torch.models.llama import preset
    from dynamo_tpu_torch.runtime.engine import Context
    from dynamo_tpu_torch.utils.prometheus import stage_metrics

    Lk = preset(PRESET).num_layers * (DEVICE == "cuda")
    router = await drt.namespace("dynamo").component("router") \
        .endpoint("route").client().start()
    await router.wait_for_instances(1, timeout=60)
    engine = RemoteCoreEngine(workers, router, model_name=PRESET)
    prompt = np.random.default_rng(FAILOVER_SEED).integers(
        0, vocab, FAILOVER_PROMPT).tolist()
    names = {w: n for n, w in ids.items()}

    async def decision():
        st, raw = await asyncio.to_thread(http_get, http_port,
                                          "/v1/router/decisions")
        last = json.loads(raw)["decisions"][-1]
        decisions.append(last)
        return last["worker_id"]

    decisions: list = []

    async def stream(kill=None):
        bi = BackendInput(token_ids=list(prompt), stop=StopConditions(
            max_tokens=FAILOVER_TOKENS, ignore_eos=True))
        got, hits, finish, killed_at = [], [], None, None
        t0 = time.monotonic()
        ttft = pause = gap = last = None
        async for out in engine.generate(bi, Context()):
            now = time.monotonic()
            if out.finish_reason == FinishReason.ERROR:
                raise AssertionError(f"failover stream failed: {out.error}")
            if out.kv_prefix_hit_tokens is not None:
                # each attempt's first frame carries its prefix hit: a
                # later one is the survivor's first token
                hits.append((len(got), out.kv_prefix_hit_tokens))
                if got and killed_at is not None:
                    pause, gap = now - killed_at, now - last
            if out.token_ids:
                ttft = now - t0 if ttft is None else ttft
                last = now
            got += out.token_ids
            finish = out.finish_reason or finish
            if kill is not None and killed_at is None \
                    and len(got) >= FAILOVER_KILL_AT:
                kill()
                killed_at = time.monotonic()
        return dict(ids=got, hits=hits, ttft_s=ttft, pause_s=pause,
                    gap_s=gap, finish=finish.value if finish else None,
                    total_s=time.monotonic() - t0)

    async def settled(wid):
        # the worker idle in its published metrics, and two router
        # scrapes since: overlap, not a stale load, places the next run
        t0 = time.monotonic()
        while json.loads((await drt.store.get(
                f"metrics/dynamo/backend/{wid:x}")).decode())[
                "request_active_slots"] > 0:
            if time.monotonic() - t0 > 30:
                raise AssertionError(f"worker {wid:x} never went idle")
            await asyncio.sleep(0.05)
        await asyncio.sleep(1.2)

    cold = await stream()
    holder = await decision()
    await settled(holder)
    unkilled = await stream()
    if await decision() != holder:
        raise AssertionError(f"the unkilled run left the cold run's "
                             f"worker: {decisions}")
    (survivor,) = set(ids.values()) - {holder}
    hs, hh = f"{survivor:x}", f"{holder:x}"
    await settled(holder)
    sc0 = await asyncio.to_thread(scrape, http_port)
    own0 = await worker_counters(drt.store, survivor, SURVIVOR_COUNTERS)
    resumed0 = stage_metrics().stream_resumes.get("resumed")

    def resume_latency_sum():
        return _total(samples("\n".join(
            stage_metrics().resume_latency.render())),
            "dyn_resume_latency_seconds_sum")

    latency0 = resume_latency_sum()
    victim = fleet.procs[names[holder]][0]
    killed = await stream(kill=lambda: victim.send_signal(signal.SIGKILL))
    if await decision() != survivor:
        raise AssertionError(f"the resume was not routed to the survivor: "
                             f"{decisions}")
    await asyncio.sleep(4 * FLEET_METRICS_S)
    sc1 = await asyncio.to_thread(scrape, http_port)
    resumed = stage_metrics().stream_resumes.get("resumed") - resumed0
    # the resume layer's own reading: from the break it saw to the
    # survivor's first token (the pause less the break's detection)
    resume_s = resume_latency_sum() - latency0
    # the resumed attempt's first frame: where it re-entered, and the
    # prefix the survivor held for it
    (k, hit_s), = [h for h in killed["hits"] if h[0] > 0] or [(None, None)]
    got = killed["ids"]
    s = _delta(_counts(sc0, hs), _counts(sc1, hs))
    chunk = ENGINE_ARGS["prefill_chunk"]

    own1 = await worker_counters(drt.store, survivor, SURVIVOR_COUNTERS)
    fallbacks, fetches, reattached = (own1[n] - own0[n]
                                      for n in SURVIVOR_COUNTERS)
    row = dict(
        holder=hh, survivor=hs, prompt_tokens=FAILOVER_PROMPT,
        max_tokens=FAILOVER_TOKENS, kill_at=FAILOVER_KILL_AT,
        victim_rc=victim.wait(timeout=30), emitted_before_break=k,
        finish=killed["finish"], tokens=len(got), resumed=resumed,
        pause_s=killed["pause_s"], gap_s=killed["gap_s"],
        resume_latency_s=resume_s,
        cold_ttft_s=cold["ttft_s"],
        unkilled_ttft_s=unkilled["ttft_s"], killed_total_s=killed["total_s"],
        unkilled_equals_cold=unkilled["ids"] == cold["ids"],
        unkilled_total_s=unkilled["total_s"],
        survivor_prefix_hit=hit_s, survivor_launches=s,
        cluster_fetches=fetches, cluster_fallbacks=fallbacks,
        resume_reattached_blocks=reattached,
        rebuild=("failed cluster fetch, then local prefill" if fallbacks
                 else "its own tier" if hit_s else "local prefill"),
        prefix_equals_unkilled=k is not None
        and got[:k] == unkilled["ids"][:k],
        equals_unkilled=got == unkilled["ids"],
        first_divergence=next((i for i, (a, b) in enumerate(
            zip(got, unkilled["ids"])) if a != b), None),
        prompt=prompt, ids=got, unkilled_ids=unkilled["ids"])
    if not (row["finish"] == "length" and len(got) == FAILOVER_TOKENS
            and resumed == 1 and k is not None
            and k >= FAILOVER_KILL_AT and row["prefix_equals_unkilled"]
            and row["victim_rc"] == -signal.SIGKILL
            and s["prefill"] == -(-(FAILOVER_PROMPT + k - hit_s) // chunk)
            and s["flash"] == Lk * s["prefill"]
            and s["decode_step"] >= FAILOVER_TOKENS - k - 1
            and s["paged"] == Lk * s["decode_step"]):
        raise AssertionError(f"failover: "
                             f"{ {n: v for n, v in row.items() if 'ids' not in n and n != 'prompt'} }")
    return row


def failover_reference(torch, params, fo: dict) -> dict:
    """The resumed stream against an in-process engine on the same
    weights and engine arguments. The survivor's part must equal, token
    for token, a cold greedy run of prompt + the tokens emitted before
    the break (the rebuild the survivor made). Both whole streams, the
    unkilled and the killed, are then held to one teacher-forced prefill
    of prompt + stream (:func:`_stream_logits`, the flash path): every
    token must sit within FAILOVER_MARGIN_LIMIT of that step's top logit.
    The two streams may differ where the unkilled run decoded what the
    survivor prefilled: bf16 orders near-tied logits of random weights
    differently on the two paths. Two planted faults, each the survivor's
    greedy continuation from a wrong resume prefix (the last emitted token
    dropped; the emitted tokens ignored), spliced after the emitted
    tokens, must each break the margin."""
    from dynamo_tpu_torch.engine.engine import (TorchEngine,
                                                TorchEngineConfig)
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.protocols.common import (BackendInput,
                                                       StopConditions)

    k, got, prompt = fo["emitted_before_break"], fo["ids"], fo["prompt"]
    eng = TorchEngine(TorchEngineConfig.from_card(
        ModelDeploymentCard.synthetic(PRESET),
        **dict(ENGINE_ARGS, max_batch=CLUSTER_MAX_BATCH), device=DEVICE),
        params)

    def greedy(prefix, n):
        return spec_streams(eng, {"r": BackendInput(
            token_ids=list(prefix), stop=StopConditions(
                max_tokens=n, ignore_eos=True))})["r"]["tokens"]

    def margins(stream):
        # per step: the teacher-forced top logit less the chosen token's
        lg = _stream_logits(torch, eng.core, prompt, stream)
        idx = torch.arange(len(stream), device=lg.device)
        chosen = lg[idx, torch.tensor(stream, device=lg.device)]
        return (lg.max(-1).values - chosen).tolist()

    try:
        row = dict(survivor_equals_cold_rebuild=got[k:] == greedy(
            prompt + got[:k], FAILOVER_TOKENS - k))
        n = fo["first_divergence"]
        if n is not None:
            lg, _ = _prefix_logits(torch, eng.core,
                                   prompt + fo["unkilled_ids"][:n], 1)
            top = torch.topk(lg, 2).values.tolist()
            row.update(diverging_tokens=[got[n], fo["unkilled_ids"][n]],
                       top2_gap=top[0] - top[1],
                       rel_gap=(top[0] - top[1]) / abs(top[0]))
        sound = {"unkilled": margins(fo["unkilled_ids"]),
                 "killed": margins(got)}
        faults = {name: margins(got[:k] + greedy(prefix,
                                                 FAILOVER_TOKENS - k))
                  for name, prefix in (
                      ("last_emitted_dropped", prompt + got[:k - 1]),
                      ("emitted_ignored", prompt))}
    finally:
        eng.shutdown()
    worst = {name: max(m) for name, m in {**sound, **faults}.items()}
    row.update(margin_limit=FAILOVER_MARGIN_LIMIT, worst_margin=worst,
               steps_over_limit={name: sum(x > FAILOVER_MARGIN_LIMIT
                                           for x in m) for name, m in
                                 {**sound, **faults}.items()})
    emit({"phase": "cluster", "step": "failover_margins", **row,
          "margins": {name: m for name, m in {**sound, **faults}.items()}})
    if not (row["survivor_equals_cold_rebuild"]
            and all(worst[name] <= FAILOVER_MARGIN_LIMIT for name in sound)
            and all(worst[name] > FAILOVER_MARGIN_LIMIT for name in faults)):
        raise AssertionError(f"failover stream against the reference: {row}")
    return row


def cluster_phase(torch, smi: str, serve: dict, params) -> dict:
    """Cluster-wide KV sharing on this card, each piece a process of the
    port's own with ``DYN_KV_CLUSTER=1`` and the default lease: the store,
    two Llama-3-8B workers (``max_batch`` 1, so that two requests saturate
    one), the KV router and the discovery frontend. A serves the reuse
    prompt and mirrors its blocks write-through; B, stamped with A as
    donor, fetches them over the data plane and prefills the last 24
    tokens; the router places a second prefix that A holds on B while A is
    saturated, stamping A as donor; last, the reuse prompt, by then in B's
    host tier and partly off its device, waits behind a busy B while its
    blocks stage on the side stream."""
    import asyncio
    import re

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    engine_args = dict(ENGINE_ARGS, max_batch=CLUSTER_MAX_BATCH)
    fleet = Fleet(CLUSTER_DIR)
    fleet.env.update(DYN_KV_CLUSTER="1",
                     DYN_KV_CLUSTER_PUBLISH_INTERVAL=str(CLUSTER_PUBLISH_S))
    try:
        fleet.start("store", "dynamo_tpu_torch.runtime.store_server",
                    "--host", "127.0.0.1", "--port", "0")
        line = fleet.wait_line("store", r"listening on \S+:\d+", 60)
        store_port = int(line.rsplit(":", 1)[1])
        store = f"127.0.0.1:{store_port}"
        t0 = time.perf_counter()
        for name in ("A", "B"):
            fleet.start(name, "dynamo_tpu_torch.cli.worker", "--engine",
                        "torch", "--device", DEVICE, "--store", store,
                        "--register-model", "--model-name", PRESET,
                        "--kv-block-size", str(ENGINE_ARGS["page_size"]),
                        "--metrics-interval", str(FLEET_METRICS_S),
                        "--extra-engine-args", json.dumps(engine_args))
        ids = {}
        for name in ("A", "B"):
            line = fleet.wait_line(name, r"worker [0-9a-f]+ serving",
                                   FLEET_START_S)
            ids[name] = int(line.split()[1], 16)
        workers_start_s = time.perf_counter() - t0
        fleet.start("router", "dynamo_tpu_torch.cli.router", "--store",
                    store, "--block-size", str(ENGINE_ARGS["page_size"]))
        fleet.wait_line("router", r"kv router serving", 120)
        fleet.start("http", "dynamo_tpu_torch.cli.http", "--store", store,
                    "--host", "127.0.0.1", "--port", "0",
                    "--router-component", "router", "--namespace",
                    "dynamo")
        line = fleet.wait_line("http", r"http frontend on :\d+", 120)
        http_port = int(re.search(r":(\d+)", line).group(1))
        t0 = time.monotonic()
        while PRESET not in http_get(http_port, "/v1/models")[1].decode():
            if time.monotonic() - t0 > 60:
                raise AssertionError("frontend never discovered the model")
            time.sleep(0.1)
        planes = fleet.planes(serving=("A", "B", "router"))
        row = asyncio.run(_cluster_async(fleet, store_port, http_port, ids,
                                         serve["reuse"]))
        fleet.stop()        # the card's memory for the reference engine
        fo = row["failover"]
        fo.update(failover_reference(torch, params, fo))
        for key in ("prompt", "ids", "unkilled_ids"):
            fo.pop(key)
        emit({"phase": "cluster", "step": "failover", **fo})
        fetch = row["step1"]["fetch"]
        row.update(phase="cluster", preset=PRESET, engine=engine_args,
                   workers_start_s=workers_start_s, planes=planes,
                   fetch_s=fetch["seconds"], fetch_gb_s=fetch["gb_s"],
                   cluster_warm_minus_cold_ttft_ms=1e3 * (
                       row["ttft_s"]["cluster_warm"]
                       - row["ttft_s"]["cold_local"]),
                   chain_writethrough=serve["chain_writethrough"],
                   chain=serve["chain"], card=smi,
                   loop_wedges_s=fleet.wedges(),
                   phase_s=time.perf_counter() - t_phase)
        emit(row)
        return row
    finally:
        fleet.stop()


# ---------------------------------------------------------------------------
# phase 12: speculative decoding
# ---------------------------------------------------------------------------

SPEC_K = 4
SPEC_SEED = 1111
SPEC_DRAFT = "llama-3.2-1b"      # the one preset with Llama-3's vocab
SPEC_NEAR_TIE = 2e-2             # top-2 gap / |top logit| at a divergence
SPEC_BUDGET_S = 300              # the phase's time limit on the card
SPEC_GREEDY = ("repeat", "reuse", "penalty")
SPEC_COUNTERS = ("prefill_dispatches", "decode_dispatches",
                 "spec_dispatch_total", "spec_proposed_total",
                 "spec_accepted_total", "spec_lane_rounds", "spec_seconds")


def verify_inputs(torch, T, ctx=(64, 300, 777, 1024, 1500, 1800, 2000, 2112),
                  Hq=32, Hkv=8, Dh=128):
    """A verify dispatch as ``engine._spec_round`` builds it: lane b's
    T = K+1 query rows are the last T positions of its ctx[b]-token context
    (valid slots t < ctx[b]), S the longest context, up to max_context plus
    the page pad (2112)."""
    dev = torch.device(DEVICE)
    B, S = len(ctx), max(ctx)
    g = torch.Generator(device=dev).manual_seed(6)
    bf = torch.bfloat16
    q = torch.randn((B, T, Hq, Dh), generator=g, device=dev).to(bf)
    k = torch.randn((B, S, Hkv, Dh), generator=g, device=dev).to(bf)
    v = torch.randn((B, S, Hkv, Dh), generator=g, device=dev).to(bf)
    n = torch.tensor(ctx, dtype=torch.int32, device=dev)[:, None]
    k_pos = torch.arange(S, dtype=torch.int32, device=dev)[None].repeat(B, 1)
    q_pos = (n - T + torch.arange(T, dtype=torch.int32, device=dev)[None])
    return (q, k, v, q_pos.contiguous(), k_pos, k_pos < n), []


def spec_requests(vocab: int) -> dict:
    """The spec phase's requests, made from the seed: a 64-token block
    repeated 8 times (greedy, 128 tokens), the reuse prompt (greedy, 64),
    one sampled request and one presence-penalty request (greedy, an
    opt-out lane riding the verify with zero drafts)."""
    import numpy as np

    from dynamo_tpu_torch.llm.protocols.common import (BackendInput,
                                                       SamplingOptions,
                                                       StopConditions)

    rng = np.random.default_rng(SPEC_SEED)
    block = rng.integers(0, vocab, 64).tolist()

    def bi(prompt, n, **sp):
        return BackendInput(token_ids=prompt, sampling=SamplingOptions(**sp),
                            stop=StopConditions(max_tokens=n,
                                                ignore_eos=True))

    return {"repeat": bi(block * 8, 128),
            "reuse": bi(reuse_prompt(vocab), 64),
            "sampled": bi(block * 2, 64, temperature=0.8, seed=SPEC_SEED),
            "penalty": bi(rng.integers(0, vocab, 200).tolist(), 32,
                          presence_penalty=0.5)}


def spec_streams(engine, reqs: dict) -> dict:
    """The requests of ``reqs`` at once through the engine's AsyncEngine
    entry point: each one's token ids, TTFT and last-token time (s)."""
    import asyncio

    from dynamo_tpu_torch.llm.protocols.common import FinishReason
    from dynamo_tpu_torch.runtime.engine import Context

    async def one(key, bi):
        toks, stamps = [], []
        t0 = time.perf_counter()
        async for o in engine.generate(bi, Context()):
            if o.finish_reason == FinishReason.ERROR:
                raise AssertionError(f"spec request {key} failed: {o.error}")
            toks += o.token_ids
            stamps += [time.perf_counter() - t0] * len(o.token_ids)
        if len(toks) != bi.stop.max_tokens:
            raise AssertionError(f"spec request {key}: {len(toks)} tokens")
        return dict(tokens=toks, ttft_s=stamps[0], last_s=stamps[-1])

    async def go():
        res = await asyncio.gather(*(one(k, bi) for k, bi in reqs.items()))
        return dict(zip(reqs, res))

    return asyncio.run(go())


def _decode_rate(st: dict) -> dict:
    n = len(st["tokens"])
    span = st["last_s"] - st["ttft_s"]
    return dict(ttft_s=st["ttft_s"], decode_tok_s=(n - 1) / span,
                itl_ms=1e3 * span / (n - 1))


def _spec_counts(core) -> dict:
    out = {n: getattr(core, n) for n in SPEC_COUNTERS}
    out["k_rounds"] = dict(core.spec_k_rounds)
    p = core.proposer
    out["draft_sync"] = getattr(p, "sync_dispatches", 0)
    out["draft_steps"] = getattr(p, "steps_run", 0)
    return out


def _spec_delta(a: dict, b: dict) -> dict:
    out = {k: b[k] - a[k] for k in a if k != "k_rounds"}
    out["k_rounds"] = {k: v - a["k_rounds"].get(k, 0)
                       for k, v in b["k_rounds"].items()
                       if v - a["k_rounds"].get(k, 0)}
    return out


def _launches(att) -> dict:
    return {"flash": dict(att.flash_attention.launches_by_head_dim),
            "paged": dict(att.paged_attention.launches_by_head_dim)}


def _reset_launches(att) -> None:
    for w in (att.flash_attention, att.paged_attention):
        w.launches = 0
        w.launches_by_head_dim.clear()


def greedy_rule(torch, core, bi, got: list, want: list) -> dict:
    """Spec-on ``got`` against spec-off ``want`` for one greedy request:
    equal, or, where they first differ, a near-tie: a teacher-forced
    prefill of the prompt and the common prefix (with the request's
    presence penalty over its generated tokens) has a top-2 logit gap
    under SPEC_NEAR_TIE x |top logit| there."""
    n = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if n is None:
        if len(got) != len(want):
            raise AssertionError(f"spec stream length {len(got)} vs "
                                 f"{len(want)}")
        return dict(first_divergence="none")
    lg, _ = _prefix_logits(torch, core, list(bi.token_ids) + want[:n], 1)
    pres = bi.sampling.presence_penalty or 0.0
    if pres and n:
        lg[torch.tensor(sorted(set(want[:n])), device=lg.device)] -= pres
    top = torch.topk(lg, 2).values.tolist()
    row = dict(first_divergence=n, tokens=[got[n], want[n]],
               top2_gap=top[0] - top[1],
               rel_gap=(top[0] - top[1]) / abs(top[0]))
    if row["rel_gap"] >= SPEC_NEAR_TIE:
        raise AssertionError(f"greedy spec stream diverged without a "
                             f"near-tie: {row}")
    return row


def spec_phase(torch, att, smi: str, params) -> dict:
    """Speculative decoding in process at Llama-3-8B full width and depth,
    the serve phase's engine arguments, on the serve phase's weight
    tensors (spec on and off hold the same weights; the card holds one
    copy): n-gram (k=4) and draft-model (llama-3.2-1b, random weights from
    seed + 101) engines against a spec-off one. Every verify dispatch must
    launch the flash kernel once a layer (the target launches no paged
    kernel), the draft's sync chunks and steps launch both kernels at
    Dh=64, greedy streams follow the near-tie rule, every request answers,
    the pool drains, and the HTTP service in front of the draft engine
    shows its spec counters on ``/metrics``."""
    from collections import Counter
    from dataclasses import replace

    from dynamo_tpu_torch.engine.engine import (TorchEngine,
                                                TorchEngineConfig)
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard

    t_phase = time.perf_counter()
    card = ModelDeploymentCard.synthetic(PRESET)

    def engine(**kw):
        return TorchEngine(TorchEngineConfig.from_card(
            card, **ENGINE_ARGS, device=DEVICE, **kw), params)

    off = engine(spec="off")
    try:
        c = off.core
        L = c.cfg.model.num_layers
        reqs = spec_requests(c.cfg.model.vocab_size)
        want = spec_streams(off, reqs)
        off_alone = _decode_rate(spec_streams(
            off, {"repeat": reqs["repeat"]})["repeat"])
    finally:
        off.shutdown()
    rows = {}
    for mode in ("ngram", "draft"):
        kw = dict(spec=mode, spec_k=SPEC_K)
        mine = dict(reqs)
        if mode == "draft":
            kw["spec_draft"] = SPEC_DRAFT
            mine = {k: reqs[k] for k in ("repeat", "reuse")}
        eng = engine(**kw)
        try:
            c = eng.core
            c0 = _spec_counts(c)
            _reset_launches(att)
            t0 = time.perf_counter()
            got = spec_streams(eng, mine)
            wall = time.perf_counter() - t0
            launches = _launches(att)
            d = _spec_delta(c0, _spec_counts(c))
            row = dict(phase="spec", mode=mode, k=SPEC_K, preset=PRESET,
                       engine=ENGINE_ARGS, requests=len(mine), wall_s=wall,
                       **{k: v for k, v in d.items()
                          if k not in ("draft_sync", "draft_steps")},
                       accept_rate=(d["spec_accepted_total"]
                                    / d["spec_proposed_total"]
                                    if d["spec_proposed_total"] else None),
                       launches=launches, card=smi)
            decode_tokens = sum(len(st["tokens"]) - 1 for st in got.values())
            V = d["spec_dispatch_total"]
            row.update(decode_tokens=decode_tokens,
                       tokens_per_verify=decode_tokens / V if V else None,
                       host_s_per_round=d["spec_seconds"] / V if V else None)
            # by head dim: the target's, and the draft's (Dh=64 on the
            # card) in draft mode
            spec_flash = L * (d["prefill_dispatches"] + V)
            want_flash = Counter({c.cfg.model.head_dim: spec_flash})
            want_paged = Counter()
            if mode == "draft":
                dm = c.proposer.mcfg
                dl = dm.num_layers
                want_flash[dm.head_dim] += dl * d["draft_sync"]
                want_paged[dm.head_dim] += dl * d["draft_steps"]
                row.update(draft=SPEC_DRAFT, draft_layers=dl,
                           draft_head_dim=dm.head_dim,
                           draft_sync_dispatches=d["draft_sync"],
                           draft_steps=d["draft_steps"],
                           draft_flash_launches=dl * d["draft_sync"],
                           draft_paged_launches=dl * d["draft_steps"])
            row.update(spec_flash_launches=spec_flash,
                       spec_paged_launches=0)
            if not (V > 0 and d["decode_dispatches"] == 0
                    and sum(d["k_rounds"].values()) == V
                    and launches["flash"] == dict(+want_flash)
                    and launches["paged"] == dict(+want_paged)
                    and (mode == "ngram" or d["draft_steps"] > 0)):
                raise AssertionError(
                    f"spec {mode}: dispatches and launches do not account "
                    f"for each other: {row}, want flash {want_flash}, "
                    f"paged {want_paged}")
            row["greedy"] = {k: greedy_rule(torch, c, reqs[k],
                                            got[k]["tokens"],
                                            want[k]["tokens"])
                             for k in SPEC_GREEDY if k in mine}
            if mode == "ngram":
                row["repeat_alone"] = {"spec": _decode_rate(spec_streams(
                    eng, {"repeat": reqs["repeat"]})["repeat"]),
                    "off": off_alone}
                p0 = c.spec_proposed_total
                v0 = c.spec_dispatch_total
                spec_streams(eng, {"no_spec": replace(
                    reqs["repeat"], no_spec=True,
                    stop=replace(reqs["repeat"].stop, max_tokens=32))})
                row["no_spec"] = dict(
                    proposed=c.spec_proposed_total - p0,
                    verify_dispatches=c.spec_dispatch_total - v0)
                if row["no_spec"]["proposed"] or \
                        not row["no_spec"]["verify_dispatches"]:
                    raise AssertionError(f"no_spec drafted: {row}")
            else:
                # the draft proposes every round: the HTTP service in
                # front of this engine shows non-zero spec counters
                with http_front(card, eng) as (_, port, _):
                    row["http"] = spec_metrics_check(
                        c, port, card.name, smi, "http-draft", drafts=True)
            row["pool_free"] = c.pool.free_pages == c.pool.num_pages - 1
            row["utilization_accept_rate"] = c.utilization()[
                "spec_accept_rate"]
            emit(row)
            if not row["pool_free"]:
                raise AssertionError(f"spec {mode}: pages leaked: {row}")
            rows[mode] = row
        finally:
            eng.shutdown()
    phase_s = time.perf_counter() - t_phase
    if phase_s > SPEC_BUDGET_S:
        raise AssertionError(f"spec phase took {phase_s:.1f} s, over its "
                             f"{SPEC_BUDGET_S} s budget")
    return dict(rows, phase_s=phase_s)


def spec_metrics_check(c, port: int, model: str, smi: str, mode: str,
                       drafts: bool) -> dict:
    """One streamed and one plain greedy completion through the HTTP
    service at ``port`` in front of engine core ``c``: the spec counters'
    change on ``/metrics`` (proposed, accepted, and the accepted-per-
    dispatch histogram's count and sum) must equal the engine's, and with
    ``drafts`` be non-zero."""
    prompt = "the card verifies drafts in one pass " * 12
    names = ("spec_proposed_total", "spec_accepted_total",
             "spec_lane_rounds", "spec_dispatch_total")
    e0 = [getattr(c, n) for n in names]
    sc0 = scrape(port)
    res: dict = {}
    for key, stream in (("stream", True), ("plain", False)):
        http_post(port, "/v1/completions",
                  {"model": model, "prompt": prompt, "max_tokens": 48,
                   "stream": stream, "temperature": 0.0, "ignore_eos": True},
                  res, key)
    sc1 = scrape(port)
    e = [getattr(c, n) - a for n, a in zip(names, e0)]

    def delta(name):
        return _total(sc1, name) - _total(sc0, name)

    engine = dict(proposed=e[0], accepted=e[1], lane_rounds=e[2],
                  verify_dispatches=e[3])
    metrics = dict(
        proposed=delta("dyn_spec_proposed_total"),
        accepted=delta("dyn_spec_accepted_total"),
        lane_rounds=delta("dyn_spec_accepted_per_dispatch_count"),
        accepted_sum=delta("dyn_spec_accepted_per_dispatch_sum"))
    row = dict(phase="spec", mode=mode, engine=engine, metrics=metrics,
               tokens={k: r["usage"]["completion_tokens"]
                       for k, r in res.items()},
               status={k: r["status"] for k, r in res.items()}, card=smi)
    emit(row)
    ok = (all(r["status"] == 200 and r["usage"]["completion_tokens"] > 0
              for r in res.values())
          and engine["verify_dispatches"] > 0
          and (engine["proposed"] > 0 or not drafts)
          and metrics["proposed"] == engine["proposed"]
          and metrics["accepted"] == engine["accepted"]
          and metrics["lane_rounds"] == engine["lane_rounds"]
          and metrics["accepted_sum"] == engine["accepted"])
    if not ok:
        raise AssertionError(f"spec counters on /metrics disagree with "
                             f"the engine: {row}")
    return row


def spec_http_phase(torch, smi: str) -> dict:
    """``cli.run in=http out=torch`` with n-gram speculation from
    ``--extra-engine-args``: :func:`spec_metrics_check` on its server."""
    argv = ["--model-name", PRESET, "--extra-engine-args",
            json.dumps({"preset": PRESET, "spec": "ngram"})]
    with served(argv) as (core, _, port, model, _, _):
        c = core.core
        if c.spec is None or c.spec.mode != "ngram":
            raise AssertionError("the CLI's engine does not speculate")
        row = spec_metrics_check(c, port, model, smi, "http-cli-ngram",
                                 drafts=False)
        row["engine_args"] = argv[-1]
    return row


# ---------------------------------------------------------------------------
# phase 13: Gemma3-4B-it vision-language serving over HTTP
# ---------------------------------------------------------------------------

# google/gemma-3-4b-it's config.json (Gemma3ForConditionalGeneration), as
# the hub ships it: the text_config is sparse and leans on
# Gemma3TextConfig's class defaults, which from_hf_config applies
GEMMA3_4B_HF = {
    "architectures": ["Gemma3ForConditionalGeneration"],
    "model_type": "gemma3", "boi_token_index": 255999,
    "eoi_token_index": 256000, "image_token_index": 262144,
    "mm_tokens_per_image": 256,
    "text_config": {
        "model_type": "gemma3_text", "hidden_size": 2560,
        "intermediate_size": 10240, "num_hidden_layers": 34,
        "rope_scaling": {"factor": 8.0, "rope_type": "linear"},
        "sliding_window": 1024},
    "vision_config": {
        "model_type": "siglip_vision_model", "hidden_size": 1152,
        "intermediate_size": 4304, "num_hidden_layers": 27,
        "num_attention_heads": 16, "image_size": 896, "patch_size": 14,
        "vision_use_head": False},
}
VLM_PRESET = "gemma3-4b"        # the text model GEMMA3_4B_HF must map to
VLM_ENGINE = dict(max_batch=8, max_context=2048, page_size=64,
                  prefill_chunk=512, decode_steps=8)
VLM_TOKENS = 24
# the trained-scale tower's bf16 soft tokens against f32 (per-token
# cosine, the least over the image), from the card's readings: 0.9999902
# sound in every run, 0.9999834 with the attention probabilities rounded
# through float8_e5m2, 0.33 through float8_e4m3. The served tower is held
# to finite soft tokens only: at its seeded scale the sound 0.957 lies
# inside its controls' 0.946-0.958, so no limit tells a defect there
VLM_COS_MIN = 0.99998
VLM_TOWER_SEED = 31


def fan_in_tower(torch, siglip, cfg, seed: int, device) -> dict:
    """A tower at a trained tower's scale: matrices normal / sqrt(fan-in),
    biases 0, layer norms 1 (the seeded init's normal / sqrt(layers) on
    stacked leaves saturates the attention, where bf16 rounding alone
    decides which patch a query attends to)."""
    import math

    g = torch.Generator(device=device).manual_seed(seed)

    def leaf(name, shape):
        if name in ("patch_w", "pos_embed", "wq", "wk", "wv", "wo", "fc1",
                    "fc2"):
            fan = shape[-2] if len(shape) == 3 else shape[0]
            return (torch.randn(shape, generator=g, device=device)
                    / math.sqrt(fan)).to(cfg.dtype)
        if name.endswith("_w"):
            return torch.ones(shape, device=device)
        return torch.zeros(shape, device=device,
                           dtype=torch.float32 if name.startswith(
                               ("ln", "post")) else cfg.dtype)

    shapes = siglip.param_shapes(cfg)
    out = {k: leaf(k, v) for k, v in shapes.items() if k != "layers"}
    out["layers"] = {k: leaf(k, v) for k, v in shapes["layers"].items()}
    return out


def test_image(seed: int, h: int, w: int):
    """A seeded photo-like uint8 [h, w, 3]: smooth gradients and noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([128 + 100 * np.sin(x / (17 + 9 * c) + y / (23 + 5 * c)
                                        + seed) for c in range(3)], -1)
    return np.clip(base + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(
        np.uint8)


def vlm_phase(torch, att, smi: str) -> dict:
    """Gemma3-4B-it (full width and depth, random bf16 weights from the
    seed, the SigLIP tower from seed + 1) served over HTTP: image chat
    requests as PNG data URLs through admission (the tower), span-aligned
    chunking, dense image waves and flash text waves, and paged decode."""
    import base64
    import dataclasses
    import gc

    import numpy as np
    import torch.nn.functional as F

    from dynamo_tpu_torch.device import to_device
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.engine.multimodal import normalize_image
    from dynamo_tpu_torch.llm import _png
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.preprocessor import Preprocessor
    from dynamo_tpu_torch.llm.protocols.openai import ChatCompletionRequest
    from dynamo_tpu_torch.models import llama, siglip

    t_phase = time.perf_counter()
    # an earlier phase's engine may sit in reference cycles (its HTTP
    # service, loop and pipeline) that only a collection frees
    gc.collect()
    torch.cuda.empty_cache()
    mem_start = torch.cuda.memory_allocated()
    big, small = test_image(1200, 900, 1200), test_image(640, 480, 640)
    other = test_image(7, 900, 1200)
    # Paeth on every row (what an encoder mostly picks on photos): the
    # decoder's slowest filter, undone along anti-diagonals
    pngs = {k: _png.encode(v) for k, v in
            (("big", big), ("small", small), ("other", other))}
    t0 = time.perf_counter()
    decoded = _png.decode(pngs["big"])
    png_decode_s = time.perf_counter() - t0
    decoded_bitwise = bool(np.array_equal(decoded, big))
    urls = {k: "data:image/png;base64," + base64.b64encode(v).decode()
            for k, v in pngs.items()}
    card = ModelDeploymentCard.synthetic("gemma3-4b-it",
                                         model_config=GEMMA3_4B_HF)
    cfg = TorchEngineConfig.from_card(card, device=DEVICE, **VLM_ENGINE)
    m = cfg.model
    want = llama.preset(VLM_PRESET)
    mapped_ok = all(getattr(m, f.name) == getattr(want, f.name)
                    for f in dataclasses.fields(want)
                    if f.name not in ("vision", "mm_tokens_per_image",
                                      "image_token_id"))
    n_soft = GEMMA3_4B_HF["mm_tokens_per_image"]
    if not (mapped_ok and m.image_token_id
            == GEMMA3_4B_HF["image_token_index"]
            and m.mm_tokens_per_image == n_soft):
        raise AssertionError(f"the HF config did not map to {VLM_PRESET}: "
                             f"{m}")
    t0 = time.perf_counter()
    engine = TorchEngine(cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    c = engine.core
    L = m.num_layers
    # every prefill dispatch's attention path and query spans, read after
    # the phase (a copy on the card: no sync inside the dispatch)
    waves: list = []
    forward = llama.forward

    def recorded(*args, **kw):
        spans = kw.get("attn_spans")
        waves.append((kw["attn_impl"],
                      None if spans is None else spans[0].clone()))
        return forward(*args, **kw)

    def text(s):
        return {"type": "text", "text": s}

    def image(k):
        return {"type": "image_url", "image_url": {"url": urls[k]}}

    def chat(content, **kw):
        return ("/v1/chat/completions", {
            "model": card.name, "max_tokens": VLM_TOKENS, "min_tokens": 4,
            "stream": True, "logprobs": 1,
            "messages": [{"role": "user", "content": content}], **kw})

    reqs = {"img_down": chat([text("Describe this picture."), image("big")]),
            "img_up": chat([text("What is in this image?"), image("small")]),
            "both": chat([text("Compare"), image("big"), text("with"),
                          image("small")]),
            "text": chat("Say hello in three words.")}
    llama.forward = recorded
    try:
        with http_front(card, engine) as (loop, port, _):
            att.flash_attention.launches = 0
            att.paged_attention.launches = 0
            base = (c.prefill_dispatches, c.decode_steps_run, c.image_waves,
                    c.images_encoded, c.vision_seconds,
                    att.flash_attention.launches_by_head_dim[m.head_dim])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            results: dict = {}
            threads = [threading.Thread(target=http_post,
                                        args=(port, p, b, results, k))
                       for k, (p, b) in reqs.items()]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            for k in reqs:
                r = results.get(k)
                if r is None or r["status"] != 200 or not r["usage"] \
                        or r["usage"]["completion_tokens"] < 1 \
                        or not r["done"]:
                    raise AssertionError(f"vlm request {k} failed: {r}")
            burst_images = c.images_encoded - base[3]
            # the same requests straight through the engine, greedy
            pre = Preprocessor(card)

            def request(content):
                body = dict(chat(content, temperature=0.0)[1],
                            max_tokens=16, stream=False)
                bi = pre.preprocess_chat(
                    ChatCompletionRequest.from_dict(body)).backend_input
                bi.stop.ignore_eos = True
                return bi

            img_req = [text("Describe this picture."), image("big")]
            other_req = [text("Describe this picture."), image("other")]
            c.flush_reusable()
            g1 = _generate_request(engine, loop, request(img_req))
            c.flush_reusable()
            g2 = _generate_request(engine, loop, request(img_req))
            # the warm repeat's chunk starts inside the span whose head it
            # restored (as the JAX engine's does): its waves are not whole
            warm = len(waves)
            rep = _generate_request(engine, loop, request(img_req))
            warm = range(warm, len(waves))
            oth = _generate_request(engine, loop, request(other_req))
            c.flush_reusable()
            txt = _generate_request(engine, loop,
                                    request("Say hello in three words."))
            peak = torch.cuda.max_memory_allocated()
            flash_n = att.flash_attention.launches
            paged_n = att.paged_attention.launches
            flash_dh = (att.flash_attention.launches_by_head_dim[m.head_dim]
                        - base[5])
            counts = dict(
                prefill_dispatches=c.prefill_dispatches - base[0],
                decode_steps=c.decode_steps_run - base[1],
                image_waves=c.image_waves - base[2],
                images_encoded=c.images_encoded - base[3],
                vision_s=c.vision_seconds - base[4])
    finally:
        llama.forward = forward
        engine.shutdown()
    # the tower in bf16 against the same tower in f32, on the card: the
    # served (seeded) tower, and one at a trained tower's scale. Three
    # controls change only the attention probabilities: a softmax taken in
    # bf16 (its output is rounded to bf16 for the PV product either way),
    # and probabilities rounded through float8_e5m2 and float8_e4m3; the
    # limit must catch the last
    t0 = time.perf_counter()
    px = normalize_image(big, c.vision_cfg.image_size)[None]
    normalize_s = time.perf_counter() - t0
    vcfg = c.vision_cfg
    vc32 = dataclasses.replace(vcfg, dtype=torch.float32)
    softmax = torch.softmax
    controls = {
        "bf16_softmax": lambda s, dim: softmax(s.to(torch.bfloat16), dim=dim),
        "e5m2_probs": lambda s, dim: softmax(s, dim=dim).to(
            torch.float8_e5m2).float(),
        "e4m3_probs": lambda s, dim: softmax(s, dim=dim).to(
            torch.float8_e4m3fn).float()}

    def f32(tree):
        return {k: f32(v) if isinstance(v, dict) else v.float()
                for k, v in tree.items()}

    def encode(vp, pp, vc):
        return siglip.project(pp, vc, siglip.forward(vp, vc, xd), n_soft)

    def cos_mins(name, vp, pp):
        soft32 = encode(f32(vp), f32(pp), vc32)[0]
        out = {}
        for ctl in (None, *controls):
            # the engine has stopped: nothing else calls torch.softmax
            torch.softmax = controls.get(ctl, softmax)
            try:
                soft16 = encode(vp, pp, vcfg)[0]
            finally:
                torch.softmax = softmax
            if ctl is None:
                finite[name] = bool(torch.isfinite(soft16).all())
            out[name + ("_" + ctl if ctl else "")] = float(
                F.cosine_similarity(soft16.float(), soft32, dim=-1).min())
        return out

    finite: dict = {}

    with torch.no_grad():
        xd = to_device(px, c.device)
        scaled = fan_in_tower(torch, siglip, vcfg, VLM_TOWER_SEED, c.device)
        cos = {**cos_mins("served", c.vision_params, c.proj_params),
               **cos_mins("scaled", scaled, c.proj_params)}
        del scaled
        tower_ms = time_ms(torch, lambda: encode(
            c.vision_params, c.proj_params, vcfg), 3)
    wave_paths = [(impl, spans is not None) for impl, spans in waves]
    text_waves = sum(1 for _, mm in wave_paths if not mm)
    image_waves = sum(1 for _, mm in wave_paths if mm)
    spans = []
    for i, (_, q_span) in enumerate(waves):
        if q_span is not None and i not in warm:
            for row in q_span.cpu():
                spans += torch.unique(row[row > 0],
                                      return_counts=True)[1].tolist()
    r = results
    row = dict(
        phase="vlm", model="gemma3-4b-it", engine=VLM_ENGINE, init_s=init_s,
        weight_bytes=_nbytes(c.params),
        tower_bytes=_nbytes([c.vision_params, c.proj_params]),
        png_bytes={k: len(v) for k, v in pngs.items()},
        png_decode_bitwise=decoded_bitwise,
        png_decode_1200x900_paeth_s=png_decode_s, **counts,
        text_waves=text_waves, image_waves_recorded=image_waves,
        waves_on_their_paths=all(impl == ("dense" if mm else "flash")
                                 for impl, mm in wave_paths),
        flash_launches=flash_n, paged_launches=paged_n,
        flash_launches_at_head_dim=flash_dh, span_tokens=sorted(set(spans)),
        spans_whole=all(n == n_soft for n in spans) and bool(spans),
        burst_images=burst_images,
        prompt_tokens={k: v["usage"]["prompt_tokens"] for k, v in r.items()},
        burst_ttft_s={k: v["ttft_s"] for k, v in r.items()},
        alone_ttft_s={"image": g1[2], "image_again": g2[2],
                      "image_warm": rep[2], "text": txt[2]},
        greedy_repeats=g1[0] == g2[0], greedy_tokens=len(g1[0]),
        hits={"cold": g1[1], "cold_again": g2[1], "repeat": rep[1],
              "other_image": oth[1]},
        repeat_tokens_equal=rep[0] == g1[0],
        tower_ms_per_image=tower_ms, normalize_1200x900_s=normalize_s,
        engine_tower_ms_per_image=1e3 * counts["vision_s"]
        / max(1, counts["images_encoded"]),
        soft_token_cos_min=cos, soft_token_cos_limit_scaled=VLM_COS_MIN,
        soft_tokens_finite=finite,
        peak_mem_bytes=peak, mem_at_start_bytes=mem_start,
        phase_s=time.perf_counter() - t_phase, card=smi)
    emit(row)
    ok = (decoded_bitwise and row["spans_whole"]
          and row["waves_on_their_paths"]
          and image_waves == counts["image_waves"] > 0 and text_waves > 0
          and counts["prefill_dispatches"] == text_waves + image_waves
          and flash_n == flash_dh == L * text_waves
          and paged_n == L * counts["decode_steps"] > 0
          and burst_images == 4 and row["greedy_repeats"]
          and row["repeat_tokens_equal"]
          and g1[1] == g2[1] == 0 and rep[1] > 0 and oth[1] == 0
          and all(finite.values())
          and cos["scaled"] >= VLM_COS_MIN > cos["scaled_e4m3_probs"])
    if not ok:
        raise AssertionError(f"vlm phase failed: {row}")
    return row


# ---------------------------------------------------------------------------
# phase 15: the KV paging long-context lane
# ---------------------------------------------------------------------------

KVPAGE_ENGINE = dict(max_batch=8, max_context=2048, page_size=64,
                     prefill_chunk=512, decode_steps=8, host_cache_blocks=384,
                     kvpage_budget=20, kvpage_seg_pages=8, kvpage_prefetch=2,
                     kvpage_max_context=16384)
KVPAGE_PROMPTS = (10240, 6144)      # 8x and 4.8x the 1280-token budget
KVPAGE_TOKENS = 16
KVPAGE_SHORT_TOKENS = 8             # (c) and (e): one decode window each
KVPAGE_DENSE_TOKENS = 64            # the dense-path request beside (a)
KVPAGE_SEED = 10240
KVPAGE_BUDGET_S = 300               # the phase's time limit on the card
# every step of a paged greedy stream against the dense path's logits over
# the same tokens: the most |paged - dense| a sound lane may show, set
# between the sound runs' largest reading (0.664) and the least of the
# planted faults' (5.88, one cold segment dropped) on the card
# (scripts/kvpage_faults.py, PERF.md)
KVPAGE_LOGIT_LIMIT = 2.0
KVPAGE_FAULT_TOKENS = 4             # a planted fault's stream
KVPAGE_FAULTS = ("drop_segment", "no_upload_wait")   # the gate must fail
# spin cycles (about 20 ms) that hold back each layer's first staging
# upload on the side stream in a planted fault: longer than the host takes
# to enqueue a layer's segments (about 1 ms each), so an attention that
# does not wait reads stale slots through the layer (a hold of 5 ms left
# one step of four within 0.92 of the dense logits)
KVPAGE_UPLOAD_DELAY = 40_000_000


def kvpage_demotions(prompt: int, matched: int, new: int, chunk: int,
                     page: int, lane_budget: int, chain: int) -> int:
    """Blocks the paged lane demotes serving one greedy request, from the
    configuration alone: each prefill chunk leases its pages, then sealed
    blocks demote until ``lane_budget - chunk_pages - 1`` stay resident;
    a decode window of ``chain`` tokens demotes first if its new pages
    would take the lane over its share."""
    chunk_pages = -(-chunk // page)
    hot_keep = max(1, lane_budget - chunk_pages - 1)
    first, res, done, dem = matched, 0, matched * page, 0

    def demote(keep, sealed):
        nonlocal first, res, dem
        n = 0
        while res - n > keep and first + n < sealed:
            n += 1
        dem, first, res = dem + n, first + n, res - n

    while done < prompt:
        done += min(chunk, prompt - done)
        res = -(-done // page) - first
        demote(hot_keep, done // page)
    total, gen = prompt, 1
    while gen < new:
        n = min(chain, new - gen)
        need = -(-(total + n) // page) - first - res
        if res + need > lane_budget:
            demote(lane_budget - need, total // page)
        res += need
        total, gen = total + n, gen + n
    return dem


def _kvpage_counters() -> dict:
    from dynamo_tpu_torch.utils.prometheus import stage_metrics

    st = stage_metrics()
    wait = st.kvpage_pagein_wait.state()["series"].get("", {})
    return dict(demotions=st.kvpage_demotions.get(),
                pageins=st.kvpage_pageins.get(),
                faults=st.kvpage_faults.get(),
                pagein_wait_s=float(wait.get("sum", 0.0)),
                pagein_wait_n=float(wait.get("total", 0)))


def _stream_rate(st: dict) -> dict:
    n = len(st["tokens"])
    return dict(ttft_s=st["ttft_s"],
                decode_ms_step=1e3 * (st["last_s"] - st["ttft_s"]) / (n - 1))


def _stream_logits(torch, core, prompt, tokens):
    """The dense path's teacher-forced logits of a greedy stream through
    ``llama.forward`` (the flash kernel) in a scratch pool: row i is what
    chooses ``tokens[i]``, from ``prompt + tokens[:i]``. The prompt goes in
    chunks of the engine's ``prefill_chunk``, then ``tokens[:-1]`` in one
    chunk. f32 [len(tokens), vocab]."""
    from dynamo_tpu_torch.models import llama

    m, dev, page = core.cfg.model, core.device, core.page_size
    full = list(prompt) + list(tokens[:-1])
    n_pages = -(-len(full) // page) + 1          # + scratch page 0
    shape = (m.num_layers, m.num_kv_heads, n_pages, page, m.head_dim)
    kp = torch.zeros(shape, dtype=m.dtype, device=dev)
    vp = torch.zeros(shape, dtype=m.dtype, device=dev)
    toks = torch.tensor(full, device=dev)[None]

    def chunk(c0, c1, last_only):
        pos = torch.arange(c0, c1, dtype=torch.int32, device=dev)[None]
        ctx = torch.arange(c1, device=dev)[None]
        lg, _, _ = llama.forward(
            core.params, m, toks[:, c0:c1], pos, kp, vp, page + pos.long(),
            page + ctx, ctx.to(torch.int32),
            torch.ones((1, c1), dtype=torch.bool, device=dev),
            logits_idx=torch.tensor([c1 - c0 - 1], device=dev)
            if last_only else None)
        return lg[0].float()

    n = len(prompt)
    with torch.no_grad():
        for c0 in range(0, n, core.cfg.prefill_chunk):
            c1 = min(n, c0 + core.cfg.prefill_chunk)
            rows = [chunk(c0, c1, True)]
        if len(full) > n:
            rows.append(chunk(n, len(full), False))
    return torch.cat(rows)


def kvpage_record(torch, kp):
    """Have the lane's sampling head also keep the f32 logits it samples
    from, one [B, vocab] tensor a call (the prefill tail's, then each
    decode step's): returns that list and a function that undoes it."""
    from dynamo_tpu_torch.models import llama

    prg, rec = kp.programs, []
    head, m = prg.head, kp.core.cfg.model

    def recorded(params, x, last_i, *rest):
        rows = torch.arange(x.shape[0], device=x.device)
        rec.append(llama._lm_head(x[rows, last_i][:, None], params,
                                  m)[:, 0].float())
        return head(params, x, last_i, *rest)

    prg.head = recorded
    return rec, lambda: delattr(prg, "head")


def kvpage_stream_check(torch, core, prompt, got: list, rows: list) -> dict:
    """Every token of one lane's greedy stream (``rows``: its logits as
    :func:`kvpage_record` kept them, row 0 of each call) against the dense
    path's teacher-forced logits over the same tokens: per step the most
    |paged - dense| logit, the relative L2 distance, and the dense path's
    margin for the token the lane chose, (top - chosen) / |top| (0 where
    it is the dense argmax too)."""
    want = _stream_logits(torch, core, prompt, got)
    lane = torch.stack([r[0] for r in rows])
    if lane.shape != want.shape:
        raise AssertionError(f"kvpage: {lane.shape[0]} lane logit rows for "
                             f"{len(got)} tokens")
    delta = lane - want
    top = want.max(-1).values
    chosen = want[torch.arange(len(got), device=want.device),
                  torch.tensor(got, device=want.device)]
    out = dict(steps=len(got),
               max_abs=delta.abs().amax(-1).tolist(),
               rel_l2=(delta.norm(dim=-1) / want.norm(dim=-1)).tolist(),
               margin=((top - chosen) / top.abs()).tolist(),
               max_logit=top.abs().max().item())
    out.update(worst_abs=max(out["max_abs"]), worst_rel=max(out["rel_l2"]),
               worst_margin=max(out["margin"]),
               lane_argmax=all(int(lane[i].argmax()) == t
                               for i, t in enumerate(got)))
    return out


def kvpage_sound(tf: dict) -> bool:
    """Whether a teacher-forced reading passes the lane's gate: every
    token is the argmax of the logits the lane kept, and those are within
    ``KVPAGE_LOGIT_LIMIT`` of the dense path's at every step, so each
    token is within twice the limit of the dense path's top logit."""
    return tf["lane_argmax"] and tf["worst_abs"] <= KVPAGE_LOGIT_LIMIT


@contextlib.contextmanager
def kvpage_fault(torch, kp, name: str):
    """Plant one fault in the lane ``kp`` for the runs inside:

    - ``drop_segment``: every cold plan leaves out its second segment;
    - ``no_upload_wait``: the attention on a staging slot no longer waits
      on that slot's upload, and each layer's first upload is held back
      (``KVPAGE_UPLOAD_DELAY`` spin cycles on the side stream, which the
      uploads after it queue behind), so the missing wait shows;
    - ``no_upload_wait_undelayed``: the missing wait alone;
    - ``delayed_upload``: the delay with the wait kept (a sound control);
    - ``bf16_merge``: the online-softmax sums rounded to bf16 after every
      merge;
    - ``uncached_window``: no decode window keeps its host slots (sound:
      every step takes its segments from the pager again);
    - ``none``: nothing."""
    from dynamo_tpu_torch.llm.kvpage import programs, runner

    undo = []

    def patch(obj, attr, value):
        undo.append((obj, attr, getattr(obj, attr), attr in vars(obj)))
        setattr(obj, attr, value)

    if name == "drop_segment":
        segs = kp._cold_segments
        patch(kp, "_cold_segments", lambda seq: (lambda s: s[:1] + s[2:])(
            segs(seq)))
    if name in ("no_upload_wait", "no_upload_wait_undelayed"):
        patch(kp, "_attend_slot", lambda i: None)
    if name in ("no_upload_wait", "delayed_upload"):
        upload = kp._upload_step

        def delayed(B, l, s, cache=None, fill=None):
            if s == 0 and kp._side is not None:
                with torch.cuda.stream(kp._side):
                    torch.cuda._sleep(KVPAGE_UPLOAD_DELAY)
            return upload(B, l, s, cache, fill)

        patch(kp, "_upload_step", delayed)
    if name == "bf16_merge":
        merge = programs._merge

        def rounded(*a):
            o, m, d = merge(*a)
            return (o.to(torch.bfloat16).float(), m,
                    d.to(torch.bfloat16).float())

        patch(programs, "_merge", rounded)
    if name == "uncached_window":
        patch(runner, "WINDOW_CACHE_BYTES", -1)
    try:
        yield
    finally:
        for obj, attr, value, own in reversed(undo):
            if own:
                setattr(obj, attr, value)
            else:
                delattr(obj, attr)


def kvpage_fault_run(torch, eng, prompt, name: str, tokens: int) -> dict:
    """One greedy stream of ``prompt`` through the lane of ``eng`` with the
    fault ``name`` planted (:func:`kvpage_fault`), held to the dense path
    by :func:`kvpage_stream_check`."""
    core = eng.core
    kp = core.kvpager
    rec, unrecord = kvpage_record(torch, kp)
    w0, s0, d0 = kp.decode_windows, kp.decode_steps_run, kp.decode_seconds
    try:
        with kvpage_fault(torch, kp, name):
            got = spec_streams(eng, {name: _greedy_request(prompt, tokens)})
    finally:
        unrecord()
    st = got[name]
    tf = kvpage_stream_check(torch, core, prompt, st["tokens"], rec)
    steps = kp.decode_steps_run - s0
    return dict(fault=name, tokens=tokens, prefix_hit=core.last_prefix_hit,
                decode_windows=kp.decode_windows - w0, decode_steps=steps,
                decode_ms_step=1e3 * (kp.decode_seconds - d0) / steps
                if steps else None, teacher_forced=tf,
                sound=kvpage_sound(tf))


def _greedy_request(prompt, n):
    """A greedy request of ``n`` tokens that ignores EOS."""
    from dynamo_tpu_torch.llm.protocols.common import (BackendInput,
                                                       StopConditions)

    return BackendInput(token_ids=prompt, stop=StopConditions(
        max_tokens=n, ignore_eos=True))


def kvpage_phase(torch, att, smi: str, params) -> dict:
    """The KV paging lane at Llama-3-8B full width and depth on the serve
    phase's weight tensors (one copy on the card, shared by every engine
    here): a dense reference engine whose ``max_context`` holds the long
    prompts, then engines with the dense ``max_context`` of 2048 and a
    20-page lane (1280 tokens) over a 384-block host tier.
    (a) a greedy 10240-token prompt for 16 tokens through the lane, with
    (d) a 64-token dense-path request served beside it; (b) the same
    prompt again from the pinned prefix; two planted faults
    (``KVPAGE_FAULTS``) from the pinned prefix; (c) two lanes
    (``kvpage_batch`` 2) with the 10240- and 6144-token prompts at once
    for 8 tokens, each held to its stream alone on that engine; (e) over
    HTTP through ``cli.run``: the long prompt streams a 200 with paging
    and gets the typed 400 without.
    Gates: tokens equal to the dense engine's or a first divergence at a
    near-tie (:func:`greedy_rule`); every step of (a) and (b) against the
    dense path's teacher-forced logits (:func:`kvpage_sound`), which both
    planted faults must fail; at most 20 pages leased, the demotion counts
    :func:`kvpage_demotions` gives, a reuse hit, no page fault. The last
    prefill position against the dense path and two controls of the dense
    path alone (plain attention against flash, chunk 256 against 512) are
    reported."""
    import gc
    import urllib.error
    from dataclasses import replace
    from types import SimpleNamespace

    import numpy as np

    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.models import llama

    t_phase = time.perf_counter()
    m = llama.preset(PRESET)
    rng = np.random.default_rng(KVPAGE_SEED)
    long_p, mid_p = (rng.integers(0, m.vocab_size, n).tolist()
                     for n in KVPAGE_PROMPTS)
    short_p = rng.integers(0, m.vocab_size, KVPAGE_DENSE_TOKENS).tolist()
    page = KVPAGE_ENGINE["page_size"]

    def bi(prompt, n=KVPAGE_TOKENS):
        return _greedy_request(prompt, n)

    def engine(**kw):
        return TorchEngine(TorchEngineConfig(
            model=m, device=DEVICE, **{**KVPAGE_ENGINE, **kw}), params)

    def peak_gb(base):
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 1e9

    # earlier phases' engines sit in reference cycles: collect them first,
    # so the peaks below are this phase's own
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    # the dense reference: a pool that holds the long prompts
    ctx = KVPAGE_PROMPTS[0] + KVPAGE_DENSE_TOKENS + KVPAGE_TOKENS
    torch.cuda.reset_peak_memory_stats()
    dense = engine(max_batch=2, max_context=ctx, host_cache_blocks=0,
                   kvpage_budget=0)
    try:
        ref = spec_streams(dense, {"long": bi(long_p)})
        ref.update(spec_streams(dense, {"short": bi(short_p)}))
        dense_peak = peak_gb(base)
    finally:
        dense.shutdown()
        del dense
        gc.collect()            # the core's hooks hold a cycle to its pool
        torch.cuda.empty_cache()

    c0 = _kvpage_counters()
    torch.cuda.reset_peak_memory_stats()
    eng = engine()
    rows = {}
    try:
        core = eng.core
        kp = core.kvpager
        L = m.num_layers
        rec, unrecord = kvpage_record(torch, kp)
        _reset_launches(att)
        t0 = time.perf_counter()
        got = spec_streams(eng, {"long": bi(long_p),
                                 "short": bi(short_p)})
        wall_a = time.perf_counter() - t0
        launches = _launches(att)
        unrecord()
        peak_paged = peak_gb(base)
        if got["short"]["tokens"] != ref["short"]["tokens"]:
            raise AssertionError("kvpage (d): the dense-path request beside "
                                 "the lane changed its tokens")
        if got["short"]["last_s"] >= got["long"]["last_s"]:
            raise AssertionError("kvpage (d): the 64-token request did not "
                                 "finish while the long prompt ran")
        if not (launches["flash"].get(m.head_dim, 0) >= L
                and launches["paged"].get(m.head_dim, 0) >= L):
            raise AssertionError(f"kvpage (d): the dense request did not "
                                 f"launch both kernels: {launches}")
        ag = greedy_rule(torch, core, bi(long_p), got["long"]["tokens"],
                         ref["long"]["tokens"])
        # every step against the dense path over the lane's own tokens
        tf_a = kvpage_stream_check(torch, core, long_p,
                                   got["long"]["tokens"], rec)
        # the last prefill position's logits against the dense prefill's,
        # and two controls of the dense path alone: the plain attention
        # against the flash kernel, chunk 256 against 512
        paged_lg = rec[0][0]
        lg512, _ = _prefix_logits(torch, core, long_p, 1)
        half = SimpleNamespace(cfg=replace(core.cfg, prefill_chunk=256),
                               params=core.params, device=core.device,
                               page_size=core.page_size)
        lg256, _ = _prefix_logits(torch, half, long_p, 1)
        plain, _ = _prefix_logits(torch, core, long_p, 1, attn_impl="dense")
        scale = lg512.abs().max().item()
        diff = (paged_lg - lg512).abs().max().item()
        control = (plain - lg512).abs().max().item()
        logits = dict(max_abs=scale, paged_vs_dense=diff,
                      plain_vs_flash=control,
                      paged_vs_plain=(paged_lg - plain).abs().max().item(),
                      chunk_256_vs_512=(lg256 - lg512).abs().max().item(),
                      argmax_equal=int(paged_lg.argmax()) == int(
                          lg512.argmax()))
        lane_budget = kp.lane_budget
        want_a = kvpage_demotions(KVPAGE_PROMPTS[0], 0, KVPAGE_TOKENS,
                                  core.cfg.prefill_chunk, page, lane_budget,
                                  kp.decode_chain)
        c1 = _kvpage_counters()
        dem_a = kp.demoted_blocks
        row_a = dict(phase="kvpage", run="a", prompt=KVPAGE_PROMPTS[0],
                     engine=KVPAGE_ENGINE, wall_s=wall_a,
                     paged=_stream_rate(got["long"]),
                     dense=_stream_rate(ref["long"]),
                     beside=dict(short_ttft_s=got["short"]["ttft_s"],
                                 short_last_s=got["short"]["last_s"],
                                 long_last_s=got["long"]["last_s"]),
                     greedy=ag, teacher_forced=tf_a, logits=logits,
                     logit_limit=KVPAGE_LOGIT_LIMIT,
                     demotions=dem_a, demotions_want=want_a,
                     peak_pages=kp.peak_resident,
                     prefill_chunks=kp.prefill_chunks,
                     prefill_s=kp.prefill_seconds,
                     decode_windows=kp.decode_windows,
                     decode_steps=kp.decode_steps_run,
                     decode_s=kp.decode_seconds,
                     pagein=kp.pagein_stats(),
                     counters={k: c1[k] - c0[k] for k in c1},
                     launches=launches,
                     peak_gb=dict(paged=peak_paged, dense=dense_peak),
                     card=smi)
        pi = row_a["pagein"]
        row_a["pagein"].update(
            assemble_gbs=pi["bytes"] / pi["assemble_s"] / 1e9
            if pi["assemble_s"] else None,
            upload_gbs=pi["bytes"] / pi["upload_s"] / 1e9
            if pi["upload_s"] else None)
        emit(row_a)
        if not kvpage_sound(tf_a):
            raise AssertionError(f"kvpage (a): the lane's stream is off the "
                                 f"dense path's logits: {tf_a}")
        if kp.peak_resident > KVPAGE_ENGINE["kvpage_budget"] or \
                dem_a != want_a or row_a["counters"]["faults"] or \
                not row_a["counters"]["pageins"]:
            raise AssertionError(f"kvpage (a): residency, demotions or "
                                 f"page-ins off: {row_a}")
        rows["a"] = row_a

        # (b) the same prompt again: its demoted prefix is pinned, not
        # recomputed
        d0, c1 = kp.demoted_blocks, _kvpage_counters()
        rec, unrecord = kvpage_record(torch, kp)
        try:
            got_b = spec_streams(eng, {"long": bi(long_p)})["long"]
        finally:
            unrecord()
        hit = core.last_prefix_hit
        want_b = kvpage_demotions(KVPAGE_PROMPTS[0], hit // page,
                                  KVPAGE_TOKENS, core.cfg.prefill_chunk,
                                  page, lane_budget, kp.decode_chain)
        c2 = _kvpage_counters()
        row_b = dict(phase="kvpage", run="b", prefix_hit=hit,
                     paged=_stream_rate(got_b),
                     greedy=greedy_rule(torch, core, bi(long_p),
                                        got_b["tokens"],
                                        ref["long"]["tokens"]),
                     teacher_forced=kvpage_stream_check(
                         torch, core, long_p, got_b["tokens"], rec),
                     demotions=kp.demoted_blocks - d0,
                     demotions_want=want_b,
                     counters={k: c2[k] - c1[k] for k in c2}, card=smi)
        emit(row_b)
        if hit <= 0 or row_b["demotions"] != want_b or \
                row_b["counters"]["faults"] or \
                not kvpage_sound(row_b["teacher_forced"]):
            raise AssertionError(f"kvpage (b): no reuse, counts off or the "
                                 f"stream off the dense path: {row_b}")
        rows["b"] = row_b

        # planted faults, each served from the pinned prefix: the gate
        # above must refuse every one
        faults = [kvpage_fault_run(torch, eng, long_p, name,
                                   KVPAGE_FAULT_TOKENS)
                  for name in KVPAGE_FAULTS]
        emit(dict(phase="kvpage", run="faults", runs=faults, card=smi))
        if any(f["sound"] for f in faults):
            raise AssertionError(f"kvpage: a planted fault passed the "
                                 f"gate: {faults}")
        rows["faults"] = faults
        if core.pool.free_pages != core.pool.num_pages - 1 or \
                core.tiered.pinned_count():
            raise AssertionError("kvpage: pages or pins leaked")
    finally:
        eng.shutdown()
        del eng
        gc.collect()
        torch.cuda.empty_cache()

    # (c) two lanes at once, each against its stream alone on this engine
    # (the tier cleared between runs, so no run reuses another's prefix)
    eng = engine(kvpage_batch=2)
    try:
        core = eng.core
        kp = core.kvpager
        alone = {}
        n_c = KVPAGE_SHORT_TOKENS
        for key, prompt in (("long", long_p), ("mid", mid_p)):
            alone.update(spec_streams(eng, {key: bi(prompt, n_c)}))
            core.tiered.clear()
        d0, c1 = kp.demoted_blocks, _kvpage_counters()
        t0 = time.perf_counter()
        both = spec_streams(eng, {"long": bi(long_p, n_c),
                                  "mid": bi(mid_p, n_c)})
        wall_c = time.perf_counter() - t0
        c2 = _kvpage_counters()
        want_c = sum(kvpage_demotions(n, 0, n_c,
                                      core.cfg.prefill_chunk, page,
                                      kp.lane_budget, kp.decode_chain)
                     for n in KVPAGE_PROMPTS)
        row_c = dict(phase="kvpage", run="c", batch=2, wall_s=wall_c,
                     equal_alone={k: both[k]["tokens"] == alone[k]["tokens"]
                                  for k in both},
                     long=_stream_rate(both["long"]),
                     mid=_stream_rate(both["mid"]),
                     long_alone=_stream_rate(alone["long"]),
                     max_window_lanes=kp.max_window_lanes,
                     demotions=kp.demoted_blocks - d0,
                     demotions_want=want_c, peak_pages=kp.peak_resident,
                     counters={k: c2[k] - c1[k] for k in c2},
                     pagein=kp.pagein_stats(), card=smi)
        emit(row_c)
        if not all(row_c["equal_alone"].values()) or \
                kp.max_window_lanes != 2 or \
                kp.peak_resident > KVPAGE_ENGINE["kvpage_budget"] or \
                row_c["demotions"] != want_c or row_c["counters"]["faults"]:
            raise AssertionError(f"kvpage (c): batched lanes off: {row_c}")
        rows["c"] = row_c
    finally:
        eng.shutdown()
        del eng
        gc.collect()
        torch.cuda.empty_cache()

    # (e) over HTTP through the CLI: a 200 stream with paging, the typed
    # 400 without
    prompt = ("The paged lane streams the cold tail of a long context. "
              * 200)[:KVPAGE_PROMPTS[0]]
    paged_args = dict(preset=PRESET, **KVPAGE_ENGINE)
    dense_args = {k: v for k, v in paged_args.items()
                  if not k.startswith("kvpage")}
    # the card's context length must admit the prompt (the preprocessor
    # refuses longer ones before any engine sees them)
    ctx_arg = ["--context-length", str(KVPAGE_ENGINE["kvpage_max_context"])]
    http = {}
    with served(["--extra-engine-args", json.dumps(paged_args),
                 *ctx_arg]) as (_, _, port, model, _, _):
        http_post(port, "/v1/completions",
                  {"model": model, "prompt": prompt, "stream": True,
                   "max_tokens": KVPAGE_SHORT_TOKENS, "logprobs": 1},
                  http, "paged")
    with served(["--extra-engine-args", json.dumps(dense_args),
                 *ctx_arg]) as (_, _, port, model, _, _):
        try:
            http_post(port, "/v1/completions",
                      {"model": model, "prompt": prompt,
                       "max_tokens": KVPAGE_SHORT_TOKENS}, http, "dense")
        except urllib.error.HTTPError as e:
            http["dense"] = dict(status=e.code,
                                 error=json.loads(e.read())["error"])
    ph = http["paged"]
    row_e = dict(phase="kvpage", run="e", prompt_bytes=len(prompt),
                 paged=dict(status=ph["status"], done=ph["done"],
                            tokens=len(ph["tokens"]), ttft_s=ph["ttft_s"],
                            last_s=ph["last_s"], usage=ph["usage"]),
                 no_paging=http["dense"], card=smi)
    emit(row_e)
    err = http["dense"].get("error") or {}
    if ph["status"] != 200 or len(ph["tokens"]) != KVPAGE_SHORT_TOKENS or \
            http["dense"].get("status") != 400 or \
            (err.get("stage"), err.get("reason")) != (
                "engine_admission", "context_exceeded") or \
            err.get("message") != (
                f"prompt of {ph['usage']['prompt_tokens']} tokens exceeds "
                f"the configured max_context of "
                f"{KVPAGE_ENGINE['max_context']}"):
        raise AssertionError(f"kvpage (e): HTTP answers off: {row_e}")
    rows["e"] = row_e
    phase_s = time.perf_counter() - t_phase
    emit({"phase": "kvpage", "mode": "summary", "phase_s": phase_s})
    if phase_s > KVPAGE_BUDGET_S:
        raise AssertionError(f"kvpage phase took {phase_s:.1f} s, over its "
                             f"{KVPAGE_BUDGET_S} s budget")
    return dict(rows, launches=rows["a"]["launches"], phase_s=phase_s)


# ---------------------------------------------------------------------------
# phase 14: Mixtral-8x7B widths through the engine
# ---------------------------------------------------------------------------

# mistralai/Mixtral-8x7B-v0.1's config.json at its published widths; depth
# cut to 4 of 32 layers (all 32 are about 93 GB in bf16)
MIXTRAL = dict(vocab_size=32000, hidden_size=4096, num_layers=4,
               num_heads=32, num_kv_heads=8, head_dim=128,
               intermediate_size=14336, rope_theta=1e6, max_position=32768,
               rms_eps=1e-5, num_experts=8, experts_per_token=2)
MOE_ENGINE = dict(max_batch=8, max_context=2048, page_size=64,
                  prefill_chunk=512, decode_steps=8)
MOE_PROMPTS = (700, 300, 100, 20)
MOE_TOKENS = 32
MOE_TOL = 2e-2                  # sorted vs dense, relative to the output
MOE_CHAIN_LANES = 16            # B*T of a decode step at JAX's sorted cut


def moe_phase(torch, att, smi: str) -> dict:
    import asyncio
    import gc

    import numpy as np

    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.llm.protocols.common import (BackendInput,
                                                       FinishReason,
                                                       StopConditions)
    from dynamo_tpu_torch.models import llama, moe
    from dynamo_tpu_torch.runtime.engine import Context

    t_phase = time.perf_counter()
    # an earlier phase's engine may sit in reference cycles (its HTTP
    # service, loop and pipeline) that only a collection frees
    gc.collect()
    torch.cuda.empty_cache()
    mem_start = torch.cuda.memory_allocated()
    cfg = TorchEngineConfig(model=llama.LlamaConfig(**MIXTRAL),
                            device=DEVICE, **MOE_ENGINE)
    t0 = time.perf_counter()
    engine = TorchEngine(cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    c = engine.core
    m, L = cfg.model, cfg.model.num_layers
    try:
        # sorted against dense dispatch on one 512-token chunk of layer 0
        lp = c.params["layers"]
        g = torch.Generator(device=DEVICE).manual_seed(14)
        x = torch.randn((1, 512, m.hidden_size), generator=g,
                        device=DEVICE).to(m.dtype)
        with torch.no_grad():
            vals, idx = moe.route_topk(x, lp["wr"][0], m.experts_per_token)
            w = (lp["wg"][0], lp["wu"][0], lp["wd"][0])
            ys = moe._sorted_dispatch(x, *w, vals, idx).float()
            yd = moe.expert_ffn(x, *w, moe.dense_gates(
                vals, idx, m.num_experts)).float()
            rel = float((ys - yd).abs().max() / yd.abs().max())
            sorted_ms = time_ms(torch, lambda: moe._sorted_dispatch(
                x, *w, vals, idx), 5)
            dense_ms = time_ms(torch, lambda: moe.expert_ffn(
                x, *w, moe.dense_gates(vals, idx, m.num_experts)), 5)
        experts_hit = int(torch.bincount(idx.reshape(-1),
                                         minlength=m.num_experts).gt(0).sum())
        rng = np.random.default_rng(1414)
        prompts = [[int(t) for t in rng.integers(1, m.vocab_size, n)]
                   for n in MOE_PROMPTS]

        async def one(p):
            toks, ttft = [], None
            t0 = time.perf_counter()
            async for o in engine.generate(BackendInput(
                    token_ids=p, stop=StopConditions(
                        max_tokens=MOE_TOKENS, ignore_eos=True)), Context()):
                if o.finish_reason == FinishReason.ERROR:
                    raise AssertionError(f"moe request failed: {o.error}")
                ttft = ttft or time.perf_counter() - t0
                toks.extend(o.token_ids)
            return toks, ttft

        async def all4():
            return await asyncio.gather(*(one(p) for p in prompts))

        att.flash_attention.launches = 0
        att.paged_attention.launches = 0
        moe.moe_ffn.dispatches.clear()
        base = (c.prefill_dispatches, c.decode_steps_run, c.decode_seconds,
                c.prefill_seconds)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        outs = asyncio.run(all4())
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        pre_n = c.prefill_dispatches - base[0]
        steps = c.decode_steps_run - base[1]
        disp = dict(moe.moe_ffn.dispatches)
        flash_n = att.flash_attention.launches
        paged_n = att.paged_attention.launches
        # a chained decode window of MOE_CHAIN_LANES lanes: one token a
        # lane, so dense dispatch (sorted would read the expert counts on
        # the host, which sync debug "error" refuses)
        moe.moe_ffn.dispatches.clear()
        chain = chain_sync_phase(torch, c, lanes=MOE_CHAIN_LANES)
        chain_disp = dict(moe.moe_ffn.dispatches)
    finally:
        engine.shutdown()
    tokens = sum(len(t) for t, _ in outs)
    row = dict(phase="moe", model="mixtral-8x7b", layers=L,
               reduced="depth 4 of 32 layers", engine=MOE_ENGINE,
               init_s=init_s, weight_bytes=_nbytes(c.params),
               sorted_vs_dense_rel_err=rel, tol=MOE_TOL,
               experts_hit_in_chunk=experts_hit,
               chunk512_sorted_ms=sorted_ms, chunk512_dense_ms=dense_ms,
               prompts=list(MOE_PROMPTS), prefill_dispatches=pre_n,
               decode_steps=steps, moe_dispatches=disp,
               flash_launches=flash_n, paged_launches=paged_n,
               ttft_s=[t for _, t in outs], completion_tokens=tokens,
               wall_s=wall, decode_tok_s=tokens / wall,
               prefill_ms_per_dispatch=1e3 * (c.prefill_seconds - base[3])
               / max(1, pre_n),
               decode_step_ms=1e3 * (c.decode_seconds - base[2])
               / max(1, steps),
               chain_sync_error_mode=chain["sync_debug_mode"],
               chain_chained=chain["chained"], chain_lanes=chain["lanes"],
               chain_moe_dispatches=chain_disp, peak_mem_bytes=peak,
               mem_at_start_bytes=mem_start,
               phase_s=time.perf_counter() - t_phase, card=smi)
    emit(row)
    ok = (rel <= MOE_TOL and tokens == MOE_TOKENS * len(MOE_PROMPTS)
          and pre_n > 0 and steps > 0
          and flash_n == L * pre_n and paged_n == L * steps
          and disp.get("sorted") == L * pre_n
          and disp.get("dense") == L * steps and chain["chained"]
          and chain["lanes"] == MOE_CHAIN_LANES)
    if not ok:
        raise AssertionError(f"moe phase failed: {row}")
    return row


# ---------------------------------------------------------------------------
# phase 16: the fleet control plane — hot swap, planner, arbiter, profile
# ---------------------------------------------------------------------------
FPLANE_DIR = os.path.join(ROOT, "build", "dynamo_tpu_torch", "fleet_plane")
FPLANE_SEED = CKPT_SEED + 1         # model B: the checkpoint of A, seed + 1
FPLANE_PROMPT, FPLANE_PROMPT_SEED, FPLANE_TOKENS = 700, 7070, 16
FPLANE_ENGINE = dict(CKPT_ENGINE, host_cache_blocks=64)   # (a): demotions
FPLANE_GROUP = "llama3-8b-4l"       # the two models' swap_group
FPLANE_MODELS = ("ckpt-a", "ckpt-b")
FPLANE_BOOT_WAIT_S = 300            # the frontend parks a request this long
FPLANE_FULL_GROUP = 4               # (b)'s layers a copy (the default)
FPLANE_HOST_HEADROOM = 16 << 30     # host bytes (b) leaves free
FPLANE_PROFILE = dict(batches=(1, 4), seq_lens=(128, 512), gen_tokens=16)


def _mem_available() -> int:
    """The host's ``MemAvailable`` in bytes (0 when unreadable)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def _core_greedy(core, prompt, n: int, seq: str = "g") -> list:
    """``n`` greedy tokens of ``prompt`` through an idle EngineCore."""
    from dynamo_tpu_torch.llm.protocols.common import (BackendInput,
                                                       FinishReason,
                                                       StopConditions)

    core.submit(seq, BackendInput(token_ids=list(prompt),
                                  stop=StopConditions(max_tokens=n,
                                                      ignore_eos=True)))
    toks = []
    while core.has_work:
        for so in core.step():
            if so.finish == FinishReason.ERROR:
                raise AssertionError(f"request failed: {so.error}")
            toks.append(so.token)
    if len(toks) != n:
        raise AssertionError(f"greedy run gave {len(toks)} of {n} tokens")
    return toks


def _counted_greedy(att, core, prompt, n: int) -> dict:
    """A greedy run with the launch counters set to 0 just before it: its
    tokens, and whether flash ran once a layer a prefill dispatch and
    paged once a layer a decode step."""
    L = core.cfg.model.num_layers
    p0, s0 = core.prefill_dispatches, core.decode_steps_run
    _reset_launches(att)
    toks = _core_greedy(core, prompt, n)
    pre, steps = core.prefill_dispatches - p0, core.decode_steps_run - s0
    out = dict(tokens=toks, prefill_dispatches=pre, decode_steps=steps,
               flash_launches=att.flash_attention.launches,
               paged_launches=att.paged_attention.launches)
    if not (out["flash_launches"] == L * pre > 0
            and out["paged_launches"] == L * steps > 0):
        raise AssertionError(f"launches do not account for the run: {out}")
    return out


def _built_libraries() -> dict:
    """Every shared library the port has built (kernels and native
    helpers): {path: mtime}."""
    root = os.path.join(ROOT, "build", "dynamo_tpu_torch")
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".so"):
                p = os.path.join(d, f)
                out[p] = os.path.getmtime(p)
    return out


def write_sibling(torch, src: str, dst: str, seed: int) -> dict:
    """Model B: the directory ``src`` (config, tokenizer) with weights of
    the same shapes drawn from ``seed``, written as the checkpoint phase
    writes A."""
    import shutil

    from dynamo_tpu_torch.engine import loader
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.models import llama

    shutil.rmtree(dst, ignore_errors=True)
    os.makedirs(dst)
    for f in os.listdir(src):
        if not f.endswith(".safetensors"):
            shutil.copy(os.path.join(src, f), dst)
    cfg = llama.LlamaConfig.from_hf_config(
        ModelDeploymentCard.resolve(src).model_config)
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    dev_tree = llama.init_params(cfg, gen, torch.device(DEVICE))
    host = {k: (v.to("cpu") if k != "layers" else
                {n: x.to("cpu") for n, x in v.items()})
            for k, v in dev_tree.items()}
    del dev_tree
    torch.cuda.empty_cache()
    loader.save_llama_params(dst, host, cfg, shards=2, dtype=None)
    return dict(write_s=time.perf_counter() - t0, weight_bytes=_nbytes(host))


def swap_contract(torch, att, dir_a: str, dir_b: str, prompt) -> dict:
    """(a) The hot-swap contract in process at Llama-3-8B width, 4 layers:
    every typed refusal, then A -> B one layer a copy; B's greedy tokens
    equal a cold engine of B bit for bit and differ from A's, every param
    tensor keeps its storage, no library is built, the device's peak
    memory rises by at most one layer group, and the kernels account for
    the run after the swap."""
    from dynamo_tpu_torch.engine.engine import EngineCore, TorchEngineConfig
    from dynamo_tpu_torch.fleet.mobility import (SwapError, WeightCache,
                                                 hot_swap)
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.protocols.common import (BackendInput,
                                                       StopConditions)

    def cfg_of(path, **kw):
        return TorchEngineConfig.from_card(
            ModelDeploymentCard.resolve(path),
            **dict(FPLANE_ENGINE, **kw), device=DEVICE)

    cfg_a, cfg_b = cfg_of(dir_a), cfg_of(dir_b)
    cold = EngineCore(cfg_b)
    want_b = _core_greedy(cold, prompt, FPLANE_TOKENS)
    cold.close()
    cold.release_device()
    del cold
    core = EngineCore(cfg_a)
    want_a = _core_greedy(core, prompt, FPLANE_TOKENS)
    if want_a == want_b:
        raise AssertionError("models A and B stream the same tokens")
    # the worker's own path to B's host tree: load, then page-lock
    on_card = DEVICE == "cuda"
    cache = WeightCache(pinned=on_card)
    t0 = time.perf_counter()
    host_b = cache.load_now(dir_b, cfg_b.model)
    load_s = time.perf_counter() - t0
    if host_b is None or not all(
            v.is_pinned() == on_card for v in [host_b["embed"],
                                               *host_b["layers"].values()]):
        raise AssertionError("B's host tree is not page-locked")

    refusals = {}
    core.submit("busy", BackendInput(token_ids=list(prompt[:64]),
                                     stop=StopConditions(max_tokens=64)))
    core.step()
    for name, host, cfg in (
            ("busy", host_b, cfg_b),
            ("geometry", host_b, cfg_of(
                dir_b, max_batch=2 * FPLANE_ENGINE["max_batch"])),
            ("no_lm_head", {k: v for k, v in host_b.items()
                            if k != "lm_head"}, cfg_b)):
        if name == "geometry":
            core.cancel("busy")
            while core.has_work:
                core.step()
        try:
            hot_swap(core, host, cfg)
        except SwapError as e:
            refusals[name] = e.reason
        else:
            raise AssertionError(f"the {name} swap was not refused")
    if refusals != {"busy": "not_drained", "geometry": "shape_mismatch",
                    "no_lm_head": "shape_mismatch"}:
        raise AssertionError(f"refusals: {refusals}")

    leaves = dict(core.params["layers"])
    leaves.update({k: v for k, v in core.params.items() if k != "layers"})
    ptrs = {k: v.data_ptr() for k, v in leaves.items()}
    libs = _built_libraries()
    group_bytes = sum(v[0].numel() * v.element_size()
                      for v in core.params["layers"].values())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = hot_swap(core, host_b, cfg_b, group_layers=1)
    rise = torch.cuda.max_memory_allocated() - base
    moved = [k for k, v in leaves.items() if v.data_ptr() != ptrs[k]]
    after = _counted_greedy(att, core, prompt, FPLANE_TOKENS)
    row = dict(swap_s=out.seconds, slab_bytes=out.slab_bytes,
               slab_s=out.slab_seconds,
               slab_gb_s=out.slab_bytes / out.slab_seconds / 1e9,
               groups=out.groups, demoted_blocks=out.demoted_blocks,
               host_load_s=load_s, refusals=refusals,
               tokens_equal_cold_b=after["tokens"] == want_b,
               tokens_differ_from_a=after["tokens"] != want_a,
               tensors_moved=moved, libraries_built=sorted(
                   set(_built_libraries()) - set(libs)),
               peak_rise_bytes=rise, layer_group_bytes=group_bytes,
               weight_bytes=_nbytes(core.params),
               **{k: after[k] for k in after if k != "tokens"})
    L = cfg_a.model.num_layers
    if not (row["tokens_equal_cold_b"] and row["tokens_differ_from_a"]
            and not moved and not row["libraries_built"]
            and _built_libraries() == libs and rise <= group_bytes
            and out.groups == L * len(core.params["layers"])
            and out.demoted_blocks > 0):
        raise AssertionError(f"hot-swap contract: {row}")
    core.close()
    core.release_device()
    cache.close()
    return dict(row, want_a=want_a, want_b=want_b)


def _drawn_host_tree(torch, tree, seed: int, rows: int):
    """Model B of (b): for each leaf of ``tree``, a page-locked host leaf
    drawn from ``seed`` as ``llama.init_params`` draws (ones for the
    pre-norms, else normal over the leaf's leading dim, cast to the leaf's
    dtype), ``rows`` leading rows (layers) at a time on the card, so no
    f32 copy of a whole leaf, let alone the tree, exists at once."""
    import math

    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def draw(name, leaf):
        h = torch.empty(leaf.shape, dtype=leaf.dtype,
                        pin_memory=DEVICE == "cuda")
        if name in ("ln1", "ln2", "final_norm"):
            h.fill_(1.0)
            return h
        step = rows if leaf.dim() > 2 else max(1, (1 << 28) // max(
            1, leaf[0].numel()))
        for s in range(0, leaf.shape[0], step):
            n = min(step, leaf.shape[0] - s)
            t = torch.randn((n, *leaf.shape[1:]), generator=gen,
                            dtype=torch.float32, device=DEVICE)
            h[s:s + n].copy_(t.mul_(1.0 / math.sqrt(leaf.shape[0]))
                             .to(leaf.dtype))
        return h

    out = {k: draw(k, v) for k, v in tree.items() if k != "layers"}
    out["layers"] = {k: draw(k, v) for k, v in tree["layers"].items()}
    return out


def swap_full_depth(torch, att, params, cold_tokens: list) -> dict:
    """(b) A -> B -> A on an engine holding the serve phase's Llama-3-8B
    weights (32 layers): A's host copy taken from the card, B drawn on the
    host side one layer group at a time; after the return every leaf
    equals the saved copy and the greedy stream equals the serve phase's
    cold stream. Cut to fewer layers, on weights of its own, when the
    host cannot hold two page-locked copies."""
    import dataclasses

    from dynamo_tpu_torch.engine.engine import EngineCore, TorchEngineConfig
    from dynamo_tpu_torch.fleet.mobility import hot_swap
    from dynamo_tpu_torch.fleet.mobility.weightcache import pin_tree
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.models import llama

    cfg = TorchEngineConfig.from_card(ModelDeploymentCard.synthetic(PRESET),
                                      **ENGINE_ARGS, device=DEVICE)
    weight_bytes = _nbytes(params)
    avail = _mem_available()
    cut = None
    if avail < 2 * weight_bytes + FPLANE_HOST_HEADROOM:
        L = cfg.model.num_layers
        per_layer = sum(v[0].numel() * v.element_size()
                        for v in params["layers"].values())
        fixed = weight_bytes - L * per_layer
        keep = int((avail - FPLANE_HOST_HEADROOM) / 2 - fixed) // per_layer
        keep = max(1, min(L - 1, keep))
        cut = dict(layers=keep, of=L, reason=(
            f"MemAvailable {avail} B < two page-locked copies of "
            f"{weight_bytes} B + {FPLANE_HOST_HEADROOM} B headroom"))
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, num_layers=keep))
        gen = torch.Generator(device=DEVICE).manual_seed(CKPT_SEED)
        params = llama.init_params(cfg.model, gen, torch.device(DEVICE))
    core = EngineCore(cfg, params)
    prompt = reuse_prompt(cfg.model.vocab_size)
    t0 = time.perf_counter()
    host_a = pin_tree(core.params)
    copy_a_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_b = _drawn_host_tree(torch, core.params, FPLANE_SEED,
                              FPLANE_FULL_GROUP)
    draw_b_s = time.perf_counter() - t0
    swaps = {}
    for name, host in (("a_to_b", host_b), ("b_to_a", host_a)):
        out = hot_swap(core, host, cfg, group_layers=FPLANE_FULL_GROUP)
        swaps[name] = dict(seconds=out.seconds, slab_bytes=out.slab_bytes,
                           slab_s=out.slab_seconds,
                           slab_gb_s=out.slab_bytes / out.slab_seconds / 1e9,
                           groups=out.groups,
                           demoted_blocks=out.demoted_blocks)
        if name == "a_to_b":
            b_tokens = _core_greedy(core, prompt, REUSE_TOKENS)
    leaves = {("layers", k): v for k, v in core.params["layers"].items()}
    leaves.update({(k,): v for k, v in core.params.items()
                   if k != "layers"})
    unequal = [k for k, v in leaves.items() if not torch.equal(
        v, (host_a[k[0]] if len(k) == 1 else host_a["layers"][k[1]])
        .to(DEVICE))]
    run = _counted_greedy(att, core, prompt, REUSE_TOKENS)
    row = dict(layers=cfg.model.num_layers, cut=cut, mem_available=avail,
               weight_bytes=_nbytes(core.params), host_copy_a_s=copy_a_s,
               host_draw_b_s=draw_b_s, swaps=swaps,
               leaves_unequal_after_return=unequal,
               b_differs=b_tokens != run["tokens"],
               stream_equals_serve=(run["tokens"] == cold_tokens
                                    if cut is None else None),
               **{k: run[k] for k in run if k != "tokens"})
    core.close()
    core.release_device()
    del host_a, host_b
    if unequal or not row["b_differs"] or (
            cut is None and not row["stream_equals_serve"]):
        raise AssertionError(f"full-depth swap: {row}")
    return row


def profile_sweep(torch, att, dir_a: str) -> dict:
    """(d) ``run_profile(engine="torch")`` on model A on the card: a
    ``ProfileTable`` the SLA policy loads, the kernels launched in it."""
    from dynamo_tpu_torch.planner.policy import SlaPolicy
    from dynamo_tpu_torch.planner.profile import ProfileTable, run_profile

    _reset_launches(att)
    t0 = time.perf_counter()
    table = run_profile("torch", FPLANE_PROFILE["batches"],
                        FPLANE_PROFILE["seq_lens"],
                        gen_tokens=FPLANE_PROFILE["gen_tokens"],
                        model_path=dir_a, device=DEVICE)
    sweep_s = time.perf_counter() - t0
    path = os.path.join(FPLANE_DIR, "profile.json")
    table.save(path)
    pol = SlaPolicy(ProfileTable.load(path), ttft_target=2.0,
                    itl_target=0.05)
    row = dict(table=table.to_dict(), sweep_s=sweep_s,
               sla_capacity_2s_50ms=pol.capacity,
               flash_launches=att.flash_attention.launches,
               paged_launches=att.paged_attention.launches)
    if table.meta.get("platform") != DEVICE or len(table.points) != 4 \
            or not (row["flash_launches"] > 0 and row["paged_launches"] > 0):
        raise AssertionError(f"profile sweep: {row}")
    return row


async def _fplane_store(store_port: int, fn):
    from dynamo_tpu_torch.runtime.scale.shards import make_store_client

    sc = await make_store_client("127.0.0.1", store_port).connect()
    try:
        return await fn(sc)
    finally:
        await sc.close()


def _fplane_request(port: int, model: str, prompt) -> dict:
    res: dict = {}
    http_post(port, "/v1/completions", {
        "model": model, "prompt": list(prompt), "max_tokens": FPLANE_TOKENS,
        "temperature": 0.0, "stream": True, "logprobs": 1,
        "ignore_eos": True}, res, "r")
    r = res["r"]
    if r["status"] != 200 or r["usage"]["completion_tokens"] != FPLANE_TOKENS:
        raise AssertionError(f"{model} request: {r}")
    return r


def swap_across_processes(torch, dir_a: str, dir_b: str, prompt,
                          want_a: list, want_b: list, b_bytes: int) -> dict:
    """(c) The planner hands the card from A to B by an in-place swap:
    the native store, ``cli.planner --fleet --connector local --platform
    cuda --total-chips 1``, ``cli.router --fleet`` and the discovery
    frontend, A and B registered in one swap group (B of higher priority,
    so the arbiter preempts A for it). A request for A parks until the
    planner spawns A's worker on card 0; a request for B parks until the
    arbiter hands that card to B: the same worker swaps its weights in
    place and re-registers as B."""
    import asyncio
    import re
    import signal

    from dynamo_tpu_torch.fleet.mobility import mobility_wake_key
    from dynamo_tpu_torch.fleet.registry import (FleetModelSpec,
                                                 fetch_fleet_status,
                                                 put_fleet_model)
    from dynamo_tpu_torch.llm.tokenizer import load_tokenizer

    torch.cuda.empty_cache()
    tok = load_tokenizer(dir_a)
    strings = {m: [tok.decode([t]) for t in w]
               for m, w in zip(FPLANE_MODELS, (want_a, want_b))}
    a, b = FPLANE_MODELS
    page = CKPT_ENGINE["page_size"]
    fleet = Fleet(FPLANE_DIR)
    # the planner's spawned workers log under this phase's directory
    fleet.env["TMPDIR"] = FPLANE_DIR
    pid = None
    try:
        fleet.start("store", "dynamo_tpu_torch.runtime.store_server",
                    "--host", "127.0.0.1", "--port", "0")
        line = fleet.wait_line("store", r"listening on \S+:\d+", 60)
        store_port = int(line.rsplit(":", 1)[1])
        store = f"127.0.0.1:{store_port}"
        extra = ["--kv-block-size", str(page), "--metrics-interval", "0.25",
                 "--extra-engine-args", json.dumps(CKPT_ENGINE)]
        specs = [FleetModelSpec(name=m, engine="torch", model_path=p,
                                chips_per_replica=1, min_replicas=0,
                                max_replicas=1, priority=prio,
                                swap_group=FPLANE_GROUP, extra_args=extra)
                 for m, p, prio in ((a, dir_a, 0), (b, dir_b, 1))]

        async def register(sc):
            for s in specs:
                await put_fleet_model(sc, "dynamo", s)
        asyncio.run(_fplane_store(store_port, register))
        fleet.start("planner", "dynamo_tpu_torch.cli.planner", "--store",
                    store, "--namespace", "dynamo", "--fleet",
                    "--connector", "local", "--platform", DEVICE,
                    "--total-chips", "1", "--interval", "0.5",
                    "--cooldown-up", "0")
        fleet.wait_line("planner", r"planner serving", 120)
        fleet.start("router", "dynamo_tpu_torch.cli.router", "--store",
                    store, "--fleet", "--block-size", str(page))
        fleet.wait_line("router", r"kv router serving", 120)
        fleet.env["DYN_BOOT_WAIT"] = str(FPLANE_BOOT_WAIT_S)
        fleet.start("http", "dynamo_tpu_torch.cli.http", "--store", store,
                    "--host", "127.0.0.1", "--port", "0",
                    "--router-component", "router", "--namespace",
                    "dynamo")
        line = fleet.wait_line("http", r"http frontend on :\d+", 120)
        http_port = int(re.search(r":(\d+)", line).group(1))

        def models():
            return {r["id"]: r.get("state") for r in json.loads(
                http_get(http_port, "/v1/models")[1])["data"]}

        def status():
            st = asyncio.run(_fplane_store(
                store_port, lambda sc: fetch_fleet_status(sc, "dynamo")))
            return {m: {k: v for k, v in s.items() if k != "ts"}
                    for m, s in st.items()}

        models0 = models()
        status0 = status()
        # A scales from zero: the parked request is its wake signal
        ra = _fplane_request(http_port, a, prompt)
        spawn = re.findall(r"planner spawned (\S+) worker pid=(\d+) "
                           r"\(log ([^)]+)\)", fleet.log("planner"))
        if len(spawn) != 1 or spawn[0][0] != a:
            raise AssertionError(f"planner spawns: {spawn}")
        pid, wlog = int(spawn[0][1]), spawn[0][2]
        with open(f"/proc/{pid}/environ", "rb") as f:
            wenv = dict(kv.split(b"=", 1) for kv in f.read().split(b"\0")
                        if b"=" in kv)
        visible = wenv.get(b"CUDA_VISIBLE_DEVICES", b"").decode()
        warm_a = _fplane_request(http_port, a, prompt)
        # the plane's prefetch hint stages B's weights in the worker's
        # host cache (its stage dump's dyn_weight_cache_bytes)
        t0 = time.monotonic()
        while _total(scrape(http_port), "dyn_weight_cache_bytes") \
                < b_bytes:
            if time.monotonic() - t0 > 120:
                raise AssertionError("worker never staged B's weights")
            time.sleep(0.25)
        staged_s = time.monotonic() - t0
        status_mid = status()
        # B parks; the arbiter hands A's card to B by a swap
        t_b = time.perf_counter()
        rb = _fplane_request(http_port, b, prompt)
        b_total_s = time.perf_counter() - t_b
        wake = json.loads(asyncio.run(_fplane_store(
            store_port, lambda sc: sc.get(mobility_wake_key("dynamo", b)))))
        wid = wake["worker"]
        time.sleep(1.0)
        s0 = scrape(http_port)
        rb2 = _fplane_request(http_port, b, prompt[::-1])
        time.sleep(1.5)
        s1 = scrape(http_port)
        comp = f"backend-{b}"
        d = _delta(_counts(_component(s0, comp), wid),
                   _counts(_component(s1, comp), wid))
        L = CKPT_HF["num_hidden_layers"]
        spawns = re.findall(r"planner spawned", fleet.log("planner"))
        wtext = open(wlog).read()
        row = dict(
            worker_pid=pid, worker_pid_alive_after=os.path.exists(
                f"/proc/{pid}"), worker_cuda_visible_devices=visible,
            spawns=len(spawns),
            reregistered=f"re-registered as {b}" in wtext,
            swaps_swap=_total(s1, "dyn_model_swaps_total", outcome="swap"),
            swaps_reload=_total(s1, "dyn_model_swaps_total",
                                outcome="reload"),
            wake=wake, wake_s=wake["seconds"],
            a_scale_from_zero_ttft_s=ra["ttft_s"],
            a_warm_ttft_s=warm_a["ttft_s"], b_staged_after_s=staged_s,
            b_parked_ttft_s=rb["ttft_s"], b_parked_total_s=b_total_s,
            b_warm_ttft_s=rb2["ttft_s"],
            a_tokens_equal_cold_a=ra["tokens"] == strings[a],
            b_tokens_equal_cold_b=rb["tokens"] == strings[b],
            b_launches_after_swap=d, models_before=models0,
            models_after=models(), status_before=status0,
            status_mid=status_mid, status_after=status(),
            planes=dict(fleet.planes(serving=("router",)), worker=(
                re.findall(r"data plane: (\w+) on port", wtext) or [None]
            )[-1]),
            loop_wedges_s=fleet.wedges(),
            flash_launches=d.get("flash", 0.0),
            paged_launches=d.get("paged", 0.0))
        # a SIGTERM to the planner drains the worker it spawned
        planner = fleet.procs["planner"][0]
        planner.terminate()
        planner.wait(timeout=60)
        t0 = time.monotonic()
        while os.path.exists(f"/proc/{pid}") and \
                time.monotonic() - t0 < 30:
            time.sleep(0.1)
        row["worker_drained_with_planner"] = not os.path.exists(
            f"/proc/{pid}")
        row["planner_rc"] = planner.returncode
        on_card = DEVICE == "cuda"
        if not (row["worker_pid_alive_after"] and row["spawns"] == 1
                and row["worker_drained_with_planner"]
                and row["planner_rc"] == 0
                and visible == ("0" if on_card else "")
                and row["reregistered"]
                and row["planes"]["worker"] == "native"
                and row["swaps_swap"] == 1 and row["swaps_reload"] == 0
                and wake["path"] == "swap"
                and row["a_tokens_equal_cold_a"]
                and row["b_tokens_equal_cold_b"]
                and d["prefill"] > 0 and d["decode_step"] > 0
                and d["flash"] == L * d["prefill"] * on_card
                and d["paged"] == L * d["decode_step"] * on_card
                and {a, b} <= set(row["models_after"])
                and all(row["models_after"][m] for m in (a, b))):
            raise AssertionError(f"the card handed from A to B: {row}")
        return row
    finally:
        fleet.stop()
        if pid is not None and os.path.exists(f"/proc/{pid}"):
            # a planner that failed before its drain leaves its worker
            os.kill(pid, signal.SIGTERM)
            for _ in range(200):
                if not os.path.exists(f"/proc/{pid}"):
                    break
                time.sleep(0.1)
            else:
                os.kill(pid, signal.SIGKILL)


def fleet_plane_phase(torch, att, smi: str, params, serve: dict) -> dict:
    """Phase 16: (b) on the served weights first, then (a), (d) and (c)
    on the checkpoint phase's 4-layer directory and its sibling."""
    t_phase = time.perf_counter()
    os.makedirs(FPLANE_DIR, exist_ok=True)
    full = swap_full_depth(torch, att, params,
                           serve["reuse"]["cold_tokens"])
    emit({"phase": "fleet_plane", "part": "b_full_depth", "card": smi,
          **full})
    dir_a = os.path.join(CKPT_DIR, "llama3-8b-4l")
    dir_b = os.path.join(CKPT_DIR, "llama3-8b-4l-b")
    sib = write_sibling(torch, dir_a, dir_b, FPLANE_SEED)
    import numpy as np

    prompt = np.random.default_rng(FPLANE_PROMPT_SEED).integers(
        0, CKPT_HF["vocab_size"] - CKPT_SPECIALS, FPLANE_PROMPT).tolist()
    contract = swap_contract(torch, att, dir_a, dir_b, prompt)
    want_a, want_b = contract.pop("want_a"), contract.pop("want_b")
    emit({"phase": "fleet_plane", "part": "a_contract", "card": smi,
          "sibling": sib, **contract})
    prof = profile_sweep(torch, att, dir_a)
    emit({"phase": "fleet_plane", "part": "d_profile", "card": smi, **prof})
    import gc

    gc.collect()        # the profile's engines, before the worker's load
    torch.cuda.empty_cache()
    cross = swap_across_processes(torch, dir_a, dir_b, prompt, want_a,
                                  want_b, sib["weight_bytes"])
    emit({"phase": "fleet_plane", "part": "c_across_processes",
          "card": smi, **cross})
    row = dict(phase="fleet_plane", mode="summary", card=smi,
               phase_s=time.perf_counter() - t_phase,
               flash_launches=sum(r["flash_launches"] for r in (
                   full, contract, prof, cross)),
               paged_launches=sum(r["paged_launches"] for r in (
                   full, contract, prof, cross)))
    emit(row)
    return row


# ---------------------------------------------------------------------------
# phase 17: a serving graph through cli.serve, and the operator tools
# ---------------------------------------------------------------------------

GRAPH_DIR = os.path.join(ROOT, "build", "dynamo_tpu_torch", "graph")
GRAPH_ENTRY = "dynamo_tpu_torch.examples.llm_graphs:AggRouterGraph"
GRAPH_START_S = 300           # cli.serve's bring-up: the 8B worker's build
GRAPH_STOP_S = 90             # LocalServe's 60 s grace, the store's 10 s
GRAPH_METRICS_S = 0.25        # the worker's metrics interval
GRAPH_SEED = 1717
GRAPH_PREFIX_TOKENS = 256     # each prime's full pages (4 of 64 tokens)
GRAPH_PRIMES = 4
GRAPH_BURST = 8
GRAPH_BURSTS = 2
GRAPH_BURST_TOKENS = 32
GRAPH_LONG_TOKENS = 1536      # the request dyntop sees in flight
GRAPH_MEM_SLACK = 256 << 20   # card bytes the stopped graph may leave
PYTOK_REVERSE = ("async def generate(request, context):\n"
                 "    for t in reversed(request.token_ids):\n"
                 "        yield t\n")


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _tool(*argv: str, timeout: float = 120) -> str:
    """One operator CLI of the port (``python -m``), its stdout; fails on
    a non-zero exit."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-m", *argv], capture_output=True,
                       text=True, timeout=timeout, cwd=ROOT, env=env)
    if r.returncode != 0:
        raise AssertionError(f"{argv[0]} exited {r.returncode}:\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
    return r.stdout


def _children(pid: int) -> dict:
    """{pid: executable name} of ``pid``'s child processes (from /proc)."""
    out = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            if ppid == pid:
                out[int(d)] = os.path.basename(os.readlink(f"/proc/{d}/exe"))
        except (OSError, ValueError, IndexError):
            continue
    return out


def _graph_yaml(http: int) -> str:
    """The graph's config, in the YAML subset ``cli.serve`` reads."""
    page = ENGINE_ARGS["page_size"]
    return "\n".join([
        "# the KV-routed graph of the smoke's graph phase",
        "Frontend:", "  host: 127.0.0.1", f"  port: {http}",
        "  router_component: router",
        "Router:", "  worker_component: backend", f"  block_size: {page}",
        "Worker:", "  engine: torch", "  register_model: true",
        f"  model_name: {PRESET}", f"  kv_block_size: {page}",
        f"  metrics_interval: {GRAPH_METRICS_S}",
        f"  extra_engine_args: '{json.dumps(ENGINE_ARGS)}'", ""])


def _stream_held(port: int, body: dict, first: threading.Event,
                 done: threading.Event, results: dict, key: str) -> None:
    """A streamed completion that sets ``first`` at its first chunk and
    hangs up once ``done`` is set (the frontend then stops it)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps(dict(body, stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    n = 0
    with urllib.request.urlopen(req, timeout=600) as resp:
        results[key] = dict(status=resp.status)
        for raw in resp:
            if raw.startswith(b"data:") and b"[DONE]" not in raw:
                n += 1
                first.set()
            if done.is_set():
                break
    results[key]["chunks"] = n


async def _post(http: int, body: dict) -> dict:
    import asyncio

    res: dict = {}
    await asyncio.to_thread(http_post, http, "/v1/completions", body,
                            res, "r")
    return res["r"]


async def _graph_greedy(store_port: int, http: int, serve_lone: dict,
                        what: str = "the graph") -> dict:
    """The serve phase's cold greedy stream through a KV-routed graph's
    frontend, after one warm-up request (the worker's first dispatch), as
    in the fleet; and its token ids through the router and the worker's
    data plane. Fails unless all equal the in-process server's."""
    import asyncio

    from dynamo_tpu_torch.llm.remote import RemoteCoreEngine
    from dynamo_tpu_torch.runtime.component import DistributedRuntime

    t0 = time.perf_counter()
    warm = await _post(http, {"model": PRESET, "prompt": "warm up",
                              "max_tokens": 4})
    warm_s = time.perf_counter() - t0
    if warm["status"] != 200:
        raise AssertionError(f"the warm-up request failed: {warm}")
    lone = await asyncio.to_thread(lone_stream, http)
    # the token ids too (the byte tokenizer drops ids from 256 up): one
    # seeded greedy request through the router and the worker's data plane
    gdrt = await DistributedRuntime(store_port=store_port).connect()
    try:
        workers = await gdrt.namespace("dynamo").component("backend") \
            .endpoint("generate").client().start()
        router = await gdrt.namespace("dynamo").component("router") \
            .endpoint("route").client().start()
        await workers.wait_for_instances(1, timeout=60)
        await router.wait_for_instances(1, timeout=60)
        lone["greedy_ids"] = await greedy_ids(
            RemoteCoreEngine(workers, router, model_name=PRESET))
    finally:
        await gdrt.close()
    for key in ("text", "tokens", "greedy_ids"):
        if lone[key] != serve_lone[key]:
            raise AssertionError(f"{what} streamed {key} {lone[key]!r}, "
                                 f"the in-process server "
                                 f"{serve_lone[key]!r}")
    return dict(warm_up_s=warm_s, lone_stream=dict(
        ttft_s=lone["ttft_s"], itl_ms=lone["itl_ms"], chunks=lone["chunks"]))


async def _graph_requests(store_port: int, http: int, wid: int,
                          serve_lone: dict) -> dict:
    """(b), (c) and (d) against the live graph."""
    import asyncio

    import numpy as np

    from dynamo_tpu_torch.llm.kv_router.indexer import KvIndexer
    from dynamo_tpu_torch.llm.kv_router.protocols import RouterEvent
    from dynamo_tpu_torch.llm.recorder import KvRecorder
    from dynamo_tpu_torch.runtime.component import DistributedRuntime

    page = ENGINE_ARGS["page_size"]
    store = f"127.0.0.1:{store_port}"

    async def post(body):
        return await _post(http, body)

    async def decisions():
        st, raw = await asyncio.to_thread(http_get, http,
                                          "/v1/router/decisions")
        if st != 200:
            raise AssertionError(f"/v1/router/decisions answered {st}")
        d = json.loads(raw)
        return d.get("decisions", d)

    # (b) the serve phase's cold greedy stream, through the graph
    row = await _graph_greedy(store_port, http, serve_lone)

    # (d) a KvRecorder on the worker component from here on
    rec_path = os.path.join(GRAPH_DIR, "kv_events.jsonl")
    if os.path.exists(rec_path):
        os.remove(rec_path)
    drt = await DistributedRuntime(store_port=store_port).connect()
    try:
        rec = await KvRecorder(rec_path).attach(
            drt.namespace("dynamo").component("backend"))
        seq0 = max([d["seq"] for d in await decisions()] or [0])
        rng = np.random.default_rng(GRAPH_SEED)
        primes = [rng.integers(32, 127, GRAPH_PREFIX_TOKENS + k + 1).tolist()
                  for k in range(GRAPH_PRIMES)]
        prompts = {len(p): p for p in primes}
        for p in primes:                     # one at a time, events landed
            r = await post({"model": PRESET, "prompt": p, "max_tokens": 4,
                            "temperature": 0.0})
            if r["status"] != 200:
                raise AssertionError(f"prime failed: {r}")
            t0 = time.monotonic()
            while True:
                rec.flush()
                idx = KvIndexer(page)
                KvRecorder(rec_path).replay_into_indexer(idx)
                if idx.find_matches_for_tokens(p).scores.get(wid, 0) \
                        >= GRAPH_PREFIX_TOKENS // page:
                    break
                if time.monotonic() - t0 > 30:
                    raise AssertionError("a prime's KV events did not "
                                         "arrive")
                await asyncio.sleep(0.05)
        await asyncio.sleep(0.5)             # the router has them too
        # (b) two bursts: every prompt a prime's pages and a suffix of a
        # length of its own (the first is the worker's first 8-lane
        # prefill)
        row["bursts"] = []
        for b in range(GRAPH_BURSTS):
            burst = {}
            for i in range(GRAPH_BURST):
                p = (primes[i % GRAPH_PRIMES][:GRAPH_PREFIX_TOKENS]
                     + rng.integers(32, 127, 10 + b + 5 * i).tolist())
                prompts[len(p)] = p
                # logprobs: a chunk a token (random weights' ids mostly
                # decode to no text), so the first chunk times the first
                # token
                burst[f"b{i}"] = ("/v1/completions", {
                    "model": PRESET, "prompt": p, "stream": True,
                    "max_tokens": GRAPH_BURST_TOKENS, "ignore_eos": True,
                    "temperature": 0.0, "logprobs": 1})
            results: dict = {}
            t0 = time.perf_counter()
            threads = [threading.Thread(target=http_post, args=(
                http, path, body, results, key))
                for key, (path, body) in burst.items()]
            for th in threads:
                th.start()
            for th in threads:
                await asyncio.to_thread(th.join, 600)
            wall = time.perf_counter() - t0
            for key in burst:
                r = results.get(key)
                if r is None or r["status"] != 200 or not r.get("done") \
                        or r["usage"]["completion_tokens"] \
                        != GRAPH_BURST_TOKENS:
                    raise AssertionError(f"burst {b} request {key} failed: "
                                         f"{r}")
            tokens = sum(r["usage"]["completion_tokens"]
                         for r in results.values())
            ttfts = sorted(r["ttft_s"] for r in results.values())
            row["bursts"].append(dict(
                requests=GRAPH_BURST, wall_s=wall, completion_tokens=tokens,
                tok_s=tokens / wall, ttft_s_min=ttfts[0],
                ttft_s_median=ttfts[len(ttfts) // 2], ttft_s_max=ttfts[-1],
                first_rid=results["b0"]["rid"]))
        await asyncio.sleep(0.5)
        rec.close()
    finally:
        await drt.close()

    # (d) replayed: each decision's overlap from the events recorded
    # before it, and the whole capture through replay_into_indexer
    events = []
    with open(rec_path) as f:
        for line in f:
            d = json.loads(line)
            events.append((d["ts"], d["event"]["payload"]))
    live = [d for d in await decisions() if d["seq"] > seq0]
    if len(live) != GRAPH_PRIMES + GRAPH_BURSTS * GRAPH_BURST:
        raise AssertionError(f"{len(live)} decisions for "
                             f"{GRAPH_PRIMES + GRAPH_BURSTS * GRAPH_BURST} "
                             f"requests")
    compared = []
    for d in live:
        toks = prompts[d["isl_tokens"]]
        idx = KvIndexer(page)
        for ts, payload in events:
            if ts <= d["at"]:
                idx.apply_sync(RouterEvent.from_dict(payload))
        got = idx.find_matches_for_tokens(toks).scores.get(d["worker_id"], 0)
        compared.append((d["isl_tokens"], d["overlap_blocks"], got))
        if got != d["overlap_blocks"]:
            raise AssertionError(f"replayed overlap {got} for the "
                                 f"{d['isl_tokens']}-token prompt, the live "
                                 f"router's {d['overlap_blocks']}: "
                                 f"{compared}")
    full = KvIndexer(page)
    applied = KvRecorder(rec_path).replay_into_indexer(full)
    prime_blocks = [full.find_matches_for_tokens(p).scores.get(wid, 0)
                    for p in primes]
    if applied != len(events) or prime_blocks != [
            GRAPH_PREFIX_TOKENS // page] * GRAPH_PRIMES:
        raise AssertionError(f"replay_into_indexer: {applied} of "
                             f"{len(events)} events, primes {prime_blocks}")
    row["replay"] = dict(events=len(events), decisions=len(live),
                         overlaps=[c[1] for c in compared],
                         prime_blocks=prime_blocks)

    # (c) the operator tools against the live graph: dyntop while a long
    # request holds a slot
    first, done, held = threading.Event(), threading.Event(), {}
    long_req = threading.Thread(target=_stream_held, args=(
        http, {"model": PRESET, "prompt": primes[0], "ignore_eos": True,
               "max_tokens": GRAPH_LONG_TOKENS, "temperature": 0.0,
               "logprobs": 1},
        first, done, held, "long"))
    long_req.start()
    try:
        if not await asyncio.to_thread(first.wait, 120):
            raise AssertionError("the long request streamed nothing")
        t0 = time.monotonic()
        calls = 0
        while True:
            calls += 1
            top = await asyncio.to_thread(
                _tool, "dynamo_tpu_torch.cli.dyntop", "--store", store,
                "--once", "--plain")
            rows = [line.split() for line in top.splitlines()
                    if line.split()[:1] == [f"{wid:x}"]]
            if rows and int(rows[0][2].split("/")[0]) >= 1 \
                    and float(rows[0][3]) > 0:
                seen_s = time.monotonic() - t0
                break
            if time.monotonic() - t0 > 60 or not long_req.is_alive():
                raise AssertionError(f"dyntop never showed worker {wid:x} "
                                     f"with slots and KV in use:\n{top}")
            await asyncio.sleep(GRAPH_METRICS_S)
    finally:
        done.set()
        await asyncio.to_thread(long_req.join, 600)
    if held.get("long", {}).get("status") != 200:
        raise AssertionError(f"the long request failed: {held}")
    row["dyntop"] = dict(seen_s=seen_s, calls=calls,
                         long_chunks=held["long"]["chunks"],
                         text=top.splitlines())
    emit({"phase": "graph", "part": "b_d_requests", **row})
    listed = await asyncio.to_thread(_tool, "dynamo_tpu_torch.cli.ctl",
                                     "--store", store, "http", "list")
    if PRESET not in listed:
        raise AssertionError(f"ctl http list does not name {PRESET}:\n"
                             f"{listed}")
    row["ctl_http_list"] = listed.strip().splitlines()
    rid = row["bursts"][0]["first_rid"]
    t0 = time.monotonic()
    while True:
        out = await asyncio.to_thread(
            _tool, "dynamo_tpu_torch.cli.tracectl", rid, "--url",
            f"http://127.0.0.1:{http}", "--json")
        spans = json.loads(out).get("spans", [])
        pids = {s["pid"] for s in spans}
        comps = {s["component"] for s in spans}
        if len(pids) >= 3 and {"http", "router", "decode_worker"} <= comps:
            break
        if time.monotonic() - t0 > 20:
            raise AssertionError(f"tracectl {rid}: {len(spans)} spans from "
                                 f"pids {pids}, components {comps}")
        await asyncio.sleep(0.5)
    row["tracectl"] = dict(rid=rid, spans=len(spans), pids=len(pids),
                           components=sorted(comps))
    return row


def _metrics_scrape(fleet: Fleet, name: str, store: str, component: str,
                    until, timeout: float = 60) -> dict:
    """Start ``cli.metrics`` as ``name`` on ``component``; its /metrics
    samples once ``until(samples)`` holds."""
    import re

    fleet.start(name, "dynamo_tpu_torch.cli.metrics", "--store", store,
                "--component", component, "--port", "0",
                "--scrape-interval", str(GRAPH_METRICS_S))
    line = fleet.wait_line(name, r"metrics aggregator on :\d+", 60)
    port = int(re.search(r":(\d+)", line).group(1))
    t0 = time.monotonic()
    while True:
        sc = scrape(port)
        if until(sc):
            return sc
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"{name}: /metrics never showed what was "
                                 f"wanted: {sorted(sc)[:40]}")
        time.sleep(GRAPH_METRICS_S)


def _cpu_engines(smi: str) -> dict:
    """(f): ``cli.run`` with the CPU-level engines, and ``cli.mock_worker``
    scraped by ``cli.metrics``, each a process on this machine."""
    import re

    fleet = Fleet(os.path.join(GRAPH_DIR, "cpu_engines"))
    fleet.env["DYN_TOKEN_ECHO_DELAY_MS"] = "0"
    pytok = os.path.join(fleet.root, "reverse.py")
    with open(pytok, "w") as f:
        f.write(PYTOK_REVERSE)
    try:
        fleet.start("store", "dynamo_tpu_torch.runtime.store_server",
                    "--host", "127.0.0.1", "--port", "0")
        for name, out in (("pytok", f"pytok:{pytok}"),
                          ("echo_core", "echo_core")):
            fleet.start(name, "dynamo_tpu_torch.cli.run", "in=http",
                        f"out={out}", "--http-host", "127.0.0.1",
                        "--http-port", "0", "--model-name", "m")
        line = fleet.wait_line("store", r"listening on \S+:\d+", 60)
        store = f"127.0.0.1:{line.rsplit(':', 1)[1]}"
        fleet.start("mock_worker", "dynamo_tpu_torch.cli.mock_worker",
                    "--store", store, "--component", "mock", "--period",
                    "0.1", "--total-slots", "8", "--kv-total", "512")
        texts = {}
        for name, prompt, want in (("pytok", "abcdef", "fed"),
                                   ("echo_core", "hello", "hello")):
            line = fleet.wait_line(name, r"listening on :\d+", 120)
            port = int(re.search(r":(\d+)", line).group(1))
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/completions",
                data=json.dumps({"model": "m", "prompt": prompt,
                                 "max_tokens": len(want)}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                out = json.loads(resp.read())
            texts[name] = out["choices"][0]["text"]
            if texts[name] != want \
                    or out["usage"]["completion_tokens"] != len(want):
                raise AssertionError(f"out={name} answered {out} for "
                                     f"{prompt!r}, want {want!r}")
        sc = _metrics_scrape(
            fleet, "metrics", store, "mock",
            lambda s: _total(s, "llm_requests_total_slots",
                             component="mock") == 8
            and _total(s, "llm_kv_blocks_total", component="mock") == 512)
        return dict(texts=texts,
                    mock_gauges={k: v for k, v in sc.items()
                                 if 'component="mock"' in k},
                    card=smi)
    finally:
        fleet.stop()


def graph_phase(torch, smi: str, serve: dict) -> dict:
    """``python -m dynamo_tpu_torch.cli.serve`` brings up the KV-routed
    graph (store, frontend, router, one Llama-3-8B worker on the card) as
    a user would, from a YAML config; requests go through its frontend
    (the serve phase's cold greedy stream, a burst); dyntop, ctl,
    tracectl and cli.metrics read the live graph; a KvRecorder's capture
    replays into the live router's overlaps; SIGTERM stops the graph and
    frees the card; then the CPU-level engines of ``cli.run`` and the mock
    worker run on this machine."""
    import asyncio
    import re

    t_phase = time.perf_counter()
    os.makedirs(GRAPH_DIR, exist_ok=True)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    free0 = torch.cuda.mem_get_info()[0] if DEVICE == "cuda" else None
    http = _free_port()
    cfg_path = os.path.join(GRAPH_DIR, "agg_router.yaml")
    with open(cfg_path, "w") as f:
        f.write(_graph_yaml(http))
    fleet = Fleet(GRAPH_DIR)
    row: dict = dict(phase="graph", entry=GRAPH_ENTRY, card=smi,
                     preset=PRESET, engine=ENGINE_ARGS)
    try:
        # (a) bring-up
        t0 = time.perf_counter()
        serve_proc = fleet.start(
            "serve", "dynamo_tpu_torch.cli.serve", GRAPH_ENTRY, "--config",
            cfg_path, "--platform", "cuda" if DEVICE == "cuda" else "cpu",
            "--total-chips", "1")
        line = fleet.wait_line("serve", r"serving \S+ \(store \S+\)",
                               GRAPH_START_S)
        row["bring_up_s"] = time.perf_counter() - t0
        store_port = int(re.search(r"store \S+:(\d+)\)", line).group(1))
        log = fleet.log("serve")
        planes = {}
        for svc, kind in re.findall(
                r"^\[(\w+)\] .*data plane: (\w+) on port", log, re.M):
            planes.setdefault(svc, set()).add(kind)
        kids = _children(serve_proc.pid)
        stores = [p for p, exe in kids.items() if exe.startswith("dynstore-")]
        # as Fleet.planes: every data plane native, and the services that
        # serve endpoints (the router, the worker) have one; the frontend
        # serves none
        if not {"router", "backend"} <= set(planes) \
                or any(k != {"native"} for k in planes.values()) \
                or len(stores) != 1 or len(kids) != 4:
            raise AssertionError(f"graph children not on the native plane "
                                 f"and store: planes {planes}, children "
                                 f"{kids}")
        wid = int(re.search(r"DYNAMO_SERVICE_READY backend worker=([0-9a-f]+)",
                            log).group(1), 16)
        row.update(children=sorted(kids.values()), worker=f"{wid:x}",
                   planes={k: sorted(v) for k, v in planes.items()})
        emit({"phase": "graph", "part": "a_bring_up",
              "bring_up_s": row["bring_up_s"], "children": row["children"],
              "planes": row["planes"]})
        t0 = time.monotonic()
        while PRESET not in http_get(http, "/v1/models")[1].decode():
            if time.monotonic() - t0 > 60:
                raise AssertionError("the graph's frontend never listed "
                                     "the model")
            time.sleep(0.1)
        # the worker's counters before the requests, from cli.metrics
        store = f"127.0.0.1:{store_port}"
        sc0 = _metrics_scrape(fleet, "metrics", store, "backend",
                              lambda s: f"{wid:x}" in _per_worker(
                                  s, "dyn_engine_dispatches_total", "kind"))
        mport = int(re.search(r"aggregator on :(\d+)",
                              fleet.log("metrics")).group(1))
        # (b)-(d)
        row.update(asyncio.run(_graph_requests(store_port, http, wid,
                                               serve["lone_stream"])))
        from dynamo_tpu_torch.models.llama import preset

        L = preset(PRESET).num_layers
        on_card = DEVICE == "cuda"        # the wrappers count card launches
        time.sleep(8 * GRAPH_METRICS_S)   # the last publish and scrape
        sc = scrape(mport)
        counts = _delta(_counts(sc0, f"{wid:x}"), _counts(sc, f"{wid:x}"))
        if not (counts["prefill"] > 0 and counts["decode_step"] > 0
                and counts["flash"] == L * counts["prefill"] * on_card
                and counts["paged"] == L * counts["decode_step"] * on_card
                and (counts["flash"] > 0) == on_card
                and (counts["paged"] > 0) == on_card):
            raise AssertionError(f"the graph worker's kernel launches do "
                                 f"not account for its dispatches: {counts}")
        row.update(counts=counts, flash_launches=counts["flash"],
                   paged_launches=counts["paged"])
        # (e) stop: SIGTERM to cli.serve, every child and the store gone
        t0 = time.perf_counter()
        serve_proc.terminate()
        serve_proc.wait(timeout=GRAPH_STOP_S)
        row["stop_s"] = time.perf_counter() - t0
        if serve_proc.returncode != 0 or "serve stopped" not in fleet.log(
                "serve"):
            raise AssertionError(f"cli.serve exited {serve_proc.returncode}"
                                 f":\n{fleet.log('serve')[-3000:]}")
        alive = [p for p in kids if os.path.exists(f"/proc/{p}")]
        if alive:
            raise AssertionError(f"graph children still alive after stop: "
                                 f"{alive}")
        if DEVICE == "cuda":
            torch.cuda.synchronize()
            t0 = time.monotonic()
            while torch.cuda.mem_get_info()[0] < free0 - GRAPH_MEM_SLACK:
                if time.monotonic() - t0 > 30:
                    raise AssertionError(
                        f"the card holds {free0 - torch.cuda.mem_get_info()[0]}"
                        f" bytes more than before the graph")
                time.sleep(0.5)
            row["card_free_bytes"] = dict(
                before=free0, after=torch.cuda.mem_get_info()[0])
        emit({"phase": "graph", "part": "e_stop", "stop_s": row["stop_s"],
              "card_free_bytes": row.get("card_free_bytes")})
    finally:
        fleet.stop()
    # (f) the CPU-level engines on this machine
    row["cpu_engines"] = _cpu_engines(smi)
    row.update(loop_wedges_s=fleet.wedges(),
               phase_s=time.perf_counter() - t_phase)
    emit(row)
    return row


# ---------------------------------------------------------------------------
# phase 18: the graph deployed as an artifact by the port's operator
# ---------------------------------------------------------------------------

DEPLOY_DIR = os.path.join(ROOT, "build", "dynamo_tpu_torch", "deploy")
DEPLOY_NAME = "llm"
DEPLOY_MODULE = "smoke_graphs"      # the graph's module: only the bundle
DEPLOY_RESYNC_S = 1.0
DEPLOY_START_S = 300                 # apply to ready: the 8B worker's build


def _deploy_resource(http: int, platform: str) -> str:
    """The deployment, in the YAML subset ``deployctl -f`` reads: the
    graph phase's services and engine arguments, the worker on one card."""
    page = ENGINE_ARGS["page_size"]
    return "\n".join([
        "# the KV-routed Llama-3-8B graph, deployed from its artifact",
        "apiVersion: dynamo.tpu/v1alpha1", "kind: DynamoDeployment",
        "metadata:", f"  name: {DEPLOY_NAME}", "  namespace: default",
        "spec:", f"  graph: artifact://llm/1#{DEPLOY_MODULE}:AggRouterGraph",
        f"  platform: {platform}", "  services:",
        "    frontend:", "      config:", "        host: 127.0.0.1",
        f"        port: {http}", "        router_component: router",
        "    router:", "      config:", "        worker_component: backend",
        f"        block_size: {page}",
        "    backend:", "      replicas: 1", "      gpus: 1", "      config:",
        "        engine: torch", "        register_model: true",
        f"        model_name: {PRESET}", f"        kv_block_size: {page}",
        f"        metrics_interval: {GRAPH_METRICS_S}",
        f"        extra_engine_args: '{json.dumps(ENGINE_ARGS)}'", ""])


def _ctl(store: str, *argv: str):
    """``deployctl --store <store> ...``: (exit code, stdout)."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-m", "dynamo_tpu_torch.cli.deployctl",
                        "--store", store, *argv], capture_output=True,
                       text=True, timeout=120, cwd=ROOT, env=env)
    return r.returncode, r.stdout


def _deploy_status(store: str):
    rc, out = _ctl(store, "status", DEPLOY_NAME)
    return json.loads(out) if rc == 0 else None


def _compute_pids() -> set:
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return {int(x) for x in out.split() if x.strip().isdigit()}


def _no_cuda_context(pid: int) -> dict:
    """Whether ``pid`` holds no CUDA context: it maps no ``libcuda`` and
    ``nvidia-smi`` lists no compute app of that pid (this process, which
    holds one, tells whether the listing sees this pid namespace)."""
    with open(f"/proc/{pid}/maps") as f:
        libcuda = "libcuda.so" in f.read()
    pids = _compute_pids() if DEVICE == "cuda" else set()
    row = dict(libcuda_mapped=libcuda, listed=pid in pids,
               listing_sees_this_process=os.getpid() in pids)
    if libcuda or row["listed"]:
        raise AssertionError(f"the operator (pid {pid}) holds a CUDA "
                             f"context: {row}")
    return row


def _worker_of(op_pid: int):
    """(pid, environ) of the operator's card worker."""
    for pid in _children(op_pid):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
            if f"{DEPLOY_MODULE}:Worker".encode() in argv:
                with open(f"/proc/{pid}/environ", "rb") as f:
                    env = dict(kv.decode().split("=", 1)
                               for kv in f.read().split(b"\0") if b"=" in kv)
                return pid, env
        except OSError:
            continue
    return None, None


def _await_ready(fleet: Fleet, store: str, t0: float, old_pid=None) -> dict:
    """Polls ``deployctl status`` until ``ready``; fails if it reads ready
    before the card worker's ``DYNAMO_SERVICE_READY`` line."""
    seen = []
    while True:
        st = _deploy_status(store)
        state = st and st["state"]
        if not seen or seen[-1] != state:
            seen.append(state)
        if state == "ready":
            readies = fleet.log("operator").count(
                "[backend] DYNAMO_SERVICE_READY backend")
            if readies < (2 if old_pid else 1):
                raise AssertionError(f"status ready before the worker's "
                                     f"READY line: {st}")
            return dict(seconds=time.perf_counter() - t0, states=seen,
                        ready_replicas=st["readyReplicas"],
                        conditions=[(c["type"], c["status"], c["message"])
                                    for c in st["conditions"]])
        if time.perf_counter() - t0 > DEPLOY_START_S:
            raise AssertionError(f"deployment not ready in {DEPLOY_START_S} "
                                 f"s: {st}\n{fleet.log('operator')[-3000:]}")
        fleet.procs["operator"][0].poll()
        if fleet.procs["operator"][0].returncode is not None:
            raise AssertionError(f"the operator exited:\n"
                                 f"{fleet.log('operator')[-3000:]}")
        time.sleep(0.25)


def _served_counts(mport: int, sc0: dict, wid: str, L: int) -> dict:
    """The worker's dispatches and launches since ``sc0``; fails unless
    flash = L x prefill dispatches and paged = L x decode steps."""
    on_card = DEVICE == "cuda"
    time.sleep(8 * GRAPH_METRICS_S)   # the last publish and scrape
    counts = _delta(_counts(sc0, wid), _counts(scrape(mport), wid))
    if not (counts["prefill"] > 0 and counts["decode_step"] > 0
            and counts["flash"] == L * counts["prefill"] * on_card
            and counts["paged"] == L * counts["decode_step"] * on_card):
        raise AssertionError(f"the deployed worker's kernel launches do not "
                             f"account for its dispatches: {counts}")
    return counts


def _kube_part(store: str, resource: str) -> dict:
    """(e): the rendered manifests, and a reconcile through the REST
    adapter against an apiserver double, scaled by cli.planner's kube
    connector."""
    import asyncio

    from dynamo_tpu_torch.cli import planner as planner_cli
    from dynamo_tpu_torch.deploy import artifacts
    from dynamo_tpu_torch.deploy.crd import Deployment
    from dynamo_tpu_torch.deploy.kube import (CR_KIND, FakeKubeApi,
                                              KubeReconciler, serve_fake_api)
    from dynamo_tpu_torch.deploy.operator import Operator
    from dynamo_tpu_torch.deploy.rest_api import RestKubeApi
    from dynamo_tpu_torch.runtime.store_client import StoreClient
    from dynamo_tpu_torch.utils import yamlsubset

    path = os.path.join(DEPLOY_DIR, "llm.yaml")
    rc, text = _ctl(store, "render", "-f", path)
    docs = [yamlsubset.loads(d) for d in text.split("---\n") if d.strip()]
    pods = {d["metadata"]["name"]: d["spec"]["template"]["spec"]
            for d in docs if d["kind"] == "Deployment"}
    modules = sorted({c["command"][2] for p in pods.values()
                      for c in p["containers"]})
    limits = pods[f"{DEPLOY_NAME}-backend"]["containers"][0].get(
        "resources", {}).get("limits")
    if rc != 0 or limits != {"nvidia.com/gpu": 1} \
            or "dynamo_tpu." in text \
            or any(not m.startswith("dynamo_tpu_torch.") for m in modules):
        raise AssertionError(f"deployctl render: rc {rc}, worker limits "
                             f"{limits}, modules {modules}")
    row: dict = dict(render=dict(kinds=[d["kind"] for d in docs],
                                 worker_limits=limits, modules=modules))

    artifacts.CACHE_DIR = os.path.join(DEPLOY_DIR, "cache")
    host, port = store.split(":")

    async def services():
        client = await StoreClient(host, int(port)).connect()
        try:
            return Operator._collect_services(artifacts.load_entry(
                *await artifacts.resolve(client, f"artifact://llm/1#"
                                         f"{DEPLOY_MODULE}:AggRouterGraph")))
        finally:
            await client.close()

    svc = asyncio.run(services())
    fake = FakeKubeApi()
    srv = serve_fake_api(fake)
    try:
        url = f"http://127.0.0.1:{srv.server_port}"
        rec = KubeReconciler(RestKubeApi(url), svc)
        args = planner_cli.parse_args([
            "--connector", "kube", "--kube-url", url, "--kube-deployment",
            DEPLOY_NAME, "--kube-namespace", "default"])
        conn = planner_cli.build_connector(args, {"decode": "backend"})
        if type(conn.api) is not RestKubeApi:
            raise AssertionError(f"the kube connector's api: {conn.api}")
        dep = Deployment.from_dict(yamlsubset.loads(resource))
        steps = []
        for target in (None, 2, 1):
            if target is not None:
                asyncio.run(conn.apply("decode", target, None))
                dep = Deployment.from_dict(
                    conn.api.get(CR_KIND, "default", DEPLOY_NAME))
            status = rec.reconcile(dep)
            child = conn.api.get("Deployment", "default",
                                 f"{DEPLOY_NAME}-backend")
            labels = child["spec"]["selector"]["matchLabels"]
            running = [p for p in conn.api.list("Pod", "default", labels)
                       if p["status"]["phase"] == "Running"]
            want = target or 1
            conds = {c["type"]: c["status"] for c in status["conditions"]}
            if child["spec"]["replicas"] != want or len(running) != want \
                    or status["services"]["backend"] != {"want": want,
                                                         "ready": want} \
                    or conds != {"Available": "True",
                                 "Progressing": "False"}:
                raise AssertionError(f"kube reconcile at {want}: {child}, "
                                     f"{len(running)} pods, {status}")
            steps.append(dict(replicas=want, pods=len(running),
                              conditions=conds,
                              services=status["services"]))
        row["kube"] = dict(steps=steps, objects=len(fake.objects),
                           applies=fake.apply_count)
    finally:
        srv.shutdown()
        srv.server_close()
    return row


def deploy_phase(torch, smi: str, serve: dict) -> dict:
    """The port's deploy layer on the card: a store, the api-store and
    ``deployctl operator --platform cuda`` as processes; the graph phase's
    KV-routed Llama-3-8B graph pushed as an artifact under a module name
    only the bundle has, applied, served (the serve phase's greedy stream),
    crash-restarted and deleted by the operator; its Kubernetes half on
    this host; SIGTERM stops the operator with nothing left behind."""
    import asyncio
    import hashlib
    import re
    import shutil
    import signal

    from dynamo_tpu_torch.models.llama import preset
    from dynamo_tpu_torch.runtime.store_client import StoreClient

    t_phase = time.perf_counter()
    L = preset(PRESET).num_layers
    os.makedirs(DEPLOY_DIR, exist_ok=True)
    for sub in ("cache", "objects"):
        shutil.rmtree(os.path.join(DEPLOY_DIR, sub), ignore_errors=True)
    on_card = DEVICE == "cuda"
    platform = "cuda" if on_card else "cpu"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        free0 = torch.cuda.mem_get_info()[0]
    fleet = Fleet(DEPLOY_DIR)
    fleet.env["DYNAMO_ARTIFACT_CACHE"] = os.path.join(DEPLOY_DIR, "cache")
    row: dict = dict(phase="deploy", card=smi, preset=PRESET,
                     engine=ENGINE_ARGS)
    try:
        # (a) bring-up: store, api-store, operator
        fleet.start("store", "dynamo_tpu_torch.runtime.store_server",
                    "--host", "127.0.0.1", "--port", "0")
        line = fleet.wait_line("store", r"listening on \S+:\d+", 60)
        store = f"127.0.0.1:{line.rsplit(':', 1)[1]}"
        store_port = int(store.rsplit(":", 1)[1])
        fleet.start("api", "dynamo_tpu_torch.deploy.api_store", "--store",
                    store, "--root", "file://" + os.path.join(DEPLOY_DIR,
                                                              "objects"),
                    "--port", "0")
        api = fleet.wait_line("api", r"api-store on \S+", 60).split()[-1]
        op = fleet.start("operator", "dynamo_tpu_torch.cli.deployctl",
                         "--store", store, "operator", "--platform",
                         platform, "--total-chips", "1", "--resync",
                         str(DEPLOY_RESYNC_S))
        fleet.wait_line("operator", r"operator watching .* 1 cards", 60)
        row["operator_context"] = {"started": _no_cuda_context(op.pid)}
        emit({"phase": "deploy", "part": "a_bring_up",
              "planes": fleet.planes(), "operator": row["operator_context"]})

        # (b) the artifact: llm_graphs.py as smoke_graphs.py
        bundle = os.path.join(DEPLOY_DIR, f"{DEPLOY_MODULE}.py")
        with open(os.path.join(ROOT, "dynamo_tpu_torch", "examples",
                               "llm_graphs.py"), "rb") as f:
            data = f.read()
        with open(bundle, "wb") as f:
            f.write(data)
        rc, out = _ctl(store, "push", "llm", bundle, "--api",
                       f"http://{api}")

        async def descriptor():
            client = await StoreClient("127.0.0.1", store_port).connect()
            try:
                return await client.get("deploy/artifacts/llm/00000001")
            finally:
                await client.close()

        desc = json.loads(asyncio.run(descriptor()) or b"{}")
        digest = hashlib.sha256(data).hexdigest()
        if rc != 0 or not out.startswith("pushed llm v1 ") \
                or desc.get("sha256") != digest \
                or desc.get("size") != len(data):
            raise AssertionError(f"push: rc {rc} {out!r}, descriptor {desc}")
        row["artifact"] = dict(size=len(data), sha256=digest,
                               url=desc["url"])
        emit({"phase": "deploy", "part": "b_artifact", **row["artifact"]})

        # (c) apply and serve
        http = _free_port()
        resource = _deploy_resource(http, platform)
        with open(os.path.join(DEPLOY_DIR, "llm.yaml"), "w") as f:
            f.write(resource)
        t0 = time.perf_counter()
        rc, out = _ctl(store, "apply", "-f",
                       os.path.join(DEPLOY_DIR, "llm.yaml"))
        if rc != 0:
            raise AssertionError(f"deployctl apply: {rc} {out}")
        row["apply"] = _await_ready(fleet, store, t0)
        if "deploying" not in row["apply"]["states"]:
            raise AssertionError(f"status went to ready without deploying: "
                                 f"{row['apply']}")
        row["operator_context"]["serving"] = _no_cuda_context(op.pid)
        log = fleet.log("operator")
        planes = {}
        for svc, kind in re.findall(
                r"^\[(\w+)\] .*data plane: (\w+) on port", log, re.M):
            planes.setdefault(svc, set()).add(kind)
        kids = _children(op.pid)
        wpid, wenv = _worker_of(op.pid)
        cache = os.path.join(DEPLOY_DIR, "cache", "llm", "1")
        if not {"router", "backend"} <= set(planes) \
                or any(k != {"native"} for k in planes.values()) \
                or len(kids) != 3 or wpid is None \
                or wenv.get("DYNAMO_ARTIFACT_PATH") != cache \
                or wenv.get("CUDA_VISIBLE_DEVICES") != ("0" if on_card
                                                        else "") \
                or not os.path.exists(os.path.join(cache,
                                                   f"{DEPLOY_MODULE}.py")):
            raise AssertionError(f"deployed children: planes {planes}, "
                                 f"{kids}, worker {wpid} env "
                                 f"{ {k: wenv.get(k) for k in ('DYNAMO_ARTIFACT_PATH', 'CUDA_VISIBLE_DEVICES')} if wenv else None}")
        wid = re.search(r"DYNAMO_SERVICE_READY backend worker=([0-9a-f]+)",
                        log).group(1)
        row.update(children=sorted(kids.values()), worker=wid,
                   planes={k: sorted(v) for k, v in planes.items()},
                   store_program=fleet.planes()["store"])
        t0 = time.monotonic()
        while PRESET not in http_get(http, "/v1/models")[1].decode():
            if time.monotonic() - t0 > 60:
                raise AssertionError("the frontend never listed the model")
            time.sleep(0.1)
        sc0 = _metrics_scrape(fleet, "metrics", store, "backend",
                              lambda s: wid in _per_worker(
                                  s, "dyn_engine_dispatches_total", "kind"))
        mport = int(re.search(r"aggregator on :(\d+)",
                              fleet.log("metrics")).group(1))
        row["served"] = asyncio.run(_graph_greedy(
            store_port, http, serve["lone_stream"], "the deployed graph"))
        row["counts"] = _served_counts(mport, sc0, wid, L)
        emit({"phase": "deploy", "part": "c_apply_serve",
              "apply_to_ready_s": row["apply"]["seconds"],
              "states": row["apply"]["states"], "planes": row["planes"],
              "children": row["children"], "served": row["served"],
              "counts": row["counts"], "operator": row["operator_context"]})

        # (d) crash restart: SIGKILL the worker
        t0 = time.perf_counter()
        os.kill(wpid, signal.SIGKILL)
        while (_deploy_status(store) or {}).get("state") == "ready":
            if time.perf_counter() - t0 > 60:
                raise AssertionError("status stayed ready after the kill")
            time.sleep(0.1)
        left_s = time.perf_counter() - t0
        row["restart"] = _await_ready(fleet, store, t0, old_pid=wpid)
        row["restart"]["left_ready_s"] = left_s
        npid, nenv = _worker_of(op.pid)
        wid2 = re.findall(r"DYNAMO_SERVICE_READY backend worker=([0-9a-f]+)",
                          fleet.log("operator"))[-1]
        if npid in (None, wpid) or wid2 == wid \
                or nenv.get("CUDA_VISIBLE_DEVICES") != wenv.get(
                    "CUDA_VISIBLE_DEVICES"):
            raise AssertionError(f"no new worker on the card: {npid} "
                                 f"(was {wpid}), worker {wid2}")
        sc1 = _metrics_scrape(fleet, "metrics2", store, "backend",
                              lambda s: wid2 in _per_worker(
                                  s, "dyn_engine_dispatches_total", "kind"))
        mport2 = int(re.search(r"aggregator on :(\d+)",
                               fleet.log("metrics2")).group(1))
        row["restart"]["served"] = asyncio.run(_graph_greedy(
            store_port, http, serve["lone_stream"],
            "the restarted deployment"))
        row["restart"]["counts"] = _served_counts(mport2, sc1, wid2, L)
        row["restart"]["worker"] = wid2
        emit({"phase": "deploy", "part": "d_crash_restart",
              "kill_to_ready_s": row["restart"]["seconds"],
              **{k: row["restart"][k] for k in ("left_ready_s", "states",
                                                "served", "counts")}})

        # (e) Kubernetes on this host
        row.update(_kube_part(store, resource))
        emit({"phase": "deploy", "part": "e_kube", "render": row["render"],
              "kube": row["kube"]})

        # (f) delete, then stop the operator
        kids = _children(op.pid)
        t0 = time.perf_counter()
        rc, out = _ctl(store, "delete", f"default/{DEPLOY_NAME}")
        if (rc, out) != (0, "deleted\n"):
            raise AssertionError(f"deployctl delete: {rc} {out!r}")
        while [p for p in kids if os.path.exists(f"/proc/{p}")] \
                or _deploy_status(store) is not None:
            if time.perf_counter() - t0 > GRAPH_STOP_S:
                raise AssertionError(f"after delete: children "
                                     f"{_children(op.pid)}, status "
                                     f"{_deploy_status(store)}")
            time.sleep(0.2)
        row["delete_s"] = time.perf_counter() - t0
        if on_card:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            while torch.cuda.mem_get_info()[0] < free0 - GRAPH_MEM_SLACK:
                if time.monotonic() - t0 > 30:
                    raise AssertionError(
                        f"the card holds "
                        f"{free0 - torch.cuda.mem_get_info()[0]} bytes more "
                        f"than before the deployment")
                time.sleep(0.5)
            row["card_free_bytes"] = dict(before=free0,
                                          after=torch.cuda.mem_get_info()[0])
        t0 = time.perf_counter()
        op.send_signal(signal.SIGTERM)
        op.wait(timeout=GRAPH_STOP_S)
        row["operator_stop_s"] = time.perf_counter() - t0
        if op.returncode != 0 or "operator stopped" not in fleet.log(
                "operator") or _children(op.pid):
            raise AssertionError(f"operator exited {op.returncode}:\n"
                                 f"{fleet.log('operator')[-3000:]}")
        emit({"phase": "deploy", "part": "f_delete",
              "delete_s": row["delete_s"],
              "card_free_bytes": row.get("card_free_bytes"),
              "operator_stop_s": row["operator_stop_s"]})
    finally:
        fleet.stop()
    row.update(flash_launches=row["counts"]["flash"]
               + row["restart"]["counts"]["flash"],
               paged_launches=row["counts"]["paged"]
               + row["restart"]["counts"]["paged"],
               loop_wedges_s=fleet.wedges(),
               phase_s=time.perf_counter() - t_phase)
    emit(row)
    return row


# ---------------------------------------------------------------------------
# phase 17: tensor parallelism, two ranks sharing this card
# ---------------------------------------------------------------------------

TP_ARGS = ["--tensor-parallel-size", "2", "--dist-backend", "gloo",
           "--devices", "0,0"]
TP_SEED = 2020
TP_PROMPTS = (600, 200, 40)      # greedy requests, one 600-token 2-chunk
TP_TOKENS = 24
TP_MARGIN_LIMIT = 1.5            # PR 15's failover margin
TP_EXIT_S = 15                   # the leader's exit after its follower's
TP_FREE_S = 30                   # the card's memory back after the exit
TP_BUDGET_S = 300
TP_DISAGG_PROMPT = 600           # (b): two 512-token chunks' worth
TP_SPEC_TOKENS = 32              # (c): n-gram rounds over a repeated block
# the pair's engine: the serve phase's arguments and a paging lane (the
# kvpage phase's 20 pages of 8-block segments) for (d)
TP_ENGINE = dict(ENGINE_ARGS, kvpage_budget=20, kvpage_seg_pages=8,
                 kvpage_prefetch=2, kvpage_max_context=8192)
TP_KVPAGE_PROMPT = 4096          # (d): 3.2x the lane's 1280 tokens
TP_KVPAGE_TOKENS = 16
TP_KVPAGE_DENSE = 64             # (d): a dense request beside the lane's
TP_VLM_TOKENS = 16               # (e): Gemma3-4B, an image and a text
TP_SWAP_LAYERS = 4               # (f): Llama-3-8B width, swap_contract's
TP_SWAP_SEED = 2022              # (f): model B's seed (A: the engine's)
TP_SWAP_PROMPT = 300
TP_SWAP_TOKENS = 16
# the card's free bytes after a pair against before it started: the
# allocator's cache is emptied, but the process may keep what a pair's
# first shapes made (cuBLAS workspaces); an H100 80GB read 0-29 MB less.
# A rank left behind would hold gigabytes
TP_FREE_SLACK = 1 << 30


def _settled_rank_stats(core, timeout: float = 30.0) -> list:
    """Every rank's counters from a gather the leader began after this
    call, once it caught up with the leader's own dispatches
    (``EngineCore.rank_stats``: the followers' from their processes)."""
    seq = core.rank_stats_begun
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st = [dict(r) for r in core.rank_stats]
        if core.rank_stats_seq > seq and st \
                and st[0]["prefill_dispatches"] == core.prefill_dispatches \
                and st[0]["decode_steps"] == core.decode_steps_run:
            return st
        time.sleep(0.1)
    raise AssertionError("the tp ranks' counters did not settle")


async def _greedy_streams(engine, prompts, n: int) -> list:
    from dynamo_tpu_torch.llm.protocols.common import (BackendInput,
                                                       StopConditions)
    from dynamo_tpu_torch.runtime.engine import Context

    async def one(p):
        ids = []
        async for out in engine.generate(BackendInput(
                token_ids=list(p), stop=StopConditions(
                    max_tokens=n, ignore_eos=True)), Context()):
            ids += out.token_ids
        return ids

    import asyncio

    return list(await asyncio.gather(*(one(p) for p in prompts)))


def _rank_delta(a: list, b: list) -> list:
    return [{k: y[k] - x[k] for k in x} for x, y in zip(a, b)]


def _await(loop, coro, timeout: float = 300):
    import asyncio

    return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)


def _drain_greedy(core) -> list:
    """The tokens an idle EngineCore streams until it has no work (an
    injected sequence's decode)."""
    from dynamo_tpu_torch.llm.protocols.common import FinishReason

    toks = []
    while core.has_work:
        for so in core.step():
            if so.finish == FinishReason.ERROR:
                raise AssertionError(f"request failed: {so.error}")
            toks.append(so.token)
    return toks


def tp_restore_step(core, eng, loop, margins, smi: str) -> dict:
    """(a) Prefix reuse through the leader's host tier at tp=2: the reuse
    phase's 1496-token prompt, then every reusable device block flushed to
    the tier on the engine thread (``kv_offload`` frames: each rank's d2h
    of its kv heads, gathered into whole blocks), then the prompt again:
    its 23 full blocks restore from the tier in one ``kv_restore`` frame
    (each rank uploads its kv heads of the leader's whole blocks). Each
    rank's restored and offloaded bytes and seconds; both streams within
    TP_MARGIN_LIMIT of tp=1's teacher-forced top logit."""
    from dynamo_tpu_torch.models import llama

    m, page = core.cfg.model, core.page_size
    prompt = reuse_prompt(m.vocab_size)
    expect = (len(prompt) - 1) // page * page
    st0 = _settled_rank_stats(core)
    cold, cold_hit, cold_ttft, _ = _generate(eng, loop, prompt)
    t0 = time.perf_counter()
    flushed = eng.run_on_engine(lambda c: c.flush_reusable())
    flush_s = time.perf_counter() - t0
    hits0, restore0 = core.tiered.stats()["hits"], core.restore_seconds
    warm, hit, ttft, _ = _generate(eng, loop, prompt)
    st1 = _settled_rank_stats(core)
    d = _rank_delta(st0, st1)
    rank_block = llama.kv_block_bytes(m, page) // core.tp
    row = dict(
        prompt_tokens=len(prompt), flushed_blocks=flushed, flush_s=flush_s,
        cold_hit=cold_hit, kv_prefix_hit_tokens=hit, expect_hit=expect,
        tier_hits=core.tiered.stats()["hits"] - hits0,
        cold_ttft_s=cold_ttft, host_ttft_s=ttft,
        leader_restore_s=core.restore_seconds - restore0,
        rank_restore_bytes=[x["kv_restore_bytes"] for x in d],
        rank_restore_s=[x["kv_restore_seconds"] for x in d],
        rank_offload_bytes=[x["kv_offload_bytes"] for x in d],
        rank_offload_s=[x["kv_offload_seconds"] for x in d],
        streams_equal=cold == warm,
        worst_margin=max(max(margins(prompt, cold)),
                         max(margins(prompt, warm))))
    emit({"phase": "tp", "step": "restore", "nvidia_smi": smi, **row})
    if not (cold_hit == 0 and hit == expect
            and row["tier_hits"] == expect // page
            and row["rank_restore_bytes"] == [expect // page * rank_block]
            * core.tp
            and all(b >= flushed * rank_block
                    for b in row["rank_offload_bytes"])
            and row["worst_margin"] <= TP_MARGIN_LIMIT):
        raise AssertionError(f"tp host-tier restore: {row}")
    return row


def tp_disagg_step(torch, core, eng, loop, params, margins,
                   smi: str) -> dict:
    """(b) Disaggregation in both directions between the tp=2 pair and a
    tp=1 core on the serve phase's weights in this process: a 600-token
    prompt's ``prefill_extract`` on the pair (a ``kv_extract`` frame: each
    rank's kv heads gathered into the whole [L, T, Hkv, Dh] arrays on the
    leader) injected into the tp=1 core, and the tp=1 core's extract
    injected into the pair (``generate_prefilled``: a ``kv_inject`` frame
    gives each rank its kv heads). Both decodes within TP_MARGIN_LIMIT of
    tp=1's teacher-forced top logit."""
    import numpy as np

    from dynamo_tpu_torch.engine.engine import EngineCore, TorchEngineConfig
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.protocols.common import (BackendInput,
                                                       StopConditions)
    from dynamo_tpu_torch.runtime.engine import Context

    m = core.cfg.model
    prompt = np.random.default_rng(TP_SEED + 1).integers(
        1, m.vocab_size, TP_DISAGG_PROMPT).tolist()
    bi = BackendInput(token_ids=prompt, stop=StopConditions(
        max_tokens=TP_TOKENS, ignore_eos=True))
    one = EngineCore(TorchEngineConfig.from_card(
        ModelDeploymentCard.synthetic(PRESET), **dict(
            ENGINE_ARGS, max_batch=2, host_cache_blocks=0), device=DEVICE),
        params=params)
    try:
        t0 = time.perf_counter()
        k, v, tok, lp = _await(loop, eng.prefill_extract(bi, Context()))
        extract_s = time.perf_counter() - t0
        first = one.inject_prefilled("tp2-to-tp1", bi, k, v, tok, lp)
        to_one = [first.token] + _drain_greedy(one)
        k1, v1, tok1, lp1 = one.prefill_extract("tp1-extract", bi)

        async def into_pair():
            ids = []
            async for o in eng.generate_prefilled(bi, Context(), k1, v1,
                                                  tok1, lp1):
                ids += o.token_ids
            return ids

        t0 = time.perf_counter()
        to_pair = _await(loop, into_pair())
        inject_s = time.perf_counter() - t0
    finally:
        one.close()
        one.release_device()
        del one
    bits = [torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).float()
            for a in (k, k1)]
    row = dict(
        prompt_tokens=len(prompt), kv_shape=list(k.shape),
        kv_dtype=str(k.dtype), extract_s=extract_s, inject_decode_s=inject_s,
        first_tokens=[tok, tok1],
        k_max_abs_diff_tp2_vs_tp1=float((bits[0] - bits[1]).abs().max()),
        tp2_to_tp1=to_one, tp1_to_tp2=to_pair,
        worst_margin=max(max(margins(prompt, to_one)),
                         max(margins(prompt, to_pair))))
    emit({"phase": "tp", "step": "disagg", "nvidia_smi": smi, **row})
    want = [m.num_layers, len(prompt), m.num_kv_heads, m.head_dim]
    if not (row["kv_shape"] == want and k.dtype == np.uint16
            and len(to_one) == len(to_pair) == TP_TOKENS
            and row["worst_margin"] <= TP_MARGIN_LIMIT):
        raise AssertionError(f"tp disagg: {row}")
    return row


def tp_spec_step(torch, att, margins, smi: str) -> dict:
    """(c) n-gram speculative decoding at tp=2: a second pair, the serve
    phase's engine arguments with ``spec="ngram"``, streams a greedy
    request over a repeated 64-token block. The proposals are the
    leader's; each round is a ``verify`` frame both ranks run, the flash
    kernel at K+1 positions a lane on each rank's heads. Each rank's
    verify dispatches must be equal, and its flash launches one a layer a
    prefill dispatch and a round (no paged launch: spec decodes through
    the verify only), the stream within TP_MARGIN_LIMIT of tp=1. The
    rounds by bucket K are recorded: whether the random weights' stream
    repeats itself enough for the n-gram table to draft is the model's
    business, not the port's."""
    import numpy as np

    from dynamo_tpu_torch.models import llama

    block = np.random.default_rng(SPEC_SEED).integers(
        0, llama.preset(PRESET).vocab_size, 64).tolist()
    prompt = block * 4
    with served(["--model-name", PRESET, *TP_ARGS, "--extra-engine-args",
                 json.dumps(dict(ENGINE_ARGS, spec="ngram",
                                 spec_k=SPEC_K))]) as (eng, loop, _, _n,
                                                       init_s, _m):
        core = eng.core
        L = core.cfg.model.num_layers
        ranks = eng.plane.ranks
        st0 = _settled_rank_stats(core)
        t0 = time.perf_counter()
        got = _await(loop, _greedy_streams(eng, [prompt], TP_SPEC_TOKENS))[0]
        spec_s = time.perf_counter() - t0
        st1 = _settled_rank_stats(core)
        stats = dict(proposed=core.spec_proposed_total,
                     accepted=core.spec_accepted_total,
                     k_rounds=dict(core.spec_k_rounds))
    follower_rc = [p.returncode for p in ranks.procs]
    eng = core = None
    d = _rank_delta(st0, st1)
    row = dict(
        init_s=init_s, spec_s=spec_s, prompt_tokens=len(prompt),
        tokens=len(got), **stats,
        rank_verify_frames=[x["spec_dispatches"] for x in d],
        rank_prefill_dispatches=[x["prefill_dispatches"] for x in d],
        rank_launches=[{"flash": x["flash_launches"],
                        "paged": x["paged_launches"]} for x in d],
        follower_exit_codes=follower_rc, stream=got,
        worst_margin=max(margins(prompt, got)))
    emit({"phase": "tp", "step": "spec", "nvidia_smi": smi, **row})
    if not (len(got) == TP_SPEC_TOKENS
            and row["rank_verify_frames"][0] == row["rank_verify_frames"][1]
            > 0
            and all(x["flash_launches"] == L * (x["prefill_dispatches"]
                                                + x["spec_dispatches"])
                    and x["paged_launches"] == 0 for x in d)
            and follower_rc == [0]
            and row["worst_margin"] <= TP_MARGIN_LIMIT):
        raise AssertionError(f"tp spec: {row}")
    return row


def _card_free(torch) -> int:
    """The card's free bytes once this process's cached blocks went back
    (0 on the CPU)."""
    import gc

    gc.collect()
    if DEVICE != "cuda":
        return 0
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return torch.cuda.mem_get_info()[0]


def _tp_layout():
    """Two ranks sharing this card over gloo (``TP_ARGS``'s layout)."""
    from dynamo_tpu_torch.cli.worker import RankLayout

    return RankLayout(2, device=DEVICE, backend="gloo",
                      devices="0,0" if DEVICE == "cuda" else None)


def _run(coro, timeout: float = 600):
    import asyncio

    return asyncio.run(asyncio.wait_for(coro, timeout))


def _counted_kinds(core) -> "collections.Counter":
    """Count the leader's frames by kind (wraps its dispatch hook)."""
    import collections

    kinds, hook = collections.Counter(), core.dispatch_hook

    def counted(kind, meta, arrs):
        kinds[kind] += 1
        hook(kind, meta, arrs)
    core.dispatch_hook = counted
    return kinds


def _launch_check(d: list, L: int, prefill: list, decode: list) -> bool:
    """Each rank's flash launches one a layer a dense prefill dispatch
    (``prefill[r]``) and paged ones one a layer a decode step."""
    return all(x["flash_launches"] == L * p and x["paged_launches"] == L * n
               for x, p, n in zip(d, prefill, decode))


def tp_kvpage_step(torch, att, core, eng, loop, params, margins,
                   smi: str) -> dict:
    """(d) The KV paging lane at tp=2 on the pair (its engine has the
    kvpage phase's 20-page lane): a 4096-token greedy prompt, over the
    2048-token ``max_context``, routes to the lane; a 64-token dense
    request beside it. The lane's chunks and windows are frames both
    ranks run (``kvpage_prefill``, ``kvpage_decode``); its demotions are
    ``kv_offload`` frames; at each upload step the leader scatters each
    rank its kv heads of the tier's whole segment (``scatter_heads``).
    Each rank's page-in bytes and staging seconds; both kernels on both
    ranks for the dense request; the lane's stream within
    KVPAGE_LOGIT_LIMIT and the dense one within TP_MARGIN_LIMIT of tp=1's
    teacher-forced top logit. Then the same two requests on a tp=1 engine
    of the same arguments sharing this process's weights: its lane's
    seconds beside the pair's (the staging a rank minus tp=1's is about
    what the scatters cost; the two ranks time-slice one card)."""
    import numpy as np

    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig

    m = core.cfg.model
    L = m.num_layers
    kp = core.kvpager
    rng = np.random.default_rng(TP_SEED + 2)
    long_p = rng.integers(1, m.vocab_size, TP_KVPAGE_PROMPT).tolist()
    short_p = rng.integers(1, m.vocab_size, TP_KVPAGE_DENSE).tolist()
    kinds = _counted_kinds(core)
    lane0 = (kp.prefill_chunks, kp.decode_windows, kp.demoted_blocks,
             kp.pager.faults, kp.pager.pageins, kp.prefill_seconds,
             kp.decode_seconds, kp.stage_seconds)
    att.flash_attention.launches = 0
    att.paged_attention.launches = 0
    st0 = _settled_rank_stats(core)
    t0 = time.perf_counter()
    got_long, got_short = _await(loop, _greedy_streams(
        eng, [long_p, short_p], TP_KVPAGE_TOKENS))
    step_s = time.perf_counter() - t0
    st1 = _settled_rank_stats(core)
    leader = (att.flash_attention.launches, att.paged_attention.launches)
    core.dispatch_hook = eng.plane.publisher.hook
    d = _rank_delta(st0, st1)
    lane = [a - b for a, b in zip(
        (kp.prefill_chunks, kp.decode_windows, kp.demoted_blocks,
         kp.pager.faults, kp.pager.pageins, kp.prefill_seconds,
         kp.decode_seconds, kp.stage_seconds), lane0)]
    # the same requests at tp=1, on this process's copy of the weights
    one = TorchEngine(TorchEngineConfig(
        model=m, device=DEVICE, **{k: v for k, v in TP_ENGINE.items()
                                   if k != "preset"}), params)
    try:
        t0 = time.perf_counter()
        one_long, one_short = _run(_greedy_streams(
            one, [long_p, short_p], TP_KVPAGE_TOKENS))
        one_s = time.perf_counter() - t0
        k1 = one.core.kvpager
        tp1 = dict(step_s=one_s, lane_prefill_s=k1.prefill_seconds,
                   lane_decode_s=k1.decode_seconds,
                   stage_s=k1.stage_seconds, pagein_bytes=k1.pagein_bytes,
                   streams_equal_tp2=[one_long == got_long,
                                      one_short == got_short])
    finally:
        one.shutdown()
        one.core.release_device()
        del one
    row = dict(
        prompt_tokens=len(long_p), dense_prompt_tokens=len(short_p),
        step_s=step_s, lane_prefill_chunks=lane[0],
        lane_decode_windows=lane[1], demoted_blocks=lane[2],
        pager_faults=lane[3], pager_pageins=lane[4],
        lane_prefill_s=lane[5], lane_decode_s=lane[6],
        leader_stage_s=lane[7], tp1=tp1,
        peak_resident_pages=kp.peak_resident,
        frames=dict(kinds),
        rank_pagein_bytes=[x["kvpage_pagein_bytes"] for x in d],
        rank_pagein_s=[x["kvpage_pagein_seconds"] for x in d],
        rank_offload_bytes=[x["kv_offload_bytes"] for x in d],
        rank_launches=[{"flash": x["flash_launches"],
                        "paged": x["paged_launches"]} for x in d],
        rank_dispatches=[{"prefill": x["prefill_dispatches"],
                          "decode_steps": x["decode_steps"]} for x in d],
        leader_launches={"flash": leader[0], "paged": leader[1]},
        worst_margin_paged=max(margins(long_p, got_long)),
        worst_margin_dense=max(margins(short_p, got_short)),
        margin_limit_paged=KVPAGE_LOGIT_LIMIT)
    emit({"phase": "tp", "step": "kvpage", "nvidia_smi": smi, **row})
    chunks = -(-TP_KVPAGE_PROMPT // ENGINE_ARGS["prefill_chunk"])
    if not (len(got_long) == len(got_short) == TP_KVPAGE_TOKENS
            and lane[0] == chunks and lane[1] > 0 and lane[2] > 0
            and kinds["kvpage_prefill"] == lane[0]
            and kinds["kvpage_decode"] == lane[1]
            and kinds["kv_offload"] > 0
            and kp.peak_resident <= TP_ENGINE["kvpage_budget"]
            and row["rank_pagein_bytes"][0] == row["rank_pagein_bytes"][1]
            > 0
            and _launch_check(d, L, [x["prefill_dispatches"] for x in d],
                              [x["decode_steps"] for x in d])
            and all(x["prefill_dispatches"] > 0 and x["decode_steps"] > 0
                    for x in d)
            and leader == (d[0]["flash_launches"], d[0]["paged_launches"])
            and row["worst_margin_paged"] <= KVPAGE_LOGIT_LIMIT
            and row["worst_margin_dense"] <= TP_MARGIN_LIMIT):
        raise AssertionError(f"tp kvpage: {row}")
    return row


def _mm_stream_logits(torch, core, bi, tokens):
    """The teacher-forced logits of an image request's greedy stream on a
    tp=1 VLM core: the prompt and ``tokens[:-1]`` in one dense forward,
    the tower's soft tokens over the image positions and the same-image
    or-mask; row i is what chooses ``tokens[i]``. f32."""
    import numpy as np

    from dynamo_tpu_torch.device import to_device
    from dynamo_tpu_torch.models import llama

    m, dev, page = core.cfg.model, core.device, core.page_size
    prompt = list(bi.token_ids)
    spans, soft, _ = core._prepare_mm(bi, prompt)
    full = prompt + list(tokens[:-1])
    S = len(full)
    sp = np.zeros(S, np.int32)
    sp[:len(spans)] = spans
    mask = to_device(sp > 0, dev)
    vals = torch.zeros((S, m.hidden_size), dtype=m.dtype, device=dev)
    vals[mask] = soft.to(m.dtype)
    n_pages = -(-S // page) + 1
    shape = (m.num_layers, m.num_kv_heads, n_pages, page, m.head_dim)
    kp = torch.zeros(shape, dtype=m.dtype, device=dev)
    vp = torch.zeros(shape, dtype=m.dtype, device=dev)
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None]
    span = to_device(sp, dev)[None]
    with torch.no_grad():
        lg, _, _ = llama.forward(
            core.params, m, to_device(np.asarray(full), dev)[None], pos, kp,
            vp, page + pos.long(), page + pos.long(), pos,
            torch.ones((1, S), dtype=torch.bool, device=dev),
            attn_impl="dense", embed_override=(vals[None], mask[None]),
            attn_spans=(span, span))
    return lg[0, len(prompt) - 1:].float()


def _top_margins(torch, lg, stream) -> list:
    idx = torch.arange(len(stream), device=lg.device)
    chosen = lg[idx, torch.tensor(stream, device=lg.device)]
    return (lg.max(-1).values - chosen).tolist()


def _write_config(name: str, cfg: dict) -> str:
    """A model directory holding only ``config.json``: the ranks build
    the model it names from the engine's seed."""
    d = os.path.join(ROOT, "build", "dynamo_tpu_torch", name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f)
    return d


def tp_vlm_step(torch, att, smi: str) -> dict:
    """(e) Gemma3-4B-it (full width and depth, random bf16 weights from
    the seed, the SigLIP tower from seed + 1) at tp=2, both ranks on this
    card over gloo, built as ``cli.run --tensor-parallel-size 2`` builds
    it (``cli.worker.tp_engine``): the tower and projector are the
    leader's, unsharded; an image wave's ``prefill`` frame carries ``mm``
    and the soft-token rows it reads, and each rank runs it on the dense
    path at its 4 query and 2 kv heads; text waves run flash and decode
    paged there. A PNG image request (decoded by the frontend's decoder)
    and a text request, one after the other; each stream within
    TP_MARGIN_LIMIT of a tp=1 engine's teacher-forced top logit on the
    same seeds; both kernels' launches on each rank; the follower exits
    0 and the card's free bytes come back."""
    import numpy as np

    from dynamo_tpu_torch.cli.worker import tp_engine
    from dynamo_tpu_torch.engine.engine import EngineCore, TorchEngineConfig
    from dynamo_tpu_torch.llm import _png
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.protocols.common import (BackendInput,
                                                       StopConditions)

    path = _write_config("tp_vlm", GEMMA3_4B_HF)
    card = ModelDeploymentCard.resolve(path, "gemma3-4b-it")
    card.kv_block_size = VLM_ENGINE["page_size"]
    extra = dict(VLM_ENGINE, device=DEVICE)
    m_img = GEMMA3_4B_HF["image_token_index"]
    n_soft = GEMMA3_4B_HF["mm_tokens_per_image"]
    # text ids below the image token and the vocab
    hi = min(30000, m_img, TorchEngineConfig.from_card(
        card, **extra).model.vocab_size)
    rng = np.random.default_rng(TP_SEED + 3)
    png = _png.encode(test_image(5, 480, 640))
    pixels = _png.decode(png)
    head = rng.integers(2, hi, 12).tolist()
    tail = rng.integers(2, hi, 20).tolist()
    reqs = [BackendInput(token_ids=head + [m_img] * n_soft + tail,
                         images=[pixels], stop=StopConditions(
                             max_tokens=TP_VLM_TOKENS, ignore_eos=True)),
            BackendInput(token_ids=rng.integers(2, hi, 40).tolist(),
                         stop=StopConditions(max_tokens=TP_VLM_TOKENS,
                                             ignore_eos=True))]

    async def serve(eng):
        # one after the other: served together, both prompts would ride
        # the image wave (a dense dispatch) and the text one no flash wave
        from dynamo_tpu_torch.runtime.engine import Context

        out = []
        for bi in reqs:
            ids = []
            async for o in eng.generate(bi, Context()):
                ids += o.token_ids
            out.append(ids)
        return out

    free0 = _card_free(torch)
    t0 = time.perf_counter()
    eng = tp_engine(_tp_layout(), card, extra, model_path=path,
                    kv_block_size=card.kv_block_size)
    try:
        init_s = time.perf_counter() - t0
        core = eng.core
        m = core.cfg.model
        L = m.num_layers
        ranks = eng.plane.ranks
        if not (core.tp == 2 and core.vision_params is not None
                and core.k_pool.shape[1] == m.num_kv_heads // 2):
            raise AssertionError(f"tp vlm engine: {tuple(core.k_pool.shape)}")
        att.flash_attention.launches = 0
        att.paged_attention.launches = 0
        st0 = _settled_rank_stats(core)
        base = (core.image_waves, core.images_encoded)
        t0 = time.perf_counter()
        got = _run(serve(eng))
        serve_s = time.perf_counter() - t0
        st1 = _settled_rank_stats(core)
        leader = (att.flash_attention.launches, att.paged_attention.launches)
        waves = core.image_waves - base[0]
        images = core.images_encoded - base[1]
    finally:
        eng.shutdown()
    follower_rc = [p.returncode for p in ranks.procs]
    eng = core = None
    free1 = _card_free(torch)
    d = _rank_delta(st0, st1)
    # the tp=1 reference: the same seeds, the whole weights
    ref = EngineCore(TorchEngineConfig.from_card(card, **dict(
        extra, max_batch=1)))
    try:
        margins = [
            _top_margins(torch, _mm_stream_logits(torch, ref, reqs[0],
                                                  got[0]), got[0]),
            _top_margins(torch, _stream_logits(torch, ref,
                                               reqs[1].token_ids, got[1]),
                         got[1])]
    finally:
        ref.close()
        ref.release_device()
        del ref
    free2 = _card_free(torch)
    row = dict(
        model="gemma3-4b-it", init_s=init_s, serve_s=serve_s,
        image_prompt_tokens=len(reqs[0].token_ids),
        png_bytes=len(png), image_waves=waves, images_encoded=images,
        rank_launches=[{"flash": x["flash_launches"],
                        "paged": x["paged_launches"]} for x in d],
        rank_dispatches=[{"prefill": x["prefill_dispatches"],
                          "decode_steps": x["decode_steps"]} for x in d],
        leader_launches={"flash": leader[0], "paged": leader[1]},
        rank_weight_bytes=[x["weight_bytes"] for x in st1],
        follower_exit_codes=follower_rc, streams=got,
        worst_margin=[max(x) for x in margins],
        margin_limit=TP_MARGIN_LIMIT,
        free_before=free0, free_after=free1, free_after_ref=free2)
    emit({"phase": "tp", "step": "vlm", "nvidia_smi": smi, **row})
    if not (all(len(g) == TP_VLM_TOKENS for g in got)
            and waves > 0 and images == 1
            and _launch_check(d, L, [x["prefill_dispatches"] - waves
                                     for x in d],
                              [x["decode_steps"] for x in d])
            and all(x["prefill_dispatches"] > waves and x["decode_steps"]
                    for x in d)
            and leader == (d[0]["flash_launches"], d[0]["paged_launches"])
            and follower_rc == [0]
            and free1 >= free0 - TP_FREE_SLACK
            and max(row["worst_margin"]) <= TP_MARGIN_LIMIT):
        raise AssertionError(f"tp vlm: {row}")
    return dict(row, flash_launches=leader[0], paged_launches=leader[1])


def tp_swap_step(torch, att, smi: str) -> dict:
    """(f) Weight swaps at tp=2: a pair of Llama-3-8B width cut to
    TP_SWAP_LAYERS layers (seeded, from a config-only directory) with a
    host tier swaps A -> B -> A in place: each sibling's cut drawn by
    every rank into its own host cache (``swap_prefetch`` frames), a
    shape-mismatch refusal that sends no frame and keeps A, then per swap
    a ``swap_check`` frame (every rank's cut resident, one all-reduce) and
    a ``swap`` frame (every rank overwrites its shard where it lies).
    Then one cold reload to B (``cli.worker.reload_engine``, the
    worker's typed fallback): the pair's ``shutdown`` frame, its follower
    exits 0, and a new rank group serves B. Every stream within
    TP_MARGIN_LIMIT of a tp=1 engine's teacher-forced top logit on its
    seed; each rank's swap bytes and seconds; both kernels' launches on
    each rank."""
    import dataclasses
    import types

    import numpy as np

    from dynamo_tpu_torch.cli.worker import (group_starter, reload_engine,
                                             tp_engine)
    from dynamo_tpu_torch.fleet.mobility import SwapError
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.models import llama

    hf = dict(CKPT_HF, num_hidden_layers=TP_SWAP_LAYERS,
              architectures=["LlamaForCausalLM"], model_type="llama")
    path = _write_config("tp_swap", hf)
    card = ModelDeploymentCard.resolve(path, "llama3-8b-4l")
    card.kv_block_size = ENGINE_ARGS["page_size"]
    extra = {k: v for k, v in ENGINE_ARGS.items() if k != "preset"}
    extra.update(host_cache_blocks=32, device=DEVICE)
    prompt = np.random.default_rng(TP_SEED + 4).integers(
        1, hf["vocab_size"], TP_SWAP_PROMPT).tolist()

    def greedy(eng):
        return _run(_greedy_streams(eng, [prompt], TP_SWAP_TOKENS))[0]

    free0 = _card_free(torch)
    t0 = time.perf_counter()
    eng = tp_engine(_tp_layout(), card, extra, model_path=path,
                    kv_block_size=card.kv_block_size)
    new = None
    streams, outs = {}, {}
    try:
        init_s = time.perf_counter() - t0
        core = eng.core
        L = core.cfg.model.num_layers
        old_ranks = eng.plane.ranks
        cfg_a = dataclasses.replace(core.cfg, tp=1, mesh=None,
                                    params_path=None)
        cfg_b = dataclasses.replace(cfg_a, seed=TP_SWAP_SEED)
        kinds = _counted_kinds(core)
        ptrs = {k: v.data_ptr() for k, v in core.params["layers"].items()}
        att.flash_attention.launches = 0
        att.paged_attention.launches = 0
        st0 = _settled_rank_stats(core)
        streams["a"] = greedy(eng)
        eng.prefetch_shards(cfg_b)      # every rank stages B's cut
        sent = sum(kinds.values())
        try:
            _run(eng.swap_weights(None, dataclasses.replace(
                cfg_b, max_batch=2 * cfg_b.max_batch)))
            refused = None
        except SwapError as e:
            refused = e.reason
        refused_frames = {k: v for k, v in kinds.items()
                          if k in ("swap_check", "swap")}
        streams["a_after_refusal"] = greedy(eng)
        for name, cfg in (("b", cfg_b), ("a_again", cfg_a)):
            if name == "a_again":
                eng.prefetch_shards(cfg_a)
            t1 = time.perf_counter()
            out = _run(eng.swap_weights(None, cfg))
            outs[name] = dict(out.to_dict(), wall_s=time.perf_counter() - t1)
            streams[name] = greedy(eng)
        st1 = _settled_rank_stats(core)
        leader = (att.flash_attention.launches, att.paged_attention.launches)
        in_place = ptrs == {k: v.data_ptr()
                            for k, v in core.params["layers"].items()}
        shard = [x["weight_bytes"] for x in st1]
        core.dispatch_hook = eng.plane.publisher.hook
        # the cold reload: the pair ends, a new group starts on B
        t1 = time.perf_counter()
        new = reload_engine(eng, dataclasses.replace(cfg_b,
                                                     params_path=path),
                            group_starter(_tp_layout(),
                                          kv_block_size=card.kv_block_size,
                                          engine_args=json.dumps(extra)))
        reload_s = time.perf_counter() - t1
        old_rc = [p.returncode for p in old_ranks.procs]
        streams["reload_b"] = greedy(new)
        new_ranks = new.plane.ranks
    finally:
        if new is not None:
            new.shutdown()
        eng.shutdown()
    new_rc = [p.returncode for p in new_ranks.procs]
    eng = new = core = None
    free1 = _card_free(torch)
    d = _rank_delta(st0, st1)
    margins = {}
    for seed, names in ((cfg_a.seed, ("a", "a_after_refusal", "a_again")),
                        (TP_SWAP_SEED, ("b", "reload_b"))):
        ref = types.SimpleNamespace(params=llama.init_params(
            cfg_a.model, torch.Generator(device=DEVICE).manual_seed(seed),
            torch.device(DEVICE)), device=torch.device(DEVICE),
            page_size=cfg_a.page_size, cfg=cfg_a)
        for n in names:
            margins[n] = max(_top_margins(torch, _stream_logits(
                torch, ref, prompt, streams[n]), streams[n]))
        del ref
    free2 = _card_free(torch)
    row = dict(
        layers=L, reduced=f"depth 32 -> {L}", init_s=init_s,
        refused=refused,
        refused_frames=refused_frames, frames_before_refusal=sent,
        swaps=outs, in_place=in_place, reload_s=reload_s,
        rank_swap_bytes=[x["swap_bytes"] for x in d],
        rank_swap_s=[x["swap_seconds"] for x in d],
        rank_shard_bytes=shard,
        rank_launches=[{"flash": x["flash_launches"],
                        "paged": x["paged_launches"]} for x in d],
        rank_dispatches=[{"prefill": x["prefill_dispatches"],
                          "decode_steps": x["decode_steps"]} for x in d],
        leader_launches={"flash": leader[0], "paged": leader[1]},
        frames={k: v for k, v in kinds.items() if k.startswith("swap")},
        follower_exit_codes={"pair": old_rc, "reloaded": new_rc},
        streams_differ=streams["a"] != streams["b"],
        worst_margin=margins, margin_limit=TP_MARGIN_LIMIT,
        free_before=free0, free_after=free1, free_after_refs=free2)
    emit({"phase": "tp", "step": "swap", "nvidia_smi": smi, **row})
    if not (refused == "shape_mismatch" and not refused_frames
            and in_place and row["streams_differ"]
            and all(len(v) == TP_SWAP_TOKENS for v in streams.values())
            and row["frames"] == {"swap_prefetch": 2, "swap_check": 2,
                                  "swap": 2}
            and row["rank_swap_bytes"] == [2 * x for x in shard]
            and all(s > 0 for s in row["rank_swap_s"])
            and _launch_check(d, L, [x["prefill_dispatches"] for x in d],
                              [x["decode_steps"] for x in d])
            and all(x["prefill_dispatches"] and x["decode_steps"]
                    for x in d)
            and leader == (d[0]["flash_launches"], d[0]["paged_launches"])
            and old_rc == [0] and new_rc == [0]
            and free1 >= free0 - TP_FREE_SLACK
            and max(margins.values()) <= TP_MARGIN_LIMIT):
        raise AssertionError(f"tp swap: {row}")
    return dict(row, flash_launches=leader[0], paged_launches=leader[1])


def tp_kill_step(torch, engine_args: dict) -> dict:
    """``cli.run --tensor-parallel-size 2`` as a process of its own: it
    serves, its follower is SIGKILLed, the leader must exit non-zero
    within TP_EXIT_S and the card's free bytes come back to what they were
    before it started within TP_FREE_S."""
    import gc
    import signal

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    free0 = torch.cuda.mem_get_info()[0]
    port = _free_port()
    log = open(os.path.join(ROOT, "build", "dynamo_tpu_torch",
                            "tp_kill.log"), "w")
    t0 = time.perf_counter()
    leader = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.cli.run", "in=http",
         "out=torch", "--model-name", PRESET, "--http-port", str(port),
         "--http-host", "127.0.0.1", *TP_ARGS, "--extra-engine-args",
         json.dumps(engine_args)], cwd=ROOT, stdout=log,
        stderr=subprocess.STDOUT, env=dict(os.environ, PYTHONPATH=ROOT))
    try:
        res: dict = {}
        deadline = time.monotonic() + 150
        while True:
            if leader.poll() is not None:
                raise AssertionError(f"tp leader exited {leader.returncode} "
                                     f"during bring-up")
            try:
                http_post(port, "/v1/completions",
                          {"model": PRESET, "prompt": [11, 12, 13],
                           "max_tokens": 4}, res, "warm")
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise AssertionError("tp leader did not serve within "
                                         "150 s")
                time.sleep(0.5)
        up_s = time.perf_counter() - t0
        if res["warm"]["usage"]["completion_tokens"] != 4:
            raise AssertionError(f"tp leader's answer: {res['warm']}")
        followers = _children(leader.pid)
        if len(followers) != 1:
            raise AssertionError(f"tp leader's children: {followers}")
        free_up = torch.cuda.mem_get_info()[0]
        os.kill(next(iter(followers)), signal.SIGKILL)
        t1 = time.perf_counter()
        try:
            rc = leader.wait(TP_EXIT_S)
        except subprocess.TimeoutExpired:
            raise AssertionError(f"tp leader still up {TP_EXIT_S} s after "
                                 f"its follower's SIGKILL")
        exit_s = time.perf_counter() - t1
        while torch.cuda.mem_get_info()[0] < free0 \
                and time.perf_counter() - t1 < TP_FREE_S:
            time.sleep(0.2)
        free1 = torch.cuda.mem_get_info()[0]
    finally:
        if leader.poll() is None:
            leader.kill()
            leader.wait()
        for pid in _children(leader.pid):
            os.kill(pid, signal.SIGKILL)
        log.close()
    row = dict(bring_up_s=up_s, leader_exit_code=rc, leader_exit_s=exit_s,
               free_before=free0, free_serving=free_up, free_after=free1,
               free_back_s=time.perf_counter() - t1)
    emit({"phase": "tp", "step": "follower_killed", **row})
    if rc == 0 or free1 < free0:
        raise AssertionError(f"tp follower death: {row}")
    return row


def tp_phase(torch, att, smi: str, params) -> dict:
    """Tensor parallelism on one card: ``cli.run in=http out=torch
    --tensor-parallel-size 2`` serving Llama-3-8B (full width and depth,
    random bf16 weights from the seed, the serve phase's engine arguments
    with a paging lane: prefix reuse on, a 128-block host tier and the
    kvpage phase's 20-page lane, ``TP_ENGINE``), both ranks on
    cuda:0 over gloo: the leader in this process, its follower a
    ``cli.worker`` process replaying its dispatch frames. NCCL would
    refuse two ranks on one GPU; NCCL across two cards is not run here.

    An HTTP burst and greedy requests through the engine; each rank's
    counters (gathered by the leader between dispatches) must show flash
    launches one a layer a prefill dispatch and paged ones one a layer a
    decode step, the same dispatches on both ranks, and the worker's
    ``dyn_kernel_launches_total`` both kernels for both ranks. The greedy
    streams are held to tp=1 (the serve phase's weights, this process) by
    teacher-forced logits: every token within TP_MARGIN_LIMIT of its step's
    top logit, which the streams shifted by one token must break (bf16
    sums the ranks' partial products in another order than one card, so
    token identity is not the bar). Each rank's weight bytes and peak
    memory; the follower exits 0 at the leader's orderly shutdown. On the
    same pair :func:`tp_restore_step` (a host-tier restore),
    :func:`tp_disagg_step` (disagg both ways with tp=1) and
    :func:`tp_kvpage_step` (a 4096-token prompt through the paging lane);
    then :func:`tp_spec_step` (n-gram spec on a second pair),
    :func:`tp_vlm_step` (Gemma3-4B image and text requests on a third),
    :func:`tp_swap_step` (hot swaps and a cold reload on a fourth, depth
    cut) and :func:`tp_kill_step`. Each pair's follower exits 0 and the
    card's memory comes back before the next starts. Both ranks
    time-slice one card: no tokens/s of this phase says anything about
    tensor parallelism."""
    import asyncio
    import types

    import numpy as np

    from dynamo_tpu_torch.cli.worker import engine_counters
    from dynamo_tpu_torch.engine.engine import TorchEngineConfig
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    # this process holds the serve phase's weights: the leader's own peak
    # is its process's above them
    base = torch.cuda.memory_allocated()
    rng = np.random.default_rng(TP_SEED)
    prompts = [[int(t) for t in rng.integers(1, 256, n)] for n in TP_PROMPTS]
    reqs = {
        "c0": ("/v1/completions", {"model": PRESET, "prompt": prompts[0],
                                   "max_tokens": 16}),
        "c1": ("/v1/completions", {"model": PRESET, "prompt": prompts[1],
                                   "max_tokens": 16, "stream": True}),
        "chat": ("/v1/chat/completions", {
            "model": PRESET, "max_tokens": 16,
            "messages": [{"role": "user", "content": "Say hi twice."}]}),
    }
    # teacher-forced tp=1 logits on this process's copy of the weights
    ref = types.SimpleNamespace(
        params=params, device=torch.device(DEVICE),
        page_size=ENGINE_ARGS["page_size"],
        cfg=TorchEngineConfig.from_card(
            ModelDeploymentCard.synthetic(PRESET), **ENGINE_ARGS,
            device=DEVICE))

    def margins(prompt, stream):
        lg = _stream_logits(torch, ref, prompt, stream)
        idx = torch.arange(len(stream), device=lg.device)
        chosen = lg[idx, torch.tensor(stream, device=lg.device)]
        return (lg.max(-1).values - chosen).tolist()

    with served(["--model-name", PRESET, *TP_ARGS, "--extra-engine-args",
                 json.dumps(TP_ENGINE)]) as (eng, loop, port, _, init_s,
                                             _m):
        core = eng.core
        if core.tp != 2 or core.k_pool.shape[1] \
                != core.cfg.model.num_kv_heads // 2 \
                or not core.enable_prefix_reuse or core.tiered is None \
                or core.kvpager is None:
            raise AssertionError(f"tp engine: tp={core.tp}, pool "
                                 f"{tuple(core.k_pool.shape)}")
        ranks = eng.plane.ranks
        L = core.cfg.model.num_layers
        # the leader's counts from 0; the follower's read as differences
        att.flash_attention.launches = 0
        att.paged_attention.launches = 0
        st0 = _settled_rank_stats(core)
        b = burst(att, eng, port, reqs, "tp")
        t0 = time.perf_counter()
        got = asyncio.run_coroutine_threadsafe(
            _greedy_streams(eng, prompts, TP_TOKENS), loop).result(600)
        greedy_s = time.perf_counter() - t0
        st1 = _settled_rank_stats(core)
        counters = engine_counters(core, 0)
        restore = tp_restore_step(core, eng, loop, margins, smi)
        disagg = tp_disagg_step(torch, core, eng, loop, params, margins, smi)
        kvpage = tp_kvpage_step(torch, att, core, eng, loop, params,
                                margins, smi)
    follower_rc = [p.returncode for p in ranks.procs]
    # the leader's engine is shut down: let its tensors go before the kill
    # step measures the card's free bytes
    eng = core = None
    delta = [{k: b1[k] - a1[k] for k in a1} for a1, b1 in zip(st0, st1)]
    series = counters["dyn_kernel_launches_total"]["series"]
    per_rank_kernels = {w: {k: v for (ww, k), v in
                            ((tuple(key.split("\x1f")), val)
                             for key, val in series.items()) if ww == w}
                        for w in ("0", "0/rank1")}
    sound = [margins(p, g) for p, g in zip(prompts, got)]
    fault = [margins(p, g[1:] + g[:1]) for p, g in zip(prompts, got)]
    row = dict(
        init_s=init_s, greedy_s=greedy_s, burst_wall_s=b["wall_s"],
        prefill_dispatches=delta[0]["prefill_dispatches"],
        decode_steps=delta[0]["decode_steps"],
        rank_launches=[{"flash": d["flash_launches"],
                        "paged": d["paged_launches"]} for d in delta],
        rank_dispatches=[{"prefill": d["prefill_dispatches"],
                          "decode": d["decode_dispatches"],
                          "decode_steps": d["decode_steps"]} for d in delta],
        dyn_kernel_launches_total=per_rank_kernels,
        rank_weight_bytes=[s["weight_bytes"] for s in st1],
        rank_peak_bytes=[st1[0]["device_memory_peak_bytes"] - base]
        + [s["device_memory_peak_bytes"] for s in st1[1:]],
        leader_process_base_bytes=base,
        follower_exit_codes=follower_rc, margin_limit=TP_MARGIN_LIMIT,
        worst_margin=max(max(m) for m in sound),
        fault_worst_margin=[max(m) for m in fault], streams=got,
        margins=sound, note="two ranks time-slice one card over gloo: "
        "the times here say nothing about tensor parallelism")
    emit({"phase": "tp", "step": "serve", "nvidia_smi": smi, **row})
    ok = (all(d["flash_launches"] == L * d["prefill_dispatches"] > 0
              and d["paged_launches"] == L * d["decode_steps"] > 0
              for d in delta)
          and row["rank_dispatches"][0] == row["rank_dispatches"][1]
          and all(v.get("flash_attention", 0) > 0
                  and v.get("paged_attention", 0) > 0
                  for v in per_rank_kernels.values())
          and follower_rc == [0]
          and row["worst_margin"] <= TP_MARGIN_LIMIT
          and all(w > TP_MARGIN_LIMIT for w in row["fault_worst_margin"]))
    if not ok:
        raise AssertionError(f"tp phase: {row}")
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    row.update(restore=restore, disagg=disagg, kvpage=kvpage,
               spec=tp_spec_step(torch, att, margins, smi))
    gc.collect()
    torch.cuda.empty_cache()
    row["vlm"] = tp_vlm_step(torch, att, smi)
    row["swap"] = tp_swap_step(torch, att, smi)
    row["kill"] = tp_kill_step(torch, ENGINE_ARGS)
    row["phase_s"] = time.perf_counter() - t_phase
    emit({"phase": "tp", "step": "summary", "phase_s": row["phase_s"]})
    if row["phase_s"] > TP_BUDGET_S:
        raise AssertionError(f"tp phase took {row['phase_s']:.0f} s, over "
                             f"its {TP_BUDGET_S} s")
    return dict(row, flash_launches=delta[0]["flash_launches"],
                paged_launches=delta[0]["paged_launches"],
                spec_rank_flash=[r["flash"]
                                 for r in row["spec"]["rank_launches"]])


def main() -> int:
    import gc

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from dynamo_tpu_torch.ops import _build
    from dynamo_tpu_torch.ops import attention as att

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    emit({"phase": "device", "name": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    from concurrent.futures import ThreadPoolExecutor

    from dynamo_tpu_torch.native import _build as native_build

    def timed_native():
        t = time.perf_counter()
        built = native_build.build_all()
        return {k: os.path.basename(v) for k, v in built.items()}, \
            time.perf_counter() - t

    # the host helpers (g++, one process each) build beside the kernels
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        native = pool.submit(timed_native)
        _build.build_all()
        native, native_s = native.result()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "native": native, "native_seconds": native_s,
          "ptxas": {k: _build.ptxas_instances(v)
                    for k, v in _build.build_log.items()}})

    flash = flash_case(torch, att, "llama3-8b",
                       *flash_inputs(torch, 2, 512, 1024, 32, 8, 128))
    flash_case(torch, att, "gemma2-9b-softcap-window",
               *flash_inputs(torch, 2, 512, 1024, 16, 8, 256),
               scale=1 / 16.0, softcap=50.0, window=256, library=False)
    # the first 512-token chunk of one prompt (a prefill's common shape)
    flash_case(torch, att, "llama3-8b-first-chunk",
               *flash_inputs(torch, 1, 512, 512, 32, 8, 128, ragged=False))
    # a ragged batched dispatch in the serve path's own layout
    flash_case(torch, att, "llama3-8b-serve-layout",
               *serve_layout_inputs(torch))
    # the chunk after a restored prefix: the last 24 of 1496 positions
    flash_case(torch, att, "llama3-8b-prefix-hit",
               *flash_inputs(torch, 1, 24, 1496, 32, 8, 128, ragged=False))
    # the CLI's default model, tiny-byte: Hq=4, Hkv=2, Dh=16
    flash16 = flash_case(torch, att, "tiny-byte",
                         *flash_inputs(torch, 2, 512, 1024, 4, 2, 16))
    # speculative verify dispatches: K+1 = 5 and 2 query positions a lane
    # over eight ragged contexts up to 2112 tokens
    verify5 = flash_case(torch, att, "llama3-8b-verify",
                         *verify_inputs(torch, 5))
    verify2 = flash_case(torch, att, "llama3-8b-verify-t2",
                         *verify_inputs(torch, 2))
    # the llama-3.2-1b draft's sync chunk (Dh=64): the reuse prompt's
    # second 512-token chunk
    flash64 = flash_case(torch, att, "llama-3.2-1b",
                         *flash_inputs(torch, 1, 512, 1024, 32, 8, 64,
                                       ragged=False))
    # Gemma3-4B's text chunks (the vlm phase): 8 q / 4 kv heads at Dh 256,
    # the sliding layers' 1024-token window, scale 1/sqrt(256)
    flash256 = flash_case(torch, att, "gemma3-4b-window",
                          *flash_inputs(torch, 2, 512, 2048, 8, 4, 256),
                          scale=1 / 16.0, window=1024)
    from dynamo_tpu_torch.ops.paged_probe import PAGED_CASES

    paged_rows = {name: paged_case(torch, att, name, **kw)
                  for name, kw in PAGED_CASES.items()}
    paged, paged16 = paged_rows["llama3-8b"], paged_rows["tiny-byte"]
    paged64 = paged_rows["llama-3.2-1b-draft"]
    paged256 = paged_rows["gemma3-4b"]
    # one tp=2 rank's heads at Llama-3-8B: Hq 32/2, Hkv 8/2 (the tp phase)
    flash_tp = flash_case(torch, att, "llama3-8b-tp2-rank",
                          *flash_inputs(torch, 2, 512, 1024, 16, 4, 128))
    paged_tp = paged_case(torch, att, "llama3-8b-tp2-rank", Hq=16, Hkv=4)
    # one tp=2 rank's heads at Gemma3-4B: Hq 8/2, Hkv 4/2 at Dh 256 (the tp
    # phase's vlm step)
    flash_vlm_tp = flash_case(torch, att, "gemma3-4b-tp2-rank",
                              *flash_inputs(torch, 2, 512, 2048, 4, 2, 256),
                              scale=1 / 16.0, window=1024)
    paged_vlm_tp = paged_case(torch, att, "gemma3-4b-tp2-rank", window=1024,
                              Hq=4, Hkv=2, Dh=256)

    serve, _, params = serve_phase(torch, att, smi)
    default = serve_default_phase(torch, att, smi)
    ckpt = checkpoint_phase(torch, att, smi)
    fleet = fleet_phase(torch, smi, serve["lone_stream"])
    disagg = disagg_phase(torch, smi, serve)
    cluster = cluster_phase(torch, smi, serve, params)
    spec = spec_phase(torch, att, smi, params)
    kvpage = kvpage_phase(torch, att, smi, params)
    fplane = fleet_plane_phase(torch, att, smi, params, serve)
    graph = graph_phase(torch, smi, serve)
    deploy = deploy_phase(torch, smi, serve)
    gc.collect()
    torch.cuda.empty_cache()
    tp = tp_phase(torch, att, smi, params)
    del params      # the HTTP engine draws the same weights from the seed
    # the phases' engines sit in reference cycles with their weights:
    # collect them before the next engine draws its own
    gc.collect()
    torch.cuda.empty_cache()
    spec["http"] = spec_http_phase(torch, smi)
    emit({"phase": "spec", "mode": "summary", "phase_s": spec["phase_s"]})
    ngram, draft = spec["ngram"], spec["draft"]
    vlm = vlm_phase(torch, att, smi)
    moe = moe_phase(torch, att, smi)

    src = "dynamo_tpu_torch/ops/csrc/"
    kernels = [
        dict(name="flash_attention", route="cuda",
             source=src + "flash_attention.cu",
             replaces="dynamo_tpu/ops/attention.py:166",
             launches=serve["flash_launches"],
             reuse_launches=sum(r["flash_launches"]
                                for r in serve["reuse"]["runs"]),
             lint_launches=serve["lint"]["launches"]["flash"],
             checkpoint_launches=ckpt["flash_launches"],
             fleet_launches=fleet["flash_launches"],
             disagg_launches=disagg["flash_launches"],
             cluster_launches=cluster["flash_launches"],
             spec_launches=ngram["spec_flash_launches"],
             draft_launches=draft["spec_flash_launches"],
             moe_launches=moe["flash_launches"],
             kvpage_launches=sum(kvpage["launches"]["flash"].values()),
             fleet_plane_launches=fplane["flash_launches"],
             graph_launches=graph["flash_launches"],
             deploy_launches=deploy["flash_launches"],
             tp_launches=tp["flash_launches"],
             verify_ms={"t5": verify5["ms"], "t2": verify2["ms"]},
             verify_bound_frac={"t5": verify5["bound_frac"],
                                "t2": verify2["bound_frac"]},
             max_abs_err=flash["max_abs_err"], ms=flash["ms"],
             plain_ms=flash["plain_ms"], bound_ms=flash["bound_ms"],
             bound_by=flash["bound_by"], bound_frac=flash["bound_frac"],
             library_ms=flash["library_ms"]),
        dict(name="paged_attention", route="cuda",
             source=src + "paged_attention.cu",
             replaces="dynamo_tpu/ops/attention.py:400",
             also_replaces="dynamo_tpu/ops/attention.py:552",
             launches=serve["paged_launches"], splits=paged["splits"],
             reuse_launches=sum(r["paged_launches"]
                                for r in serve["reuse"]["runs"]),
             lint_launches=serve["lint"]["launches"]["paged"],
             checkpoint_launches=ckpt["paged_launches"],
             fleet_launches=fleet["paged_launches"],
             disagg_launches=disagg["paged_launches"],
             cluster_launches=cluster["paged_launches"],
             spec_launches=ngram["spec_paged_launches"],
             draft_launches=draft["spec_paged_launches"],
             moe_launches=moe["paged_launches"],
             kvpage_launches=sum(kvpage["launches"]["paged"].values()),
             fleet_plane_launches=fplane["paged_launches"],
             graph_launches=graph["paged_launches"],
             deploy_launches=deploy["paged_launches"],
             tp_launches=tp["paged_launches"],
             max_abs_err=paged["max_abs_err"], ms=paged["ms"],
             plain_ms=paged["plain_ms"], bound_ms=paged["bound_ms"],
             bound_by=paged["bound_by"], bound_frac=paged["bound_frac"],
             library_ms=None),
        # the Dh=16 instances, on the CLI default model's path
        dict(name="flash_attention_dh16", route="cuda",
             source=src + "flash_attention.cu",
             replaces="dynamo_tpu/ops/attention.py:166",
             launches=default["flash_launches"],
             max_abs_err=flash16["max_abs_err"], ms=flash16["ms"],
             plain_ms=flash16["plain_ms"], bound_ms=flash16["bound_ms"],
             bound_by=flash16["bound_by"], bound_frac=flash16["bound_frac"],
             library_ms=flash16["library_ms"]),
        dict(name="paged_attention_dh16", route="cuda",
             source=src + "paged_attention.cu",
             replaces="dynamo_tpu/ops/attention.py:400",
             also_replaces="dynamo_tpu/ops/attention.py:552",
             launches=default["paged_launches"], splits=paged16["splits"],
             max_abs_err=paged16["max_abs_err"], ms=paged16["ms"],
             plain_ms=paged16["plain_ms"], bound_ms=paged16["bound_ms"],
             bound_by=paged16["bound_by"], bound_frac=paged16["bound_frac"],
             library_ms=None),
        # the Dh=64 instances, on the llama-3.2-1b draft's path
        dict(name="flash_attention_dh64", route="cuda",
             source=src + "flash_attention.cu",
             replaces="dynamo_tpu/ops/attention.py:166",
             launches=draft["draft_flash_launches"],
             max_abs_err=flash64["max_abs_err"], ms=flash64["ms"],
             plain_ms=flash64["plain_ms"], bound_ms=flash64["bound_ms"],
             bound_by=flash64["bound_by"], bound_frac=flash64["bound_frac"],
             library_ms=flash64["library_ms"]),
        dict(name="paged_attention_dh64", route="cuda",
             source=src + "paged_attention.cu",
             replaces="dynamo_tpu/ops/attention.py:400",
             also_replaces="dynamo_tpu/ops/attention.py:552",
             launches=draft["draft_paged_launches"], splits=paged64["splits"],
             max_abs_err=paged64["max_abs_err"], ms=paged64["ms"],
             plain_ms=paged64["plain_ms"], bound_ms=paged64["bound_ms"],
             bound_by=paged64["bound_by"], bound_frac=paged64["bound_frac"],
             library_ms=None),
        # the Dh=256 instances, on Gemma3-4B's path (the vlm phase: text
        # waves and decode; image waves take the dense path)
        dict(name="flash_attention_dh256", route="cuda",
             source=src + "flash_attention.cu",
             replaces="dynamo_tpu/ops/attention.py:166",
             launches=vlm["flash_launches"],
             vlm_launches=vlm["flash_launches"],
             vlm_text_waves=vlm["text_waves"],
             vlm_image_waves=vlm["image_waves"],
             max_abs_err=flash256["max_abs_err"], ms=flash256["ms"],
             plain_ms=flash256["plain_ms"], bound_ms=flash256["bound_ms"],
             bound_by=flash256["bound_by"],
             bound_frac=flash256["bound_frac"],
             library_ms=flash256["library_ms"]),
        dict(name="paged_attention_dh256", route="cuda",
             source=src + "paged_attention.cu",
             replaces="dynamo_tpu/ops/attention.py:400",
             also_replaces="dynamo_tpu/ops/attention.py:552",
             launches=vlm["paged_launches"],
             vlm_launches=vlm["paged_launches"],
             splits=paged256["splits"],
             max_abs_err=paged256["max_abs_err"], ms=paged256["ms"],
             plain_ms=paged256["plain_ms"], bound_ms=paged256["bound_ms"],
             bound_by=paged256["bound_by"],
             bound_frac=paged256["bound_frac"], library_ms=None),
        # one tp=2 rank's instances (Hq=16, Hkv=4 at Dh=128): the tp
        # phase's leader's launches; its follower's under rank_launches
        dict(name="flash_attention_tp2_rank", route="cuda",
             source=src + "flash_attention.cu",
             replaces="dynamo_tpu/ops/attention.py:166",
             launches=tp["flash_launches"],
             rank_launches=[r["flash"] for r in tp["rank_launches"]],
             spec_rank_launches=tp["spec_rank_flash"],
             kvpage_rank_launches=[r["flash"] for r in
                                   tp["kvpage"]["rank_launches"]],
             swap_rank_launches=[r["flash"] for r in
                                 tp["swap"]["rank_launches"]],
             max_abs_err=flash_tp["max_abs_err"], ms=flash_tp["ms"],
             plain_ms=flash_tp["plain_ms"], bound_ms=flash_tp["bound_ms"],
             bound_by=flash_tp["bound_by"],
             bound_frac=flash_tp["bound_frac"],
             library_ms=flash_tp["library_ms"]),
        dict(name="paged_attention_tp2_rank", route="cuda",
             source=src + "paged_attention.cu",
             replaces="dynamo_tpu/ops/attention.py:400",
             also_replaces="dynamo_tpu/ops/attention.py:552",
             launches=tp["paged_launches"],
             rank_launches=[r["paged"] for r in tp["rank_launches"]],
             kvpage_rank_launches=[r["paged"] for r in
                                   tp["kvpage"]["rank_launches"]],
             swap_rank_launches=[r["paged"] for r in
                                 tp["swap"]["rank_launches"]],
             splits=paged_tp["splits"],
             max_abs_err=paged_tp["max_abs_err"], ms=paged_tp["ms"],
             plain_ms=paged_tp["plain_ms"], bound_ms=paged_tp["bound_ms"],
             bound_by=paged_tp["bound_by"],
             bound_frac=paged_tp["bound_frac"], library_ms=None),
        # one tp=2 rank's Dh=256 instances (Gemma3-4B, Hq=4, Hkv=2): the tp
        # phase's vlm step (text waves and decode; image waves are dense)
        dict(name="flash_attention_gemma3_tp2_rank", route="cuda",
             source=src + "flash_attention.cu",
             replaces="dynamo_tpu/ops/attention.py:166",
             launches=tp["vlm"]["flash_launches"],
             rank_launches=[r["flash"] for r in tp["vlm"]["rank_launches"]],
             max_abs_err=flash_vlm_tp["max_abs_err"], ms=flash_vlm_tp["ms"],
             plain_ms=flash_vlm_tp["plain_ms"],
             bound_ms=flash_vlm_tp["bound_ms"],
             bound_by=flash_vlm_tp["bound_by"],
             bound_frac=flash_vlm_tp["bound_frac"],
             library_ms=flash_vlm_tp["library_ms"]),
        dict(name="paged_attention_gemma3_tp2_rank", route="cuda",
             source=src + "paged_attention.cu",
             replaces="dynamo_tpu/ops/attention.py:400",
             also_replaces="dynamo_tpu/ops/attention.py:552",
             launches=tp["vlm"]["paged_launches"],
             rank_launches=[r["paged"] for r in tp["vlm"]["rank_launches"]],
             splits=paged_vlm_tp["splits"],
             max_abs_err=paged_vlm_tp["max_abs_err"],
             ms=paged_vlm_tp["ms"], plain_ms=paged_vlm_tp["plain_ms"],
             bound_ms=paged_vlm_tp["bound_ms"],
             bound_by=paged_vlm_tp["bound_by"],
             bound_frac=paged_vlm_tp["bound_frac"], library_ms=None),
    ]
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
