#!/usr/bin/env python3
"""On-card smoke of the PyTorch/H100 port (``dynamo_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order, each printing one JSON line; any failure exits non-zero
with a traceback and prints no result:

1. device    — the card's name and power limit (nvidia-smi).
2. build     — builds the CUDA kernels from ``dynamo_tpu_torch/ops/csrc``;
               ptxas's registers and spills for each kernel instance.
3. kernels   — every kernel of the serving path against its plain torch
               version on the card, in bf16, at Llama-3-8B (and Gemma2-9B)
               head shapes, the flash kernel also on a ragged dispatch in
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
7. chain     — on an engine sharing the served weights, one chained
               steady-state decode enqueue under
               ``torch.cuda.set_sync_debug_mode("error")``: no host sync,
               with the stage metrics, heartbeats and goodput accounting on.
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
            last = chunks[-1]
            results[key] = dict(status=status, done=done, chunks=len(chunks),
                                rid=rid, usage=last.get("usage"),
                                finish=last["choices"][0].get("finish_reason"),
                                ttft_s=stamps[0], last_s=stamps[-1])
        else:
            out = json.loads(resp.read())
            results[key] = dict(status=status, rid=rid,
                                usage=out.get("usage"),
                                finish=out["choices"][0].get("finish_reason"),
                                seconds=time.perf_counter() - t0)


@contextlib.contextmanager
def served(argv, env=None):
    """The CLI's torch engine (``cli.run`` arguments ``argv``; ``env`` set
    while it is built) behind the OpenAI HTTP service on a free port, its
    loop on a thread of its own: yields (TorchEngine, loop, port, model id,
    the engine's construction seconds, the ModelManager); stops both
    after."""
    import asyncio

    import torch

    from dynamo_tpu_torch.cli.run import make_card, make_engines, parse_args
    from dynamo_tpu_torch.llm.http_service import (HttpService, ModelManager,
                                                   ServedModel)

    t0 = time.perf_counter()
    args = parse_args(["in=http", "out=torch", "--device", DEVICE, *argv])
    card = make_card(args)
    saved = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    try:
        chat, comp, core = make_engines(args, card)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    loop = asyncio.new_event_loop()
    manager = ModelManager()
    manager.add(ServedModel(card, chat, comp))
    svc = HttpService(manager, host="127.0.0.1", port=0)
    port = loop.run_until_complete(svc.start())
    server = threading.Thread(target=loop.run_forever, name="http",
                              daemon=True)
    server.start()
    try:
        http_post(port, "/v1/completions",
                  {"model": card.name, "prompt": "warm up", "max_tokens": 2},
                  {}, "warm")
        yield core, loop, port, card.name, init_s, manager
    finally:
        asyncio.run_coroutine_threadsafe(svc.stop(), loop).result(60)
        loop.call_soon_threadsafe(loop.stop)
        server.join(timeout=60)
        loop.close()
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


def serve_phase(torch, att, smi: str):
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
        row["chain"] = chain_sync_phase(torch, c)
        launch["after_phases"] = launch_us(torch)
        # read the trace only now: loading it builds millions of Python
        # objects, which must not overlap a timed phase
        row["profile_trace"] = profile_trace_check(core, launch)
    return row, ref


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
    out = {}
    for line in text.decode().splitlines():
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
    """One greedy request straight through the engine's AsyncEngine entry
    point on the server's loop: (tokens, kv_prefix_hit_tokens, TTFT s,
    total s)."""
    import asyncio

    from dynamo_tpu_torch.llm.protocols.common import (BackendInput,
                                                       FinishReason,
                                                       StopConditions)
    from dynamo_tpu_torch.runtime.engine import Context

    async def go():
        toks, hit, ttft = [], None, None
        t0 = time.perf_counter()
        async for o in engine.generate(BackendInput(
                token_ids=prompt, stop=StopConditions(
                    max_tokens=REUSE_TOKENS, ignore_eos=True)), Context()):
            if o.finish_reason == FinishReason.ERROR:
                raise AssertionError(f"reuse request failed: {o.error}")
            if ttft is None:
                ttft = time.perf_counter() - t0
                hit = o.kv_prefix_hit_tokens
            toks.extend(o.token_ids)
        return toks, hit, ttft, time.perf_counter() - t0

    return asyncio.run_coroutine_threadsafe(go(), loop).result(600)


def _prefix_logits(torch, core, prompt, warm_tokens: int):
    """Last-position logits of ``prompt`` through ``llama.forward`` in a
    scratch pool: a cold chunked prefill (chunks of the engine's
    ``prefill_chunk``), then a warm prefill of only the last
    ``warm_tokens`` over the cold pass's cached pages."""
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
            attn_impl="flash",
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


def reuse_phase(torch, att, engine, loop) -> dict:
    """KV block reuse on the serving engine (idle between requests)."""
    import numpy as np

    from dynamo_tpu_torch.llm.tokens import compute_seq_hashes

    core = engine.core
    page = core.page_size
    L = core.cfg.model.num_layers
    cs, tiers = core.copy_stream, core.tiered
    vocab = core.cfg.model.vocab_size
    prompt = np.random.default_rng(REUSE_SEED).integers(
        0, vocab, REUSE_PROMPT).tolist()
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

    _, cold = run("cold")
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
    return dict(row, runs=[cold, warm, host, again], flush=flush)


# ---------------------------------------------------------------------------
# phase 7: a chained decode enqueue makes no host sync
# ---------------------------------------------------------------------------

def chain_sync_phase(torch, served) -> dict:
    """On a second engine core that shares the served weights (the serving
    core belongs to its engine thread), two requests decode until the next
    dispatch can chain off the one in flight; that enqueue then runs under
    ``torch.cuda.set_sync_debug_mode("error")``, where any host sync (a
    pageable copy, ``.item()``, a stream sync) raises."""
    import dataclasses

    from dynamo_tpu_torch.engine.engine import EngineCore
    from dynamo_tpu_torch.llm.protocols.common import (BackendInput,
                                                       StopConditions)

    cfg = dataclasses.replace(served.cfg, max_batch=2, num_pages=None,
                              host_cache_blocks=0)
    core = EngineCore(cfg, served.params)
    for sid in ("a", "b"):
        core.submit(sid, BackendInput(
            token_ids=list(range(1, 65)) if sid == "a" else [7] * 40,
            stop=StopConditions(max_tokens=48, ignore_eos=True)))
    for _ in range(20):
        core.step()
        if len(core._inflight) == 1 and core._can_chain():
            break
    else:
        raise AssertionError("the window never became chainable")
    n = core.decode_dispatches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        core._dispatch_decode()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    enqueue_s = time.perf_counter() - t0
    chained = core.decode_dispatches == n + 1 and core._inflight[-1]["chained"]
    tokens = 0
    for _ in range(40):
        tokens += len(core.step())
        if not core.has_work:
            break
    row = dict(phase="chain", sync_debug_mode="error", chained=chained,
               enqueue_s=enqueue_s, decode_steps=core.cfg.decode_steps,
               tokens_after=tokens, drained=not core.has_work,
               pages_free=core.pool.free_pages == core.pool.num_pages - 1)
    emit(row)
    if not (chained and row["drained"] and row["pages_free"]):
        raise AssertionError(f"chained enqueue check failed: {row}")
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


def main() -> int:
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

    t0 = time.perf_counter()
    _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
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
    from dynamo_tpu_torch.ops.paged_probe import PAGED_CASES

    paged_rows = {name: paged_case(torch, att, name, **kw)
                  for name, kw in PAGED_CASES.items()}
    paged, paged16 = paged_rows["llama3-8b"], paged_rows["tiny-byte"]

    serve, _ = serve_phase(torch, att, smi)
    default = serve_default_phase(torch, att, smi)
    ckpt = checkpoint_phase(torch, att, smi)

    src = "dynamo_tpu_torch/ops/csrc/"
    kernels = [
        dict(name="flash_attention", route="cuda",
             source=src + "flash_attention.cu",
             replaces="dynamo_tpu/ops/attention.py:166",
             launches=serve["flash_launches"],
             reuse_launches=sum(r["flash_launches"]
                                for r in serve["reuse"]["runs"]),
             checkpoint_launches=ckpt["flash_launches"],
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
             checkpoint_launches=ckpt["paged_launches"],
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
    ]
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
