"""Single-binary style launcher: ``python -m dynamo_tpu_torch.cli.run in=... out=...``

Input modes:  http | text | batch:<file.jsonl> | none
Output modes: torch | echo_full

``out=torch`` serves a Llama-family model on the torch engine, on the card
unless ``--device cpu`` is given; ``--extra-engine-args`` takes the engine
config as JSON (inline, or a file path), e.g. ``{"preset": "llama-3-8b"}``.
``--model-path`` names a HF-style directory (``config.json``,
``*.safetensors``, ``tokenizer.json``), a ``.gguf`` file, or an ``org/name``
repo id already in the local HF cache; without a checkpoint the weights
are random, made from the engine seed.

Reference capability: launch/dynamo-run (lib.rs:53-456, opt.rs, flags.rs,
input/{http,text,batch}.rs) — the in=X out=Y matrix, model flags, and the
built-in batch load generator.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import statistics
import time
from typing import Any, Dict, List, Optional

from ..llm.http_service import HttpService, ModelManager, ServedModel
from ..llm.model_card import ModelDeploymentCard
from ..llm.pipeline import build_chat_engine, build_completion_engine
from ..llm.protocols.openai import ChatCompletionRequest
from ..runtime.engine import AsyncEngine, Context


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="dynamo-run-torch")
    p.add_argument("positional", nargs="*",
                   help="in=<mode> out=<engine> (order-free)")
    p.add_argument("--model-path", default=None,
                   help="model directory, .gguf file, or org/name repo id "
                        "in the local HF cache")
    p.add_argument("--model-name", default=None)
    p.add_argument("--http-port", type=int, default=8080)
    p.add_argument("--http-host", default="0.0.0.0")
    p.add_argument("--kv-block-size", type=int, default=64)
    p.add_argument("--context-length", type=int, default=None)
    p.add_argument("--max-tokens", type=int, default=128,
                   help="default max tokens for text/batch modes")
    p.add_argument("--concurrency", type=int, default=8,
                   help="batch mode concurrency")
    p.add_argument("--extra-engine-args", default=None,
                   help="extra engine kwargs: a JSON file path, or inline "
                        "JSON if the value starts with '{'")
    p.add_argument("--device", default="cuda",
                   help="torch device of out=torch (cuda | cpu)")
    args = p.parse_args(argv)
    args.input, args.output = "text", "torch"
    for tok in args.positional:
        if tok.startswith("in="):
            args.input = tok[3:]
        elif tok.startswith("out="):
            args.output = tok[4:]
        else:
            p.error(f"unrecognized argument {tok!r}")
    return args


def make_card(args) -> ModelDeploymentCard:
    if args.model_path:
        card = ModelDeploymentCard.resolve(args.model_path, args.model_name)
    else:
        card = ModelDeploymentCard.synthetic(args.model_name or args.output)
    if args.context_length:
        card.context_length = args.context_length
    card.kv_block_size = args.kv_block_size
    return card


def make_engines(args, card: ModelDeploymentCard):
    """Returns (chat_engine, completion_engine, core) at the OpenAI level;
    ``core`` is the torch engine (None for echo)."""
    out = args.output
    if out == "echo_full":
        return (build_chat_engine(card, out), build_completion_engine(card, out),
                None)
    if out == "torch":
        from ..engine.engine import TorchEngine, TorchEngineConfig

        extra: Dict[str, Any] = {}
        if args.extra_engine_args:
            if args.extra_engine_args.lstrip().startswith("{"):
                extra = json.loads(args.extra_engine_args)
            else:
                with open(args.extra_engine_args) as f:
                    extra = json.load(f)
        extra.setdefault("device", args.device)
        core = TorchEngine(TorchEngineConfig.from_card(card, **extra))
        return (build_chat_engine(card, "core", core),
                build_completion_engine(card, "core", core), core)
    raise SystemExit(f"unknown out={out}")


# ---------------------------------------------------------------------------
# input modes
# ---------------------------------------------------------------------------

async def run_http(args, card, chat_engine, completion_engine) -> None:
    from ..utils.tracing import configure as configure_tracing

    configure_tracing(component="http")
    manager = ModelManager()
    manager.add(ServedModel(card, chat_engine, completion_engine))
    svc = HttpService(manager, host=args.http_host, port=args.http_port)
    port = await svc.start()
    print(f"dynamo_tpu_torch http frontend listening on :{port} "
          f"(model={card.name}, out={args.output})", flush=True)
    try:
        while True:
            await asyncio.sleep(3600)
    finally:
        await svc.stop()


async def _ask(chat_engine: AsyncEngine, card, prompt: str, max_tokens: int,
               stream_out=True) -> str:
    req = ChatCompletionRequest.from_dict({
        "model": card.name,
        "messages": [{"role": "user", "content": prompt}],
        "max_tokens": max_tokens,
    })
    parts: List[str] = []
    async for ch in chat_engine.generate(req, Context()):
        if "event" in ch:
            continue
        delta = ch["choices"][0].get("delta", {})
        if delta.get("content"):
            parts.append(delta["content"])
            if stream_out:
                print(delta["content"], end="", flush=True)
    if stream_out:
        print()
    return "".join(parts)


async def run_text(args, card, chat_engine, _completion_engine) -> None:
    print(f"dynamo_tpu_torch interactive ({card.name}). Ctrl-D to exit.")
    loop = asyncio.get_running_loop()
    while True:
        try:
            line = await loop.run_in_executor(None, lambda: input("> "))
        except EOFError:
            return
        if line.strip():
            await _ask(chat_engine, card, line, args.max_tokens)


async def run_batch(args, card, chat_engine, _c, path: str) -> Dict[str, Any]:
    """JSONL load generator: one {"text": ...} (or {"prompt": ...}) per line.
    Reports latency/throughput stats."""
    prompts = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                d = json.loads(line)
                prompts.append(d.get("text") or d.get("prompt") or "")
    sem = asyncio.Semaphore(args.concurrency)
    latencies: List[float] = []
    ttfts: List[float] = []
    tokens_out = 0

    async def one(prompt: str):
        nonlocal tokens_out
        async with sem:
            t0 = time.monotonic()
            first: Optional[float] = None
            req = ChatCompletionRequest.from_dict({
                "model": card.name,
                "messages": [{"role": "user", "content": prompt}],
                "max_tokens": args.max_tokens,
            })
            async for ch in chat_engine.generate(req, Context()):
                if "event" in ch:
                    continue
                if first is None:
                    first = time.monotonic() - t0
                u = ch.get("usage")
                if u:
                    tokens_out += u["completion_tokens"]
            latencies.append(time.monotonic() - t0)
            ttfts.append(first if first is not None else 0.0)

    t_start = time.monotonic()
    await asyncio.gather(*(one(p) for p in prompts))
    wall = time.monotonic() - t_start
    stats = {
        "requests": len(prompts),
        "wall_s": wall,
        "req_per_s": len(prompts) / wall if wall else None,
        "tokens_out": tokens_out,
        "tok_per_s": tokens_out / wall if wall else None,
        "p50_latency_s": statistics.median(latencies) if latencies else None,
        "p50_ttft_s": statistics.median(ttfts) if ttfts else None,
        "p99_latency_s": (sorted(latencies)[int(0.99 * (len(latencies) - 1))]
                          if latencies else None),
    }
    print(json.dumps(stats), flush=True)
    return stats


async def amain(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    card = make_card(args)
    chat_engine, completion_engine, core = make_engines(args, card)
    mode = args.input
    try:
        if mode == "http":
            await run_http(args, card, chat_engine, completion_engine)
        elif mode == "text":
            await run_text(args, card, chat_engine, completion_engine)
        elif mode.startswith("batch:"):
            await run_batch(args, card, chat_engine, completion_engine,
                            mode.split(":", 1)[1])
        elif mode == "none":
            print("engine initialized; no input mode (in=none)")
        else:
            raise SystemExit(f"unknown in={mode}")
    finally:
        if core is not None:
            core.shutdown()


def main() -> None:
    try:
        asyncio.run(amain())
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
