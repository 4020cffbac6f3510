"""Single-binary style launcher: ``python -m dynamo_tpu_torch.cli.run in=... out=...``

Input modes:  http | text | stdin | batch:<file.jsonl> | none
Output modes: torch | echo_core | echo_full | pystr:<file.py> |
pytok:<file.py> | dyn://namespace.component.endpoint

``out=torch`` serves a Llama-family model on the torch engine, on the card
unless ``--device cpu`` is given; ``--extra-engine-args`` takes the engine
config as JSON (inline, or a file path), e.g. ``{"preset": "llama-3-8b"}``.
``--model-path`` names a HF-style directory (``config.json``,
``*.safetensors``, ``tokenizer.json``), a ``.gguf`` file, or an ``org/name``
repo id already in the local HF cache; without a checkpoint the weights
are random, made from the engine seed. A VLM preset (``tiny-gemma3-vlm``)
takes ``image_url`` chat parts as PNG data URLs. ``out=dyn://ns.component.endpoint``
drives a remote worker's core engine (``cli.worker``, torch or JAX) over
the runtime's data plane, found through the store at ``--store``.
``--tensor-parallel-size N`` serves ``out=torch`` over N tensor-parallel
ranks, one process each: this process is the leader and starts the others
as ``cli.worker`` followers (``--devices`` lists each rank's card, which
may repeat over ``--dist-backend gloo``; NCCL refuses two ranks on one
GPU); prefix reuse, the host and disk tiers and speculative decoding
serve at N > 1 as at 1.
``out=echo_core`` echoes the prompt's tokens through the preprocessor and
backend, ``out=echo_full`` its text with no tokenizer at all.
``out=pystr:file.py`` / ``out=pytok:file.py`` serve the ``async def
generate(request, context)`` a user file defines, at the text or the token
level (``llm/python_engine.py``). ``in=stdin`` sends all of standard input
as one chat prompt and prints the answer.

Reference capability: launch/dynamo-run (lib.rs:53-456, opt.rs, flags.rs,
input/{http,text,batch}.rs) — the in=X out=Y matrix, model flags, and the
built-in batch load generator.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import statistics
import sys
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
    p.add_argument("--tensor-parallel-size", type=int, default=1,
                   help="tensor-parallel ranks of out=torch, one process "
                        "each")
    p.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                   help="collectives' backend at --tensor-parallel-size > 1 "
                        "(nccl on a card, gloo on --device cpu)")
    p.add_argument("--devices", default=None,
                   help="comma list of each rank's CUDA device (default: "
                        "rank j on cuda:j; a card may repeat over gloo)")
    p.add_argument("--store", default="127.0.0.1:4222",
                   help="dynstore host:port (out=dyn:// remote mode)")
    p.add_argument("--connect-timeout", type=float, default=30.0,
                   help="seconds to wait for a live out=dyn:// instance")
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


def vlm_card_wiring(card: ModelDeploymentCard, model) -> None:
    """A VLM preset served without a model directory: give the card the
    image token and the soft-token count, so the preprocessor splices an
    ``image_url`` part's placeholders (a checkpoint's config.json carries
    them already)."""
    mc = dict(card.model_config or {})
    if model.image_token_id is None or "image_token_id" in mc \
            or "image_token_index" in mc:
        return
    mc.update(image_token_id=model.image_token_id,
              mm_tokens_per_image=model.mm_tokens_per_image)
    card.model_config = mc


def make_engines(args, card: ModelDeploymentCard):
    """Returns (chat_engine, completion_engine, core) at the OpenAI level;
    ``core`` is the torch engine (None for the others)."""
    out = args.output
    if out in ("echo_core", "echo_full"):
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
        tp = args.tensor_parallel_size
        if tp <= 1:
            cfg = TorchEngineConfig.from_card(card, **extra)
            vlm_card_wiring(card, cfg.model)
            core = TorchEngine(cfg)
        else:
            core = _tp_engine(args, card, extra)
            vlm_card_wiring(card, core.core.cfg.model)
        return (build_chat_engine(card, "core", core),
                build_completion_engine(card, "core", core), core)
    if out.startswith(("pystr:", "pytok:")):
        from ..llm.python_engine import PythonEngineError, build_python_engines

        try:
            return (*build_python_engines(out, card), None)
        except PythonEngineError as e:
            raise SystemExit(str(e))
    if out.startswith("dyn://"):
        # async connect: handled by connect_remote_engines in amain
        raise AssertionError("dyn:// handled before make_engines")
    raise SystemExit(f"unknown out={out}")


def _tp_engine(args, card: ModelDeploymentCard, extra: Dict[str, Any]):
    """The leader of ``--tensor-parallel-size`` ranks on this host
    (:func:`~.worker.tp_engine`)."""
    from .worker import RankLayout, tp_engine

    return tp_engine(RankLayout(args.tensor_parallel_size, args.device,
                                args.dist_backend, args.devices),
                     card, dict(extra), model_path=args.model_path,
                     model_name=args.model_name,
                     kv_block_size=args.kv_block_size)


async def connect_remote_engines(args, card: ModelDeploymentCard):
    """``out=dyn://ns.component.endpoint``: drive a remote worker's core
    engine over the runtime data plane. Returns (chat_engine,
    completion_engine, drt); the caller closes ``drt``."""
    from ..llm.remote import RemoteCoreEngine
    from ..runtime.component import DistributedRuntime

    path = args.output[len("dyn://"):]
    parts = path.split(".")
    if len(parts) != 3:
        raise SystemExit(f"out=dyn://{path}: expected ns.component.endpoint")
    host, _, port = args.store.partition(":")
    drt = await DistributedRuntime(store_host=host or "127.0.0.1",
                                   store_port=int(port or 4222)).connect()
    client = await (drt.namespace(parts[0]).component(parts[1])
                    .endpoint(parts[2]).client().start())
    try:
        await client.wait_for_instances(1, timeout=args.connect_timeout)
    except TimeoutError as e:
        await drt.close()
        raise SystemExit(f"out={args.output}: {e}")
    core = RemoteCoreEngine(client)
    return (build_chat_engine(card, "core", core),
            build_completion_engine(card, "core", core), drt)


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


async def run_stdin(args, card, chat_engine, _c) -> None:
    data = sys.stdin.read()
    if data.strip():
        await _ask(chat_engine, card, data, args.max_tokens)


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
    drt = None
    if args.output.startswith("dyn://"):
        core = None
        chat_engine, completion_engine, drt = await connect_remote_engines(
            args, card)
    else:
        chat_engine, completion_engine, core = make_engines(args, card)
    mode = args.input
    try:
        if mode == "http":
            await run_http(args, card, chat_engine, completion_engine)
        elif mode == "text":
            await run_text(args, card, chat_engine, completion_engine)
        elif mode == "stdin":
            await run_stdin(args, card, chat_engine, completion_engine)
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
        if drt is not None:
            await drt.close()


def main() -> None:
    try:
        asyncio.run(amain())
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
