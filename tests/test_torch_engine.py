"""The torch port's engine, HTTP service, CLI and package boundary.

- Greedy token streams of the torch engine (float32 tiny-byte on the CPU,
  three concurrent prompts: shorter than a page, longer than a prefill
  chunk, in between) are identical to the JAX engine's with the same
  weights.
- The chained decode window: a sequence freed while a dispatch is in
  flight (finish or cancel) keeps its pages until the window drains, and
  no page leaks; sampled streams repeat from run to run and do not depend
  on their batchmates or on how the window chained.
- The construction check's predicate: the CUDA kernels' head dims and
  dtype.
- The stdlib HTTP service answers /v1/models, completions (stream and not),
  chat, malformed requests with 400, and cancels on client disconnect.
- No file of the port, and not ``chip_smoke.py``, imports JAX or the JAX
  package.
"""

import ast
import asyncio
import json
import pathlib
import socket
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.engine import EngineCore as JaxCore, JaxEngineConfig
from dynamo_tpu.models import llama as jl
from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.engine.engine import (EngineCore, TorchEngine,
                                            TorchEngineConfig)
from dynamo_tpu_torch.llm.http_service import (HttpService, ModelManager,
                                               ServedModel)
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.pipeline import (build_chat_engine,
                                           build_completion_engine)
from dynamo_tpu_torch.llm.protocols.common import (BackendInput,
                                                   FinishReason,
                                                   StopConditions)
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.ops.attention import check_kernel_support
from dynamo_tpu_torch.runtime.engine import Context

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENGINE = dict(page_size=8, max_batch=4, max_context=128, prefill_chunk=32,
              decode_steps=4)
PROMPTS = {"short": [5, 6, 7, 8, 9],                    # < one page
           "long": list(np.arange(70) % 250 + 3),       # > prefill_chunk
           "mid": list(np.arange(20) * 7 % 200 + 1)}


def _torch_cfg(**kw):
    d = dict(model=tl.preset("tiny-byte", dtype=torch.float32),
             device="cpu", **ENGINE)
    d.update(kw)
    return TorchEngineConfig(**d)


def _jax_streams_and_params():
    core = JaxCore(JaxEngineConfig(
        model=jl.preset("tiny-byte", dtype=jnp.float32), **ENGINE))
    for sid, toks in PROMPTS.items():
        core.submit(sid, BackendInput(token_ids=toks,
                                      stop=StopConditions(max_tokens=10)))
    got = {sid: [] for sid in PROMPTS}
    done = set()
    for _ in range(200):
        for so in core.step():
            got[so.seq_id].append(so.token)
            if so.finish is not None:
                done.add(so.seq_id)
        if done == set(PROMPTS):
            break
    assert done == set(PROMPTS)
    return got, jax.tree.map(lambda a: np.array(a), core.params)


async def _collect(engine, toks):
    out = []
    async for o in engine.generate(
            BackendInput(token_ids=toks, stop=StopConditions(max_tokens=10)),
            Context()):
        out.extend(o.token_ids)
        if o.finish_reason is not None:
            assert o.finish_reason == FinishReason.LENGTH
    return out


async def test_greedy_streams_match_jax_engine():
    want, np_params = _jax_streams_and_params()
    cfg = _torch_cfg()
    engine = TorchEngine(cfg, tl.params_from_jax(np_params, cfg.model,
                                                 torch.device("cpu")))
    try:
        got = await asyncio.wait_for(asyncio.gather(
            *(_collect(engine, toks) for toks in PROMPTS.values())), 120)
    finally:
        engine.shutdown()
    assert dict(zip(PROMPTS, got)) == want
    # the long prompt took several prefill chunks, all lanes decoded
    assert engine.core.prefill_dispatches >= 3
    assert engine.core.decode_dispatches >= 3
    assert engine.core.pool.free_pages == engine.core.pool.num_pages - 1


def test_core_rejects_and_evicts_cleanly():
    core = EngineCore(_torch_cfg(num_pages=6))
    core.submit("big", BackendInput(token_ids=list(range(200)),
                                    stop=StopConditions(max_tokens=2)))
    core.submit("img", BackendInput(token_ids=[1, 2], images=[np.zeros(3)],
                                    stop=StopConditions(max_tokens=2)))
    outs = core.step()
    assert {o.seq_id: o.error_code for o in outs} == {"big": 400, "img": 400}
    assert all(o.finish == FinishReason.ERROR for o in outs)
    core.submit("a", BackendInput(token_ids=[1, 2, 3],
                                  stop=StopConditions(max_tokens=3)))
    core.cancel("a")          # still waiting: dropped before admission
    assert not core.has_work


def _steps_until(core, done, limit=200):
    """Step until ``done(outputs so far, this step's outputs)``; returns
    every output by sequence."""
    got = {}
    for _ in range(limit):
        outs = core.step()
        for so in outs:
            got.setdefault(so.seq_id, []).append(so)
        if done(got, outs):
            return got
    raise AssertionError("condition not reached")


def test_window_holds_releases_until_it_drains():
    core = EngineCore(_torch_cfg(max_batch=2, num_pages=24))
    for sid, n in (("a", 40), ("b", 9)):
        core.submit(sid, BackendInput(token_ids=list(range(5, 17)),
                                      stop=StopConditions(max_tokens=n,
                                                          ignore_eos=True)))
    # b finishes while the dispatch chained behind its last one is in
    # flight: its pages stay leased until that dispatch is drained
    _steps_until(core, lambda got, outs: any(
        so.seq_id == "b" and so.finish for so in outs))
    assert core._inflight and "b" in core.pool.seqs
    assert [sid for sid, _ in core._deferred_release] == ["b"]
    core.step()
    assert not core._deferred_release and "b" not in core.pool.seqs
    # a, cancelled with a chained dispatch in flight, is reaped, the window
    # drains in the same step, and every page comes back
    _steps_until(core, lambda got, outs: len(core._inflight) == 1
                 and core._inflight[0]["chained"])
    core.cancel("a")
    outs = core.step()
    assert [(so.seq_id, so.finish) for so in outs][0] == (
        "a", FinishReason.CANCELLED)
    assert not core.has_work and not core._deferred_release
    assert core.pool.free_pages == core.pool.num_pages - 1


async def test_engine_error_drops_the_window_and_leaks_no_page():
    """An exception inside a step with dispatches in flight fails every live
    request, drops the window and applies the releases held for it, so a
    fault that persists leaves no page leased."""
    engine = TorchEngine(_torch_cfg(max_batch=2))
    core = engine.core
    fetch, calls = core._process_oldest_inflight, []

    def failing_fetch():            # the fault persists once it struck
        calls.append(len(core._inflight))
        if len(calls) >= 2:
            raise RuntimeError("injected fault")
        return fetch()

    core._process_oldest_inflight = failing_fetch
    try:
        outs = await asyncio.wait_for(asyncio.gather(*(
            _collect_outputs(engine, toks, 30)
            for toks in (PROMPTS["mid"], PROMPTS["short"]))), 60)
    finally:
        engine.shutdown()
    for got in outs:
        assert got[-1].finish_reason == FinishReason.ERROR
        assert "injected fault" in got[-1].error
    assert calls[1] == 2               # a chained dispatch was in flight
    assert not core._inflight and not core._deferred_release
    assert not core.by_seq
    assert core.pool.free_pages == core.pool.num_pages - 1


async def _collect_outputs(engine, toks, n):
    outs = []
    async for o in engine.generate(
            BackendInput(token_ids=toks, stop=StopConditions(max_tokens=n)),
            Context()):
        outs.append(o)
    return outs


def test_sampled_streams_repeat_and_are_batch_invariant():
    """A seeded sampled request draws its lane's uniforms in the same order
    whether its dispatches chain or not, so its stream is the same alone,
    again, and beside a batchmate that joins mid-stream (which drains the
    window and breaks the chain)."""
    def run(batchmate):
        core = EngineCore(_torch_cfg(max_batch=2))
        core.submit("s", _sampled(7, 14))
        got = _steps_until(core, lambda got, outs: len(got.get("s", [])) >= 5
                           or not core.has_work)
        if batchmate:
            core.submit("m", _sampled(3, 9))
        got2 = _steps_until(core, lambda g, outs: not core.has_work)
        return [so.token for so in got["s"] + got2.get("s", [])], core

    alone, core = run(False)
    assert len(alone) == 14 and core.decode_dispatches >= 3
    assert run(False)[0] == alone
    batched, core = run(True)
    assert batched == alone
    assert core.decode_dispatches >= 4


def _sampled(seed, n):
    req = BackendInput(token_ids=[9, 8, 7, 6, 5],
                       stop=StopConditions(max_tokens=n, ignore_eos=True))
    req.sampling.temperature = 0.9
    req.sampling.top_p = 0.95
    req.sampling.seed = seed
    return req


@pytest.mark.parametrize("head_dim,dtype,ok", [
    (16, torch.bfloat16, True),      # tiny-* presets
    (64, torch.bfloat16, True),
    (128, torch.bfloat16, True),     # Llama-3-8B
    (256, torch.bfloat16, True),     # Gemma2-9B
    (80, torch.bfloat16, False),
    (16, torch.float32, False),
    (128, torch.float16, False),
])
def test_kernel_support_check(head_dim, dtype, ok):
    """The predicate EngineCore checks at construction on CUDA: only head
    dims and a dtype that both kernels have an instance for."""
    if ok:
        check_kernel_support(head_dim, dtype)
    else:
        with pytest.raises(ValueError, match="no CUDA attention kernel"):
            check_kernel_support(head_dim, dtype)


def test_config_from_card_validates_args():
    card = ModelDeploymentCard.synthetic("t")
    cfg = TorchEngineConfig.from_card(card, preset="tiny-gemma2",
                                      max_batch=2, device="cpu")
    assert cfg.model.sliding_window == 8 and cfg.max_batch == 2
    with pytest.raises(ValueError, match="unknown engine arg"):
        TorchEngineConfig.from_card(card, max_bacth=2)
    with pytest.raises(NotImplementedError, match="tp"):
        TorchEngineConfig.from_card(card, tp=2)


def test_config_accepts_kv_block_manager_args():
    card = ModelDeploymentCard.synthetic("t")
    assert TorchEngineConfig.from_card(card).enable_prefix_reuse
    cfg = TorchEngineConfig.from_card(card, enable_prefix_reuse=False,
                                      host_cache_blocks=4)
    assert not cfg.enable_prefix_reuse and cfg.host_cache_blocks == 4
    with pytest.raises(NotImplementedError, match="cluster_writethrough"):
        TorchEngineConfig.from_card(card, host_cache_blocks=4,
                                    cluster_writethrough=True)


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        EngineCore(_torch_cfg(device="cuda"))


# ---------------------------------------------------------------------------
# HTTP service
# ---------------------------------------------------------------------------

def _http(port, path, body=None, raw=None, method=None):
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.headers.get("Content-Type"), \
                resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read().decode()


async def test_http_service_routes_and_errors():
    card = ModelDeploymentCard.synthetic("tiny")
    engine = TorchEngine(_torch_cfg())
    manager = ModelManager()
    manager.add(ServedModel(card, build_chat_engine(card, "core", engine),
                            build_completion_engine(card, "core", engine)))
    svc = HttpService(manager, host="127.0.0.1", port=0)
    port = await svc.start()
    call = asyncio.to_thread
    try:
        st, _, body = await call(_http, port, "/v1/models")
        assert st == 200 and json.loads(body)["data"][0]["id"] == "tiny"
        st, _, body = await call(_http, port, "/health")
        assert st == 200 and json.loads(body)["status"] == "ok"

        st, _, body = await call(_http, port, "/v1/completions", {
            "model": "tiny", "prompt": "hello", "max_tokens": 5})
        out = json.loads(body)
        assert st == 200 and out["object"] == "text_completion"
        assert out["usage"]["completion_tokens"] == 5
        assert out["choices"][0]["finish_reason"] == "length"

        st, ctype, body = await call(_http, port, "/v1/completions", {
            "model": "tiny", "prompt": "hello", "max_tokens": 4,
            "stream": True, "logprobs": 1})
        assert st == 200 and ctype == "text/event-stream"
        datas = [ln[5:].strip() for ln in body.splitlines()
                 if ln.startswith("data:")]
        assert datas[-1] == "[DONE]" and len(datas) == 5
        assert json.loads(datas[-2])["usage"]["completion_tokens"] == 4

        st, _, body = await call(_http, port, "/v1/chat/completions", {
            "model": "tiny", "max_tokens": 3,
            "messages": [{"role": "user", "content": "hi"}]})
        out = json.loads(body)
        assert st == 200 and out["object"] == "chat.completion"
        assert out["usage"]["completion_tokens"] == 3

        for raw, want in ((b"{not json", 400), (b"[1, 2]", 400),
                          (json.dumps({"model": "tiny"}).encode(), 400),
                          (json.dumps({"model": "nope", "prompt": "x"})
                           .encode(), 404)):
            st, _, body = await call(_http, port, "/v1/completions", raw=raw)
            assert st == want
            assert json.loads(body)["error"]["code"] == want
        st, _, _ = await call(_http, port, "/v1/completions", method="GET")
        assert st == 405
        st, _, _ = await call(_http, port, "/nowhere")
        assert st == 404
    finally:
        await svc.stop()
        engine.shutdown()


async def test_http_client_disconnect_cancels_the_request():
    card = ModelDeploymentCard.synthetic("tiny")
    engine = TorchEngine(_torch_cfg(max_context=1024))
    manager = ModelManager()
    manager.add(ServedModel(card, None,
                            build_completion_engine(card, "core", engine)))
    svc = HttpService(manager, host="127.0.0.1", port=0)
    port = await svc.start()

    def open_stream_and_hang_up():
        body = json.dumps({"model": "tiny", "prompt": "x", "stream": True,
                           "max_tokens": 900, "logprobs": 1}).encode()
        s = socket.create_connection(("127.0.0.1", port), timeout=30)
        s.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Type: application/json\r\n"
                  b"Content-Length: " + str(len(body)).encode()
                  + b"\r\n\r\n" + body)
        first = s.recv(4096)
        s.close()
        return first

    try:
        first = await asyncio.to_thread(open_stream_and_hang_up)
        assert first.startswith(b"HTTP/1.1 200")
        for _ in range(300):
            if not engine.core.has_work:
                break
            await asyncio.sleep(0.05)
        assert not engine.core.has_work
        assert engine.core.decode_steps_run < 900   # cancelled, not finished
        assert engine.core.pool.free_pages == engine.core.pool.num_pages - 1
    finally:
        await svc.stop()
        engine.shutdown()


def test_cli_builds_the_torch_engine():
    from dynamo_tpu_torch.cli.run import make_card, make_engines, parse_args

    args = parse_args(["in=none", "out=torch", "--device", "cpu",
                       "--extra-engine-args", json.dumps(
                           {"max_batch": 2, "max_context": 64})])
    card = make_card(args)
    _, _, core = make_engines(args, card)
    try:
        assert card.name == "torch"
        assert core.core.cfg.max_batch == 2
        assert core.core.device.type == "cpu"
    finally:
        core.shutdown()


# ---------------------------------------------------------------------------
# package boundary
# ---------------------------------------------------------------------------

def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_the_jax_package():
    """...nor ``xxhash``, which the card's machine lacks: the port carries
    its own XXH3-64 (``llm/xxh3.py``)."""
    files = sorted((ROOT / "dynamo_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = {str(f.relative_to(ROOT)): sorted(
               r for r in set(_imported_roots(f))
               if r in ("jax", "jaxlib", "dynamo_tpu", "xxhash"))
           for f in files}
    assert {k: v for k, v in bad.items() if v} == {}
