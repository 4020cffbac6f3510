"""The port's deployment SDK, ``cli.serve`` and serving graphs, against the
JAX package's.

Module against module: the YAML subset reader against ``yaml.safe_load``
on the repo's configs (and its refusals), the graphs' specs and
dependency-first order against the JAX examples', ``ServiceConfig`` and the
card plan ``LocalServe`` makes before it spawns anything. Then graphs that
run: a three-stage graph in process over the real data plane, the
KV-routed echo graph through ``python -m dynamo_tpu_torch.cli.serve`` as
processes (stopped with SIGTERM: every child and the store reaped), and
``DisaggRouterGraph`` in process with tiny-byte f32 workers on the CPU,
whose frontend streams the port's local greedy tokens for a prompt the
decode worker sends to the prefill worker.
"""

import asyncio
import glob
import importlib
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest
import torch
import yaml

from dynamo_tpu_torch.sdk import (AllocationError, async_on_start, depends,
                                  dynamo_endpoint, service)
from dynamo_tpu_torch.sdk.service import ServiceConfig, chips_of, collect_graph
from dynamo_tpu_torch.utils import yamlsubset

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted(glob.glob(str(ROOT / "examples" / "configs" / "*.yaml")))
# the configs outside the subset: a folded block scalar (``>-``)
REFUSED = {"70b_offload.yaml": 11, "70b_pp.yaml": 13}


# ---------------------------------------------------------------------------
# the YAML subset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p)
                                               for p in CONFIGS])
def test_yaml_subset_reads_the_configs_as_safe_load(path):
    text = Path(path).read_text()
    name = os.path.basename(path)
    if name in REFUSED:
        with pytest.raises(yamlsubset.YamlSubsetError) as e:
            yamlsubset.loads(text)
        assert e.value.line == REFUSED[name] and "'>'" in str(e.value)
        return
    assert yamlsubset.loads(text) == yaml.safe_load(text)


SNIPPETS = [
    "a: 1\nb: -2\nc: +3\nd: 0", "a: 1.5\nb: 2.\nc: 1.0e+3\nd: 1e3",
    "a: .inf\nb: -.Inf\nc: .NaN\nd: 01.5", "a: yes\nb: Off\nc: TRUE\nd: y",
    "a: ~\nb:\nc: null\nd: NULL  # c", "a: 'x''y'  # c\nb: \"t\\ty\\u00e9\\\\\"",
    "a: b#c\nb: c #d\nc: 127.0.0.1:4222\nd: http://x/y", "'q k': 1\n\"k\": v",
    "a:\n  b: 1\n  c:\n    d: x\n\n  # between\ne: 2", "a: it's\nb: b,c\nc: -x",
    "\ufeffa: 1\r\nb: 2\r\n", "a: ''\nb: \"\"\nc: x y  z",
]
# (text, line refused on)
BAD = [("a: !!str 1", 1), ("a: &x 1", 1), ("a: *x", 1), ("a: [1]", 1),
       ("a: {b: 1}", 1), ("a: |\n  x", 1), ("- a", 1), ("a: b\n  c", 2),
       ("a: b: c", 1), ("a: 0x1f", 1), ("a: 1_0", 1), ("a: 2001-01-01", 1),
       ("a: 1:20", 1), ("a: 010", 1), ("a: .5", 1), ("x: 1\na: 1\na: 2", 3),
       ("1: x", 1), ("a:\n\tb: 1", 2), ("---\na: 1", 1), ("a: 'open", 1),
       ("a: \"x\" y", 1), ("a:\n  b: 1\n c: 2", 3), ("a: -", 1),
       ("a: =", 1), ("<<: x", 1), ("a: \"\\N\"", 1), ("just text", 1)]


@pytest.mark.parametrize("text", SNIPPETS, ids=range(len(SNIPPETS)))
def test_yaml_subset_reads_plain_forms_as_safe_load(text):
    got, want = yamlsubset.loads(text), yaml.safe_load(text)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


@pytest.mark.parametrize("case", BAD, ids=[b[0] for b in BAD])
def test_yaml_subset_refuses_with_the_line(case):
    text, line = case
    with pytest.raises(yamlsubset.YamlSubsetError) as e:
        yamlsubset.loads(text)
    assert e.value.line == line and str(e.value).startswith(f"line {line}:")


def test_serve_reads_json_and_yaml_configs(tmp_path):
    from dynamo_tpu_torch.cli.serve import load_config

    y = tmp_path / "c.yaml"
    y.write_text("Worker:\n  engine: echo\n  resources:\n    gpu: 0\n")
    j = tmp_path / "c.cfg"
    j.write_text(' {"Worker": {"engine": "echo", "resources": {"gpu": 0}}}')
    assert load_config(str(y)) == load_config(str(j)) == {
        "Worker": {"engine": "echo", "resources": {"gpu": 0}}}


# ---------------------------------------------------------------------------
# specs, graph order, config
# ---------------------------------------------------------------------------

GRAPHS = [("hello_world", "Frontend"), ("llm_graphs", "AggGraph"),
          ("llm_graphs", "AggRouterGraph"), ("llm_graphs", "DisaggRouterGraph")]


def _spec_view(cls):
    s = cls._dynamo_spec
    return dict(cls=cls.__name__, namespace=s.namespace, name=s.name,
                chips=chips_of(s.resources), workers=s.workers,
                links=[c.__name__ for c in s.links], endpoints=s.endpoints,
                on_start=s.on_start,
                deps={k: (d.target.__name__, d.endpoint)
                      for k, d in s.dependencies.items()})


@pytest.mark.parametrize("graph", GRAPHS, ids=[g[1] for g in GRAPHS])
def test_graph_specs_and_order_equal_jax(graph):
    mod, entry = graph
    views = []
    for pkg in ("examples", "dynamo_tpu_torch.examples"):
        cls = getattr(importlib.import_module(f"{pkg}.{mod}"), entry)
        views.append([_spec_view(c) for c in collect_graph(cls)])
    assert views[0] == views[1]
    chips = {v["cls"]: v["chips"] for v in views[1]}
    assert all(chips.get(w, 1) == 1 for w in ("Worker", "PrefillWorker"))


def test_sdk_decorators_config_and_resources(monkeypatch, tmp_path):
    @service(namespace="t", resources={"tpu": 2}, workers=3)
    class A:
        @dynamo_endpoint("gen")
        async def g(self, request, ctx):
            yield request

        @async_on_start
        async def boot(self):
            pass

    @service(namespace="t")
    class B:
        a = depends(A, "gen")

    B.link(A)
    s = A._dynamo_spec
    assert (s.name, s.endpoints, s.on_start, s.workers) == (
        "a", {"gen": "g"}, ["boot"], 3)
    assert collect_graph(B) == [A, B] and chips_of(s.resources) == 2
    assert chips_of({"gpu": 1, "tpu": 1}) == 1 and chips_of({}) is None
    with pytest.raises(ValueError, match="different"):
        chips_of({"gpu": 1, "tpu": 2})
    with pytest.raises(RuntimeError, match="not wired"):
        B().a
    monkeypatch.setenv("DYN_SERVICE_CONFIG", json.dumps({"A": {"x": 1}}))
    assert ServiceConfig.load().for_service(A) == {"x": 1}
    f = tmp_path / "cfg.json"
    f.write_text(json.dumps({"B": {"y": 2}}))
    monkeypatch.delenv("DYN_SERVICE_CONFIG")
    monkeypatch.setenv("DYN_SERVICE_CONFIG_FILE", str(f))
    cfg = ServiceConfig.load()
    assert cfg.for_service("B") == {"y": 2} and cfg.get("A") == {}


# (graph, config, platform, cards, the plan's (service, CUDA_VISIBLE_DEVICES,
#  device) per process, or the error)
PLANS = [
    ("AggRouterGraph", {"Worker": {"engine": "jax"}}, "cuda", 1,
     [("router", "", None), ("backend", "0", "cuda"), ("frontend", "", None)]),
    ("AggRouterGraph", {"Worker": {"workers": 2}}, "cuda", 2,
     [("router", "", None), ("backend", "0", "cuda"), ("backend", "1", "cuda"),
      ("frontend", "", None)]),
    ("AggRouterGraph", {"Worker": {"workers": 2}}, "cuda", 1, AllocationError),
    ("DisaggRouterGraph", {}, "cuda", 1, AllocationError),
    ("DisaggRouterGraph", {"PrefillWorker": {"resources": {"tpu": 0}}},
     "cuda", 1, [("router", "", None), ("backend", "0", "cuda"),
                 ("prefill", "", "cpu"), ("frontend", "", None)]),
    ("DisaggRouterGraph", {"Worker": {"device": "cpu"}}, "cpu", 1,
     [("router", "", None), ("backend", "", "cpu"), ("prefill", "", "cpu"),
      ("frontend", "", None)]),
]


@pytest.mark.parametrize("case", PLANS, ids=range(len(PLANS)))
def test_local_serve_plans_cards_before_spawning(case):
    from dynamo_tpu_torch.sdk.serve import LocalServe

    graph, config, platform, cards, want = case
    serve = LocalServe(f"dynamo_tpu_torch.examples.llm_graphs:{graph}",
                       config=config, platform=platform, total_chips=cards)
    if want is AllocationError:
        with pytest.raises(AllocationError):
            serve.start()
        assert serve.procs == [] and serve.store is None
        return
    got = []
    for cls, env in serve.plan():
        section = json.loads(env["DYN_SERVICE_CONFIG"]).get(cls.__name__, {})
        got.append((cls._dynamo_spec.name, env["CUDA_VISIBLE_DEVICES"],
                    section.get("device")))
    assert sorted(got, key=str) == sorted(want, key=str)


# ---------------------------------------------------------------------------
# graphs that run
# ---------------------------------------------------------------------------

@service(namespace="t")
class Leaf:
    @dynamo_endpoint()
    async def generate(self, request, ctx):
        yield {"n": request["n"] * 2}


@service(namespace="t")
class Mid:
    leaf = depends(Leaf)
    started = False

    @async_on_start
    async def boot(self):
        type(self).started = True

    @dynamo_endpoint()
    async def generate(self, request, ctx):
        async for item in self.leaf.generate(request):
            yield {"n": item["n"] + 1}


@service(namespace="t")
class Entry:
    mid = depends(Mid)

    @dynamo_endpoint()
    async def generate(self, request, ctx):
        async for item in self.mid.generate(request):
            yield item


Entry.link(Mid).link(Leaf)


async def test_three_stage_graph_in_process():
    """Entry -> Mid -> Leaf, each service brought up as ``serve_child``
    does, over the real data plane; cancelling a service ends its tasks
    and closes its runtime."""
    from dynamo_tpu_torch.runtime.component import DistributedRuntime
    from dynamo_tpu_torch.runtime.store_server import PyStoreServer
    from dynamo_tpu_torch.sdk.serve_child import run_service

    srv = PyStoreServer()
    port = await srv.start()
    tasks = []
    try:
        for cls in collect_graph(Entry):
            ev = asyncio.Event()
            tasks.append(asyncio.create_task(
                run_service(cls, f"127.0.0.1:{port}", ready_event=ev)))
            await asyncio.wait_for(ev.wait(), 15)
        assert Mid.started
        caller = await DistributedRuntime(store_port=port).connect()
        try:
            cl = await caller.namespace("t").component("entry") \
                .endpoint("generate").client().start()
            await cl.wait_for_instances(1, timeout=10)
            assert [x async for x in cl.generate({"n": 20})] == [{"n": 41}]
        finally:
            await caller.close()
    finally:
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        await srv.stop()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_cli_serve_runs_the_echo_router_graph_and_stops_on_sigterm(tmp_path):
    """``python -m dynamo_tpu_torch.cli.serve`` with the repo's
    ``agg_router.yaml`` (echo workers, the frontend on a free port): two
    workers, the router and the frontend come up as processes beside a
    store, a completion streams through the router, and SIGTERM leaves no
    process of its process group alive."""
    text = (ROOT / "examples" / "configs" / "agg_router.yaml").read_text()
    http = _free_port()
    cfg = tmp_path / "agg_router.yaml"
    cfg.write_text(text.replace("port: 8080", f"port: {http}\n  host: "
                                              "127.0.0.1"))
    log = open(tmp_path / "serve.log", "w")
    env = dict(os.environ, PYTHONPATH=str(ROOT), DYN_TOKEN_ECHO_DELAY_MS="0")
    p = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.cli.serve",
         "dynamo_tpu_torch.examples.llm_graphs:AggRouterGraph", "--config",
         str(cfg), "--platform", "cpu"], stdout=log, stderr=subprocess.STDOUT,
        cwd=str(ROOT), env=env, start_new_session=True)
    try:
        deadline = time.monotonic() + 60
        body = None
        while time.monotonic() < deadline and body is None:
            assert p.poll() is None, (tmp_path / "serve.log").read_text()
            try:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{http}/v1/completions",
                    data=json.dumps({"model": "demo", "prompt": "a b c",
                                     "max_tokens": 4, "stream": True}).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=10) as r:
                    body = r.read().decode()
            except OSError:
                time.sleep(0.2)
        # the frontend may answer once one worker is up; cli.serve prints
        # its "serving" line only after every worker's READY line
        while time.monotonic() < deadline and not re.search(
                r"^serving ", (tmp_path / "serve.log").read_text(), re.M):
            time.sleep(0.1)
        out = (tmp_path / "serve.log").read_text()
        assert body is not None and "[DONE]" in body, out
        assert out.count("DYNAMO_SERVICE_READY backend") == 2
        assert set(re.findall(r"data plane: (\w+) on port", out)) == {"native"}
        p.send_signal(signal.SIGTERM)
        assert p.wait(60) == 0
        assert "serve stopped" in (tmp_path / "serve.log").read_text()
        time.sleep(0.2)
        with pytest.raises(ProcessLookupError):
            os.killpg(p.pid, 0)     # nothing of the group is left
    finally:
        if p.poll() is None:
            p.kill()
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        log.close()


async def test_disagg_router_graph_serves_the_local_greedy_tokens(
        monkeypatch, capsys):
    """``DisaggRouterGraph`` in one process on the CPU: tiny-byte f32 decode
    and prefill workers, the KV router and the frontend, each brought up
    as ``serve_child`` does with the config ``LocalServe`` would hand it.
    A prompt longer than the decode worker's local limit is prefilled by
    the prefill worker and streamed back; the frontend streams the tokens
    the port's own engine gives for it locally."""
    from dynamo_tpu_torch.cli.worker import make_engine, parse_args
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.pipeline import build_completion_engine
    from dynamo_tpu_torch.llm.protocols.openai import (
        CompletionRequest, aggregate_completion_chunks)
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.runtime.engine import Context
    from dynamo_tpu_torch.runtime.store_server import PyStoreServer
    from dynamo_tpu_torch.sdk.serve_child import run_service
    from dynamo_tpu_torch.utils.prometheus import stage_metrics
    from dynamo_tpu_torch.examples import llm_graphs as g

    torch.set_num_threads(2)
    monkeypatch.setitem(llama.PRESETS, "tiny-byte",
                        {**llama.PRESETS["tiny-byte"], "dtype": torch.float32})
    engine_args = json.dumps({"preset": "tiny-byte", "max_batch": 2,
                              "max_context": 256, "page_size": 16,
                              "prefill_chunk": 64})
    config = {
        "Frontend": {"host": "127.0.0.1", "port": 0,
                     "router_component": "router"},
        "Router": {"worker_component": "backend", "block_size": 16},
        "Worker": {"engine": "jax", "register_model": True,
                   "model_name": "demo", "enable_disagg": True,
                   "max_local_prefill_length": 16, "kv_block_size": 16,
                   "extra_engine_args": engine_args, "device": "cpu"},
        "PrefillWorker": {"kv_block_size": 16, "device": "cpu",
                          "extra_engine_args": engine_args},
    }
    monkeypatch.setenv("DYN_SERVICE_CONFIG", json.dumps(config))
    prompt = "the graph prefills this prompt on another worker"
    body = {"model": "demo", "prompt": prompt, "max_tokens": 12,
            "temperature": 0.0}

    # the port's local greedy stream of the same prompt
    largs = parse_args([])
    for k, v in config["Worker"].items():
        setattr(largs, k, v)
    largs.engine = "torch"
    local = make_engine(largs)
    try:
        card = ModelDeploymentCard.synthetic("demo")
        card.kv_block_size = 16
        chunks = [c async for c in build_completion_engine(
            card, "core", local).generate(
                CompletionRequest.from_dict(body), Context())
            if "event" not in c]
        want = aggregate_completion_chunks(chunks)["choices"][0]
    finally:
        local.shutdown()

    recv0 = stage_metrics().kv_transfer_bytes.get("recv")
    srv = PyStoreServer()
    port = await srv.start()
    tasks = []
    try:
        for cls in collect_graph(g.DisaggRouterGraph)[:-1]:
            ev = asyncio.Event()
            tasks.append(asyncio.create_task(
                run_service(cls, f"127.0.0.1:{port}", ready_event=ev)))
            await asyncio.wait_for(ev.wait(), 60)
        http = int(re.search(r"http frontend on :(\d+)",
                             capsys.readouterr().out).group(1))

        def post():
            deadline = time.monotonic() + 30
            while True:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{http}/v1/models", timeout=10) as r:
                    if "demo" in r.read().decode():
                        break
                assert time.monotonic() < deadline, "model never discovered"
                time.sleep(0.1)
            req = urllib.request.Request(
                f"http://127.0.0.1:{http}/v1/completions",
                data=json.dumps({**body, "stream": True}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                return [json.loads(line[5:]) for line in
                        r.read().decode().splitlines()
                        if line.startswith("data:") and "[DONE]" not in line]

        got = await asyncio.to_thread(post)
    finally:
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        await srv.stop()
    text = "".join(c["choices"][0].get("text") or "" for c in got)
    assert text == want["text"] and len(text) > 0
    assert got[-1]["choices"][0]["finish_reason"] == want["finish_reason"]
    # the prompt's KV came from the prefill worker
    assert stage_metrics().kv_transfer_bytes.get("recv") > recv0
