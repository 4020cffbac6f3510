"""The port's operator tools and bring-your-own engines, against the JAX
package's.

Module against module on the same inputs: the KV recorder's JSONL lines
(timestamps apart) and its replay into both packages' indexers, from
records made by hand and from a live ``kv_events`` tap; ``pystr:`` and
``pytok:`` user engines (the cases of ``tests/test_python_engine.py``)
streaming the same text, finish reasons and usage, and ``cli.run``'s
``in=stdin`` with ``out=echo_core``; the records ``ctl`` writes into a
store, byte for byte, and each package's ``ctl`` reading the other's;
``dyntop --once --plain`` on one store holding JAX and port workers' dumps;
``tracectl``'s waterfall, decision lines and Chrome export, offline from a
bundle and live from the port's frontend; the cluster aggregator's
exposition over the mock workers' ramp, served by ``cli.metrics`` on the
port's own HTTP server and pushed to a pushgateway.
"""

import argparse
import asyncio
import contextlib
import importlib
import io
import json
import time
import urllib.request

import numpy as np
import pytest

PKGS = J, T = ("dynamo_tpu", "dynamo_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


async def until(predicate, timeout: float = 10.0, msg: str = "condition"):
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {msg}")
        await asyncio.sleep(0.02)


@contextlib.asynccontextmanager
async def store(pkg=T):
    srv = _mod(pkg, "runtime.store_server").PyStoreServer()
    port = await srv.start()
    try:
        yield port
    finally:
        await srv.stop()


def _stored(pkg, worker, tokens, page=4, parent=None):
    p = _mod(pkg, "llm.kv_router.protocols")
    hashes = _mod(pkg, "llm.tokens").compute_seq_hashes(tokens, page)
    return p.RouterEvent(worker, p.KvCacheEvent(
        event_id=1, stored=p.KvStoredEvent(
            blocks=[p.StoredBlock(block_hash=h, tokens_hash=h ^ 1)
                    for h in hashes], parent_hash=parent))).to_dict()


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def _lines(path):
    out = []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            assert set(rec) == {"ts", "event"}
            out.append(json.dumps(rec["event"]))
    return out


def _overlaps(rec_path, pkg_idx, queries, **kw):
    """Replay a capture into package ``pkg_idx``'s indexer; the overlap
    scores of each query."""
    rec = _mod(pkg_idx, "llm.recorder").KvRecorder(rec_path)
    idx = _mod(pkg_idx, "llm.kv_router.indexer").KvIndexer(block_size=4)
    n = rec.replay_into_indexer(idx, **kw)
    rec.close()
    return n, [idx.find_matches_for_tokens(q).scores for q in queries]


def test_recorder_lines_and_replay_match_jax(tmp_path):
    """Pause, filter, the event bound and close gate the same events in
    both recorders; the lines match field for field; either capture
    replayed into either package's indexer scores the same overlaps."""
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(0, 200, 4 * n)]
               for n in (3, 2, 4, 1, 2)]
    paths = {}
    for pkg in PKGS:
        paths[pkg] = str(tmp_path / f"{pkg}.jsonl")
        rec = _mod(pkg, "llm.recorder").KvRecorder(
            paths[pkg], filter_fn=lambda e: e["payload"]["worker_id"] != 99,
            max_events=4)
        got = []
        for i, (w, toks) in enumerate(zip((1, 2, 99, 1, 2), prompts)):
            if i == 1:
                rec.pause()
            got.append(rec.record({"subject": "kv_events",
                                   "payload": _stored(pkg, w, toks)}))
            if i == 1:
                rec.resume()
        got.append(rec.record({"subject": "kv_events",
                               "payload": _stored(pkg, 3, prompts[0])}))
        got.append(rec.record({"subject": "kv_events",
                               "payload": _stored(pkg, 4, prompts[1])}))
        assert rec.stopped and (rec.count, rec.skipped) == (4, 3)
        assert got == [True, False, False, True, True, True, False]
        rec.close()
        assert not rec.record({"payload": {}})
    assert _lines(paths[T]) == _lines(paths[J])
    queries = prompts + [prompts[0][:8] + [7] * 4]
    scores = {(cap, idx): _overlaps(paths[cap], idx, queries)
              for cap in PKGS for idx in PKGS}
    assert len(set(json.dumps(v, sort_keys=True) for v in scores.values())) == 1
    n, got = scores[(T, T)]
    assert n == 4 and got[0] == {1: 3, 3: 3} and got[-1] == {1: 2, 3: 2}
    assert _overlaps(paths[T], J, queries, worker_ids=[2]) \
        == _overlaps(paths[T], T, queries, worker_ids=[2])
    assert _overlaps(paths[T], T, queries, worker_ids=[2])[0] == 1


async def test_recorder_taps_live_events_and_replays_like_jax(tmp_path):
    """Both packages' recorders attach to one live ``kv_events`` subject
    (the port's store, the port's engine pool publishing): the same lines,
    replayed (paced, on the loop) into either indexer, give the overlaps
    the events made."""
    from dynamo_tpu_torch.engine.cache import PagePool
    from dynamo_tpu_torch.llm.kv_router.publisher import KvEventPublisher

    async with store() as port:
        rts, recs = [], {}
        try:
            for pkg in PKGS:
                drt = await _mod(pkg, "runtime.component").DistributedRuntime(
                    store_port=port).connect()
                rts.append(drt)
                recs[pkg] = await _mod(pkg, "llm.recorder").KvRecorder(
                    str(tmp_path / f"{pkg}.jsonl")).attach(
                    drt.namespace("dynamo").component("backend"))
            comp = rts[1].namespace("dynamo").component("backend")

            async def transport(subject, payload):
                await comp.publish(subject, payload)

            pub = KvEventPublisher(worker_id=7, publish=transport)
            await pub.start()
            pool = PagePool(num_pages=8, page_size=4)
            pool.on_block_sealed = pub.block_stored
            pool.create("s1")
            pool.extend("s1", list(range(13)))     # seals 3 blocks
            await pub.flush()
            await pub.stop()
            await until(lambda: all(r.count == 3 for r in recs.values()),
                        msg="both taps")
        finally:
            for drt in rts:
                await drt.close()
    for r in recs.values():
        r.close()
    assert _lines(recs[T].path) == _lines(recs[J].path)
    for pkg in PKGS:
        seen = []
        n = await _mod(pkg, "llm.recorder").KvRecorder(
            recs[T].path).replay_into_async(seen.append, speed=1e4)
        assert n == 3 and seen == [json.loads(x)["payload"]
                                   for x in _lines(recs[J].path)]
        assert _overlaps(recs[T].path, pkg, [list(range(13))])[1] \
            == [{7: 3}]


# ---------------------------------------------------------------------------
# pystr: / pytok: user engines
# ---------------------------------------------------------------------------

PYTOK = '''
async def generate(request, context):
    for t in reversed(request.token_ids):
        yield t
'''
PYSTR = '''
async def generate(prompt, context):
    yield "you said: "
    yield prompt.upper()[:20]
'''
PYTOK_EO = '''
from {pkg}.llm.protocols.common import EngineOutput

async def generate(request, context):
    for t in request.token_ids:
        yield EngineOutput(token_ids=[t])
'''
PYTOK_ALL = '''
async def generate(request, context):
    yield list(request.token_ids)
'''
PYSTR_ECHO = "async def generate(prompt, context):\n    yield prompt\n"
TOOL = {"type": "function", "function": {"name": "secret_tool"}}

# (id, kind, user file, endpoint, request)
PY_CASES = [
    ("pytok-reverse", "pytok", PYTOK, "completion",
     {"prompt": "abc", "max_tokens": 3}),
    ("pytok-max-tokens", "pytok", PYTOK, "completion",
     {"prompt": "abcdef", "max_tokens": 2}),
    ("pytok-engine-output", "pytok", PYTOK_EO, "completion",
     {"prompt": "abcdef", "max_tokens": 2}),
    ("pytok-multitoken", "pytok", PYTOK_ALL, "completion",
     {"prompt": "abcdef", "max_tokens": 2}),
    ("pytok-chat", "pytok", PYTOK, "chat",
     {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 6}),
    ("pystr-chat", "pystr", PYSTR, "chat",
     {"messages": [{"role": "user", "content": "hello"}]}),
    ("pystr-completion", "pystr", PYSTR, "completion",
     {"prompt": "plain text"}),
    ("pystr-tools-none", "pystr", PYSTR_ECHO, "chat",
     {"messages": [{"role": "user", "content": "x"}], "tools": [TOOL],
      "tool_choice": "none"}),
    ("pystr-tools", "pystr", PYSTR_ECHO, "chat",
     {"messages": [{"role": "user", "content": "x"}], "tools": [TOOL]}),
    ("pystr-multipart", "pystr", "async def generate(p, c):\n    yield 'ok'\n",
     "chat", {"messages": [{"role": "user",
                            "content": [{"type": "text", "text": "hi"}]}]}),
]


async def _py_stream(pkg, tmp_path, kind, src, endpoint, body):
    f = tmp_path / f"{pkg}_eng.py"
    f.write_text(src.format(pkg=pkg) if "{pkg}" in src else src)
    card = _mod(pkg, "llm.model_card").ModelDeploymentCard(name="pym")
    chat, comp = _mod(pkg, "llm.python_engine").build_python_engines(
        f"{kind}:{f}", card)
    oa = _mod(pkg, "llm.protocols.openai")
    Context = _mod(pkg, "runtime.engine").Context
    if endpoint == "chat":
        req = oa.ChatCompletionRequest.from_dict({"model": "pym", **body})
        engine, agg = chat, oa.aggregate_chat_chunks
    else:
        req = oa.CompletionRequest.from_dict({"model": "pym", **body})
        engine, agg = comp, oa.aggregate_completion_chunks
    chunks = [c async for c in engine.generate(req, Context())
              if "event" not in c]
    out = agg(chunks)
    for k in ("id", "created"):
        out.pop(k, None)
    return out


@pytest.mark.parametrize("case", PY_CASES, ids=[c[0] for c in PY_CASES])
async def test_python_engines_stream_as_jax(case, tmp_path):
    _, kind, src, endpoint, body = case
    got = {pkg: await _py_stream(pkg, tmp_path, kind, src, endpoint, body)
           for pkg in PKGS}
    assert got[T] == got[J]
    choice = got[T]["choices"][0]
    text = choice.get("text", (choice.get("message") or {}).get("content"))
    assert text and got[T]["usage"]["completion_tokens"] > 0
    if case[0] == "pytok-max-tokens":
        assert text == "fe" and choice["finish_reason"] == "length"
    if case[0] == "pystr-tools":
        assert "secret_tool" in text


async def test_python_engine_errors_and_stop_close_the_generator(tmp_path):
    pe = _mod(T, "llm.python_engine")
    card = _mod(T, "llm.model_card").ModelDeploymentCard(name="pym")
    bad = tmp_path / "nogen.py"
    bad.write_text("x = 1\n")
    for spec, match in ((f"pytok:{bad}", "generate"),
                        ("pytok:/nope/missing.py", "not found"),
                        ("pystr:", "path"), ("pyfoo:x.py", "unknown")):
        with pytest.raises(pe.PythonEngineError, match=match):
            pe.build_python_engines(spec, card)
    oa = _mod(T, "llm.protocols.openai")
    with pytest.raises(oa.ProtocolError):
        f = tmp_path / "s.py"
        f.write_text(PYSTR)
        _, comp = pe.build_python_engines(f"pystr:{f}", card)
        async for _ in comp.generate(
                oa.CompletionRequest.from_dict({"model": "pym",
                                                "prompt": [1, 2, 3]}),
                _mod(T, "runtime.engine").Context()):
            pass
    sentinel = tmp_path / "closed.txt"
    f = tmp_path / "eng.py"
    f.write_text(f"""
async def generate(request, context):
    try:
        for t in request.token_ids:
            yield t
    finally:
        open({str(sentinel)!r}, "w").write("closed")
""")
    _, comp = pe.build_python_engines(f"pytok:{f}", card)
    ctx = _mod(T, "runtime.engine").Context()
    n = 0
    async for _ in comp.generate(oa.CompletionRequest.from_dict(
            {"model": "pym", "prompt": "abcdefgh", "max_tokens": 8}), ctx):
        n += 1
        if n == 2:
            ctx.stop_generating()
    assert sentinel.exists() and n < 10


@pytest.mark.parametrize("out", ["echo_core", "echo_full", "pytok", "pystr"])
async def test_run_stdin_prints_what_jax_prints(out, tmp_path, monkeypatch,
                                               capsys):
    """``cli.run in=stdin`` over each CPU-level engine: the port's CLI
    prints what the JAX CLI prints for the same standard input."""
    monkeypatch.setenv("DYN_TOKEN_ECHO_DELAY_MS", "0")
    f = tmp_path / "eng.py"
    f.write_text(PYTOK if out == "pytok" else PYSTR)
    spec = f"{out}:{f}" if out.startswith("py") else out
    printed = {}
    for pkg in PKGS:
        monkeypatch.setattr("sys.stdin", io.StringIO("what is two and two"))
        await _mod(pkg, "cli.run").amain(
            ["in=stdin", f"out={spec}", "--max-tokens", "12",
             "--model-name", "m"])
        printed[pkg] = capsys.readouterr().out
    assert printed[T] == printed[J] and printed[T].strip()


# ---------------------------------------------------------------------------
# ctl: the records it writes
# ---------------------------------------------------------------------------

CTL_WRITES = [
    ("http-add-chat", ["http", "add", "chat", "m1", "dynamo.backend.generate"]),
    ("http-add-both", ["http", "add", "both", "m2", "ns.comp.ep",
                       "--kv-block-size", "16"]),
    ("disagg-set", ["disagg", "set", "--namespace", "dn", "--model", "m1",
                    "--max-local-prefill-length", "512",
                    "--max-prefill-queue-size", "3"]),
    ("fleet-add", ["fleet", "add", "fm", "--engine", "torch", "--chips", "2",
                   "--min-replicas", "1", "--max-replicas", "3",
                   "--priority", "5", "--tenant",
                   "acme:rps=5,burst=10,concurrency=8", "--tenant", "b:rps=1",
                   "--worker-args", "--x 1 --y", "--swap-group", "g",
                   "--prewarm"]),
    ("fleet-add-echo", ["fleet", "add", "fe", "--engine", "echo",
                        "--namespace", "other", "--component", "pool"]),
]
# what each package's ctl prints for the records written above, read back
CTL_READS = [["http", "list"], ["fleet", "list"],
             ["fleet", "list", "--namespace", "other"],
             ["disagg", "get", "--namespace", "dn", "--model", "m1"],
             ["disagg", "get"], ["incident", "ls"], ["flows"]]


async def _ctl(pkg, port, argv, capsys):
    ctl = _mod(pkg, "cli.ctl")
    rc = await ctl.run(ctl.parse_args(["--store", f"127.0.0.1:{port}",
                                       *argv]))
    return rc, capsys.readouterr().out


async def _dump(port):
    drt = await _mod(T, "runtime.component").DistributedRuntime(
        store_port=port).connect()
    try:
        return {k: v for k, v in await drt.store.get_prefix("")
                if not k.startswith(("metrics_stage/_store/", "instances/"))}
    finally:
        await drt.close()


async def test_ctl_records_equal_jax_both_ways(capsys):
    """Each write, made by either package's ``ctl`` into a store of its
    own, leaves the same keys and bytes; then each package's ``ctl`` reads
    both stores and prints the same lines. ``fleet remove`` and ``http
    remove`` take the records out again alike."""
    async with store() as pj, store() as pt:
        ports = {J: pj, T: pt}
        for _, argv in CTL_WRITES:
            for pkg in PKGS:
                rc, _ = await _ctl(pkg, ports[pkg], argv, capsys)
                assert rc == 0
        dumps = {pkg: await _dump(p) for pkg, p in ports.items()}
        assert dumps[T] == dumps[J] and len(dumps[T]) >= 6
        for argv in CTL_READS:
            outs = {(reader, writer): await _ctl(reader, ports[writer], argv,
                                                 capsys)
                    for reader in PKGS for writer in PKGS}
            assert len(set(outs.values())) == 1, (argv, outs)
        for argv in (["fleet", "remove", "fm"],
                     ["http", "remove", "both", "m2"]):
            for pkg in PKGS:
                await _ctl(pkg, ports[pkg], argv, capsys)
        assert await _dump(pt) == await _dump(pj)


async def test_ctl_fleet_engine_default_and_incidents(capsys, tmp_path):
    """``fleet add`` without ``--engine`` records ``torch`` in the port
    (``jax`` in JAX), and the port's planner serves either on its torch
    worker; a captured incident lists, shows and exports in both."""
    from dynamo_tpu_torch.fleet.registry import worker_engine

    async with store() as port:
        for pkg, name in ((J, "a"), (T, "b")):
            await _ctl(pkg, port, ["fleet", "add", name], capsys)
        drt = await _mod(T, "runtime.component").DistributedRuntime(
            store_port=port).connect()
        try:
            specs = {s.name: s for s in await _mod(
                T, "fleet.registry").list_fleet_models(drt.store, "dynamo")}
        finally:
            await drt.close()
        assert (specs["a"].engine, specs["b"].engine) == ("jax", "torch")
        assert {worker_engine(s.engine) for s in specs.values()} == {"torch"}
        rc, out = await _ctl(T, port, ["incident", "capture", "--reason",
                                       "probe"], capsys)
        iid = out.split()[1]
        assert rc == 0 and "-probe-" in iid
        ls = {pkg: (await _ctl(pkg, port, ["incident", "ls"], capsys))[1]
              for pkg in PKGS}
        assert iid in ls[T] and iid in ls[J]
        shown = {pkg: await _ctl(pkg, port, ["incident", "show", iid],
                                 capsys) for pkg in PKGS}
        assert shown[T] == shown[J]
        files = {}
        for pkg in PKGS:
            files[pkg] = str(tmp_path / f"{pkg}.json")
            await _ctl(pkg, port, ["incident", "export", iid, "-o",
                                   files[pkg]], capsys)
        bundles = [json.load(open(f)) for f in files.values()]
        assert bundles[0] == bundles[1] and bundles[0]["manifest"]["id"] == iid


# ---------------------------------------------------------------------------
# dyntop
# ---------------------------------------------------------------------------

def _stage_dump(pkg, rank):
    """A worker's stage registry with the series every dyntop line reads."""
    pr = _mod(pkg, "utils.prometheus")
    sm = pr.StageMetrics(pr.Registry())
    sm.kv_tier_hits.inc("host", amount=6 + rank)
    sm.kv_tier_misses.inc(amount=2)
    sm.kv_tier_blocks.set("host", f"w{rank}", value=40.0)
    sm.kv_cluster_hits.inc(amount=3)
    sm.kv_cluster_fetches.inc(amount=2 + rank)
    sm.kv_transfer_bytes.inc("recv", amount=5e6 * (rank + 1))
    sm.kv_transfer_bytes.inc("send", amount=5e6)
    sm.kv_pair_bw.set("q", f"w{rank}", value=2e9 + rank * 1e9)
    sm.kv_stream_ingests.inc(amount=4)
    sm.kvpage_demotions.inc(amount=10 + rank)
    sm.kvpage_resident_bytes.set("device", f"w{rank}", value=3e6)
    sm.kvpage_resident_bytes.set("host", f"w{rank}", value=9e6)
    sm.link_bytes.inc(f"w{rank}", "w9", "disagg_push", amount=7e6)
    sm.link_bytes.inc("host:1", f"dev:{rank}", "kvpage_pagein", amount=2e6)
    sm.compiled_programs.inc("prefill", amount=3)
    for v in (0.05, 0.2, 0.4):
        sm.ttft.observe("m", value=v)
    return sm.registry.state_dump()


async def test_dyntop_renders_what_jax_renders(monkeypatch, capsys):
    """One store with a JAX and a port worker's metrics and stage dumps, a
    store self-dump, a fleet model and an incident: ``dyntop --once
    --plain`` prints the same text from either package, with its
    ``store:``, ``fleet``, ``cluster:``, ``links:`` and ``paging:`` lines;
    a snapshotter's second refresh (rates) renders alike too."""
    now = 1.7e9

    clock = argparse.Namespace(time=lambda: now, monotonic=time.monotonic)

    for pkg in PKGS:
        monkeypatch.setattr(_mod(pkg, "cli.dyntop"), "time", clock)
    monkeypatch.setenv("DYN_STORE_METRICS_INTERVAL", "0")
    ss = _mod(T, "runtime.store_server")
    srv = ss.PyStoreServer()
    port = await srv.start()
    rts = []
    try:
        for rank, pkg in enumerate(PKGS):
            drt = await _mod(pkg, "runtime.component").DistributedRuntime(
                store_port=port).connect()
            rts.append(drt)
            ma = _mod(pkg, "llm.metrics_aggregator")
            m = _mod(pkg, "llm.kv_router.protocols").ForwardPassMetrics(
                request_active_slots=1 + rank, request_total_slots=8,
                kv_active_blocks=30, kv_total_blocks=100,
                gpu_prefix_cache_hit_rate=0.25, mfu=0.1, mbu=0.2,
                hbm_gbps=40.0 + rank)
            await drt.store.put(
                ma.metrics_key("dynamo", "backend", drt.worker_id),
                json.dumps(m.to_dict()).encode(), lease=drt.lease)
            dump = _stage_dump(pkg, rank)
            await ma.StagePublisher(drt.store, "dynamo", "backend",
                                    drt.worker_id, drt.lease,
                                    dump_fn=lambda d=dump: d).publish()
        await rts[0].store.put(ss.SELF_STAGE_KEY, json.dumps(
            {"component": "store",
             "metrics": srv.stats.registry.state_dump()}).encode())
        reg = _mod(T, "fleet.registry")
        await reg.put_fleet_model(rts[1].store, "dynamo", reg.FleetModelSpec(
            name="fm", component="backend", min_replicas=1, max_replicas=2))
        await reg.publish_fleet_status(rts[1].store, "dynamo", "fm", {
            "state": "serving", "replicas": 1, "target": 2, "chips": 1,
            "burn": 0.5, "wake_path": "swap", "wake_seconds": 1.25})
        beacon = {"id": "1700000000-manual-abc123", "reason": "manual",
                  "at": now - 12.0, "window": [now - 42, now - 12],
                  "trace_id": None, "detail": {}, "by": "test"}
        inc = _mod(T, "obs.incidents")
        await rts[1].store.put(inc.incident_beacon_key("dynamo", beacon["id"]),
                               json.dumps(beacon).encode())
        texts = {}
        for pkg in PKGS:
            dt = _mod(pkg, "cli.dyntop")
            args = dt.parse_args(["--store", f"127.0.0.1:{port}", "--once",
                                  "--plain"])
            texts[pkg] = await dt.run_once(args)
            snaps = []
            snapper = dt.ClusterSnapshotter(rts[0].store, "dynamo",
                                            ["backend", "prefill"])
            for _ in range(2):
                snaps.append(dt.render(await snapper.collect(),
                                       store_detail=True))
            texts[pkg, "detail"] = snaps[0]
        assert texts[T] == texts[J]
        assert texts[T, "detail"] == texts[J, "detail"]
        lines = texts[T].splitlines()
        for head in ("store:", "fleet:", "cluster:", "links:", "paging:",
                     "compiles:", "incidents:"):
            assert any(l.startswith(head) for l in lines), (head, texts[T])
        for drt in rts:
            assert any(l.split()[:1] == [f"{drt.worker_id:x}"]
                       for l in lines)
    finally:
        for drt in rts:
            await drt.close()
        await srv.stop()


# ---------------------------------------------------------------------------
# tracectl
# ---------------------------------------------------------------------------

def _spans(pkg, trace_id, pid0):
    tr = _mod(pkg, "utils.tracing")
    out = []
    base = 1000.0
    for i, (name, comp, parent) in enumerate((
            ("http:completions", "http", None), ("preprocess", "http", 0),
            ("route", "router", 0), ("rpc:generate", "decode_worker", 0),
            ("prefill", "decode_worker", 3))):
        out.append(tr.Span(
            trace_id=trace_id, span_id=f"s{i}", name=name, component=comp,
            pid=pid0 + (i > 1) + (i > 2),
            parent_id=None if parent is None else f"s{parent}",
            start=base + 0.01 * i, end=base + 0.2 - 0.02 * i,
            status="ok" if i != 4 else "error", attrs={"i": i}).to_dict())
    return out


def test_tracectl_waterfall_decisions_and_bundle_export(tmp_path, capsys):
    """The waterfall and decision text of the same spans and audit ring,
    and ``--bundle`` (summary, ``--json``, ``--chrome`` merging the trace
    with every process ring) give the same output in both packages."""
    spans = _spans(T, "t-1", 100)
    decisions = [{"seq": 1, "isl_tokens": 70, "isl_blocks": 4,
                  "worker_id": 0xab, "overlap_blocks": 2, "retries": 1,
                  "candidates": [
                      {"worker_id": 0xab, "logit": 1.5, "overlap_norm": 0.5,
                       "cache_usage": 0.25, "load": 0.1},
                      {"worker_id": 0xcd, "logit": -0.5, "overlap_norm": 0.0,
                       "cache_usage": 0.5, "load": 0.9, "saturated": True}]},
                 {"seq": 2, "isl_tokens": 3, "worker_id": None}]
    bundle = {"manifest": {"id": "i1", "reason": "manual", "at": 1000.0,
                           "window": [970.0, 1000.0], "trace_id": "t-1",
                           "detail": {}, "by": "test"},
              "trace": spans[:3], "processes": {
                  "http:1": {"rings": {"spans": {"items": spans[1:2]}}},
                  "decode_worker:2": {"rings": {"spans": {
                      "items": spans[3:]}}}}}
    path = tmp_path / "bundle.json"
    path.write_text(json.dumps(bundle))
    out = {}
    for pkg in PKGS:
        tc = _mod(pkg, "cli.tracectl")
        got = [tc.render_timeline(spans), tc.render_decisions(decisions)]
        for extra in ([], ["--json"], ["--chrome", str(tmp_path / pkg)]):
            rc = tc.run(tc.parse_args(["--bundle", str(path), *extra]))
            assert rc == 0
            got.append(capsys.readouterr().out.replace(str(tmp_path / pkg),
                                                       "FILE"))
        got.append(json.load(open(tmp_path / pkg)))
        out[pkg] = got
    assert out[T] == out[J]
    assert "!ERROR" in out[T][0] and "SATURATED" in out[T][1]
    events = out[T][-1]["traceEvents"]
    assert len({e["pid"] for e in events if e.get("ph") == "X"}) == 3


async def test_tracectl_reads_the_ports_frontend(tmp_path):
    """Live: both packages' ``tracectl`` against the port's frontend,
    whose store holds spans another process published: the same list,
    waterfall and Chrome file; an unknown id is an error in both."""
    from dynamo_tpu_torch.llm.http_service import HttpService, ModelManager

    async with store() as port:
        drt = await _mod(T, "runtime.component").DistributedRuntime(
            store_port=port).connect()
        tr = _mod(T, "utils.tracing")
        sink = await tr.StoreSpanSink(drt.store).start()
        for d in _spans(T, "t-live", 300):
            sink._on_finish(tr.Span.from_dict(d))
        await sink.stop()
        svc = HttpService(ModelManager(), host="127.0.0.1", port=0,
                          store=drt.store)
        hport = await svc.start()
        try:
            def runs(pkg):
                tc = _mod(pkg, "cli.tracectl")
                url = f"http://127.0.0.1:{hport}"
                chrome = str(tmp_path / f"{pkg}.json")
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf), \
                        contextlib.redirect_stderr(io.StringIO()):
                    rcs = [tc.run(tc.parse_args(a)) for a in (
                        ["t-live", "--url", url],
                        ["t-live", "--url", url, "--chrome", chrome],
                        ["nope", "--url", url, "--json"])]
                return rcs, buf.getvalue().replace(chrome, "F"), \
                    json.load(open(chrome))

            got = {pkg: await asyncio.to_thread(runs, pkg) for pkg in PKGS}
        finally:
            await svc.stop()
            await drt.close()
    assert got[T] == got[J]
    rcs, text, chrome = got[T]
    assert rcs[:2] == [0, 0] and "trace t-live — 5 spans" in text
    assert len([e for e in chrome["traceEvents"] if e.get("ph") == "X"]) == 5


# ---------------------------------------------------------------------------
# the aggregator and the mock worker
# ---------------------------------------------------------------------------

def test_mock_worker_ramp_equals_jax():
    for tick in range(40):
        snaps = [_mod(pkg, "cli.mock_worker").snapshot(tick, 8, 64).to_dict()
                 for pkg in PKGS]
        assert snaps[0] == snaps[1]


async def test_metrics_cli_serves_and_pushes_the_jax_exposition():
    """Each package's mock worker publishes its ramp; both aggregators
    scrape the same store (with a worker's stage dump) and render the same
    bytes; ``cli.metrics`` serves them on ``/metrics`` of the port's own
    server, and in push mode PUTs them to a pushgateway."""
    from dynamo_tpu_torch.cli import metrics as cm
    from dynamo_tpu_torch.llm.http_service import HttpServer, Response

    async with store() as port:
        tasks, rts, aggs = [], [], {}
        try:
            for i, pkg in enumerate(PKGS):
                args = argparse.Namespace(
                    store=f"127.0.0.1:{port}", namespace="ns", component="c",
                    period=0.05, total_slots=4, kv_total=64)
                ready = asyncio.Event()
                tasks.append(asyncio.create_task(_mod(
                    pkg, "cli.mock_worker").run_mock_worker(
                        args, ready_event=ready)))
                await asyncio.wait_for(ready.wait(), 10)
            drt = await _mod(T, "runtime.component").DistributedRuntime(
                store_port=port).connect()
            rts.append(drt)
            await _mod(T, "llm.metrics_aggregator").StagePublisher(
                drt.store, "ns", "c", drt.worker_id, drt.lease,
                dump_fn=lambda: _stage_dump(T, 0)).publish()
            for pkg in PKGS:
                d = await _mod(pkg, "runtime.component").DistributedRuntime(
                    store_port=port).connect()
                rts.append(d)
                aggs[pkg] = _mod(pkg, "llm.metrics_aggregator") \
                    .ClusterMetricsAggregator(d, "ns", ["c"])
                await aggs[pkg].scrape_once()
            text = aggs[T].render()
            assert text == aggs[J].render()
            assert len(aggs[T].workers["c"]) == 2 and "llm_load_avg" in text
            server = cm.build_server(aggs[T], 0)
            sport = await server.start()
            pushed = asyncio.Queue()

            async def sink(req):
                await pushed.put((req.method, req.headers.get("content-type"),
                                  req.body))
                return Response(200, b"ok", "text/plain")

            gateway = HttpServer("127.0.0.1", 0,
                                 {("PUT", "/metrics/job/dynamo"): sink})
            gport = await gateway.start()
            pusher = asyncio.create_task(cm.push_loop(
                aggs[T], f"http://127.0.0.1:{gport}/metrics/job/dynamo", 30))
            try:
                def get():
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{sport}/metrics",
                            timeout=10) as r:
                        return r.status, r.headers["Content-Type"], r.read()

                status, ctype, body = await asyncio.to_thread(get)
                assert (status, ctype) == (200, "text/plain; charset=utf-8")
                assert body.decode() == text
                method, ptype, pbody = await asyncio.wait_for(pushed.get(),
                                                              10)
                assert (method, ptype, pbody.decode()) == ("PUT",
                                                           "text/plain", text)
            finally:
                pusher.cancel()
                await server.stop()
                await gateway.stop()
        finally:
            for task in tasks:
                task.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            for a in aggs.values():
                await a.stop()
            for d in rts:
                await d.close()
