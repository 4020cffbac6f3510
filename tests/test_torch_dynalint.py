"""The port's dynalint (``dynamo_tpu_torch.analysis``) against the JAX
package's framework, and the gate over the port's tree.

- Same-source parity, by rule: every synthetic source that
  ``tests/test_dynalint.py`` feeds a rule both packages have (read out of
  that file's AST, so the two stay one set of fixtures) goes through both
  frameworks, each rule's ``scope`` option pointed at a ``tmp_path`` tree;
  the ``(rule, line, key)`` sets must be equal. ``flow-accounting`` and
  ``loop-blocking-path``, which that file does not exercise, get shared
  fixtures here.
- ``host-sync`` is the one rule whose lattice differs (torch, not jax):
  each of the JAX file's ``jnp`` fixtures has a torch twin here, flagged on
  the same lines with the same keys; torch-only sinks are flagged, and
  host tensors (pinned, ``device="cpu"``, ``torch.from_numpy``, a CPU
  generator's draws) are not.
- Every ``.item()``/``.tolist()``/``.cpu()``/``.numpy()``/``synchronize``
  site in the rule's port scope is in its inventory, or is one of the
  host-side shapes the fixtures above show unflagged.
- The knob and keyspace documents equal their ``render_markdown()``; the
  whole port is clean through ``python -m dynamo_tpu_torch.cli.dynalint``
  with an empty baseline, and ``--report host-sync --json`` lists every
  suppressed site with its reason.
- ``dynamo_tpu_torch.analysis`` imports neither ``jax`` nor
  ``dynamo_tpu``.
- The flow-ledger divergence the port's ``flow-accounting`` found: an
  eviction-only flush puts the evicted pages' bytes on the ledger under
  ``d2h_writethrough``, as the JAX engine does.
"""

import ast
import contextlib
import io
import json
import re
import textwrap
from pathlib import Path

import pytest

from dynamo_tpu.analysis import runner as jrunner
from dynamo_tpu.analysis.core import Module as JModule
from dynamo_tpu.analysis.rules.host_sync import HostSyncRule as JHostSync
from dynamo_tpu_torch.analysis import runner as trunner
from dynamo_tpu_torch.analysis.core import Module as TModule
from dynamo_tpu_torch.analysis.rules.host_sync import HostSyncRule

ROOT = Path(__file__).resolve().parent.parent
JAX_TESTS = ROOT / "tests" / "test_dynalint.py"

#: the rules both frameworks have, by the prefix of the JAX file's tests
PER_FILE = {
    "test_blocking_async_": "blocking-async",
    "test_fire_forget_": "fire-and-forget",
    "test_silent_except_": "swallowed-exception",
    "test_lock_discipline_": "lock-discipline",
    "test_unbounded_await_": "unbounded-await",
    "test_await_holding_lock_": "await-holding-lock",
}


def _jax_fixtures():
    """{test name: [dedented source, ...]} of the JAX dynalint tests: the
    string handed to ``mod_from``/``_mini_wire_tree`` or dedented for a
    ``write_text``."""
    tree = ast.parse(JAX_TESTS.read_text())
    out = {}
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        srcs = []
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = getattr(node.func, "id", getattr(node.func, "attr", ""))
            idx = {"mod_from": 1, "_mini_wire_tree": 1, "dedent": 0}.get(name)
            if idx is not None and len(node.args) > idx and isinstance(
                    node.args[idx], ast.Constant) and isinstance(
                    node.args[idx].value, str):
                srcs.append(textwrap.dedent(node.args[idx].value))
        if srcs:
            out[fn.name] = srcs
    return out


JAX_FIXTURES = _jax_fixtures()


def _per_file_cases():
    for test, srcs in JAX_FIXTURES.items():
        for prefix, rule in PER_FILE.items():
            if test.startswith(prefix):
                for k, src in enumerate(srcs):
                    yield pytest.param(rule, src, id=f"{test}[{k}]")


#: shared fixtures for the two per-file rules the JAX file does not drive
FLOW_SRC = """\
from ..obs.flows import record_flow


class Core:
    def metered(self, pages):
        k, v = self.copy_stream.d2h_pages(self.k_pool, self.v_pool, pages)
        record_flow("d2h_writethrough", k.nbytes + v.nbytes)

    def unmetered(self, pages, k, v):
        self.copy_stream.h2d_pages(self.k_pool, self.v_pool, pages, k, v)
        self.copy_stream.scatter_blocks(self.k_pool, self.v_pool, pages,
                                        k, v)

    def closure(self, pages):
        def inner():
            self.copy_stream.d2h_pages(self.k_pool, self.v_pool, pages)
        record_flow("x", 1)
        return inner

    async def push(self, client, req):
        async for _ in client.generate(req, mode="direct"):
            pass
        # dynalint: ok(flow-accounting) a suppressed site
        self.copy_stream.h2d_param_slab(self.buf, 0, req)
"""

LOOP_SRC = """\
import subprocess
import time


def _settle():
    time.sleep(0.1)


def _probe():
    _settle()


class Daemon:
    def _spawn(self):
        return subprocess.run(["true"])

    async def tick(self, loop):
        _probe()
        self._spawn()
        await loop.run_in_executor(None, lambda: _probe())

    async def fine(self):
        return len("x")
"""


def _findings(res):
    return {(f.rule, f.line, f.key) for f in res.findings}


def _both_per_file(tmp_path, rule, src):
    pkg = tmp_path / "pkg"
    pkg.mkdir(exist_ok=True)
    (pkg / "m.py").write_text(src)
    cfg = {rule: {"scope": ["pkg"]}}
    kw = dict(paths=[str(pkg)], rule_names=[rule], config=cfg,
              repo=str(tmp_path))
    return (_findings(jrunner.run_lint(**kw)),
            _findings(trunner.run_lint(**kw)))


@pytest.mark.parametrize("rule,src", [
    *_per_file_cases(),
    pytest.param("flow-accounting", FLOW_SRC, id="flow-accounting"),
    pytest.param("loop-blocking-path", LOOP_SRC, id="loop-blocking-path"),
])
def test_per_file_rules_match_jax_on_the_same_source(tmp_path, rule, src):
    want, got = _both_per_file(tmp_path, rule, src)
    assert got == want


def test_shared_fixtures_flag_what_they_should(tmp_path):
    """The two fixtures of this file are not vacuous: each rule flags
    the sites it exists for (and the JAX framework agrees, above)."""
    _, flow = _both_per_file(tmp_path, "flow-accounting", FLOW_SRC)
    assert {k for _r, _l, k in flow} == {
        "unmetered:h2d_pages", "unmetered:scatter_blocks",
        "push:generate[mode=direct]"}
    _, loop = _both_per_file(tmp_path, "loop-blocking-path", LOOP_SRC)
    assert {k for _r, _l, k in loop} == {
        "tick->_probe:time.sleep", "tick->_spawn:subprocess.run"}


def _repo_rule_both(tmp_path, rel, src, jcls, tcls):
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(src)
    out = []
    for mod_cls, cls in ((JModule, jcls), (TModule, tcls)):
        m = mod_cls(str(p), repo=str(tmp_path))
        out.append({(f.rule, f.line, f.key)
                    for f in cls().check_repo([m], str(tmp_path))
                    if f.path == rel})
    return out


def test_knob_drift_matches_jax_on_the_same_source(tmp_path):
    from dynamo_tpu.analysis.rules.knob_drift import KnobDriftRule as J
    from dynamo_tpu_torch.analysis.rules.knob_drift import KnobDriftRule

    (src,) = JAX_FIXTURES["test_knob_drift_unregistered_literal"]
    want, got = _repo_rule_both(tmp_path, "m.py", src, J, KnobDriftRule)
    assert got == want == {("knob-drift", 3,
                            "unregistered:DYN_TOTALLY_BOGUS")}


def test_store_key_drift_matches_jax_on_the_same_source(tmp_path):
    from dynamo_tpu.analysis.rules.store_key_drift import \
        StoreKeyDriftRule as J
    from dynamo_tpu_torch.analysis.rules.store_key_drift import \
        StoreKeyDriftRule

    (src,) = JAX_FIXTURES[
        "test_store_key_drift_flags_unregistered_and_unresolved"]
    want, got = _repo_rule_both(tmp_path, "dynamo_tpu/x.py", src, J,
                                StoreKeyDriftRule)
    assert got == want
    assert {k for _r, _l, k in got} == {"rogue:put", "opaque:put"}


def test_store_key_resolver_matches_jax_on_the_same_source(tmp_path):
    from dynamo_tpu.analysis.rules.store_key_drift import _Resolver as JR
    from dynamo_tpu.runtime import keyspace as jks
    from dynamo_tpu_torch.analysis.rules.store_key_drift import _Resolver
    from dynamo_tpu_torch.runtime import keyspace

    (src,) = JAX_FIXTURES[
        "test_store_key_resolver_chases_fstrings_and_helpers"]
    p = tmp_path / "m.py"
    p.write_text(src)
    got = []
    for mod_cls, res, ks in ((JModule, JR, jks), (TModule, _Resolver,
                                                 keyspace)):
        m = mod_cls(str(p), repo=str(tmp_path))
        r = res(m, ks)
        seen = {}
        for node in ast.walk(m.tree):
            if isinstance(node, ast.AsyncFunctionDef):
                for call in ast.walk(node):
                    if isinstance(call, ast.Call) and isinstance(
                            call.func, ast.Attribute) and call.func.attr in (
                            "get_prefix", "put", "delete"):
                        seen.setdefault(node.name,
                                        r.resolve(call.args[0], node))
        got.append(seen)
    assert got[1] == got[0]
    assert got[1]["a"] == ("family", "planner") and got[1]["f"] is None


@pytest.mark.parametrize("test", [
    t for t in JAX_FIXTURES if t.startswith("test_wire_field_drift_")])
def test_wire_field_drift_matches_jax_on_the_same_source(tmp_path, test):
    from dynamo_tpu.analysis.rules.wire_field_drift import \
        WireFieldDriftRule as J
    from dynamo_tpu_torch.analysis.rules.wire_field_drift import \
        WireFieldDriftRule

    wire = textwrap.dedent(JAX_FIXTURES["_mini_wire_tree"][0])
    got = []
    for pkg, mod_cls, cls in (("dynamo_tpu", JModule, J),
                              ("dynamo_tpu_torch", TModule,
                               WireFieldDriftRule)):
        root = tmp_path / pkg
        rt = root / "runtime"
        rt.mkdir(parents=True)
        (rt / "wire.py").write_text(wire)
        (rt / "component.py").write_text(JAX_FIXTURES[test][0])
        mods = [mod_cls(str(rt / n), repo=str(tmp_path))
                for n in ("wire.py", "component.py")]
        got.append({(f.rule, f.line, f.key)
                    for f in cls().check_repo(mods, str(tmp_path))})
    assert got[1] == got[0]
    assert bool(got[1]) == ("clean" not in test)


def test_metrics_catalog_matches_jax_on_the_same_source(tmp_path):
    from dynamo_tpu.analysis.rules import metrics_catalog as jmc
    from dynamo_tpu_torch.analysis.rules import metrics_catalog as tmc

    (src,) = JAX_FIXTURES["test_metrics_catalog_synthetic"]
    p = tmp_path / "m.py"
    p.write_text(src)
    got = []
    for mod_cls, mc in ((JModule, jmc), (TModule, tmc)):
        reg = mc.registered_in_module(mod_cls(str(p), repo=str(tmp_path)))
        got.append((set(reg), {(f.rule, f.key) for f in mc.catalog_findings(
            reg, {"dyn_things_total", "dyn_ghost"})}))
    assert got[1] == got[0]


# ---------------------------------------------------------------------------
# host-sync: the torch lattice
# ---------------------------------------------------------------------------

#: torch twins of the JAX file's host-sync fixtures, line for line
TWINS = {
    "test_host_sync_positive_and_negative": """\
import torch
from dynamo_tpu_torch.device import to_device
import numpy as np

def step(x): return x.cuda(non_blocking=True) * 2

def bad(x):
    out = step(x)
    t = int(out[0])             # sync: a device result
    arr = np.asarray(out)       # sync: wholesale fetch
    torch.ones(3, device="cuda").tolist()  # sync: a device constructor
    return t, arr

def fine(host_list):
    a = np.asarray(host_list)   # host data: no device involved
    n = int(a[0])
    to_device(a, torch.device("cuda"))  # pinned non-blocking upload
    return n

def metadata(x):
    out = step(x)
    return out.shape, out.dtype  # host metadata, no transfer
""",
    "test_host_sync_container_truthiness_not_flagged": """\
import torch, collections
import numpy as np

class E:
    def __init__(self):
        self._q = collections.deque()
        self._dev = torch.device("cuda")

    def push(self):
        self._q.append({"packed": torch.zeros(1, device=self._dev)})

    def busy(self):
        return bool(self._q)          # len check: fine

    def pop(self):
        rec = self._q.popleft()
        return np.asarray(rec["packed"])   # the actual sync
""",
    "test_host_sync_statement_level_closure_scanned": """\
import torch
import numpy as np

def step(x): return x.cuda(non_blocking=True)

def outer(x):
    def inner():
        out = step(x)
        return np.asarray(out)     # sync inside the closure
    return inner

def shadowed(x):
    out = step(x)                  # device in the OUTER scope
    def inner(out):
        return np.asarray(out)     # param shadows: unknown host
    return inner, int(out[0])      # the outer sync IS flagged
""",
}


def _hits(tmp_path, cls, mod_cls, src, name="m.py"):
    p = tmp_path / name
    p.write_text(src)
    return {(f.line, f.key)
            for f in cls().check_module(mod_cls(str(p), repo=str(tmp_path)))}


@pytest.mark.parametrize("test", sorted(TWINS))
def test_host_sync_torch_twin_flags_the_jax_lines(tmp_path, test):
    (src,) = JAX_FIXTURES[test]
    want = _hits(tmp_path, JHostSync, JModule, src, "jax_m.py")
    got = _hits(tmp_path, HostSyncRule, TModule, TWINS[test])
    assert want and got == want


TORCH_ONLY = """\
import torch
from dynamo_tpu_torch.device import to_device


def sinks(host, dev, idx):
    x = torch.zeros(4, device=dev)
    a = x.sum().item()                          # 7: .item()
    b = x.cpu()                                 # 8: .cpu()
    c = x.to("cpu")                             # 9: .to(cpu)
    d = x.to("cpu", non_blocking=True)          # no sync
    if x.any():                                 # 11: truthiness
        pass
    torch.cuda.synchronize()                    # 13: barrier
    ev = torch.cuda.Event()
    ev.synchronize()                            # 15: event barrier
    n = torch.nonzero(x)                        # 16: data-dependent
    m = x[x > 0]                                # 17: mask index
    r = x.repeat_interleave(2)                  # 18: output size read
    s = x.repeat_interleave(2, output_size=8)   # no sync
    u = torch.tensor(host, device=dev)          # 20: blocking upload
    w = host.to(dev)                            # 21: blocking upload
    y = to_device(host, dev)                    # pinned, non-blocking
    z = x[[0, 1]]                               # 23: list index upload
    x[0] = 1                                    # 24: setitem upload
    x[1] = x[2]                                 # device to device
    return a, b, c, d, n, m, r, s, u, w, y, z, idx
"""


def test_host_sync_flags_the_torch_sinks(tmp_path):
    got = _hits(tmp_path, HostSyncRule, TModule, TORCH_ONLY)
    assert {line for line, _ in got} == {7, 8, 9, 11, 13, 15, 16, 17, 18,
                                         20, 21, 23, 24}


HOST_SIDE = """\
import numpy as np
import torch


def pinned(shape):
    h = torch.empty(shape, dtype=torch.float32, pin_memory=True)
    return h.sum().item(), h.numpy(), h.tolist()


def cpu_device(n):
    t = torch.arange(n, device="cpu")
    return t.max().item(), int(t[0]), bool(t.any())


def from_numpy(a):
    t = torch.from_numpy(np.asarray(a))
    return t.sum().item(), t.numpy()


def cpu_draws(n, gen):
    # kvpage runner: a lane's uniforms from its CPU generator
    return torch.rand(n, generator=gen).numpy()


def host_dtype(dtype):
    # kvbm transfer: the numpy dtype of a pool dtype
    return torch.empty((), dtype=dtype).numpy().dtype


def to_host_array(t):
    # kvbm transfer: a CPU tensor as a numpy view (the caller's copy)
    return t.numpy()


def cpu_engine(cfg):
    pool = torch.zeros((2, 8), device=torch.device("cpu"))
    if pool.sum() > 0:
        return pool.cpu().numpy()
    return pool.tolist()
"""


def test_host_tensors_are_not_flagged(tmp_path):
    assert _hits(tmp_path, HostSyncRule, TModule, HOST_SIDE) == set()


def test_colocated_parameters_and_card_only_modules(tmp_path):
    """A function that allocates on a tensor parameter's device takes its
    tensor parameters to be on the card (the MoE dispatch's host read);
    a card-only tool's compute calls are device values."""
    src = """\
import torch
from dynamo_tpu_torch.ops import attention as tatt


def dispatch(x: torch.Tensor, idx: torch.Tensor, E: int) -> torch.Tensor:
    y = torch.empty(x.shape, device=x.device)
    return torch.bincount(idx.reshape(-1), minlength=E).tolist(), y


def helper(x: torch.Tensor) -> float:
    return float(x.sum())


def check(fn, x):
    want = tatt.paged_attention_plain(*x).float()
    return (fn(*x) - want).abs().max().item()
"""
    got = _hits(tmp_path, HostSyncRule, TModule, src)
    assert {k for _l, k in got} == {"dispatch:.tolist()",
                                    "dispatch:torch.bincount"}
    from dynamo_tpu_torch.analysis.dataflow import get_device_taint

    p = tmp_path / "probe.py"
    p.write_text(src)
    taint = get_device_taint(TModule(str(p), repo=str(tmp_path)),
                             {"card_only": True})
    check = next(f for f in taint.top_level_functions()
                 if f.name == "check")
    assert [h.label for h in taint.sink_hits(check, "check")] == [".item()"]


#: the shapes of the grep sites that hold host tensors (HOST_SIDE shows
#: each unflagged): a CPU generator's draws, the host-dtype probe and the
#: numpy view of a host block
HOST_SITE_LINES = (
    re.compile(r"torch\.rand\(\s*$|torch\.rand\(.*generator=.*\.numpy\(\)"),
    re.compile(r"torch\.empty\(\(\), dtype=dtype\)\.numpy\(\)"),
    re.compile(r"^\s*return t\.numpy\(\)\s*$"),
)
GREP = re.compile(r"\.item\(\)|\.tolist\(\)|\.cpu\(\)|\.numpy\(\)|"
                  r"synchronize")


def _grep_sites():
    from dynamo_tpu_torch.analysis.rules.host_sync import SCOPE

    out = []
    for rel in SCOPE:
        p = ROOT / rel
        files = [p] if p.suffix == ".py" else sorted(p.rglob("*.py"))
        for f in files:
            lines = f.read_text().splitlines()
            for i, line in enumerate(lines, 1):
                code = line.split("#", 1)[0]
                if GREP.search(code):
                    out.append((f.relative_to(ROOT).as_posix(), i, line,
                                lines[i - 2] if i > 1 else ""))
    return out


@pytest.fixture(scope="module")
def host_sync_report():
    from dynamo_tpu_torch.cli import dynalint

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert dynalint.main(["--report", "host-sync", "--json"]) == 0
    return json.loads(buf.getvalue())


def test_every_grep_site_is_seen_or_host_side(host_sync_report):
    seen = {(s["path"], s["line"]) for s in host_sync_report["sites"]}
    # a multi-line call is reported at its first line: a site counts as
    # seen when the call it closes started on a seen line
    missing = []
    for rel, i, line, prev in _grep_sites():
        if (rel, i) in seen or (rel, i - 1) in seen:
            continue
        if any(p.search(line) or p.search(prev + line)
               for p in HOST_SITE_LINES):
            continue
        missing.append(f"{rel}:{i}: {line.strip()}")
    assert not missing, "\n".join(missing)
    assert len(_grep_sites()) >= 27


def test_report_lists_every_suppressed_site_with_its_reason(
        host_sync_report):
    r = host_sync_report
    assert r["open"] == 0 and r["baselined"] == 0
    assert r["suppressed"] == len(r["sites"]) >= 30
    assert all(s["status"] == "suppressed" and s["reason"]
               for s in r["sites"])
    # no annotation outlives its site: each one sits in the comment block
    # directly above a line the rule reports
    sites = {(s["path"], s["line"]) for s in r["sites"]}
    for rel in {s["path"] for s in r["sites"]}:
        lines = (ROOT / rel).read_text().splitlines()
        for i, line in enumerate(lines):
            if "dynalint: ok(host-sync)" in line:
                j = i
                while lines[j].strip().startswith("#"):
                    j += 1
                assert (rel, j + 1) in sites, f"{rel}:{i + 1}"
    keys = {s["key"] for s in r["sites"]}
    for k in ("EngineCore._prefill_dispatch:.cpu()",
              "EngineCore._process_oldest_inflight:.synchronize()",
              "EngineCore._spec_round:.cpu()",
              "PagedEngine._decode_window:.cpu()"):
        assert k in keys


# ---------------------------------------------------------------------------
# the gate over the port, its documents and its imports
# ---------------------------------------------------------------------------

def test_port_is_dynalint_clean(capsys):
    from dynamo_tpu_torch.cli import dynalint

    assert dynalint.main(["--json"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert not res["failed"] and res["findings"] == []
    assert res["grandfathered"] == [] and res["stale_baseline"] == []
    assert len(res["rules"]) == 13
    assert "tracer-leak" not in res["rules"]
    assert "recompile-hazard" not in res["rules"]
    assert res["elapsed_s"] < 10.0
    assert all(s["reason"] and s["reason"] != "(no reason)"
               for s in res["suppressed"])
    with open(dynalint.DEFAULT_BASELINE) as f:
        assert json.load(f) == {}


def test_generated_documents_equal_their_registries():
    from dynamo_tpu_torch.runtime import keyspace
    from dynamo_tpu_torch.utils import knobs

    for mod in (knobs, keyspace):
        assert (ROOT / mod.DOC_REL).read_text() == mod.render_markdown()
    assert len(keyspace.HELPER_INDEX) == sum(
        len(f.helpers) for f in keyspace.KEYSPACE.values())


def test_cli_rejects_missing_paths_and_narrows_to_file_rules(tmp_path,
                                                             capsys):
    from dynamo_tpu_torch.cli import dynalint

    with pytest.raises(SystemExit):
        dynalint.main([str(tmp_path / "no_such_dir")])
    empty = tmp_path / "empty"
    empty.mkdir()
    assert dynalint.main([str(empty)]) == 2
    py = tmp_path / "ok.py"
    py.write_text("x = 1\n")
    with pytest.raises(SystemExit):
        dynalint.main([str(py), "--write-baseline"])
    assert dynalint.main([str(py)]) == 0
    assert "9 rules" in capsys.readouterr().out


def test_analysis_imports_neither_jax_nor_the_jax_package():
    bad = []
    files = sorted((ROOT / "dynamo_tpu_torch" / "analysis").rglob("*.py"))
    files.append(ROOT / "dynamo_tpu_torch" / "cli" / "dynalint.py")
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for n in names:
                if n.split(".")[0] in ("jax", "dynamo_tpu", "torch"):
                    bad.append(f"{f.name}: {n}")
    assert not bad, bad


# ---------------------------------------------------------------------------
# the flow-ledger repair
# ---------------------------------------------------------------------------

def test_eviction_flush_puts_its_bytes_on_the_ledger_as_jax_does():
    """tiny-byte f32 with a host tier and no write-through; the second
    prompt evicts the first one's pages into the tier. Both engines put the
    same ``d2h_writethrough`` bytes on their ledgers (the port's used to
    record only the write-through share of a flush: nothing here)."""
    import jax.numpy as jnp
    import torch

    from dynamo_tpu.engine.engine import EngineCore as JaxCore
    from dynamo_tpu.engine.engine import JaxEngineConfig
    from dynamo_tpu.llm.protocols.common import BackendInput as JBI
    from dynamo_tpu.llm.protocols.common import StopConditions as JSC
    from dynamo_tpu.models import llama as jl
    from dynamo_tpu.obs import flows as jflows
    from dynamo_tpu_torch.engine.engine import EngineCore, TorchEngineConfig
    from dynamo_tpu_torch.llm.protocols.common import (BackendInput,
                                                       StopConditions)
    from dynamo_tpu_torch.models import llama as tl
    from dynamo_tpu_torch.obs import flows as tflows

    eng = dict(page_size=8, max_batch=1, max_context=64, prefill_chunk=32,
               decode_steps=4, num_pages=9, host_cache_blocks=16,
               disk_cache_blocks=0, cluster_writethrough=False)

    def drive(core, bi, sc):
        for sid, prompt in (("a", list(range(1, 33))),
                            ("b", list(range(100, 132)))):
            core.submit(sid, bi(token_ids=prompt,
                                stop=sc(max_tokens=4, ignore_eos=True)))
            for _ in range(100):
                core.step()
                if not core.has_work:
                    break
        return core.tiered.stats()["host_blocks"]

    totals = []
    jflows.flow_ledger().reset()
    jcore = JaxCore(JaxEngineConfig(
        model=jl.preset("tiny-byte", dtype=jnp.float32), **eng))
    try:
        blocks = [drive(jcore, JBI, JSC)]
    finally:
        jcore.close()
    totals.append(jflows.flow_ledger().total_bytes("d2h_writethrough"))
    tflows.flow_ledger().reset()
    tcore = EngineCore(TorchEngineConfig(
        model=tl.preset("tiny-byte", dtype=torch.float32), device="cpu",
        **eng))
    try:
        blocks.append(drive(tcore, BackendInput, StopConditions))
        assert tcore.writethrough_blocks == 0
    finally:
        tcore.close()
    totals.append(tflows.flow_ledger().total_bytes("d2h_writethrough"))
    assert blocks[0] == blocks[1] > 0
    assert totals[1] == totals[0] > 0
    assert totals[1] == tcore.copy_stream.d2h_bytes
