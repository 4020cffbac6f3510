"""The port's deploy layer (``dynamo_tpu_torch/deploy/``, ``cli/
deployctl.py``) held against the JAX package's on the same inputs: the
resource model, the operator's reconcile script under ``FakeRunner``, the
api-store's answers on both object-store backends, artifacts; then the
port's own ``LocalRunner`` on the CPU, and the JAX operator faults the port
does not copy (ROADMAP Queue 3 items 18-22)."""

import asyncio
import json
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from dynamo_tpu.deploy import crd as jcrd
from dynamo_tpu_torch.deploy import crd as tcrd
from dynamo_tpu_torch.deploy.object_store import http_request
from dynamo_tpu_torch.runtime.store_client import StoreClient
from dynamo_tpu_torch.runtime.store_server import PyStoreServer
from dynamo_tpu_torch.sdk import depends, dynamo_endpoint, service

ROOT = Path(__file__).resolve().parents[1]


# the port's twin of tests/test_deploy.py's graph (cards: gpu for tpu)
@service(namespace="dep")
class Backend:
    @dynamo_endpoint()
    async def generate(self, request, ctx):
        yield request


@service(namespace="dep", workers=2, resources={"gpu": 4})
class Frontend:
    backend = depends(Backend)

    @dynamo_endpoint()
    async def generate(self, request, ctx):
        yield request


# ---------------------------------------------------------------------------
# the resource model
# ---------------------------------------------------------------------------

def test_resource_roundtrip_equals_jax_with_gpus_for_tpu_chips():
    ingress = dict(enabled=True, host="h", envoy=True, port=80,
                   annotations={"a": "b"})
    want = jcrd.Deployment(name="agg", namespace="prod", generation=3,
                           spec=jcrd.DeploymentSpec(
        graph="tests.test_deploy:Frontend", store="s:1", platform="cpu",
        ingress=jcrd.IngressSpec(**ingress),
        services={"frontend": jcrd.ServiceSpec(
            replicas=3, tpu_chips=8, config={"port": 8000},
            envs={"A": "1"})})).to_dict()
    # a JAX resource reads as the same port resource
    got = tcrd.Deployment.from_dict(want)
    assert got.spec.services["frontend"].gpus == 8
    row = want["spec"]["services"]["frontend"]
    row["gpus"] = row.pop("tpu_chips")
    assert got.to_dict() == want
    assert tcrd.Deployment.from_bytes(got.to_bytes()).to_dict() == want
    assert tcrd.deploy_key("prod", "agg") == jcrd.deploy_key("prod", "agg")
    assert tcrd.status_key("prod", "agg") == jcrd.status_key("prod", "agg")
    st = tcrd.DeploymentStatus()
    st.set_condition("WorkersReady", "False", "r", "m")
    st.set_condition("WorkersReady", "True", "r2", "m2")
    js = jcrd.DeploymentStatus.from_dict(st.to_dict())
    assert js.to_dict() == st.to_dict()
    assert tcrd.ServiceSpec.from_dict({"gpus": 2, "tpu_chips": 2}).gpus == 2


JAX_BAD = [
    {"kind": "Other", "metadata": {"name": "x"}, "spec": {"graph": "a:B"}},
    {"metadata": {}, "spec": {"graph": "a:B"}},
    {"metadata": {"name": "x"}, "spec": {}},
    {"metadata": {"name": "x"},
     "spec": {"graph": "a:B", "services": {"S": {"replicas": -1}}}},
    {"metadata": {"name": "x"},
     "spec": {"graph": "a:B", "services": {"S": {"tpu_chips": -1}}}},
    {"metadata": {"name": "x"},
     "spec": {"graph": "a:B", "ingress": {"enabled": True, "port": 0}}},
]
PORT_BAD = [
    ({"metadata": {"name": "x"}, "spec": {"graph": "a:B", "platform": "tpu"}},
     "this package runs on CUDA"),
    ({"metadata": {"name": "x"},
      "spec": {"graph": "a:B", "services": {"S": {"gpus": 1,
                                                  "tpu_chips": 2}}}},
     "different counts"),
    ({"metadata": {"name": "x"},
      "spec": {"graph": "a:B", "services": {"S": {"gpus": -1}}}},
     "gpus must be"),
]


@pytest.mark.parametrize("bad", JAX_BAD + [b for b, _ in PORT_BAD],
                         ids=range(len(JAX_BAD) + len(PORT_BAD)))
def test_resource_validation(bad):
    """The JAX file's refusals, and the port's three: a ``tpu`` platform,
    ``gpus`` and ``tpu_chips`` disagreeing, a negative card count."""
    with pytest.raises(tcrd.SpecError) as e:
        tcrd.Deployment.from_dict(bad)
    if bad in JAX_BAD:
        with pytest.raises(jcrd.SpecError):
            jcrd.Deployment.from_dict(bad)
    else:
        assert next(m for b, m in PORT_BAD if b is bad) in str(e.value)


# ---------------------------------------------------------------------------
# the operator under FakeRunner, both packages on one script
# ---------------------------------------------------------------------------

async def _until(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if await pred():
            return True
        await asyncio.sleep(0.02)
    return False


async def operator_script(pkg: str) -> list:
    if pkg == "jax":
        from dynamo_tpu.deploy import crd
        from dynamo_tpu.deploy import operator as op_mod
        graph = "tests.test_deploy:Frontend"
        cards = "tpu_chips"
    else:
        from dynamo_tpu_torch.deploy import crd
        from dynamo_tpu_torch.deploy import operator as op_mod
        graph = "tests.test_torch_deploy:Frontend"
        cards = "gpus"
    srv = PyStoreServer()
    port = await srv.start()
    runner = op_mod.FakeRunner()
    op = await op_mod.Operator("127.0.0.1", port, runner=runner,
                               resync_interval=0.05).start()
    client = await StoreClient("127.0.0.1", port).connect()
    out = []

    async def status(name="g"):
        st = await op_mod.get_status(client, "default", name)
        return st and (st.state, st.ready_replicas, st.observed_generation,
                       [(c.type, c.status, c.reason, c.message)
                        for c in st.conditions])

    async def record(step):
        out.append((step, [(h["service"], h["idx"], h["chips"],
                            h["class"].split(":")[1], h["alive"])
                           for h in runner.started],
                    [(h["service"], h["idx"]) for h in runner.stopped],
                    await status(), await status("broken")))

    async def alive(n):
        return sum(h["alive"] for h in runner.started) == n

    try:
        dep = crd.Deployment(name="g", spec=crd.DeploymentSpec(graph=graph))
        await op_mod.apply(client, dep)
        assert await _until(lambda: alive(3))
        assert await _until(lambda: _ready_status(status, 3))
        await record("applied")
        dep.spec.services["frontend"] = crd.ServiceSpec(
            replicas=1, **{cards: 4})
        await op_mod.apply(client, dep)
        assert await _until(lambda: alive(2))
        assert await _until(lambda: _ready_status(status, 2))
        await record("scaled")
        next(h for h in runner.started if h["service"] == "backend")[
            "alive"] = False
        assert await _until(lambda: alive(2))
        await record("restarted")
        await op_mod.apply(client, crd.Deployment(
            name="broken", spec=crd.DeploymentSpec(graph="no.such:Nope")))
        assert await _until(lambda: _state(status, "failed", "broken"))
        await op_mod.delete(client, "default", "g")
        assert await _until(lambda: alive(0))
        assert await _until(lambda: _gone(status))
        await record("deleted")
    finally:
        await client.close()
        await op.close()
        await srv.stop()
    return out


async def _ready_status(status, n):
    st = await status()
    return st is not None and st[0] == "ready" and sum(st[1].values()) == n


async def _state(status, state, name):
    st = await status(name)
    return st is not None and st[0] == state


async def _gone(status):
    return await status() is None


async def test_both_operators_make_the_same_calls_and_states():
    jax, port = await operator_script("jax"), await operator_script("torch")
    assert port == jax
    assert port[0][1] == [("backend", 0, 0, "Backend", True),
                          ("frontend", 0, 4, "Frontend", True),
                          ("frontend", 1, 4, "Frontend", True)]
    assert port[0][3][3][1] == ("WorkersReady", "True", "Reconciled",
                                "3/3 workers")
    assert port[-1][4][0] == "failed"


# ---------------------------------------------------------------------------
# the api-store against the JAX one; artifacts
# ---------------------------------------------------------------------------

async def api_script(pkg: str, backend: str, tmp_path) -> list:
    if pkg == "jax":
        from dynamo_tpu.deploy.api_store import ApiStore
        from dynamo_tpu.deploy.object_store import MinioStub
    else:
        from dynamo_tpu_torch.deploy.api_store import ApiStore
        from dynamo_tpu_torch.deploy.object_store import MinioStub
    srv = PyStoreServer()
    port = await srv.start()
    minio = None
    root = str(tmp_path / pkg)
    if backend == "s3":
        minio = MinioStub()
        root = f"s3://arts?endpoint=http://127.0.0.1:{await minio.start()}"
    store = ApiStore(root, "127.0.0.1", port)
    base = f"http://127.0.0.1:{await store.start()}/api/v1"
    client = await StoreClient("127.0.0.1", port).connect()
    out = []

    async def call(method, path, body=None):
        data = json.dumps(body).encode() if isinstance(body, dict) else body
        st, raw = await asyncio.to_thread(http_request, method, base + path,
                                          data)
        try:
            got = json.loads(raw)
        except ValueError:
            got = raw.decode()
        if isinstance(got, dict):
            got.pop("uploaded", None)
            for versions in got.get("artifacts", {}).values():
                for v in versions:
                    v.pop("uploaded", None)
        out.append((method, path, st, got))

    try:
        await call("POST", "/artifacts/g1/versions", b"bundle-bytes")
        await call("GET", "/artifacts")
        await call("GET", "/artifacts/g1/versions/1")
        await call("POST", "/artifacts/g1/versions", b"x2")
        await call("POST", "/artifacts/.bad/versions", b"x")
        await call("DELETE", "/artifacts/g1/versions/1")
        await call("GET", "/artifacts/g1/versions/1")
        await call("DELETE", "/artifacts/g1/versions/x")
        await call("POST", "/artifacts/g1/versions", b"v3")
        await call("GET", "/artifacts")
        desc = await client.get("deploy/artifacts/g1/00000003")
        out.append(("descriptor", {k: v for k, v in json.loads(desc).items()
                                   if k != "url"}))
        dep = {"metadata": {"name": "d1"}, "spec": {"graph": "m:C"}}
        await call("POST", "/deployments", dep)
        await call("GET", "/deployments")
        await call("GET", "/deployments/default/d1")
        await call("POST", "/deployments", dep)
        await call("DELETE", "/deployments/default/d1")
        await call("GET", "/deployments/default/d1")
        await call("DELETE", "/deployments/default/d1")
        await call("POST", "/deployments", {"kind": "Nope"})
        await call("POST", "/deployments", b"{not json")
        await call("PUT", "/deployments")
        out.append(("store", await client.get("deploy/deployments/default/"
                                               "d1")))
    finally:
        await client.close()
        await store.stop()
        await srv.stop()
        if minio is not None:
            await minio.stop()
    return out


@pytest.mark.parametrize("backend", ["file", "s3"])
async def test_api_store_answers_as_jax(backend, tmp_path):
    jax = await api_script("jax", backend, tmp_path)
    port = await api_script("torch", backend, tmp_path)
    assert port == jax
    assert [r[2] for r in port if len(r) == 4] == [
        201, 200, 200, 201, 400, 200, 404, 404, 201, 200, 201, 200, 200,
        201, 200, 404, 404, 400, 400, 405]
    assert port[1][3] == {"artifacts": {"g1": [
        {"version": 1, "sha256": port[0][3]["sha256"], "size": 12}]}}


ART_GRAPH = '''
from dynamo_tpu_torch.sdk import dynamo_endpoint, service

@service(namespace="art", workers=2)
class ArtSvc:
    @dynamo_endpoint()
    async def generate(self, request, ctx):
        yield request
'''


async def test_artifact_deployment_resolves_into_the_port_cache(
        tmp_path, monkeypatch):
    from dynamo_tpu_torch.deploy import artifacts
    from dynamo_tpu_torch.deploy.api_store import ApiStore
    from dynamo_tpu_torch.deploy.operator import (FakeRunner, Operator,
                                                  apply, get_status)

    monkeypatch.setattr(artifacts, "CACHE_DIR", str(tmp_path / "cache"))
    srv = PyStoreServer()
    port = await srv.start()
    store = ApiStore(str(tmp_path / "artifacts"), "127.0.0.1", port)
    http = await store.start()
    runner = FakeRunner()
    op = await Operator("127.0.0.1", port, runner=runner,
                        resync_interval=0.05).start()
    client = await StoreClient("127.0.0.1", port).connect()
    try:
        st, _ = await asyncio.to_thread(
            http_request, "POST",
            f"http://127.0.0.1:{http}/api/v1/artifacts/artgraph/versions",
            ART_GRAPH.encode())
        assert st == 201
        await apply(client, tcrd.Deployment(name="fromart",
                                            spec=tcrd.DeploymentSpec(
            graph="artifact://artgraph/1#art_graph_mod:ArtSvc")))

        async def two():
            return sum(h["alive"] for h in runner.started) == 2
        assert await _until(two)
        h = runner.started[0]
        path = h["envs"]["DYNAMO_ARTIFACT_PATH"]
        assert h["class"] == "art_graph_mod:ArtSvc"
        assert path == str(tmp_path / "cache" / "artgraph" / "1")
        assert sorted(os.listdir(path)) == [".sha256", "art_graph_mod.py"]
        st = await get_status(client, "default", "fromart")
        assert st.state == "ready"
        with pytest.raises(artifacts.ArtifactError, match="not registered"):
            await artifacts.resolve(client, "artifact://nope#m:C")
    finally:
        await client.close()
        await op.close()
        await store.stop()
        await srv.stop()


# ---------------------------------------------------------------------------
# the port's LocalRunner on the CPU, through deployctl
# ---------------------------------------------------------------------------

def _children(pid: int) -> dict:
    """{pid: argv} of ``pid``'s live child processes."""
    out = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read().rsplit(")", 1)[1].split()
            if int(stat[1]) == pid and stat[0] != "Z":
                with open(f"/proc/{d}/cmdline", "rb") as f:
                    out[int(d)] = f.read().split(b"\0")
        except (OSError, ValueError, IndexError):
            continue
    return out


class _Procs:
    def __init__(self, tmp_path, env):
        self.tmp, self.env, self.procs = tmp_path, env, {}

    def start(self, name, *argv):
        # a session of its own: stop() reaps the workers an operator
        # spawned along with it, even when the operator is killed first
        log = open(self.tmp / f"{name}.log", "w")
        self.procs[name] = subprocess.Popen(
            [sys.executable, "-m", *argv], stdout=log,
            stderr=subprocess.STDOUT, cwd=str(ROOT), env=self.env,
            start_new_session=True)
        return self.procs[name]

    def log(self, name):
        return (self.tmp / f"{name}.log").read_text()

    def wait_line(self, name, pattern, timeout=30):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            m = re.search(pattern, self.log(name))
            if m:
                return m
            assert self.procs[name].poll() is None, self.log(name)
            time.sleep(0.05)
        raise AssertionError(f"{name}: no {pattern!r}:\n{self.log(name)}")

    def ctl(self, store, *argv):
        r = subprocess.run(
            [sys.executable, "-m", "dynamo_tpu_torch.cli.deployctl",
             "--store", store, *argv], capture_output=True, text=True,
            cwd=str(ROOT), env=self.env, timeout=60)
        return r.returncode, r.stdout

    def stop(self):
        for p in self.procs.values():
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait(timeout=30)


def _status(procs, store, name):
    rc, out = procs.ctl(store, "status", name)
    return json.loads(out) if rc == 0 else None


def _wait_status(procs, store, name, pred, timeout=30):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st = _status(procs, store, name)
        if pred(st):
            return st
        time.sleep(0.2)
    raise AssertionError(f"status of {name}: {st}\n{procs.log('operator')}")


def test_deployctl_operator_serves_an_artifact_graph_on_the_cpu(tmp_path):
    """``deployctl operator --platform cpu`` beside a store and the
    api-store: the port's hello_world graph pushed as an artifact (under a
    module name only the bundle has) answers a request, its children see
    the bundle through ``DYNAMO_ARTIFACT_PATH``; ``deployctl delete`` reaps
    every child; apply/list/status/render read the port's example resource;
    SIGTERM drains the operator's workers and it exits 0 (Queue 3 item
    21: the JAX operator dies and leaves them running)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), PYTHONUNBUFFERED="1",
               DYNAMO_TPU_DATAPLANE="python", DYNAMO_TPU_STORE="python",
               DYNAMO_ARTIFACT_CACHE=str(tmp_path / "cache"))
    procs = _Procs(tmp_path, env)
    try:
        procs.start("store", "dynamo_tpu_torch.runtime.store_server",
                    "--host", "127.0.0.1", "--port", "0")
        store = "127.0.0.1:" + procs.wait_line(
            "store", r"listening on \S+:(\d+)").group(1)
        procs.start("api", "dynamo_tpu_torch.deploy.api_store", "--store",
                    store, "--root", f"file://{tmp_path}/objects",
                    "--port", "0")
        api = procs.wait_line("api", r"api-store on (\S+)").group(1)
        op = procs.start("operator", "dynamo_tpu_torch.cli.deployctl",
                         "--store", store, "operator", "--platform", "cpu",
                         "--resync", "0.5")
        procs.wait_line("operator", r"operator watching")
        bundle = tmp_path / "hello_art.py"
        bundle.write_text((ROOT / "dynamo_tpu_torch" / "examples" /
                           "hello_world.py").read_text())
        rc, out = procs.ctl(store, "push", "hello", str(bundle), "--api",
                            f"http://{api}")
        assert rc == 0 and out.startswith("pushed hello v1 "), out
        res = tmp_path / "hello.yaml"
        res.write_text("metadata:\n  name: hello\nspec:\n"
                       "  graph: artifact://hello/1#hello_art:Frontend\n"
                       "  platform: cpu\n  services:\n    middle:\n"
                       "      replicas: 2\n")
        assert procs.ctl(store, "apply", "-f", str(res))[0] == 0
        st = _wait_status(procs, store, "hello",
                          lambda s: s and s["state"] == "ready")
        assert st["readyReplicas"] == {"backend": 1, "middle": 2,
                                       "frontend": 1}
        kids = _children(op.pid)
        assert len(kids) == 4
        cache = str(tmp_path / "cache" / "hello" / "1")
        for pid, argv in kids.items():
            assert argv[2] == b"dynamo_tpu_torch.sdk.serve_child"
            assert argv[3].startswith(b"hello_art:")
            with open(f"/proc/{pid}/environ", "rb") as f:
                assert f"DYNAMO_ARTIFACT_PATH={cache}".encode() in \
                    f.read().split(b"\0")
        words = asyncio.run(_hello_request(int(store.rsplit(":", 1)[1])))
        assert words == ["A-BACK", "B-BACK"]
        log = procs.log("operator")
        assert log.count("DYNAMO_SERVICE_READY middle") == 2
        assert "[frontend] DYNAMO_SERVICE_READY frontend" in log

        assert procs.ctl(store, "delete", "default/hello") == (0, "deleted\n")
        deadline = time.monotonic() + 15
        while _children(op.pid) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert _children(op.pid) == {}
        _wait_status(procs, store, "hello", lambda s: s is None)

        example = str(ROOT / "dynamo_tpu_torch" / "examples" / "configs" /
                      "deployment.yaml")
        assert procs.ctl(store, "apply", "-f", example) == (
            0, "applied default/hello (generation 1)\n")
        rc, out = procs.ctl(store, "list")
        assert out == ("default/hello  graph=dynamo_tpu_torch.examples."
                       "hello_world:Frontend generation=1\n")
        st = _wait_status(procs, store, "hello",
                          lambda s: s and s["state"] == "ready")
        assert st["readyReplicas"] == {"backend": 1, "middle": 2,
                                       "frontend": 1}
        rc, out = procs.ctl(store, "render", "-f", example, "--no-store")
        import yaml

        docs = list(yaml.safe_load_all(out))
        assert rc == 0 and [d["metadata"]["name"] for d in docs
                            if d["kind"] == "Deployment"] == [
            "hello-backend", "hello-middle", "hello-frontend"]
        assert "dynamo_tpu." not in out
        kids = set(_children(op.pid))
        assert len(kids) == 4
        op.send_signal(signal.SIGTERM)
        assert op.wait(30) == 0
        assert "operator stopped" in procs.log("operator")
        assert not [p for p in kids if os.path.exists(f"/proc/{p}")]
    finally:
        procs.stop()


async def _hello_request(store_port: int) -> list:
    from dynamo_tpu_torch.runtime.component import DistributedRuntime

    drt = await DistributedRuntime(store_port=store_port).connect()
    try:
        cl = await drt.namespace("hello").component("frontend") \
            .endpoint("generate").client().start()
        await cl.wait_for_instances(1, timeout=10)
        return [x["word"] async for x in cl.generate({"text": "a b"})]
    finally:
        await drt.close()


# ---------------------------------------------------------------------------
# the JAX operator's faults the port does not copy (in process)
# ---------------------------------------------------------------------------

FAULT_GRAPH = '''
import asyncio
import os
import signal

from dynamo_tpu_torch.sdk import async_on_start, dynamo_endpoint, service


@service(namespace="fault")
class Slow:
    """READY only after its start hook's sleep."""

    @async_on_start
    async def boot(self):
        await asyncio.sleep(float(self.config.get("boot_s", 0)))

    @dynamo_endpoint()
    async def generate(self, request, ctx):
        yield request


@service(namespace="fault", resources={"gpu": 1})
class Stubborn:
    """Ignores SIGTERM: only SIGKILL ends it."""

    @async_on_start
    async def boot(self):
        signal.signal(signal.SIGTERM, signal.SIG_IGN)

    @dynamo_endpoint()
    async def generate(self, request, ctx):
        yield request
'''


@pytest.fixture()
def fault_graph(tmp_path, monkeypatch):
    (tmp_path / "fault_graph.py").write_text(FAULT_GRAPH)
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setenv("PYTHONPATH", f"{tmp_path}:{ROOT}")
    monkeypatch.setenv("DYNAMO_TPU_DATAPLANE", "python")


async def _operator(runner):
    from dynamo_tpu_torch.deploy.operator import Operator

    srv = PyStoreServer()
    port = await srv.start()
    op = await Operator("127.0.0.1", port, runner=runner,
                        resync_interval=0.2).start()
    client = await StoreClient("127.0.0.1", port).connect()
    return srv, op, client, f"127.0.0.1:{port}"


def _dep(name, graph, **services):
    return tcrd.Deployment(name=name, spec=tcrd.DeploymentSpec(
        graph=graph, services={k: tcrd.ServiceSpec(**v)
                               for k, v in services.items()}))


async def test_worker_is_ready_only_after_its_ready_line(fault_graph):
    """Queue 3 item 18: with the child alive and its start hook still
    running, the status reads ``deploying`` (the JAX runner counts an
    alive process as ready)."""
    from dynamo_tpu_torch.deploy.operator import LocalRunner, apply, get_status

    runner = LocalRunner("", "cpu")
    srv, op, client, runner.store = await _operator(runner)
    try:
        await apply(client, _dep("slow", "fault_graph:Slow",
                                 slow={"config": {"boot_s": 1.5}}))
        seen = []
        while not seen or seen[-1][0] != "ready":
            st = await get_status(client, "default", "slow")
            alive = [w for w in runner._workers if w.proc.poll() is None]
            if st is not None and alive:
                seen.append((st.state, st.ready_replicas,
                             alive[0].is_ready))
            assert len(seen) < 400
            await asyncio.sleep(0.02)
        assert ("deploying", {}, False) in seen
        assert seen[-1] == ("ready", {"slow": 1}, True)
    finally:
        await client.close()
        await op.close()
        await srv.stop()


async def test_replica_that_does_not_fit_stays_unstarted(fault_graph):
    """Queue 3 item 19: two cards asked of a one-card operator: nothing is
    spawned and ``WorkersReady`` names the cards (the JAX runner spawns
    the replica with every chip visible)."""
    from dynamo_tpu_torch.deploy.operator import LocalRunner, apply, get_status

    runner = LocalRunner("127.0.0.1:1", "cuda", total_chips=1)
    srv, op, client, _ = await _operator(runner)
    try:
        await apply(client, _dep("big", "fault_graph:Stubborn",
                                 stubborn={"gpus": 2}))

        async def placed():
            st = await get_status(client, "default", "big")
            return st is not None and st.conditions[-1].type == "WorkersReady"
        assert await _until(placed)
        st = await get_status(client, "default", "big")
        cond = st.conditions[-1]
        assert (st.state, cond.status, cond.reason) == (
            "deploying", "False", "InsufficientCards")
        assert "need 2 contiguous cards" in cond.message
        assert "of 1 total" in cond.message
        assert runner._workers == []
    finally:
        await client.close()
        await op.close()
        await srv.stop()


async def test_a_slow_drain_never_stalls_the_reconcile_loop(fault_graph):
    """Queue 3 item 20: a worker that ignores SIGTERM is scaled away; the
    next deployment comes up while it still drains, and it is SIGKILLed
    at the grace (the JAX runner waits 5 s on the event loop)."""
    from dynamo_tpu_torch.deploy.operator import LocalRunner, apply, get_status

    runner = LocalRunner("", "cpu", grace=3.0)
    srv, op, client, runner.store = await _operator(runner)
    try:

        def ready(name):
            async def pred():
                st = await get_status(client, "default", name)
                return st is not None and st.state == "ready"
            return pred

        await apply(client, _dep("a", "fault_graph:Stubborn",
                                 stubborn={"replicas": 1}))
        assert await _until(ready("a"), 20)
        stubborn = runner._workers[0]
        t0 = time.monotonic()
        await apply(client, _dep("a", "fault_graph:Stubborn",
                                 stubborn={"replicas": 0}))
        await apply(client, _dep("b", "fault_graph:Slow"))
        assert await _until(ready("b"), 20)
        assert stubborn.stopping and stubborn.proc.poll() is None
        assert time.monotonic() - t0 < 3.0
        assert await asyncio.to_thread(runner.join, 10)
        assert stubborn.proc.returncode == -signal.SIGKILL
        assert time.monotonic() - t0 >= 3.0
    finally:
        await client.close()
        await op.close()
        await srv.stop()


def test_deploy_modules_import_neither_yaml_aiohttp_nor_torch():
    """The deploy layer and deployctl import no PyYAML and no aiohttp
    (the card's machine has neither), and not torch: the operator process
    never touches the card."""
    code = ("import sys\nimport dynamo_tpu_torch.deploy, "
            "dynamo_tpu_torch.deploy.api_store, "
            "dynamo_tpu_torch.deploy.artifacts, "
            "dynamo_tpu_torch.deploy.imagebuild, "
            "dynamo_tpu_torch.cli.deployctl\n"
            "print(sorted(m for m in ('yaml', 'aiohttp', 'torch', 'jax', "
            "'dynamo_tpu') if m in sys.modules))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(ROOT), timeout=60)
    assert r.stdout.strip() == "[]", r.stderr
    import ast

    bad = {}
    for f in sorted((ROOT / "dynamo_tpu_torch").rglob("*.py")) + [
            ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for n in names:
                if n.split(".")[0] in ("yaml", "aiohttp"):
                    bad.setdefault(str(f.relative_to(ROOT)), []).append(n)
    assert bad == {}


def test_service_config_reaches_a_service_by_component_name():
    """Queue 3 item 22: the operator's env JSON and the rendered ConfigMap
    key a service's config by component name; the port's service reads
    it (a section named after the class still wins), the JAX one reads
    nothing."""
    from dynamo_tpu.sdk.service import ServiceConfig as JConfig
    from examples.hello_world import Backend as JBackend

    from dynamo_tpu_torch.examples.hello_world import Backend
    from dynamo_tpu_torch.sdk.service import ServiceConfig

    data = {"backend": {"greeting": "hi"}}
    assert JConfig(data).for_service(JBackend) == {}
    assert ServiceConfig(data).for_service(Backend) == {"greeting": "hi"}
    data["Backend"] = {"greeting": "by class"}
    assert ServiceConfig(data).for_service(Backend) == {"greeting": "by class"}
    assert ServiceConfig(data).for_service("backend") == {"greeting": "hi"}


def test_operator_on_cuda_without_a_card_refuses():
    """``deployctl operator --platform cuda`` with no card visible to NVML
    stops before it connects anywhere; there is no fallback to the CPU."""
    from dynamo_tpu_torch.cli import deployctl

    if deployctl.visible_cards():
        pytest.skip("a CUDA card is visible here")
    with pytest.raises(SystemExit, match="no CUDA card is visible"):
        deployctl.main(["--store", "127.0.0.1:1", "operator"])
