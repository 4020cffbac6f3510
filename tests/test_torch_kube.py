"""The port's Kubernetes half (``dynamo_tpu_torch/deploy/{manifests,kube,
rest_api}.py``, the YAML writer, the chart) held against the JAX package's
modules on the same inputs. The port differs from JAX by design in three
places, mapped here before objects are compared: a worker asks for
``nvidia.com/gpu`` (JAX: ``google.com/tpu`` and GKE TPU node selectors),
containers run ``dynamo_tpu_torch`` modules (the store with ``--impl
native``), and the default image is ``dynamo-tpu-torch:latest``."""

import copy
import importlib
import os

import pytest
import yaml

from dynamo_tpu.deploy import crd as jcrd
from dynamo_tpu.deploy import kube as jkube
from dynamo_tpu.deploy import manifests as jman
from dynamo_tpu_torch.deploy import crd as tcrd
from dynamo_tpu_torch.deploy import kube as tkube
from dynamo_tpu_torch.deploy import manifests as tman
from dynamo_tpu_torch.deploy.rest_api import KubeApiError, RestKubeApi
from dynamo_tpu_torch.utils import yamlsubset

SERVICES = {
    "Frontend": ("examples.llm_graphs:Frontend", 1, 0),
    "Worker": ("examples.llm_graphs:Worker", 2, 1),
}


def make_dep(pkg, ingress=None, **services):
    """The same resource in either package (``gpus`` is JAX's
    ``tpu_chips``)."""
    crd = tcrd if pkg == "torch" else jcrd
    rows = {}
    for name, kw in services.items():
        kw = dict(kw)
        if pkg == "jax" and "gpus" in kw:
            kw["tpu_chips"] = kw.pop("gpus")
        rows[name] = crd.ServiceSpec(**kw)
    spec = crd.DeploymentSpec(
        graph="examples.llm_graphs:AggGraph", services=rows,
        ingress=crd.IngressSpec(**ingress) if ingress else None)
    return crd.Deployment(name="demo", namespace="prod", spec=spec)


def as_port(obj):
    """A JAX object as the port renders it: the three deliberate
    differences mapped, an envoy config read back as data."""
    obj = copy.deepcopy(obj)

    def walk(o):
        if isinstance(o, dict):
            limits = o.get("limits")
            if isinstance(limits, dict) and "google.com/tpu" in limits:
                limits["nvidia.com/gpu"] = limits.pop("google.com/tpu")
            o.pop("nodeSelector", None)
            if o.get("image") == "dynamo-tpu:latest":
                o["image"] = "dynamo-tpu-torch:latest"
            cmd = o.get("command")
            if isinstance(cmd, list) and len(cmd) > 2:
                cmd[2] = cmd[2].replace("dynamo_tpu.", "dynamo_tpu_torch.")
                if cmd[2].endswith("runtime.store_server"):
                    cmd[3:3] = ["--impl", "native"]
            if "envoy.yaml" in o:
                o["envoy.yaml"] = yaml.safe_load(o["envoy.yaml"])
            if "tpu_chips" in o:                # a CR's service rows
                o["gpus"] = o.pop("tpu_chips")
            for v in o.values():
                walk(v)
        elif isinstance(o, list):
            for v in o:
                walk(v)

    walk(obj)
    return obj


def read_envoy(objs):
    objs = copy.deepcopy(objs)
    for o in objs:
        if "envoy.yaml" in o.get("data", {}):
            o["data"]["envoy.yaml"] = yaml.safe_load(o["data"]["envoy.yaml"])
    return objs


INGRESS = [
    None,
    dict(enabled=True, host="llm.example.com", port=8080, tls_secret="tls",
         annotations={"kubernetes.io/ingress.class": "nginx"}),
    dict(enabled=True, port=9000, envoy=True, debug_service="Worker",
         debug_header="x-debug", debug_value="yes"),
    dict(enabled=True, port=8080, envoy=True),
]


@pytest.mark.parametrize("ingress", INGRESS, ids=range(len(INGRESS)))
def test_manifests_equal_jax_once_mapped(ingress):
    services = dict(Worker={"replicas": 3, "gpus": 2},
                    Frontend={"replicas": 1, "envs": {"A": "1"},
                              "config": {"port": 8080}})
    jax = jman.render_manifests(make_dep("jax", ingress, **services),
                                SERVICES, image="reg/img:1")
    port = tman.render_manifests(make_dep("torch", ingress, **services),
                                 SERVICES, image="reg/img:1")
    assert read_envoy(port) == [as_port(m) for m in jax]
    worker = next(m for m in port if m["metadata"]["name"] == "demo-worker"
                  and m["kind"] == "Deployment")
    pod = worker["spec"]["template"]["spec"]
    assert pod["containers"][0]["resources"] == {
        "limits": {"nvidia.com/gpu": 2}}
    assert "nodeSelector" not in pod
    # the written stream reads back as the same objects, by PyYAML and by
    # the port's reader
    text = tman.to_yaml(port)
    assert list(yaml.safe_load_all(text)) == port
    assert [yamlsubset.loads(doc) for doc in text.split("---\n")] == port
    assert "dynamo_tpu." not in text
    if ingress and ingress.get("envoy"):
        cm = next(m for m in port if m["metadata"]["name"].endswith("-envoy"))
        assert yaml.safe_load(cm["data"]["envoy.yaml"]) == \
            yamlsubset.loads(cm["data"]["envoy.yaml"])


def test_gpu_product_selects_nodes_for_card_workers():
    dep = make_dep("torch", Worker={"replicas": 1, "gpus": 1})
    ms = tman.render_manifests(dep, SERVICES, include_store=False,
                               gpu_product="NVIDIA-H100-80GB-HBM3")
    pods = {m["metadata"]["name"]: m["spec"]["template"]["spec"]
            for m in ms if m["kind"] == "Deployment"}
    assert pods["demo-worker"]["nodeSelector"] == {
        "nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3"}
    assert "nodeSelector" not in pods["demo-frontend"]
    assert tman.render_envoy_config(9000, "u", 9001, "x-d", "1", "d", 9002) \
        == jman.render_envoy_config(9000, "u", 9001, "x-d", "1", "d", 9002)


def _cm(name="cm", data=None, **md):
    return {"apiVersion": "v1", "kind": "ConfigMap",
            "metadata": {"name": name, "namespace": "prod", **md},
            "data": data or {"k": "v"}}


def kube_script(kube, pkg):
    """Applies, scales, a pod crash, GC, a cascade delete, conflicts and
    finalizers on one FakeKubeApi; the live objects and statuses after
    each step, normalised (no times; JAX's objects mapped)."""
    api = kube.FakeKubeApi()
    out = []

    def untimed(status):
        status = copy.deepcopy(status)
        for c in status["conditions"]:
            c.pop("lastTransitionTime")
        return status

    def snap(status=None):
        objs = {"/".join(k): copy.deepcopy(as_port(o) if pkg == "jax" else o)
                for k, o in api.objects.items()}
        for o in objs.values():
            o["metadata"].pop("deletionTimestamp", None)
            if "status" in o and "conditions" in o["status"]:
                o["status"] = untimed(o["status"])
        out.append((objs, status and untimed(status)))

    rec = kube.KubeReconciler(api, SERVICES)
    snap(rec.reconcile(make_dep(pkg, Worker={"replicas": 2, "gpus": 1})))
    n = api.apply_count
    snap(rec.reconcile(make_dep(pkg, Worker={"replicas": 2, "gpus": 1})))
    out.append(("idempotent", api.apply_count == n))
    snap(rec.reconcile(make_dep(pkg, Worker={"replicas": 4, "gpus": 1})))
    labels = api.get("Deployment", "prod",
                     "demo-worker")["spec"]["selector"]["matchLabels"]
    api.fail_pod("prod", api.list("Pod", "prod", labels)[0]["metadata"]["name"])
    snap()
    snap(rec.reconcile(make_dep(pkg, Worker={"replicas": 1, "gpus": 1},
                                ingress=dict(enabled=True))))
    # an outside manager force-adopts a child's spec; the reconciler takes
    # it back
    child = api.get("Deployment", "prod", "demo-worker")
    api.apply({"apiVersion": "apps/v1", "kind": "Deployment",
               "metadata": {"name": "demo-worker", "namespace": "prod"},
               "spec": {**child["spec"], "replicas": 7}},
              field_manager="outsider")
    snap(kube.KubeReconciler(api, {"Worker": SERVICES["Worker"]}).reconcile(
        make_dep(pkg, Worker={"replicas": 1, "gpus": 1})))
    # conflicts: field manager, stale resourceVersion; finalizers
    api.apply(_cm(), field_manager="alpha")
    try:
        api.apply(_cm(data={"k": "x"}), field_manager="beta", force=False)
    except kube.KubeConflict as e:
        out.append(("conflict", e.conflicts))
    stale = api.get("ConfigMap", "prod", "cm")["metadata"]["resourceVersion"]
    api.apply(_cm(data={"k": "newer"}))
    try:
        api.apply(_cm(data={"k": "mine"}, resourceVersion=stale))
    except kube.KubeConflict as e:
        out.append(("stale", "modified" in str(e), e.conflicts))
    api.apply(_cm("fin", finalizers=["dynamo.tpu/cleanup"]))
    out.append(("delete", api.delete("ConfigMap", "prod", "fin")))
    fin = api.get("ConfigMap", "prod", "fin")
    out.append(("marked", bool(fin["metadata"].get("deletionTimestamp"))))
    snap()
    api.apply(_cm("fin", finalizers=[],
                  resourceVersion=fin["metadata"]["resourceVersion"]))
    api.delete(kube.CR_KIND, "prod", "demo")
    snap()
    return out


def test_fake_kube_api_and_reconciler_behave_as_jax():
    port = kube_script(tkube, "torch")
    assert port == kube_script(jkube, "jax")
    objs, status = port[0]
    assert status["conditions"][0] == {"type": "Available", "status": "True"}
    assert status["services"] == {"Frontend": {"want": 1, "ready": 1},
                                  "Worker": {"want": 2, "ready": 2}}
    assert sorted(objs)[-1].startswith("Service/")
    # the cascade left the unowned store and ConfigMap; the finalizer's
    # cleared object is gone
    assert {k for k in port[-1][0] if "/dynstore" not in k} == {
        "ConfigMap/prod/cm"}


@pytest.fixture()
def rest_api():
    fake = tkube.FakeKubeApi()
    srv = tkube.serve_fake_api(fake)
    try:
        yield RestKubeApi(f"http://127.0.0.1:{srv.server_port}"), fake
    finally:
        srv.shutdown()
        srv.server_close()


def test_reconcile_through_the_rest_adapter_lands_as_direct(rest_api):
    api, fake = rest_api
    direct = tkube.FakeKubeApi()
    dep = make_dep("torch", Worker={"replicas": 2, "gpus": 1},
                   ingress=dict(enabled=True, envoy=True))
    status = tkube.KubeReconciler(api, SERVICES).reconcile(dep)
    assert status["conditions"][0]["status"] == "True"
    tkube.KubeReconciler(direct, SERVICES).reconcile(dep)
    # the in-process reconciler writes the status onto the stored CR itself
    direct.get(tkube.CR_KIND, "prod", "demo").pop("status")
    assert fake.objects == direct.objects
    n = fake.apply_count
    tkube.KubeReconciler(api, SERVICES).reconcile(dep)
    assert fake.apply_count == n
    # GC through labelSelector lists and DELETE
    tkube.KubeReconciler(api, {"Frontend": SERVICES["Frontend"]}).reconcile(
        make_dep("torch"))
    assert fake.get("Deployment", "prod", "demo-worker") is None
    assert api.get("Deployment", "prod", "demo-worker") is None
    assert [o["metadata"]["name"] for o in api.list(
        "Deployment", "prod", labels={"dynamo.tpu/service": "Frontend"})] \
        == ["demo-frontend"]
    assert api.delete("Deployment", "prod", "demo-frontend") is True
    assert api.delete("Deployment", "prod", "demo-frontend") is False
    # a non-force manager on an owned field: 409, object untouched
    api.apply(_cm())
    rival = RestKubeApi(api.base_url, field_manager="rival", force=False)
    with pytest.raises(KubeApiError) as e:
        rival.apply(_cm(data={"k": "other"}))
    assert e.value.status == 409 and "conflict" in e.value.body.lower()
    assert fake.get("ConfigMap", "prod", "cm")["data"] == {"k": "v"}


KUBECONFIG = """\
apiVersion: v1
kind: Config
current-context: demo
preferences: {}
clusters:
- name: other
  cluster:
    server: https://9.9.9.9:6443
- name: democluster
  cluster:
    server: https://1.2.3.4:6443
    certificate-authority-data: {ca}
    insecure-skip-tls-verify: true
contexts:
  - name: demo
    context:
      cluster: democluster
      user: demouser
      namespace: prod
users:
- name: demouser
  user:
    token: "sekrit-token"  # a comment
"""


def test_kubeconfig_with_sequences_and_ca_data_reads_as_pyyaml(tmp_path):
    import base64

    ca = b"-----BEGIN CERTIFICATE-----\nMIIC\n-----END CERTIFICATE-----\n"
    text = KUBECONFIG.replace("{ca}", base64.b64encode(ca).decode())
    assert yamlsubset.loads(text) == yaml.safe_load(text)
    path = tmp_path / "kubeconfig"
    path.write_text(text)
    api = RestKubeApi.from_kubeconfig(str(path))
    assert (api.base_url, api.token) == ("https://1.2.3.4:6443",
                                         "sekrit-token")
    with open(api.ca_file, "rb") as f:
        assert f.read() == ca
    os.unlink(api.ca_file)


@pytest.mark.parametrize("text,line", [
    ("a:\n- x\n b: 1", 3), ("a:\n  - x\n - y", 3), ("- a\n- b", 1),
    ("a:\n- [1]", 2), ("a:\n- {b: 1}", 2), ("a: {}x", 1), ("a:\n-\tb", 2)])
def test_yaml_subset_refuses_sequences_outside_the_subset(text, line):
    with pytest.raises(yamlsubset.YamlSubsetError) as e:
        yamlsubset.loads(text)
    assert e.value.line == line


def _port_chart():
    return os.path.join(os.path.dirname(tkube.__file__), "charts",
                        "dynamo-platform")


@pytest.mark.parametrize("off", [None, "operator", "apiStore", "metrics"])
def test_port_chart_renders_lints_and_names_port_modules(monkeypatch, off):
    jc = importlib.import_module("tests.test_ingress_and_charts")
    monkeypatch.setattr(jc, "CHART_DIR", _port_chart())
    values = yaml.safe_load(open(os.path.join(_port_chart(), "values.yaml")))
    if off:
        values[off]["enabled"] = False
    docs = [d for t in jc._render_chart(values).values()
            for d in yaml.safe_load_all(t) if d]
    for d in docs:
        assert d["apiVersion"] and d["kind"] and d["metadata"]["name"]
        if d["kind"] == "Deployment":
            tmpl = d["spec"]["template"]
            sel = d["spec"]["selector"]["matchLabels"]
            assert all(tmpl["metadata"]["labels"].get(k) == v
                       for k, v in sel.items())
            for c in tmpl["spec"]["containers"]:
                assert c["image"] == "dynamo-tpu-torch:latest"
                assert c["command"][:2] == ["python", "-m"]
                assert c["command"][2].startswith("dynamo_tpu_torch.")
    names = [d["metadata"]["name"] for d in docs]
    want = {"operator": "rel-operator", "apiStore": "rel-api-store",
            "metrics": "rel-metrics"}
    for key, name in want.items():
        assert (name in names) == (key != off)
    assert "rel-dynstore" in names
    if off != "operator":
        op = next(d for d in docs if d["metadata"]["name"] == "rel-operator")
        c = op["spec"]["template"]["spec"]["containers"][0]
        assert c["resources"]["limits"] == {"nvidia.com/gpu": 1}
        assert c["command"][-4:] == ["--platform", "cuda", "--total-chips",
                                     "1"]
    for root, _, files in os.walk(_port_chart()):
        for f in files:
            assert "dynamo_tpu." not in open(os.path.join(root, f)).read()
