"""The port's multi-model fleet plane (``dynamo_tpu_torch/fleet``:
registry, arbiter, plane; ``FleetKvRouter``; the frontend's fleet view)
against the JAX package's.

Model specs and status records are the same JSON byte for byte, and a
record one package writes into the port's store the other reads back
(a JAX record's ``"jax"`` engine serves on the port's ``torch`` worker
without being rewritten); the chip arbiters grant the same replicas and
preempt the same victims over seeded claims; the planes publish the same
prefetch hints, swap commands, annotations and status records; the fleet
planners reconcile the same registry into the same decisions, boots
before drains; the fleet routers follow the registry and refuse an
unknown model alike; and the port's frontend lists registered models with
their state and takes its tenant quotas from the registry.
"""

import asyncio
import importlib
import json
import random
import urllib.request

import pytest

J, T = PKGS = ("dynamo_tpu", "dynamo_tpu_torch")
NS = "fleetns"


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _spec(pkg, **kw):
    reg = _mod(pkg, "fleet.registry")
    tenants = {t: _mod(pkg, "utils.overload").TenantQuota(**q)
               for t, q in kw.pop("tenants", {}).items()}
    return reg.FleetModelSpec(tenants=tenants, **kw)


SPECS = [
    dict(name="llama", engine="jax", model_path="/m/llama",
         chips_per_replica=2, min_replicas=1, max_replicas=4, priority=2,
         tenants={"acme": dict(rps=5.0, burst=10.0, concurrency=8)},
         extra_args=["--echo-slots", "4"], swap_group="llama-8b",
         prewarm=True),
    dict(name="echo-1.b_x", engine="echo", chips_per_replica=0),
    dict(name="m", component="custom", engine="torch",
         card={"name": "m", "context_length": 4096}, min_replicas=0,
         max_replicas=1),
]


@pytest.mark.parametrize("kw", SPECS, ids=[s["name"] for s in SPECS])
def test_spec_json_is_byte_identical_and_reads_across(kw):
    js, ts = _spec(J, **dict(kw)), _spec(T, **dict(kw))
    blob = json.dumps(ts.to_dict())
    assert blob == json.dumps(js.to_dict())
    for pkg in PKGS:
        back = _mod(pkg, "fleet.registry").FleetModelSpec.from_dict(
            json.loads(blob))
        assert json.dumps(back.to_dict()) == blob
    # a JAX record's engine serves on the torch worker; others pass
    want = {"jax": "torch"}.get(kw["engine"], kw["engine"])
    assert _mod(T, "fleet.registry").worker_engine(ts.engine) == want
    assert ts.engine == kw["engine"]         # the record is not rewritten


@pytest.mark.parametrize("kw", [
    dict(name="meta-llama/Llama-3-8B"), dict(name=""), dict(name="x" * 65),
    dict(name="bad", min_replicas=3, max_replicas=2),
    dict(name="bad", chips_per_replica=-1)])
def test_spec_validation_refuses_alike(kw):
    errs = []
    for pkg in PKGS:
        with pytest.raises(ValueError) as ei:
            _spec(pkg, **dict(kw))
        errs.append(str(ei.value))
    assert errs[1] == errs[0]


async def test_records_cross_packages_through_the_port_store():
    srv = _mod(T, "runtime.store_server").PyStoreServer()
    port = await srv.start()
    try:
        drts = {p: await _mod(p, "runtime.component").DistributedRuntime(
            store_port=port).connect() for p in PKGS}
        jreg, treg = _mod(J, "fleet.registry"), _mod(T, "fleet.registry")
        # the JAX ctl's record, read by the port (and its registry watch)
        await jreg.put_fleet_model(drts[J].store, NS, _spec(J, **SPECS[0]))
        got = await treg.get_fleet_model(drts[T].store, NS, "llama")
        assert json.dumps(got.to_dict()) == \
            json.dumps(_spec(J, **SPECS[0]).to_dict())
        live = await treg.FleetRegistry(drts[T].store, NS).start()
        events = []
        live.on_change = lambda name, s: events.append((name, s is None))
        # the port's record, read by the JAX package
        await treg.put_fleet_model(drts[T].store, NS, _spec(T, **SPECS[1]))
        listed = await jreg.list_fleet_models(drts[J].store, NS)
        assert [s.name for s in listed] == ["echo-1.b_x", "llama"]
        await asyncio.sleep(0.2)
        assert set(live.models) == {"llama", "echo-1.b_x"}
        assert events == [("echo-1.b_x", False)]
        jlive = jreg.FleetRegistry.__new__(jreg.FleetRegistry)
        jlive.models = {n: jreg.FleetModelSpec.from_dict(s.to_dict())
                        for n, s in live.models.items()}
        assert {t: q.to_dict() for t, q in live.tenant_quotas().items()} \
            == {t: q.to_dict() for t, q in jlive.tenant_quotas().items()}
        # lease-bound status records, each way round
        await treg.publish_fleet_status(
            drts[T].store, NS, "llama", {"state": "ready", "replicas": 1},
            lease=drts[T].lease)
        await jreg.publish_fleet_status(
            drts[J].store, NS, "echo-1.b_x", {"state": "off"},
            lease=drts[J].lease)
        st = {p: await _mod(p, "fleet.registry").fetch_fleet_status(
            drts[p].store, NS) for p in PKGS}
        assert st[T] == st[J] and st[T]["llama"]["state"] == "ready"
        assert st[T]["echo-1.b_x"]["model"] == "echo-1.b_x"
        await jreg.remove_fleet_model(drts[J].store, NS, "llama")
        await asyncio.sleep(0.2)
        assert set(live.models) == {"echo-1.b_x"}
        assert ("llama", True) in events
        assert "llama" not in await treg.fetch_fleet_status(
            drts[T].store, NS)
        for d in drts.values():
            await d.close()
    finally:
        await srv.stop()


def _claims(rng, n):
    out = []
    for i in range(n):
        want = rng.randrange(0, 5)
        out.append(dict(
            model=f"m{i}", want=want, current=rng.randrange(0, 4),
            chips_per_replica=rng.choice((0, 1, 1, 2, 4)),
            min_replicas=rng.choice((0, 0, 1)),
            priority=rng.choice((0, 0, 1)),
            burn=rng.choice((0.0, 0.3, 1.0, 5.0)),
            swap_group=rng.choice(("", "g", "h"))))
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_arbiter_grants_equal_jax_over_seeded_claims(seed):
    rng = random.Random(seed)
    ja, ta = _mod(J, "fleet.arbiter"), _mod(T, "fleet.arbiter")
    preempted = 0
    for _ in range(150):
        budget = rng.randrange(0, 10)
        margin = rng.choice((0.0, 0.5, 2.0))
        claims = _claims(rng, rng.randrange(1, 6))
        want = ja.ChipArbiter(budget, preempt_margin=margin).grant(
            [ja.PoolClaim(**c) for c in claims])
        got = ta.ChipArbiter(budget, preempt_margin=margin).grant(
            [ta.PoolClaim(**c) for c in claims])
        assert got == want
        preempted += sum(1 for _, why in got.values()
                         if why and "yielded to" in why)
    assert preempted > 0


class FakeStore:
    """get/put/delete/get_prefix/watch_prefix over a dict, with the
    write log both planes are compared by."""

    def __init__(self):
        self.kv = {}
        self.log = []

    async def get(self, key):
        return self.kv.get(key)

    async def put(self, key, value, lease=None):
        self.kv[key] = value
        self.log.append(("put", key, value))

    async def delete(self, key):
        self.log.append(("delete", key))
        return self.kv.pop(key, None) is not None

    async def get_prefix(self, prefix):
        return sorted((k, v) for k, v in self.kv.items()
                      if k.startswith(prefix))

    async def watch_prefix(self, prefix, cb):
        return await self.get_prefix(prefix)


def _plane_run(pkg):
    """Hints, arbitration, swap pairing and status on one package's
    plane over a fake store; returns what a reader can observe."""
    plane_mod = _mod(pkg, "fleet.plane")
    pol = _mod(pkg, "planner.policy")
    sig = _mod(pkg, "planner.signals")
    conn = _mod(pkg, "planner.connectors").LocalConnector(
        "127.0.0.1:0", NS, {}, platform="cpu")
    store = FakeStore()
    plane = plane_mod.FleetPlane(store, NS, total_chips=2)
    specs = [_spec(pkg, name="a", engine="jax", model_path="/ckpt/a",
                   swap_group="g", min_replicas=0),
             _spec(pkg, name="b", engine="jax", model_path="/ckpt/b",
                   swap_group="g", min_replicas=0, priority=1),
             _spec(pkg, name="c", model_path="/ckpt/c", prewarm=True,
                   min_replicas=0),
             _spec(pkg, name="d", chips_per_replica=0)]
    plane.registry.models = {s.name: s for s in specs}

    def dec(pool, cur, tgt, act):
        return pol.Decision(pool=pool, current=cur, proposed=tgt,
                            target=tgt, action=act, reason="r",
                            policy="load")

    async def body():
        await plane.publish_prefetch_hints()
        await plane.publish_prefetch_hints()          # change-gated
        decisions = [dec("a", 1, 1, pol.HOLD), dec("b", 0, 1, pol.SCALE_UP),
                     dec("c", 1, 1, pol.HOLD), dec("d", 3, 5, pol.SCALE_UP)]
        signals = {p: sig.PoolSignals(pool=p, replicas=d.current)
                   for p, d in zip("abcd", decisions)}
        plane.arbitrate(decisions, signals)
        await plane.actuate_swaps(decisions, conn)
        await plane.actuate_swaps(decisions, conn)   # need met: no repeat
        await store.put("mobility/fleetns/wake/b", json.dumps(
            {"path": "swap", "seconds": 1.5}).encode())

        class Drt:
            lease = None

        Drt.store = store
        await plane.publish_status(Drt(), decisions, signals)
        del plane.registry.models["c"]
        await plane.publish_prefetch_hints()
        # the spawned worker's argv for a JAX record serves on torch
        spec = plane.pool_spec(specs[0])
        return decisions, spec

    decisions, spec = asyncio.run(body())
    log = [(e[0], e[1], json.loads(e[2]) if len(e) > 2 else None)
           for e in store.log]
    for kind, key, val in log:
        if isinstance(val, dict):
            val.pop("ts", None)
            val.pop("issued_at", None)
    return ([(d.to_dict(), getattr(d, "swap_in", 0),
              getattr(d, "swap_out", 0)) for d in decisions],
            log, spec, conn._live_swaps("b"))


def test_plane_hints_arbitration_swaps_and_status_equal_jax():
    jd, jlog, jspec, jswaps = _plane_run(J)
    td, tlog, tspec, tswaps = _plane_run(T)
    assert td == jd and tlog == jlog and tswaps == jswaps == 1
    by_pool = {d["pool"]: (d, i, o) for d, i, o in td}
    # b (priority 1) takes a's one card by an in-place swap of a's worker
    assert by_pool["b"][0]["target"] == 1 and by_pool["b"][1] == 1
    assert by_pool["a"][0]["target"] == 0 and by_pool["a"][2] == 1
    assert "yielded to b" in by_pool["a"][0]["reason"]
    swaps = [v for k, key, v in tlog if "/swap/" in key]
    assert swaps == [{"model": "b", "component": "backend-b",
                      "model_path": "/ckpt/b", "from": "a"}]
    status = {key.rsplit("/", 1)[1]: v for k, key, v in tlog
              if key.startswith("fleet_status/")}
    assert status["b"]["wake_path"] == "swap"
    assert status["b"]["state"] == "booting"
    # the JAX record's engine "jax" becomes the torch worker
    assert (jspec.engine, tspec.engine) == ("jax", "torch")
    assert tspec.extra_args == jspec.extra_args
    assert tspec.extra_args[:3] == ["--model-name", "a", "--register-model"]


# ---------------------------------------------------------------------------
# fleet planners over one store: same decisions, boots before drains
# ---------------------------------------------------------------------------
class RecordingConnector:
    name = "recording"

    def __init__(self):
        self.applied, self.pool_specs, self.removed = [], {}, []

    def set_pool(self, pool, spec):
        self.pool_specs[pool] = spec

    async def remove_pool(self, pool):
        self.removed.append(pool)

    async def apply(self, pool, target, decision):
        self.applied.append((pool, target, decision.action))

    async def close(self):
        pass


async def _seed_worker(drt, namespace, component, active=0, total=8):
    from dynamo_tpu_torch.llm.kv_router.protocols import ForwardPassMetrics
    from dynamo_tpu_torch.llm.metrics_aggregator import metrics_key
    from dynamo_tpu_torch.runtime.component import EndpointInfo, endpoint_key

    info = EndpointInfo(host="127.0.0.1", port=1, endpoint="generate",
                        lease=drt.lease, worker_id=drt.worker_id)
    await drt.store.put(
        endpoint_key(namespace, component, "generate", drt.lease),
        info.to_bytes(), lease=drt.lease)
    m = ForwardPassMetrics(request_active_slots=active,
                           request_total_slots=total)
    await drt.store.put(metrics_key(namespace, component, drt.worker_id),
                        json.dumps(m.to_dict()).encode(), lease=drt.lease)


async def test_fleet_planners_reconcile_alike_boots_before_drains():
    srv = _mod(T, "runtime.store_server").PyStoreServer()
    port = await srv.start()
    DRT = _mod(T, "runtime.component").DistributedRuntime
    try:
        drt = await DRT(store_port=port).connect()
        seeds = [await DRT(store_port=port).connect() for _ in range(3)]
        runs = {}
        for pkg, ns in ((J, "fpj"), (T, "fpt")):
            reg = _mod(pkg, "fleet.registry")
            for kw in (dict(name="coldm", component="backend-coldm",
                            chips_per_replica=0, min_replicas=0,
                            max_replicas=4),
                       dict(name="hotm", component="backend-hotm",
                            chips_per_replica=0, min_replicas=0,
                            max_replicas=4)):
                await reg.put_fleet_model(drt.store, ns, _spec(pkg, **kw))
            await _seed_worker(seeds[0], ns, "backend-coldm")
            await _seed_worker(seeds[1], ns, "backend-coldm")
            await _seed_worker(seeds[2], ns, "backend-hotm", 8, 8)
            loop_mod = _mod(pkg, "planner.loop")
            conn = RecordingConnector()
            planner = loop_mod.Planner(
                drt, ns, {}, _mod(pkg, "planner.policy").LoadPolicy(), conn,
                loop_mod.PlannerConfig(interval=30.0, min_replicas=1,
                                       max_replicas=8, cooldown_up=0.0,
                                       cooldown_down=0.0, down_consensus=1),
                fleet=_mod(pkg, "fleet.plane").FleetPlane(
                    drt.store, ns, total_chips=4))
            await planner.fleet.start()
            await planner._watch_override()
            ds = await planner.run_once(now=1000.0)
            status = await reg.fetch_fleet_status(drt.store, ns)
            for st in status.values():
                st.pop("ts")
            # the model leaves: its pool drains and is forgotten
            await reg.remove_fleet_model(drt.store, ns, "hotm")
            await asyncio.sleep(0.2)
            await planner.run_once(now=2000.0)
            runs[pkg] = ([dict(d.to_dict(), ts=0, signals=None)
                          for d in ds], conn.applied, status,
                         conn.removed, planner.pools,
                         {p: s.extra_args
                          for p, s in conn.pool_specs.items()})
        assert runs[T] == runs[J]
        _, applied, status, removed, pools, _ = runs[T]
        assert [(p, a) for p, _t, a in applied][:2] == [
            ("hotm", "scale_up"), ("coldm", "scale_down")]
        assert status["hotm"]["state"] == "booting"
        assert status["coldm"]["state"] == "draining"
        assert removed == ["hotm"] and pools == {"coldm": "backend-coldm"}
        for c in seeds + [drt]:
            await c.close()
    finally:
        await srv.stop()


async def test_fleet_routers_follow_the_registry_and_refuse_alike():
    srv = _mod(T, "runtime.store_server").PyStoreServer()
    port = await srv.start()
    try:
        errs = []
        for pkg in PKGS:
            reg = _mod(pkg, "fleet.registry")
            drt = await _mod(pkg, "runtime.component").DistributedRuntime(
                store_port=port).connect()
            ns = f"fr-{pkg}"
            await reg.put_fleet_model(drt.store, ns, _spec(
                pkg, name="m1", component="backend-m1"))
            router = await _mod(pkg, "llm.kv_router.router").FleetKvRouter(
                drt, ns, block_size=4).start()
            assert set(router.routers) == {"m1"}
            assert router.routers["m1"].worker_component == "backend-m1"
            assert router.routers["m1"].scheduler.model == "m1"
            await reg.put_fleet_model(drt.store, ns, _spec(
                pkg, name="m2", component="backend-m2"))
            await asyncio.sleep(0.3)
            assert set(router.routers) == {"m1", "m2"}
            EngineError = _mod(pkg, "runtime.engine").EngineError
            with pytest.raises(EngineError) as ei:
                await router.route([1, 2, 3], model="ghost")
            errs.append((ei.value.code, ei.value.reason, str(ei.value)))
            with pytest.raises(EngineError):
                await router.route([1, 2, 3], model=None)
            await reg.remove_fleet_model(drt.store, ns, "m2")
            await asyncio.sleep(0.3)
            assert set(router.routers) == {"m1"}
            assert router.decisions() == []
            await router.stop()
            await drt.close()
        assert errs[1] == errs[0] and errs[1][:2] == (503, "unknown_model")
        from dynamo_tpu_torch.cli import router as cli

        assert cli.parse_args(["--fleet"]).fleet is True
    finally:
        await srv.stop()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return json.loads(r.read())


async def test_frontend_lists_fleet_models_and_takes_registry_quotas():
    from dynamo_tpu_torch.cli import http
    from dynamo_tpu_torch.fleet.registry import (publish_fleet_status,
                                                 put_fleet_model)

    srv = _mod(T, "runtime.store_server").PyStoreServer()
    port = await srv.start()
    svc = None
    try:
        drt = await _mod(T, "runtime.component").DistributedRuntime(
            store_port=port).connect()
        await put_fleet_model(drt.store, "dynamo", _spec(
            T, name="zero", min_replicas=0,
            tenants={"acme": dict(rps=5, burst=10, concurrency=8)}))
        svc = await http.run_http(http.parse_args(
            ["--store", f"127.0.0.1:{port}", "--port", "0", "--host",
             "127.0.0.1", "--namespace", "dynamo"]))
        rows = {r["id"]: r for r in (await asyncio.to_thread(
            _get, svc.port, "/v1/models"))["data"]}
        # registered, no planner yet: listed, state honest
        assert rows["zero"]["state"] == "unknown"
        assert rows["zero"]["component"] == "backend-zero"
        assert svc.known_models() == {"zero"}
        assert svc.tenants.quotas["acme"].rps == 5
        await publish_fleet_status(drt.store, "dynamo", "zero", {
            "state": "off", "replicas": 0, "target": 0,
            "component": "backend-zero", "chips": 0, "wake_path": "swap",
            "wake_seconds": 1.25})
        rows = {r["id"]: r for r in (await asyncio.to_thread(
            _get, svc.port, "/v1/models"))["data"]}
        assert rows["zero"]["state"] == "off"
        assert rows["zero"]["wake_path"] == "swap"
        # a registry change moves the live quota table
        await put_fleet_model(drt.store, "dynamo", _spec(
            T, name="zero", min_replicas=0,
            tenants={"acme": dict(rps=9, burst=10, concurrency=8)}))
        await asyncio.sleep(0.2)
        assert svc.tenants.quotas["acme"].rps == 9
        await drt.close()
    finally:
        if svc is not None:
            await svc.stop()
        await srv.stop()
