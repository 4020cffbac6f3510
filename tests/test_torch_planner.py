"""The port's planner (``dynamo_tpu_torch/planner``, ``sdk/allocator``,
``cli/{planner,plannerctl}``) against the JAX package's.

Both decision engines give the same decision records over one seeded
stream of pool signals (cooldowns, scale-down consensus, clamps, per-pool
floors of 0 with scale-from-zero, overrides, pause, dry run); the profile
tables interpolate and serialize alike; the allocators place cards where
the JAX one places chips, under ``CUDA_VISIBLE_DEVICES``; the signal
helpers read the same stage dumps alike; the Kubernetes connector patches
the JAX package's fake API as the JAX connector does; the planner loops
publish the same records into the port's store, which the JAX
``plannerctl`` reads back; and one end-to-end run scales a pool of the
port's echo workers up under load and drains it back.
"""

import asyncio
import json
import random
import sys
import time

import pytest

from dynamo_tpu.planner import policy as jpol
from dynamo_tpu.planner import profile as jprof
from dynamo_tpu.planner import signals as jsig
from dynamo_tpu.sdk.allocator import TpuAllocator
from dynamo_tpu_torch.planner import policy as tpol
from dynamo_tpu_torch.planner import profile as tprof
from dynamo_tpu_torch.planner import signals as tsig
from dynamo_tpu_torch.sdk.allocator import AllocationError, CudaAllocator

def _signal_stream(seed: int, pools, steps: int):
    """A seeded sequence of (now, {pool: signal kwargs}, override) ticks:
    surges, idles, zero-replica pools with unserved demand, breakers,
    sheds and latency readings; now advances by 0.5-40 s so the up and
    down cooldowns both fire and hold."""
    rng = random.Random(seed)
    now = 1000.0
    out = []
    for i in range(steps):
        now += rng.choice((0.5, 2.0, 5.0, 12.0, 40.0))
        sigs = {}
        for pool in pools:
            replicas = rng.choice((0, 1, 1, 2, 3, 4, 6))
            total = 8.0 * replicas
            kind = rng.choice(("surge", "idle", "mid", "zero"))
            active = {"surge": total, "idle": 0.0,
                      "mid": total * 0.5, "zero": 0.0}[kind]
            kw = dict(replicas=replicas, active_slots=active,
                      total_slots=total,
                      queue_depth=rng.choice((0.0, 0.0, 3.0, 12.0))
                      if kind == "surge" else 0.0,
                      kv_active=rng.choice((0.0, 30.0, 60.0)),
                      kv_total=64.0,
                      breaker_open=rng.choice((0, 0, 0, 1))
                      if replicas else 0,
                      shed_rate=rng.choice((0.0, 0.0, 1.5)),
                      unserved=(rng.choice((0.0, 2.0))
                                if replicas == 0 else 0.0),
                      ttft_p90=rng.choice((None, 0.2, 3.0)),
                      itl_p90=rng.choice((None, 0.01, 0.2)))
            sigs[pool] = kw
        override = None
        if i % 11 == 5:
            override = ({pools[0]: rng.choice((0, 2, 9))}, False)
        elif i % 11 == 8:
            override = ({}, True)
        elif i % 11 == 9:
            override = ({}, False)
        out.append((now, sigs, override))
    return out


def _table(prof):
    return prof.run_profile("synthetic", [1, 2, 4, 8, 16], [128, 512],
                            gen_tokens=16)


@pytest.mark.parametrize("policy,dry_run", [("load", False),
                                            ("load", True),
                                            ("sla", False)])
def test_core_decisions_equal_jax_over_seeded_signals(policy, dry_run):
    pools = ["decode", "m-zero", "m-capped"]
    cores = []
    for pol, prof in ((jpol, jprof), (tpol, tprof)):
        p = (pol.LoadPolicy() if policy == "load" else
             pol.SlaPolicy(_table(prof), ttft_target=2.0, itl_target=0.05))
        core = pol.PlannerCore(p, min_replicas=1, max_replicas=6,
                               cooldown_up=10.0, cooldown_down=30.0,
                               down_consensus=3, dry_run=dry_run)
        # fleet-style per-pool clamps: a scale-to-zero pool and a capped one
        core.set_pool_clamps({"m-zero": (0, 3), "m-capped": (1, 2)})
        cores.append(core)
    jcore, tcore = cores
    seen = set()
    for now, sigs, override in _signal_stream(7, pools, 160):
        if override is not None:
            jcore.set_override(*override)
            tcore.set_override(*override)
        want = jcore.evaluate({p: jsig.PoolSignals(pool=p, **kw)
                               for p, kw in sigs.items()}, now)
        got = tcore.evaluate({p: tsig.PoolSignals(pool=p, **kw)
                              for p, kw in sigs.items()}, now)
        assert [d.to_dict() for d in got] == [d.to_dict() for d in want]
        seen.update((d.action, d.suppressed) for d in got)
    # the stream exercised every damping path
    assert {(tpol.SCALE_UP, None), (tpol.SCALE_DOWN, None),
            (tpol.HOLD, "cooldown"), (tpol.HOLD, "paused"),
            (tpol.HOLD, "clamp")} <= seen
    if policy == "load":
        assert (tpol.HOLD, "flap_damping") in seen


def test_profile_tables_interpolate_and_serialize_like_jax(tmp_path):
    jt, tt = _table(jprof), _table(tprof)
    assert json.dumps(tt.to_dict()) == json.dumps(jt.to_dict())
    for ttft in (0.05, 0.2, 1.0, 10.0):
        for itl in (0.005, 0.02, 0.05, 1.0):
            for sl in (None, 128, 512):
                assert tt.capacity_per_replica(ttft, itl, sl) == \
                    jt.capacity_per_replica(ttft, itl, sl)
    # a table one package saves, the other loads to the same points
    path = str(tmp_path / "p.json")
    tt.save(path)
    back = jprof.ProfileTable.load(path)
    assert json.dumps(back.to_dict()) == json.dumps(jt.to_dict())
    # the sweep CLI writes the same table
    out = str(tmp_path / "cli.json")
    assert tprof.main(["--engine", "synthetic", "--batches", "1,2",
                       "--seq-lens", "64", "--out", out]) == 0
    assert len(tprof.ProfileTable.load(out).points) == 2
    with pytest.raises(ValueError, match="synthetic \\| torch"):
        tprof.run_profile("jax", [1], [64])


def test_torch_profile_sweeps_the_engine_on_the_cpu():
    t = tprof.run_profile("torch", [1, 2], [16], gen_tokens=4,
                          model="tiny-byte", device="cpu")
    assert t.meta == {"engine": "torch", "platform": "cpu",
                      "model": "tiny-byte"}
    assert [(p.batch, p.seq_len) for p in t.points] == [(1, 16), (2, 16)]
    assert all(p.ttft_s > 0 and p.tok_s > 0 for p in t.points)
    # an SlaPolicy loads what the sweep wrote
    assert tpol.SlaPolicy(t, ttft_target=10.0, itl_target=1.0).capacity > 0


def test_allocator_places_cards_where_jax_places_chips():
    rng = random.Random(3)
    j, t = TpuAllocator(8, "tpu"), CudaAllocator(8, "cuda")
    live = []
    for step in range(200):
        if live and rng.random() < 0.45:
            i = rng.randrange(len(live))
            ja, ta = live.pop(i)
            j.release(ja)
            t.release(ta)
            j.release(ja)           # a stale handle frees nothing twice
            t.release(ta)
        else:
            n = rng.choice((1, 1, 2, 3, 4))
            svc = f"s{step % 5}"
            try:
                ja = j.allocate_handle(n, service=svc)
            except Exception as e:     # noqa: BLE001
                with pytest.raises(AllocationError) as ei:
                    t.allocate_handle(n, service=svc)
                assert str(ei.value) == str(e).replace("chips", "cards")
                continue
            ta = t.allocate_handle(n, service=svc)
            assert ta.chips == ja.chips and t.device(n) == "cuda"
            assert ta.env == {"CUDA_VISIBLE_DEVICES":
                              ja.env["TPU_VISIBLE_DEVICES"]}
            live.append((ja, ta))
        assert t.placements() == j.placements()
    # a CPU grant hides every card; the worker is told --device cpu
    for a, n in ((t, 0), (CudaAllocator(4, "cpu"), 2)):
        alloc = a.allocate_handle(n, "cpu-svc")
        assert alloc.env == {"CUDA_VISIBLE_DEVICES": ""}
        assert alloc.chips == [] and a.device(n) == "cpu"


def test_signal_helpers_read_stage_dumps_like_jax():
    rng = random.Random(11)
    dumps = []
    for comp in ("http", "backend-a", "backend-b"):
        hist = {}
        for model in ("a", "b", "zero"):
            counts = [rng.randrange(0, 20) for _ in range(4)]
            hist[model] = {"counts": counts, "total": sum(counts),
                           "sum": 1.0}
        dumps.append((comp, {
            "llm_ttft_seconds": {"kind": "histogram", "labels": ["model"],
                                 "buckets": [0.05, 0.1, 1.0, 10.0],
                                 "series": hist},
            "llm_inter_token_seconds": {
                "kind": "histogram", "labels": ["model"],
                "buckets": [0.01, 0.1], "series": {
                    "a": {"counts": [3, 1], "total": 5, "sum": 0.2}}},
            "dyn_http_requests_total": {
                "kind": "counter",
                "labels": ["model", "endpoint", "status", "tenant"],
                "series": {f"{m}\x1fcompletions\x1f{st}\x1fdefault":
                           float(rng.randrange(0, 9))
                           for m in ("a", "zero", "unknown")
                           for st in ("200", "404")}},
            "dyn_queue_until_boot_total": {
                "kind": "counter", "labels": ["model", "outcome"],
                "series": {"zero\x1fparked": 2.0, "zero\x1fserved": 1.0}},
            "dyn_circuit_state": {
                "kind": "gauge", "labels": ["observer", "instance"],
                "series": {"1\x1fab": 2, "1\x1fcd": 0, "2\x1fef": 2}},
        }))
    for model in (None, "a", "b", "zero"):
        js = jsig.filter_states_by_model(dumps, model) if model else dumps
        ts = tsig.filter_states_by_model(dumps, model) if model else dumps
        assert ts == js
        for metric in ("llm_ttft_seconds", "llm_inter_token_seconds"):
            for q in (0.5, 0.9, 0.99):
                assert tsig.quantile_from_states(ts, metric, q) == \
                    jsig.quantile_from_states(js, metric, q)
    for model in ("a", "zero", "missing"):
        assert tsig.model_request_count(dumps, model) == \
            jsig.model_request_count(dumps, model)
        assert tsig.model_parked_count(dumps, model) == \
            jsig.model_parked_count(dumps, model)
    assert tsig.open_instance_ids(dumps) == jsig.open_instance_ids(dumps)
    assert tsig.breaker_open_instances(dumps, [0xab, 0xcd, 0xef]) == \
        jsig.breaker_open_instances(dumps, [0xab, 0xcd, 0xef]) == 2


def test_local_connector_argv_names_the_device_of_each_grant(tmp_path):
    from dynamo_tpu_torch.planner.connectors import LocalConnector, PoolSpec

    pools = {"decode": PoolSpec(component="backend", chips=1,
                                engine="torch"),
             "echo": PoolSpec(component="echo", chips=0),
             "prefill": PoolSpec(
                 component="prefill", chips=1,
                 module="dynamo_tpu_torch.cli.prefill_worker")}
    on_card = LocalConnector("127.0.0.1:1", "ns", pools, total_chips=2,
                             platform="cuda", logdir=str(tmp_path))
    argv = on_card._default_argv("decode", pools["decode"])
    assert argv[:3] == [sys.executable, "-m", "dynamo_tpu_torch.cli.worker"]
    assert argv[argv.index("--device") + 1] == "cuda"
    assert argv[argv.index("--engine") + 1] == "torch"
    argv = on_card._default_argv("echo", pools["echo"])
    assert argv[argv.index("--device") + 1] == "cpu"
    argv = on_card._default_argv("prefill", pools["prefill"])
    assert argv[argv.index("--device") + 1] == "cuda"
    assert "--engine" not in argv
    on_cpu = LocalConnector("127.0.0.1:1", "ns", pools, total_chips=2,
                            platform="cpu", logdir=str(tmp_path))
    argv = on_cpu._default_argv("decode", pools["decode"])
    assert argv[argv.index("--device") + 1] == "cpu"


def test_kube_connector_patches_the_jax_fake_api_alike():
    from dynamo_tpu.deploy.kube import FakeKubeApi
    from dynamo_tpu.planner.connectors import KubeConnector as JKube
    from dynamo_tpu_torch.planner.connectors import KubeConnector as TKube

    class D:
        current = 1

    objs = []
    for Kube in (JKube, TKube):
        api = FakeKubeApi()
        api.apply({"apiVersion": "dynamo.tpu/v1alpha1",
                   "kind": "DynamoDeployment",
                   "metadata": {"name": "agg", "namespace": "prod"},
                   "spec": {"services": {"decode": {"replicas": 1},
                                         "prefill": {"replicas": 2}}}})
        api.apply({"apiVersion": "apps/v1", "kind": "Deployment",
                   "metadata": {"name": "agg-decode", "namespace": "prod"},
                   "spec": {"replicas": 1,
                            "selector": {"matchLabels": {"app": "agg"}},
                            "template": {"metadata":
                                         {"labels": {"app": "agg"}}}}})
        crd = Kube(api, "agg", kube_namespace="prod", mode="crd")
        asyncio.run(crd.apply("decode", 3, D()))
        asyncio.run(crd.remove_pool("prefill"))
        dep = Kube(api, "agg", kube_namespace="prod", mode="deployment")
        asyncio.run(dep.apply("decode", 2, D()))
        objs.append((api.get("DynamoDeployment", "prod", "agg")["spec"],
                     api.get("Deployment", "prod",
                             "agg-decode")["spec"]["replicas"]))
    assert objs[1] == objs[0]
    assert objs[1][0]["services"] == {"decode": {"replicas": 3},
                                      "prefill": {"replicas": 0}}
    with pytest.raises(ValueError):
        TKube(None, "agg", mode="nope")


def test_planner_cli_parses_port_flags_and_refuses_kube():
    from dynamo_tpu_torch.cli import planner as cli

    args = cli.parse_args(["--fleet", "--connector", "local",
                           "--platform", "cuda", "--total-chips", "1",
                           "--brownout"])
    assert (args.fleet, args.platform, args.total_chips, args.brownout,
            args.worker_engine) == (True, "cuda", 1, True, "torch")
    with pytest.raises(SystemExit):
        cli.parse_args(["--platform", "tpu"])
    with pytest.raises(SystemExit):
        cli.parse_args(["--worker-engine", "jax"])
    conn = cli.build_connector(cli.parse_args(
        ["--connector", "local", "--worker-chips", "1", "--platform",
         "cuda"]), {"decode": "backend"})
    assert conn.pools["decode"].engine == "torch"
    assert conn.allocator.device(conn.pools["decode"].chips) == "cuda"
    with pytest.raises(NotImplementedError, match="item 12e"):
        cli.build_connector(cli.parse_args(
            ["--connector", "kube", "--kube-deployment", "agg"]), {})


def test_bare_planner_grants_torch_workers_a_card():
    """No flag: the local connector spawns torch workers on a card each
    (``CUDA_VISIBLE_DEVICES`` from the allocator, ``--device cuda``);
    the CPU is the caller's explicit choice, and echo workers take none."""
    from dynamo_tpu_torch.cli import planner as cli

    args = cli.parse_args([])
    assert (args.platform, args.worker_engine, args.worker_chips,
            args.prefill_worker_chips) == ("cuda", "torch", 1, 1)
    conn = cli.build_connector(cli.parse_args(["--connector", "local"]),
                               {"decode": "backend", "prefill": "prefill"})
    for pool in ("decode", "prefill"):
        spec = conn.pools[pool]
        argv = conn._default_argv(pool, spec)
        assert argv[argv.index("--device") + 1] == "cuda"
        assert spec.chips == 1
    assert conn.allocator.allocate(conn.pools["decode"].chips,
                                   "decode") == {"CUDA_VISIBLE_DEVICES": "0"}
    echo = cli.build_connector(cli.parse_args(
        ["--connector", "local", "--worker-engine", "echo"]),
        {"decode": "backend"})
    argv = echo._default_argv("decode", echo.pools["decode"])
    assert argv[argv.index("--device") + 1] == "cpu"
    cpu = cli.build_connector(cli.parse_args(
        ["--connector", "local", "--platform", "cpu"]), {"decode": "backend"})
    argv = cpu._default_argv("decode", cpu.pools["decode"])
    assert argv[argv.index("--device") + 1] == "cpu"


# ---------------------------------------------------------------------------
# the loops over one real store: same records, read across packages
# ---------------------------------------------------------------------------
class RecordingConnector:
    name = "recording"

    def __init__(self):
        self.applied = []

    async def apply(self, pool, target, decision):
        self.applied.append((pool, target, decision.action))

    async def close(self):
        pass


async def _seed_worker(drt, namespace, component, active, total):
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


async def test_planner_loops_publish_alike_and_plannerctl_reads_across(
        capsys):
    from dynamo_tpu.cli import plannerctl as jctl
    from dynamo_tpu.planner.loop import Planner as JPlanner
    from dynamo_tpu.planner.loop import PlannerConfig as JConfig
    from dynamo_tpu_torch.cli import plannerctl as tctl
    from dynamo_tpu_torch.planner.loop import (Planner, PlannerConfig,
                                               decisions_prefix, state_key)
    from dynamo_tpu_torch.runtime.component import DistributedRuntime
    from dynamo_tpu_torch.runtime.store_server import PyStoreServer

    srv = PyStoreServer()
    port = await srv.start()
    try:
        drt = await DistributedRuntime(store_port=port).connect()
        wrt = await DistributedRuntime(store_port=port).connect()
        for ns in ("pj", "pt"):
            await _seed_worker(wrt, ns, "backend", active=8, total=8)
        kw = dict(interval=30.0, min_replicas=1, max_replicas=4,
                  cooldown_up=0.0, cooldown_down=0.0, down_consensus=1)
        conns = RecordingConnector(), RecordingConnector()
        planners = [
            JPlanner(drt, "pj", {"decode": "backend"}, jpol.LoadPolicy(),
                     conns[0], JConfig(**kw)),
            Planner(drt, "pt", {"decode": "backend"}, tpol.LoadPolicy(),
                    conns[1], PlannerConfig(**kw))]
        for p in planners:
            await p._watch_override()
            await p.run_once(now=1000.0)
        assert conns[1].applied == conns[0].applied == [
            ("decode", 2, tpol.SCALE_UP)]
        recs = []
        for ns in ("pj", "pt"):
            items = await drt.store.get_prefix(decisions_prefix(ns))
            rec = json.loads(items[0][1].decode())
            rec.pop("ts")
            recs.append(rec)
        assert recs[1] == recs[0]
        st = json.loads((await drt.store.get(state_key("pt"))).decode())
        assert st["pools"]["decode"]["replicas"] == 1
        # the port's plannerctl steers the port's loop; the JAX
        # plannerctl reads the port's state and decisions
        store = ["--store", f"127.0.0.1:{port}", "--namespace", "pt"]
        assert await tctl.run(tctl.parse_args(store + ["pause"])) == 0
        await asyncio.sleep(0.1)
        assert (await planners[1].run_once(now=2000.0))[0].suppressed == \
            "paused"
        capsys.readouterr()
        assert await jctl.run(jctl.parse_args(store + ["status"])) == 0
        assert await jctl.run(jctl.parse_args(store + ["decisions"])) == 0
        out = capsys.readouterr().out
        assert "planner[pt] live policy=load" in out and "PAUSED" in out
        assert "scale_up" in out and "[paused]" in out
        await wrt.close()
        await drt.close()
    finally:
        await srv.stop()


# ---------------------------------------------------------------------------
# end to end: the port's echo workers scaled up under load and drained
# ---------------------------------------------------------------------------
async def _await_live(collector, pool, n, timeout=45.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        sigs = await collector.collect()
        if sigs[pool].replicas == n:
            return sigs[pool]
        await asyncio.sleep(0.2)
    raise AssertionError(f"{pool} never reached {n} live replicas")


async def test_planner_e2e_scales_echo_pool_up_and_drains():
    from dynamo_tpu_torch.llm.protocols.common import BackendInput
    from dynamo_tpu_torch.planner.connectors import LocalConnector, PoolSpec
    from dynamo_tpu_torch.planner.loop import Planner, PlannerConfig
    from dynamo_tpu_torch.planner.signals import SignalCollector
    from dynamo_tpu_torch.runtime.component import DistributedRuntime
    from dynamo_tpu_torch.runtime.engine import Context
    from dynamo_tpu_torch.runtime.store_server import PyStoreServer

    srv = PyStoreServer()
    port = await srv.start()
    ns = "tplane2e"
    store_addr = f"127.0.0.1:{port}"
    spec = PoolSpec(component="backend", engine="echo",
                    extra_args=["--echo-slots", "4"],
                    env={"DYNAMO_TPU_DATAPLANE": "python",
                         "DYN_TOKEN_ECHO_DELAY_MS": "20"})
    # baseline worker the planner does NOT own (the floor it drains to)
    baseline = LocalConnector(store_addr, ns, {"decode": spec},
                              platform="cpu")
    drt = await DistributedRuntime(store_port=port).connect()
    collector = SignalCollector(drt.store, ns, {"decode": "backend"})
    client = (drt.namespace(ns).component("backend").endpoint("generate")
              .client())
    failures: list = []
    surge_on = asyncio.Event()

    async def one_request(n_tokens):
        try:
            got = 0
            ctx = Context(deadline=time.time() + 30.0)
            async for _ in client.generate(
                    BackendInput(token_ids=list(range(1, n_tokens + 1))
                                 ).to_dict(), ctx):
                got += 1
            assert got == n_tokens
        except Exception as e:  # noqa: BLE001
            failures.append(repr(e))

    async def surge():
        while surge_on.is_set():
            await asyncio.gather(*(one_request(25) for _ in range(12)))

    planner = None
    try:
        baseline._spawn("decode", spec)
        # the spawned worker runs the echo engine on the CPU
        argv = baseline._default_argv("decode", spec)
        assert argv[argv.index("--device") + 1] == "cpu"
        await _await_live(collector, "decode", 1)
        await client.start()
        await client.wait_for_instances(1, timeout=10)
        live_conn = LocalConnector(store_addr, ns, {"decode": spec},
                                   platform="cpu")
        planner = await Planner(
            drt, ns, {"decode": "backend"}, tpol.LoadPolicy(), live_conn,
            PlannerConfig(interval=0.25, min_replicas=1, max_replicas=2,
                          cooldown_up=1.0, cooldown_down=2.5,
                          down_consensus=2)).start()
        surge_on.set()
        surge_task = asyncio.create_task(surge())
        assert (await _await_live(collector, "decode", 2)).replicas == 2
        up = next(d for d in planner.decisions_log
                  if d.action == tpol.SCALE_UP)
        assert (up.current, up.target) == (1, 2)
        surge_on.clear()
        await surge_task
        # idle: consensus + cooldown -> graceful drain to the baseline
        await _await_live(collector, "decode", 1)
        down = next(d for d in planner.decisions_log
                    if d.action == tpol.SCALE_DOWN)
        assert down.target == 1
        proc = planner.connector.owned["decode"][0].proc
        assert await asyncio.to_thread(proc.wait) == 0   # SIGTERM drain
        await one_request(8)
        assert failures == []
        # the loop published its dyn_planner_* series on the stage plane
        from dynamo_tpu_torch.llm.metrics_aggregator import \
            fetch_stage_states
        states = await fetch_stage_states(drt.store, ns)
        assert any(c == "planner" and "dyn_planner_decisions_total" in d
                   for c, d in states)
    finally:
        surge_on.clear()
        if planner is not None:
            await planner.stop()
        await baseline.close()
        await drt.close()
        await srv.stop()
