"""The port's scale plane (``runtime/scale/``, ``cli/aggregator.py``)
against the JAX package's.

Rendezvous owners equal JAX's for the same ids and members and move only
a dead member's workers; region pre-merges answer the flat-scrape readers
identically and equal JAX's merge; the sharded client routes every
keyspace family to the shard JAX's routes it to, fans prefix scans out
only across spanning shards, mirrors leases onto every shard and, with
one shard down, degrades only that shard's families (counted); bad shard
maps are refused with JAX's messages; the port's aggregators publish the
JAX aggregator's region record over a real sharded store and readers fall
back to the flat scrape when records go stale; queue-until-boot parks a
registered model's request until a replica appears.
"""

import asyncio
import importlib
import json
import time
import urllib.error
import urllib.request

import pytest

J, T = PKGS = ("dynamo_tpu", "dynamo_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


# ---------------------------------------------------------------------------
# rendezvous
# ---------------------------------------------------------------------------

def test_rendezvous_owners_equal_jax_and_stable_under_churn():
    jr, tr = _mod(J, "runtime.scale.rendezvous"), \
        _mod(T, "runtime.scale.rendezvous")
    workers = list(range(1000, 2000))
    members = ["a1", "a2", "a3", "a4", "a5"]
    before = {w: tr.rendezvous_owner(w, members) for w in workers}
    assert before == {w: jr.rendezvous_owner(w, members) for w in workers}
    assert tr.rendezvous_shares(workers, members) == \
        jr.rendezvous_shares(workers, members)
    assert all(tr.rendezvous_owner(w, members[::-1]) == before[w]
               for w in workers[:50])
    # member death: ONLY the dead member's workers move
    after = {w: tr.rendezvous_owner(w, [m for m in members if m != "a3"])
             for w in workers}
    assert all(after[w] == before[w] if before[w] != "a3"
               else after[w] != "a3" for w in workers)
    # join: steals roughly an even slice, moves nothing else
    joined = {w: tr.rendezvous_owner(w, members + ["a6"]) for w in workers}
    moved = [w for w in workers if joined[w] != before[w]]
    assert all(joined[w] == "a6" for w in moved)
    assert 1000 / 6 * 0.5 < len(moved) < 1000 / 6 * 1.8
    assert tr.rendezvous_owner(7, []) is None


# ---------------------------------------------------------------------------
# region pre-merge against the flat scrape
# ---------------------------------------------------------------------------

def _worker_dump(wid: int, err: bool = False):
    """A per-worker state dump: latency histogram, request counter,
    per-observer breaker gauge, depth gauge, brownout gauge."""
    counts = [0] * 4
    counts[wid % 4] = 3 + wid % 5
    return {
        "llm_ttft_seconds": {
            "kind": "histogram", "labels": ["model"],
            "buckets": [0.1, 0.5, 1.0, 5.0],
            "series": {"echo": {"counts": counts, "sum": 1.0 * wid,
                                "total": sum(counts)}}},
        "dyn_http_requests_total": {
            "kind": "counter", "labels": ["model", "endpoint", "status",
                                          "tenant"],
            "series": {f"echo\x1fcompletions\x1f"
                       f"{'500' if err else '200'}\x1fdefault": 2.0}},
        "dyn_circuit_state": {
            "kind": "gauge", "labels": ["observer", "instance"],
            "series": {f"{wid}\x1fdead1": 2.0 if err else 0.0}},
        "dyn_admission_queue_depth": {
            "kind": "gauge", "labels": [], "series": {"": 1.5}},
        "dyn_brownout_level": {
            "kind": "gauge", "labels": [], "series": {"": 2.0 if err
                                                      else 0.0}},
    }


def test_region_merge_equals_flat_scrape():
    from dynamo_tpu_torch.utils.overload import (admission_depth_total,
                                                 brownout_level_from_states)
    from dynamo_tpu_torch.utils.prometheus import merge_state_dumps
    from dynamo_tpu_torch.utils.slo import _availability_totals, _hist_totals

    dumps = [_worker_dump(w, err=(w % 7 == 0)) for w in range(40)]
    flat = [("backend", d) for d in dumps]
    merged_dump = merge_state_dumps(dumps)
    assert merged_dump == _mod(J, "utils.prometheus").merge_state_dumps(dumps)
    merged = [("backend", merged_dump)]
    assert _hist_totals(flat, "llm_ttft_seconds", 0.5) == \
        _hist_totals(merged, "llm_ttft_seconds", 0.5)
    assert _availability_totals(flat, "dyn_http_requests_total") == \
        _availability_totals(merged, "dyn_http_requests_total")
    # state gauges merge by MAX, quantity gauges by SUM
    assert brownout_level_from_states(merged) == \
        brownout_level_from_states(flat) == 2
    assert merged_dump["dyn_circuit_state"]["series"] == {
        f"{w}\x1fdead1": 2.0 if w % 7 == 0 else 0.0 for w in range(40)}
    assert admission_depth_total(merged) == \
        pytest.approx(admission_depth_total(flat)) == pytest.approx(60.0)


# ---------------------------------------------------------------------------
# shard routing
# ---------------------------------------------------------------------------

#: one representative key per registered family — a NEW family must add
#: its sample here or this test fails, keeping routing coverage total
FAMILY_SAMPLES = {
    "endpoints": "ns/components/backend/generate:ab12",
    "models": "models/chat/echo",
    "metrics": "metrics/ns/backend/ab12",
    "metrics-stage": "metrics_stage/ns/backend/ab12",
    "metrics-store": "metrics_stage/_store/store/0",
    "fleet-soak": "fleet/ns/beacon",
    "fleet-models": "fleet_models/ns/echo",
    "fleet-status": "fleet_status/ns/echo",
    "mobility": "mobility/ns/swap/backend-echo",
    "faults": "faults/store.connect",
    "overload": "overload/ns/brownout",
    "traces": "traces/tid/sid",
    "incidents": "incidents/ns/beacon/inc-1",
    "planner": "planner/ns/state",
    "kv-cluster": "kv_cluster/ns/backend/ab12",
    "disagg-config": "disagg/ns/echo",
    "prefill-queue": "ns.prefill",
    "prefill-cancel": "ns.prefill/cancelled/rid",
    "deployments": "deploy/deployments/ns/name",
    "deploy-status": "deploy/status/ns/name",
    "deploy-artifacts": "deploy/artifacts/name/00000001",
    "regions": "regions/ns/ab12",
}

PREFIXES = ["", "metrics_stage/", "metrics_stage/_store/", "traces/t1/",
            "ns/components/", "regions/ns/", "deploy/", "nowhere/", "m"]


def test_every_family_has_a_routed_sample():
    tk, jk = _mod(T, "runtime.keyspace"), _mod(J, "runtime.keyspace")
    assert set(FAMILY_SAMPLES) == set(tk.KEYSPACE)
    for fam, key in FAMILY_SAMPLES.items():
        assert tk.classify_key(key) == fam, (fam, key)
    for prefix in PREFIXES:
        assert tk.families_for_prefix(prefix) == \
            jk.families_for_prefix(prefix), prefix


class FakeShard:
    """StoreClient-shaped in-memory shard; ``dead=True`` raises the
    package's typed conn_lost on every call."""

    def __init__(self, pkg, dead=False):
        self.err = _mod(pkg, "runtime.store_client").StoreError
        self.kv = {}
        self.dead = dead
        self.calls = []
        self.leases = []
        self.revoked = []
        self.on_lease_lost = None
        self.on_session_replayed = None
        self.reconnect = None

    def _check(self, op, key):
        self.calls.append((op, key))
        if self.dead:
            raise self.err("connection lost (store disconnected)",
                           code="conn_lost")

    async def put(self, key, value, lease=None):
        self._check("put", key)
        self.kv[key] = (value, lease)

    async def get(self, key):
        self._check("get", key)
        v = self.kv.get(key)
        return v[0] if v else None

    async def get_prefix(self, prefix):
        self._check("get_prefix", prefix)
        return sorted((k, v[0]) for k, v in self.kv.items()
                      if k.startswith(prefix))

    async def lease_grant(self, ttl=5.0, auto_keepalive=True, reuse=None,
                          bind=True):
        self._check("lease_grant", reuse)
        lid = reuse if reuse is not None else 777
        self.leases.append(lid)
        return lid

    async def lease_revoke(self, lease):
        self._check("lease_revoke", lease)
        self.revoked.append(lease)

    async def q_len(self, queue):
        self._check("q_len", queue)
        return 0


def _sharded(pkg, dead=()):
    sh = _mod(pkg, "runtime.scale.shards")
    specs, fam_map = sh.parse_shard_map("telemetry=h:2;traces,queue=h:3",
                                        "h", 1)
    shards = [FakeShard(pkg, dead=(i in dead)) for i in range(3)]
    return sh.ShardedStoreClient(specs, fam_map, clients=shards), shards


async def test_shard_routing_covers_every_family_as_jax():
    routed = {}
    for pkg in PKGS:
        sc, shards = _sharded(pkg)
        got = {}
        for fam, key in FAMILY_SAMPLES.items():
            if fam == "prefill-queue":
                await sc.q_len(key)
                (got[fam],) = [i for i, s in enumerate(shards)
                               if ("q_len", key) in s.calls]
                continue
            await sc.put(key, b"x")
            assert await sc.get(key) == b"x"
            (got[fam],) = [i for i, s in enumerate(shards) if key in s.kv]
        routed[pkg] = got
    assert routed[T] == routed[J]
    assert {f: i for f, i in routed[T].items() if i} == {
        "metrics": 1, "metrics-stage": 1, "metrics-store": 1,
        "fleet-soak": 1, "regions": 1, "incidents": 1, "traces": 2,
        "prefill-queue": 2, "prefill-cancel": 2}


async def test_shard_prefix_fanout_and_single_shard_scan():
    sc, shards = _sharded(T)
    await sc.put("metrics_stage/ns/backend/a1", b"w")
    await sc.put("metrics_stage/_store/store/0", b"s")
    await sc.put("traces/t1/s1", b"t")
    # metrics_stage/ spans metrics-stage + metrics-store: both live on
    # the telemetry shard, so ONE scan serves it
    shards[1].calls.clear()
    items = await sc.get_prefix("metrics_stage/")
    assert [k for k, _ in items] == ["metrics_stage/_store/store/0",
                                     "metrics_stage/ns/backend/a1"]
    assert shards[1].calls == [("get_prefix", "metrics_stage/")]
    # a traces scan never touches the telemetry shard
    shards[1].calls.clear()
    assert await sc.get_prefix("traces/t1/") == [("traces/t1/s1", b"t")]
    assert shards[1].calls == []
    # the empty prefix fans out everywhere and merges sorted
    all_items = await sc.get_prefix("")
    assert [k for k, _ in all_items] == sorted(k for k, _ in all_items)
    assert len(all_items) == 3


async def test_lease_mirrors_ride_every_shard():
    sc, shards = _sharded(T)
    lid = await sc.lease_grant(ttl=4.0)
    assert [s.leases for s in shards] == [[lid]] * 3
    await sc.put("metrics/ns/backend/a1", b"m", lease=lid)
    assert shards[1].kv["metrics/ns/backend/a1"][1] == lid
    await sc.lease_revoke(lid)
    assert [s.revoked for s in shards] == [[lid]] * 3


async def test_one_shard_down_degrades_only_its_families():
    from dynamo_tpu_torch.runtime.store_client import StoreError
    from dynamo_tpu_torch.utils.prometheus import stage_metrics

    errs = stage_metrics().store_shard_errors
    n0 = errs.get("s1")
    sc, _shards = _sharded(T, dead={1})
    with pytest.raises(StoreError) as ei:
        await sc.put("metrics/ns/backend/a1", b"m")
    assert ei.value.code == "conn_lost"
    await sc.put("models/chat/echo", b"c")
    await sc.put("traces/t1/s1", b"t")
    assert await sc.get("models/chat/echo") == b"c"
    # a cross-shard fan-out serves the surviving shards' slice, counted
    items = await sc.get_prefix("")
    assert ("models/chat/echo", b"c") in items
    assert ("traces/t1/s1", b"t") in items
    assert errs.get("s1") == n0 + 1
    sc2, _ = _sharded(T, dead={0, 1, 2})
    with pytest.raises(StoreError):
        await sc2.get_prefix("")


def test_parse_shard_map_rejects_bad_config_as_jax():
    def refusals(pkg):
        sh = _mod(pkg, "runtime.scale.shards")
        out = []
        for raw in ("nonsense=h:1", "traces=h:1;traces=h:2", "traces",
                    "traces=h:x"):
            with pytest.raises(ValueError) as ei:
                sh.parse_shard_map(raw, "h", 0)
            out.append(str(ei.value))
        specs, fam = sh.parse_shard_map("", "h", 9)
        out.append((len(specs), fam))
        return out

    assert refusals(T) == refusals(J)
    from dynamo_tpu_torch.runtime.scale.shards import make_store_client
    from dynamo_tpu_torch.runtime.store_client import StoreClient

    assert type(make_store_client("h", 9, shards_env="")) is StoreClient


# ---------------------------------------------------------------------------
# aggregators and readers over a real sharded store
# ---------------------------------------------------------------------------

async def _publish_worker(store, ns, comp, wid, dump):
    from dynamo_tpu_torch.llm.metrics_aggregator import metrics_key, stage_key

    lease = await store.lease_grant(ttl=8.0)
    await store.put(stage_key(ns, comp, wid),
                    json.dumps({"component": comp, "seq": 1,
                                "metrics": dump}).encode(), lease=lease)
    await store.put(metrics_key(ns, comp, wid),
                    json.dumps({"request_active_slots": 2,
                                "request_total_slots": 4}).encode(),
                    lease=lease)


async def test_aggregator_region_records_and_reader_paths(monkeypatch):
    from dynamo_tpu.runtime.scale.regions import RegionalAggregator as JAgg
    from dynamo_tpu_torch.llm.metrics_aggregator import (fetch_stage_states,
                                                         fetch_stage_states_ex)
    from dynamo_tpu_torch.runtime.scale.regions import (RegionalAggregator,
                                                        fetch_region_states)
    from dynamo_tpu_torch.runtime.scale.shards import make_store_client
    from dynamo_tpu_torch.runtime.store_server import PyStoreServer
    from dynamo_tpu_torch.utils.prometheus import merge_state_dumps

    servers = [PyStoreServer(), PyStoreServer()]
    ports = [await s.start() for s in servers]
    ns = "scaletest"
    clients = []

    async def client():
        c = await make_store_client(
            "127.0.0.1", ports[0],
            shards_env=f"telemetry=127.0.0.1:{ports[1]}").connect()
        clients.append(c)
        return c

    try:
        pub = await client()
        for wid in range(1, 9):
            await _publish_worker(pub, ns, "backend", wid, _worker_dump(wid))
        # the telemetry families live on the second store only
        assert [k for k, _ in await pub.shards[0].get_prefix("")] == []
        flat, regional = await fetch_stage_states_ex(pub, ns)
        assert regional is None and [c for c, _ in flat] == ["backend"] * 8

        # the JAX aggregator's record over the same workers, then the
        # port's with the same region id: equal components
        c1, c2 = await client(), await client()
        l1, l2 = await c1.lease_grant(ttl=8.0), await c2.lease_grant(ttl=8.0)
        jrec = await (await JAgg(c1, ns, 0xa1, l1).start()).tick()
        await c1.delete(f"regions/{ns}/a1")
        a1 = await RegionalAggregator(c1, ns, 0xa1, l1, interval=0.2).start()
        rec = await a1.tick()
        assert rec.components == jrec.components
        assert rec.components["backend"]["state"] == merge_state_dumps(
            [m for _, m in flat])
        # a second aggregator splits the fleet: the regions partition it
        a2 = await RegionalAggregator(c2, ns, 0xa2, l2, interval=0.2).start()
        await asyncio.sleep(0.05)     # a1's record reaches a2's watch
        await a2.tick()
        await asyncio.sleep(0.05)
        await a1.tick()
        read = await fetch_region_states(pub, ns)
        assert read.meta["aggregators"] == 2
        assert sorted(read.ids["backend"]) == list(range(1, 9))
        assert set(read.fpm["backend"]) == set(range(1, 9))
        assert sum(r["workers"] for r in read.meta["regions"]) == 8
        states, regional = await fetch_stage_states_ex(pub, ns)
        assert regional is not None
        assert merge_state_dumps([m for _, m in states]) == \
            merge_state_dumps([m for _, m in flat])
        # an excluding read (the frontend's own /metrics) stays flat
        assert (await fetch_stage_states_ex(pub, ns, exclude_worker=1))[1] \
            is None
        # region death: a2 re-absorbs the orphans on its next tick
        await c1.lease_revoke(l1)
        await asyncio.sleep(0.05)
        await a2.tick()
        read = await fetch_region_states(pub, ns)
        assert read.meta["aggregators"] == 1
        assert sorted(read.ids["backend"]) == list(range(1, 9))
        # staleness: past the all-wedged backstop window readers fall back
        assert await fetch_region_states(pub, ns, stale_s=0.5,
                                         now=time.time() + 10) is not None
        assert await fetch_region_states(pub, ns, stale_s=0.5,
                                         now=time.time() + 120) is None
        later = time.time() + 120
        monkeypatch.setattr(time, "time", lambda: later)
        assert len(await fetch_stage_states(pub, ns)) == 8     # flat again
    finally:
        for c in clients:
            await c.close()
        for s in servers:
            await s.stop()


# ---------------------------------------------------------------------------
# queue-until-boot
# ---------------------------------------------------------------------------

async def test_queue_until_boot(monkeypatch):
    from dynamo_tpu_torch.llm.http_service import (HttpService, ModelManager,
                                                   ServedModel)
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.pipeline import build_completion_engine
    from dynamo_tpu_torch.utils.prometheus import stage_metrics

    monkeypatch.setenv("DYN_TOKEN_ECHO_DELAY_MS", "0")
    manager = ModelManager()
    svc = HttpService(manager, host="127.0.0.1", port=0)
    svc.known_models = lambda: {"booting-model"}
    port = await svc.start()
    card = ModelDeploymentCard.synthetic("booting-model")
    body = {"model": "booting-model", "prompt": "hi", "max_tokens": 4}
    qub = stage_metrics().queue_until_boot
    n0 = {k: qub.get("booting-model", k)
          for k in ("parked", "served", "expired", "overflow")}

    def post(payload, headers=None):
        rq = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/completions",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json", **(headers or {})})
        try:
            with urllib.request.urlopen(rq, timeout=30) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def delta(k):
        return qub.get("booting-model", k) - n0[k]

    try:
        # off by default: immediate 404, nothing parked
        assert (await asyncio.to_thread(post, body))[0] == 404
        assert delta("parked") == 0
        monkeypatch.setenv("DYN_BOOT_WAIT", "5")

        async def boot_later():
            await asyncio.sleep(0.3)
            manager.add(ServedModel(card, completion_engine=(
                build_completion_engine(card, "echo_core"))))

        boot = asyncio.ensure_future(boot_later())
        st, out = await asyncio.to_thread(post, body)
        await boot
        assert st == 200, out
        assert (delta("parked"), delta("served")) == (1, 1)
        # expiry: a model that never boots gets the typed 503 when the
        # request's deadline ends the park
        manager.remove("booting-model")
        st, out = await asyncio.to_thread(post, body,
                                          {"x-request-timeout": "0.4"})
        assert st == 503
        assert (out["error"]["reason"], out["error"]["stage"]) == \
            ("booting", "ingress")
        assert delta("expired") == 1
        # overflow: park queue full -> immediate typed 503
        monkeypatch.setenv("DYN_BOOT_WAIT_QUEUE", "0")
        st, out = await asyncio.to_thread(post, body)
        assert (st, out["error"]["reason"]) == (503, "boot_queue_full")
        assert delta("overflow") == 1
        # unregistered models keep the plain immediate 404
        assert (await asyncio.to_thread(
            post, {**body, "model": "nope"}))[0] == 404
    finally:
        await svc.stop()
