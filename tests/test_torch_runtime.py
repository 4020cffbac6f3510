"""The port's distributed runtime against the JAX package's, each way round.

The port's store client talks to the JAX store server and the JAX client to
the port's server: KV, leases and their expiry, prefix watches, pub/sub,
work queues with ack and requeue, and reconnect with session replay. Then
the keyspace classifier, the circuit breaker, the data plane (typed error
frames, Stop/Kill) across packages, and the worker shell's drain.
"""

import asyncio
import contextlib
import importlib
import time

import pytest

PKGS = ("dynamo_tpu", "dynamo_tpu_torch")
# (server package, client package): each way round
WAYS = [("dynamo_tpu", "dynamo_tpu_torch"), ("dynamo_tpu_torch", "dynamo_tpu")]
WAY_IDS = ["jax-store/torch-client", "torch-store/jax-client"]


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


class Store:
    """A store server of either package that can die (connections reset,
    state lost) and come back empty on the same port. ``pkg+native`` is
    that package's C++ dynstore, else its asyncio server."""

    def __init__(self, pkg):
        pkg, _, impl = pkg.partition("+")
        mod = _mod(pkg, "runtime.store_server")
        self.cls = mod.NativeStoreServer if impl == "native" \
            else mod.PyStoreServer
        self.server = None
        self.port = None

    async def start(self) -> int:
        self.server = self.cls(port=self.port or 0)
        self.port = await self.server.start()
        return self.port

    async def stop(self) -> None:
        await self.server.stop()

    async def restart(self, down_for: float = 0.05) -> None:
        await self.stop()
        await asyncio.sleep(down_for)
        await self.start()


def _client(pkg, port, reconnect=True):
    sc = _mod(pkg, "runtime.store_client")
    cfg = sc.ReconnectConfig(enabled=reconnect, attempts=40, base=0.02,
                             max_delay=0.1)
    return sc.StoreClient(port=port, reconnect=cfg).connect()


async def until(predicate, timeout: float = 5.0, msg: str = "condition"):
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {msg}")
        await asyncio.sleep(0.02)


@contextlib.asynccontextmanager
async def pair(way):
    srv_pkg, cli_pkg = way
    store = Store(srv_pkg)
    port = await store.start()
    clients = []

    async def make(reconnect=True, pkg=cli_pkg):
        c = await _client(pkg, port, reconnect)
        clients.append(c)
        return c

    try:
        yield store, make
    finally:
        for c in clients:
            await c.close()
        await store.stop()


def run(coro, limit=20.0):
    return asyncio.wait_for(coro, limit)


# ---------------------------------------------------------------------------
# the store protocol, each way round
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("way", WAYS, ids=WAY_IDS)
async def test_store_kv_ops(way):
    async def body():
        async with pair(way) as (_store, make):
            c = await make()
            err = _mod(way[1], "runtime.store_client").StoreError
            await c.put("a/b", b"1")
            assert await c.get("a/b") == b"1"
            assert await c.get("missing") is None
            await c.put("a/c", b"2")
            assert await c.get_prefix("a/") == [("a/b", b"1"), ("a/c", b"2")]
            assert await c.delete("a/b")
            assert not await c.delete("a/b")
            assert await c.create("a/d", b"3")
            with pytest.raises(err):
                await c.create("a/d", b"4")
            assert not await c.create("a/d", b"3", or_validate=True)

    await run(body())


@pytest.mark.parametrize("way", WAYS, ids=WAY_IDS)
async def test_store_leases_and_expiry(way):
    async def body():
        async with pair(way) as (_store, make):
            c1 = await make(reconnect=False)
            c2 = await make()
            lease = await c1.lease_grant(ttl=0.5, auto_keepalive=False)
            await c1.put("w/x", b"v", lease=lease)
            assert await c2.get("w/x") == b"v"
            await asyncio.sleep(1.0)        # no keepalive: the lease expires
            assert await c2.get("w/x") is None
            # a kept-alive lease outlives its ttl; its owner's death
            # expires it at once
            kept = await c1.lease_grant(ttl=0.6)
            await c1.put("w/y", b"v", lease=kept)
            await asyncio.sleep(1.0)
            assert await c2.get("w/y") == b"v"
            await c1.close()
            for _ in range(50):
                if await c2.get("w/y") is None:
                    break
                await asyncio.sleep(0.05)
            assert await c2.get("w/y") is None

    await run(body())


@pytest.mark.parametrize("way", WAYS, ids=WAY_IDS)
async def test_store_prefix_watches(way):
    async def body():
        async with pair(way) as (_store, make):
            c = await make()
            other = await make()
            await other.put("wt/a", b"0")
            events = []

            async def on_event(key, value, deleted):
                events.append((key, value, deleted))

            snap = await c.watch_prefix("wt/", on_event)
            assert snap == [("wt/a", b"0")]
            await other.put("wt/b", b"1")
            await other.put("other/x", b"1")
            await other.delete("wt/a")
            await until(lambda: len(events) >= 2, msg="watch events")
            assert events == [("wt/b", b"1", False), ("wt/a", None, True)]

    await run(body())


@pytest.mark.parametrize("way", WAYS, ids=WAY_IDS)
async def test_store_pubsub(way):
    async def body():
        async with pair(way) as (_store, make):
            sub = await make()
            pub = await make()
            got = []

            async def on_msg(subject, payload):
                got.append((subject, payload))

            await sub.subscribe("ns.backend.kv_events", on_msg)
            await pub.publish("ns.backend.kv_events", b"e1")
            await pub.publish("ns.other", b"no")
            await pub.publish("ns.backend.kv_events", b"e2")
            await until(lambda: len(got) >= 2, msg="pubsub")
            await asyncio.sleep(0.05)
            assert got == [("ns.backend.kv_events", b"e1"),
                           ("ns.backend.kv_events", b"e2")]

    await run(body())


@pytest.mark.parametrize("way", WAYS, ids=WAY_IDS)
async def test_store_queues_ack_and_requeue(way):
    async def body():
        async with pair(way) as (_store, make):
            prod = await make()
            cons = await make(reconnect=False)
            await prod.q_push("jobs", b"j1")
            await prod.q_push("jobs", b"j2")
            mid, payload = await cons.q_pull("jobs")
            assert payload == b"j1"
            await cons.q_ack("jobs", mid)
            mid2, payload2 = await cons.q_pull("jobs")
            assert payload2 == b"j2"
            # the consumer dies with j2 unacked: it goes back to the queue
            await cons.close()
            other = await make()
            _, again = await other.q_pull("jobs")
            assert again == b"j2"

    await run(body())


@pytest.mark.parametrize("way", WAYS, ids=WAY_IDS)
async def test_store_reconnect_replays_the_session(way):
    async def body():
        async with pair(way) as (store, make):
            c = await make()
            lost = asyncio.Event()
            c.on_lease_lost = lambda lease: lost.set()
            lease = await c.lease_grant(ttl=0.6)
            await c.put("rp/reg", b"me", lease=lease)
            outsider = await make(reconnect=False)
            await outsider.put("rw/x", b"1")
            events, msgs = [], []

            async def on_event(key, value, deleted):
                events.append((key, value, deleted))

            async def on_msg(subject, payload):
                msgs.append(payload)

            assert len(await c.watch_prefix("rw/", on_event)) == 1
            await c.subscribe("chan", on_msg)
            pull = asyncio.ensure_future(c.q_pull("work"))
            await asyncio.sleep(0.05)
            # the store dies and comes back empty on the same port
            await store.restart()
            await asyncio.wait_for(c.wait_connected(), 5.0)
            probe = await make(reconnect=False)
            # the lease is re-granted under the same id, its key re-put
            assert await probe.get("rp/reg") == b"me"
            fresh = await probe.lease_grant(ttl=5.0, auto_keepalive=False)
            assert fresh != lease
            # the watch re-armed with a snapshot diff: the outsider's key
            # died with the store, so its delete is synthesized
            await until(lambda: ("rw/x", None, True) in events,
                        msg="synthesized delete")
            await probe.put("rw/z", b"2")
            await until(lambda: ("rw/z", b"2", False) in events,
                        msg="live event after replay")
            await probe.publish("chan", b"hello")
            await until(lambda: msgs == [b"hello"], msg="resubscribed")
            await probe.q_push("work", b"job")
            _, payload = await asyncio.wait_for(pull, 5.0)
            assert payload == b"job"
            await asyncio.sleep(0.8)        # keepalives on the new session
            assert not lost.is_set()
            assert await probe.get("rp/reg") == b"me"

    await run(body(), 30)


@pytest.mark.parametrize("pkg", PKGS)
async def test_store_self_metrics_and_errors_match(pkg, monkeypatch):
    """Both servers publish their own telemetry under the same key and
    answer the same error codes."""
    monkeypatch.setenv("DYN_STORE_METRICS_INTERVAL", "0.1")

    async def body():
        other = PKGS[1 - PKGS.index(pkg)]
        store = Store(pkg)
        port = await store.start()
        c = await _client(other, port)
        try:
            key = _mod(pkg, "runtime.store_server").SELF_STAGE_KEY
            assert key == "metrics_stage/_store/store/0"
            await c.put("m/x", b"1")
            for _ in range(100):
                if await c.get(key):
                    break
                await asyncio.sleep(0.05)
            import json

            doc = json.loads((await c.get(key)).decode())
            assert doc["component"] == "store"
            assert "dyn_store_op_seconds" in doc["metrics"]
            err = _mod(other, "runtime.store_client").StoreError
            with pytest.raises(err) as ei:
                await c.put("m/y", b"1", lease=12345)
            assert ei.value.code == "lease_not_found"
            with pytest.raises(err) as ei:
                await c._call("no_such_op")
            assert "unknown op" in str(ei.value)
        finally:
            await c.close()
            await store.stop()

    await run(body())


# ---------------------------------------------------------------------------
# keyspace, breaker, faults
# ---------------------------------------------------------------------------

def test_keyspace_registry_and_classify_key_equal_jax():
    jk = _mod("dynamo_tpu", "runtime.keyspace")
    tk = _mod("dynamo_tpu_torch", "runtime.keyspace")
    # every field of every family as in JAX (descriptions are prose; the
    # port words one of them differently)
    def fields(ks):
        return {n: {k: v for k, v in f.__dict__.items()
                    if k != "description"} for n, f in ks.KEYSPACE.items()}

    assert fields(tk) == fields(jk)
    keys = ["dynamo/components/backend/generate:1f", "ns.prefill",
            "ns.prefill.batch", "ns.prefill/cancelled/abc", "random/key",
            "", "metrics_stage/_store/store/0"]
    for fam in jk.KEYSPACE.values():
        if fam.prefix:
            keys += [fam.prefix, fam.prefix + "a/b:1f", fam.prefix[:-1]]
    for k in keys:
        assert tk.classify_key(k) == jk.classify_key(k), k
    # every family is reached by some key
    assert {tk.classify_key(k) for k in keys} >= set(tk.KEYSPACE) - {
        f.name for f in tk.KEYSPACE.values()
        if not f.prefix and f.name not in ("endpoints", "prefill-queue",
                                           "prefill-cancel")}


def test_circuit_breaker_states_equal_jax(monkeypatch):
    script = ["f", "f", "s", "f", "f", "f", "t2", "f", "t6", "s", "f",
              "t0.5", "f", "f", "t5", "f", "t10"]
    states = {}
    for pkg in PKGS:
        cb = _mod(pkg, "runtime.circuit_breaker")
        now = [100.0]
        monkeypatch.setattr(cb.time, "monotonic", lambda: now[0])
        b = cb.InstanceBreaker(threshold=3, cooldown=5.0)
        seen = []
        for step in script:
            if step == "f":
                b.record_failure(7)
            elif step == "s":
                b.record_success(7)
            else:
                now[0] += float(step[1:])
            seen.append((b.state(7), b.allow(7), b.filter([7, 8])))
        states[pkg] = seen
    assert states["dynamo_tpu_torch"] == states["dynamo_tpu"]
    assert {s[0] for s in states["dynamo_tpu"]} == {"closed", "open",
                                                    "half_open"}


async def test_faults_fire_and_follow_the_store():
    from dynamo_tpu_torch.utils import faults

    async def body():
        store = Store("dynamo_tpu")
        port = await store.start()
        c = await _client("dynamo_tpu_torch", port)
        try:
            faults.configure("p.refuse:refuse,p.delay:delay:0.01")
            with pytest.raises(ConnectionRefusedError):
                await faults.fire("p.refuse")
            t0 = time.monotonic()
            await faults.fire("p.delay")
            assert time.monotonic() - t0 >= 0.01
            await faults.fire("p.unarmed")
            faults.disarm("p.refuse")
            await faults.fire("p.refuse")
            await faults.watch_store_faults(c)
            await c.put("faults/sd.point", b"drop")
            await until(lambda: faults.is_active("sd.point") is not None,
                        msg="armed via the store")
            with pytest.raises(ConnectionResetError):
                await faults.fire("sd.point")
            await c.delete("faults/sd.point")
            await until(lambda: faults.is_active("sd.point") is None,
                        msg="disarmed via the store")
        finally:
            faults.disarm()
            await c.close()
            await store.stop()

    await run(body())


def test_native_and_sharded_options_raise(monkeypatch):
    """The store and store-client switches resolve as in the JAX package:
    a bad value raises, ``native`` names the C++ dynstore, a shard map
    makes the sharded client and a malformed one raises."""
    from dynamo_tpu_torch.runtime import component, store_server
    from dynamo_tpu_torch.runtime.scale.shards import ShardedStoreClient
    from dynamo_tpu_torch.runtime.store_client import StoreClient

    for impl, cls in (("native", store_server.NativeStoreServer),
                      ("python", store_server.PyStoreServer),
                      ("auto", store_server.PyStoreServer)):
        monkeypatch.setenv("DYNAMO_TPU_STORE", impl)
        assert type(store_server.StoreServer()) is cls
    monkeypatch.setenv("DYNAMO_TPU_STORE", "bogus")
    with pytest.raises(ValueError, match="DYNAMO_TPU_STORE"):
        store_server.StoreServer()
    monkeypatch.delenv("DYNAMO_TPU_STORE")
    monkeypatch.setenv("DYN_STORE_SHARDS", "telemetry=127.0.0.1:1")
    sharded = component.DistributedRuntime().store
    assert isinstance(sharded, ShardedStoreClient)
    assert sharded.shard_names == ["s0", "s1"]
    monkeypatch.setenv("DYN_STORE_SHARDS", "nonsense=127.0.0.1:1")
    with pytest.raises(ValueError, match="unknown family"):
        component.DistributedRuntime()
    monkeypatch.delenv("DYN_STORE_SHARDS")
    assert type(component.DistributedRuntime().store) is StoreClient


async def test_native_dataplane_env_raises_at_serve(monkeypatch, tmp_path):
    """``DYNAMO_TPU_DATAPLANE``: a bad mode raises; with a compiler that
    fails, ``native`` raises with its output and ``auto`` serves on the
    asyncio plane."""
    import shutil

    from dynamo_tpu_torch.native import _build
    from dynamo_tpu_torch.runtime.component import DistributedRuntime

    for f in ("dataplane.cpp", "msgpack.hpp"):
        shutil.copy(_build.SRC / f, tmp_path / f)
    with open(tmp_path / "dataplane.cpp", "a") as f:
        f.write("\nthis is not C++;\n")
    monkeypatch.setattr(_build, "SRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")

    async def serve(mode):
        monkeypatch.setenv("DYNAMO_TPU_DATAPLANE", mode)
        drt = await DistributedRuntime(store_port=port).connect()
        try:
            async def h(request, ctx):
                yield request

            await drt.namespace("n").component("c").endpoint("e").serve(h)
            return drt.dataplane
        finally:
            await drt.close()

    async def body():
        store = Store("dynamo_tpu_torch")
        nonlocal port
        port = await store.start()
        try:
            with pytest.raises(ValueError, match="DYNAMO_TPU_DATAPLANE"):
                await serve("bogus")
            with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
                await serve("native")
            assert await serve("auto") == "python"
            assert await serve("python") == "python"
        finally:
            await store.stop()

    port = None
    await run(body())


# ---------------------------------------------------------------------------
# the data plane across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("way", WAYS, ids=["jax-server/torch-caller",
                                           "torch-server/jax-caller"])
async def test_endpoint_roundtrip_typed_errors_and_stop_kill(way):
    srv_pkg, cli_pkg = way

    async def body():
        store = Store("dynamo_tpu_torch")
        port = await store.start()
        S = _mod(srv_pkg, "runtime.component").DistributedRuntime
        C = _mod(cli_pkg, "runtime.component").DistributedRuntime
        s_ov = _mod(srv_pkg, "utils.overload")
        c_eng = _mod(cli_pkg, "runtime.engine")
        w = await S(store_port=port, advertise_host="127.0.0.1").connect()
        caller = await C(store_port=port).connect()
        stopped, killed = asyncio.Event(), asyncio.Event()
        try:
            async def handler(request, ctx):
                if request.get("shed"):
                    raise s_ov.OverloadError(
                        "queue full", stage="worker_queue",
                        reason="queue_full", retry_after=0.5)
                if request.get("fail"):
                    raise ValueError("boom")
                for i in range(request["n"]):
                    if ctx.is_killed:
                        killed.set()
                        return
                    if ctx.is_stopped:
                        stopped.set()
                        yield {"i": i, "stopped": True}
                        return
                    yield {"i": i}
                    await asyncio.sleep(request.get("pace", 0))

            ep = w.namespace("x").component("c").endpoint("gen")
            await ep.serve(handler)
            client = await caller.namespace("x").component("c") \
                .endpoint("gen").client().start()
            await client.wait_for_instances(1, timeout=5)
            assert [x async for x in client.generate({"n": 3})] == \
                [{"i": 0}, {"i": 1}, {"i": 2}]
            with pytest.raises(c_eng.EngineError) as ei:
                async for _ in client.generate({"shed": 1}):
                    pass
            e = ei.value
            assert (e.code, e.stage, e.reason, e.retry_after) == \
                (429, "worker_queue", "queue_full", 0.5)
            with pytest.raises(c_eng.EngineError) as ei:
                async for _ in client.generate({"fail": 1}):
                    pass
            assert ei.value.code == 500 and "boom" in str(ei.value)
            # Stop: the handler sees it mid-stream and ends cleanly
            ctx = c_eng.Context()
            got = []
            async for item in client.generate({"n": 1000, "pace": 0.01},
                                              ctx):
                got.append(item)
                if len(got) == 3:
                    ctx.stop_generating()
            await asyncio.wait_for(stopped.wait(), 5)
            assert got[-1].get("stopped") and len(got) < 1000
            # Kill: the handler sees it and the stream ends
            ctx = c_eng.Context()
            agen = client.generate({"n": 1000, "pace": 0.01}, ctx)
            await agen.__anext__()
            ctx.kill()
            with contextlib.suppress(Exception):
                async for _ in agen:
                    pass
            await asyncio.wait_for(
                until(lambda: killed.is_set() or stopped.is_set()), 5)
            # a registered endpoint whose handler is gone: a typed 404
            await w.namespace("x").component("c").endpoint("gone").serve(
                handler)
            del w._handlers["gone"]
            bad = await caller.namespace("x").component("c") \
                .endpoint("gone").client().start()
            await bad.wait_for_instances(1, timeout=5)
            with pytest.raises(c_eng.EngineError) as ei:
                async for _ in bad.generate({"n": 1}):
                    pass
            assert ei.value.code == 404
        finally:
            await caller.close()
            await w.close()
            await store.stop()

    await run(body(), 30)


def test_error_control_round_trip_equals_jax():
    from dynamo_tpu.runtime import component as jc
    from dynamo_tpu.utils import overload as jo
    from dynamo_tpu_torch.runtime import component as tc
    from dynamo_tpu_torch.utils import overload as to

    for je, te in ((jo.OverloadError("shed", stage="admission",
                                     reason="brownout_batch",
                                     retry_after=1.5),
                    to.OverloadError("shed", stage="admission",
                                     reason="brownout_batch",
                                     retry_after=1.5)),
                   (ValueError("x"), ValueError("x"))):
        jctl, tctl = jc.error_control(je), tc.error_control(te)
        assert tctl == jctl
        a, b = jc.error_from_control(tctl), tc.error_from_control(jctl)
        for f in ("code", "stage", "reason", "retry_after"):
            assert getattr(a, f, None) == getattr(b, f, None)
        assert str(a) == str(b)


# ---------------------------------------------------------------------------
# the worker shell's drain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_worker_drain_deregisters_first_then_finishes(pkg):
    """SIGTERM's path: the lease is revoked (endpoint key gone) before the
    in-flight stream is disturbed, the stream then completes inside the
    grace window, and the app is cancelled last. Same order in both."""
    Worker = _mod(pkg, "runtime.worker").Worker
    DRT = _mod(pkg, "runtime.component").DistributedRuntime
    events = []

    async def app(token):
        store = Store("dynamo_tpu_torch")
        port = await store.start()
        drt = await DRT(store_port=port, advertise_host="127.0.0.1").connect()
        shell.add_runtime(drt)
        probe = await _client("dynamo_tpu", port)
        release = asyncio.Event()

        async def handler(request, ctx):
            yield {"i": 0}
            await release.wait()
            yield {"i": 1}

        await drt.namespace("dr").component("c").endpoint("gen").serve(
            handler)
        caller = await DRT(store_port=port).connect()
        client = await caller.namespace("dr").component("c") \
            .endpoint("gen").client().start()
        await client.wait_for_instances(1, timeout=5)
        agen = client.generate({})
        assert await agen.__anext__() == {"i": 0}
        try:
            shell._on_signal()                        # SIGTERM
            await until(lambda: drt.draining.is_set())
            for _ in range(100):
                if not await probe.get_prefix("dr/components/"):
                    break
                await asyncio.sleep(0.02)
            events.append(("deregistered",
                           await probe.get_prefix("dr/components/") == []))
            release.set()
            events.append(("finished", await agen.__anext__()))
            await token.wait()
            await asyncio.sleep(3600)
        finally:
            events.append("app-cancelled")
            await caller.close()
            await probe.close()
            await store.stop()

    shell = Worker(grace=5.0)
    t0 = time.monotonic()
    shell.execute(app)
    assert events == [("deregistered", True), ("finished", {"i": 1}),
                      "app-cancelled"]
    assert time.monotonic() - t0 < 5.0


def test_pipeline_nodes_equal_jax():
    jn = _mod("dynamo_tpu", "runtime.pipeline_nodes")
    tn = _mod("dynamo_tpu_torch", "runtime.pipeline_nodes")
    assert [n for n in dir(jn) if not n.startswith("_")] == \
        [n for n in dir(tn) if not n.startswith("_")]
