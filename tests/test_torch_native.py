"""The port's native (C++) helpers against the JAX package's.

The data plane: round trip and pooled reuse, the error prologue, stop
mid-stream, streaming request parts and binary data frames, each with the
port's server on its native plane and the port's client, with a JAX client
against the port's native plane, and with the port's client against the
JAX package's native plane; and one request's response frames byte for
byte across the native and asyncio planes of both packages; and the
request envelope (deadline, priority, trace parent) acting alike on the
port's native and asyncio planes. The store:
the port's runtime store suite (tests/test_torch_runtime.py) against the
port's C++ dynstore with either package's client, lease expiry and
disconnect, and a slow subscriber cut off. The C-ABI KV-event publisher:
its events feed the port's ``KvIndexer`` and equal, dict for dict, the
JAX package's C-ABI events for the same calls and the RouterEvent dicts
of the Python protocol. The helpers build once for the module.
"""

import asyncio
import contextlib
import importlib
import json

import pytest

import test_torch_runtime as rt

T, J = "dynamo_tpu_torch", "dynamo_tpu"


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(scope="module", autouse=True)
def native_built():
    from dynamo_tpu_torch.native import _build

    return _build.build_all()


@contextlib.asynccontextmanager
async def plane(server_pkg, client_pkg, handler, monkeypatch):
    """A store, a worker of ``server_pkg`` serving ``handler`` on its
    native data plane, and a started client of ``client_pkg``."""
    store = _mod(T, "runtime.store_server").PyStoreServer()
    port = await store.start()
    worker = caller = None
    try:
        monkeypatch.setenv("DYNAMO_TPU_DATAPLANE", "native")
        worker = await _mod(server_pkg, "runtime.component") \
            .DistributedRuntime(store_port=port,
                                advertise_host="127.0.0.1").connect()
        ep = worker.namespace("ndp").component("c").endpoint("generate")
        await ep.serve(handler)
        assert worker._native_dp is not None and worker._dp_server is None
        caller = await _mod(client_pkg, "runtime.component") \
            .DistributedRuntime(store_port=port).connect()
        cl = await caller.namespace("ndp").component("c") \
            .endpoint("generate").client().start()
        await cl.wait_for_instances(1)
        yield cl
    finally:
        for drt in (caller, worker):
            if drt is not None:
                await drt.close()
        await store.stop()


# (server package on its native plane, client package)
WAYS = [(T, T), (T, J), (J, T)]
WAY_IDS = ["torch-native/torch-client", "torch-native/jax-client",
           "jax-native/torch-client"]


@pytest.mark.parametrize("way", WAYS, ids=WAY_IDS)
async def test_dataplane_roundtrip_and_pooled_reuse(way, monkeypatch):
    async def echo(request, ctx):
        for w in request["text"].split():
            yield {"w": w.upper()}

    async with plane(*way, echo, monkeypatch) as cl:
        out = [x async for x in cl.generate({"text": "a b c"})]
        assert out == [{"w": "A"}, {"w": "B"}, {"w": "C"}]
        # sequential requests reuse the pooled connection against the C++
        # server (frame-boundary reuse semantics)
        pooled = next(iter(cl._pool.values()))[0][2]
        assert [x async for x in cl.generate({"text": "d"})] == [{"w": "D"}]
        assert next(iter(cl._pool.values()))[0][2] is pooled


@pytest.mark.parametrize("way", WAYS, ids=WAY_IDS)
async def test_dataplane_error_prologue(way, monkeypatch):
    async def failing(request, ctx):
        raise _mod(way[0], "runtime.engine").EngineError("nope", 418)
        yield  # pragma: no cover

    async with plane(*way, failing, monkeypatch) as cl:
        err = _mod(way[1], "runtime.engine").EngineError
        with pytest.raises(err, match="nope") as ei:
            async for _ in cl.generate({}):
                pass
        assert ei.value.code == 418


@pytest.mark.parametrize("way", WAYS, ids=WAY_IDS)
async def test_dataplane_stop_mid_stream(way, monkeypatch):
    stopped = asyncio.Event()

    async def endless(request, ctx):
        i = 0
        while not ctx.is_stopped:
            yield {"i": i}
            i += 1
            await asyncio.sleep(0.01)
        stopped.set()

    async with plane(*way, endless, monkeypatch) as cl:
        ctx = _mod(way[1], "runtime.engine").Context()
        got = 0
        async for _ in cl.generate({}, context=ctx):
            got += 1
            if got == 3:
                ctx.stop_generating()
        assert got >= 3
        await asyncio.wait_for(stopped.wait(), 10)


@pytest.mark.parametrize("way", WAYS, ids=WAY_IDS)
async def test_dataplane_streaming_request_parts(way, monkeypatch):
    async def sink(request, ctx):
        total = 0
        async for chunk in request.parts:
            total += len(chunk)
        yield {"meta": request.meta, "bytes": total}

    async with plane(*way, sink, monkeypatch) as cl:
        async def parts():
            yield b"x" * 1000
            yield b"y" * 2345

        out = [x async for x in cl.generate({"name": "blob"}, parts=parts())]
        assert out == [{"meta": {"name": "blob"}, "bytes": 3345}]


@pytest.mark.parametrize("way", WAYS, ids=WAY_IDS)
async def test_dataplane_binary_data_frames(way, monkeypatch):
    async def blobs(request, ctx):
        yield b"\x00\x01\x02"
        yield {"done": True}

    async with plane(*way, blobs, monkeypatch) as cl:
        assert [x async for x in cl.generate({})] == [b"\x00\x01\x02",
                                                     {"done": True}]


async def test_dataplane_frames_byte_for_byte(monkeypatch):
    """One raw request, sent to the native and asyncio planes of both
    packages, gets the same response bytes from each."""
    wire = _mod(T, "runtime.wire")
    request = wire.pack([{wire.KIND_KEY: "request",
                          wire.ENDPOINT_KEY: "generate",
                          wire.CONTEXT_ID_KEY: "bytes-1"},
                         json.dumps({"n": 2}).encode()])

    async def handler(request, ctx):
        for i in range(request["n"]):
            yield {"i": i, "text": "é☃"}
        yield b"\xff\x00raw"

    async def exchange(pkg, mode):
        monkeypatch.setenv("DYNAMO_TPU_DATAPLANE", mode)
        drt = await _mod(pkg, "runtime.component").DistributedRuntime(
            store_port=port, advertise_host="127.0.0.1").connect()
        try:
            await drt.namespace("raw").component("c").endpoint(
                "generate").serve(handler)
            assert (drt._native_dp is not None) == (mode == "native")
            reader, writer = await asyncio.open_connection("127.0.0.1",
                                                           drt.dp_port)
            writer.write(request)
            await writer.drain()
            frames = []
            while True:
                head = await reader.readexactly(4)
                body = await reader.readexactly(int.from_bytes(head, "big"))
                frames.append(head + body)
                control, _ = wire.unpack_two_part(
                    _mod(T, "runtime._msgpack").unpackb(body))
                if control[wire.KIND_KEY] in ("sentinel", "error"):
                    break
            writer.close()
            return frames
        finally:
            await drt.close()

    store = _mod(T, "runtime.store_server").PyStoreServer()
    port = await store.start()
    try:
        got = {(pkg, mode): await exchange(pkg, mode)
               for pkg in (T, J) for mode in ("native", "python")}
    finally:
        await store.stop()
    ref = got[(T, "native")]
    assert len(ref) == 5                 # prologue, 3 data, sentinel
    assert all(frames == ref for frames in got.values())


async def test_dataplane_envelope_deadline_priority_trace(monkeypatch):
    """The request envelope acts the same on both of the port's planes: an
    expired deadline is refused at the worker's ingress (a typed 504,
    counted, the handler never runs); a live deadline and ``batch``
    priority reach the handler's Context; the server span parents under
    the wire trace field, and falls back to trace_id == context id
    without one."""
    import time

    wire = _mod(T, "runtime.wire")
    unpackb = _mod(T, "runtime._msgpack").unpackb
    tracing = _mod(T, "utils.tracing")
    metrics = _mod(T, "utils.prometheus").stage_metrics()
    ran: list = []

    async def handler(request, ctx):
        ran.append(request["tag"])
        span = tracing.current_span_var.get()
        yield {"priority": ctx.priority, "deadline": ctx.deadline,
               "trace_id": span.trace_id}

    deadline = time.time() + 600
    requests = {
        "expired": {wire.DEADLINE_KEY: time.time() - 5},
        "batch": {wire.DEADLINE_KEY: deadline, wire.PRIORITY_KEY: "batch",
                  wire.TRACE_KEY: "parent-span"},
        "bare": {},
    }

    async def outcome(mode):
        monkeypatch.setenv("DYNAMO_TPU_DATAPLANE", mode)
        drt = await _mod(T, "runtime.component").DistributedRuntime(
            store_port=port, advertise_host="127.0.0.1").connect()
        out = {}
        try:
            await drt.namespace("env").component("c").endpoint(
                "generate").serve(handler)
            assert drt.dataplane == mode
            for tag, fields in requests.items():
                cid = f"env-{mode}-{tag}"
                trace_id = cid
                if wire.TRACE_KEY in fields:
                    # a trace of this plane's own, so spans_for reads one
                    trace_id = f"{cid}-trace"
                    fields = dict(fields, **{wire.TRACE_KEY: [
                        trace_id, fields[wire.TRACE_KEY]]})
                reader, writer = await asyncio.open_connection(
                    "127.0.0.1", drt.dp_port)
                writer.write(wire.pack([
                    {wire.KIND_KEY: "request", wire.ENDPOINT_KEY: "generate",
                     wire.CONTEXT_ID_KEY: cid, **fields},
                    json.dumps({"tag": tag}).encode()]))
                await writer.drain()
                frames = []
                while True:
                    head = await reader.readexactly(4)
                    control, payload = wire.unpack_two_part(unpackb(
                        await reader.readexactly(int.from_bytes(head,
                                                                "big"))))
                    if control.get(wire.MESSAGE_KEY):
                        # the message ends with how late the request was
                        control[wire.MESSAGE_KEY] = control[
                            wire.MESSAGE_KEY].split(" (")[0]
                    frames.append([control, payload and json.loads(payload)])
                    if control[wire.KIND_KEY] in ("sentinel", "error"):
                        break
                writer.close()
                spans = [sp for sp in tracing.get_tracer().spans_for(
                    trace_id) if sp.name == "rpc:generate"]
                for _, item in frames:
                    if item:
                        item["trace_id"] = {trace_id: "<trace field>",
                                            cid: "<context id>"}.get(
                            item["trace_id"], item["trace_id"])
                out[tag] = dict(frames=frames, server_span_parents=[
                    sp.parent_id for sp in spans])
        finally:
            await drt.close()
        return out

    store = _mod(T, "runtime.store_server").PyStoreServer()
    port = await store.start()
    stage = "worker_ingress:generate"
    try:
        got = {}
        for mode in ("native", "python"):
            before = metrics.deadline_expiries.get(stage)
            ran.clear()
            got[mode] = await outcome(mode)
            assert metrics.deadline_expiries.get(stage) - before == 1
            assert ran == ["batch", "bare"]
    finally:
        await store.stop()
    assert got["native"] == got["python"]
    env = got["native"]
    (error, _), = env["expired"]["frames"]
    assert error == {wire.KIND_KEY: "error", wire.CODE_KEY: 504,
                     wire.STAGE_KEY: stage, wire.REASON_KEY: "deadline",
                     wire.MESSAGE_KEY: f"request deadline exceeded at stage "
                                       f"{stage!r}"}
    assert env["expired"]["server_span_parents"] == []
    assert env["batch"]["frames"][1][1] == {
        "priority": "batch", "deadline": deadline,
        "trace_id": "<trace field>"}
    assert env["batch"]["server_span_parents"] == ["parent-span"]
    assert env["bare"]["frames"][1][1] == {
        "priority": "interactive", "deadline": None,
        "trace_id": "<context id>"}
    assert env["bare"]["server_span_parents"] == [None]


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

# (lease expiry has its own test below, with the disconnect cases)
STORE_CASES = [rt.test_store_kv_ops,
               rt.test_store_prefix_watches, rt.test_store_pubsub,
               rt.test_store_queues_ack_and_requeue,
               rt.test_store_reconnect_replays_the_session]


@pytest.mark.parametrize("case", STORE_CASES,
                         ids=[c.__name__[len("test_store_"):]
                              for c in STORE_CASES])
@pytest.mark.parametrize("client", [T, J], ids=["torch-client",
                                                "jax-client"])
async def test_runtime_store_suite_on_native_dynstore(case, client):
    """The port's store scenarios, unmodified, against its C++ dynstore."""
    await case((T + "+native", client))


async def _native_store():
    srv = _mod(T, "runtime.store_server").NativeStoreServer()
    return srv, await srv.start()


async def test_native_store_lease_expiry_and_disconnect():
    from dynamo_tpu_torch.runtime.store_client import StoreClient

    srv, port = await _native_store()
    try:
        # TTL expiry deletes lease-bound keys
        c1 = await StoreClient(port=port).connect()
        lease = await c1.lease_grant(ttl=0.5, auto_keepalive=False)
        await c1.put("w/x", b"v", lease=lease)
        c2 = await StoreClient(port=port).connect()
        assert await c2.get("w/x") == b"v"
        await asyncio.sleep(1.0)
        assert await c2.get("w/x") is None

        # connection death expires its leases at once (process death)
        c3 = await StoreClient(port=port).connect()
        lease3 = await c3.lease_grant(ttl=30.0, auto_keepalive=False)
        await c3.put("w/y", b"v3", lease=lease3)
        assert await c2.get("w/y") == b"v3"
        await c3.close()
        await asyncio.sleep(0.3)
        assert await c2.get("w/y") is None

        # ... but an UNBOUND (bind=False) lease survives its grantor and
        # expires only by TTL
        c3b = await StoreClient(port=port).connect()
        orphan = await c3b.lease_grant(ttl=1.0, auto_keepalive=False,
                                       bind=False)
        await c3b.put("w/z", b"vz", lease=orphan)
        await c3b.close()
        await asyncio.sleep(0.3)
        assert await c2.get("w/z") == b"vz"
        await asyncio.sleep(1.0)
        assert await c2.get("w/z") is None

        # an unacked queue message requeues when its consumer dies
        c4 = await StoreClient(port=port).connect()
        await c2.q_push("qq", b"work")
        await c4.q_pull("qq")
        await c4.close()
        mid, payload = await asyncio.wait_for(c2.q_pull("qq"), 2.0)
        assert payload == b"work"
        await c2.q_ack("qq", mid)
        await c1.close()
        await c2.close()
    finally:
        await srv.stop()


async def test_native_store_slow_subscriber_disconnected():
    """A subscriber that never reads is dropped once its write backlog
    passes the server's cap; publishers and healthy subscribers keep
    working throughout."""
    from dynamo_tpu_torch.runtime.store_client import StoreClient
    from dynamo_tpu_torch.runtime.wire import write_frame

    srv, port = await _native_store()
    try:
        sr, sw = await asyncio.open_connection("127.0.0.1", port)
        await write_frame(sw, {"op": "subscribe", "id": 1, "sub_id": 1,
                               "subject": "bench.slow"})
        await sr.readexactly(4)      # the ack's length only; then stop
        healthy = await StoreClient(port=port).connect()
        got = []
        await healthy.subscribe("bench.slow", lambda s, p: got.append(len(p)))
        pub = await StoreClient(port=port).connect()
        payload = b"x" * (256 * 1024)
        for _ in range(128):         # 32 MiB >> the 8 MiB backlog cap
            await pub.publish("bench.slow", payload)

        async def drain_to_eof():
            while await sr.read(1 << 20):
                pass

        await asyncio.wait_for(drain_to_eof(), 30.0)
        for _ in range(200):
            if len(got) >= 128:
                break
            await asyncio.sleep(0.05)
        assert len(got) == 128
        assert await pub.publish("bench.slow", b"tail") >= 1
        await healthy.close()
        await pub.close()
        sw.close()
    finally:
        await srv.stop()


# ---------------------------------------------------------------------------
# the C-ABI KV-event publisher
# ---------------------------------------------------------------------------

async def test_c_abi_publisher_feeds_indexer_and_equals_jax():
    from dynamo_tpu_torch.llm.kv_router.indexer import KvIndexer
    from dynamo_tpu_torch.llm.kv_router.protocols import (KvCacheEvent,
                                                          KvRemovedEvent,
                                                          KvStoredEvent,
                                                          RouterEvent,
                                                          StoredBlock)
    from dynamo_tpu_torch.llm.tokens import compute_seq_hashes
    from dynamo_tpu_torch.runtime.store_client import StoreClient

    srv, port = await _native_store()
    pubs = []
    try:
        c = await StoreClient(port=port).connect()
        received = {T: [], J: []}
        done = asyncio.Event()

        def on(pkg):
            async def on_msg(subject, payload):
                received[pkg].append(json.loads(payload.decode()))
                if all(len(v) >= 3 for v in received.values()):
                    done.set()
            return on_msg

        for pkg in (T, J):
            await c.subscribe(f"{pkg}.worker.kv_events", on(pkg))
        loop = asyncio.get_running_loop()
        for pkg in (T, J):
            cls = _mod(pkg, "llm.kv_router.native").NativeKvPublisher
            pubs.append(await loop.run_in_executor(
                None, cls, "127.0.0.1", port, pkg, "worker", 7))
        tokens = list(range(32))
        h = compute_seq_hashes(tokens, 16)
        for pub in pubs:
            pub.publish_stored([(h[0], 0xABC0_0000_0000_0002)])
            pub.publish_stored([(h[1], 0x2222_0000_0000_0004)],
                               parent_hash=h[0], lora_id=42)
            pub.publish_removed([h[1]])
        await asyncio.wait_for(done.wait(), 5.0)
        assert received[T] == received[J]
        want = [RouterEvent(7, KvCacheEvent(1, stored=KvStoredEvent(
                    [StoredBlock(h[0], 0xABC0_0000_0000_0002)]))),
                RouterEvent(7, KvCacheEvent(2, stored=KvStoredEvent(
                    [StoredBlock(h[1], 0x2222_0000_0000_0004)],
                    parent_hash=h[0], lora_id=42))),
                RouterEvent(7, KvCacheEvent(3, removed=KvRemovedEvent(
                    [h[1]])))]
        assert received[T] == [w.to_dict() for w in want]
        index = KvIndexer(16)
        for d in received[T][:2]:
            index.apply_sync(RouterEvent.from_dict(d))
        assert index.find_matches(h).scores == {7: 2}
        index.apply_sync(RouterEvent.from_dict(received[T][2]))
        assert index.find_matches(h).scores == {7: 1}
        await c.close()
    finally:
        for pub in pubs:
            pub.shutdown()
        await srv.stop()
