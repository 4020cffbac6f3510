"""dynstore — the coordination plane in one service.

Provides, over one TCP protocol (wire.py frames):

- **KV with leases + prefix watches** (the etcd role): put/get/get_prefix/
  create/delete; leases with TTL + keepalive; keys bound to a lease vanish
  when it expires; watchers get pushed put/delete events.
- **Pub/sub** (the NATS core role): subject-based fanout.
- **Work queues** (the JetStream role): push/pull-with-ack; unacked messages
  return to the queue when their consumer's connection dies.

Single asyncio process, all state in memory owned by one task group — the
discovery/config/event/queue planes of SURVEY §1/L0 collapsed into one
deployable binary.

Two implementations share this wire protocol:
- this Python server (the reference implementation and test fixture), and
- the C++ server (``dynamo_tpu_torch/native/dynstore.cpp``, epoll event
  loop), spawned by :class:`NativeStoreServer`.
``StoreServer(...)`` builds the one ``DYNAMO_TPU_STORE`` names: ``native``
the C++ server, ``auto`` (the default) and ``python`` this one. The CLI's
``--impl auto`` prefers the C++ server where ``g++`` builds it.

Ops (client -> server): {op, id, ...} -> reply {id, ok, ...}; pushed
server -> client frames carry {push: "watch"|"msg"|"queue", ...}.
"""

from __future__ import annotations

import asyncio
import collections
import itertools
import json
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Set, Tuple

from ..utils.prometheus import LATENCY_BUCKETS_FAST, Registry
from .keyspace import classify_key
from .wire import FrameReader, write_frame

log = logging.getLogger("dynamo_tpu_torch.store")

DEFAULT_TTL = 5.0

# sentinel: an op handler parked the request; the reply is pushed later
DEFER = object()

#: where the server publishes its own telemetry dump (into its own KV —
#: the one store key no client writes; family ``metrics-store`` in
#: runtime/keyspace.py, fetched by metrics_aggregator.fetch_stage_states)
SELF_STAGE_KEY = "metrics_stage/_store/store/0"


class StoreStats:
    """The store's self-observability registry: per-op latency labeled by
    keyspace *family* (via :func:`~.keyspace.classify_key`, so the series
    vocabulary is drift-gated with the keyspace registry for free), plus
    watch/lease/connection gauges, per-family resident keys/bytes, queue
    depths, and watch fan-out volume. Published on the ordinary
    stage-metrics merge path every ``DYN_STORE_METRICS_INTERVAL`` seconds
    so ``/metrics``, the aggregator and ``dyntop`` see the store like any
    other component."""

    def __init__(self) -> None:
        r = Registry()
        self.registry = r
        self.op_seconds = r.histogram(
            "dyn_store_op_seconds",
            "Store op handler latency by op and keyspace family "
            "(q_pull measures the immediate-dequeue path; parked pulls "
            "are not ops, they are waits)", ("op", "family"),
            buckets=LATENCY_BUCKETS_FAST)
        self.watches = r.gauge(
            "dyn_store_watches", "Registered prefix watches", ())
        self.leases = r.gauge(
            "dyn_store_leases", "Live leases", ())
        self.conns = r.gauge(
            "dyn_store_conns", "Open client connections", ())
        self.keys = r.gauge(
            "dyn_store_keys", "Resident keys by keyspace family",
            ("family",))
        self.bytes = r.gauge(
            "dyn_store_bytes", "Resident value bytes by keyspace family",
            ("family",))
        self.queue_depth = r.gauge(
            "dyn_store_queue_depth",
            "Undelivered work-queue messages by queue family", ("family",))
        self.watch_fanout = r.counter(
            "dyn_store_watch_fanout_total",
            "Watch events pushed to watchers (one put/delete fans out to "
            "every matching watch)", ())
        self.fanout_drops = r.counter(
            "dyn_store_fanout_drops_total",
            "Connections dropped because their push outbox overflowed "
            "(defunct consumer — the fan-out they missed died with them)",
            ())


@dataclass
class _KeyVal:
    value: bytes
    lease: Optional[int] = None
    family: str = "other"


@dataclass
class _Lease:
    id: int
    ttl: float
    expires: float
    keys: Set[str] = field(default_factory=set)
    # owning connection (process liveness binding): when it dies the lease
    # expires immediately — unless a reconnecting client re-adopts the
    # lease id first (session re-establishment)
    owner: Optional["_Conn"] = None


@dataclass
class _QueueMsg:
    id: int
    payload: bytes


class _Conn:
    _ids = itertools.count(1)

    def __init__(self, writer: asyncio.StreamWriter,
                 stats: Optional[StoreStats] = None):
        self.id = next(_Conn._ids)
        self.writer = writer
        self.stats = stats
        self.watches: Dict[int, str] = {}          # watch_id -> prefix
        self.subs: Dict[int, str] = {}             # sub_id -> subject
        self.leases: Set[int] = set()
        self.pulling: Dict[str, List[int]] = {}    # queue -> pending pull ids
        self.unacked: Dict[Tuple[str, int], _QueueMsg] = {}
        self._send_lock = asyncio.Lock()
        # detached push: an ordered per-connection outbox drained by one
        # pump task, so a watcher/subscriber that stops reading its socket
        # blocks only its own pump — never the put/publish that notified it
        self._outbox: "asyncio.Queue[Any]" = asyncio.Queue()
        self._pump_task: Optional[asyncio.Task] = None

    OUTBOX_LIMIT = 4096   # frames; beyond this the consumer is defunct

    async def push(self, obj: Any) -> None:
        async with self._send_lock:
            # dynalint: ok(await-holding-lock) per-connection frame
            # serialization is the lock's purpose; a consumer that stops
            # reading hits the OUTBOX_LIMIT path and is dropped
            await write_frame(self.writer, obj)

    def push_nowait(self, obj: Any) -> None:
        """Enqueue a push frame, preserving per-connection order, without
        awaiting the (possibly stalled) socket."""
        if self._outbox.qsize() >= self.OUTBOX_LIMIT:
            if self.stats is not None:
                self.stats.fanout_drops.inc()
            self.writer.close()   # defunct consumer: drop the connection
            return
        self._outbox.put_nowait(obj)
        if self._pump_task is None or self._pump_task.done():
            self._pump_task = asyncio.get_running_loop().create_task(
                self._pump())

    async def _pump(self) -> None:
        try:
            while not self._outbox.empty():
                obj = self._outbox.get_nowait()
                async with self._send_lock:
                    # dynalint: ok(await-holding-lock) the pump contends
                    # only with reply writes on THIS connection; a stalled
                    # socket blocks its own pump, and the defunct-consumer
                    # limit closes the connection
                    await write_frame(self.writer, obj)
        # dynalint: ok(swallowed-exception) broken pipe: the reader loop
        # reaps the connection, and logging per lost frame would spam on
        # every ordinary client drop
        except Exception:
            pass


class PyStoreServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host, self.port = host, port
        self._kv: Dict[str, _KeyVal] = {}
        self._leases: Dict[int, _Lease] = {}
        # fresh lease ids start at boot wall-clock millis: a RESTARTED
        # store must never hand out an id a pre-restart client still holds
        # in its session — that client's reuse-grant would otherwise adopt
        # the fresh grantee's lease and give it two owners. Monotonic
        # across restarts as long as boots are >1ms apart and a single
        # boot grants fewer leases than milliseconds it was down.
        self._lease_ids = itertools.count(int(time.time() * 1000))
        self._watchers: Dict[int, Tuple[_Conn, int, str]] = {}  # gid -> (conn, wid, prefix)
        self._watch_gids = itertools.count(1)
        self._subs: Dict[str, Dict[int, Tuple[_Conn, int]]] = {}  # subject -> gid -> (conn, sid)
        self._sub_gids = itertools.count(1)
        self._queues: Dict[str, Deque[_QueueMsg]] = {}
        self._queue_waiters: Dict[str, Deque[Tuple[_Conn, int]]] = {}
        self._queue_msg_ids = itertools.count(1)
        self._server: Optional[asyncio.base_events.Server] = None
        self._reaper: Optional[asyncio.Task] = None
        self._conns: set = set()
        # self-observability: per-op latency/family accounting + the
        # periodic dump into our own KV (0 = keep recording, never publish)
        self.stats = StoreStats()
        raw_interval = os.environ.get("DYN_STORE_METRICS_INTERVAL", "")
        try:
            self._stats_interval = float(raw_interval) if raw_interval \
                else 2.0
        except ValueError:
            log.warning("ignoring malformed DYN_STORE_METRICS_INTERVAL=%r",
                        raw_interval)
            self._stats_interval = 2.0
        self._stats_task: Optional[asyncio.Task] = None
        self._fam_keys: Dict[str, int] = {}
        self._fam_bytes: Dict[str, int] = {}
        self._fam_cache: Dict[str, str] = {}   # key -> family (bounded)

    # ------------------------------------------------------------------
    async def start(self) -> int:
        self._server = await asyncio.start_server(self._serve, self.host,
                                                  self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._reaper = asyncio.create_task(self._reap_leases())
        if self._stats_interval > 0:
            self._stats_task = asyncio.create_task(self._publish_stats())
        return self.port

    async def stop(self) -> None:
        if self._stats_task:
            self._stats_task.cancel()
        if self._reaper:
            self._reaper.cancel()
        if self._server:
            self._server.close()
            # force-close live connections: 3.12's wait_closed waits for
            # every handler, and a client that never disconnects (or a test
            # that leaked one) would park shutdown forever
            for conn in list(self._conns):
                try:
                    conn.writer.close()
                # dynalint: ok(swallowed-exception) force-closing leaked
                # client sockets at shutdown; nothing can act on a close()
                # failure and wait_closed() below is the real gate
                except Exception:
                    pass
            await self._server.wait_closed()

    async def _reap_leases(self) -> None:
        while True:
            await asyncio.sleep(0.2)
            now = time.monotonic()
            for lid, lease in list(self._leases.items()):
                if lease.expires < now:
                    await self._expire_lease(lid)

    async def _expire_lease(self, lid: int) -> None:
        lease = self._leases.pop(lid, None)
        if lease is None:
            return
        for key in list(lease.keys):
            if key in self._kv and self._kv[key].lease == lid:
                self._kv_del(key)
                await self._notify_watchers(key, None)

    # -- per-family residency accounting --------------------------------
    def _family(self, key: str) -> str:
        fam = self._fam_cache.get(key)
        if fam is None:
            if len(self._fam_cache) >= 65536:
                self._fam_cache.clear()
            fam = self._fam_cache[key] = classify_key(key)
        return fam

    def _kv_set(self, key: str, value: bytes,
                lease: Optional[int]) -> None:
        old = self._kv.get(key)
        fam = old.family if old is not None else self._family(key)
        if old is None:
            self._fam_keys[fam] = self._fam_keys.get(fam, 0) + 1
        else:
            self._fam_bytes[fam] = self._fam_bytes.get(fam, 0) \
                - len(old.value)
        self._fam_bytes[fam] = self._fam_bytes.get(fam, 0) + len(value)
        self._kv[key] = _KeyVal(value, lease, fam)

    def _kv_del(self, key: str) -> Optional[_KeyVal]:
        kv = self._kv.pop(key, None)
        if kv is not None:
            self._fam_keys[kv.family] = self._fam_keys.get(kv.family, 1) - 1
            self._fam_bytes[kv.family] = self._fam_bytes.get(
                kv.family, len(kv.value)) - len(kv.value)
        return kv

    # ------------------------------------------------------------------
    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        conn = _Conn(writer, self.stats)
        self._conns.add(conn)
        fr = FrameReader(reader)
        try:
            while True:
                # unbounded-ok: server op loop; lives as long as the client
                msg = await fr.read()
                try:
                    reply = await self._dispatch(conn, msg)
                except Exception as e:  # noqa: BLE001 - op failure => error reply
                    reply = {"id": msg.get("id"), "ok": False, "error": str(e)}
                if reply is not None:
                    await conn.push(reply)
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        finally:
            self._conns.discard(conn)
            await self._cleanup(conn)
            writer.close()

    async def _cleanup(self, conn: _Conn) -> None:
        for gid in [g for g, (c, _, _) in self._watchers.items() if c is conn]:
            del self._watchers[gid]
        for subject in list(self._subs):
            self._subs[subject] = {g: v for g, v in self._subs[subject].items()
                                   if v[0] is not conn}
        # a dead consumer's unacked queue messages go back to the queue head
        for (qname, _mid), m in list(conn.unacked.items()):
            self._queues.setdefault(qname, collections.deque()).appendleft(m)
            await self._kick_queue(qname)
        conn.unacked.clear()
        for qname, pulls in conn.pulling.items():
            w = self._queue_waiters.get(qname)
            if w:
                self._queue_waiters[qname] = collections.deque(
                    (c, rid) for c, rid in w if c is not conn)
        # leases owned by this connection expire immediately (process death)
        # — unless a reconnecting client already re-adopted the lease id
        # (half-open TCP: the new connection can land before the old one's
        # EOF is observed; adoption transferred ownership away from us)
        for lid in list(conn.leases):
            lease = self._leases.get(lid)
            if lease is not None and lease.owner is conn:
                await self._expire_lease(lid)

    # ------------------------------------------------------------------
    async def _dispatch(self, conn: _Conn, m: Dict[str, Any]) -> Optional[Dict]:
        op = m["op"]
        rid = m.get("id")
        fn = getattr(self, f"_op_{op}", None)
        if fn is None:
            return {"id": rid, "ok": False, "error": f"unknown op {op!r}"}
        key = m.get("key") or m.get("prefix") or m.get("queue")
        t0 = time.perf_counter()
        out = await fn(conn, m)
        if out is DEFER:
            # a parked pull is a wait, not an op — recording its setup
            # time would drown the real dequeue-path latency
            return None
        self.stats.op_seconds.observe(
            op, self._family(key) if key else "none",
            value=time.perf_counter() - t0)
        if out is None:
            out = {}
        out.setdefault("id", rid)
        out.setdefault("ok", True)
        return out

    # -- KV -------------------------------------------------------------
    async def _op_put(self, conn, m):
        key, value = m["key"], m["value"]
        lease = m.get("lease")
        if lease is not None and lease not in self._leases:
            return {"ok": False, "error": "lease not found",
                    "code": "lease_not_found"}
        self._kv_set(key, value, lease)
        if lease is not None:
            self._leases[lease].keys.add(key)
        await self._notify_watchers(key, value)
        return {}

    async def _op_create(self, conn, m):
        """Create-if-absent (atomic); optionally validate existing value."""
        key = m["key"]
        existing = self._kv.get(key)
        if existing is not None:
            if m.get("or_validate") and existing.value == m["value"]:
                return {"created": False}
            return {"ok": False, "error": "key exists"}
        return await self._op_put(conn, m) or {"created": True}

    async def _op_get(self, conn, m):
        kv = self._kv.get(m["key"])
        return {"value": kv.value if kv else None, "found": kv is not None}

    async def _op_get_prefix(self, conn, m):
        pfx = m["prefix"]
        return {"items": [[k, v.value] for k, v in sorted(self._kv.items())
                          if k.startswith(pfx)]}

    async def _op_delete(self, conn, m):
        key = m["key"]
        kv = self._kv_del(key)
        if kv is not None:
            if kv.lease in self._leases:
                self._leases[kv.lease].keys.discard(key)
            await self._notify_watchers(key, None)
        return {"deleted": kv is not None}

    async def _notify_watchers(self, key: str, value: Optional[bytes]) -> None:
        # detached delivery: the put/delete must not block on any watcher's
        # socket; per-connection order is preserved by the outbox pump
        fanned = 0
        for conn, wid, prefix in list(self._watchers.values()):
            if key.startswith(prefix):
                fanned += 1
                conn.push_nowait({"push": "watch", "watch_id": wid,
                                  "key": key, "value": value,
                                  "deleted": value is None})
        if fanned:
            self.stats.watch_fanout.inc(amount=fanned)

    # -- leases ----------------------------------------------------------
    async def _op_lease_grant(self, conn, m):
        ttl = float(m.get("ttl", DEFAULT_TTL))
        # bind=False grants an ORPHAN lease: no owning connection, expires
        # only by TTL. For data meant to outlive its producer — incident
        # beacons/ring dumps, trace spans (a crashed worker's black box
        # must survive the crash that made it interesting).
        bind = bool(m.get("bind", True))
        reuse = m.get("reuse")
        if reuse is not None:
            # session re-establishment: a reconnecting client re-grants its
            # previous lease ID so identity derived from it (worker_id,
            # endpoint keys) survives a store/connection restart. If the
            # lease still exists (expiry hasn't caught up, or a half-open
            # old connection holds it) the new connection ADOPTS it —
            # etcd-style: leases belong to sessions, not TCP connections.
            lid = int(reuse)
            lease = self._leases.get(lid)
            if lease is not None:
                old = lease.owner
                if old is not None and old is not conn:
                    old.leases.discard(lid)
                lease.owner = conn if bind else None
                lease.ttl = ttl
                lease.expires = time.monotonic() + ttl
                if bind:
                    conn.leases.add(lid)
                return {"lease": lid, "ttl": ttl}
        else:
            lid = next(self._lease_ids)
            # a restarted store's counter restarts too: never collide with
            # ids re-granted by reconnecting clients
            while lid in self._leases:
                lid = next(self._lease_ids)
        self._leases[lid] = _Lease(lid, ttl, time.monotonic() + ttl,
                                   owner=conn if bind else None)
        if bind:
            conn.leases.add(lid)
        return {"lease": lid, "ttl": ttl}

    async def _op_lease_keepalive(self, conn, m):
        lease = self._leases.get(m["lease"])
        if lease is None:
            return {"ok": False, "error": "lease not found",
                    "code": "lease_not_found"}
        lease.expires = time.monotonic() + lease.ttl
        return {}

    async def _op_lease_revoke(self, conn, m):
        await self._expire_lease(m["lease"])
        return {}

    # -- watches ---------------------------------------------------------
    async def _op_watch(self, conn, m):
        """Register a prefix watch; current state is returned inline so the
        caller starts from a consistent snapshot."""
        wid = m["watch_id"]
        prefix = m["prefix"]
        gid = next(self._watch_gids)
        self._watchers[gid] = (conn, wid, prefix)
        conn.watches[wid] = prefix
        items = [[k, v.value] for k, v in sorted(self._kv.items())
                 if k.startswith(prefix)]
        return {"items": items}

    # -- pub/sub ---------------------------------------------------------
    async def _op_subscribe(self, conn, m):
        sid, subject = m["sub_id"], m["subject"]
        gid = next(self._sub_gids)
        self._subs.setdefault(subject, {})[gid] = (conn, sid)
        conn.subs[sid] = subject
        return {}

    async def _op_publish(self, conn, m):
        subject, payload = m["subject"], m["payload"]
        targets = list(self._subs.get(subject, {}).values())
        for c, sid in targets:
            c.push_nowait({"push": "msg", "sub_id": sid,
                           "subject": subject, "payload": payload})
        return {"delivered": len(targets)}

    # -- work queues ------------------------------------------------------
    async def _op_q_push(self, conn, m):
        qname = m["queue"]
        msg = _QueueMsg(next(self._queue_msg_ids), m["payload"])
        self._queues.setdefault(qname, collections.deque()).append(msg)
        await self._kick_queue(qname)
        return {"msg_id": msg.id}

    async def _op_q_pull(self, conn, m):
        """Pull one message; blocks server-side by parking the request until
        a message arrives. Message must be acked or it requeues on disconnect."""
        qname = m["queue"]
        q = self._queues.setdefault(qname, collections.deque())
        if q:
            msg = q.popleft()
            conn.unacked[(qname, msg.id)] = msg
            return {"msg_id": msg.id, "payload": msg.payload}
        self._queue_waiters.setdefault(qname, collections.deque()).append(
            (conn, m.get("id")))
        conn.pulling.setdefault(qname, []).append(m.get("id"))
        return DEFER  # reply pushed by _kick_queue when a message arrives

    async def _op_q_ack(self, conn, m):
        conn.unacked.pop((m["queue"], m["msg_id"]), None)
        return {}

    async def _op_q_len(self, conn, m):
        q = self._queues.get(m["queue"])
        return {"len": len(q) if q else 0}

    async def _kick_queue(self, qname: str) -> None:
        q = self._queues.get(qname)
        waiters = self._queue_waiters.get(qname)
        while q and waiters:
            conn, rid = waiters.popleft()
            if conn.writer.is_closing():
                continue
            msg = q.popleft()
            conn.unacked[(qname, msg.id)] = msg
            try:
                await conn.push({"id": rid, "ok": True, "msg_id": msg.id,
                                 "payload": msg.payload})
            # dynalint: ok(swallowed-exception) the handler IS the
            # recovery: the message is requeued for the next kick and the
            # broken connection is reaped by its own reader loop
            except Exception:
                q.appendleft(msg)
                conn.unacked.pop((qname, msg.id), None)

    # -- misc -------------------------------------------------------------
    async def _op_ping(self, conn, m):
        return {"pong": True}

    # -- self-observability ------------------------------------------------
    def _refresh_gauges(self) -> None:
        s = self.stats
        s.watches.set(value=len(self._watchers))
        s.leases.set(value=len(self._leases))
        s.conns.set(value=len(self._conns))
        for fam, n in self._fam_keys.items():
            s.keys.set(fam, value=n)
            s.bytes.set(fam, value=self._fam_bytes.get(fam, 0))
        depths: Dict[str, int] = {}
        for qname, q in self._queues.items():
            fam = self._family(qname)
            depths[fam] = depths.get(fam, 0) + len(q)
        for fam, d in depths.items():
            s.queue_depth.set(fam, value=d)

    async def _publish_stats(self) -> None:
        """Refresh the self-telemetry dump under :data:`SELF_STAGE_KEY` —
        a direct write into our own KV (with ordinary watch fan-out), so
        the stage-metrics merge path picks the store up like any worker.
        The key dies with the process; a restarted store republishes
        within one interval."""
        while True:
            await asyncio.sleep(self._stats_interval)
            try:
                self._refresh_gauges()
                payload = json.dumps({
                    "component": "store",
                    "metrics": self.stats.registry.state_dump(),
                }).encode()
                self._kv_set(SELF_STAGE_KEY, payload, None)
                await self._notify_watchers(SELF_STAGE_KEY, payload)
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("store self-metrics publish failed")


# ----------------------------------------------------------------------
# native (C++) implementation: same protocol, spawned as a subprocess
# ----------------------------------------------------------------------

STORE_IMPLS = ("auto", "python", "native")


def build_native() -> str:
    """The path of the C++ dynstore binary, compiled first if needed
    (``dynamo_tpu_torch/native/_build.py``). Raises ``RuntimeError`` with
    the compiler's output when it cannot be built."""
    from ..native._build import build

    return str(build("dynstore"))


class NativeStoreServer:
    """Spawns the C++ dynstore — same ``start()/stop()/port`` surface as
    the asyncio server so it drops into every fixture."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host, self.port = host, port
        self._proc: Optional[asyncio.subprocess.Process] = None

    async def start(self) -> int:
        # build off-loop: the first build is a multi-second g++ run and must
        # not stall live coroutines (lease keepalives use sub-second TTLs)
        binary = await asyncio.to_thread(build_native)
        self._proc = await asyncio.create_subprocess_exec(
            binary, "--host", self.host, "--port", str(self.port),
            stdout=asyncio.subprocess.PIPE)
        line = await asyncio.wait_for(self._proc.stdout.readline(), 10.0)
        text = line.decode().strip()  # "dynstore listening on H:P"
        if "listening on" not in text:
            raise RuntimeError(f"native dynstore failed to start: {text!r}")
        self.port = int(text.rsplit(":", 1)[1])
        return self.port

    async def stop(self) -> None:
        if self._proc and self._proc.returncode is None:
            self._proc.terminate()
            try:
                await asyncio.wait_for(self._proc.wait(), 5.0)
            except asyncio.TimeoutError:
                self._proc.kill()
                await self._proc.wait()


def _check_impl(impl: str) -> str:
    if impl not in STORE_IMPLS:
        raise ValueError(f"DYNAMO_TPU_STORE={impl!r} "
                         f"(expected auto|python|native)")
    return impl


def StoreServer(host: str = "127.0.0.1", port: int = 0):
    """The store server ``DYNAMO_TPU_STORE`` names, read at each call:
    ``native`` = :class:`NativeStoreServer`, ``auto`` (the default) and
    ``python`` = :class:`PyStoreServer`."""
    impl = _check_impl(os.environ.get("DYNAMO_TPU_STORE", "auto"))
    cls = NativeStoreServer if impl == "native" else PyStoreServer
    return cls(host, port)


async def main(host: str = "0.0.0.0", port: int = 4222) -> None:
    srv = PyStoreServer(host, port)
    p = await srv.start()
    log.info("dynstore listening on %s:%s", host, p)
    print(f"dynstore listening on {host}:{p}", flush=True)
    while True:
        await asyncio.sleep(3600)


if __name__ == "__main__":
    import argparse

    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(prog="dynstore")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=4222)
    ap.add_argument("--impl", choices=STORE_IMPLS,
                    # argparse validates choices only for CLI-supplied
                    # values: a typo'd env var must not run the wrong store
                    default=_check_impl(os.environ.get("DYNAMO_TPU_STORE",
                                                       "auto")),
                    help="auto = the C++ dynstore when g++ builds it, "
                         "else the asyncio server; native = the C++ "
                         "dynstore (a failed build is an error); python = "
                         "the asyncio server")
    a = ap.parse_args()
    binary = None
    if a.impl == "native":
        binary = build_native()
    elif a.impl == "auto":
        try:
            binary = build_native()
        except RuntimeError:
            log.info("native dynstore unavailable; using asyncio server",
                     exc_info=True)
    if binary is not None:
        # the C++ server takes this process's place, so a signal to it
        # reaches the store itself; it prints the same ready line
        os.execv(binary, [binary, "--host", a.host, "--port", str(a.port)])
    asyncio.run(main(host=a.host, port=a.port))
