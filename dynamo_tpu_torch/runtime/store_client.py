"""Async client for dynstore (KV/lease/watch + pub/sub + queues).

One connection multiplexes everything: request/reply by id, plus pushed
frames routed to watch/subscription/queue callbacks. The API mirrors what the
runtime layers need (component registration, endpoint discovery, KV events,
prefill queue) — the union of the reference's etcd + NATS client surfaces
(lib/runtime/src/transports/{etcd,nats}.rs) behind one handle.

Connection loss is survivable: pending calls fail fast with ``StoreError``
(code ``conn_lost``), then a reconnect loop with exponential backoff
(``DYN_STORE_RECONNECT_*``) re-establishes the **session** — leases are
re-granted under their original ids (the server's ``reuse`` grant), lease-
bound keys (endpoint/model registrations, metrics snapshots) are re-put,
prefix watches re-arm with a snapshot diff that synthesizes the put/delete
events missed during the outage, pub/sub subjects re-subscribe, and blocked
``q_pull`` loops resume. Only when the window is exhausted (or the server
cannot preserve a lease id) does ``on_lease_lost`` fire — the etcd-style
"liveness is truly gone, restart me" signal.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import os
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Dict, List, Optional, Set, Tuple

from ..obs import flightrec as _flightrec
from ..utils import faults
from .wire import FrameReader, write_frame

log = logging.getLogger("dynamo_tpu_torch.store.client")

WatchCallback = Callable[[str, Optional[bytes], bool], Awaitable[None]]
MsgCallback = Callable[[str, bytes], Awaitable[None]]


class StoreError(RuntimeError):
    """Error reply from the store (or transport loss).

    ``code`` is the machine-readable classification ("lease_not_found",
    "conn_lost", or "" for anything else). Branch on it, never on the
    human-readable text — a reworded server message must not silently flip
    terminal-vs-transient handling (ADVICE r4). Servers predating the
    ``code`` wire field get a legacy substring fallback at construction.
    """

    def __init__(self, msg: str, code: str = ""):
        super().__init__(msg)
        if not code:  # prebuilt/old server: classify by the known phrases
            low = msg.lower()
            if "lease not found" in low:
                code = "lease_not_found"
            elif "connection" in low:
                code = "conn_lost"
        self.code = code


def _env_num(name: str, default: float, cast=float):
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return cast(raw)
    except ValueError:
        log.warning("ignoring malformed %s=%r", name, raw)
        return default


@dataclass
class ReconnectConfig:
    """Backoff schedule for store reconnects. ``attempts`` tries, sleeping
    ``base * 2^n`` capped at ``max_delay`` between them (defaults span
    ~8 s — comfortably above a store restart, below a lease TTL deluge)."""

    enabled: bool = True
    attempts: int = 10
    base: float = 0.05
    max_delay: float = 2.0

    @classmethod
    def from_env(cls) -> "ReconnectConfig":
        raw = os.environ.get("DYN_STORE_RECONNECT", "1").strip().lower()
        return cls(
            enabled=raw not in ("0", "false", "no", "off"),
            attempts=_env_num("DYN_STORE_RECONNECT_ATTEMPTS", 10, int),
            base=_env_num("DYN_STORE_RECONNECT_BASE", 0.05),
            max_delay=_env_num("DYN_STORE_RECONNECT_MAX", 2.0))


@dataclass
class _WatchState:
    """Per-watch replay state: the prefix, the last-known key set (updated
    in push order), and — during a replay — the keys real events touched
    since re-arm (so stale snapshot-diff synthetics are skipped)."""

    prefix: str
    known: Dict[str, bytes] = field(default_factory=dict)
    touched: Optional[Set[str]] = None


class StoreClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 4222,
                 reconnect: Optional[ReconnectConfig] = None):
        self.host, self.port = host, port
        self.reconnect = reconnect or ReconnectConfig.from_env()
        self._reader: Optional[FrameReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._ids = itertools.count(1)
        self._pending: Dict[int, asyncio.Future] = {}
        self._watch_cbs: Dict[int, WatchCallback] = {}
        self._watch_state: Dict[int, _WatchState] = {}
        self._sub_cbs: Dict[int, MsgCallback] = {}
        self._sub_subjects: Dict[int, str] = {}
        self._rx_task: Optional[asyncio.Task] = None
        self._push_q: "asyncio.Queue[Dict[str, Any]]" = asyncio.Queue()
        self._push_task: Optional[asyncio.Task] = None
        self._keepalive_tasks: List[asyncio.Task] = []
        self._reconnect_task: Optional[asyncio.Task] = None
        # session state replayed on reconnect
        self._session_leases: Dict[int, float] = {}      # lease -> ttl
        self._lease_puts: Dict[str, Tuple[bytes, int]] = {}
        # fired (sync, on the loop) when a kept-alive lease is discovered
        # UNRECOVERABLY lost — reconnect/replay exhausted or the server
        # couldn't preserve the id; the owner should shut down/restart
        self.on_lease_lost: Optional[Callable[[int], None]] = None
        # fired (sync) after each successful session replay
        self.on_session_replayed: Optional[Callable[[], None]] = None
        self._send_lock = asyncio.Lock()
        self._gen = 0            # connection generation
        self._closing = False    # deliberate close() (or terminal failure)
        self._connected = asyncio.Event()
        self.closed = asyncio.Event()

    # ------------------------------------------------------------------
    async def connect(self) -> "StoreClient":
        await self._open_transport()
        self._push_task = asyncio.create_task(self._push_loop(),
                                              name="store-push")
        self._connected.set()
        return self

    async def _open_transport(self) -> None:
        await faults.fire("store.connect")
        # bounded: a blackholed store must not park the reconnect loop
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(self.host, self.port), 10.0)
        self._reader = FrameReader(reader)
        self._writer = writer
        self._gen += 1
        self._rx_task = asyncio.create_task(self._rx_loop(self._gen),
                                            name=f"store-rx-{self._gen}")

    async def close(self) -> None:
        self._closing = True
        for t in self._keepalive_tasks:
            t.cancel()
        if self._reconnect_task:
            self._reconnect_task.cancel()
        if self._rx_task:
            self._rx_task.cancel()
        if self._push_task:
            self._push_task.cancel()
        if self._writer:
            self._writer.close()
        self._fail_pending()
        self.closed.set()

    # ------------------------------------------------------------------
    def _fail_pending(self, why: str = "connection lost") -> None:
        """Reject every in-flight call NOW — a dead connection must fail
        fast, not hang callers forever (even with reconnect disabled)."""
        pending, self._pending = self._pending, {}
        for fut in pending.values():
            if not fut.done():
                fut.set_exception(StoreError(why, code="conn_lost"))

    def _conn_lost(self, gen: int, why: str) -> None:
        if gen != self._gen:
            return            # stale rx loop of an already-replaced transport
        self._connected.clear()
        self._fail_pending()
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:
                # transport already torn down under us — reconnect (or
                # closed.set below) is the real recovery path either way
                log.debug("writer close failed in _conn_lost",
                          exc_info=True)
        if self._closing or not self.reconnect.enabled:
            self.closed.set()
            return
        log.warning("store connection lost (%s); reconnecting", why)
        _flightrec.note_event("store.conn_lost", why=why)
        if self._reconnect_task is None or self._reconnect_task.done():
            self._reconnect_task = asyncio.create_task(
                self._reconnect_loop(), name="store-reconnect")

    async def _rx_loop(self, gen: int) -> None:
        try:
            while True:
                # unbounded-ok: the rx loop lives exactly as long as the
                # connection; loss paths reject all pending futures below
                msg = await self._reader.read()
                if "push" in msg:
                    # NEVER await user callbacks here: a callback that issues
                    # a store call would deadlock the rx loop (the reply is
                    # read by this very loop). FIFO queue keeps event order.
                    self._push_q.put_nowait(msg)
                else:
                    fut = self._pending.pop(msg.get("id"), None)
                    if fut is not None and not fut.done():
                        fut.set_result(msg)
        except asyncio.CancelledError:
            self._fail_pending()
            self.closed.set()
        except (asyncio.IncompleteReadError, ConnectionResetError,
                OSError) as e:
            self._conn_lost(gen, f"{type(e).__name__}: {e}")
        except Exception as e:  # noqa: BLE001 - ANY rx death must not orphan
            log.exception("store rx loop died")
            self._conn_lost(gen, f"{type(e).__name__}: {e}")

    # ------------------------------------------------------------------
    # reconnect + session re-establishment
    # ------------------------------------------------------------------
    async def wait_connected(self) -> None:
        """Block until the session is (re-)established; raises StoreError
        when the client is closed or the reconnect window is exhausted."""
        while not self._connected.is_set():
            if self.closed.is_set():
                raise StoreError("connection lost (store unreachable)",
                                 code="conn_lost")
            conn = asyncio.ensure_future(self._connected.wait())
            dead = asyncio.ensure_future(self.closed.wait())
            try:
                # unbounded-ok: bounded by the reconnect window — the loop
                # always sets either _connected or closed
                await asyncio.wait({conn, dead},
                                   return_when=asyncio.FIRST_COMPLETED)
            finally:
                conn.cancel()
                dead.cancel()

    async def _reconnect_loop(self) -> None:
        from ..utils.prometheus import stage_metrics

        stage = stage_metrics()
        cfg = self.reconnect
        delay = cfg.base
        try:
            for attempt in range(1, cfg.attempts + 1):
                await asyncio.sleep(delay)
                delay = min(delay * 2, cfg.max_delay)
                stage.store_reconnects.inc("attempt")
                try:
                    await self._open_transport()
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # noqa: BLE001 - ANY failure is one
                    log.info("store reconnect attempt %d/%d failed: %s",
                             attempt, cfg.attempts, e)   # more attempt, not
                    continue                             # a dead loop
                try:
                    await self._replay_session()
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # noqa: BLE001 - e.g. a malformed
                    # server reply must burn an attempt, never kill the loop
                    log.warning("session replay failed (attempt %d/%d): %s",
                                attempt, cfg.attempts, e)
                    if self._writer is not None:
                        self._writer.close()
                    continue
                stage.store_reconnects.inc("ok")
                log.info("store session re-established (attempt %d)",
                         attempt)
                _flightrec.note_event("store.reconnected", attempt=attempt)
                self._connected.set()
                if self.on_session_replayed is not None:
                    try:
                        self.on_session_replayed()
                    except Exception:
                        log.exception("on_session_replayed callback")
                return
            stage.store_reconnects.inc("fail")
            log.error("store reconnect window exhausted (%d attempts); "
                      "session is dead", cfg.attempts)
        finally:
            # whatever path exits this task — exhaustion, cancellation, a
            # bug — it must NEVER leave waiters parked between states:
            # either the session is up or the client is terminally closed
            if not self._connected.is_set() and not self.closed.is_set():
                self._closing = True
                self.closed.set()   # wakes wait_connected()/q_pull loops

    async def _replay_session(self) -> None:
        """Re-establish session state on a fresh transport: leases first
        (identity), then their keys, then watches (+ missed-event diff),
        then pub/sub. Runs before ``_connected`` is set."""
        from ..utils.prometheus import stage_metrics

        stage = stage_metrics()
        # 1. leases: re-grant under the ORIGINAL id so worker identity
        # (worker_id == lease, endpoint key suffixes) survives
        for lid, ttl in list(self._session_leases.items()):
            r = await self._call("lease_grant", ttl=ttl, reuse=lid,
                                 _replay=True)
            if r["lease"] != lid:
                # server couldn't preserve the id (e.g. native store without
                # reuse support): this lease's identity is gone for good
                try:
                    await self._call("lease_revoke", lease=r["lease"],
                                     _replay=True)
                except StoreError:
                    pass
                self._session_leases.pop(lid, None)
                for key in [k for k, (_, lse) in self._lease_puts.items()
                            if lse == lid]:
                    self._lease_puts.pop(key, None)
                self._fire_lease_lost(
                    lid, "lease id could not be re-granted on reconnect")
                continue
            stage.lease_regrants.inc()
        # 2. lease-bound keys (registrations/metrics): the store may have
        # restarted empty, or expired them during the outage — re-put
        for key, (value, lease) in list(self._lease_puts.items()):
            if lease in self._session_leases:
                await self._call("put", key=key, value=value, lease=lease,
                                 _replay=True)
                stage.session_replays.inc("put")
        # 3. watches: re-arm under the same watch_id, then diff the fresh
        # snapshot against the last-known state so deletes (and puts) that
        # happened during the outage are synthesized for the callback
        for wid, ws in list(self._watch_state.items()):
            ws.touched = set()
            r = await self._call("watch", watch_id=wid, prefix=ws.prefix,
                                 _replay=True)
            snapshot = {k: v for k, v in r["items"]}
            for key in ws.known:
                if key not in snapshot:
                    self._push_q.put_nowait(
                        {"push": "watch", "watch_id": wid, "key": key,
                         "value": None, "deleted": True, "synthetic": True})
            for key, value in snapshot.items():
                if ws.known.get(key) != value:
                    self._push_q.put_nowait(
                        {"push": "watch", "watch_id": wid, "key": key,
                         "value": value, "deleted": False,
                         "synthetic": True})
            self._push_q.put_nowait({"push": "_watch_replay_done",
                                     "watch_id": wid})
            stage.session_replays.inc("watch")
        # 4. pub/sub subjects
        for sid, subject in list(self._sub_subjects.items()):
            await self._call("subscribe", sub_id=sid, subject=subject,
                             _replay=True)
            stage.session_replays.inc("subscribe")
        # q_pull loops resume themselves via wait_connected()

    # ------------------------------------------------------------------
    async def _push_loop(self) -> None:
        try:
            while True:
                await self._handle_push(await self._push_q.get())
        except asyncio.CancelledError:
            pass

    async def _handle_push(self, msg: Dict[str, Any]) -> None:
        kind = msg["push"]
        try:
            if kind == "watch":
                wid = msg["watch_id"]
                key, value = msg["key"], msg.get("value")
                deleted = msg["deleted"]
                ws = self._watch_state.get(wid)
                if ws is not None:
                    if msg.get("synthetic"):
                        # skip synthetics superseded by a real event that
                        # arrived since the re-arm (ordering race), and
                        # no-op diffs
                        if ws.touched is not None and key in ws.touched:
                            return
                        if deleted and key not in ws.known:
                            return
                        if not deleted and ws.known.get(key) == value:
                            return
                    elif ws.touched is not None:
                        ws.touched.add(key)
                    if deleted:
                        ws.known.pop(key, None)
                    else:
                        ws.known[key] = value
                cb = self._watch_cbs.get(wid)
                if cb:
                    await cb(key, value, deleted)
            elif kind == "_watch_replay_done":
                ws = self._watch_state.get(msg["watch_id"])
                if ws is not None:
                    ws.touched = None
            elif kind == "msg":
                cb = self._sub_cbs.get(msg["sub_id"])
                if cb:
                    await cb(msg["subject"], msg["payload"])
        except Exception:
            log.exception("push handler failed")

    async def _call(self, op: str, _replay: bool = False, **kw
                    ) -> Dict[str, Any]:
        try:
            await faults.fire("store.call")
        except (ConnectionError, RuntimeError) as e:
            # injected faults surface EXACTLY like real transport loss at
            # this layer — callers are contracted to see StoreError only
            raise StoreError(f"connection lost: {e}",
                             code="conn_lost") from e
        if self._writer is None or self._writer.is_closing() or (
                not self._connected.is_set() and not _replay):
            # fail fast — callers that prefer to block ride
            # wait_connected(); hanging forever is never an option
            raise StoreError("connection lost (store disconnected)",
                             code="conn_lost")
        rid = next(self._ids)
        fut = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        try:
            async with self._send_lock:
                # unbounded-ok: drain stalls only on TCP backpressure from
                # the store; bounded by the connection's own lifetime
                # dynalint: ok(await-holding-lock) the send lock EXISTS to
                # serialize request frames on the one store socket; a stall
                # is TCP backpressure from the store, and connection loss
                # rejects every waiter via _fail_pending
                await write_frame(self._writer, {"op": op, "id": rid, **kw})
        except (ConnectionResetError, BrokenPipeError, OSError) as e:
            self._pending.pop(rid, None)
            raise StoreError(f"connection lost: {e}",
                             code="conn_lost") from e
        reply = await fut
        if not reply.get("ok", False):
            raise StoreError(reply.get("error", "store error"),
                             code=reply.get("code", ""))
        return reply

    # -- KV -------------------------------------------------------------
    async def put(self, key: str, value: bytes,
                  lease: Optional[int] = None) -> None:
        await self._call("put", key=key, value=value, lease=lease)
        if lease is not None and lease in self._session_leases:
            # lease-bound state is liveness state: remember it for replay
            self._lease_puts[key] = (value, lease)

    async def create(self, key: str, value: bytes,
                     lease: Optional[int] = None,
                     or_validate: bool = False) -> bool:
        r = await self._call("create", key=key, value=value, lease=lease,
                             or_validate=or_validate)
        return r.get("created", True)

    async def get(self, key: str) -> Optional[bytes]:
        r = await self._call("get", key=key)
        return r["value"] if r["found"] else None

    async def get_prefix(self, prefix: str) -> List[Tuple[str, bytes]]:
        r = await self._call("get_prefix", prefix=prefix)
        return [(k, v) for k, v in r["items"]]

    async def delete(self, key: str) -> bool:
        r = await self._call("delete", key=key)
        self._lease_puts.pop(key, None)
        return r["deleted"]

    # -- leases ----------------------------------------------------------
    async def lease_grant(self, ttl: float = 5.0,
                          auto_keepalive: bool = True,
                          reuse: Optional[int] = None,
                          bind: bool = True) -> int:
        """Grant a lease; ``reuse`` asks the server for a SPECIFIC id —
        how a sharded store mirrors one session lease onto every shard
        (and how session replay preserves identity). A server that
        cannot honor it returns its own id; the caller must check.
        ``bind=False`` grants an orphan lease that survives this
        connection's death and expires only by TTL — for keys that must
        outlive their producer (incident bundles, trace spans)."""
        kw = {"ttl": ttl}
        if reuse is not None:
            kw["reuse"] = int(reuse)
        if not bind:
            kw["bind"] = False
        r = await self._call("lease_grant", **kw)
        lease = r["lease"]
        if auto_keepalive:
            # kept-alive leases are SESSION leases: re-granted (same id)
            # and re-keyed by the replay after a reconnect
            self._session_leases[lease] = ttl
            self._keepalive_tasks.append(asyncio.create_task(
                self._keepalive_loop(lease, ttl), name=f"lease-{lease}"))
        return lease

    def _fire_lease_lost(self, lease: int, why: str) -> None:
        # liveness is gone: registrations expire(d) server-side, so a
        # worker that kept serving would be an unroutable zombie. Mirror
        # the reference (etcd.rs:55-76 — lease loss cancels the worker's
        # token): notify so the shell can shut down for a clean restart.
        log.warning("lease %x lost (%s); keepalive stopping", lease, why)
        _flightrec.note_event("store.lease_lost", lease=f"{lease:x}",
                              why=why)
        self._session_leases.pop(lease, None)
        if self.on_lease_lost is not None:
            try:
                self.on_lease_lost(lease)
            except Exception:
                log.exception("on_lease_lost callback")

    async def _await_session(self, lease: int) -> bool:
        """Keepalive helper: block for the reconnect+replay to finish.
        True => the lease survived (continue keepalives); False => it is
        lost (and lease_lost has fired)."""
        try:
            await self.wait_connected()
        except StoreError:
            if lease in self._session_leases:
                self._fire_lease_lost(
                    lease, "store unreachable (reconnect exhausted)")
            return False
        # replay fired lease_lost itself if the id couldn't be preserved
        return lease in self._session_leases

    async def _keepalive_loop(self, lease: int, ttl: float) -> None:
        try:
            while True:
                await asyncio.sleep(ttl / 3)
                try:
                    # bounded reply wait: a STALLED-but-open connection
                    # (SIGSTOP'd store, blackholed traffic — no EOF, no
                    # RST) must read as a loss before the lease silently
                    # expires server-side. Dropping the transport routes
                    # recovery through the normal reconnect path.
                    try:
                        await asyncio.wait_for(
                            self._call("lease_keepalive", lease=lease),
                            ttl)
                    except asyncio.TimeoutError:
                        log.warning("lease %x keepalive stalled >%.1fs; "
                                    "dropping store connection", lease, ttl)
                        if self._writer is not None:
                            self._writer.close()   # rx loop => _conn_lost
                        raise StoreError("keepalive stalled",
                                         code="conn_lost") from None
                except StoreError as e:
                    recoverable = (self.reconnect.enabled
                                   and not self._closing)
                    if e.code == "lease_not_found":
                        if lease not in self._session_leases:
                            # deliberately revoked between beats (drain /
                            # swap identity handoff) — not a loss
                            return
                        if recoverable and not self._connected.is_set():
                            # replay in flight: the re-grant hasn't landed
                            if not await self._await_session(lease):
                                return
                            continue
                        # expired server-side (e.g. after loop starvation)
                        self._fire_lease_lost(lease, str(e))
                        return
                    if e.code == "conn_lost":
                        if recoverable:
                            # reconnect+replay preserves the lease id; only
                            # an exhausted window is a true loss
                            if not await self._await_session(lease):
                                return
                            continue
                        self._fire_lease_lost(lease, str(e))
                        return
                    # other server hiccup (version skew, transient): the
                    # lease may still be alive — keep trying rather than
                    # orphaning a healthy lease
                    log.debug("lease %x keepalive error (retrying): %s",
                              lease, e)
                except (ConnectionError, OSError,
                        asyncio.IncompleteReadError) as e:
                    # transport died mid-call — same terminal state
                    self._fire_lease_lost(lease, f"{type(e).__name__}: {e}")
                    return
        except asyncio.CancelledError:
            pass

    async def lease_revoke(self, lease: int) -> None:
        self._session_leases.pop(lease, None)
        # a deliberate revoke must also stop the lease's keepalive loop:
        # an orphaned beat would see lease_not_found on a healthy
        # connection and fire on_lease_lost — fatal to a process that
        # revoked one identity to adopt another (model-mobility swap)
        for t in self._keepalive_tasks:
            if t.get_name() == f"lease-{lease}":
                t.cancel()
        self._keepalive_tasks = [t for t in self._keepalive_tasks
                                 if not t.done()
                                 and t.get_name() != f"lease-{lease}"]
        for key in [k for k, (_, lse) in self._lease_puts.items()
                    if lse == lease]:
            self._lease_puts.pop(key, None)
        await self._call("lease_revoke", lease=lease)

    # -- watches ---------------------------------------------------------
    async def watch_prefix(self, prefix: str, callback: WatchCallback
                           ) -> List[Tuple[str, bytes]]:
        """Start watching; returns the current snapshot; callback fires on
        every subsequent put/delete under the prefix. The watch survives
        reconnects: it re-arms and synthesizes events missed meanwhile."""
        wid = next(self._ids)
        self._watch_cbs[wid] = callback
        ws = _WatchState(prefix)
        ws.touched = set()      # events racing registration beat the merge
        self._watch_state[wid] = ws
        r = await self._call("watch", watch_id=wid, prefix=prefix)
        for k, v in r["items"]:
            if k not in ws.touched:
                ws.known[k] = v
        ws.touched = None
        return [(k, v) for k, v in r["items"]]

    # -- pub/sub ---------------------------------------------------------
    async def subscribe(self, subject: str, callback: MsgCallback) -> int:
        sid = next(self._ids)
        self._sub_cbs[sid] = callback
        self._sub_subjects[sid] = subject
        await self._call("subscribe", sub_id=sid, subject=subject)
        return sid

    async def publish(self, subject: str, payload: bytes) -> int:
        r = await self._call("publish", subject=subject, payload=payload)
        return r["delivered"]

    # -- queues -----------------------------------------------------------
    async def q_push(self, queue: str, payload: bytes) -> int:
        r = await self._call("q_push", queue=queue, payload=payload)
        return r["msg_id"]

    async def q_pull(self, queue: str) -> Tuple[int, bytes]:
        """Blocks until a message is available; must q_ack when done. The
        pull survives reconnects: a parked pull rejected by connection loss
        re-issues itself once the session is re-established (the old
        server-side waiter requeued any unacked message — at-least-once)."""
        while True:
            try:
                r = await self._call("q_pull", queue=queue)
                return r["msg_id"], r["payload"]
            except StoreError as e:
                if (e.code != "conn_lost" or not self.reconnect.enabled
                        or self._closing):
                    raise
                await self.wait_connected()

    async def q_ack(self, queue: str, msg_id: int) -> None:
        await self._call("q_ack", queue=queue, msg_id=msg_id)

    async def q_len(self, queue: str) -> int:
        return (await self._call("q_len", queue=queue))["len"]

    async def ping(self) -> bool:
        return (await self._call("ping")).get("pong", False)
