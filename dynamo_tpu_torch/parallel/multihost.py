"""One process per rank: the leader serves, the followers replay.

The JAX package runs one controller per host and, across hosts, a leader
that broadcasts a descriptor of every device dispatch to the followers,
which replay it through ``EngineCore.mirror_dispatch`` (its
``parallel/multihost.py``). PyTorch has no single controller at all, so
here that model is *the* mechanism, within one host and across hosts:
every tensor-parallel rank is a process with one device; rank 0 runs the
scheduler and serves the endpoint; every other rank replays the leader's
dispatch frames on its own shard, and the collectives inside the forward
keep the ranks in lockstep. Only the leader registers, streams tokens and
reads results to the host.

A frame is the JAX package's, byte for byte: ``wire.pack([kind, meta,
arrays])`` with each array as ``[dtype, shape, bytes]``. The kinds the JAX
channel has keep its names (``prefill``, ``decode``, ``verify``). The port
adds kinds the JAX channel lacks, since its single controller copies KV
without a frame:

- ``stats``: every rank contributes its counters to a gather the leader
  keeps;
- ``shutdown``: an orderly end (the followers exit 0);
- ``kv_offload`` (``pages``): each rank's d2h of evicted or mirrored pages,
  gathered into whole blocks for the leader's tiers;
- ``kv_restore`` (``pages``): the leader's whole tier blocks scattered,
  each rank uploading its kv heads;
- ``kv_extract`` (``slots``; meta ``layer``): a sequence's KV gathered into
  the leader's whole arrays (disaggregated prefill);
- ``kv_inject`` (``slots``; meta ``l0``, ``layers``): the leader's whole
  layers scattered into each rank's pool (disaggregated decode);
- ``kvpage_prefill`` and ``kvpage_decode`` (the KV paging lane's chunk
  and decode window: tokens, positions, write and hot read slots, each
  layer's cold segment plan ``steps``/``meta``, the sampling rows and
  uniforms; decode meta ``cached``): each rank's segmented forward, the
  leader scattering each rank its kv heads of every staged segment;
- ``swap_prefetch``, ``swap_check`` and ``swap`` (meta ``key``,
  ``params_path``, ``seed``; ``swap`` also ``preset``, ``group_layers``):
  each rank stages its own cut of a sibling model, reports it resident
  (one all-reduce), and overwrites its shard in place.

The KV bytes of ``kv_offload`` to ``kv_inject`` and the paging lane's
segments move through a host collective of the tp group
(``parallel.collectives``), never through the frames. An image wave is
JAX's ``prefill`` frame with ``mm``: its ``ov_vals`` are the soft-token
rows the wave reads (``ov_rows`` indexes them), not a dense buffer.

Failure is the slice's, as in the JAX package: the leader exits 13 when a
follower's socket reads EOF or a send fails (a follower that missed a
dispatch can never rejoin the lockstep), and a follower raises when it
loses the leader. Every wait is bounded by :data:`DIST_TIMEOUT_S`: the
process group's rendezvous and collectives, the follower's connect and
the leader's accept.
"""

from __future__ import annotations

import atexit
import datetime
import logging
import os
import queue
import select
import socket
import struct
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..runtime import _msgpack
from ..runtime.wire import MAX_FRAME, pack as wire_pack

log = logging.getLogger("dynamo_tpu_torch.multihost")

_HDR = struct.Struct(">I")

#: exit code of a leader that lost a follower (the JAX package's)
FOLLOWER_LOST_EXIT = 13

#: seconds the ranks' rendezvous, a collective, the follower's connect and
#: the leader's accept wait at most (an 8B rank's weights init inside it)
DIST_TIMEOUT_S = 300.0


def init_distributed(coordinator: str, world_size: int, rank: int,
                     backend: str = "gloo", timeout: float = DIST_TIMEOUT_S,
                     device=None) -> None:
    """``torch.distributed.init_process_group`` over ``tcp://coordinator``
    (``host:port``; rank 0 listens there). The rendezvous and every later
    collective wait at most ``timeout`` seconds. A CUDA ``device`` becomes
    the process's current device first, and NCCL binds its communicator
    to it."""
    import torch
    import torch.distributed as dist

    kw = {}
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(device)
        if backend == "nccl":
            kw["device_id"] = torch.device(device)
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator}",
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout), **kw)


def free_port(host: str = "127.0.0.1") -> int:
    """A TCP port that was free a moment ago on ``host``."""
    s = socket.socket()
    try:
        s.bind((host, 0))
        return s.getsockname()[1]
    finally:
        s.close()


def _pack_arrays(arrs: Dict[str, np.ndarray]) -> Dict[str, Any]:
    out = {}
    for k, a in arrs.items():
        a = np.ascontiguousarray(a)
        out[k] = [str(a.dtype), list(a.shape), a.tobytes()]
    return out


def _unpack_arrays(d: Dict[str, Any]) -> Dict[str, np.ndarray]:
    out = {}
    for k, (dtype, shape, raw) in d.items():
        # a writable copy: torch.from_numpy shares the array's memory
        out[k] = np.frombuffer(bytearray(raw),
                               dtype=np.dtype(dtype)).reshape(shape)
    return out


def pack_frame(kind: str, meta: Dict[str, Any],
               arrs: Dict[str, np.ndarray]) -> bytes:
    """One dispatch frame as the leader sends it."""
    return wire_pack([kind, meta, _pack_arrays(arrs)])


def _recv_frame(sock: socket.socket) -> Any:
    hdr = _recv_exact(sock, _HDR.size)
    (n,) = _HDR.unpack(hdr)
    if n > MAX_FRAME:
        raise ConnectionError(f"dispatch frame of {n} bytes exceeds "
                              f"MAX_FRAME: corrupt channel")
    return _msgpack.unpackb(_recv_exact(sock, n))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("dispatch channel closed")
        buf += chunk
    return bytes(buf)


def _die() -> None:
    os._exit(FOLLOWER_LOST_EXIT)


class DispatchPublisher:
    """Leader side: accepts the followers' connections, then broadcasts
    every engine dispatch in order.

    :meth:`hook` plugs into ``EngineCore.dispatch_hook`` (engine thread):
    it packs the frame and queues it; a sender thread coalesces whatever
    is queued into one write per follower, so the engine never blocks on a
    socket while the bounded queue still holds a stalled follower within
    ``queue_depth`` dispatches of the leader. ``on_lost`` (default: exit
    13) runs when a follower's socket reads EOF or a send fails, unless
    :meth:`close` began."""

    def __init__(self, port: int, expected_followers: int,
                 queue_depth: int = 8, host: str = "0.0.0.0",
                 on_lost: Optional[Callable[[], None]] = None):
        self.expected = expected_followers
        self.on_lost = on_lost or _die
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(max(1, expected_followers))
        self.port = self._srv.getsockname()[1]
        self._socks: List[socket.socket] = []
        self._lock = threading.Lock()
        self._closing = False
        self.frames = 0
        self._q: "queue.Queue[bytes]" = queue.Queue(maxsize=queue_depth)
        self._sender = threading.Thread(target=self._drain, daemon=True,
                                        name="dispatch-publisher")
        self._sender.start()
        # a follower's death must be seen even while the engine is wedged
        # inside a collective waiting for it (no send ever happens again);
        # followers never write, so a readable socket means EOF or reset
        self._monitor = threading.Thread(target=self._watch_followers,
                                         daemon=True,
                                         name="dispatch-monitor")
        self._monitor.start()

    def wait_for_followers(self, timeout: float = DIST_TIMEOUT_S) -> None:
        deadline = time.monotonic() + timeout
        while len(self._socks) < self.expected:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{len(self._socks)}/{self.expected} followers connected "
                    f"to the dispatch channel within {timeout:.0f} s")
            self._srv.settimeout(left)
            try:
                sock, addr = self._srv.accept()
            except socket.timeout:
                continue
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self._socks.append(sock)
            log.info("follower %s connected (%d/%d)", addr,
                     len(self._socks), self.expected)

    def hook(self, kind: str, meta: Dict[str, Any],
             arrs: Dict[str, np.ndarray]) -> None:
        # packed on the engine thread (the dispatch order), sent on the
        # sender thread (overlapping the leader's own dispatch)
        self._q.put(pack_frame(kind, meta, arrs))
        self.frames += 1

    def flush(self, timeout: float = 30.0) -> None:
        """Wait until every queued frame went out."""
        deadline = time.monotonic() + timeout
        while self._q.unfinished_tasks and time.monotonic() < deadline:
            time.sleep(0.005)

    def _drain(self) -> None:
        while True:
            buf = [self._q.get()]
            while True:
                try:
                    buf.append(self._q.get_nowait())
                except queue.Empty:
                    break
            data = b"".join(buf)          # coalesced: one write a follower
            with self._lock:
                socks = list(self._socks)
            try:
                for sock in socks:
                    sock.sendall(data)
            except OSError:
                if not self._closing:
                    log.critical("dispatch channel to a follower failed; "
                                 "ending the tensor-parallel worker")
                    self.on_lost()
            finally:
                for _ in buf:
                    self._q.task_done()

    def _watch_followers(self) -> None:
        while not self._closing:
            with self._lock:
                socks = list(self._socks)
            if not socks:
                time.sleep(0.2)
                continue
            try:
                readable, _, errored = select.select(socks, [], socks, 0.5)
            except (OSError, ValueError):
                time.sleep(0.2)          # close() raced us
                continue
            if (readable or errored) and not self._closing:
                log.critical("dispatch channel lost (a follower died); "
                             "ending the tensor-parallel worker")
                self.on_lost()
                return

    def close(self) -> None:
        """Orderly teardown: send ``shutdown`` to the followers, then close
        the sockets without treating their EOF as a death."""
        if self._closing:
            return
        # from here a follower's EOF is its orderly exit, not a death
        self._closing = True
        if self._socks:
            self.hook("shutdown", {}, {})
            self.flush()
        with self._lock:
            for s in self._socks:
                s.close()
        self._srv.close()


class FollowerLoop:
    """Follower side: connect to the leader's dispatch channel and replay
    every frame through ``core.mirror_dispatch`` until ``shutdown``."""

    def __init__(self, core, leader_host: str, dispatch_port: int,
                 connect_timeout: float = DIST_TIMEOUT_S):
        self.core = core
        self.frames = 0
        t0 = time.monotonic()
        while True:
            try:
                self._sock = socket.create_connection(
                    (leader_host, dispatch_port), timeout=5)
                break
            except OSError:
                if time.monotonic() - t0 > connect_timeout:
                    raise
                time.sleep(0.2)
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def run(self) -> None:
        try:
            while True:
                kind, meta, packed = _recv_frame(self._sock)
                if kind == "shutdown":
                    log.info("leader shut down after %d dispatches",
                             self.frames)
                    return
                self.core.mirror_dispatch(kind, meta, _unpack_arrays(packed))
                self.frames += 1
        except ConnectionError as e:
            # losing the leader is the slice's failure, not a clean exit
            log.error("dispatch channel lost after %d dispatches: %s",
                      self.frames, e)
            raise
        finally:
            self._sock.close()


class LocalRanks:
    """A host's other ranks as ``cli.worker`` follower processes, reaped
    with the leader: :meth:`close` (or the interpreter's exit) waits for
    them after an orderly shutdown, then terminates, then kills."""

    def __init__(self, procs: Sequence[subprocess.Popen]):
        self.procs = list(procs)
        atexit.register(self.close, 5.0)

    def close(self, timeout: float = 30.0) -> None:
        deadline = time.monotonic() + timeout
        for p in self.procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.terminate()
        for p in self.procs:
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def spawn_local_followers(argv: Sequence[str], local_ranks: Sequence[int],
                          env: Optional[Dict[str, str]] = None
                          ) -> LocalRanks:
    """Start ``python -m dynamo_tpu_torch.cli.worker *argv --local-rank j``
    for each ``j`` of ``local_ranks``. Their output goes to this process's
    standard error."""
    procs = []
    for j in local_ranks:
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.cli.worker", *argv,
             "--local-rank", str(j)],
            env=env, stdin=subprocess.DEVNULL, stdout=2, stderr=2))
    return LocalRanks(procs)


class LeaderPlane:
    """What a leader holds besides its engine: its mesh, the dispatch
    publisher and the host's follower processes. :meth:`attach` waits for
    every follower and hooks the publisher into the core; :meth:`close`
    shuts the followers down in order and leaves the process group."""

    def __init__(self, mesh, publisher: Optional[DispatchPublisher],
                 ranks: Optional[LocalRanks] = None,
                 wait_timeout: float = DIST_TIMEOUT_S):
        self.mesh = mesh
        self.publisher = publisher
        self.ranks = ranks
        self.wait_timeout = wait_timeout

    def attach(self, core) -> None:
        if self.publisher is None:
            return
        self.publisher.wait_for_followers(self.wait_timeout)
        core.dispatch_hook = self.publisher.hook

    def close(self) -> None:
        if self.publisher is not None:
            self.publisher.close()
        if self.ranks is not None:
            self.ranks.close()
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
