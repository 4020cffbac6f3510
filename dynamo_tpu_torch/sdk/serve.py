"""Local multi-process orchestrator for @service graphs.

    serve = LocalServe("dynamo_tpu_torch.examples.hello_world:Frontend",
                       config={"Backend": {...}}, platform="cpu")
    serve.start()      # store + one process per service worker, cards
    ...                # granted per service `resources={"gpu": n}`
    serve.stop()

The orchestrator: (1) grants every worker of the graph its cards up front
(a graph that asks for more cards than the host has fails with
:class:`~dynamo_tpu_torch.sdk.allocator.AllocationError` before anything is
spawned), (2) starts a store unless given an existing one
(``dynamo_tpu_torch.runtime.store_server``, which execs the C++ dynstore in
its own process where it builds), (3) spawns each worker as ``python -m
dynamo_tpu_torch.sdk.serve_child`` with the YAML config injected through
the ``DYN_SERVICE_CONFIG`` env JSON and ``CUDA_VISIBLE_DEVICES`` from
:class:`~dynamo_tpu_torch.sdk.allocator.CudaAllocator`, and (4) waits for
every worker's READY line.

The JAX package's ``LocalServe`` with the port's allocator, and three
differences: the cards are granted before the first spawn (JAX grants as it
spawns); a service whose resources name a card count gets ``device`` (the
worker's ``--device``) in its config section unless the config sets one
(``cuda`` on a card grant, ``cpu`` on the CPU platform or a grant of none:
the port's workers take their device from the flag, never from the
environment); and :meth:`LocalServe.stop` gives the children
:data:`STOP_GRACE_S` to drain after SIGTERM, reaps every one, then stops
and reaps the store (JAX: 5 s, and the store is never waited for).

Reference capability: deploy/dynamo/sdk/cli/serving.py:120-251 (circus
watchers per service + GPU allocator + env-injected config).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Type

from .allocator import CudaAllocator
from .serve_child import READY_MARKER, load_class
from .service import SERVICE_CONFIG_ENV, chips_of, collect_graph

#: seconds a child gets between SIGTERM and SIGKILL: a Llama-3-8B worker
#: drains its streams (``DYN_DRAIN_TIMEOUT``, 10 s by default), shuts its
#: engine down and frees its card well inside it
STOP_GRACE_S = 60.0


class LocalServe:
    def __init__(self, entry, config: Optional[Dict[str, Any]] = None,
                 store: Optional[str] = None, platform: str = "cuda",
                 total_chips: int = 4, cwd: Optional[str] = None):
        if platform not in ("cuda", "cpu"):
            raise ValueError(f"platform {platform!r}: cuda or cpu")
        self.entry: Type = load_class(entry) if isinstance(entry, str) else entry
        self.config = dict(config or {})
        self.store = store
        self.platform = platform
        self.total_chips = total_chips
        self.cwd = cwd or os.getcwd()
        self.procs: List[subprocess.Popen] = []
        self._store_proc: Optional[subprocess.Popen] = None

    # ------------------------------------------------------------------
    def _ensure_store(self) -> str:
        if self.store:
            return self.store
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        self._store_proc = subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.runtime.store_server",
             "--host", "127.0.0.1", "--port", str(port)],
            cwd=self.cwd, stdout=subprocess.DEVNULL,
            stderr=subprocess.STDOUT)
        self.store = f"127.0.0.1:{port}"
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if self._store_proc.poll() is not None:
                break
            try:
                socket.create_connection(("127.0.0.1", port), 0.5).close()
                return self.store
            except OSError:
                time.sleep(0.1)
        raise RuntimeError("dynstore failed to start")

    def plan(self) -> List[tuple]:
        """``(class, process env)`` for every worker process of the graph,
        cards granted: raises AllocationError if the graph does not fit."""
        alloc = CudaAllocator(self.total_chips, self.platform)
        out = []
        for cls in collect_graph(self.entry):
            spec = cls._dynamo_spec
            if not (spec.endpoints or spec.on_start or spec.dependencies):
                continue   # pure grouping node (a graph entry like AggGraph)
            section = dict(self.config.get(cls.__name__, {}))
            workers = int(section.get("workers", spec.workers))
            chips = chips_of(section.get("resources", {}))
            if chips is None:
                chips = chips_of(spec.resources)
            for _ in range(workers):
                grant = alloc.allocate(chips or 0, service=spec.name)
                config = self.config
                if chips is not None and "device" not in section:
                    config = {**self.config, cls.__name__: {
                        **section, "device": alloc.device(chips)}}
                env = {**grant, SERVICE_CONFIG_ENV: json.dumps(config)}
                out.append((cls, env))
        return out

    # ------------------------------------------------------------------
    def start(self, timeout: float = 120.0) -> "LocalServe":
        plan = self.plan()
        store = self._ensure_store()
        waiters = []
        try:
            for cls, env in plan:
                p = subprocess.Popen(
                    [sys.executable, "-m", "dynamo_tpu_torch.sdk.serve_child",
                     f"{cls.__module__}:{cls.__name__}", "--store", store],
                    cwd=self.cwd, env={**os.environ, **env},
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
                self.procs.append(p)
                waiters.append((cls._dynamo_spec.name, p))
        except BaseException:
            self.stop()
            raise
        return self._await_ready(waiters, timeout)

    def _await_ready(self, waiters, timeout: float) -> "LocalServe":
        # wait for every worker's READY marker (reader threads keep pipes
        # drained afterwards so children never block on stdout)
        ready = {}
        lock = threading.Lock()

        def pump(name, p):
            for line in p.stdout:
                if READY_MARKER in line:
                    with lock:
                        ready[p] = True
                sys.stderr.write(f"[{name}] {line}")

        for n, p in waiters:
            threading.Thread(target=pump, args=(n, p), daemon=True).start()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with lock:
                if len(ready) == len(waiters):
                    return self
            dead = [p for _, p in waiters if p.poll() is not None]
            if dead:
                self.stop()
                raise RuntimeError(
                    f"{len(dead)} service worker(s) exited during bring-up")
            time.sleep(0.1)
        self.stop()
        raise RuntimeError("serve bring-up timed out")

    def stop(self) -> None:
        """SIGTERM every child, give them :data:`STOP_GRACE_S` together to
        drain and exit, SIGKILL what is left; reap all; then the store."""
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.monotonic() + STOP_GRACE_S
        for p in self.procs:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self.procs.clear()
        if self._store_proc is not None:
            self._store_proc.terminate()
            try:
                self._store_proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self._store_proc.kill()
                self._store_proc.wait()
            self._store_proc = None
