"""The deployment operator: reconciles desired state (Deployment resources
in dynstore) into running service workers.

Level-triggered, like a k8s controller: every event (prefix watch) and every
resync tick runs the same ``_reconcile_all`` pass that diffs desired workers
(graph services × replicas) against actual ones and starts/stops the
difference; dead workers are restarted on the next pass, removed resources
are torn down, and observed state is written back to ``deploy/status/``.

Runners abstract "how a worker runs": ``LocalRunner`` spawns per-service
child processes (the same entry the serve orchestrator uses);
``FakeRunner`` records calls for tests. A real-cluster deployment renders
manifests instead (see manifests.py) — the operator there is k8s itself.

The JAX package's ``dynamo_tpu/deploy/operator.py``: the same store keys,
status JSON, conditions and reconcile order (``FakeRunner`` sees the same
``start``/``stop`` calls). The port's :class:`LocalRunner` differs:

- it spawns ``python -m dynamo_tpu_torch.sdk.serve_child`` and grants
  cards through :class:`~dynamo_tpu_torch.sdk.allocator.CudaAllocator`
  (``CUDA_VISIBLE_DEVICES``, and the service's ``device`` config as
  ``sdk.serve.LocalServe`` sets it); the JAX runner shows every chip to
  every replica. A replica that does not fit the cards stays unstarted,
  under a ``WorkersReady=False`` condition that names the cards;
- a worker counts as ready only once it printed ``DYNAMO_SERVICE_READY``
  (JAX: once its process is alive), and every line it prints goes to the
  operator's stderr prefixed with ``[service]``, as ``cli.serve`` does;
- :meth:`LocalRunner.stop` sends SIGTERM and returns: a reaper thread
  gives the worker :data:`~dynamo_tpu_torch.sdk.serve.STOP_GRACE_S` to
  drain, then SIGKILLs it, and its cards return to the pool once it has
  exited (JAX: 5 s waited out on the event loop, which stalls every other
  deployment's reconcile);
- the operator process never touches the card: the graph module is
  imported to learn its services, and nothing there makes a CUDA context.

Reference capability: deploy/dynamo/operator/internal/controller/
dynamodeployment_controller.go (reconcile loop, conditions, child-resource
ownership), scoped to this stack's process model.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
import os
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..runtime.scale.shards import make_store_client
from ..runtime.store_client import StoreClient
from ..sdk.allocator import AllocationError, CudaAllocator
from ..sdk.serve import STOP_GRACE_S
from .crd import (
    DEPLOY_PREFIX,
    Deployment,
    DeploymentStatus,
    ServiceSpec,
    SpecError,
    status_key,
)

log = logging.getLogger("dynamo_tpu_torch.deploy.operator")

WorkerKey = Tuple[str, str, int]        # (dep key, service, replica index)


class Runner:
    """How a single service worker runs. Handles are opaque. ``start`` may
    raise :class:`~dynamo_tpu_torch.sdk.allocator.AllocationError` for a
    replica that does not fit; ``notify`` (set by the operator) may be
    called from any thread when a worker's readiness or liveness changes."""

    notify: Optional[Callable[[], None]] = None

    def start(self, dep: Deployment, service: str, idx: int,
              sspec: ServiceSpec, class_spec: str) -> Any:
        raise NotImplementedError

    def stop(self, handle: Any) -> None:
        raise NotImplementedError

    def alive(self, handle: Any) -> bool:
        raise NotImplementedError

    def ready(self, handle: Any) -> bool:
        return self.alive(handle)

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for every stopped worker to be gone; False on timeout."""
        return True


class _Worker:
    """A :class:`LocalRunner` handle: the process, its card grant, whether
    it printed its READY line, and whether it has exited (and released its
    cards)."""

    def __init__(self, service: str, proc: subprocess.Popen, alloc):
        self.service = service
        self.proc = proc
        self.alloc = alloc
        self.is_ready = False
        self.stopping = False
        self.exited = threading.Event()


class LocalRunner(Runner):
    """Spawns ``python -m dynamo_tpu_torch.sdk.serve_child`` per worker, on
    cards granted from ``total_chips`` (``platform='cuda'``) or on the CPU
    (``platform='cpu'``, or a deployment whose ``platform`` is ``cpu``)."""

    def __init__(self, store: str, platform: str = "cuda",
                 total_chips: int = 4, grace: float = STOP_GRACE_S):
        if platform not in ("cuda", "cpu"):
            raise ValueError(f"platform {platform!r}: cuda or cpu")
        self.store = store
        self.platform = platform
        self.allocator = CudaAllocator(total_chips, platform)
        self.grace = grace
        self._lock = threading.Lock()       # the allocator, across threads
        self._workers: List[_Worker] = []

    def _notify(self) -> None:
        if self.notify is not None:
            self.notify()

    def _cards(self, dep: Deployment, sspec: ServiceSpec) -> int:
        platform = (self.platform if dep.spec.platform == "auto"
                    else dep.spec.platform)
        if platform == "cuda" and self.platform == "cpu" and sspec.gpus:
            raise AllocationError(
                f"deployment {dep.key()} asks for platform cuda; this "
                f"operator grants the CPU only (--platform cpu)")
        return sspec.gpus if platform == "cuda" else 0

    def start(self, dep, service, idx, sspec, class_spec):
        from ..sdk.serve_child import READY_MARKER, load_class
        from ..sdk.service import SERVICE_CONFIG_ENV, chips_of

        n = self._cards(dep, sspec)
        section = dict(sspec.config)
        declared = chips_of(load_class(class_spec)._dynamo_spec.resources)
        if "device" not in section and (sspec.gpus or declared is not None):
            section["device"] = self.allocator.device(n)
        with self._lock:
            alloc = self.allocator.allocate_handle(
                n, service=f"{dep.key()}/{service}")
        env = {**os.environ, **sspec.envs,
               SERVICE_CONFIG_ENV: json.dumps({service: section}
                                              if section else {}),
               **alloc.env}
        try:
            proc = subprocess.Popen(
                [sys.executable, "-m", "dynamo_tpu_torch.sdk.serve_child",
                 class_spec, "--store", dep.spec.store or self.store],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, errors="replace")
        except BaseException:
            with self._lock:
                self.allocator.release(alloc)
            raise
        w = _Worker(service, proc, alloc)
        self._workers.append(w)
        threading.Thread(target=self._pump, args=(w, READY_MARKER),
                         daemon=True, name=f"pump-{service}").start()
        return w

    def _pump(self, w: _Worker, marker: str) -> None:
        """The worker's output into ours, its READY line noted; at its end
        the process is reaped and its cards released."""
        for line in w.proc.stdout:
            if not w.is_ready and marker in line:
                w.is_ready = True
                self._notify()
            sys.stderr.write(f"[{w.service}] {line}")
            sys.stderr.flush()
        w.proc.wait()
        with self._lock:
            self.allocator.release(w.alloc)
        w.exited.set()
        self._notify()

    def _reap(self, w: _Worker) -> None:
        try:
            w.proc.wait(timeout=self.grace)
        except subprocess.TimeoutExpired:
            log.warning("%s worker %d did not drain in %.0f s: SIGKILL",
                        w.service, w.proc.pid, self.grace)
            w.proc.kill()

    def stop(self, handle):
        if handle.stopping:
            return
        handle.stopping = True
        if handle.proc.poll() is None:
            handle.proc.terminate()
        threading.Thread(target=self._reap, args=(handle,), daemon=True,
                         name=f"reap-{handle.service}").start()

    def alive(self, handle):
        return not handle.exited.is_set()

    def ready(self, handle):
        return handle.is_ready and not handle.stopping and self.alive(handle)

    def join(self, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        for w in [w for w in self._workers if w.stopping]:
            left = None if deadline is None else max(
                0.0, deadline - time.monotonic())
            if not w.exited.wait(left):
                return False
        self._workers = [w for w in self._workers if not w.exited.is_set()]
        return True


class FakeRunner(Runner):
    """Test double: every started worker is a dict whose liveness the test
    flips."""

    def __init__(self):
        self.started = []
        self.stopped = []

    def start(self, dep, service, idx, sspec, class_spec):
        h = {"dep": dep.key(), "service": service, "idx": idx,
             "chips": sspec.gpus, "class": class_spec,
             "envs": dict(sspec.envs), "alive": True}
        self.started.append(h)
        return h

    def stop(self, handle):
        handle["alive"] = False
        self.stopped.append(handle)

    def alive(self, handle):
        return handle["alive"]


class Operator:
    def __init__(self, store_host: str = "127.0.0.1", store_port: int = 4222,
                 runner: Optional[Runner] = None,
                 resync_interval: float = 5.0):
        self.store_host = store_host
        self.store_port = store_port
        self.runner = runner or LocalRunner(f"{store_host}:{store_port}")
        self.resync_interval = resync_interval
        self.client: Optional[StoreClient] = None
        self._desired: Dict[str, Deployment] = {}
        self._workers: Dict[WorkerKey, Any] = {}
        self._artifact_dirs: Dict[str, str] = {}   # dep key -> resolved dir
        self._dirty = asyncio.Event()
        self._stop = asyncio.Event()
        self._task: Optional[asyncio.Task] = None

    # ------------------------------------------------------------------
    async def start(self) -> "Operator":
        loop = asyncio.get_running_loop()
        # a worker's READY line or exit starts a pass at once
        self.runner.notify = lambda: loop.call_soon_threadsafe(
            self._dirty.set)
        self.client = await make_store_client(self.store_host,
                                              self.store_port).connect()
        await self.client.watch_prefix(DEPLOY_PREFIX, self._on_event)
        for key, value in await self.client.get_prefix(DEPLOY_PREFIX):
            self._ingest(key, value)
        self._task = asyncio.create_task(self._run())
        self._dirty.set()
        return self

    async def close(self) -> None:
        """Stop the loop, stop every worker and wait (off the event loop)
        until each has drained and exited."""
        self._stop.set()
        self._dirty.set()
        if self._task is not None:
            await self._task
        for handle in self._workers.values():
            self.runner.stop(handle)
        self._workers.clear()
        if not await asyncio.to_thread(self.runner.join, STOP_GRACE_S + 10):
            log.error("workers still running after close")
        self.runner.notify = None
        if self.client is not None:
            await self.client.close()

    # ------------------------------------------------------------------
    def _ingest(self, key: str, value: Optional[bytes]) -> None:
        dep_key = key[len(DEPLOY_PREFIX):]
        if value is None:
            self._desired.pop(dep_key, None)
            return
        try:
            dep = Deployment.from_bytes(value)
        except (SpecError, ValueError) as e:
            log.error("invalid deployment at %s: %s", key, e)
            return
        self._desired[dep_key] = dep

    async def _on_event(self, key: str, value: Optional[bytes],
                        deleted: bool = False) -> None:
        self._ingest(key, None if deleted else value)
        self._dirty.set()

    # ------------------------------------------------------------------
    async def _run(self) -> None:
        while not self._stop.is_set():
            self._dirty.clear()
            try:
                await self._reconcile_all()
            except Exception:  # noqa: BLE001 - the loop must survive
                log.exception("reconcile pass failed")
            try:
                await asyncio.wait_for(self._dirty.wait(),
                                       self.resync_interval)
            except asyncio.TimeoutError:
                pass

    async def _reconcile_all(self) -> None:
        # tear down workers of deleted deployments
        live = set(self._desired)
        for wkey in [k for k in self._workers if k[0] not in live]:
            self.runner.stop(self._workers.pop(wkey))
        for dk in [k for k in self._artifact_dirs if k not in live]:
            del self._artifact_dirs[dk]
        removed_status = []
        for dep_key, dep in list(self._desired.items()):
            await self._reconcile_one(dep_key, dep)
        # drop status of deployments that no longer exist
        if self.client is not None:
            for skey, _ in await self.client.get_prefix("deploy/status/"):
                if skey[len("deploy/status/"):] not in live:
                    removed_status.append(skey)
            for skey in removed_status:
                await self.client.delete(skey)

    async def _reconcile_one(self, dep_key: str, dep: Deployment) -> None:
        status = DeploymentStatus(observed_generation=dep.generation)
        try:
            artifact_dir = None
            graph = dep.spec.graph
            from .artifacts import is_artifact_ref, load_entry, resolve

            if is_artifact_ref(graph):
                artifact_dir, class_spec = await resolve(self.client, graph)
                entry = load_entry(artifact_dir, class_spec)
                services = self._collect_services(entry)
                prev_dir = self._artifact_dirs.get(dep_key)
                if prev_dir is not None and prev_dir != artifact_dir:
                    # a new artifact version resolved (latest moved, or the
                    # spec pinned a different one): restart the whole
                    # deployment — a key-only diff would leave old workers
                    # on the previous bundle, a silent mixed-version state
                    for wkey in [k for k in self._workers
                                 if k[0] == dep_key]:
                        self.runner.stop(self._workers.pop(wkey))
                self._artifact_dirs[dep_key] = artifact_dir
            else:
                services = self._resolve_graph(dep)
        except Exception as e:  # noqa: BLE001 - bad graph => failed status
            status.state = "failed"
            status.set_condition("GraphResolved", "False",
                                 "ImportError", str(e))
            await self._write_status(dep, status)
            return
        status.set_condition("GraphResolved", "True", "Resolved",
                             f"{len(services)} services")

        desired: Dict[WorkerKey, Tuple[ServiceSpec, str]] = {}
        for name, (class_spec, default_workers, default_chips) in \
                services.items():
            sspec = dep.spec.services.get(name) or ServiceSpec(
                replicas=default_workers, gpus=default_chips)
            if artifact_dir is not None:
                # worker children must see the extracted bundle on sys.path
                sspec = dataclasses.replace(
                    sspec, envs={**sspec.envs,
                                 "DYNAMO_ARTIFACT_PATH": artifact_dir})
            for idx in range(sspec.replicas):
                desired[(dep_key, name, idx)] = (sspec, class_spec)

        # stop: actual workers not desired anymore, or dead ones
        for wkey in [k for k in self._workers
                     if k[0] == dep_key and k not in desired]:
            self.runner.stop(self._workers.pop(wkey))
        for wkey in [k for k, h in self._workers.items()
                     if k[0] == dep_key and not self.runner.alive(h)]:
            self._workers.pop(wkey)

        # start: desired workers with no live handle; a replica the cards
        # cannot take stays unstarted until a later pass finds room
        unplaced: List[str] = []
        for wkey, (sspec, class_spec) in desired.items():
            if wkey not in self._workers:
                try:
                    self._workers[wkey] = self.runner.start(
                        dep, wkey[1], wkey[2], sspec, class_spec)
                except AllocationError as e:
                    unplaced.append(f"{wkey[1]}[{wkey[2]}]: {e}")

        ready: Dict[str, int] = {}
        for wkey, h in self._workers.items():
            if wkey[0] == dep_key and self.runner.ready(h):
                ready[wkey[1]] = ready.get(wkey[1], 0) + 1
        status.ready_replicas = ready
        want = len(desired)
        have = sum(ready.values())
        status.state = "ready" if have >= want else "deploying"
        if unplaced:
            status.set_condition("WorkersReady", "False", "InsufficientCards",
                                 f"{have}/{want} workers; not placed: "
                                 + "; ".join(unplaced))
        else:
            status.set_condition("WorkersReady",
                                 "True" if have >= want else "False",
                                 "Reconciled", f"{have}/{want} workers")
        await self._write_status(dep, status)

    # ------------------------------------------------------------------
    @staticmethod
    def _collect_services(entry) -> Dict[str, Tuple[str, int, int]]:
        """service name -> (class import spec, default workers, default
        cards) for every runnable service reachable from the entry class."""
        from ..sdk.service import chips_of, collect_graph

        out: Dict[str, Tuple[str, int, int]] = {}
        for cls in collect_graph(entry):
            spec = cls._dynamo_spec
            if not (spec.endpoints or spec.on_start or spec.dependencies):
                continue  # pure grouping node
            out[spec.name] = (f"{cls.__module__}:{cls.__name__}",
                              spec.workers, chips_of(spec.resources) or 0)
        return out

    @staticmethod
    def _resolve_graph(dep: Deployment) -> Dict[str, Tuple[str, int, int]]:
        from ..sdk.serve_child import load_class

        return Operator._collect_services(load_class(dep.spec.graph))

    async def _write_status(self, dep: Deployment,
                            status: DeploymentStatus) -> None:
        if self.client is None:
            return
        await self.client.put(
            status_key(dep.namespace, dep.name),
            json.dumps(status.to_dict()).encode())


async def apply(client: StoreClient, dep: Deployment) -> None:
    """kubectl-apply equivalent: upsert the resource (bumping generation)."""
    from .crd import deploy_key

    key = deploy_key(dep.namespace, dep.name)
    old = await client.get(key)
    if old is not None:
        try:
            dep.generation = Deployment.from_bytes(old).generation + 1
        except (SpecError, ValueError):
            pass
    await client.put(key, dep.to_bytes())


async def delete(client: StoreClient, namespace: str, name: str) -> bool:
    from .crd import deploy_key

    return await client.delete(deploy_key(namespace, name))


async def get_status(client: StoreClient, namespace: str,
                     name: str) -> Optional[DeploymentStatus]:
    raw = await client.get(status_key(namespace, name))
    if raw is None:
        return None
    return DeploymentStatus.from_dict(json.loads(raw.decode()))
