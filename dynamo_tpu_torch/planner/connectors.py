"""How decisions become replicas: local process spawn/drain, Kube patch.

- :class:`LocalConnector` — the ``sdk/serve`` shape: scale-up spawns worker
  processes (``python -m dynamo_tpu_torch.cli.worker`` by default) on cards
  granted by the :class:`~..sdk.allocator.CudaAllocator` (a CPU grant
  starts the worker with ``--device cpu``); scale-down sends
  SIGTERM so the Worker shell runs its graceful drain (``prepare_drain``
  deregisters BEFORE streams stop; in-flight requests complete). The
  connector never SIGKILLs — a stuck drain is the Worker shell's own
  escalation to handle. It only drains workers IT spawned (it cannot signal
  processes it does not own); externally started baseline workers are the
  floor it scales down to.
- :class:`KubeConnector` — patches replica counts through the operator
  plane: ``crd`` mode read-modify-writes ``spec.services[pool].replicas``
  on the DynamoDeployment resource (the reconciler does the rest), and
  ``deployment`` mode patches the child ``apps/v1`` Deployment directly.
  Works against any api with the ``get``/``apply`` surface of
  ``deploy.rest_api.RestKubeApi`` (a real apiserver) and
  ``deploy.kube.FakeKubeApi`` (tests) identically.
- :class:`NullConnector` — observes-only (also what dry-run effectively
  does, but dry-run still records what WOULD have been applied).
"""

from __future__ import annotations

import asyncio
import logging
import os
import signal
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..sdk.allocator import Allocation, AllocationError, CudaAllocator

log = logging.getLogger("dynamo_tpu_torch.planner")


@dataclass
class PoolSpec:
    """How the local connector builds a worker for one pool."""

    component: str                      # store component the pool serves as
    chips: int = 0                      # cards per replica (0 = CPU)
    engine: str = "echo"                # worker --engine (torch | echo)
    # worker binary: cli.worker for decode-shaped pools; cli.prefill_worker
    # (queue-pull, no endpoint, no --engine/--component flags) for prefill
    module: str = "dynamo_tpu_torch.cli.worker"
    extra_args: List[str] = field(default_factory=list)
    env: Dict[str, str] = field(default_factory=dict)


@dataclass
class _Owned:
    proc: subprocess.Popen
    alloc: Optional[Allocation]
    log_path: str
    started_at: float


class NullConnector:
    """No actuation — a planner that only watches and records."""

    name = "none"

    async def apply(self, pool: str, target: int, decision) -> None:
        log.info("null connector: would set %s -> %d replicas", pool, target)

    async def close(self) -> None:
        pass


class LocalConnector:
    """Spawn/drain local worker processes to meet per-pool targets."""

    name = "local"

    def __init__(self, store: str, namespace: str,
                 pools: Dict[str, PoolSpec],
                 total_chips: int = 4, platform: str = "cuda",
                 cwd: Optional[str] = None, logdir: Optional[str] = None,
                 argv_builder=None, boot_grace: float = 60.0):
        self.store = store
        self.namespace = namespace
        self.pools = dict(pools)
        self.allocator = CudaAllocator(total_chips, platform)
        self.cwd = cwd or os.getcwd()
        self.logdir = logdir or tempfile.mkdtemp(prefix="dyn_planner_")
        self.owned: Dict[str, List[_Owned]] = {p: [] for p in pools}
        self._spawned = 0
        self._argv_builder = argv_builder or self._default_argv
        self._reapers: List[asyncio.Task] = []
        # externally started workers seen per pool (first-apply estimate,
        # revised down if they die) — what lets us count our own BOOTING
        # workers as pending capacity instead of re-spawning every tick
        self._external: Dict[str, int] = {}
        # how long a spawned worker may count as "booting": bounds how long
        # a stale external estimate can wedge scale-up (set >= worst-case
        # worker bring-up; engine weight loads can take minutes)
        self.boot_grace = boot_grace
        # model-mobility swap-wakes in flight per BENEFICIARY pool
        # (monotonic issue times). A swap-wake is incoming capacity — the
        # spawn loop must not double-provision it — but it is NOT a
        # process boot: the worker already exists with an old started_at,
        # so routing it through the pending-boot arithmetic (which gates
        # on process age) would either miscount it or wedge. Tracked
        # separately and pruned by the same boot_grace age cap.
        self._swapping: Dict[str, List[float]] = {}

    # ------------------------------------------------------------------
    def _default_argv(self, pool: str, spec: PoolSpec) -> List[str]:
        # a CPU grant hides every card: the worker must be told so
        device = ["--device", self.allocator.device(spec.chips)]
        if spec.module.endswith("prefill_worker"):
            return [sys.executable, "-m", spec.module,
                    "--store", self.store,
                    "--namespace", self.namespace,
                    "--advertise-host", "127.0.0.1", *device,
                    *spec.extra_args]
        return [sys.executable, "-m", spec.module,
                "--engine", spec.engine, "--store", self.store,
                "--namespace", self.namespace,
                "--component", spec.component,
                "--advertise-host", "127.0.0.1",
                "--metrics-interval", "0.25", *device, *spec.extra_args]

    # ------------------------------------------------------------------
    # dynamic pool membership (the fleet plane adds/removes model pools
    # while the planner runs)
    def set_pool(self, pool: str, spec: PoolSpec) -> None:
        self.pools[pool] = spec
        self.owned.setdefault(pool, [])

    async def remove_pool(self, pool: str) -> None:
        """A model left the registry: gracefully drain every worker this
        connector owns in its pool, then forget the spec. Externally
        started workers are (as ever) not ours to signal."""
        for o in self.live_owned(pool):
            await self._drain(o, pool)
        self.pools.pop(pool, None)

    def live_owned(self, pool: str) -> List[_Owned]:
        """Owned workers still running (reaps exited ones' allocations)."""
        alive = []
        for o in self.owned.get(pool, []):
            if o.proc.poll() is None:
                alive.append(o)
            elif o.alloc is not None:
                self.allocator.release(o.alloc)
                o.alloc = None
        self.owned[pool] = alive
        return alive

    def _spawn(self, pool: str, spec: PoolSpec) -> None:
        try:
            alloc = self.allocator.allocate_handle(spec.chips, service=pool)
        except AllocationError as e:
            log.warning("planner scale-up of %s blocked: %s", pool, e)
            raise
        env = {**os.environ, **alloc.env, **spec.env}
        self._spawned += 1
        path = os.path.join(self.logdir,
                            f"{pool}-{self._spawned}.log")
        logf = open(path, "wb")
        try:
            proc = subprocess.Popen(self._argv_builder(pool, spec),
                                    cwd=self.cwd, env=env, stdout=logf,
                                    stderr=subprocess.STDOUT)
        finally:
            logf.close()   # the child holds its own copy of the fd
        self.owned[pool].append(
            _Owned(proc, alloc, path, time.monotonic()))
        log.info("planner spawned %s worker pid=%d (log %s)", pool,
                 proc.pid, path)

    async def _drain(self, o: _Owned, pool: str) -> None:
        """SIGTERM -> Worker shell graceful drain. NEVER kill -9: the shell
        owns escalation (stop, then kill) inside its own drain budget."""
        if o.proc.poll() is None:
            log.info("planner draining %s worker pid=%d", pool, o.proc.pid)
            o.proc.send_signal(signal.SIGTERM)

        async def reap():
            await asyncio.to_thread(o.proc.wait)
            if o.alloc is not None:
                self.allocator.release(o.alloc)
                o.alloc = None

        # prune finished reapers so a standing daemon's list stays bounded
        self._reapers = [t for t in self._reapers if not t.done()]
        self._reapers.append(asyncio.create_task(reap()))

    # ------------------------------------------------------------------
    # model mobility: in-place weight swap instead of spawn + drain
    async def swap_pool(self, store, namespace: str, from_pool: str,
                        from_component: str, payload: Dict) -> int:
        """Issue one SIGUSR1-style swap command: a worker of
        ``from_component`` should overwrite its weights in place with
        ``payload["model"]``'s and re-register under that model's
        component. ``store`` is the fleet plane's async store client
        (this connector's own ``self.store`` is just an address string).
        The command key holds a single claim-by-delete record, so at
        most one swap per donor component is in flight at a time — a
        still-pending command from an earlier tick is left alone and 0
        is returned (the plane falls back to plain spawn/drain for the
        remainder). Returns the number of swaps issued (0 or 1)."""
        import json as _json

        from ..fleet.mobility.keys import mobility_swap_key
        key = mobility_swap_key(namespace, from_component)
        if await store.get(key):
            return 0
        await store.put(key, _json.dumps(payload).encode())
        self.note_swap(from_pool, payload["model"])
        return 1

    def note_swap(self, from_pool: str, to_pool: str) -> None:
        """Accounting for one issued swap: move the donor pool's oldest
        owned process record to the beneficiary (the process keeps
        running and will serve the new component — draining
        ``from_pool`` later must not SIGTERM a worker that left it, and
        its chip allocation now belongs to ``to_pool``), and mark the
        wake in flight so ``apply`` neither spawns over it nor counts it
        as a pending process boot."""
        alive = self.live_owned(from_pool)
        if alive:
            moved = min(alive, key=lambda o: o.started_at)
            self.owned[from_pool].remove(moved)
            self.owned.setdefault(to_pool, []).append(moved)
        # else: an externally started worker swaps away; from_pool's
        # registered count drops on its own and apply's external
        # estimate revises itself down (ext = min(ext, current))
        self._swapping.setdefault(to_pool, []).append(time.monotonic())

    def _live_swaps(self, pool: str) -> int:
        """Swap-wakes still plausibly in flight for ``pool`` (age-capped
        by boot_grace so a failed swap cannot suppress spawns forever)."""
        now = time.monotonic()
        keep = [t for t in self._swapping.get(pool, ())
                if now - t < self.boot_grace]
        if keep:
            self._swapping[pool] = keep
        else:
            self._swapping.pop(pool, None)
        return len(keep)

    # ------------------------------------------------------------------
    async def apply(self, pool: str, target: int, decision) -> None:
        spec = self.pools.get(pool)
        if spec is None:
            log.warning("planner: no local pool spec for %r", pool)
            return
        current = decision.current
        alive = self.live_owned(pool)
        if current >= target:
            # capacity arrived (a swap landed and re-registered, or a
            # plain boot finished): in-flight wake markers are spent
            self._swapping.pop(pool, None)
        if target > current:
            # pending = owned processes alive but not yet registered (still
            # booting). Spawning target-current every tick would overshoot
            # the clamp whenever boot time exceeds the decision cadence.
            ext = self._external.get(pool)
            if ext is None:
                ext = max(current - len(alive), 0)
            ext = min(ext, current)     # externals that died stop counting
            self._external[pool] = ext
            owned_registered = max(current - ext, 0)
            # two independent bounds on "booting": the registration
            # arithmetic (exact while the external estimate holds) and the
            # boot-grace age cap (self-healing when an external died while
            # an owned worker was registered — the estimate can't tell
            # those apart and would otherwise wedge scale-up forever)
            now = time.monotonic()
            # swap-wakes are counted OUTSIDE the boot arithmetic: the
            # swapping worker is an old process (never "young") whose
            # registration is still under its old pool, so without the
            # separate ledger the spawn loop would double-provision
            # every swap with a cold boot
            swapping = self._live_swaps(pool)
            young = sum(1 for o in alive
                        if now - o.started_at < self.boot_grace)
            pending = min(
                max(len(alive) - swapping - owned_registered, 0), young)
            for _ in range(target - current - pending - swapping):
                try:
                    self._spawn(pool, spec)
                except AllocationError:
                    break       # out of chips: partial scale-up, retried
                                # naturally on the next evaluation
        elif target < current:
            # newest-first: baseline (externally started / oldest) workers
            # are the last to go, and never workers we don't own.
            # Replicas leaving by swap (note_swap already moved their
            # ownership to the beneficiary) are part of the shrink — do
            # not SIGTERM extra workers to cover them.
            swap_out = getattr(decision, "swap_out", 0)
            shrink = min(max(current - target - swap_out, 0), len(alive))
            victims = sorted(alive, key=lambda o: -o.started_at)[:shrink]
            if shrink < current - target - swap_out:
                log.info("planner: %s scale-down to %d limited to %d owned "
                         "worker(s); externally started workers are not "
                         "drainable from here", pool, target, shrink)
            for o in victims:
                await self._drain(o, pool)

    async def close(self, drain: bool = True) -> None:
        for pool in list(self.owned):
            for o in self.live_owned(pool):
                if drain:
                    await self._drain(o, pool)
                else:
                    o.proc.terminate()
        for t in self._reapers:
            try:
                await asyncio.wait_for(t, timeout=30.0)
            except Exception:  # noqa: BLE001 - teardown is best-effort
                t.cancel()
        self._reapers.clear()


class KubeConnector:
    """Patch replica counts through the Kubernetes plane."""

    name = "kube"

    def __init__(self, api, deployment: str, kube_namespace: str = "default",
                 mode: str = "crd",
                 service_for_pool: Optional[Dict[str, str]] = None,
                 crd_api_version: str = "dynamo.tpu/v1alpha1"):
        if mode not in ("crd", "deployment"):
            raise ValueError(f"KubeConnector mode {mode!r}")
        self.api = api
        self.deployment = deployment
        self.kube_namespace = kube_namespace
        self.mode = mode
        # pool -> CRD service name / child Deployment suffix. Defaults to
        # the pool name itself (the manifests lowercase service names).
        self.service_for_pool = dict(service_for_pool or {})
        self.crd_api_version = crd_api_version

    def _service(self, pool: str) -> str:
        return self.service_for_pool.get(pool, pool).lower()

    def set_pool(self, pool: str, spec) -> None:
        """Fleet-plane hook: map a model pool onto its CRD service name
        (the PoolSpec's component; the reconciler owns the rest)."""
        self.service_for_pool.setdefault(
            pool, getattr(spec, "component", pool))

    async def remove_pool(self, pool: str) -> None:
        """A model left the registry: patch its service to zero replicas
        (the registry contract — 'the planner's next tick drains the
        pool') and drop the mapping. A missing resource is fine: the
        deployment may never have been reconciled."""
        try:
            await asyncio.to_thread(self._apply_sync, pool, 0)
        except RuntimeError:
            log.info("fleet pool %s: no kube resource to drain", pool)
        self.service_for_pool.pop(pool, None)

    def _apply_sync(self, pool: str, target: int) -> None:
        svc = self._service(pool)
        if self.mode == "crd":
            # read-modify-write the full object: a partial spec would be
            # taken as a spec REPLACE by the fake api (and SSA field
            # stripping on a real one), wiping sibling services' replicas.
            # The carried resourceVersion makes a concurrent editor a
            # clean conflict instead of a lost update.
            obj = self.api.get("DynamoDeployment", self.kube_namespace,
                               self.deployment)
            if obj is None:
                raise RuntimeError(
                    f"DynamoDeployment {self.deployment} not found in "
                    f"{self.kube_namespace}")
            obj.setdefault("apiVersion", self.crd_api_version)
            obj.setdefault("kind", "DynamoDeployment")
            services = obj.setdefault("spec", {}).setdefault("services", {})
            services.setdefault(svc, {})["replicas"] = int(target)
            self.api.apply(obj)
        else:
            name = f"{self.deployment}-{svc}"
            obj = self.api.get("Deployment", self.kube_namespace, name)
            if obj is None:
                raise RuntimeError(f"Deployment {name} not found in "
                                   f"{self.kube_namespace}")
            obj.setdefault("spec", {})["replicas"] = int(target)
            self.api.apply(obj)

    async def apply(self, pool: str, target: int, decision) -> None:
        # the REST adapter is sync urllib: keep the control loop unblocked
        await asyncio.to_thread(self._apply_sync, pool, target)

    async def close(self) -> None:
        pass
