"""Worker-side mobility actor: watch ``mobility/`` hints, execute swaps.

One :class:`MobilityAgent` per (simple-path) worker process. It arms a
single store watch over the namespace's ``mobility/`` prefix and reacts
to the two record kinds addressed at its CURRENT component:

- **prefetch hints** — stage the listed sibling checkpoints into the
  host :class:`~.weightcache.WeightCache` (background thread; the
  incumbent keeps serving);
- **swap commands** — claim the command by deleting its key, drain
  (``prepare_drain`` + bounded wait for in-flight streams), hand the
  cached host tree to the engine thread
  (:meth:`~dynamo_tpu_torch.engine.engine.TorchEngine.swap_weights`), then
  re-register under the new model's component via the host-supplied
  ``reregister`` callback. A typed :class:`~.swap.SwapError` (shape
  mismatch, drain timeout, missing weights) falls back to a counted
  full reload through the ``cold_reload`` callback — never a hang.
  A failure AFTER the drain (the reload's build raised, the swap broke
  off mid-copy, the re-registration failed) leaves the worker with no
  lease and no servable engine: the agent then calls ``on_fatal`` so the
  worker ends and its orchestrator reaps it and its cards. The JAX agent
  logs and lives on there, a zombie that holds its cards.

A tensor-parallel engine (``TorchEngine.shard_swaps``) keeps no whole
tree here: a prefetch hint becomes a ``swap_prefetch`` frame that has
every rank stage its own cut of the sibling, and the swap overwrites each
rank's shard from it (``EngineCore.swap_weights``). Its cold reload
rebuilds the whole rank group (the worker's ``cold_reload``).

The agent publishes the wake record (``mobility/{ns}/wake/{model}``)
and the ``dyn_model_wake_seconds``/``dyn_model_swaps_total`` series;
wake latency is measured from command receipt to serving registration,
which is the number the arbiter's swap preference is buying down.

Scope gate: hot-swap is only wired for the simple serving path — no
disagg, no cluster KV attach, one node (the worker CLI enforces this at
construction; those paths keep the plain cold-spawn wake).
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
import time
from typing import Any, Awaitable, Callable, Optional

from ...utils.knobs import env_float
from .keys import (mobility_prefetch_key, mobility_prefix,
                   mobility_swap_key, mobility_wake_key)
from .swap import SwapError, SwapOutcome
from .weightcache import WeightCache

log = logging.getLogger("dynamo_tpu_torch.mobility")

#: geometry fields copied from the incumbent config when building the
#: swap candidate's config — the KV pool and batch lanes were sized from
#: these, on this device, so the sibling must be evaluated against the
#: SAME geometry (a matching model class then signature-matches and swaps
#: in place). The JAX package's list, less tp (the sibling's config is a
#: tp=1 config from its card; a tp engine's ranks keep their layout) and
#: the options the port has not ported (``engine._NOT_PORTED``), plus the
#: device the engine runs on
GEOMETRY_FIELDS = (
    "page_size", "max_batch", "max_context",
    "prefill_chunk", "num_pages", "decode_steps",
    "spec", "spec_k", "spec_draft",
    "enable_prefix_reuse", "host_cache_blocks", "disk_cache_blocks",
    "disk_cache_path", "cluster_writethrough",
    "kvpage_budget", "kvpage_seg_pages", "kvpage_prefetch",
    "kvpage_max_context", "kvpage_batch", "device",
)


class EngineRef:
    """Serving-path indirection: handlers stream through ``.engine`` so
    a cold-reload fallback can rebind the live engine object without
    re-plumbing every closure that captured it."""

    def __init__(self, engine: Any):
        self.engine = engine

    def generate(self, request, context):
        return self.engine.generate(request, context)

    def __getattr__(self, name):
        return getattr(self.engine, name)


class MobilityAgent:
    """See module docstring. ``reregister(payload)`` re-grants the lease
    and re-serves endpoints under the swapped-in model's component;
    ``cold_reload(new_cfg)`` builds a replacement engine for the typed
    fallback path (both supplied by the worker CLI; tests inject stubs).
    ``on_fatal()`` ends the worker after a failure past the drain point.
    """

    def __init__(self, drt, namespace: str, component: str,
                 engine_ref: EngineRef,
                 reregister: Callable[[dict], Awaitable[None]],
                 cold_reload: Optional[
                     Callable[[Any], Awaitable[Any]]] = None,
                 cache: Optional[WeightCache] = None,
                 model_name: str = "",
                 cfg_builder: Optional[Callable[[str, str], Any]] = None,
                 on_fatal: Optional[Callable[[], None]] = None):
        self.drt = drt
        self.namespace = namespace
        self.component = component
        self.engine_ref = engine_ref
        self.reregister = reregister
        self.cold_reload = cold_reload
        self.on_fatal = on_fatal
        self._drained = False     # this command has taken the worker down
        # a worker on a card page-locks the staged weights (the swap's
        # h2d copies are asynchronous only from pinned memory)
        self.cache = cache or WeightCache(pinned=self._on_card())
        self.model_name = model_name
        self._cfg_builder = cfg_builder or self._default_cfg
        self._lock = asyncio.Lock()
        self._tasks: list = []
        self.swaps = 0            # completed wakes (either path)

    # ------------------------------------------------------------------
    def _shard_swaps(self) -> bool:
        return bool(getattr(self.engine_ref.engine, "shard_swaps", False))

    def _on_card(self) -> bool:
        core = getattr(self.engine_ref.engine, "core", None)
        device = getattr(core, "device", None)
        return getattr(device, "type", None) == "cuda"

    def _default_cfg(self, model_name: str, model_path: str):
        """Candidate engine config for a sibling checkpoint: its own
        model config on the INCUMBENT's geometry (see GEOMETRY_FIELDS)."""
        from ...engine.engine import TorchEngineConfig
        from ...llm.model_card import ModelDeploymentCard

        old = self.engine_ref.engine.core.cfg
        card = ModelDeploymentCard.resolve(model_path, model_name or None)
        card.kv_block_size = old.page_size
        cand = TorchEngineConfig.from_card(card, device=old.device)
        return dataclasses.replace(
            cand, **{f: getattr(old, f) for f in GEOMETRY_FIELDS})

    # ------------------------------------------------------------------
    async def start(self) -> "MobilityAgent":
        prefix = mobility_prefix(self.namespace)

        async def on_event(key: str, value: Optional[bytes],
                           deleted: bool) -> None:
            self._dispatch(key, value, deleted)

        snapshot = await self.drt.store.watch_prefix(prefix, on_event)
        for key, value in snapshot:
            self._dispatch(key, value, False)
        return self

    def _dispatch(self, key: str, value: Optional[bytes],
                  deleted: bool) -> None:
        """Route one watch event. The comparison is against the CURRENT
        component, so after a swap the same watch follows the worker's
        new identity with no re-arm."""
        if deleted or not value:
            return
        if key == mobility_prefetch_key(self.namespace, self.component):
            self._apply_prefetch(value)
        elif key == mobility_swap_key(self.namespace, self.component):
            try:
                payload = json.loads(value.decode())
            except (ValueError, json.JSONDecodeError):
                log.warning("ignoring malformed swap command %s", key)
                return
            self._tasks = [t for t in self._tasks if not t.done()]
            self._tasks.append(
                asyncio.create_task(self._execute(payload)))

    def _apply_prefetch(self, value: bytes) -> None:
        try:
            models = json.loads(value.decode()).get("models") or []
        except (ValueError, json.JSONDecodeError):
            log.warning("ignoring malformed prefetch hint for %s",
                        self.component)
            return
        for m in models:
            path = m.get("model_path")
            if not path or path in self.cache:
                continue
            try:
                cfg = self._cfg_builder(m.get("model", ""), path)
            except Exception:  # noqa: BLE001 - a bad hint must not kill
                log.warning("prefetch hint for %s unresolvable", path,
                            exc_info=True)
                continue
            if self._shard_swaps():
                # every rank stages its own cut (a swap_prefetch frame)
                self.engine_ref.engine.prefetch_shards(cfg)
                log.info("prefetching sibling weights on every rank: %s",
                         path)
            elif self.cache.prefetch(path, cfg.model):
                log.info("prefetching sibling weights: %s", path)

    # ------------------------------------------------------------------
    async def _wait_drained(self) -> bool:
        """Bounded post-``prepare_drain`` wait for in-flight streams and
        engine work to finish. DYN_SWAP_DRAIN_TIMEOUT caps it — a wedged
        drain becomes the typed reload fallback, never a hang."""
        timeout = env_float("DYN_SWAP_DRAIN_TIMEOUT", 120.0, minimum=0.0)
        deadline = time.monotonic() + timeout
        core = getattr(self.engine_ref.engine, "core", None)
        while time.monotonic() < deadline:
            busy = bool(self.drt._active) \
                or (core is not None and core.has_work)
            if not busy:
                return True
            await asyncio.sleep(0.05)
        return False

    async def _execute(self, payload: dict) -> None:
        async with self._lock:
            self._drained = False
            try:
                await self._execute_locked(payload)
            except Exception:  # noqa: BLE001 - agent must survive a swap
                # failure and keep serving whatever identity it holds
                from ...utils.prometheus import stage_metrics

                stage_metrics().model_swaps.inc("error")
                if not self._drained:
                    log.exception("swap command failed; worker keeps its "
                                  "current model")
                    return
                # deregistered, and the engine may be gone or half
                # overwritten: nothing is left to serve
                log.exception("swap command failed after the drain; the "
                              "worker has no servable engine")
                if self.on_fatal is not None:
                    self.on_fatal()

    async def _execute_locked(self, payload: dict) -> None:
        from ...utils.prometheus import stage_metrics

        model = payload.get("model") or ""
        model_path = payload.get("model_path")
        command_key = mobility_swap_key(self.namespace, self.component)
        # claim-by-delete: the first worker to erase the command owns it
        # (a rare double-claim over-swaps by one worker; the planner's
        # next tick corrects the counts)
        await self.drt.store.delete(command_key)
        t0 = time.monotonic()
        new_cfg = self._cfg_builder(model, model_path)
        # the source tree must survive the swap window even under cache
        # pressure from a concurrent prefetch. A tp engine's ranks hold
        # their own cuts (the swap loads any that has not landed)
        shards = self._shard_swaps()
        host = self.cache.get(model_path) if model_path and not shards \
            else None
        if host is None and model_path and not shards:
            host = await asyncio.to_thread(
                self.cache.load_now, model_path, new_cfg.model)
        if model_path:
            self.cache.pin(model_path)
        try:
            # dynalint: ok(lock-discipline) _execute_locked runs only inside
            # _execute's `async with self._lock`, so this write holds the lock
            self._drained = True
            await self.drt.prepare_drain()
            drained = await self._wait_drained()
            outcome: Optional[SwapOutcome] = None
            try:
                if host is None and not (shards and model_path):
                    raise SwapError("weights_unavailable",
                                    model_path or "no model_path")
                if not drained:
                    raise SwapError("not_drained", "drain timeout")
                if not hasattr(self.engine_ref.engine, "swap_weights"):
                    raise SwapError("unsupported",
                                    "engine has no swap path")
                outcome = await self.engine_ref.engine.swap_weights(
                    host, new_cfg)
            except SwapError as e:
                stage_metrics().model_swaps.inc(e.reason)
                if self.cold_reload is None:
                    raise
                log.warning("hot-swap to %s refused (%s); full reload",
                            model, e)
                self.engine_ref.engine = await self.cold_reload(new_cfg)
                stage_metrics().model_swaps.inc("reload")
                outcome = SwapOutcome("cold", time.monotonic() - t0,
                                      model_path)
        finally:
            if model_path:
                self.cache.unpin(model_path)
        # serving registration under the new identity completes the wake
        await self.reregister(payload)
        old = self.component
        self.component = payload.get("component") or f"backend-{model}"
        self.model_name = model
        self.swaps += 1
        seconds = time.monotonic() - t0
        stage_metrics().model_wake_seconds.observe(outcome.path,
                                                   value=seconds)
        await self.drt.store.put(
            mobility_wake_key(self.namespace, model),
            json.dumps({"path": outcome.path,
                        "seconds": round(seconds, 3),
                        "at": time.time(),
                        "worker": f"{self.drt.worker_id:x}"}).encode())
        log.info("model wake %s -> %s via %s in %.2fs", old,
                 self.component, outcome.path, seconds)
