"""In-place engine hot-swap: overwrite the weight tensors from host.

The engine's dispatches read ``params`` through the tensors it holds, and
the hand-written flash and paged kernels are built once per process
(``build/dynamo_tpu_torch/``) for the head shapes, never for the weights.
So a sibling checkpoint whose shape signature matches is swapped in by
overwriting the weight tensors in place: every param tensor keeps its
storage (``data_ptr()`` is unchanged), no kernel is rebuilt, and no second
copy of the weights is allocated on the device — the port's form of the
JAX package's "no new compiled program" contract. The signature covers
every compute-affecting field: the full model config plus the engine
geometry the KV pool and batch lanes were sized for.

Swap sequencing (engine thread, post-drain):

1. gate — param tree + shape signature must match, else a typed
   :class:`SwapError` (the agent falls back to a counted full reload);
2. demote — sealed device KV blocks flush to the host tier;
3. overwrite — per layer-group h2d copies from the (pinned) host tree
   into the live tensors (``CopyStream.h2d_param_slab``), enqueued on a
   side stream that waits on the compute stream, so the device streams
   weights while the host...
4. ...tears down KV state: tiered cache + hash registries clear (block
   hashes carry no model identity — old-model KV must not alias), then
   one barrier on the copies.

Under tensor parallelism every rank overwrites its own shard from its own
host cut of the sibling (``EngineCore.swap_weights``): the leader checks
the gate, a ``swap_check`` frame has every rank report its cut resident
and shaped as its shard (one small all-reduce), the leader demotes, and a
``swap`` frame runs :func:`overwrite` and :func:`barrier` on every rank.
A refusal therefore leaves every rank serving the old model.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ...utils.knobs import env_float

log = logging.getLogger("dynamo_tpu_torch.mobility")

#: layers per h2d group (DYN_SWAP_GROUP_LAYERS overrides)
DEFAULT_GROUP_LAYERS = 4

#: TorchEngineConfig fields the signature holds beside the model config:
#: the JAX package's geometry, less tp (a sibling's config comes from its
#: card at tp=1; the ranks' shards follow the incumbent's tp) and the
#: options the port has not ported (``engine._NOT_PORTED``: sp/ep/pp,
#: prefill_lanes, attn_impl, warmup)
SIGNATURE_GEOMETRY = (
    "page_size", "max_batch", "max_context", "prefill_chunk", "num_pages",
    "decode_steps", "spec", "spec_k", "spec_draft")


class SwapError(RuntimeError):
    """Typed swap refusal; ``reason`` is one of ``shape_mismatch`` |
    ``not_drained`` | ``weights_unavailable`` | ``unsupported``."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"{reason}: {detail}" if detail else reason)
        self.reason = reason


@dataclasses.dataclass
class SwapOutcome:
    path: str                 # "swap" (in-place) | "cold" (full reload)
    seconds: float
    model_path: Optional[str]
    groups: int = 0           # layer-group h2d copies issued
    demoted_blocks: int = 0   # sealed KV blocks demoted to the host tier
    # the weight stream (the swap_slab flow): bytes, and seconds from the
    # first copy enqueued to the barrier
    slab_bytes: int = 0
    slab_seconds: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def swap_signature(cfg) -> str:
    """The shape signature of a :class:`TorchEngineConfig`: equal
    signatures guarantee one engine's pool, buckets and kernels serve the
    other's params. Covers the full model config (all fields affect either
    shapes or the computation) and the engine geometry — NOT
    ``params_path``/``preset``/``seed``, which only name the weights."""
    m = dataclasses.asdict(cfg.model)
    geom = {f: getattr(cfg, f) for f in SIGNATURE_GEOMETRY}
    geom["spec"] = geom["spec"] or None
    return json.dumps({"model": m, "geom": geom}, sort_keys=True,
                      default=str)


def _flat(tree, prefix=()) -> Dict[tuple, Any]:
    """{path tuple: leaf} of a nested param dict (the port's stacked
    ``[L, ...]`` tree: ``embed``, ``layers/wq``, ...)."""
    if isinstance(tree, dict):
        out: Dict[tuple, Any] = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (str(k),)))
        return out
    return {prefix: tree}


def _host_tensor(leaf, dtype):
    """A host leaf (torch tensor or numpy array) as a CPU tensor of the
    live leaf's dtype (converted on the host only when they differ)."""
    import torch

    t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(leaf))
    if t.dtype != dtype:
        t = t.to(dtype)
    return t


def check_swap(core, new_cfg) -> None:
    """The swap's gate on the engine as it is (the leader's, before any
    frame): drained, the shape signature, and no state derived from the
    weights outside the param tree. Raises :class:`SwapError`."""
    if core.by_seq or core.waiting or core._inflight \
            or core._stream_injects:
        raise SwapError("not_drained",
                        f"{len(core.by_seq)} active, "
                        f"{len(core.waiting)} waiting")
    if swap_signature(core.cfg) != swap_signature(new_cfg):
        raise SwapError("shape_mismatch",
                        "engine geometry/model config differs")
    if core.cfg.model.vision is not None:
        # the vision tower and projector are weights of their own;
        # swapping only the LM half would serve mismatched encoders —
        # take the full reload path
        raise SwapError("unsupported", "VLM engines reload cold")
    if core.kvpager is not None:
        # the paging lane holds demoted KV and staged segments computed
        # from the old weights, keyed by hashes with no model identity
        raise SwapError("unsupported",
                        "engines with a KV paging lane reload cold")
    if core.spec is not None and core.spec.mode == "draft":
        # the draft model's weights and KV are not part of the tree
        raise SwapError("unsupported",
                        "engines with a draft model reload cold")


def check_tree(core, host_params) -> Tuple[Dict[tuple, Any],
                                          Dict[tuple, Any]]:
    """(new, old) flat trees once ``host_params`` holds every leaf of the
    engine's params at its shape (a tp rank's: its shard). Raises
    :class:`SwapError` ``shape_mismatch``."""
    new_flat = _flat(host_params)
    old_flat = _flat(core.params)
    if set(new_flat) != set(old_flat):
        missing = set(old_flat) ^ set(new_flat)
        raise SwapError("shape_mismatch",
                        f"param tree differs at {sorted(missing)[:4]}")
    for path, leaf in old_flat.items():
        if tuple(new_flat[path].shape) != tuple(leaf.shape):
            raise SwapError(
                "shape_mismatch",
                f"{'/'.join(path)}: {tuple(new_flat[path].shape)} vs "
                f"{tuple(leaf.shape)}")
    return new_flat, old_flat


def overwrite(core, new_flat, old_flat, group_layers: Optional[int] = None
              ) -> Tuple[int, int]:
    """Enqueue the in-place overwrite of every live leaf from its host
    source, a layer group at a time (async device work); returns (groups,
    bytes)."""
    import torch

    if group_layers is None:
        group_layers = max(1, int(env_float(
            "DYN_SWAP_GROUP_LAYERS", DEFAULT_GROUP_LAYERS, minimum=1.0)))
    L = core.cfg.model.num_layers
    groups = 0
    slab_bytes = 0
    cs = core.copy_stream
    with torch.no_grad():
        for path, leaf in old_flat.items():
            src = _host_tensor(new_flat[path], leaf.dtype)
            slab_bytes += src.numel() * src.element_size()
            if path[0] == "layers" and leaf.shape[0] == L \
                    and L > group_layers:
                for g0 in range(0, L, group_layers):
                    # dynalint: ok(flow-accounting) the caller records the
                    # whole stream once (finish_swap: swap_slab)
                    cs.h2d_param_slab(leaf, g0, src[g0:g0 + group_layers])
                    groups += 1
            else:
                # non-stacked leaves (embed/final_norm/lm_head) and small
                # stacks: one whole-leaf copy through the same stream
                # dynalint: ok(flow-accounting) recorded with the whole
                # stream (finish_swap: swap_slab)
                cs.h2d_param_slab(leaf, 0, src)
    return groups, slab_bytes


def clear_kv(core) -> None:
    """The KV teardown on the host: tiered cache and hash registries clear
    (block hashes carry no model identity: old-model KV must not alias)."""
    if core._wt_copies:
        core._retire_writethrough(wait=True)   # before the tier clears
    if core.tiered is not None:
        core.tiered.clear()
    core.pool.flush_reusable()           # anything demotion re-parked
    core._evict_buf.clear()              # post-clear offloads are moot
    core._wt_pending.clear()
    with core._h2d_stage_lock:
        core._h2d_stage.clear()
        core._h2d_requested.clear()
    core._pending_prefix_hit.clear()
    core._spec_states.clear()
    core.prefix_hit_tokens = 0
    core.prefix_query_tokens = 0
    core.last_prefix_hit = 0


def barrier(core) -> None:
    """Weights resident before the first new-model token."""
    import torch

    if core.device.type == "cuda":
        # the swap cutover's one host sync, never on a request
        # dynalint: ok(host-sync) the swap's one cutover barrier: every slab
        # landed before the new weights serve
        torch.cuda.current_stream(core.device).synchronize()


def hot_swap(core, host_params, new_cfg, group_layers: Optional[int] = None
             ) -> SwapOutcome:
    """Overwrite ``core``'s weight tensors with ``host_params`` (the new
    model's host tree) in place. Engine-thread only, post-drain. Raises
    :class:`SwapError` (typed, never hangs) when the swap cannot reuse
    the engine as it is; the caller then takes the full-reload path."""
    t0 = time.monotonic()
    check_swap(core, new_cfg)
    new_flat, old_flat = check_tree(core, host_params)

    # ---- demote sealed KV to the host tier ----------------------------
    demoted = core.flush_reusable()

    # ---- enqueue the weight overwrite (async device work) ------------
    t_enq = time.monotonic()
    groups, slab_bytes = overwrite(core, new_flat, old_flat, group_layers)

    # ---- KV teardown on the host while the device streams weights ----
    clear_kv(core)

    # ---- barrier: weights resident before the first new-model token --
    barrier(core)
    # one flow for the whole weight stream: the barrier bounds it, so
    # bytes/seconds is the swap's real h2d rate
    slab_seconds = time.monotonic() - t_enq
    core.swap_bytes += slab_bytes
    core.swap_seconds += slab_seconds
    return finish_swap(core, new_cfg, t0, groups, demoted, slab_bytes,
                       slab_seconds)


def finish_swap(core, new_cfg, t0: float, groups: int, demoted: int,
                slab_bytes: int, slab_seconds: float) -> SwapOutcome:
    """The leader's record of a completed swap: the ``swap_slab`` flow,
    the new weights' names in its config, ``dyn_model_swaps_total``."""
    from ...obs.flows import record_flow
    from ...utils.prometheus import stage_metrics

    record_flow("swap_slab", slab_bytes, slab_seconds)
    core.cfg = dataclasses.replace(
        core.cfg, params_path=getattr(new_cfg, "params_path", None),
        preset=getattr(new_cfg, "preset", None))
    seconds = time.monotonic() - t0
    stage_metrics().model_swaps.inc("swap")
    log.info("hot-swap to %s: %.2fs, %d layer-group copies, %d KV "
             "blocks demoted (weights overwritten in place)",
             core.cfg.params_path, seconds, groups, demoted)
    return SwapOutcome("swap", seconds, core.cfg.params_path,
                       groups=groups, demoted_blocks=demoted,
                       slab_bytes=slab_bytes, slab_seconds=slab_seconds)
