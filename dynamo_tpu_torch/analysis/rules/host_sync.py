"""Rule ``host-sync``: implicit device→host syncs on the dispatch paths.

Every ``.item()`` / ``.tolist()`` / ``.numpy()`` / ``.cpu()`` /
``.to("cpu")`` / ``int()`` / ``float()`` / ``bool()`` / truthiness test
applied to a tensor on the card blocks the host until the stream drains
and the buffer ships; so do ``torch.cuda.synchronize()``, an event's or a
stream's ``synchronize()``, the ops whose output shape depends on the data
(``nonzero``, ``unique``, ``masked_select``, boolean-mask indexing,
``repeat_interleave`` without ``output_size``) and a blocking upload (a
``.to(device)`` / ``.cuda()`` without ``non_blocking=True``, a
``torch.tensor(..., device=...)`` of host data, a tensor indexed by a
Python list). On the decode path any of these is a per-step host round
trip that holds the next enqueue behind the card — the cost ``PERF.md``
names as the port's first bottleneck.

This rule runs the :mod:`..dataflow` torch taint lattice per module. The
taint comes from device evidence only — a ``device=`` naming the card,
``.cuda()``, ``.to(<device>)``, the port's ``to_device``, the pools and
weights, the compute modules' functions and torch ops over tainted values
— because host tensors are torch tensors too: ``.item()`` on a pinned
staging buffer or on a CPU engine's tensor is no sync. A flagged site is
either a bug (hoist/batch the fetch) or a *designed* transfer, which gets
a ``# dynalint: ok(host-sync) <why>`` suppression; the suppressed
inventory doubles as the dispatch paths' documented transfer budget
(``python -m dynamo_tpu_torch.cli.dynalint --report host-sync``).

Scoped to the compute dirs: host-side code elsewhere would only produce
noise.
"""

from __future__ import annotations

from typing import Dict, List

from ..core import Finding, Module, Rule, register
from ..dataflow import get_device_taint

SCOPE = [
    "dynamo_tpu_torch/engine",
    "dynamo_tpu_torch/ops",
    "dynamo_tpu_torch/models",
    # the KV-paging lane moves pages d2h/h2d by design — every one of its
    # transfer sites must carry a reasoned suppression (they ARE the
    # documented paging budget), and a new un-reasoned sync still fails
    "dynamo_tpu_torch/llm/kvpage",
    "dynamo_tpu_torch/llm/kvbm/transfer.py",
    # the model-mobility swap path enqueues h2d weight slabs async and
    # barriers exactly once per swap (the annotated cutover); any other
    # sync it grows is a serving-path regression
    "dynamo_tpu_torch/fleet/mobility",
]

#: tools that run only on a card (they refuse to start without CUDA)
CARD_ONLY = ("dynamo_tpu_torch/ops/flash_probe.py",
             "dynamo_tpu_torch/ops/paged_probe.py")

#: the paging lane's programs (built in programs.py, called from the
#: runner): their results are device tensors
KVPAGE_PROGRAMS = ("embed", "qkv", "attn_hot", "attn_cold", "layer_out",
                   "head")


@register
class HostSyncRule(Rule):
    name = "host-sync"
    description = ("device-tainted tensor flows into .item/.tolist/.numpy/"
                   ".cpu/int/float/bool/truthiness, a synchronize(), a "
                   "data-dependent shape or a blocking upload — a host sync")
    scope = list(SCOPE)

    def check_module(self, mod: Module) -> List[Finding]:
        opts = dict(self.options or {})
        if mod.rel.startswith("dynamo_tpu_torch/llm/kvpage"):
            # the paged runner consumes programs BUILT in programs.py;
            # per-module attribute scanning cannot see those assignments,
            # so name them — their call results are device tensors, and
            # every fetch of one must carry a reasoned suppression
            opts["devfn_attrs"] = tuple(opts.get("devfn_attrs", ())) \
                + KVPAGE_PROGRAMS
        if mod.rel in CARD_ONLY:
            opts["card_only"] = True
        taint = get_device_taint(mod, opts)
        out: List[Finding] = []
        dup: Dict[str, int] = {}
        for func in taint.top_level_functions():
            qual = taint.qualname(func)
            for hit in taint.sink_hits(func, qual):
                key = f"{qual}:{hit.label}"
                n = dup.get(key, 0) + 1
                dup[key] = n
                if n > 1:
                    key = f"{key}#{n}"
                out.append(Finding(
                    rule=self.name, path=mod.rel, line=hit.node.lineno,
                    message=(f"{hit.label} in {qual}() makes the host "
                             f"wait for the card — batch/hoist it, or "
                             f"suppress with the reason it is a designed "
                             f"transfer"),
                    key=key))
        out.sort(key=lambda f: f.line)
        return out
