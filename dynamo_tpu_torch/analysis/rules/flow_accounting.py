"""Rule ``flow-accounting``: byte-moving call sites must hit the ledger.

The byte-flow ledger (:mod:`dynamo_tpu_torch.obs.flows`) only earns its
claim — "every byte the cluster moves is on one link's meter" — if no
transfer site can silently bypass it. This rule pins that invariant: every
call to a byte-moving *primitive* must sit inside a function that routes
bytes through :func:`record_flow` (or the ledger directly), or carry a
``# dynalint: ok(flow-accounting) <why>`` suppression explaining why the
bytes are deliberately off-ledger. The suppressed inventory doubles as the
documented list of unmetered copies
(``python -m dynamo_tpu_torch.cli.dynalint --report flow-accounting``).

Primitives (the copies that physically cross a host/device/network edge):

- ``CopyStream`` transfer methods — ``d2h_pages`` / ``h2d_pages`` /
  ``scatter_blocks`` / ``h2d_param_slab``;
- the weight loader's pinned staging upload, ``_Stage.rows`` (called on
  a receiver spelled ``stage``): the port's counterpart of the JAX
  package's ``global_put`` — a host tree to device buffers. There is no
  ``device_put``;
- direct-mode streams — any ``client.generate(..., mode="direct", ...)``
  call: the runtime's byte plane (disagg KV push, cluster prefix fetch).

Accounting is function-granular: a site is accounted when ANY enclosing
function's body (nested defs included, so ``hot_swap``'s closures inherit
the outer record) contains a ``record_flow`` / ``flow_ledger`` call. Finer
would force one record per enqueued scatter — the ledger deliberately
meters the bounded unit (the batch, the slab stream), not each async copy.

Scoped to the byte-plane dirs. ``llm/kvbm/transfer.py`` — the CopyStream
implementation itself — is deliberately OUT of scope: it is the primitive
layer, and accounting belongs at its call sites, where the batch boundary
and the link identity are known.
"""

from __future__ import annotations

import ast
from typing import Dict, List

from ..core import Finding, Module, Rule, register

SCOPE = [
    "dynamo_tpu_torch/engine",
    "dynamo_tpu_torch/llm/kvpage",
    "dynamo_tpu_torch/llm/kv_transfer.py",
    "dynamo_tpu_torch/llm/kv_cluster",
    "dynamo_tpu_torch/fleet/mobility",
]

#: last path component of a resolved call naming a transfer primitive
MOVER_SUFFIXES = {
    "d2h_pages", "h2d_pages", "scatter_blocks", "h2d_param_slab",
}

#: primitive methods recognised only on a receiver whose name contains
#: the given spelling (``stage.rows(...)``: the loader's staging upload)
MOVER_ON_RECEIVER = {"rows": "stage"}

#: last path component of a call that routes bytes through the ledger
ACCOUNTING = {"record_flow", "flow_ledger"}


def _is_direct_stream(call: ast.Call) -> bool:
    """``*.generate(..., mode="direct", ...)`` — a runtime byte stream."""
    if not (isinstance(call.func, ast.Attribute)
            and call.func.attr == "generate"):
        return False
    for kw in call.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant) \
                and kw.value.value == "direct":
            return True
    return False


def _on_receiver(call: ast.Call, last: str) -> bool:
    spelling = MOVER_ON_RECEIVER.get(last)
    if spelling is None or not isinstance(call.func, ast.Attribute):
        return False
    base = call.func.value
    name = base.attr if isinstance(base, ast.Attribute) else (
        base.id if isinstance(base, ast.Name) else "")
    return spelling in name.lower()


@register
class FlowAccountingRule(Rule):
    name = "flow-accounting"
    description = ("byte-moving primitive (CopyStream transfer, staged "
                   "weight upload, direct-mode stream) outside any "
                   "function that records the bytes on the flow ledger")
    scope = list(SCOPE)

    def check_module(self, mod: Module) -> List[Finding]:
        extra_movers = set(self.options.get("movers", ()))
        accounted_funcs = set()
        movers: List[tuple] = []  # (node, label)
        for node in mod.nodes():
            if not isinstance(node, ast.Call):
                continue
            name = mod.resolve_call(node)
            last = name.rsplit(".", 1)[-1]
            if last in ACCOUNTING:
                fn = mod.enclosing_function(node)
                # credit the whole nesting chain: a closure recording on
                # behalf of its outer function (or vice versa) counts
                while fn is not None:
                    accounted_funcs.add(fn)
                    fn = mod.enclosing_function(fn)
            if (last in MOVER_SUFFIXES or last in extra_movers
                    or _on_receiver(node, last)):
                movers.append((node, last))
            elif _is_direct_stream(node):
                movers.append((node, "generate[mode=direct]"))

        out: List[Finding] = []
        dup: Dict[str, int] = {}
        for node, label in movers:
            fn = mod.enclosing_function(node)
            accounted = False
            qual = "<module>"
            names = []
            while fn is not None:
                names.append(fn.name)
                if fn in accounted_funcs:
                    accounted = True
                fn = mod.enclosing_function(fn)
            if names:
                qual = ".".join(reversed(names))
            if accounted:
                continue
            key = f"{qual}:{label}"
            n = dup.get(key, 0) + 1
            dup[key] = n
            if n > 1:
                key = f"{key}#{n}"
            out.append(Finding(
                rule=self.name, path=mod.rel, line=node.lineno,
                message=(f"{label} in {qual}() moves bytes no ledger "
                         f"sees — record_flow(...) the transfer, or "
                         f"suppress with the reason these bytes are "
                         f"deliberately off-ledger"),
                key=key))
        out.sort(key=lambda f: f.line)
        return out
