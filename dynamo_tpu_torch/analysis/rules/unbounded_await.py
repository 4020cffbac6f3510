"""Rule ``unbounded-await``: network awaits must be deadline-bounded.

The port's copy of the JAX package's gate. Every ``await`` of a network primitive
(``asyncio.open_connection``, frame/stream ``read``/``readexactly``,
writer ``drain``, queue ``q_pull``) is a potential hang: if the peer
stalls without closing the socket, the coroutine parks forever and the
request above it never reaches a terminal state.

An await passes when it is

- wrapped in a ``wait_for`` (``asyncio.wait_for`` or the deadline layer's
  ``deadline.wait_for``) somewhere between the await and its enclosing
  function, or
- annotated — the legacy ``# unbounded-ok`` spelling and the framework's
  ``# dynalint: ok(unbounded-await) <reason>`` are both honored — on the
  await's line or the contiguous comment block above it.

The scope stays the curated list the standalone gate grew PR over PR:
the runtime layer plus every standing control loop added since (planner,
spec, roofline/slo/dyntop, overload). New standing-daemon modules must be
added to :data:`LEGACY_SCOPE`.
"""

from __future__ import annotations

import ast
from typing import List

from ..core import Finding, Module, Rule, register

#: method/function names whose await parks on the network
NETWORK_CALLS = {"open_connection", "readexactly", "read", "drain",
                 "q_pull"}
#: enclosing call names that bound the await
GUARD_CALLS = {"wait_for"}
LEGACY_ANNOTATION = "unbounded-ok"

#: the curated path list the standalone gate accumulated (see its
#: docstring for the per-entry rationale)
LEGACY_SCOPE = [
    "dynamo_tpu_torch/runtime",
    "dynamo_tpu_torch/planner",
    "dynamo_tpu_torch/engine/spec.py",
    "dynamo_tpu_torch/utils/roofline.py",
    "dynamo_tpu_torch/utils/slo.py",
    "dynamo_tpu_torch/cli/dyntop.py",
    "dynamo_tpu_torch/utils/overload.py",
    "dynamo_tpu_torch/llm/kv_cluster",
    "dynamo_tpu_torch/llm/kvpage",
    "dynamo_tpu_torch/fleet",
    "dynamo_tpu_torch/llm/resume.py",
    "dynamo_tpu_torch/cli/aggregator.py",
]


def _call_name(node: ast.AST) -> str:
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute):
            return f.attr
        if isinstance(f, ast.Name):
            return f.id
    return ""


def _legacy_annotated(mod: Module, lineno: int) -> bool:
    lines = mod.lines
    if LEGACY_ANNOTATION in lines[lineno - 1]:
        return True
    i = lineno - 2
    while i >= 0 and lines[i].strip().startswith("#"):
        if LEGACY_ANNOTATION in lines[i]:
            return True
        i -= 1
    return False


def unbounded_awaits(mod: Module) -> List["tuple"]:
    """``(lineno, primitive_name, enclosing_function)`` for every
    unguarded, un-annotated network await — the structural API
    :class:`UnboundedAwaitRule` builds its findings from."""
    parents = mod.parents()
    out: List[tuple] = []
    for node in mod.nodes():
        if not isinstance(node, ast.Await):
            continue
        name = _call_name(node.value)
        if name not in NETWORK_CALLS:
            continue
        cur, guarded = node, False
        while cur in parents:
            cur = parents[cur]
            if _call_name(cur) in GUARD_CALLS:
                guarded = True
                break
            if isinstance(cur, (ast.AsyncFunctionDef, ast.FunctionDef)):
                break
        if guarded or _legacy_annotated(mod, node.lineno):
            continue
        fn = mod.enclosing_function(node)
        out.append((node.lineno, name,
                    fn.name if fn is not None else "<module>"))
    out.sort()
    return out


@register
class UnboundedAwaitRule(Rule):
    name = "unbounded-await"
    description = ("await of a network primitive with no wait_for bound "
                   "and no annotation")
    scope = LEGACY_SCOPE

    def check_module(self, mod: Module) -> List[Finding]:
        out: List[Finding] = []
        seen: dict = {}
        for lineno, name, where in unbounded_awaits(mod):
            key = f"{where}:{name}"
            n = seen.get(key, 0) + 1
            seen[key] = n
            if n > 1:
                key = f"{key}#{n}"
            out.append(Finding(
                rule=self.name, path=mod.rel, line=lineno,
                message=(f"unbounded network await ({name}) — wrap in "
                         f"wait_for()/deadline.wait_for() or annotate "
                         f"'# unbounded-ok: <why bounded>'"),
                key=key))
        return out
