"""Rule ``fire-and-forget``: every spawned task handle must be retained.

``asyncio.create_task`` / ``ensure_future`` used as a bare statement drops
the only reference to the task. Two distinct failure modes follow:

- an exception inside the task is swallowed until the task object is
  garbage collected, then surfaces as an unactionable "Task exception was
  never retrieved" log line — long after the request it belonged to
  returned garbage;
- CPython's event loop holds only a *weak* reference to tasks, so a
  dropped handle can be collected mid-flight and the work silently
  vanishes.

Retaining means anything that keeps the Call's value alive or observed:
assignment, append into a registry, passing it onward, awaiting it, or an
immediate method call on it (``ensure_future(aw).cancel()``). Statically
that is simply: the Call must not be an expression-statement. Flagged on
``asyncio.create_task`` / ``asyncio.ensure_future`` (alias-resolved) and
on ``<anything>.create_task`` / ``<anything>.ensure_future`` so
``loop.create_task(...)`` is covered too.
"""

from __future__ import annotations

import ast
from typing import List

from ..core import Finding, Module, Rule, register

SPAWN_ATTRS = {"create_task", "ensure_future"}
SPAWN_CANONICAL = {"asyncio.create_task", "asyncio.ensure_future"}


@register
class FireForgetRule(Rule):
    name = "fire-and-forget"
    description = ("asyncio task spawned as a bare statement — the handle "
                   "(and any exception in it) is dropped")

    def check_module(self, mod: Module) -> List[Finding]:
        parents = mod.parents()
        out: List[Finding] = []
        dup: dict = {}
        for node in mod.nodes():
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            attr = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else "")
            # alias-resolved: `from asyncio import ensure_future as bg`
            # canonicalizes to asyncio.ensure_future; a method spelled
            # create_task/ensure_future on ANY object (loop.create_task)
            # also counts. A bare local helper that merely shares the
            # name resolves to neither and is skipped.
            canonical = mod.resolve_call(node)
            if canonical in SPAWN_CANONICAL:
                attr = canonical.rsplit(".", 1)[-1]
            elif not (isinstance(f, ast.Attribute)
                      and attr in SPAWN_ATTRS):
                continue
            if not isinstance(parents.get(node), ast.Expr):
                continue
            fn = mod.enclosing_function(node)
            where = fn.name if fn is not None else "<module>"
            # discriminate repeats so one baseline entry can never
            # grandfather a second, newly added drop of the same shape
            key = f"{where}:{attr}"
            n = dup.get(key, 0) + 1
            dup[key] = n
            if n > 1:
                key = f"{key}#{n}"
            out.append(Finding(
                rule=self.name, path=mod.rel, line=node.lineno,
                message=(f"{attr}() handle dropped in {where} — retain it "
                         f"(task set / attribute) or add a done-callback "
                         f"that logs the exception"),
                key=key))
        return out
