"""Rule ``lock-discipline``: lock-guarded fields stay lock-guarded.

If any method of a class writes ``self.x`` under ``with self._lock:``, the
author decided ``x`` is shared mutable state. A second write site WITHOUT
the lock silently breaks that invariant: under free-threading (or plain
callback reentrancy) the unguarded write races the guarded read-modify-
write and the field tears — exactly the class of bug that produced the
unlocked-reads fix in ``utils/prometheus.py``.

Mechanics, per ``class`` statement:

- guard set = every ``self.<attr>`` assigned (``=``, ``+=``, annotated)
  anywhere inside a ``with self.<lock>:`` block, where the context
  manager's attribute name contains ``lock``;
- violation = a write to a guarded attr outside every such block, in any
  method except ``__init__``/``__new__`` (construction happens-before
  publication, so the constructor may write freely).

Writes inside functions nested in a method are treated as unguarded —
they run later, when the enclosing ``with`` is long gone; if the closure
is only ever called under the lock, say so in a suppression.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Tuple

from ..core import Finding, Module, Rule, register

CTOR = {"__init__", "__new__"}


def _lock_ctx_attrs(node: ast.AST, pattern: str) -> bool:
    """True when a With/AsyncWith item is ``self.<attr>`` with ``pattern``
    in the attribute name (``self._lock``, ``self.metrics_lock``, ...)."""
    if not isinstance(node, (ast.With, ast.AsyncWith)):
        return False
    for item in node.items:
        ctx = item.context_expr
        if isinstance(ctx, ast.Attribute) and isinstance(
                ctx.value, ast.Name) and ctx.value.id == "self" \
                and pattern in ctx.attr.lower():
            return True
    return False


def _self_write_attrs(stmt: ast.stmt) -> List[Tuple[str, int]]:
    """``self.<attr>`` names written by an assignment statement."""
    targets: List[ast.expr] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        if isinstance(stmt, ast.AnnAssign) and stmt.value is None:
            return []
        targets = [stmt.target]
    out: List[Tuple[str, int]] = []
    for t in targets:
        for node in ast.walk(t):     # unpack tuples: self.a, self.b = ...
            if isinstance(node, ast.Attribute) and isinstance(
                    node.value, ast.Name) and node.value.id == "self" \
                    and isinstance(node.ctx, ast.Store):
                out.append((node.attr, stmt.lineno))
    return out


@register
class LockDisciplineRule(Rule):
    name = "lock-discipline"
    description = ("attribute written under `with self.<lock>` is also "
                   "written outside it in the same class")

    def check_module(self, mod: Module) -> List[Finding]:
        pattern = self.options.get("lock_attr_pattern", "lock")
        out: List[Finding] = []
        for cls in mod.nodes():
            if isinstance(cls, ast.ClassDef):
                out.extend(self._check_class(mod, cls, pattern))
        out.sort(key=lambda f: f.line)
        return out

    def _check_class(self, mod: Module, cls: ast.ClassDef,
                     pattern: str) -> List[Finding]:
        # (attr, line, method, guarded) for every self.<attr> write
        writes: List[Tuple[str, int, str, bool]] = []

        def scan(stmts, method: str, in_lock: bool) -> None:
            for stmt in stmts:
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    # a def at class level is a method; any deeper def is
                    # a closure, attributed to its enclosing method —
                    # closures run after the with-block exits, so their
                    # writes never inherit the guard (in_lock resets)
                    is_method = method == "<class>"
                    scan(stmt.body, stmt.name if is_method else method,
                         False)
                    continue
                if isinstance(stmt, ast.ClassDef):
                    continue      # nested class: its own _check_class run
                for attr, line in _self_write_attrs(stmt):
                    writes.append((attr, line, method, in_lock))
                lock_here = _lock_ctx_attrs(stmt, pattern)
                for _fname, body in ast.iter_fields(stmt):
                    if not (isinstance(body, list) and body):
                        continue
                    if isinstance(body[0], ast.stmt):
                        scan(body, method, in_lock or lock_here)
                    elif isinstance(body[0], ast.ExceptHandler):
                        for h in body:
                            scan(h.body, method, in_lock)

        scan(cls.body, "<class>", False)
        guarded = {attr for attr, _l, _m, g in writes if g}
        out: List[Finding] = []
        dup: Dict[str, int] = {}
        for attr, line, method, g in writes:
            if g or attr not in guarded or method in CTOR:
                continue
            key = f"{cls.name}.{attr}@{method}"
            n = dup.get(key, 0) + 1
            dup[key] = n
            if n > 1:
                key = f"{key}#{n}"
            out.append(Finding(
                rule=self.name, path=mod.rel, line=line,
                message=(f"{cls.name}.{attr} is written under "
                         f"self.*{pattern}* elsewhere but written without "
                         f"it in {method}() — take the lock or document "
                         f"why this write cannot race"),
                key=key))
        return out
