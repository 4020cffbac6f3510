"""Rule ``await-holding-lock``: network awaits under an async lock.

``async with self._send_lock: await write_frame(...)`` holds the lock
across a network wait: one slow/stalled peer parks every other task at
the lock acquire, converting a single backpressured connection into a
process-wide convoy. Sometimes that is the *point* (a send lock exists
precisely to serialize frame writes) — then the site carries a
``# dynalint: ok(await-holding-lock) <why>`` suppression stating the
bound; anything else should copy the data under the lock and await
outside it.

Reuses the lock-discipline recognizer: the context manager is
``self.<attr>`` (or a bare name) whose name contains ``lock``. The
network-capable call set mirrors the unbounded-await rule's primitives
plus the repo's frame writer.
"""

from __future__ import annotations

import ast
from typing import Dict, List

from ..core import Finding, Module, Rule, register
from .lock_discipline import _lock_ctx_attrs

#: awaited callables that can park on the network (by terminal name)
NETWORK_CALLS = {
    "write_frame", "drain", "open_connection", "read", "readexactly",
    "readuntil", "readline", "sendall", "connect", "q_pull", "publish",
}


def _lock_ctx(node: ast.AST, pattern: str) -> bool:
    """Async-with over self.<lock> (lock-discipline recognizer) or a bare
    ``async with lock:`` name."""
    if _lock_ctx_attrs(node, pattern):
        return isinstance(node, ast.AsyncWith)
    if isinstance(node, ast.AsyncWith):
        for item in node.items:
            ctx = item.context_expr
            if isinstance(ctx, ast.Name) and pattern in ctx.id.lower():
                return True
    return False


@register
class AwaitHoldingLockRule(Rule):
    name = "await-holding-lock"
    description = ("await of a network-capable call inside `async with "
                   "<lock>` — one slow peer convoys every lock waiter")

    def check_module(self, mod: Module) -> List[Finding]:
        pattern = self.options.get("lock_attr_pattern", "lock")
        out: List[Finding] = []
        dup: Dict[str, int] = {}
        def pruned_walk(root: ast.AST):
            for child in ast.iter_child_nodes(root):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda)):
                    continue   # a def under the lock runs later
                yield child
                yield from pruned_walk(child)

        for node in mod.nodes():
            if not _lock_ctx(node, pattern):
                continue
            for inner in pruned_walk(node):
                if not isinstance(inner, ast.Await):
                    continue
                call = inner.value
                if not isinstance(call, ast.Call):
                    continue
                name = mod.resolve_call(call).rsplit(".", 1)[-1]
                if name not in NETWORK_CALLS:
                    continue
                func = mod.enclosing_function(inner)
                where = getattr(func, "name", "<module>")
                key = f"{where}:{name}"
                n = dup.get(key, 0) + 1
                dup[key] = n
                if n > 1:
                    key = f"{key}#{n}"
                out.append(Finding(
                    rule=self.name, path=mod.rel, line=inner.lineno,
                    message=(f"await {name}() inside `async with "
                             f"<{pattern}>` in {where}() holds the lock "
                             f"across a network wait — move the await out, "
                             f"or suppress with the serialization bound"),
                    key=key))
        out.sort(key=lambda f: f.line)
        return out
