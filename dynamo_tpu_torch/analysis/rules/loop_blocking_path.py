"""Rule ``loop-blocking-path``: blocking calls REACHED from async code
through module-local sync helpers.

``blocking-async`` catches ``time.sleep`` written directly inside an
``async def``; this rule catches the one-hop-removed version that gate
cannot see: an async handler calling a module-local sync helper (or a
chain of them) whose body parks the loop — the classic refactor where a
blocking call is "cleaned up" into a helper function and silently stops
being flagged. Detection builds the module-local call graph (plain
``helper(...)`` calls to module-level functions plus ``self.method(...)``
within a class), computes which sync functions transitively reach a
blocking call, and flags the async-side CALL SITE of any such helper,
naming the chain.

Boundaries, deliberately:

- only the module-local graph — cross-module reachability would need
  whole-program analysis and its false-positive budget;
- a ``lambda`` is an executor boundary: ``run_in_executor(None, lambda:
  build())`` runs off-loop, so calls inside lambdas are never attributed
  to the enclosing async def (and functions passed UNCALLED to
  ``to_thread``/``run_in_executor``/``spawn_blocking`` never parse as
  calls at all);
- direct blocking calls inside the async def itself are excluded here —
  that is exactly ``blocking-async``'s finding, and double-reporting
  would force paired suppressions.

The blocking set is shared with ``blocking-async`` (``time.sleep``,
subprocess, requests, ``urllib.request.urlopen``, socket resolution /
connect, ``os.system``...) plus this rule's own ``extra_calls`` option —
wire sync store/file I/O wrappers there as they appear.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from ..core import Finding, Module, Rule, register
from .blocking_async import BLOCKING_CALLS

FuncNode = ast.AST          # FunctionDef | AsyncFunctionDef


def _owner(mod: Module, node: ast.AST) -> Optional[ast.AST]:
    """Nearest enclosing FunctionDef/AsyncFunctionDef/Lambda — unlike
    ``Module.enclosing_function``, a Lambda counts (it is the executor-
    thunk boundary this rule must not cross)."""
    parents = mod.parents()
    cur = node
    while cur in parents:
        cur = parents[cur]
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            return cur
    return None


def _enclosing_class(mod: Module, node: ast.AST) -> Optional[ast.ClassDef]:
    parents = mod.parents()
    cur = node
    while cur in parents:
        cur = parents[cur]
        if isinstance(cur, ast.ClassDef):
            return cur
        # keep walking through function hops: a def nested inside a
        # method closes over the same ``self``, so its ``self.x()``
        # calls resolve against the same class
    return None


@register
class LoopBlockingPathRule(Rule):
    name = "loop-blocking-path"
    description = ("blocking call reached from an async def through "
                   "module-local sync helpers (the hop blocking-async "
                   "cannot see)")

    def check_module(self, mod: Module) -> List[Finding]:
        blocking = BLOCKING_CALLS | set(self.options.get("extra_calls", ()))
        funcs = [n for n in mod.nodes()
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        if not funcs:
            return []
        # resolution maps: module-level `helper(...)` and `self.method(...)`
        toplevel: Dict[str, FuncNode] = {}
        methods: Dict[Tuple[ast.ClassDef, str], FuncNode] = {}
        klass_of: Dict[FuncNode, Optional[ast.ClassDef]] = {}
        for fn in funcs:
            klass = _enclosing_class(mod, fn)
            klass_of[fn] = klass
            if _owner(mod, fn) is not None:
                continue     # nested def: not resolvable by bare name
            if klass is None:
                toplevel.setdefault(fn.name, fn)
            else:
                methods.setdefault((klass, fn.name), fn)

        def resolve_local(call: ast.Call, caller: FuncNode
                          ) -> Optional[FuncNode]:
            f = call.func
            if isinstance(f, ast.Name):
                return toplevel.get(f.id)
            if (isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name)
                    and f.value.id == "self"):
                klass = klass_of.get(caller)
                if klass is not None:
                    return methods.get((klass, f.attr))
            return None

        # per-function call lists (calls OWNED by the function — nested
        # defs and lambdas keep their own)
        calls_of: Dict[FuncNode, List[ast.Call]] = {fn: [] for fn in funcs}
        for node in mod.nodes():
            if isinstance(node, ast.Call):
                own = _owner(mod, node)
                if own in calls_of:
                    calls_of[own].append(node)

        # which sync functions reach a blocking call, and through what
        # chain: {fn: (canonical blocking name, [helper names walked])}
        reach: Dict[FuncNode, Optional[Tuple[str, List[str]]]] = {}

        def reaches(fn: FuncNode, stack: List[FuncNode]
                    ) -> Optional[Tuple[str, List[str]]]:
            if fn in reach:
                return reach[fn]
            if fn in stack:
                return None          # recursion: already being resolved
            for call in calls_of[fn]:
                canonical = mod.resolve_call(call)
                if canonical in blocking:
                    reach[fn] = (canonical, [fn.name])
                    return reach[fn]
            for call in calls_of[fn]:
                callee = resolve_local(call, fn)
                if callee is None or callee is fn \
                        or isinstance(callee, ast.AsyncFunctionDef):
                    continue
                sub = reaches(callee, stack + [fn])
                if sub is not None:
                    reach[fn] = (sub[0], [fn.name] + sub[1])
                    return reach[fn]
            reach[fn] = None
            return None

        out: List[Finding] = []
        dup: Dict[str, int] = {}
        for fn in funcs:
            if not isinstance(fn, ast.AsyncFunctionDef):
                continue
            for call in calls_of[fn]:
                callee = resolve_local(call, fn)
                if callee is None \
                        or isinstance(callee, ast.AsyncFunctionDef):
                    continue
                hit = reaches(callee, [])
                if hit is None:
                    continue
                canonical, chain = hit
                via = " -> ".join(chain)
                key = f"{fn.name}->{chain[0]}:{canonical}"
                n = dup.get(key, 0) + 1
                dup[key] = n
                if n > 1:
                    key = f"{key}#{n}"
                out.append(Finding(
                    rule=self.name, path=mod.rel, line=call.lineno,
                    message=(f"async def {fn.name} calls {chain[0]}() "
                             f"which reaches {canonical}() "
                             f"(via {via}) — this blocks the event loop; "
                             f"run the helper under asyncio.to_thread / "
                             f"an executor, or use the async variant"),
                    key=key))
        return out
