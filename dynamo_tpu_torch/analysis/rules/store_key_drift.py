"""Rule ``store-key-drift``: the dynstore keyspace cannot rot.

The store keyspace is an API between processes that restart
independently — a producer writing ``planner/{ns}/decisions/…`` and a
consumer watching ``planner/{ns}/decision/…`` is a silent cross-version
outage, and the keys are mostly built via f-strings a literal grep cannot
see. This gate resolves every store API call site's **key argument**
through the def-use layer back to its origin and checks it against the
central registry (:mod:`dynamo_tpu_torch.runtime.keyspace`):

1. **producer/consumer → registry**: each ``put``/``get``/``get_prefix``/
   ``watch_prefix``/``delete``/``create``/``q_push``/``q_pull``/``q_len``
   call on a store handle must resolve to a registered key family — via a
   registered helper (``decisions_prefix(ns)``), a registered constant
   (``MODEL_PREFIX``), or a literal head that starts with a registered
   prefix. An unresolvable key expression is itself a finding: route it
   through a keyspace helper (or suppress with the reason it is
   test-local).
2. **registry → code**: every registered family must still have at least
   one resolved call site — a stale entry is a keyspace nobody serves.
3. **docs**: ``dynamo_tpu_torch/docs/keyspace.md`` must match the
   generated registry rendering byte-for-byte (``python -m
   dynamo_tpu_torch.runtime.keyspace --write``). The rendering also embeds the wire-field table, so one
   regenerate refreshes both protocol surfaces.

Store handles are recognized structurally: the call's receiver chain ends
in an attribute/name spelled ``store``, ``client`` or ``ctl`` (the repo's
three StoreClient spellings); the store client/server modules themselves
are exempt (they DEFINE the ops). ``publish``/``subscribe`` subjects are
event-plane names, not keys, and stay out of scope.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from ..core import Finding, Module, Rule, register
from ..dataflow import class_attr_bindings, scope_bindings

DOC_REL = "dynamo_tpu_torch/docs/keyspace.md"
REGISTRY_REL = "dynamo_tpu_torch/runtime/keyspace.py"

#: ops whose FIRST positional arg (or key=/prefix=/queue= kwarg) is a key
KEY_OPS = {"put", "get", "get_prefix", "delete", "create", "watch_prefix",
           "q_push", "q_pull", "q_len"}

#: receiver spellings that mean "this is a StoreClient"
STORE_BASES = {"store", "client", "ctl"}

#: modules that define the store protocol itself (their put/get are the
#: implementation, not keyspace producers/consumers)
EXEMPT = {
    "dynamo_tpu_torch/runtime/store_client.py",
    "dynamo_tpu_torch/runtime/store_server.py",
    "dynamo_tpu_torch/runtime/keyspace.py",
    # the sharded client IS the routing layer: its put/get/... bodies
    # forward caller-resolved keys through classify_key — the call
    # sites behind it are the producers/consumers this rule gates
    "dynamo_tpu_torch/runtime/scale/shards.py",
}

KEY_KWARGS = {"key", "prefix", "queue"}


def _receiver_is_store(call: ast.Call) -> bool:
    f = call.func
    if not isinstance(f, ast.Attribute) or f.attr not in KEY_OPS:
        return False
    base = f.value
    if isinstance(base, ast.Attribute):
        return base.attr in STORE_BASES
    if isinstance(base, ast.Name):
        return base.id in STORE_BASES
    return False


def _key_arg(call: ast.Call) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg in KEY_KWARGS:
            return kw.value
    if call.args:
        return call.args[0]
    return None


class _Resolver:
    """Resolve a key expression to ('family', name) / ('literal', head) /
    None, chasing local and self-attribute bindings one function deep."""

    MAX_DEPTH = 6

    def __init__(self, mod: Module, registry):
        self.mod = mod
        self.reg = registry

    def resolve(self, expr: ast.expr, func: Optional[ast.AST],
                depth: int = 0) -> Optional[Tuple[str, str]]:
        if depth > self.MAX_DEPTH:
            return None
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            return ("literal", expr.value)
        if isinstance(expr, ast.JoinedStr):
            head = ""
            for part in expr.values:
                if isinstance(part, ast.Constant):
                    head += str(part.value)
                    continue
                if head:
                    return ("literal", head)
                # leading placeholder: the head IS the placeholder's origin
                inner = part.value if isinstance(
                    part, ast.FormattedValue) else part
                return self.resolve(inner, func, depth + 1)
            return ("literal", head)
        if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
            return self.resolve(expr.left, func, depth + 1)
        if isinstance(expr, ast.Await):
            return self.resolve(expr.value, func, depth + 1)
        if isinstance(expr, ast.Call):
            name = self.mod.resolve_call(expr).rsplit(".", 1)[-1]
            if name in self.reg.HELPER_INDEX:
                return ("family", self.reg.HELPER_INDEX[name].name)
            if isinstance(expr.func, ast.Attribute):
                # keys handed back by the store itself: iterating
                # `store.get_prefix(X)` yields keys under X
                if expr.func.attr in KEY_OPS:
                    karg = _key_arg(expr)
                    if karg is not None:
                        r = self.resolve(karg, func, depth + 1)
                        if r is not None:
                            return r
                # container projections: self.queues.get(...) / .values()
                # ('get' is ambiguous with the store op — the fallthrough
                # order tries both readings)
                if expr.func.attr in ("get", "values", "keys", "items",
                                      "pop"):
                    return self.resolve(expr.func.value, func, depth + 1)
            return None
        if isinstance(expr, ast.DictComp):
            return self.resolve(expr.value, func, depth + 1)
        if isinstance(expr, (ast.ListComp, ast.GeneratorExp)):
            return self.resolve(expr.elt, func, depth + 1)
        if isinstance(expr, (ast.Tuple, ast.List)):
            for e in expr.elts:
                r = self.resolve(e, func, depth + 1)
                if r is not None:
                    return r
            return None
        if isinstance(expr, ast.Attribute):
            if expr.attr in self.reg.CONSTANT_INDEX:
                return ("family", self.reg.CONSTANT_INDEX[expr.attr].name)
            # self.<attr>: chase the class-level binding
            if isinstance(expr.value, ast.Name) \
                    and expr.value.id == "self" and func is not None:
                cls = self._enclosing_class(func)
                if cls is not None:
                    for value, _via in class_attr_bindings(cls).get(
                            expr.attr, []):
                        r = self.resolve(value, None, depth + 1)
                        if r is not None:
                            return r
            return None
        if isinstance(expr, ast.Name):
            if expr.id in self.reg.CONSTANT_INDEX:
                return ("family", self.reg.CONSTANT_INDEX[expr.id].name)
            # imported constant under its own name
            imported = self.mod.imports().get(expr.id, "")
            tail = imported.rsplit(".", 1)[-1]
            if tail in self.reg.CONSTANT_INDEX:
                return ("family", self.reg.CONSTANT_INDEX[tail].name)
            if func is not None:
                for value, via in scope_bindings(func).get(expr.id, []):
                    r = self.resolve(value, func, depth + 1)
                    if r is not None:
                        return r
            return None
        if isinstance(expr, ast.Subscript):
            return self.resolve(expr.value, func, depth + 1)
        if isinstance(expr, ast.IfExp):
            return (self.resolve(expr.body, func, depth + 1)
                    or self.resolve(expr.orelse, func, depth + 1))
        return None

    def _enclosing_class(self, func: ast.AST) -> Optional[ast.ClassDef]:
        parents = self.mod.parents()
        cur = func
        while cur in parents:
            cur = parents[cur]
            if isinstance(cur, ast.ClassDef):
                return cur
        return None


def _family_lines(modules: List[Module]) -> Dict[str, int]:
    """{family name: line of its ``name=`` in the registry module}."""
    reg = next((m for m in modules if m.rel == REGISTRY_REL), None)
    out: Dict[str, int] = {}
    if reg is None:
        return out
    for node in reg.nodes():
        if isinstance(node, ast.keyword) and node.arg == "name" \
                and isinstance(node.value, ast.Constant):
            out.setdefault(str(node.value.value), node.value.lineno)
    return out


@register
class StoreKeyDriftRule(Rule):
    name = "store-key-drift"
    description = ("store API call whose key does not resolve to the "
                   "keyspace registry, a stale registry family, or "
                   "the keyspace doc out of sync")

    def check_repo(self, modules: List[Module], repo: str) -> List[Finding]:
        from ...runtime import keyspace
        out: List[Finding] = []
        used: Set[str] = set()
        dup: Dict[str, int] = {}
        for mod in modules:
            if mod.rel in EXEMPT:
                continue
            resolver = _Resolver(mod, keyspace)
            for node in mod.nodes():
                if not (isinstance(node, ast.Call)
                        and _receiver_is_store(node)):
                    continue
                key_expr = _key_arg(node)
                if key_expr is None:
                    continue
                func = mod.enclosing_function(node)
                resolved = resolver.resolve(key_expr, func)
                op = node.func.attr
                if resolved is None:
                    self._emit(out, dup, mod, node, op,
                               "key expression does not resolve to the "
                               "keyspace registry — build it with a "
                               "registered helper/constant "
                               "(runtime/keyspace.py)")
                    continue
                kind, value = resolved
                if kind == "family":
                    used.add(value)
                    continue
                fam = keyspace.family_for_literal(value)
                if fam is None:
                    self._emit(out, dup, mod, node, op,
                               f"literal key head {value!r} matches no "
                               f"registered prefix — register the family "
                               f"in runtime/keyspace.py")
                else:
                    used.add(fam.name)
        # registry -> code (at the family's line in the registry, so a
        # family kept for another reason carries its suppression there)
        fam_lines = _family_lines(modules)
        for name, fam in sorted(keyspace.KEYSPACE.items()):
            if name not in used:
                out.append(Finding(
                    rule=self.name, path=REGISTRY_REL,
                    line=fam_lines.get(name, 0),
                    message=(f"key family {name!r} ({fam.pattern}) has no "
                             f"resolved store call site in scanned code — "
                             f"delete the entry or fix the resolution"),
                    key=f"stale:{name}"))
        # docs — the wire-field table is read via AST (wire_field_drift's
        # loader) so the doc compare never imports wire.py/msgpack at
        # lint time; without wire.py in the scanned set the compare is
        # skipped (the wire rule reports that situation itself)
        from .wire_field_drift import load_registry
        wire_reg = load_registry(modules)
        doc_path = os.path.join(repo, DOC_REL)
        if not os.path.exists(doc_path):
            out.append(Finding(
                rule=self.name, path=DOC_REL, line=0,
                message=(f"{DOC_REL} missing — generate it: python -m "
                         f"dynamo_tpu_torch.runtime.keyspace --write"),
                key="doc:missing"))
        elif wire_reg is not None:
            with open(doc_path, "r", encoding="utf-8") as f:
                if f.read() != keyspace.render_markdown(
                        wire_fields=wire_reg["fields"]):
                    out.append(Finding(
                        rule=self.name, path=DOC_REL, line=0,
                        message=(f"{DOC_REL} differs from the "
                                 "generated registry — regenerate: python "
                                 "-m dynamo_tpu_torch.runtime.keyspace --write"),
                        key="doc:drift"))
        return out

    def _emit(self, out: List[Finding], dup: Dict[str, int], mod: Module,
              call: ast.Call, op: str, why: str) -> None:
        func = mod.enclosing_function(call)
        where = getattr(func, "name", "<module>")
        key = f"{where}:{op}"
        n = dup.get(f"{mod.rel}:{key}", 0) + 1
        dup[f"{mod.rel}:{key}"] = n
        if n > 1:
            key = f"{key}#{n}"
        out.append(Finding(
            rule=self.name, path=mod.rel, line=call.lineno,
            message=f"store.{op}() in {where}(): {why}", key=key))
