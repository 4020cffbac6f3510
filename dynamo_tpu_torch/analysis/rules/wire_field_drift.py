"""Rule ``wire-field-drift``: control-header field names come from wire.py.

The two-part frame control header is the request/data plane's protocol
surface: ``context_id``, ``trace``, ``priority``, the error-frame fields.
Planes that drop unknown fields degrade gracefully — which is exactly why
a misspelled field never errors, it silently forks the protocol. The
registry (``WIRE_FIELDS`` + the ``*_KEY`` constants in
``dynamo_tpu_torch/runtime/wire.py``) is gated three ways:

1. **code → registry** (dataplane modules): a control-header dict literal
   key, or a ``.get()``/subscript on a control-named variable, spelled as
   a string literal fails — spell it through the constant. A literal that
   is not even a registered field is flagged as an unregistered field.
   Control dicts are recognized structurally: dict literals carrying a
   ``kind`` discriminator (literal or ``KIND_KEY``), and variables named
   ``control``/``base_control``/``req_control``/``ctrl``.
2. **registry → code**: every registered field's constant must be read
   somewhere outside wire.py — a constant nobody spells is a stale field.
3. **docs**: every registered field appears in the keyspace doc and vice
   versa (the full byte-for-byte check rides store-key-drift, which owns
   the generated file).

The registry is read via AST (no import of wire.py — and thus msgpack —
at lint time): ``WIRE_FIELDS`` is a literal dict and the constants are
literal assignments, by design.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set

from ..core import Finding, Module, Rule, register

WIRE_REL = "dynamo_tpu_torch/runtime/wire.py"
DOC_REL = "dynamo_tpu_torch/docs/keyspace.md"

#: modules that build/parse control headers (the per-file literal check)
DATAPLANE = (
    "dynamo_tpu_torch/runtime/component.py",
    "dynamo_tpu_torch/runtime/native_dataplane.py",
)

CONTROL_NAME_RE = re.compile(r"^(control|base_control|req_control|ctrl)$")


def load_registry(modules: List[Module]
                  ) -> Optional[Dict[str, Dict[str, str]]]:
    """{'fields': {name: desc}, 'constants': {CONST: field}} parsed from
    wire.py's AST; None when wire.py is not in the scanned set."""
    wire = next((m for m in modules if m.rel == WIRE_REL), None)
    if wire is None:
        return None
    fields: Dict[str, str] = {}
    constants: Dict[str, str] = {}
    for node in wire.tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1 \
                or not isinstance(node.targets[0], ast.Name):
            continue
        name = node.targets[0].id
        if name == "WIRE_FIELDS" and isinstance(node.value, ast.Dict):
            for k, v in zip(node.value.keys, node.value.values):
                if isinstance(k, ast.Constant) \
                        and isinstance(v, ast.Constant):
                    fields[str(k.value)] = str(v.value)
        elif name.endswith("_KEY") and isinstance(node.value, ast.Constant):
            constants[name] = str(node.value.value)
    return {"fields": fields, "constants": constants}


@register
class WireFieldDriftRule(Rule):
    name = "wire-field-drift"
    description = ("control-header field spelled as a literal in dataplane "
                   "code, unregistered wire field, stale registry "
                   "constant, or docs out of sync")

    def check_repo(self, modules: List[Module], repo: str) -> List[Finding]:
        reg = load_registry(modules)
        if reg is None:
            return []
        fields, constants = reg["fields"], reg["constants"]
        out: List[Finding] = []
        # constants must cover the field table exactly
        const_fields = set(constants.values())
        for f in sorted(set(fields) - const_fields):
            out.append(Finding(
                rule=self.name, path=WIRE_REL, line=0,
                message=(f"WIRE_FIELDS entry {f!r} has no *_KEY constant "
                         f"— add one so code can spell it"),
                key=f"no-constant:{f}"))
        for c, f in sorted(constants.items()):
            if f not in fields:
                out.append(Finding(
                    rule=self.name, path=WIRE_REL, line=0,
                    message=(f"constant {c} = {f!r} is not in WIRE_FIELDS "
                             f"— register the field (or delete the "
                             f"constant)"),
                    key=f"unregistered-constant:{c}"))
        # code -> registry: literal spellings in dataplane modules
        dup: Dict[str, int] = {}
        for mod in modules:
            if mod.rel not in DATAPLANE:
                continue
            for lit, line, ctxdesc in self._literal_fields(mod):
                if lit in fields:
                    why = (f"spell it through wire."
                           f"{self._const_for(constants, lit)}")
                else:
                    why = ("not a registered wire field — register it in "
                           "WIRE_FIELDS + a *_KEY constant")
                key = f"literal:{lit}"
                n = dup.get(f"{mod.rel}:{key}", 0) + 1
                dup[f"{mod.rel}:{key}"] = n
                if n > 1:
                    key = f"{key}#{n}"
                out.append(Finding(
                    rule=self.name, path=mod.rel, line=line,
                    message=(f"control-header field {lit!r} spelled as a "
                             f"literal in {ctxdesc} — {why}"),
                    key=key))
        # registry -> code: each constant read outside wire.py
        read: Set[str] = set()
        for mod in modules:
            if mod.rel == WIRE_REL:
                continue
            for node in mod.nodes():
                if isinstance(node, ast.Name) and node.id in constants:
                    read.add(node.id)
                elif isinstance(node, ast.Attribute) \
                        and node.attr in constants:
                    read.add(node.attr)
                elif isinstance(node, ast.ImportFrom):
                    for a in node.names:
                        if a.name in constants:
                            read.add(a.name)
        for c in sorted(set(constants) - read):
            out.append(Finding(
                rule=self.name, path=WIRE_REL, line=0,
                message=(f"wire-field constant {c} is never read outside "
                         f"wire.py — stale field, or a producer still "
                         f"spells the literal"),
                key=f"stale:{c}"))
        # docs two-way (field tokens in the generated doc)
        doc_path = os.path.join(repo, DOC_REL)
        if os.path.exists(doc_path):
            with open(doc_path, "r", encoding="utf-8") as f:
                text = f.read()
            doc_fields = set(re.findall(r"^\| `([a-z_]+)` \|", text,
                                        re.MULTILINE))
            for f2 in sorted(set(fields) - doc_fields):
                out.append(Finding(
                    rule=self.name, path=DOC_REL, line=0,
                    message=(f"wire field {f2!r} missing from the doc "
                             f"table — regenerate: python -m "
                             f"dynamo_tpu_torch.runtime.keyspace --write"),
                    key=f"doc-missing:{f2}"))
        return out

    @staticmethod
    def _const_for(constants: Dict[str, str], field: str) -> str:
        for c, f in constants.items():
            if f == field:
                return c
        return "<add a constant>"

    def _literal_fields(self, mod: Module):
        """(literal, line, context) for every literal field spelling in
        control-header contexts of one dataplane module."""
        for node in mod.nodes():
            if isinstance(node, ast.Dict) \
                    and self._is_control_dict(node, mod):
                for k in node.keys:
                    if isinstance(k, ast.Constant) \
                            and isinstance(k.value, str):
                        yield k.value, k.lineno, "a control dict literal"
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "get" \
                    and self._is_control_base(node.func.value) \
                    and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                yield (node.args[0].value, node.lineno,
                       "a control .get()")
            elif isinstance(node, ast.Subscript) \
                    and self._is_control_base(node.value) \
                    and isinstance(node.slice, ast.Constant) \
                    and isinstance(node.slice.value, str):
                # unrestricted on purpose: a TYPO'D field written via
                # subscript (`base_control["prority"] = ...`) is the
                # silent protocol fork this rule exists to catch
                yield node.slice.value, node.lineno, "a control subscript"

    @staticmethod
    def _is_control_base(expr: ast.expr) -> bool:
        return isinstance(expr, ast.Name) \
            and CONTROL_NAME_RE.match(expr.id) is not None

    @staticmethod
    def _is_control_dict(node: ast.Dict, mod: Module) -> bool:
        for k, v in zip(node.keys, node.values):
            if isinstance(k, ast.Constant) and k.value == "kind":
                return True
            if isinstance(k, ast.Name) and k.id == "KIND_KEY":
                return True
            if isinstance(k, ast.Attribute) and k.attr == "KIND_KEY":
                return True
            # {**base_control, ...}: a spread OF a control dict IS one
            if k is None and isinstance(v, ast.Name) \
                    and CONTROL_NAME_RE.match(v.id):
                return True
        # a dict literal assigned to a control-named variable is a control
        # dict even without a kind discriminator
        parent = mod.parents().get(node)
        if isinstance(parent, ast.Assign):
            for t in parent.targets:
                if isinstance(t, ast.Name) and CONTROL_NAME_RE.match(t.id):
                    return True
        return False
