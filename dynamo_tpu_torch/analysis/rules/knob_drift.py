"""Rule ``knob-drift``: the ``DYN_*`` knob surface cannot rot.

Three checks against the central registry
(:mod:`dynamo_tpu_torch.utils.knobs`), mirroring the metrics-catalog gate:

1. every literal ``DYN_*`` string constant in scanned code must be a
   registered knob — an env read nobody declared is an operational
   surface nobody documented;
2. every non-``derived`` registry entry must still appear as a literal
   somewhere — a stale entry is a knob operators set to no effect;
3. ``dynamo_tpu_torch/docs/configuration.md`` (generated from the
   registry) must contain exactly the registered names, two-way —
   regenerate with ``python -m dynamo_tpu_torch.utils.knobs --write``
   after touching the registry.

Literal collection is AST-based (``ast.Constant`` full-matching
``DYN_[A-Z0-9_]+`` not ending in ``_``), so docstrings, prose, and prefix
fragments used to *build* names never false-positive. The registry file
itself is excluded from read collection, or the reverse check would be
trivially satisfied.

As a whole-repo rule this only runs on full-tree scans (the dynalint CLI
skips repo rules when given an explicit path subset).
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Tuple

from ..core import Finding, Module, Rule, register

KNOB_RE = re.compile(r"DYN_[A-Z0-9_]*[A-Z0-9]")
DOC_REL = "dynamo_tpu_torch/docs/configuration.md"
REGISTRY_REL = "dynamo_tpu_torch/utils/knobs.py"


def _literal_reads(modules: List[Module]) -> Dict[str, List[Tuple[str, int]]]:
    """{knob name: [(rel_path, line), ...]} for every full-match literal."""
    out: Dict[str, List[Tuple[str, int]]] = {}
    for mod in modules:
        if mod.rel == REGISTRY_REL:
            continue
        for node in mod.nodes():
            if isinstance(node, ast.Constant) and isinstance(
                    node.value, str) and KNOB_RE.fullmatch(node.value):
                out.setdefault(node.value, []).append(
                    (mod.rel, node.lineno))
    return out


@register
class KnobDriftRule(Rule):
    name = "knob-drift"
    description = ("DYN_* env knob not in the central registry, stale "
                   "registry entry, or the configuration doc out of sync")

    def check_repo(self, modules: List[Module], repo: str) -> List[Finding]:
        from ...utils.knobs import KNOBS, render_markdown
        reads = _literal_reads(modules)
        out: List[Finding] = []
        for name in sorted(reads):
            if name in KNOBS:
                continue
            path, line = reads[name][0]
            out.append(Finding(
                rule=self.name, path=path, line=line,
                message=(f"env knob {name!r} is not registered — add it to "
                         f"dynamo_tpu_torch/utils/knobs.py (type/default/"
                         f"description) and regenerate "
                         f"{DOC_REL}"),
                key=f"unregistered:{name}"))
        for name, knob in sorted(KNOBS.items()):
            if knob.derived or name in reads:
                continue
            out.append(Finding(
                rule=self.name, path=REGISTRY_REL, line=0,
                message=(f"registered knob {name!r} is never read in "
                         f"scanned code — delete the entry or mark it "
                         f"derived=True"),
                key=f"stale:{name}"))
        # ---- doc sync: the generated table IS the registry ----
        doc_path = os.path.join(repo, DOC_REL)
        if not os.path.exists(doc_path):
            out.append(Finding(
                rule=self.name, path=DOC_REL, line=0,
                message=(f"{DOC_REL} missing — generate it: "
                         f"python -m dynamo_tpu_torch.utils.knobs --write"),
                key="doc:missing"))
            return out
        with open(doc_path, "r", encoding="utf-8") as f:
            text = f.read()
        doc_tokens = set(KNOB_RE.findall(text))
        for name in sorted(set(KNOBS) - doc_tokens):
            out.append(Finding(
                rule=self.name, path=DOC_REL, line=0,
                message=(f"knob {name!r} is registered but missing from "
                         f"the doc table — regenerate: "
                         f"python -m dynamo_tpu_torch.utils.knobs --write"),
                key=f"doc-missing:{name}"))
        for name in sorted(doc_tokens - set(KNOBS)):
            out.append(Finding(
                rule=self.name, path=DOC_REL, line=0,
                message=(f"doc table names unregistered knob {name!r} — "
                         f"stale entry (or a typo); regenerate the doc"),
                key=f"doc-stale:{name}"))
        if text != render_markdown():
            out.append(Finding(
                rule=self.name, path=DOC_REL, line=0,
                message=(f"{DOC_REL} differs from the "
                         f"generated table — regenerate: "
                         f"python -m dynamo_tpu_torch.utils.knobs --write"),
                key="doc:drift"))
        return out
