"""Rule ``metrics-catalog``: the port's metrics catalog cannot rot.

The port's copy of the JAX package's catalog gate, read against the
port's own catalog, ``dynamo_tpu_torch/docs/observability.md``. Collects every
metric name registered through the in-tree registry (``.counter("name",
...)`` / ``.gauge`` / ``.histogram`` with a literal first argument,
including local aliases ``g = registry.gauge``) and cross-checks the
catalog two-way:

- every registered metric must appear in the doc;
- every metric-shaped doc token (``dyn_*`` / ``llm_*``, minus wildcard
  families and histogram exposition suffixes) must be registered —
  documented metrics no code exports are exactly how operators end up
  alerting on series that never appear;
- the **type** column of a catalog table row (``counter`` / ``gauge`` /
  ``histogram``, optionally followed by a label list) must match the
  register method actually used — a doc claiming ``gauge`` for a
  counter sends operators writing ``rate()`` over resets the wrong way.

The collection functions are module-level so tests can hold them to the
JAX package's on the same source.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Set

from ..core import Finding, Module, Rule, register

REGISTER_METHODS = {"counter", "gauge", "histogram"}
DOC_TOKEN = re.compile(r"\b(?:dyn|llm)_[a-z0-9_]+\b")
DOC_REL = "dynamo_tpu_torch/docs/observability.md"
CODE_PREFIX = "dynamo_tpu_torch/"


def registered_in_module(mod: Module) -> Dict[str, List[str]]:
    """{metric name: [``rel:line``, ...]} for one parsed module."""
    out: Dict[str, List[str]] = {}
    # local aliases of a register method (`g = registry.gauge`) register
    # through a bare Name call — resolve them too
    aliases: Set[str] = set()
    for node in mod.nodes():
        if (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Attribute)
                and node.value.attr in REGISTER_METHODS):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    aliases.add(t.id)
    for node in mod.nodes():
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        name = func.attr if isinstance(func, ast.Attribute) else (
            func.id if isinstance(func, ast.Name) else "")
        if (name not in REGISTER_METHODS and name not in aliases) \
                or not node.args:
            continue
        arg0 = node.args[0]
        if isinstance(arg0, ast.Constant) and isinstance(
                arg0.value, str) and DOC_TOKEN.fullmatch(arg0.value):
            out.setdefault(arg0.value, []).append(
                f"{mod.rel}:{node.lineno}")
    return out


def registered_types_in_module(mod: Module) -> Dict[str, Set[str]]:
    """{metric name: {register method kinds}} for one parsed module —
    the same literal-first-argument scan as :func:`registered_in_module`,
    keeping the ``counter``/``gauge``/``histogram`` method instead of the
    site. A set because nothing stops two files registering one name
    through different methods (itself a bug the mismatch check surfaces
    against the doc's single claimed type)."""
    out: Dict[str, Set[str]] = {}
    aliases: Dict[str, str] = {}   # local alias name -> register method
    for node in mod.nodes():
        if (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Attribute)
                and node.value.attr in REGISTER_METHODS):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    aliases[t.id] = node.value.attr
    for node in mod.nodes():
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        name = func.attr if isinstance(func, ast.Attribute) else (
            func.id if isinstance(func, ast.Name) else "")
        kind = name if name in REGISTER_METHODS else aliases.get(name)
        if kind is None or not node.args:
            continue
        arg0 = node.args[0]
        if isinstance(arg0, ast.Constant) and isinstance(
                arg0.value, str) and DOC_TOKEN.fullmatch(arg0.value):
            out.setdefault(arg0.value, set()).add(kind)
    return out


def documented_types(doc_path: str) -> Dict[str, str]:
    """{metric name: claimed type} from the catalog tables: rows shaped
    ``| `name` | type ... | ...`` where the type cell LEADS with
    ``counter``/``gauge``/``histogram`` (label lists and prose after it
    are fine). Non-table mentions carry no type claim and are skipped."""
    out: Dict[str, str] = {}
    with open(doc_path, "r", encoding="utf-8") as f:
        for line in f:
            if not line.lstrip().startswith("|"):
                continue
            cells = [c.strip() for c in line.strip().strip("|").split("|")]
            if len(cells) < 2:
                continue
            m = DOC_TOKEN.fullmatch(cells[0].strip("`"))
            if m is None:
                continue
            claimed = cells[1].split()[0].rstrip(",") if cells[1] else ""
            if claimed in REGISTER_METHODS:
                out[m.group(0)] = claimed
    return out


def documented_tokens(doc_path: str) -> Set[str]:
    with open(doc_path, "r", encoding="utf-8") as f:
        text = f.read()
    # drop wildcard families like `llm_kv_blocks_*`: they are prose
    # shorthand, not catalog entries (the expanded names must still appear)
    text = re.sub(r"\b(?:dyn|llm)_[a-z0-9_]+\*", " ", text)
    return set(DOC_TOKEN.findall(text))


def catalog_findings(registered: Dict[str, List[str]],
                     documented: Set[str], rule: str = "metrics-catalog",
                     registered_kinds: Dict[str, Set[str]] = None,
                     claimed_types: Dict[str, str] = None
                     ) -> List[Finding]:
    findings: List[Finding] = []
    # type column vs register method (only for names both sides know;
    # presence mismatches are reported by the two-way checks below)
    for name in sorted(claimed_types or {}):
        kinds = (registered_kinds or {}).get(name)
        claimed = claimed_types[name]
        if not kinds or claimed in kinds:
            continue
        where = registered.get(name, [f"{DOC_REL}:0"])[0]
        path, _, line = where.rpartition(":")
        findings.append(Finding(
            rule=rule, path=path, line=int(line),
            message=(f"metric {name!r} is documented as {claimed!r} but "
                     f"registered as {'/'.join(sorted(kinds))} — fix the "
                     f"type column in {DOC_REL} (or the "
                     f"registration)"),
            key=f"type-mismatch:{name}"))
    for name in sorted(registered):
        if name not in documented:
            where = registered[name][0]
            path, _, line = where.rpartition(":")
            findings.append(Finding(
                rule=rule, path=path, line=int(line),
                message=(f"undocumented metric {name!r} — add it to "
                         f"{DOC_REL}"),
                key=f"undocumented:{name}"))
    # exposition-format suffixes of registered histograms/counters are
    # legitimate doc tokens (e.g. `llm_ttft_seconds_bucket`)
    expanded = set(registered)
    for name in registered:
        for sfx in ("_bucket", "_sum", "_count", "_total"):
            expanded.add(name + sfx)
    for token in sorted(documented):
        if token not in expanded:
            findings.append(Finding(
                rule=rule, path=DOC_REL, line=0,
                message=(f"documented metric {token!r} is not registered "
                         f"anywhere under {CODE_PREFIX} — stale catalog "
                         f"entry (or a typo)"),
                key=f"stale:{token}"))
    return findings


@register
class MetricsCatalogRule(Rule):
    name = "metrics-catalog"
    description = ("registered Prometheus metrics <-> the port's "
                   "observability.md catalog, two-way")

    def check_repo(self, modules: List[Module], repo: str) -> List[Finding]:
        registered: Dict[str, List[str]] = {}
        kinds: Dict[str, Set[str]] = {}
        for mod in modules:
            if not mod.rel.startswith(CODE_PREFIX):
                continue
            for name, sites in registered_in_module(mod).items():
                registered.setdefault(name, []).extend(sites)
            for name, ks in registered_types_in_module(mod).items():
                kinds.setdefault(name, set()).update(ks)
        doc_path = os.path.join(repo, DOC_REL)
        if not os.path.exists(doc_path):
            return [Finding(rule=self.name, path=DOC_REL, line=0,
                            message=f"{DOC_REL} is missing",
                            key="doc:missing")]
        return catalog_findings(registered, documented_tokens(doc_path),
                                rule=self.name, registered_kinds=kinds,
                                claimed_types=documented_types(doc_path))
