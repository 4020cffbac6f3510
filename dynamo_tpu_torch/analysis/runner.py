"""dynalint runner: parse once, run every rule, apply suppressions+baseline.

The runner is the only piece that sees the whole picture: it expands the
path set, parses each file exactly once into a :class:`~.core.Module`,
feeds per-file rules the modules in their scope and repo rules the full
list, then filters raw findings through inline suppressions and the
baseline. The result object renders as human text or machine JSON.

Suppression semantics (see :mod:`.core`): a matching
``# dynalint: ok(<rule>) <reason>`` mutes the finding; a reason-less one
still mutes it but surfaces a ``suppression`` meta finding, so the run
fails until the mute is justified. Stale baseline entries fail the run
too — the baseline only shrinks.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from . import baseline as baseline_mod
from .core import (REPO, Finding, Module, Rule, all_rules, get_rule,
                   iter_python_files)

#: repo-relative roots a plain ``python -m dynamo_tpu_torch.cli.dynalint``
#: covers: the package and the on-card smoke (which stands in for the JAX
#: package's ``scripts/``: ``swallowed-exception`` guards it against a
#: phase whose failure is caught)
DEFAULT_ROOTS = ("dynamo_tpu_torch", "chip_smoke.py")


@dataclass
class LintResult:
    findings: List[Finding]                 # actionable: new + meta
    grandfathered: List[Finding]            # matched a baseline entry
    suppressed: List[Tuple[Finding, str]]   # (finding, reason)
    stale_baseline: List[Tuple[str, str, str]]
    files: int = 0
    rules_run: List[str] = field(default_factory=list)
    elapsed_s: float = 0.0

    @property
    def failed(self) -> bool:
        return bool(self.findings or self.stale_baseline)

    # -- rendering --------------------------------------------------------
    def to_text(self, verbose: bool = False) -> str:
        out: List[str] = []
        for f in self.findings:
            out.append(f"{f.location()}: [{f.rule}] {f.message}")
        for key in self.stale_baseline:
            rule, path, k = key
            out.append(f"{path}: [baseline] stale entry ({rule}, key={k!r}) "
                       f"— the finding is gone, delete it from the baseline")
        if verbose:
            for f, reason in self.suppressed:
                out.append(f"{f.location()}: [{f.rule}] suppressed: {reason}")
            for f in self.grandfathered:
                out.append(f"{f.location()}: [{f.rule}] baselined")
        n = len(self.findings) + len(self.stale_baseline)
        if n:
            out.append(f"\n{n} dynalint finding(s) "
                       f"({len(self.grandfathered)} baselined, "
                       f"{len(self.suppressed)} suppressed)")
        else:
            out.append(f"ok: {len(self.rules_run)} rules over "
                       f"{self.files} files in {self.elapsed_s:.1f}s "
                       f"({len(self.grandfathered)} baselined, "
                       f"{len(self.suppressed)} suppressed)")
        return "\n".join(out)

    def to_json(self) -> str:
        def enc(f: Finding) -> dict:
            return {"rule": f.rule, "path": f.path, "line": f.line,
                    "message": f.message, "key": f.key}
        return json.dumps({
            "failed": self.failed,
            "findings": [enc(f) for f in self.findings],
            "grandfathered": [enc(f) for f in self.grandfathered],
            "suppressed": [dict(enc(f), reason=r)
                           for f, r in self.suppressed],
            "stale_baseline": [
                {"rule": r, "path": p, "key": k}
                for r, p, k in self.stale_baseline],
            "files": self.files, "rules": self.rules_run,
            "elapsed_s": round(self.elapsed_s, 3),
        }, indent=2)


def _parse_tree(roots: List[str], repo: str,
                cache: Dict[str, Optional[Module]], raw: List[Finding]
                ) -> Tuple[List[Module], int]:
    files = iter_python_files(roots)
    modules: List[Module] = []
    for path in files:
        if path in cache:
            # None = already reported as a syntax error; a full-tree
            # reparse for a repo rule must not report it twice
            if cache[path] is not None:
                modules.append(cache[path])
            continue
        try:
            cache[path] = Module(path, repo=repo)
            modules.append(cache[path])
        except SyntaxError as e:
            cache[path] = None
            raw.append(Finding(
                rule="parse", path=os.path.relpath(path, repo),
                line=e.lineno or 0, message=f"syntax error: {e.msg}",
                key="syntax-error"))
    return modules, len(files)


def run_lint(paths: Optional[List[str]] = None,
             rule_names: Optional[List[str]] = None,
             baseline_path: Optional[str] = None,
             config: Optional[Dict[str, dict]] = None,
             repo: str = REPO) -> LintResult:
    """Run ``rule_names`` (default: all registered) over ``paths``.

    Per-file rules see exactly the files under ``paths``; whole-repo rules
    reason about two-way sync, so they ALWAYS analyze the full default
    tree regardless of ``paths`` (a narrowed module set would misreport
    e.g. every knob read outside the subset as a stale registry entry).

    ``config`` maps rule name -> options dict handed to the rule's
    constructor (e.g. ``{"unbounded-await": {"scope": [...]}}``).
    """
    t0 = time.monotonic()
    default_roots = [os.path.join(repo, r) for r in DEFAULT_ROOTS]
    roots = paths or default_roots
    cache: Dict[str, Optional[Module]] = {}
    raw: List[Finding] = []
    modules, n_files = _parse_tree(roots, repo, cache, raw)
    config = config or {}
    names = rule_names or sorted(all_rules())
    repo_rules_run = []
    full_modules: Optional[List[Module]] = None
    for name in names:
        cls = get_rule(name)
        rule = cls(config.get(name))
        for mod in modules:
            if rule.in_scope(mod):
                raw.extend(rule.check_module(mod))
        if cls.check_repo is not Rule.check_repo:
            repo_rules_run.append(name)
            if full_modules is None:
                full_modules = modules if paths is None else _parse_tree(
                    default_roots, repo, cache, raw)[0]
            raw.extend(rule.check_repo(full_modules, repo))

    # inline suppressions (+ meta finding for reason-less ones) — resolve
    # against every parsed module: repo-rule findings may point at files
    # outside the narrowed per-file subset
    by_rel = {m.rel: m for m in cache.values() if m is not None}
    kept: List[Finding] = []
    suppressed: List[Tuple[Finding, str]] = []
    meta: List[Finding] = []
    for f in raw:
        mod = by_rel.get(f.path)
        sup = mod.suppressions_at(f.line) if mod is not None else []
        hit = next((s for s in sup if s[0] == f.rule), None)
        if hit is None:
            kept.append(f)
            continue
        _, reason, comment_line = hit
        if reason:
            suppressed.append((f, reason))
        else:
            suppressed.append((f, "(no reason)"))
            meta.append(Finding(
                rule="suppression", path=f.path, line=comment_line,
                message=f"suppression of [{f.rule}] has no reason — "
                        f"write '# dynalint: ok({f.rule}) <why>'",
                key=f"{f.rule}:{f.key}"))

    base = baseline_mod.load(baseline_path) if baseline_path else {}
    # a subset scan can only vouch for what it saw: keep an entry in the
    # stale comparison iff its rule ran AND its finding could have been
    # produced (repo rules always see the full tree; per-file entries
    # need their file in the scanned subset)
    scanned = {m.rel for m in modules}
    base = {k: v for k, v in base.items()
            if k[0] in names and (k[0] in repo_rules_run
                                  or k[1] in scanned)}
    new, grandfathered, stale = baseline_mod.split(kept, base)
    new.extend(meta)
    new.sort(key=lambda f: (f.path, f.line, f.rule))
    return LintResult(findings=new, grandfathered=grandfathered,
                      suppressed=suppressed, stale_baseline=stale,
                      files=n_files, rules_run=list(names),
                      elapsed_s=time.monotonic() - t0)
