"""dynalint — run the port's static analysis suite.

    python -m dynamo_tpu_torch.cli.dynalint                  # all rules
    python -m dynamo_tpu_torch.cli.dynalint dynamo_tpu_torch/llm/
    python -m dynamo_tpu_torch.cli.dynalint --changed        # git diff
    python -m dynamo_tpu_torch.cli.dynalint --report host-sync [--json]
    python -m dynamo_tpu_torch.cli.dynalint --rule lock-discipline --json
    python -m dynamo_tpu_torch.cli.dynalint --list-rules
    python -m dynamo_tpu_torch.cli.dynalint --write-baseline

The counterpart of the JAX package's ``scripts/dynalint.py``, over
``dynamo_tpu_torch/`` and ``chip_smoke.py``. Exit 1 when any unsuppressed,
non-baselined finding (or stale baseline entry) remains. Suppress inline
with ``# dynalint: ok(<rule>) <reason>``; grandfather pre-existing
findings in ``dynamo_tpu_torch/analysis/dynalint_baseline.json`` (every
entry needs a one-line justification; the file is kept empty).

Whole-repo rules (knob-drift, metrics-catalog, store-key-drift,
wire-field-drift) reason about two-way sync, so they always analyze the
full default tree; when explicit paths narrow the scan they are skipped
by default (name them with ``--rule`` to run them anyway — still against
the full tree). ``--changed`` keeps them: per-file rules see only the
files ``git diff`` names (merge-base vs HEAD + worktree), whole-repo
rules keep full-tree semantics.

``--report <rule>`` inventories EVERY site the rule knows — open findings
first, then suppressed (with their reasons) and baselined ones — and
exits 0: for ``host-sync`` this is the documented device->host transfer
budget of the dispatch paths. With ``--json`` it prints the inventory as
one JSON object (``sites``: rule, path, line, key, status, reason).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import List, Optional

from ..analysis import all_rules, run_lint
from ..analysis import baseline as baseline_mod
from ..analysis.core import REPO, Rule
from ..analysis.runner import DEFAULT_ROOTS

DEFAULT_BASELINE = os.path.join(REPO, "dynamo_tpu_torch", "analysis",
                                "dynalint_baseline.json")


def _is_repo_rule(cls) -> bool:
    return cls.check_repo is not Rule.check_repo


def _git(args: List[str]) -> List[str]:
    try:
        out = subprocess.run(["git"] + args, cwd=REPO, check=True,
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return []
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def changed_files() -> Optional[List[str]]:
    """Changed ``.py`` files under the default roots: merge-base vs HEAD
    plus worktree/index plus untracked. None when git is unavailable."""
    if not _git(["rev-parse", "--is-inside-work-tree"]):
        return None
    base = "HEAD"
    for upstream in ("@{upstream}", "origin/main", "origin/master"):
        mb = _git(["merge-base", "HEAD", upstream])
        if mb:
            base = mb[0]
            break
    names = set(_git(["diff", "--name-only", base, "HEAD"]))
    names |= set(_git(["diff", "--name-only", "HEAD"]))
    names |= set(_git(["ls-files", "--others", "--exclude-standard"]))
    out = []
    for rel in sorted(names):
        if not rel.endswith(".py") or not any(
                rel == r or rel.startswith(r.rstrip("/") + "/")
                for r in DEFAULT_ROOTS):
            continue
        path = os.path.join(REPO, rel)
        if os.path.exists(path):       # deleted files can't be parsed
            out.append(path)
    return out


def _disp_rank(key: str) -> int:
    low = key.lower()
    for rank, tokens in enumerate((("decode",), ("verify", "spec"),
                                   ("prefill",))):
        if any(t in low for t in tokens):
            return rank
    return 3


def inventory(rule_name: str, result) -> List[dict]:
    """Every site the rule knows, ranked — open findings first, then
    suppressed/baselined dispatch-path sites before the rest."""
    rows = []
    for f in result.findings:
        rows.append((0, f, "open", None))
    for f, reason in result.suppressed:
        rows.append((1, f, "suppressed", reason))
    for f in result.grandfathered:
        rows.append((2, f, "baselined", None))
    rows.sort(key=lambda r: (r[0], _disp_rank(r[1].key), r[1].path,
                             r[1].line))
    return [{"rule": f.rule, "path": f.path, "line": f.line, "key": f.key,
             "status": status, "reason": reason, "message": f.message}
            for _s, f, status, reason in rows]


def _report(rule_name: str, result, as_json: bool) -> int:
    sites = inventory(rule_name, result)
    counts = {s: sum(1 for x in sites if x["status"] == s)
              for s in ("open", "suppressed", "baselined")}
    try:
        if as_json:
            print(json.dumps({"rule": rule_name, **counts,
                              "files": result.files,
                              "elapsed_s": round(result.elapsed_s, 3),
                              "sites": sites}, indent=2))
            return 0
        print(f"{rule_name} inventory — {len(sites)} site(s) "
              f"({counts['open']} open, {counts['suppressed']} "
              f"suppressed, {counts['baselined']} baselined)")
        for s in sites:
            loc = f"{s['path']}:{s['line']}"
            if s["status"] == "open":
                print(f"OPEN       {loc}: {s['message']}")
            elif s["status"] == "suppressed":
                print(f"suppressed {loc} [{s['key']}] — {s['reason']}")
            else:
                print(f"baselined  {loc} [{s['key']}]")
    except BrokenPipeError:
        # `--report x | head` closing the pipe early is a fine way to read
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
    return 0


def main(argv: List[str]) -> int:
    p = argparse.ArgumentParser(prog="dynalint",
                                description=__doc__.splitlines()[0])
    p.add_argument("paths", nargs="*",
                   help="files/dirs to scan (default: dynamo_tpu_torch/ "
                        "+ chip_smoke.py)")
    p.add_argument("--rule", action="append", default=None,
                   metavar="NAME", help="run only these rules")
    p.add_argument("--changed", action="store_true",
                   help="per-file rules over `git diff` files only "
                        "(merge-base vs HEAD + worktree); whole-repo "
                        "rules keep full-tree semantics")
    p.add_argument("--report", metavar="RULE", default=None,
                   help="inventory mode: print every site RULE knows "
                        "(open + suppressed + baselined), exit 0")
    p.add_argument("--baseline", default=DEFAULT_BASELINE)
    p.add_argument("--no-baseline", action="store_true",
                   help="report grandfathered findings as failures too")
    p.add_argument("--write-baseline", action="store_true",
                   help="rewrite the baseline from current findings "
                        "(preserves existing reasons)")
    p.add_argument("--json", action="store_true")
    p.add_argument("--verbose", action="store_true",
                   help="also list suppressed/baselined findings")
    p.add_argument("--list-rules", action="store_true")
    args = p.parse_args(argv)

    rules = all_rules()
    if args.list_rules:
        for name in sorted(rules):
            kind = "repo" if _is_repo_rule(rules[name]) else "file"
            print(f"{name:22s} [{kind}] {rules[name].description}")
        return 0

    if args.report is not None:
        if args.report not in rules:
            p.error(f"unknown rule {args.report!r} "
                    f"(--list-rules shows the registry)")
        result = run_lint(rule_names=[args.report],
                          baseline_path=args.baseline)
        return _report(args.report, result, args.json)

    names = args.rule
    if names:
        unknown = [n for n in names if n not in rules]
        if unknown:
            p.error(f"unknown rule(s): {', '.join(unknown)} "
                    f"(--list-rules shows the registry)")
    elif args.paths:
        # narrowed scan: whole-repo rules would misreport two-way sync
        names = sorted(n for n, c in rules.items() if not _is_repo_rule(c))
    else:
        names = sorted(rules)

    if args.changed:
        if args.paths:
            p.error("--changed and explicit paths are mutually exclusive")
        changed = changed_files()
        if changed is None:
            p.error("--changed requires a git checkout")
        if not changed:
            print("ok: no changed Python files under "
                  + " + ".join(DEFAULT_ROOTS))
            return 0
        # unlike an explicit path subset, --changed KEEPS the whole-repo
        # rules: the runner feeds them the full default tree anyway, so
        # the drift gates stay sound while per-file rules run sub-second
        args.paths = changed

    # a typo'd path silently green-lighting every violation is the worst
    # possible CI outcome — reject missing paths and empty scans loudly
    for path in args.paths:
        if not os.path.exists(path):
            p.error(f"path does not exist: {path}")
        if os.path.isfile(path) and not path.endswith(".py"):
            p.error(f"not a Python file: {path}")
    if args.write_baseline and args.paths:
        # a subset rewrite would silently delete every entry (and its
        # hand-written reason) for files outside the subset
        p.error("--write-baseline requires a full-tree scan "
                "(drop the explicit paths)")

    baseline_path = None if (args.no_baseline or args.write_baseline) \
        else args.baseline
    result = run_lint(paths=[os.path.abspath(x) for x in args.paths] or None,
                      rule_names=names, baseline_path=baseline_path)
    if result.files == 0:
        print(f"error: no Python files found under: "
              f"{', '.join(args.paths)}", file=sys.stderr)
        return 2

    if args.write_baseline:
        # meta findings (reason-less suppressions) are never grandfathered
        real = [f for f in result.findings if f.rule != "suppression"]
        baseline_mod.save(args.baseline, real)
        print(f"wrote {os.path.relpath(args.baseline, REPO)} "
              f"({len(real)} entries) — now justify every reason field")
        return 0

    print(result.to_json() if args.json else
          result.to_text(verbose=args.verbose))
    return 1 if result.failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
