"""dynalint baseline: checked-in grandfather list for pre-existing findings.

The baseline lets a new rule land with teeth (CI fails on NEW findings
immediately) while the existing findings are burned down over time. Format
(``dynamo_tpu_torch/analysis/dynalint_baseline.json``)::

    {
      "rule-name": [
        {"path": "dynamo_tpu_torch/x.py", "key": "func:time.sleep",
         "reason": "one-line justification — mandatory"},
        ...
      ]
    }

Matching is on ``(rule, path, key)`` — no line numbers, so unrelated edits
don't churn the file. The gate is two-way: a finding not in the baseline
fails the run, and a baseline entry whose finding no longer exists is
reported *stale* and must be deleted (the baseline only ever shrinks).
An entry without a reason fails loading — un-justified grandfathering is
exactly the rot this file exists to prevent.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Set, Tuple

from .core import Finding

BaselineKey = Tuple[str, str, str]          # (rule, path, key)


def load(path: str) -> Dict[BaselineKey, str]:
    """{(rule, path, key): reason}; missing file = empty baseline."""
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as f:
        raw = json.load(f)
    out: Dict[BaselineKey, str] = {}
    for rule, entries in raw.items():
        for e in entries:
            reason = (e.get("reason") or "").strip()
            if not reason:
                raise ValueError(
                    f"baseline entry {rule}:{e.get('path')}:{e.get('key')} "
                    f"has no reason — every grandfathered finding needs a "
                    f"one-line justification")
            out[(rule, e["path"], e["key"])] = reason
    return out


def save(path: str, findings: List[Finding],
         default_reason: str = "TODO: justify or fix") -> None:
    """Write ``findings`` as a baseline skeleton, preserving reasons already
    present in the file for entries that still match."""
    existing = {}
    try:
        existing = load(path)
    except (ValueError, json.JSONDecodeError, OSError):
        pass
    by_rule: Dict[str, List[dict]] = {}
    for f in sorted(findings, key=lambda f: (f.rule, f.path, f.key)):
        reason = existing.get((f.rule, f.path, f.key), default_reason)
        by_rule.setdefault(f.rule, []).append(
            {"path": f.path, "key": f.key, "reason": reason})
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(by_rule, fh, indent=2, sort_keys=True)
        fh.write("\n")


def split(findings: List[Finding], baseline: Dict[BaselineKey, str]
          ) -> Tuple[List[Finding], List[Finding], List[BaselineKey]]:
    """(new, grandfathered, stale_entries)."""
    seen: Set[BaselineKey] = set()
    new: List[Finding] = []
    old: List[Finding] = []
    for f in findings:
        k = (f.rule, f.path, f.key)
        if k in baseline:
            seen.add(k)
            old.append(f)
        else:
            new.append(f)
    stale = [k for k in baseline if k not in seen]
    return new, old, sorted(stale)
