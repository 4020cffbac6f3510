"""Rule ``swallowed-exception``: broad excepts must leave a trace.

``except Exception: pass`` in serving code turns a real failure (store
session lost, KV block corrupt, task cancelled mid-transfer) into silence:
the request above it limps on or hangs, and the operator debugging the
fleet sees *nothing*. A broad handler must do at least one observable
thing: log, mark the span, bump a counter, re-raise, or capture the bound
exception object somewhere.

Flagged: ``except:``, ``except Exception``, ``except BaseException``
(alone or in a tuple) whose body contains none of

- a ``raise`` statement,
- a call to a logging / traceback / metrics / span primitive
  (``log.warning``, ``counter.inc()``, ``span.fail(...)``, ...),
- any use of the bound exception name (``except Exception as e`` where
  ``e`` flows into a message, a state field, or a response).

The repo's pre-existing ``# noqa: BLE001 - <reason>`` annotations on the
except line are honored as suppressions when they carry a reason — they
are the same contract under an older spelling. New suppressions should use
``# dynalint: ok(swallowed-exception) <reason>``.
"""

from __future__ import annotations

import ast
import re
from typing import List

from ..core import Finding, Module, Rule, register

BROAD = {"Exception", "BaseException"}
#: call names (method attr or bare function) that count as observing
OBSERVE_CALLS = {
    # logging
    "debug", "info", "warning", "warn", "error", "exception", "critical",
    "log", "print", "print_exc", "format_exc",
    # metrics
    "inc", "observe",
    # spans / request bookkeeping
    "fail", "finish", "event", "record_exception", "set_error", "annotate",
}
NOQA_BLE = re.compile(r"#\s*noqa:\s*BLE001\b\s*-?\s*(.*)")


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    names = t.elts if isinstance(t, ast.Tuple) else [t]
    return any(isinstance(n, ast.Name) and n.id in BROAD for n in names)


def _walk_no_defs(nodes):
    """Walk statements without descending into nested function/class defs —
    their bodies run later (or never), so they don't observe THIS except."""
    stack = list(nodes)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _observes(handler: ast.ExceptHandler) -> bool:
    bound = handler.name  # 'e' in `except Exception as e`, else None
    for node in _walk_no_defs(handler.body):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else "")
            if name in OBSERVE_CALLS:
                return True
        if (bound and isinstance(node, ast.Name) and node.id == bound):
            return True
    return False


@register
class SilentExceptRule(Rule):
    name = "swallowed-exception"
    description = ("broad except with no logging, span, counter, re-raise, "
                   "or use of the caught exception")

    def check_module(self, mod: Module) -> List[Finding]:
        out: List[Finding] = []
        seen_keys: dict = {}
        for node in mod.nodes():
            if not isinstance(node, ast.ExceptHandler) or not _is_broad(node):
                continue
            if _observes(node):
                continue
            # legacy inline justification: `except Exception:  # noqa:
            # BLE001 - reason` — same contract, older spelling
            line = mod.lines[node.lineno - 1] \
                if node.lineno <= len(mod.lines) else ""
            m = NOQA_BLE.search(line)
            if m and m.group(1).strip():
                continue
            fn = mod.enclosing_function(node)
            where = fn.name if fn is not None else "<module>"
            typ = "bare" if node.type is None else "Exception"
            key = f"{where}:{typ}"
            n = seen_keys.get(key, 0) + 1
            seen_keys[key] = n
            if n > 1:
                key = f"{key}#{n}"
            out.append(Finding(
                rule=self.name, path=mod.rel, line=node.lineno,
                message=(f"broad except in {where} swallows the exception "
                         f"silently — log it, bump a counter, mark the "
                         f"span, or re-raise"),
                key=key))
        out.sort(key=lambda f: f.line)
        return out
