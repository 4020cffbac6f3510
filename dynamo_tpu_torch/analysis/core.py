"""dynalint core: parsed-module cache, rule registry, suppressions.

A :class:`Rule` sees :class:`Module` objects — one parsed Python file with
lazily built parent links and an import-alias map — and returns
:class:`Finding`\\ s. Findings carry a **stable key** (no line number) so the
baseline survives unrelated edits shifting lines.

Suppression syntax (checked by :func:`suppressed`)::

    do_thing()   # dynalint: ok(rule-name) one-line reason why this is fine

The annotation may sit on the flagged line itself or anywhere in the
contiguous comment block directly above it (same convention the legacy
``# unbounded-ok`` annotation used). A reason is mandatory: a bare
``ok(rule)`` suppresses the finding but raises a ``suppression`` meta
finding instead, so un-justified mutes cannot accumulate silently.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple, Type

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SUPPRESS_RE = re.compile(
    r"#\s*dynalint:\s*ok\(\s*([a-z0-9_\-]+)\s*\)\s*(.*)")


@dataclass(frozen=True)
class Finding:
    """One rule violation.

    ``key`` is the baseline identity: stable across line drift (e.g.
    ``"func_name:time.sleep"``), unique enough within (rule, path) that a
    grandfathered finding doesn't mask a new one of the same shape — rules
    append a discriminator when a key would collide.
    """

    rule: str
    path: str          # repo-relative, '/'-separated
    line: int
    message: str
    key: str

    def location(self) -> str:
        return f"{self.path}:{self.line}"


class Module:
    """One parsed source file, shared across rules (parse once per run)."""

    def __init__(self, path: str, repo: str = REPO):
        self.path = os.path.abspath(path)
        self.rel = os.path.relpath(self.path, repo).replace(os.sep, "/")
        with open(self.path, "r", encoding="utf-8") as f:
            self.src = f.read()
        self.lines = self.src.splitlines()
        self.tree = ast.parse(self.src, filename=self.path)
        self._parents: Optional[Dict[ast.AST, ast.AST]] = None
        self._imports: Optional[Dict[str, str]] = None
        self._nodes: Optional[List[ast.AST]] = None

    # -- structure helpers ------------------------------------------------
    def nodes(self) -> List[ast.AST]:
        """Flat cached list of every AST node (``ast.walk`` order). Rules
        that scan the whole module iterate this instead of re-walking the
        tree — with a dozen rules over a hundred files, the repeated
        ``ast.walk`` traversals were the suite's dominant cost."""
        if self._nodes is None:
            self._nodes = list(ast.walk(self.tree))
        return self._nodes

    def parents(self) -> Dict[ast.AST, ast.AST]:
        if self._parents is None:
            self._parents = {}
            for node in self.nodes():
                for child in ast.iter_child_nodes(node):
                    self._parents[child] = node
        return self._parents

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        """Nearest enclosing (Async)FunctionDef, or None at module level."""
        parents = self.parents()
        cur = node
        while cur in parents:
            cur = parents[cur]
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
        return None

    # -- import resolution ------------------------------------------------
    def imports(self) -> Dict[str, str]:
        """{local name: canonical dotted name} for every import binding.

        ``import time as _time`` -> ``{"_time": "time"}``;
        ``from subprocess import run`` -> ``{"run": "subprocess.run"}``.
        A dotted ``import a.b`` binds only the top-level ``a`` — mapping
        it to itself keeps attribute chains canonical (``a.b.c()``
        resolves to ``"a.b.c"``, not ``"a.b.b.c"``). Relative imports
        keep their textual module path — rules match stdlib canonical
        names, which are never relative.
        """
        if self._imports is None:
            m: Dict[str, str] = {}
            for node in ast.walk(self.tree):
                if isinstance(node, ast.Import):
                    for a in node.names:
                        if a.asname:
                            m[a.asname] = a.name
                        else:
                            top = a.name.split(".")[0]
                            m[top] = top
                elif isinstance(node, ast.ImportFrom) and node.module:
                    prefix = "." * node.level + node.module
                    for a in node.names:
                        m[a.asname or a.name] = f"{prefix}.{a.name}"
                elif isinstance(node, ast.ImportFrom) and node.level:
                    # `from . import attention as tatt`: a sibling module
                    for a in node.names:
                        m[a.asname or a.name] = "." * node.level + a.name
            self._imports = m
        return self._imports

    def resolve_call(self, call: ast.Call) -> str:
        """Best-effort canonical dotted name of a call's target.

        ``_time.sleep(1)`` -> ``"time.sleep"`` (through the alias map);
        ``run(...)`` where run came ``from subprocess import run`` ->
        ``"subprocess.run"``; an unresolvable base keeps its local name
        (``"loop.create_task"``).
        """
        parts: List[str] = []
        f: ast.AST = call.func
        while isinstance(f, ast.Attribute):
            parts.append(f.attr)
            f = f.value
        if isinstance(f, ast.Name):
            base = self.imports().get(f.id, f.id)
        else:
            base = "?"          # call on an expression, e.g. foo().bar()
        return ".".join([base] + list(reversed(parts)))

    # -- suppressions -----------------------------------------------------
    def suppressions_at(self, lineno: int) -> List[Tuple[str, str, int]]:
        """``(rule, reason, comment_line)`` annotations covering ``lineno``:
        on the line itself or in the contiguous comment block above. A
        block annotation's reason continues across the following comment
        lines (until another annotation or the end of the block), so
        reasons can be written out in full."""
        out: List[Tuple[str, str, int]] = []
        if 1 <= lineno <= len(self.lines):
            m = SUPPRESS_RE.search(self.lines[lineno - 1])
            if m:
                out.append((m.group(1), m.group(2).strip(), lineno))
        i = lineno - 2
        while i >= 0 and self.lines[i].strip().startswith("#"):
            m = SUPPRESS_RE.search(self.lines[i])
            if m:
                reason = [m.group(2).strip()]
                j = i + 1
                while j < lineno - 1:
                    cont = self.lines[j].strip()
                    if not cont.startswith("#") or SUPPRESS_RE.search(cont):
                        break
                    reason.append(cont.lstrip("#").strip())
                    j += 1
                out.append((m.group(1), " ".join(r for r in reason if r),
                            i + 1))
            i -= 1
        return out


class Rule:
    """Base class: subclass, set ``name``/``description``, register.

    Per-file rules override :meth:`check_module`; whole-repo rules
    (cross-file state, doc sync) override :meth:`check_repo` and are fed
    the full module list once. ``scope`` (optional list of repo-relative
    prefixes) narrows which files a per-file rule sees — the legacy
    unbounded-await gate keeps its curated path list this way.

    ``options`` comes from the per-rule config dict the runner was given;
    rules read what they understand and ignore the rest.
    """

    name: str = ""
    description: str = ""
    scope: Optional[List[str]] = None

    def __init__(self, options: Optional[dict] = None):
        self.options = dict(options or {})
        if self.options.get("scope") is not None:
            self.scope = list(self.options["scope"])

    def in_scope(self, mod: Module) -> bool:
        if self.scope is None:
            return True
        return any(mod.rel == p or mod.rel.startswith(p.rstrip("/") + "/")
                   for p in self.scope)

    def check_module(self, mod: Module) -> List[Finding]:
        return []

    def check_repo(self, modules: List[Module], repo: str) -> List[Finding]:
        return []


_REGISTRY: Dict[str, Type[Rule]] = {}


def register(cls: Type[Rule]) -> Type[Rule]:
    """Class decorator adding a Rule to the global registry."""
    if not cls.name:
        raise ValueError(f"rule {cls.__name__} has no name")
    if cls.name in _REGISTRY:
        raise ValueError(f"duplicate rule name {cls.name!r}")
    _REGISTRY[cls.name] = cls
    return cls


def all_rules() -> Dict[str, Type[Rule]]:
    # importing .rules populates the registry exactly once
    from . import rules  # noqa: F401
    return dict(_REGISTRY)


def get_rule(name: str) -> Type[Rule]:
    rules = all_rules()
    if name not in rules:
        known = ", ".join(sorted(rules))
        raise KeyError(f"unknown rule {name!r} (known: {known})")
    return rules[name]


def iter_python_files(paths: Iterable[str]) -> List[str]:
    """Expand files/directories to a sorted list of ``.py`` files."""
    out: List[str] = []
    for root in paths:
        if root.endswith(".py"):
            # a default root that a tree lacks (a test's tmp repo) is
            # skipped; an explicit path was checked by the CLI
            if os.path.isfile(root):
                out.append(root)
            continue
        for dirpath, dirs, files in os.walk(root):
            dirs[:] = [d for d in dirs if d != "__pycache__"]
            out.extend(os.path.join(dirpath, fn)
                       for fn in sorted(files) if fn.endswith(".py"))
    return sorted(set(out))
