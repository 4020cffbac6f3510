"""dynalint dataflow: intra-procedural def-use chains + a torch device-taint
lattice, built on the parse-once :class:`~.core.Module` cache.

Two layers, both AST-only (no torch import — the analysis must run in the
test budget on machines with no accelerator stack):

1. **Def-use chains** (:func:`scope_bindings`, :func:`class_attr_bindings`):
   every binding of a local name / ``self.<attr>`` inside one function or
   class scope, in source order. Rules use these to resolve "where did this
   value come from" questions — e.g. the store-key-drift gate resolving an
   f-string key back to its keyspace helper.

2. **Device taint** (:class:`DeviceTaint`): a lattice ``host < devfn <
   devbox < device`` seeded by device *evidence* only, because in torch a
   host buffer is a tensor too (pinned staging slots, tier blocks,
   ``torch.from_numpy`` views, every tensor of an engine built for the
   CPU), and ``.item()`` on one of those is no sync. The seeds:

   - a tensor made with a ``device=`` that is not a CPU literal (the
     engine's device, ``"cuda"``), ``.cuda()``, ``.to(<device>)`` and the
     port's :func:`to_device`;
   - the KV pools and the weights (``k_pool``, ``v_pool``, ``params``,
     plus the ``device_attrs`` option), and any attribute assigned a
     device value anywhere in the module;
   - callables known to return device tensors (``devfn_attrs``: the paging
     lane's programs), the functions of the compute modules (``models``,
     ``ops.attention``, ``sampling``) applied to device values, the
     module's own functions whose return is device (a one-level summary),
     and every ``torch.*`` op or tensor method on a tainted value.

   ``device="cpu"``, ``pin_memory=True``, ``torch.from_numpy`` and the
   result of a sink stay host. Taint propagates through assignments,
   arithmetic, subscripts, containers (``append`` included), loops and
   comprehension targets until fixpoint.

The analysis is **flow-insensitive within a function** (a name tainted by
ANY binding stays tainted). Function parameters start untainted: a helper
that is handed a tensor cannot know where it lives, and flagging every
``float()`` of a parameter would bury the real transfers.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from .core import Module

# lattice points (host is represented as None)
DEVICE = "device"    # a tensor on the card
DEVFN = "devfn"      # a callable whose result is a DEVICE tensor
DEVBOX = "devbox"    # host container HOLDING device values: its truthiness
#                      and len() are host metadata (no sync), but
#                      subscripting it hands back a DEVICE value and
#                      converting it wholesale (np.asarray) syncs

#: attribute loads that read host-side metadata off a tensor — following
#: them does NOT transfer the buffer
HOST_META_ATTRS = {
    "shape", "dtype", "device", "is_cuda", "ndim", "layout", "is_pinned",
    "requires_grad", "nbytes", "itemsize", "names", "is_contiguous",
}

#: method calls on a tensor that read host metadata (no transfer)
HOST_META_METHODS = {
    "size", "dim", "numel", "stride", "data_ptr", "element_size",
    "is_contiguous", "get_device", "storage_offset", "nelement",
    "is_pinned", "untyped_storage", "query", "record", "elapsed_time",
    "wait_event", "wait_stream", "record_stream",
}

#: method calls on a device tensor whose RESULT lives on the host (the
#: host-sync rule reports them, the lattice drops taint)
HOST_RESULT_METHODS = {"item", "tolist", "numpy", "cpu"}

#: data-dependent-shape ops: the output size is read back to the host
SHAPE_SYNC_OPS = {"nonzero", "unique", "unique_consecutive",
                  "masked_select", "argwhere", "bincount"}

#: tensor methods that make a boolean mask (mask indexing is a sync)
MASK_METHODS = {"bool", "eq", "ne", "gt", "ge", "lt", "le", "isnan",
                "isinf", "isfinite", "logical_and", "logical_or",
                "logical_not", "logical_xor"}

#: resolved calls whose result is a HOST value whatever their arguments
HOST_RESULT_CALLS = {
    "int", "float", "bool", "len", "str", "repr", "isinstance", "print",
    "numpy.asarray", "numpy.array", "torch.from_numpy",
    "torch.Generator", "torch.device", "torch.cuda.Event",
    "torch.cuda.Stream", "torch.cuda.current_stream",
    "torch.cuda.default_stream", "torch.cuda.stream",
}

#: last segments of the port's helpers whose result is host data
HOST_RESULT_HELPERS = {"to_host_array", "host_dtype", "_to_host",
                       "d2h_pages"}

#: last segment of the port's upload helper (pinned, non-blocking)
DEVICE_HELPERS = {"to_device"}

#: module path components of the port's compute layers: their functions
#: applied to device values return device values
COMPUTE_MODULES = {"models", "llama", "moe", "siglip", "attention",
                   "sampling"}

#: attributes that hold device tensors (pools) or trees of them (weights)
DEFAULT_DEVICE_ATTRS = {"k_pool": DEVICE, "v_pool": DEVICE,
                        "params": DEVBOX}

#: torch dtype names (``.to(torch.float32)`` converts, it does not move)
TORCH_DTYPES = {
    "float", "double", "half", "bfloat16", "float16", "float32", "float64",
    "int", "long", "short", "int8", "int16", "int32", "int64", "uint8",
    "uint16", "uint32", "uint64", "bool", "complex64", "complex128",
    "float8_e4m3fn", "float8_e5m2",
}

#: factory calls that fill from host data: with a device they upload it
UPLOAD_FACTORIES = {"torch.tensor", "torch.as_tensor", "torch.asarray"}


# ---------------------------------------------------------------------------
# def-use chains
# ---------------------------------------------------------------------------

def iter_scope_statements(body: List[ast.stmt]) -> Iterator[ast.stmt]:
    """Statements of one function/class scope, recursing into compound
    statements but NOT into nested function/class definitions (those are
    their own scopes). The nested def/class statement itself IS yielded."""
    for stmt in body:
        yield stmt
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        for _f, value in ast.iter_fields(stmt):
            if isinstance(value, list) and value \
                    and isinstance(value[0], ast.stmt):
                yield from iter_scope_statements(value)
            elif isinstance(value, list) and value \
                    and isinstance(value[0], ast.excepthandler):
                for h in value:
                    yield from iter_scope_statements(h.body)


def iter_scope_nodes(body: List[ast.stmt]) -> Iterator[ast.AST]:
    """Every AST node of one scope, visited exactly once, with nested
    function/class/lambda BODIES pruned (the scope-introducing node itself
    is yielded — its name binding is visible here — but nothing inside
    it). This is the walker scope-sensitive rules need: ``ast.walk`` over
    statements double-visits compound-statement bodies and leaks into
    nested scopes."""
    stack: List[ast.AST] = list(reversed(body))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue        # the binding is visible; the body is not
        stack.extend(ast.iter_child_nodes(node))


def _binding_pairs(stmt: ast.stmt) -> List[Tuple[ast.expr, ast.expr, str]]:
    """(target, value, via) bindings introduced by one statement. ``via``
    is 'assign' | 'aug' | 'for' | 'with' — loop/with bindings bind each
    ELEMENT of the iterable, which taint consumers treat differently."""
    out: List[Tuple[ast.expr, ast.expr, str]] = []
    if isinstance(stmt, ast.Assign):
        for t in stmt.targets:
            out.append((t, stmt.value, "assign"))
    elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
        out.append((stmt.target, stmt.value, "assign"))
    elif isinstance(stmt, ast.AugAssign):
        out.append((stmt.target, stmt.value, "aug"))
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        out.append((stmt.target, stmt.iter, "for"))
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        for item in stmt.items:
            if item.optional_vars is not None:
                out.append((item.optional_vars, item.context_expr, "with"))
    return out


def scope_bindings(func: ast.AST) -> Dict[str, List[Tuple[ast.expr, str]]]:
    """{local name: [(value_expr, via), ...]} for one function scope, in
    source order. Tuple targets bind every name to the whole value (the
    consumer decides how to project). Walrus (:=) bindings included."""
    out: Dict[str, List[Tuple[ast.expr, str]]] = {}

    def bind(target: ast.expr, value: ast.expr, via: str) -> None:
        for node in ast.walk(target):
            if isinstance(node, ast.Name) \
                    and isinstance(node.ctx, ast.Store):
                out.setdefault(node.id, []).append((value, via))

    body = func.body if hasattr(func, "body") else []
    for stmt in iter_scope_statements(body):
        for target, value, via in _binding_pairs(stmt):
            bind(target, value, via)
        # walrus anywhere inside the statement's expressions
        for node in ast.walk(stmt):
            if isinstance(node, ast.NamedExpr):
                bind(node.target, node.value, "assign")
    return out


def class_attr_bindings(cls: ast.ClassDef
                        ) -> Dict[str, List[Tuple[ast.expr, str]]]:
    """{attr: [(value_expr, via), ...]} for every ``self.<attr> = ...``
    across all methods of one class (plus class-level assignments)."""
    out: Dict[str, List[Tuple[ast.expr, str]]] = {}

    def scan(body: List[ast.stmt]) -> None:
        for stmt in iter_scope_statements(body):
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scan(stmt.body)
                continue
            for target, value, via in _binding_pairs(stmt):
                for node in ast.walk(target):
                    if isinstance(node, ast.Attribute) and isinstance(
                            node.value, ast.Name) \
                            and node.value.id == "self" \
                            and isinstance(node.ctx, ast.Store):
                        out.setdefault(node.attr, []).append((value, via))

    scan(cls.body)
    return out


# ---------------------------------------------------------------------------
# device taint
# ---------------------------------------------------------------------------

class SinkHit:
    """One device→host synchronization point found by the taint sweep."""

    __slots__ = ("node", "label", "func_name")

    def __init__(self, node: ast.AST, label: str, func_name: str):
        self.node = node
        self.label = label          # e.g. ".item()", ".cpu()", "truthiness"
        self.func_name = func_name  # qualified enclosing function


def _last_segment(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def _kw(call: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _is_true(expr: Optional[ast.expr]) -> bool:
    return isinstance(expr, ast.Constant) and expr.value is True


def _terminal_name(expr: ast.expr) -> str:
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        return expr.attr
    return ""


def device_target(mod: Module, expr: Optional[ast.expr]) -> Optional[str]:
    """What a device argument names: ``"cpu"``, ``"device"`` (anything
    else that is evidently a device: ``"cuda"``, ``self.device``, ``dev``,
    ``torch.device(...)``) or None (a dtype, or nothing evident)."""
    if expr is None:
        return None
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return "cpu" if expr.value.split(":")[0] == "cpu" else "device"
    if isinstance(expr, ast.Call):
        if mod.resolve_call(expr) == "torch.device":
            if expr.args:
                inner = device_target(mod, expr.args[0])
                return inner or "device"
            return "device"
        return None
    name = _terminal_name(expr)
    if not name or name in TORCH_DTYPES or "dtype" in name:
        return None
    if name in ("device", "dev", "d", "cuda") or name.endswith(
            ("device", "_dev")):
        return "device"
    return None


def _is_mask_shaped(expr: ast.expr) -> bool:
    if isinstance(expr, ast.Compare):
        return not all(isinstance(op, (ast.Is, ast.IsNot))
                       for op in expr.ops)
    if isinstance(expr, ast.UnaryOp):
        return isinstance(expr.op, (ast.Invert, ast.Not))
    if isinstance(expr, ast.BinOp):
        return isinstance(expr.op, (ast.BitAnd, ast.BitOr, ast.BitXor)) \
            and (_is_mask_shaped(expr.left) or _is_mask_shaped(expr.right))
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute):
        return expr.func.attr in MASK_METHODS
    return False


def _holds_list_literal(expr: ast.expr) -> bool:
    if isinstance(expr, (ast.List, ast.ListComp)):
        return True
    if isinstance(expr, ast.Tuple):
        return any(isinstance(e, (ast.List, ast.ListComp))
                   for e in expr.elts)
    return False


def _project(pairs: List[Tuple[ast.expr, ast.expr, str]]
             ) -> List[Tuple[ast.expr, ast.expr, str]]:
    """Split literal unpacks position by position: ``a, b = x, y`` binds
    ``a`` to ``x`` only, and ``for n, t in (("q", q), ("k", k))`` binds
    ``t`` to ``q`` and ``k`` only (the name is not a device value just
    because a sibling position holds one)."""
    out: List[Tuple[ast.expr, ast.expr, str]] = []
    seqs = (ast.Tuple, ast.List)
    for target, value, via in pairs:
        if not isinstance(target, seqs) or any(
                isinstance(e, ast.Starred) for e in target.elts):
            out.append((target, value, via))
            continue
        n = len(target.elts)
        if via in ("assign", "with") and isinstance(value, seqs) \
                and len(value.elts) == n:
            out.extend(_project([(t, v, via) for t, v in
                                 zip(target.elts, value.elts)]))
        elif via == "for" and isinstance(value, seqs) and value.elts \
                and all(isinstance(e, seqs) and len(e.elts) == n
                        for e in value.elts):
            for row in value.elts:
                out.extend(_project([(t, v, "assign") for t, v in
                                     zip(target.elts, row.elts)]))
        else:
            out.append((target, value, via))
    return out


def get_device_taint(mod: Module, options: Optional[dict] = None
                     ) -> "DeviceTaint":
    """Per-module DeviceTaint, cached on the Module (options only vary the
    seeds, so they key the cache)."""
    key = tuple(sorted(
        (k, tuple(v) if isinstance(v, (list, set, tuple)) else v)
        for k, v in (options or {}).items()
        if k in ("device_attrs", "devfn_attrs", "card_only")))
    cache = getattr(mod, "_taint_cache", None)
    if cache is None:
        cache = mod._taint_cache = {}
    if key not in cache:
        cache[key] = DeviceTaint(mod, options)
    return cache[key]


class DeviceTaint:
    """Module-wide device-taint index + per-function analysis.

    Construction walks the module once to build:

    - ``attr_tags``: attribute names assigned a DEVICE/DEVBOX/DEVFN value
      anywhere in the module (``self.k_pool``, ``self._inflight``), over
      the defaults (``k_pool``/``v_pool`` DEVICE, ``params`` DEVBOX);
    - ``summaries``: function name -> lattice tag of its return value,
      iterated to fixpoint so methods that return device results taint
      their own call sites.

    Options (all additive): ``device_attrs`` — attribute names assumed
    device-resident; ``devfn_attrs`` — attribute names holding callables
    that return device tensors ACROSS module boundaries (the paging
    lane's programs, built in ``programs.py``); ``card_only`` — the module
    runs only on a card (the kernel probes), so the compute modules'
    functions return device tensors whatever their arguments.

    A function that allocates on one of its tensor parameters' device
    (``torch.empty(..., device=x.device)``, ``dev = x.device``) states
    where its tensors live: its ``torch.Tensor`` parameters are taken to
    be co-located on that device (torch ops need their operands on one
    device).
    """

    MAX_PASSES = 4

    def __init__(self, mod: Module, options: Optional[dict] = None):
        options = options or {}
        self.mod = mod
        self.attr_tags: Dict[str, str] = dict(DEFAULT_DEVICE_ATTRS)
        self.attr_tags.update(
            {a: DEVICE for a in options.get("device_attrs", ())})
        self.attr_tags.update(
            {a: DEVFN for a in options.get("devfn_attrs", ())})
        self.card_only = bool(options.get("card_only"))
        self.global_tags: Dict[str, str] = {}
        self.summaries: Dict[str, Optional[str]] = {}
        self._env_cache: Dict[int, Dict[str, str]] = {}
        self._prog_cache: Dict[int, dict] = {}
        self._shim_cache: Dict[int, ast.AST] = {}
        self._functions: List[ast.AST] = [
            n for n in mod.nodes()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        self._module_fixpoint()

    # -- per-scope program cache -------------------------------------------
    def _prog(self, scope: ast.AST) -> dict:
        """One-time extraction of everything the fixpoint passes consume
        from a scope: bindings, attr stores, container appends, walrus +
        comprehension targets, return exprs. The fixpoint then iterates
        these flat lists instead of re-walking the AST on every pass."""
        prog = self._prog_cache.get(id(scope))
        if prog is not None:
            return prog
        binds: List[Tuple[List[str], List[str], ast.expr, str, bool]] = []
        named: List[Tuple[str, ast.expr]] = []
        comps: List[Tuple[List[str], ast.expr]] = []
        appends: List[ast.Call] = []
        returns: List[ast.expr] = []
        for stmt in iter_scope_statements(scope.body):
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, ast.Return) and stmt.value is not None:
                returns.append(stmt.value)
            for target, value, via in _project(_binding_pairs(stmt)):
                names, attrs = [], []
                for t in ast.walk(target):
                    if not isinstance(getattr(t, "ctx", None), ast.Store):
                        continue
                    if isinstance(t, ast.Name):
                        names.append(t.id)
                    elif isinstance(t, ast.Attribute):
                        attrs.append(t.attr)
                unpack = isinstance(target, (ast.Tuple, ast.List))
                binds.append((names, attrs, value, via, unpack))
            for node in ast.walk(stmt):
                if isinstance(node, ast.NamedExpr):
                    named.append((node.target.id, node.value))
                elif isinstance(node, (ast.ListComp, ast.SetComp,
                                       ast.GeneratorExp, ast.DictComp)):
                    for comp in node.generators:
                        tnames = [t.id for t in ast.walk(comp.target)
                                  if isinstance(t, ast.Name)]
                        comps.append((tnames, comp.iter))
                elif isinstance(node, ast.Call) and isinstance(
                        node.func, ast.Attribute) \
                        and node.func.attr in ("append", "appendleft",
                                               "add", "extend") \
                        and isinstance(node.func.value,
                                       (ast.Attribute, ast.Name)) \
                        and node.args:
                    appends.append(node)
        prog = {"binds": binds, "named": named, "comps": comps,
                "appends": appends, "returns": returns}
        self._prog_cache[id(scope)] = prog
        return prog

    # -- module fixpoint ---------------------------------------------------
    def _module_fixpoint(self) -> None:
        module_scope = ast.Module(body=self.mod.tree.body, type_ignores=[])
        rank = {DEVICE: 3, DEVBOX: 2, DEVFN: 1}
        for _ in range(self.MAX_PASSES):
            changed = False
            # per-pass cache only: envs depend on attr_tags/summaries,
            # which this pass may still be growing
            self._env_cache.clear()
            for scope in [module_scope] + self._functions:
                if scope is module_scope:
                    env = dict(self.global_tags)
                else:
                    env = self._function_env(scope)
                changed |= self._scan_stores(scope, env,
                                             scope is module_scope)
                # function summaries (DEVICE beats DEVBOX beats DEVFN)
                if scope is not module_scope:
                    tag = None
                    for value in self._prog(scope)["returns"]:
                        t = self.evaluate(value, env)
                        if t is not None and rank[t] > rank.get(tag, 0):
                            tag = t
                    if tag is not None \
                            and self.summaries.get(scope.name) != tag:
                        self.summaries[scope.name] = tag
                        changed = True
            if not changed:
                break

    def _scan_stores(self, scope: ast.AST, env: Dict[str, str],
                     module_level: bool) -> bool:
        """Record attr/global tags from one scope's stores + appends."""
        changed = False
        prog = self._prog(scope)
        binds = prog["binds"]
        for k, (names, attrs, value, via, unpack) in enumerate(binds):
            if not attrs and not (module_level and names):
                continue
            tag = self._reaching_tag(binds, k, env) \
                if isinstance(value, ast.Name) and via == "assign" \
                else self._bound_tag(value, env, via, unpack)
            if tag is None:
                continue
            for attr in attrs:
                if self.attr_tags.get(attr) not in (tag, DEVICE):
                    self.attr_tags[attr] = tag
                    changed = True
            if module_level:
                for name in names:
                    if self.global_tags.get(name) != tag:
                        self.global_tags[name] = tag
                        changed = True
        # device containers filled via .append/.appendleft/.add/.extend
        for node in prog["appends"]:
            holder = node.func.value
            if isinstance(holder, ast.Attribute) and self.evaluate(
                    node.args[0], env) in (DEVICE, DEVBOX):
                if self.attr_tags.get(holder.attr) not in (DEVICE, DEVBOX):
                    self.attr_tags[holder.attr] = DEVBOX
                    changed = True
        return changed

    def _reaching_tag(self, binds: list, k: int, env: Dict[str, str]
                      ) -> Optional[str]:
        """Tag of ``self.x = name`` from the binding of ``name`` that
        precedes it in the scope (a local reused for a host value later,
        ``tok = int(arr[...])``, must not taint the attribute with its
        earlier device binding); the whole-scope tag when none does."""
        name = binds[k][2].id
        for names, _attrs, value, via, unpack in reversed(binds[:k]):
            if name in names:
                return self._bound_tag(value, env, via, unpack)
        return self.evaluate(binds[k][2], env)

    def _bound_tag(self, value: ast.expr, env: Dict[str, str], via: str,
                   unpack: bool) -> Optional[str]:
        """The tag a binding gives its target: a loop over (or an unpack
        of) a container of device values binds device values."""
        tag = self.evaluate(value, env)
        if tag == DEVBOX and (via == "for" or unpack):
            return DEVICE
        return tag

    # -- per-function analysis --------------------------------------------
    def _function_env(self, func: ast.AST,
                      outer: Optional[Dict[str, str]] = None
                      ) -> Dict[str, str]:
        """Union (flow-insensitive) taint env for one function scope,
        iterated to local fixpoint."""
        if outer is None and id(func) in self._env_cache:
            return self._env_cache[id(func)]
        env: Dict[str, str] = dict(outer or {})
        # parameters are fresh local bindings: they SHADOW any same-named
        # device value inherited from an enclosing scope
        args = getattr(func, "args", None)
        if args is not None:
            for a in (list(args.posonlyargs) + list(args.args)
                      + list(args.kwonlyargs)
                      + [x for x in (args.vararg, args.kwarg) if x]):
                env.pop(a.arg, None)
            for name in self._colocated_params(func):
                env[name] = DEVICE
        prog = self._prog(func)

        def join(name: str, tag: Optional[str]) -> bool:
            if tag and env.get(name) not in (tag, DEVICE):
                env[name] = tag
                return True
            return False

        for _ in range(self.MAX_PASSES):
            changed = False
            for names, _attrs, value, via, unpack in prog["binds"]:
                if names:
                    tag = self._bound_tag(value, env, via, unpack)
                    for name in names:
                        changed |= join(name, tag)
            for name, value in prog["named"]:
                changed |= join(name, self.evaluate(value, env))
            for tnames, it in prog["comps"]:
                tag = self.evaluate(it, env)
                if tag == DEVBOX:
                    tag = DEVICE
                for name in tnames:
                    changed |= join(name, tag)
            for node in prog["appends"]:
                holder = node.func.value
                if isinstance(holder, ast.Name) and self.evaluate(
                        node.args[0], env) in (DEVICE, DEVBOX):
                    changed |= join(holder.id, DEVBOX)
            if not changed:
                break
        if outer is None:
            self._env_cache[id(func)] = env
        return env

    def _colocated_params(self, func: ast.AST) -> Set[str]:
        """Tensor parameters of ``func`` that its own allocations place on
        the card: some ``device=`` (or ``.to(...)``) names a parameter's
        ``.device``, directly or through a local bound to it."""
        args = func.args
        params = {a.arg: a for a in (list(args.posonlyargs)
                                     + list(args.args)
                                     + list(args.kwonlyargs))
                  if a.arg not in ("self", "cls")}
        if not params or not isinstance(getattr(func, "body", None), list):
            return set()

        def param_device(expr: Optional[ast.expr]) -> Optional[str]:
            if isinstance(expr, ast.Attribute) and expr.attr == "device" \
                    and isinstance(expr.value, ast.Name) \
                    and expr.value.id in params:
                return expr.value.id
            return None

        aliases: Dict[str, str] = {}
        nodes = list(iter_scope_nodes(func.body))
        for node in nodes:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                p = param_device(node.value)
                if p is not None:
                    aliases[node.targets[0].id] = p
        anchor = None
        for node in nodes:
            if not isinstance(node, ast.Call):
                continue
            cands = [_kw(node, "device")]
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "to" and node.args:
                cands.append(node.args[0])
            for c in cands:
                p = param_device(c) or (aliases.get(c.id) if isinstance(
                    c, ast.Name) else None)
                if p is not None:
                    anchor = p
                    break
            if anchor is not None:
                break
        if anchor is None:
            return set()
        out = {anchor}
        for name, a in params.items():
            if a.annotation is not None \
                    and "Tensor" in ast.unparse(a.annotation):
                out.add(name)
        return out

    def evaluate(self, expr: ast.expr, env: Dict[str, str]
                 ) -> Optional[str]:
        """Lattice tag of an expression under ``env`` (None = host)."""
        if isinstance(expr, ast.Name):
            return env.get(expr.id) or self.global_tags.get(expr.id)
        if isinstance(expr, ast.Attribute):
            if expr.attr in HOST_META_ATTRS:
                return None
            base = self.evaluate(expr.value, env)
            if base is not None:
                return base
            return self.attr_tags.get(expr.attr)
        if isinstance(expr, ast.Subscript):
            base = self.evaluate(expr.value, env)
            if base == DEVBOX:
                return DEVICE      # an element handed out of the container
            return base
        if isinstance(expr, ast.Await):
            return self.evaluate(expr.value, env)
        if isinstance(expr, ast.BinOp):
            return (self.evaluate(expr.left, env)
                    or self.evaluate(expr.right, env))
        if isinstance(expr, ast.UnaryOp):
            if isinstance(expr.op, ast.Not):
                return None        # `not t` is a host bool (a sink)
            return self.evaluate(expr.operand, env)
        if isinstance(expr, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in expr.ops):
                return None        # identity: no tensor op at all
            for e in [expr.left] + list(expr.comparators):
                if self.evaluate(e, env) == DEVICE:
                    return DEVICE
            return None
        if isinstance(expr, ast.BoolOp):
            for e in expr.values:
                t = self.evaluate(e, env)
                if t is not None:
                    return t
            return None
        if isinstance(expr, ast.IfExp):
            return (self.evaluate(expr.body, env)
                    or self.evaluate(expr.orelse, env))
        if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
            for e in expr.elts:
                if self.evaluate(e, env) in (DEVICE, DEVBOX):
                    return DEVBOX
            return None
        if isinstance(expr, ast.Dict):
            for e in expr.values:
                if e is not None and self.evaluate(e, env) in (DEVICE,
                                                               DEVBOX):
                    return DEVBOX
            return None
        if isinstance(expr, ast.Starred):
            return self.evaluate(expr.value, env)
        if isinstance(expr, ast.Call):
            return self._call_tag(expr, env)
        return None

    def _args_tainted(self, call: ast.Call, env: Dict[str, str]) -> bool:
        return any(self.evaluate(a, env) in (DEVICE, DEVBOX)
                   for a in list(call.args)
                   + [kw.value for kw in call.keywords])

    def _call_tag(self, call: ast.Call, env: Dict[str, str]
                  ) -> Optional[str]:
        resolved = self.mod.resolve_call(call)
        last = _last_segment(resolved)
        if resolved in HOST_RESULT_CALLS or last in HOST_RESULT_HELPERS:
            return None
        if last in DEVICE_HELPERS:
            return DEVICE
        if _is_true(_kw(call, "pin_memory")):
            return None
        dev = _kw(call, "device")
        if dev is not None:
            return None if device_target(self.mod, dev) == "cpu" \
                else DEVICE
        f = call.func
        if isinstance(f, ast.Attribute):
            if f.attr in HOST_RESULT_METHODS or f.attr == "pin_memory":
                return None          # host results (the sinks)
            if f.attr == "cuda":
                return DEVICE
            if f.attr in HOST_META_METHODS:
                return None
            if f.attr == "to" and call.args:
                target = device_target(self.mod, call.args[0])
                if target == "cpu":
                    return None
                if target == "device":
                    return DEVICE
            # the attribute itself may BE a device callable (prg.head)
            if self.evaluate(f, env) == DEVFN:
                return DEVICE
            base = self.evaluate(f.value, env)
            if base in (DEVFN, DEVICE):
                # a method of a device tensor (.float(), .view(), ...)
                return DEVICE
            if base == DEVBOX:
                # .popleft()/.pop()/.get() hand out container contents —
                # which may themselves be containers (dicts of tensors)
                return DEVBOX
        elif isinstance(f, (ast.Name, ast.Subscript, ast.Call)):
            if self.evaluate(f, env) == DEVFN:
                return DEVICE
        if resolved.startswith("torch."):
            if resolved.startswith("torch.cuda."):
                return None
            # a torch op over device tensors runs on the device
            return DEVICE if self._args_tainted(call, env) else None
        if COMPUTE_MODULES.intersection(resolved.split(".")[:-1]):
            # the port's model/kernel/sampling functions over device values
            return DEVICE if (self.card_only or self._args_tainted(
                call, env)) else None
        if resolved in ("dict", "list", "tuple", "deque",
                        "collections.deque"):
            return DEVBOX if self._args_tainted(call, env) else None
        summary = self.summaries.get(last)
        if summary is not None:
            return summary
        return None

    # -- sink sweep --------------------------------------------------------
    def sink_hits(self, func: ast.AST, qualname: str,
                  outer_env: Optional[Dict[str, str]] = None
                  ) -> List[SinkHit]:
        """Device→host sync points inside one function scope (nested defs
        are visited with the enclosing env inherited, attributed to the
        same qualname — a closure fetching device state is still a sync)."""
        env = self._function_env(func, outer_env)
        hits: List[SinkHit] = []
        nested: List[ast.AST] = []

        def walk(node: ast.AST) -> Iterator[ast.AST]:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda)):
                    nested.append(child)
                    continue
                yield child
                yield from walk(child)

        for stmt in func.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # a statement-level closure is a nested scope like any
                # other — its body must NOT be scanned under this env
                nested.append(stmt)
                continue
            for node in [stmt] + list(walk(stmt)):
                hit = self._sink_label(node, env)
                if hit:
                    hits.append(SinkHit(node, hit, qualname))
        for nfunc in nested:
            # shims are cached by the ORIGINAL node (which the Module
            # keeps alive): a transient shim freed between sweeps could
            # otherwise recycle its id() into a stale _prog/_env entry
            shim = self._shim_cache.get(id(nfunc))
            if shim is None:
                body = nfunc.body if isinstance(nfunc.body, list) \
                    else [ast.Expr(nfunc.body)]
                shim = ast.FunctionDef(
                    name=getattr(nfunc, "name", "<lambda>"), body=body,
                    args=nfunc.args, decorator_list=[], returns=None)
                self._shim_cache[id(nfunc)] = shim
            hits.extend(self.sink_hits(shim, qualname, env))
        return hits

    def _sink_label(self, node: ast.AST, env: Dict[str, str]
                    ) -> Optional[str]:
        if isinstance(node, ast.Call):
            return self._call_sink(node, env)
        if isinstance(node, ast.Assign):
            # `dev[i, j] = 1`: the value becomes a host tensor that a
            # blocking copy uploads before the write
            if any(isinstance(t, ast.Subscript)
                   and self.evaluate(t.value, env) == DEVICE
                   for t in node.targets) \
                    and self._evidently_host(node.value):
                return "setitem upload"
            return None
        if isinstance(node, (ast.If, ast.While, ast.Assert, ast.IfExp)):
            if self.evaluate(node.test, env) == DEVICE:
                return "truthiness"
        elif isinstance(node, ast.BoolOp):
            if any(self.evaluate(v, env) == DEVICE
                   for v in node.values[:-1]):
                return "truthiness"
        elif isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            if self.evaluate(node.operand, env) == DEVICE:
                return "truthiness"
        elif isinstance(node, ast.Subscript):
            if self.evaluate(node.value, env) != DEVICE:
                return None
            if _is_mask_shaped(node.slice) \
                    and self.evaluate(node.slice, env) == DEVICE:
                return "mask index"
            if _holds_list_literal(node.slice):
                return "list index"   # the index list is uploaded first
        return None

    def _evidently_host(self, expr: ast.expr) -> bool:
        """A value that is host data by its spelling: a number, or what a
        host conversion returns (``int()``, numpy, ``.item()``...)."""
        if isinstance(expr, ast.UnaryOp):
            expr = expr.operand
        if isinstance(expr, ast.Constant):
            return isinstance(expr.value, (int, float, bool)) \
                and expr.value is not None
        if isinstance(expr, ast.Call):
            resolved = self.mod.resolve_call(expr)
            if resolved in ("int", "float", "bool", "torch.from_numpy") \
                    or resolved.startswith("numpy."):
                return True
            return isinstance(expr.func, ast.Attribute) \
                and expr.func.attr in HOST_RESULT_METHODS
        return False

    def _call_sink(self, call: ast.Call, env: Dict[str, str]
                   ) -> Optional[str]:
        resolved = self.mod.resolve_call(call)
        last = _last_segment(resolved)
        f = call.func
        nonblocking = _is_true(_kw(call, "non_blocking"))
        if resolved == "torch.cuda.synchronize":
            return "torch.cuda.synchronize()"
        if isinstance(f, ast.Attribute):
            attr = f.attr
            if attr == "synchronize":
                # an event/stream barrier: the host waits for the card
                return ".synchronize()"
            base = self.evaluate(f.value, env)
            if attr in HOST_RESULT_METHODS and base == DEVICE:
                return f".{attr}()"
            if attr in SHAPE_SYNC_OPS and base == DEVICE:
                return f".{attr}()"
            if attr == "repeat_interleave" and base == DEVICE \
                    and _kw(call, "output_size") is None:
                return ".repeat_interleave()"
            if attr in ("to", "cuda") and not nonblocking:
                target = (device_target(self.mod, call.args[0])
                          if call.args else None)
                kwdev = _kw(call, "device")
                if kwdev is not None:
                    target = device_target(self.mod, kwdev)
                if attr == "cuda":
                    target = "device"
                if target == "cpu" and base == DEVICE:
                    return ".to(cpu)"
                if target == "device" and base is None:
                    # a blocking upload: a pageable copy waits for the
                    # stream to drain
                    return f".{attr}(device)"
        if resolved in UPLOAD_FACTORIES and call.args:
            dev = _kw(call, "device")
            if dev is not None and device_target(self.mod, dev) != "cpu" \
                    and self.evaluate(call.args[0], env) is None:
                return f"{resolved}(device=)"
        if not call.args:
            return None
        arg0 = call.args[0]
        tag0 = self.evaluate(arg0, env)
        if resolved in ("int", "float", "bool"):
            # container truthiness/len is host metadata — only a DEVICE
            # tensor here forces the sync
            if tag0 == DEVICE:
                return f"{resolved}()"
        elif resolved in ("numpy.asarray", "numpy.array"):
            if tag0 in (DEVICE, DEVBOX):
                return f"np.{last}"
        elif resolved.startswith("torch.") and tag0 == DEVICE:
            if last in SHAPE_SYNC_OPS or last in ("equal", "allclose"):
                return f"torch.{last}"
            if last == "repeat_interleave" \
                    and _kw(call, "output_size") is None:
                return "torch.repeat_interleave"
            if last == "where" and len(call.args) == 1:
                return "torch.where(cond)"
        return None

    # -- helpers for rules -------------------------------------------------
    def qualname(self, func: ast.AST) -> str:
        parts = [getattr(func, "name", "<lambda>")]
        parents = self.mod.parents()
        cur = func
        while cur in parents:
            cur = parents[cur]
            if isinstance(cur, ast.ClassDef):
                parts.append(cur.name)
            elif isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                parts.append(cur.name)
        return ".".join(reversed(parts))

    def top_level_functions(self) -> List[ast.AST]:
        """Functions that are not nested inside another function (methods
        count as top-level; their nested defs are swept by sink_hits)."""
        parents = self.mod.parents()
        out = []
        for f in self._functions:
            cur = parents.get(f)
            nested = False
            while cur is not None:
                if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    nested = True
                    break
                cur = parents.get(cur)
            if not nested:
                out.append(f)
        return out
