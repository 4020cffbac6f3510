"""A reader of the block-mapping subset of YAML that serving configs use.

The configs ``cli.serve`` reads (``examples/configs/{agg,agg_router,disagg,
disagg_router}.yaml``) are sections of ``key: value`` lines, a nested
mapping or two (``resources:``), comments, and quoted and bare scalars. The
card's machine has no PyYAML, so the port reads that subset itself:

- block mappings at any depth, each level indented further than its key
  (spaces only), keys unique within a mapping;
- plain scalars, resolved as YAML 1.1 (PyYAML's ``safe_load``) resolves
  them: ``~``/``null``/empty to None, ``true``/``yes``/``on`` (and their
  capitalised forms) and the ``false`` set to bools, decimal integers,
  decimal floats with a point (``1.5``, ``2.``, ``1.0e+3``) and
  ``.inf``/``.nan``, everything else to a string;
- single-quoted (``''`` is a quote) and double-quoted scalars (the usual
  backslash escapes) on one line, always strings;
- ``#`` comments on a line of their own or after a value.

Everything else is refused with its line number: sequences, flow
collections, block scalars (``|``, ``>``), anchors, aliases, tags,
directives, document markers, multi-line scalars, merge keys, tabs in
indentation, and the plain forms YAML 1.1 reads in ways easy to misread
(octal, hex, binary, underscores, sexagesimal, dates). A config outside the
subset fails loudly; it is never read differently from ``yaml.safe_load``.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Tuple

_NULLS = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)\Z")
_FLOAT = re.compile(r"[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?\Z")
_INF = re.compile(r"([-+]?)\.(?:inf|Inf|INF)\Z")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)\Z")
# what YAML 1.1 reads as a number or a date beyond the forms above
_INT11 = re.compile(r"[-+]?(?:0b[0-1_]+|0[0-7_]+|(?:0|[1-9][0-9_]*)"
                    r"|0x[0-9a-fA-F_]+|[1-9][0-9_]*(?::[0-5]?[0-9])+)\Z")
_FLOAT11 = re.compile(r"(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                      r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                      r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*)\Z")
_DATE = re.compile(r"[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\"}
_HEX = {"x": 2, "u": 4, "U": 8}
# characters that cannot start a plain scalar (YAML 1.1 indicators); - ? :
# may, when a non-space follows
_INDICATORS = ",[]{}#&*!|>'\"%@`"


class YamlSubsetError(ValueError):
    """A config outside the subset: ``line`` is 1-based."""

    def __init__(self, line: int, message: str):
        super().__init__(f"line {line}: {message}")
        self.line = line


def _resolve(text: str, line: int) -> Any:
    """A plain scalar's value, as YAML 1.1 resolves it."""
    if text in _NULLS:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    m = _INF.match(text)
    if m:
        return -math.inf if m.group(1) == "-" else math.inf
    if _NAN.match(text):
        return math.nan
    if _INT11.match(text) or _FLOAT11.match(text) or _DATE.match(text):
        raise YamlSubsetError(line, f"{text!r}: a YAML 1.1 number or date "
                                    f"form outside the subset (quote it)")
    if text in ("=", "<<"):
        raise YamlSubsetError(line, f"{text!r}: a value/merge key")
    return text


def _quoted(s: str, line: int) -> Tuple[str, str]:
    """A quoted scalar at the start of ``s``: (value, the rest)."""
    q = s[0]
    out: List[str] = []
    i = 1
    while i < len(s):
        c = s[i]
        if q == "'":
            if c == "'":
                if s[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), s[i + 1:]
            out.append(c)
            i += 1
            continue
        if c == '"':
            return "".join(out), s[i + 1:]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        e = s[i + 1:i + 2]
        if e in _ESCAPES:
            out.append(_ESCAPES[e])
            i += 2
        elif e in _HEX:
            digits = s[i + 2:i + 2 + _HEX[e]]
            if not re.fullmatch(r"[0-9a-fA-F]{%d}" % _HEX[e], digits):
                raise YamlSubsetError(line, f"bad \\{e} escape")
            out.append(chr(int(digits, 16)))
            i += 2 + _HEX[e]
        else:
            raise YamlSubsetError(line, f"escape \\{e or '<end>'} is outside "
                                        f"the subset")
    raise YamlSubsetError(line, "a quoted scalar must close on its own line")


def _after_quoted(rest: str, line: int) -> None:
    """Only spaces and a comment may follow a quoted scalar."""
    stripped = rest.lstrip(" \t")
    if stripped and not (stripped.startswith("#") and stripped != rest):
        raise YamlSubsetError(line, f"unexpected {stripped!r} after a "
                                    f"quoted scalar")


def _plain(s: str, line: int, what: str) -> str:
    """A plain scalar (comment cut, trailing spaces stripped)."""
    m = re.search(r"[ \t]#", s)
    if m:
        s = s[:m.start()]
    s = s.rstrip(" \t")
    if not s:
        return s
    c, nxt = s[0], s[1:2]
    if c in _INDICATORS or (c in "-?:" and nxt in ("", " ", "\t")):
        raise YamlSubsetError(line, f"{what} {s!r} starts with {c!r}: "
                                    f"sequences, flow collections, block "
                                    f"scalars, anchors, aliases, tags and "
                                    f"complex keys are outside the subset")
    if re.search(r":(?:[ \t]|\Z)", s):
        raise YamlSubsetError(line, f"{what} {s!r} holds a ': ' (a mapping "
                                    f"inside a value)")
    return s


def _split_key(body: str, line: int) -> Tuple[str, str]:
    """``key: rest`` -> (key, rest)."""
    if body[0] in "'\"":
        key, rest = _quoted(body, line)
        rest = rest.lstrip(" \t")
        if not rest.startswith(":") or rest[1:2] not in ("", " ", "\t"):
            raise YamlSubsetError(line, f"expected ':' after the key "
                                        f"{key!r}")
        return key, rest[1:]
    m = re.search(r":(?:[ \t]|\Z)", body)
    hash_at = re.search(r"[ \t]#", body)
    if m is None or (hash_at is not None and hash_at.start() < m.start()):
        raise YamlSubsetError(line, f"{body.strip()!r} is not a 'key: "
                                    f"value' line")
    raw = _plain(body[:m.start()], line, "key")
    key = _resolve(raw, line)
    if not isinstance(key, str):
        raise YamlSubsetError(line, f"key {raw!r} is not a string (quote "
                                    f"it)")
    return key, body[m.end():]


def loads(text: str) -> Dict[str, Any]:
    """The mapping a config in the subset holds ({} for an empty one)."""
    if text.startswith("\ufeff"):
        text = text[1:]
    # (line number, indent, body) of every line that carries content
    content: List[Tuple[int, int, str]] = []
    for n, raw in enumerate(text.split("\n"), 1):
        raw = raw.rstrip("\r")
        body = raw.lstrip(" ")
        stripped = body.strip(" \t")
        if not stripped or stripped.startswith("#"):
            continue
        if body[0] == "\t":
            raise YamlSubsetError(n, "tabs in indentation")
        indent = len(raw) - len(body)
        if indent == 0 and body.startswith(("---", "...", "%")):
            raise YamlSubsetError(n, "directives and document markers are "
                                     "outside the subset")
        content.append((n, indent, body))
    root: Dict[str, Any] = {}
    if not content:
        return root
    # stack of (indent, mapping); a key awaiting a nested mapping is
    # ``pending`` = (its indent, its mapping, the key)
    stack: List[Tuple[int, Dict[str, Any]]] = [(content[0][1], root)]
    pending: Optional[Tuple[int, Dict[str, Any], str]] = None
    for n, indent, body in content:
        if pending is not None:
            p_indent, p_map, p_key = pending
            pending = None
            if indent > p_indent:
                child: Dict[str, Any] = {}
                p_map[p_key] = child
                stack.append((indent, child))
        while stack and indent < stack[-1][0]:
            stack.pop()
        if not stack or indent != stack[-1][0]:
            raise YamlSubsetError(n, "indentation matches no enclosing "
                                     "mapping (or continues a scalar over "
                                     "lines)")
        mapping = stack[-1][1]
        key, rest = _split_key(body, n)
        if key in mapping:
            raise YamlSubsetError(n, f"duplicate key {key!r}")
        value_s = rest.lstrip(" \t")
        if not value_s or value_s.startswith("#"):
            mapping[key] = None
            pending = (indent, mapping, key)
        elif value_s[0] in "'\"":
            value, after = _quoted(value_s, n)
            _after_quoted(after, n)
            mapping[key] = value
        else:
            mapping[key] = _resolve(_plain(value_s, n, "value"), n)
    return root

