"""A reader and a writer of the block subset of YAML that serving configs,
deployment resources, kubeconfigs and Kubernetes manifests use.

The configs ``cli.serve`` reads (``examples/configs/{agg,agg_router,disagg,
disagg_router}.yaml``) are sections of ``key: value`` lines, a nested
mapping or two (``resources:``), comments, and quoted and bare scalars; a
kubeconfig adds block sequences of mappings (``clusters:``, ``users:``,
``contexts:``). The card's machine has no PyYAML, so the port reads that
subset itself (:func:`loads`):

- block mappings at any depth, each level indented further than its key
  (spaces only), keys unique within a mapping; the document is a mapping;
- block sequences as a key's value, their ``- `` items at the key's
  indent or further: each item a scalar, a mapping whose first key shares
  the ``- `` line, or a nested sequence;
- the empty flow collections ``{}`` and ``[]`` as values (a kubeconfig's
  ``preferences: {}``);
- plain scalars, resolved as YAML 1.1 (PyYAML's ``safe_load``) resolves
  them: ``~``/``null``/empty to None, ``true``/``yes``/``on`` (and their
  capitalised forms) and the ``false`` set to bools, decimal integers,
  decimal floats with a point (``1.5``, ``2.``, ``1.0e+3``) and
  ``.inf``/``.nan``, everything else to a string;
- single-quoted (``''`` is a quote) and double-quoted scalars (the usual
  backslash escapes) on one line, always strings;
- ``#`` comments on a line of their own or after a value.

Everything else is refused with its line number: a document that is a
sequence, flow collections that are not empty, block scalars (``|``, ``>``), anchors,
aliases, tags, directives, document markers, multi-line scalars, merge
keys, tabs in indentation, and the plain forms YAML 1.1 reads in ways easy
to misread (octal, hex, binary, underscores, sexagesimal, dates). A config
outside the subset fails loudly; it is never read differently from
``yaml.safe_load``.

:func:`dumps` writes mappings, lists, strings, numbers, bools and None in
that block style (PyYAML's layout: a sequence at its key's indent), a
string plain only where the reader and ``yaml.safe_load`` both read it back
as that string and double-quoted otherwise, an empty mapping or list as
``{}`` or ``[]``: :func:`loads` reads what it writes as ``yaml.safe_load``
does.
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


_EMPTY = re.compile(r"(\{\}|\[\])(?:[ \t]+#.*)?[ \t]*\Z")


def _is_seq_item(body: str) -> bool:
    return body == "-" or body.startswith(("- ", "-\t"))


def _is_key(body: str, line: int) -> bool:
    """Whether ``body`` starts a ``key: value`` entry (else a scalar)."""
    if body[0] in "'\"":
        _, rest = _quoted(body, line)
        rest = rest.lstrip(" \t")
        return rest.startswith(":") and rest[1:2] in ("", " ", "\t")
    m = re.search(r":(?:[ \t]|\Z)", body)
    hash_at = re.search(r"[ \t]#", body)
    return m is not None and (hash_at is None or m.start() < hash_at.start())


def _scalar(body: str, line: int) -> Any:
    """The value on the rest of a line (a quoted or a plain scalar, or an
    empty ``{}`` / ``[]``)."""
    empty = _EMPTY.match(body)
    if empty:
        return {} if empty.group(1) == "{}" else []
    if body[0] in "'\"":
        value, after = _quoted(body, line)
        _after_quoted(after, line)
        return value
    return _resolve(_plain(body, line, "value"), line)


class _Lines:
    """The content lines, (line number, indent, body) each; a sequence
    item's content is re-read in place as a line of its own at the column
    it starts on."""

    def __init__(self, content: List[Tuple[int, int, str]]):
        self.items = content
        self.i = 0

    def peek(self) -> Optional[Tuple[int, int, str]]:
        return self.items[self.i] if self.i < len(self.items) else None


def _block(lines: _Lines, indent: int) -> Any:
    """The mapping or sequence whose first line is the next one, at
    ``indent``."""
    if _is_seq_item(lines.peek()[2]):
        return _sequence(lines, indent)
    return _mapping(lines, indent)


def _value_after_key(lines: _Lines, indent: int) -> Any:
    """A ``key:`` with nothing after it: the block below it (more indented,
    or a sequence at the key's own indent), else None."""
    nxt = lines.peek()
    if nxt is None:
        return None
    if nxt[1] > indent:
        return _block(lines, nxt[1])
    if nxt[1] == indent and _is_seq_item(nxt[2]):
        return _sequence(lines, indent)
    return None


def _mapping(lines: _Lines, indent: int) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    while True:
        cur = lines.peek()
        if cur is None or cur[1] < indent:
            return out
        n, ind, body = cur
        if ind > indent:
            raise YamlSubsetError(n, "indentation matches no enclosing "
                                     "mapping (or continues a scalar over "
                                     "lines)")
        if _is_seq_item(body):
            # an item where a key belongs: the caller decides whether a
            # sequence may continue here
            return out
        lines.i += 1
        key, rest = _split_key(body, n)
        if key in out:
            raise YamlSubsetError(n, f"duplicate key {key!r}")
        value_s = rest.lstrip(" \t")
        if not value_s or value_s.startswith("#"):
            out[key] = _value_after_key(lines, indent)
        else:
            out[key] = _scalar(value_s, n)


def _sequence(lines: _Lines, indent: int) -> List[Any]:
    out: List[Any] = []
    while True:
        cur = lines.peek()
        if cur is None or cur[1] != indent or not _is_seq_item(cur[2]):
            if cur is not None and cur[1] > indent:
                raise YamlSubsetError(cur[0], "indentation matches no "
                                              "enclosing sequence item")
            return out
        n, _, body = cur
        rest = body[1:].lstrip(" ")
        if rest.startswith("\t"):
            raise YamlSubsetError(n, "tabs in indentation")
        if not rest or rest.startswith("#"):
            lines.i += 1
            nxt = lines.peek()
            out.append(_block(lines, nxt[1]) if nxt is not None
                       and nxt[1] > indent else None)
            continue
        column = indent + len(body) - len(rest)
        if _is_seq_item(rest) or _is_key(rest, n):
            # the item's content is a line of its own at its column
            lines.items[lines.i] = (n, column, rest)
            out.append(_block(lines, column))
        else:
            lines.i += 1
            out.append(_scalar(rest, n))


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
    if not content:
        return {}
    if _is_seq_item(content[0][2]):
        raise YamlSubsetError(content[0][0], "the document is a sequence: "
                                             "a config is a mapping")
    lines = _Lines(content)
    root = _mapping(lines, content[0][1])
    left = lines.peek()
    if left is not None:
        raise YamlSubsetError(left[0], "indentation matches no enclosing "
                                       "mapping (or a sequence item where "
                                       "no key opens one)")
    return root


# ---------------------------------------------------------------------------
# the writer
# ---------------------------------------------------------------------------
_PLAIN_OK = re.compile(r"[A-Za-z0-9_./][A-Za-z0-9_./@:+=-]*\Z")
# what PyYAML's reader accepts in a stream (its NON_PRINTABLE complement)
_PRINTABLE = re.compile("[\x09\x0a\x0d\x20-\x7e\x85\xa0-\ud7ff"
                        "\ue000-\ufffd\U00010000-\U0010ffff]")


def _plain_ok(s: str) -> bool:
    """Whether ``s`` written bare reads back as the string ``s``."""
    if not _PLAIN_OK.match(s) or ": " in s or s.endswith(":"):
        return False
    try:
        return _resolve(_plain(s, 0, "value"), 0) == s
    except YamlSubsetError:
        return False


def _quote(s: str) -> str:
    out = ['"']
    for c in s:
        if c in '"\\':
            out.append("\\" + c)
        elif c in "\n\t\r":
            out.append({"\n": "\\n", "\t": "\\t", "\r": "\\r"}[c])
        elif _PRINTABLE.match(c):
            out.append(c)
        elif ord(c) <= 0xff:
            out.append(f"\\x{ord(c):02x}")
        elif ord(c) <= 0xffff:
            out.append(f"\\u{ord(c):04x}")
        else:
            out.append(f"\\U{ord(c):08x}")
    out.append('"')
    return "".join(out)


def _dump_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        if "e" in r and "." not in r:          # YAML 1.1 floats need a point
            r = r.replace("e", ".0e")
        return r
    if isinstance(v, str):
        return v if _plain_ok(v) else _quote(v)
    raise TypeError(f"cannot write {type(v).__name__} as YAML")


def _dump_map(d: Dict[str, Any], indent: int) -> List[str]:
    pad = " " * indent
    lines: List[str] = []
    for k, v in d.items():
        if not isinstance(k, str):
            raise TypeError(f"mapping key {k!r} is not a string")
        head = f"{pad}{_dump_scalar(k)}:"
        if isinstance(v, dict) and v:
            lines.append(head)
            lines.extend(_dump_map(v, indent + 2))
        elif isinstance(v, (list, tuple)) and v:
            lines.append(head)
            lines.extend(_dump_seq(v, indent))
        else:
            lines.append(f"{head} {_dump_value(v)}")
    return lines


def _dump_seq(items, indent: int) -> List[str]:
    pad = " " * indent
    lines: List[str] = []
    for v in items:
        if isinstance(v, dict) and v:
            sub = _dump_map(v, indent + 2)
        elif isinstance(v, (list, tuple)) and v:
            sub = _dump_seq(v, indent + 2)
        else:
            lines.append(f"{pad}- {_dump_value(v)}")
            continue
        lines.append(f"{pad}- {sub[0][indent + 2:]}")
        lines.extend(sub[1:])
    return lines


def _dump_value(v: Any) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _dump_scalar(v)


def dumps(obj: Dict[str, Any]) -> str:
    """``obj`` (a mapping) as a block YAML document, ending in a newline."""
    if not isinstance(obj, dict):
        raise TypeError("the document must be a mapping")
    if not obj:
        return "{}\n"
    return "\n".join(_dump_map(obj, 0)) + "\n"
