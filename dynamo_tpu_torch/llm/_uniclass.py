"""Unicode character classes for Python's ``re``, in place of ``regex``.

The pre-tokenizer patterns of byte-level BPE tokenizers (GPT-2, Qwen2,
Llama-3, and the ``Split`` regexes that ``tokenizer.json`` files carry) use
``\\p{L}`` and ``\\p{N}``, which Python's ``re`` lacks, and ``\\s``, which
``re`` reads more widely than the ``regex`` module and Oniguruma do (``re``
matches U+001C..U+001F, which are not White_Space). :func:`compile_pattern`
rewrites such a pattern into plain ``re`` syntax with every class spelled
out as explicit codepoint ranges:

- ``\\p{L}`` = general categories Lu, Ll, Lt, Lm, Lo; ``\\p{N}`` = Nd, Nl,
  No, both from ``unicodedata`` (Python's own Unicode table);
- ``\\s`` = the White_Space property;
- ``\\P{..}`` and ``\\S`` are the complements, inside ``[...]`` too.

The sets are built lazily, once a process. Python 3.12 ships Unicode 15.0;
codepoints that a newer Unicode assigns (which ``regex`` may count as
letters or numbers) are unassigned here and fall outside ``\\p{L}`` and
``\\p{N}``. On every codepoint Python's table assigns, the sets equal
``regex``'s.

Any other class escape (``\\d``, ``\\w``, ``\\p{Lu}``, ...) raises: a class
that ``re`` reads differently must not slip through.
"""

from __future__ import annotations

import re
import unicodedata
from typing import Dict, List, Tuple

_MAX = 0x10FFFF

# the White_Space property (PropList.txt; unchanged since Unicode 6.3)
_WHITE_SPACE: Tuple[Tuple[int, int], ...] = (
    (0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0),
    (0x1680, 0x1680), (0x2000, 0x200A), (0x2028, 0x2029), (0x202F, 0x202F),
    (0x205F, 0x205F), (0x3000, 0x3000))

_CATEGORIES = {"L": ("Lu", "Ll", "Lt", "Lm", "Lo"),
               "N": ("Nd", "Nl", "No")}

_ranges: Dict[str, List[Tuple[int, int]]] = {}


def _build() -> None:
    want = {cat: name for name, cats in _CATEGORIES.items() for cat in cats}
    acc: Dict[str, List[Tuple[int, int]]] = {n: [] for n in _CATEGORIES}
    for c in range(_MAX + 1):
        name = want.get(unicodedata.category(chr(c)))
        if name is None:
            continue
        r = acc[name]
        if r and r[-1][1] == c - 1:
            r[-1] = (r[-1][0], c)
        else:
            r.append((c, c))
    acc["s"] = list(_WHITE_SPACE)
    _ranges.update(acc)


def ranges(name: str) -> List[Tuple[int, int]]:
    """Inclusive codepoint ranges of class ``name`` (``"L"``, ``"N"`` or
    ``"s"``), ascending."""
    if not _ranges:
        _build()
    return _ranges[name]


def _complement(rs: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out, lo = [], 0
    for a, b in rs:
        if a > lo:
            out.append((lo, a - 1))
        lo = b + 1
    if lo <= _MAX:
        out.append((lo, _MAX))
    return out


def _cp(c: int) -> str:
    return f"\\U{c:08x}"


def _items(rs: List[Tuple[int, int]]) -> str:
    return "".join(_cp(a) if a == b else f"{_cp(a)}-{_cp(b)}"
                   for a, b in rs)


def _class_escape(pat: str, i: int) -> Tuple[str, bool, int]:
    """At a backslash at ``pat[i]``: (class name, negated, next index), or
    ("", False, i) when the escape is not one of ours."""
    c = pat[i + 1] if i + 1 < len(pat) else ""
    if c in ("s", "S"):
        return "s", c == "S", i + 2
    if c in ("p", "P"):
        if pat.startswith("{", i + 2):
            end = pat.index("}", i + 2)
            name = pat[i + 3:end]
            single = False
        else:
            name, end, single = pat[i + 2:i + 3], i + 2, True
        if name not in _CATEGORIES:
            raise ValueError(f"unsupported Unicode class \\{c}{{{name}}} in "
                             f"pattern {pat!r} (only \\p{{L}} and \\p{{N}})")
        return name, c == "P", (end + 1)
    if c in ("d", "D", "w", "W", "h", "H", "b", "B", "X", "R"):
        raise ValueError(f"unsupported escape \\{c} in pattern {pat!r}: "
                         f"Python's re reads it differently")
    return "", False, i


def translate(pat: str) -> str:
    """Rewrite a ``regex``/Oniguruma-style pattern into Python ``re``."""
    out: List[str] = []
    i, n = 0, len(pat)
    while i < n:
        ch = pat[i]
        if ch == "\\":
            name, neg, j = _class_escape(pat, i)
            if name:
                rs = ranges(name)
                out.append(("[" + _items(_complement(rs)) + "]") if neg
                           else ("[" + _items(rs) + "]"))
                i = j
            else:
                out.append(pat[i:i + 2])
                i += 2
            continue
        if ch == "[":
            i = _translate_set(pat, i, out)
            continue
        out.append(ch)
        i += 1
    return "".join(out)


def _translate_set(pat: str, i: int, out: List[str]) -> int:
    """Copy the ``[...]`` starting at ``pat[i]`` with class escapes spelled
    out as ranges; returns the index after its ``]``."""
    parts = ["["]
    i += 1
    if i < len(pat) and pat[i] == "^":
        parts.append("^")
        i += 1
    first = True
    while i < len(pat):
        ch = pat[i]
        if ch == "]" and not first:
            parts.append("]")
            out.append("".join(parts))
            return i + 1
        first = False
        if ch == "\\":
            name, neg, j = _class_escape(pat, i)
            if name:
                rs = ranges(name)
                parts.append(_items(_complement(rs) if neg else rs))
                i = j
            else:
                parts.append(pat[i:i + 2])
                i += 2
            continue
        if ch == "[":
            raise ValueError(f"nested character class in pattern {pat!r}")
        parts.append(ch)
        i += 1
    raise ValueError(f"unterminated character class in pattern {pat!r}")


_compiled: Dict[str, "re.Pattern[str]"] = {}


def compile_pattern(pat: str) -> "re.Pattern[str]":
    """:func:`translate` then ``re.compile``, cached per pattern."""
    hit = _compiled.get(pat)
    if hit is None:
        hit = _compiled[pat] = re.compile(translate(pat))
    return hit


def is_white_space(ch: str) -> bool:
    """Rust's ``char::is_whitespace`` (the White_Space property)."""
    c = ord(ch)
    return any(a <= c <= b for a, b in _WHITE_SPACE)
