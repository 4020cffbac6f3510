"""Unicode character classes for Python's ``re``, in place of ``regex``.

The pre-tokenizer patterns of byte-level BPE tokenizers (GPT-2, Qwen2,
Llama-3, and the ``Split`` regexes that ``tokenizer.json`` files carry) use
``\\p{L}`` and ``\\p{N}``, which Python's ``re`` lacks, and ``\\s``, which
``re`` reads more widely than the ``regex`` module and Oniguruma do (``re``
matches U+001C..U+001F, which are not White_Space). :func:`compile_pattern`
rewrites such a pattern into plain ``re`` syntax with every class spelled
out as explicit codepoint ranges:

- ``\\p{L}`` = general categories Lu, Ll, Lt, Lm, Lo; ``\\p{N}`` = Nd, Nl,
  No, both from the committed table :mod:`._unitable`, which holds
  ``regex``'s own sets (its Unicode version is
  ``_unitable.UNICODE_VERSION``). The card's machine has no ``regex`` and
  Python's ``unicodedata`` is an older Unicode (3.12: 15.0), so the table
  is data; ``python -m dynamo_tpu_torch.llm._uniclass`` regenerates it
  where ``regex`` is installed;
- ``\\s`` = the White_Space property;
- ``\\P{..}`` and ``\\S`` are the complements, inside ``[...]`` too.

On every codepoint (surrogates aside) the sets equal ``regex``'s.

Any other class escape (``\\d``, ``\\w``, ``\\p{Lu}``, ...) raises: a class
that ``re`` reads differently must not slip through.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

_MAX = 0x10FFFF

# the White_Space property (PropList.txt; unchanged since Unicode 6.3)
_WHITE_SPACE: Tuple[Tuple[int, int], ...] = (
    (0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0),
    (0x1680, 0x1680), (0x2000, 0x200A), (0x2028, 0x2029), (0x202F, 0x202F),
    (0x205F, 0x205F), (0x3000, 0x3000))

_CATEGORIES = ("L", "N")

_ranges: Dict[str, List[Tuple[int, int]]] = {}


def ranges(name: str) -> List[Tuple[int, int]]:
    """Inclusive codepoint ranges of class ``name`` (``"L"``, ``"N"`` or
    ``"s"``), ascending."""
    if not _ranges:
        from . import _unitable

        _ranges.update(L=list(_unitable.L), N=list(_unitable.N),
                       s=list(_WHITE_SPACE))
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


# the first codepoint each Unicode version made a letter, newest first:
# how the generator names the version of ``regex``'s table
_VERSION_PROBES = (("17.0.0", 0x10940), ("16.0.0", 0x1C89),
                   ("15.1.0", 0x2EBF0), ("15.0.0", 0x11F00))


def _runs(cps: List[int]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for c in cps:
        if out and out[-1][1] == c - 1:
            out[-1] = (out[-1][0], c)
        else:
            out.append((c, c))
    return out


def generate_table() -> str:
    """The source of :mod:`._unitable` from the ``regex`` module installed
    here: ``\\p{L}`` and ``\\p{N}`` over every codepoint but the
    surrogates."""
    import regex

    text = "".join(chr(c) for c in range(_MAX + 1)
                   if not 0xD800 <= c <= 0xDFFF)
    version = next(v for v, c in _VERSION_PROBES
                   if regex.match(r"\p{L}", chr(c)))
    lines = ['r"""\\p{L} and \\p{N} of ``regex`` %s (Unicode %s), as inclusive'
             % (regex.__version__, version),
             "codepoint runs. Generated by ``python -m "
             "dynamo_tpu_torch.llm._uniclass``;",
             'do not edit."""', "",
             f"UNICODE_VERSION = {version!r}",
             f"REGEX_VERSION = {regex.__version__!r}"]
    for name in _CATEGORIES:
        runs = _runs(sorted(ord(c) for c in
                            regex.findall(r"\p{%s}" % name, text)))
        lines += ["", f"{name} = ("]
        items = [f"(0x{a:X}, 0x{b:X})," for a, b in runs]
        row = "   "
        for it in items:
            if len(row) + 1 + len(it) > 79:
                lines.append(row)
                row = "   "
            row += " " + it
        lines += [row, ")"]
    return "\n".join(lines) + "\n"


if __name__ == "__main__":
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "_unitable.py")
    with open(path, "w") as f:
        f.write(generate_table())
    print(f"wrote {path}")
