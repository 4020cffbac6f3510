"""HuggingFace ``tokenizer.json`` without the ``tokenizers`` library.

Reads the serialized fast-tokenizer file and encodes and decodes as
``tokenizers`` does with ``add_special_tokens=False`` and
``skip_special_tokens=False`` (how :class:`~dynamo_tpu_torch.llm.tokenizer.
HfTokenizer` calls it). The pipeline, per ``tokenizers``' own order:

1. added tokens are split out of the text: first those with
   ``normalized: false`` on the raw text, then, in each remaining piece
   after normalisation, those with ``normalized: true`` (leftmost-longest
   match; ``lstrip``/``rstrip`` absorb the White_Space next to a match;
   ``single_word`` only at word boundaries);
2. the normalizer runs on each remaining piece: ``NFC``/``NFD``/``NFKC``/
   ``NFKD``, ``Prepend``, ``Replace``, ``Sequence``;
3. the pre-tokenizer splits each piece: ``Split`` (all five behaviours,
   ``invert``), ``ByteLevel`` (with or without its GPT-2 regex),
   ``Metaspace`` (``prepend_scheme`` always/first/never, ``split``),
   ``Sequence``;
4. the ``BPE`` model merges each pre-token, lowest merge rank first and
   leftmost among equals, with ``byte_fallback`` (``<0xNN>`` pieces),
   ``unk_token``/``fuse_unk`` and ``ignore_merges`` (a pre-token that is a
   vocab entry is emitted whole). Merges load from ``"a b"`` strings and
   from ``["a", "b"]`` pairs.

Decoding maps ids to tokens (added tokens first) and runs the decoder:
``ByteLevel``, ``Metaspace``, ``Replace``, ``ByteFallback``, ``Fuse``,
``Strip``, ``Sequence``.

Regex patterns (``Split``, ``Replace``) are Oniguruma syntax in the file;
:mod:`._uniclass` rewrites their ``\\p{L}``/``\\p{N}``/``\\s`` classes for
Python's ``re``. Anything else the file asks for (another model, a
normalizer or pre-tokenizer not listed, truncation or padding, BPE dropout
or subword affixes) raises at load, naming it: a tokenizer that silently
differs would mis-tokenize every request.
"""

from __future__ import annotations

import json
import re
import unicodedata
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import _uniclass

# a piece of the text on its way through the pipeline: (text, starts at
# the original text's offset 0, id of the added token it is or None)
_Piece = Tuple[str, bool, Optional[int]]

# GPT-2's pre-tokenization pattern (ByteLevel with use_regex)
_BYTE_LEVEL_PAT = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
                   r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable codepoint table."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


BYTES_CHAR = bytes_to_unicode()
CHAR_BYTES = {u: b for b, u in BYTES_CHAR.items()}


class UnsupportedTokenizer(ValueError):
    """tokenizer.json asks for a component this module does not implement."""


def _unsupported(what: str, spec: Any) -> UnsupportedTokenizer:
    return UnsupportedTokenizer(
        f"tokenizer.json: unsupported {what} {json.dumps(spec)[:200]}")


def _pattern(spec: Dict[str, Any], where: str) -> "re.Pattern[str]":
    if "String" in spec:
        return re.compile(re.escape(spec["String"]))
    if "Regex" in spec:
        return _uniclass.compile_pattern(spec["Regex"])
    raise _unsupported(f"{where} pattern", spec)


# ---------------------------------------------------------------------------
# normalizers: str -> str, applied to each piece on its own
# ---------------------------------------------------------------------------

def _normalizer(spec: Optional[Dict[str, Any]]
                ) -> Optional[Callable[[str], str]]:
    if spec is None:
        return None
    kind = spec.get("type")
    if kind in ("NFC", "NFD", "NFKC", "NFKD"):
        return lambda s, form=kind: unicodedata.normalize(form, s)
    if kind == "Prepend":
        pre = spec["prepend"]
        return lambda s: pre + s if s else s
    if kind == "Replace":
        pat, content = _pattern(spec["pattern"], "Replace"), spec["content"]
        return lambda s: pat.sub(lambda _m: content, s)
    if kind == "Sequence":
        fns = [_normalizer(n) for n in spec["normalizers"]]

        def seq(s: str) -> str:
            for fn in fns:
                s = fn(s)
            return s
        return seq
    raise _unsupported("normalizer", spec)


# ---------------------------------------------------------------------------
# pre-tokenizers: List[_Piece] -> List[_Piece] (added-token pieces pass)
# ---------------------------------------------------------------------------

def _segments(text: str, pat: "re.Pattern[str]", invert: bool
              ) -> List[Tuple[int, int, bool]]:
    """(start, end, is_match) covering ``text``, as tokenizers'
    ``Pattern::find_matches``."""
    if not text:
        return [(0, 0, False)]
    out, prev = [], 0
    for m in pat.finditer(text):
        s, e = m.span()
        if prev != s:
            out.append((prev, s, invert))
        out.append((s, e, not invert))
        prev = e
    if prev != len(text):
        out.append((prev, len(text), invert))
    return out


def _split_text(text: str, pat: "re.Pattern[str]", behavior: str,
                invert: bool = False) -> List[Tuple[int, int]]:
    """tokenizers' ``NormalizedString::split``: the kept (start, end)
    spans, empty ones included (the caller drops them)."""
    segs = _segments(text, pat, invert)
    if behavior == "Isolated":
        return [(s, e) for s, e, _ in segs]
    if behavior == "Removed":
        return [(s, e) for s, e, m in segs if not m]
    acc: List[List[int]] = []
    if behavior == "MergedWithPrevious":
        prev_match = False
        for s, e, m in segs:
            if m and not prev_match and acc:
                acc[-1][1] = e
            else:
                acc.append([s, e])
            prev_match = m
        return [(s, e) for s, e in acc]
    if behavior == "MergedWithNext":
        prev_match = False
        for s, e, m in reversed(segs):
            if m and not prev_match and acc:
                acc[-1][0] = s
            else:
                acc.append([s, e])
            prev_match = m
        return [(s, e) for s, e in reversed(acc)]
    if behavior == "Contiguous":
        last: Optional[bool] = None
        for s, e, m in segs:
            if m == last and acc:
                acc[-1][1] = e
            else:
                acc.append([s, e])
            last = m
        return [(s, e) for s, e in acc]
    raise _unsupported("split behavior", behavior)


def _split_pieces(pieces: List[_Piece],
                  fn: Callable[[str, bool], List[Tuple[str, bool]]]
                  ) -> List[_Piece]:
    out: List[_Piece] = []
    for text, origin, tid in pieces:
        if tid is not None:
            out.append((text, origin, tid))
            continue
        for sub, sub_origin in fn(text, origin):
            if sub:
                out.append((sub, sub_origin, None))
    return out


def _slices(text: str, origin: bool, spans: List[Tuple[int, int]]
            ) -> List[Tuple[str, bool]]:
    # a sub-piece starts at the original offset 0 only if its parent did
    # and it starts where the parent starts
    return [(text[s:e], origin and s == 0) for s, e in spans]


def _pre_tokenizer(spec: Optional[Dict[str, Any]]
                   ) -> Optional[Callable[[List[_Piece]], List[_Piece]]]:
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        fns = [_pre_tokenizer(p) for p in spec["pretokenizers"]]

        def seq(pieces: List[_Piece]) -> List[_Piece]:
            for fn in fns:
                pieces = fn(pieces)
            return pieces
        return seq
    if kind == "Split":
        pat = _pattern(spec["pattern"], "Split")
        behavior, invert = spec["behavior"], bool(spec.get("invert", False))
        return lambda pieces: _split_pieces(
            pieces, lambda t, o: _slices(
                t, o, _split_text(t, pat, behavior, invert)))
    if kind == "ByteLevel":
        prefix = bool(spec.get("add_prefix_space", False))
        regex = (_uniclass.compile_pattern(_BYTE_LEVEL_PAT)
                 if spec.get("use_regex", True) else None)

        def byte_level(text: str, origin: bool) -> List[Tuple[str, bool]]:
            if prefix and not text.startswith(" "):
                text = " " + text
            subs = (_slices(text, origin, _split_text(text, regex,
                                                      "Isolated"))
                    if regex is not None else [(text, origin)])
            return [("".join(BYTES_CHAR[b] for b in s.encode("utf-8")), o)
                    for s, o in subs]
        return lambda pieces: _split_pieces(pieces, byte_level)
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        if "prepend_scheme" in spec:
            scheme = spec["prepend_scheme"]
        else:   # tokenizers < 0.19 files
            scheme = "always" if spec.get("add_prefix_space", True) \
                else "never"
        if scheme not in ("always", "first", "never"):
            raise _unsupported("Metaspace prepend_scheme", scheme)
        split = bool(spec.get("split", True))
        rep_pat = re.compile(re.escape(rep))

        def metaspace(text: str, origin: bool) -> List[Tuple[str, bool]]:
            text = text.replace(" ", rep)
            if not text.startswith(rep) and (
                    scheme == "always" or (scheme == "first" and origin)):
                text = rep + text
            if not split:
                return [(text, origin)]
            return _slices(text, origin,
                           _split_text(text, rep_pat, "MergedWithNext"))
        return lambda pieces: _split_pieces(pieces, metaspace)
    raise _unsupported("pre_tokenizer", spec)


# ---------------------------------------------------------------------------
# decoders: List[str] -> List[str]
# ---------------------------------------------------------------------------

def _byte_fallback(tokens: List[str]) -> List[str]:
    out: List[str] = []
    pending = bytearray()

    def flush() -> None:
        if pending:
            try:
                out.append(pending.decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("�" for _ in pending)
            pending.clear()

    for t in tokens:
        b = None
        if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
            try:
                b = int(t[3:5], 16)
            except ValueError:
                b = None
        if b is not None:
            pending.append(b)
        else:
            flush()
            out.append(t)
    flush()
    return out


def _decoder(spec: Optional[Dict[str, Any]]
             ) -> Optional[Callable[[List[str]], List[str]]]:
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        fns = [_decoder(d) for d in spec["decoders"]]

        def seq(tokens: List[str]) -> List[str]:
            for fn in fns:
                tokens = fn(tokens)
            return tokens
        return seq
    if kind == "ByteLevel":
        def byte_level(tokens: List[str]) -> List[str]:
            buf = bytearray()
            for t in tokens:
                bs = [CHAR_BYTES.get(c) for c in t]
                if None in bs:
                    buf += t.encode("utf-8")
                else:
                    buf += bytes(bs)
            return [buf.decode("utf-8", errors="replace")]
        return byte_level
    if kind == "Replace":
        pat, content = _pattern(spec["pattern"], "Replace"), spec["content"]
        return lambda tokens: [pat.sub(lambda _m: content, t)
                               for t in tokens]
    if kind == "ByteFallback":
        return _byte_fallback
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Strip":
        content, start, stop = spec["content"], spec["start"], spec["stop"]

        def strip(tokens: List[str]) -> List[str]:
            out = []
            for t in tokens:
                a = 0
                while a < min(start, len(t)) and t[a] == content:
                    a += 1
                b = len(t)
                for _ in range(stop):
                    if b > a and t[b - 1] == content:
                        b -= 1
                    else:
                        break
                out.append(t[a:b])
            return out
        return strip
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme",
                          "always" if spec.get("add_prefix_space", True)
                          else "never")

        def metaspace(tokens: List[str]) -> List[str]:
            return [t.replace(rep, "") if i == 0 and scheme != "never"
                    else t.replace(rep, " ") for i, t in enumerate(tokens)]
        return metaspace
    raise _unsupported("decoder", spec)


# ---------------------------------------------------------------------------
# the BPE model
# ---------------------------------------------------------------------------

class _Bpe:
    def __init__(self, spec: Dict[str, Any]):
        for key in ("continuing_subword_prefix", "end_of_word_suffix"):
            if spec.get(key):
                raise _unsupported(f"BPE {key}", spec[key])
        if spec.get("dropout") not in (None, 0, 0.0):
            raise _unsupported("BPE dropout", spec["dropout"])
        self.vocab: Dict[str, int] = dict(spec["vocab"])
        self.vocab_r: Dict[int, str] = {i: t for t, i in self.vocab.items()}
        self.unk = spec.get("unk_token")
        self.fuse_unk = bool(spec.get("fuse_unk", False))
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        # (left id, right id) -> (rank, merged id); a later duplicate wins,
        # as in tokenizers' HashMap collect
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, m in enumerate(spec.get("merges") or []):
            if isinstance(m, str):
                a, sep, b = m.partition(" ")
                if not sep:
                    raise _unsupported("BPE merge", m)
            else:
                a, b = m
            try:
                ids = (self.vocab[a], self.vocab[b])
                new = self.vocab[a + b]
            except KeyError as e:
                raise UnsupportedTokenizer(
                    f"tokenizer.json: merge {m!r} names a token outside the "
                    f"vocab ({e})") from None
            self.merges[ids] = (rank, new)
        self._cache: Dict[str, List[int]] = {}

    def tokenize(self, piece: str) -> List[int]:
        if self.ignore_merges:
            hit = self.vocab.get(piece)
            if hit is not None:
                return [hit]
        hit_ids = self._cache.get(piece)
        if hit_ids is not None:
            return hit_ids
        ids = self._merge_word(piece)
        if len(self._cache) < 65536:
            self._cache[piece] = ids
        return ids

    def _merge_word(self, w: str) -> List[int]:
        syms: List[int] = []
        unk: Optional[int] = None      # a pending unk id
        for ch in w:
            i = self.vocab.get(ch)
            if i is not None:
                if unk is not None:
                    syms.append(unk)
                    unk = None
                syms.append(i)
                continue
            if self.byte_fallback:
                bs = [self.vocab.get(f"<0x{b:02X}>")
                      for b in ch.encode("utf-8")]
                if None not in bs:
                    syms.extend(bs)   # a pending unk stays pending
                    continue
            if self.unk is not None:
                if self.unk not in self.vocab:
                    raise UnsupportedTokenizer(
                        f"tokenizer.json: unk_token {self.unk!r} is not in "
                        f"the vocab")
                if unk is not None and not self.fuse_unk:
                    syms.append(unk)
                unk = self.vocab[self.unk]
        if unk is not None:
            syms.append(unk)
        merges = self.merges
        while len(syms) > 1:
            best, best_i = None, -1
            for k in range(len(syms) - 1):
                m = merges.get((syms[k], syms[k + 1]))
                if m is not None and (best is None or m[0] < best[0]):
                    best, best_i = m, k
            if best is None:
                break
            syms[best_i:best_i + 2] = [best[1]]
        return syms


# ---------------------------------------------------------------------------
# the tokenizer
# ---------------------------------------------------------------------------

_POST_PROCESSORS = ("TemplateProcessing", "ByteLevel", "RobertaProcessing",
                    "BertProcessing", "Sequence")


class TokenizerJson:
    """A ``tokenizer.json`` loaded without ``tokenizers``."""

    def __init__(self, spec: Dict[str, Any]):
        for key in ("truncation", "padding"):
            if spec.get(key) is not None:
                raise _unsupported(key, spec[key])
        model = spec.get("model") or {}
        if model.get("type", "BPE") != "BPE":
            raise _unsupported("model", {"type": model.get("type")})
        post = spec.get("post_processor")
        # with add_special_tokens=False a post-processor adds nothing
        if post is not None and post.get("type") not in _POST_PROCESSORS:
            raise _unsupported("post_processor", post)
        self.model = _Bpe(model)
        self._normalize = _normalizer(spec.get("normalizer"))
        self._pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))
        self._decode = _decoder(spec.get("decoder"))

        self.added: Dict[str, int] = {}
        self.added_r: Dict[int, str] = {}
        self._added_spec: Dict[int, Dict[str, Any]] = {}
        raw, normed = [], []
        for t in spec.get("added_tokens") or []:
            tid, content = int(t["id"]), t["content"]
            self.added[content] = tid
            self.added_r[tid] = content
            self._added_spec[tid] = t
            if t.get("normalized", not t.get("special", False)):
                # matched in the normalised text: against its normalised form
                pat = self._normalize(content) if self._normalize else content
                normed.append((pat, tid))
            else:
                raw.append((content, tid))
        self._raw_pat = self._alternation(raw)
        self._norm_pat = self._alternation(normed)

    @classmethod
    def from_file(cls, path: str) -> "TokenizerJson":
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f))

    @staticmethod
    def _alternation(tokens: List[Tuple[str, int]]
                     ) -> Optional[Tuple["re.Pattern[str]", Dict[str, int]]]:
        # longest first: at the leftmost position re's first alternative
        # that matches is then the longest (aho-corasick LeftmostLongest)
        tokens = [(s, i) for s, i in tokens if s]
        if not tokens:
            return None
        ids = {s: i for s, i in tokens}
        alts = sorted(ids, key=len, reverse=True)
        return re.compile("|".join(re.escape(s) for s in alts)), ids

    # ------------------------------------------------------------------
    def _find_added(self, text: str, origin: bool, which
                    ) -> List[_Piece]:
        """tokenizers' ``AddedVocabulary::find_matches`` on one piece."""
        if which is None or not text:
            return [(text, origin, None)]
        pat, ids = which
        out: List[_Piece] = []
        start_offset = 0
        for m in pat.finditer(text):
            start, stop = m.span()
            tid = ids[m.group()]
            spec = self._added_spec[tid]
            if spec.get("single_word"):
                before_ok = start == 0 or not _is_word(text[start - 1])
                after_ok = stop == len(text) or not _is_word(text[stop])
                if not (before_ok and after_ok):
                    continue
            if spec.get("lstrip"):
                s = start
                while s > 0 and _uniclass.is_white_space(text[s - 1]):
                    s -= 1
                start = max(s, start_offset)
            if spec.get("rstrip"):
                while stop < len(text) and _uniclass.is_white_space(
                        text[stop]):
                    stop += 1
            if start_offset < start:
                out.append((text[start_offset:start],
                            origin and start_offset == 0, None))
            out.append((text[start:stop], origin and start == 0, tid))
            start_offset = stop
        if start_offset != len(text):
            out.append((text[start_offset:], origin and start_offset == 0,
                        None))
        return out

    def encode(self, text: str) -> List[int]:
        pieces: List[_Piece] = [p for p in self._find_added(
            text, True, self._raw_pat) if p[0]]
        normed: List[_Piece] = []
        for t, origin, tid in pieces:
            if tid is not None:
                normed.append((t, origin, tid))
                continue
            if self._normalize is not None:
                t = self._normalize(t)
            normed.extend(p for p in self._find_added(t, origin,
                                                      self._norm_pat)
                          if p[0])
        if self._pre_tokenize is not None:
            normed = self._pre_tokenize(normed)
        ids: List[int] = []
        for t, _, tid in normed:
            if tid is not None:
                ids.append(tid)
            else:
                ids.extend(self.model.tokenize(t))
        return ids

    def id_to_token(self, i: int) -> Optional[str]:
        t = self.added_r.get(i)
        return t if t is not None else self.model.vocab_r.get(i)

    def token_to_id(self, token: str) -> Optional[int]:
        i = self.added.get(token)
        return i if i is not None else self.model.vocab.get(token)

    def decode(self, ids: Sequence[int]) -> str:
        tokens = [t for t in (self.id_to_token(int(i)) for i in ids)
                  if t is not None]
        if self._decode is None:
            return " ".join(tokens)
        return "".join(self._decode(tokens))

    def get_vocab_size(self) -> int:
        return len(set(self.model.vocab) | set(self.added))


def _is_word(ch: str) -> bool:
    # Rust's char::is_alphanumeric or '_' (tokenizers' word test)
    return ch == "_" or ch.isalnum()
