"""Byte-level BPE (GPT-2 style) tokenizer built from GGUF metadata.

Qwen2/GPT-2-family GGUF artifacts carry ``tokenizer.ggml.model = "gpt2"``
with a token list and a merge table instead of an SPM vocab.  The serving
stack must tokenize from that alone — the reference builds an HF
``tokenizers`` byte-level BPE from the same metadata
(lib/llm/src/gguf/gguf_tokenizer.rs:121-125, 234-283); this implements the
algorithm natively:

- GPT-2 byte↔unicode table (every byte maps to a printable codepoint, so
  the merge table operates on strings while round-tripping raw bytes);
- regex pre-tokenization (GPT-2 pattern by default; the Qwen2 variant when
  ``tokenizer.ggml.pre`` says so, matching llama.cpp's pre-tokenizer tags),
  on Python's ``re`` with the ``\\p{L}``/``\\p{N}``/``\\s`` classes spelled out
  by :mod:`._uniclass` (the ``regex`` module is not needed);
- lowest-rank-first pair merging per pre-token, memoized;
- special/control tokens split out of the text before BPE so
  ``<|endoftext|>``-style markers encode to their single id.
"""

from __future__ import annotations

import re as _re
from typing import Dict, List, Optional, Sequence, Tuple

from . import _uniclass
from .tokenizer_json import BYTES_CHAR, CHAR_BYTES

# llama.cpp llama_token_type values (same table as sp_tokenizer)
_TYPE_NORMAL, _TYPE_UNKNOWN, _TYPE_CONTROL, _TYPE_USER, _TYPE_UNUSED, \
    _TYPE_BYTE = 1, 2, 3, 4, 5, 6

# GPT-2 pre-tokenization pattern (HF ByteLevel default — what the reference
# gets from pre_tokenizers::byte_level::ByteLevel).
_GPT2_PAT = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
             r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")
# Qwen2 / llama-3 family pattern (tokenizer.json pre_tokenizer split regex;
# llama.cpp selects it via the "qwen2"/"llama3" pre-tokenizer tags).
_QWEN2_PAT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"
              r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")

_PRE_PATTERNS = {
    "default": _GPT2_PAT,
    "gpt-2": _GPT2_PAT,
    "qwen2": _QWEN2_PAT,
    "llama3": _QWEN2_PAT,
    "llama-bpe": _QWEN2_PAT,
}


# GPT-2's reversible byte→printable-codepoint table
_B2U = BYTES_CHAR
_U2B = CHAR_BYTES


class BpeTokenizer:
    """Byte-level BPE over a (tokens, merges) vocab from GGUF metadata."""

    def __init__(self, tokens: Sequence[str], merges: Sequence[str],
                 types: Optional[Sequence[int]] = None,
                 bos_id: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 add_bos: bool = False,
                 pre: str = "default"):
        self.tokens = list(tokens)
        self.types = (list(types) if types
                      else [_TYPE_NORMAL] * len(self.tokens))
        self._vocab: Dict[str, int] = {}
        for i, t in enumerate(self.tokens):
            self._vocab.setdefault(t, i)
        self._ranks: Dict[Tuple[str, str], int] = {}
        for r, m in enumerate(merges):
            a, _, b = m.partition(" ")
            self._ranks[(a, b)] = r
        self._bos = bos_id
        self._eos = eos_id
        self._add_bos = add_bos
        self._pat = _uniclass.compile_pattern(
            _PRE_PATTERNS.get(pre, _GPT2_PAT))
        # specials are matched verbatim before byte-level pre-tokenization
        specials = [self.tokens[i] for i in range(len(self.tokens))
                    if self.types[i] in (_TYPE_CONTROL, _TYPE_USER)
                    and self.tokens[i]]
        self._special_pat = (_re.compile(
            "|".join(_re.escape(s) for s in
                     sorted(specials, key=len, reverse=True)))
            if specials else None)
        self._cache: Dict[str, List[int]] = {}

    # ------------------------------------------------------------------
    @classmethod
    def from_gguf_metadata(cls, md: Dict) -> "BpeTokenizer":
        tokens = md.get("tokenizer.ggml.tokens")
        merges = md.get("tokenizer.ggml.merges")
        if not tokens:
            raise ValueError("gpt2 BPE tokenizer requires tokenizer.ggml.tokens")
        if merges is None:
            raise ValueError("gpt2 BPE tokenizer requires tokenizer.ggml.merges")
        bos = md.get("tokenizer.ggml.bos_token_id")
        eos = md.get("tokenizer.ggml.eos_token_id")
        return cls(tokens, merges,
                   types=md.get("tokenizer.ggml.token_type"),
                   bos_id=int(bos) if bos is not None else None,
                   eos_id=int(eos) if eos is not None else None,
                   add_bos=bool(md.get("tokenizer.ggml.add_bos_token", False)),
                   pre=str(md.get("tokenizer.ggml.pre", "default")))

    @classmethod
    def from_gguf(cls, path: str) -> "BpeTokenizer":
        from .gguf import read_gguf

        g = read_gguf(path)
        try:
            return cls.from_gguf_metadata(g.metadata)
        finally:
            g.close()

    # ------------------------------------------------------------------
    def _bpe_word(self, word: str) -> List[int]:
        """Merge one pre-token (already byte-mapped) to ids."""
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        parts = list(word)
        while len(parts) > 1:
            best_rank, best_i = None, -1
            for i in range(len(parts) - 1):
                r = self._ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            parts[best_i:best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        out: List[int] = []
        for p in parts:
            i = self._vocab.get(p)
            if i is not None:
                out.append(i)
            else:
                # unmergeable fragment: fall back to per-byte tokens
                for ch in p:
                    j = self._vocab.get(ch)
                    if j is not None:
                        out.append(j)
        if len(self._cache) < 65536:
            self._cache[word] = out
        return out

    def _encode_span(self, text: str) -> List[int]:
        ids: List[int] = []
        for m in self._pat.finditer(text):
            mapped = "".join(_B2U[b] for b in m.group().encode("utf-8"))
            ids.extend(self._bpe_word(mapped))
        return ids

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        if self._add_bos and self._bos is not None:
            ids.append(self._bos)
        if self._special_pat is None:
            ids.extend(self._encode_span(text))
            return ids
        pos = 0
        for m in self._special_pat.finditer(text):
            if m.start() > pos:
                ids.extend(self._encode_span(text[pos:m.start()]))
            ids.append(self._vocab[m.group()])
            pos = m.end()
        if pos < len(text):
            ids.extend(self._encode_span(text[pos:]))
        return ids

    # ------------------------------------------------------------------
    def decode(self, ids: Sequence[int]) -> str:
        bs = bytearray()
        out: List[str] = []
        for i in ids:
            if i < 0 or i >= len(self.tokens):
                continue
            t = self.types[i] if i < len(self.types) else _TYPE_NORMAL
            if t in (_TYPE_CONTROL, _TYPE_UNUSED):
                continue
            tok = self.tokens[i]
            if t == _TYPE_USER:
                if bs:
                    out.append(bs.decode("utf-8", errors="replace"))
                    bs = bytearray()
                out.append(tok)
                continue
            for ch in tok:
                b = _U2B.get(ch)
                if b is not None:
                    bs.append(b)
                else:  # not byte-mapped (shouldn't happen for gpt2 vocabs)
                    bs.extend(ch.encode("utf-8"))
        if bs:
            out.append(bs.decode("utf-8", errors="replace"))
        return "".join(out)

    # ------------------------------------------------------------------
    @property
    def eos_token_ids(self) -> List[int]:
        return [self._eos] if self._eos is not None else []

    @property
    def bos_token_id(self) -> Optional[int]:
        return self._bos

    @property
    def vocab_size(self) -> int:
        return len(self.tokens)
