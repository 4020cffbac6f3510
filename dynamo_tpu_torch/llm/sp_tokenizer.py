"""SentencePiece (SPM/unigram) tokenizer built from GGUF metadata.

Stock Mistral/Llama GGUF artifacts embed an SPM vocab (pieces + unigram
log-prob scores + token types) rather than a tokenizer.json; the serving
stack must tokenize from that alone. This implements the SP unigram
algorithm natively: Viterbi segmentation maximizing the sum of piece
scores, with SP's ``▁`` whitespace convention and llama.cpp's byte-fallback
pieces (``<0x..>``) for anything outside the vocab. No sentencepiece
dependency.

Reference capability: lib/llm/src/tokenizers/sp.rs (SP wrapper) +
lib/llm/src/gguf/gguf_tokenizer.rs (tokenizer from GGUF metadata).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

_SPACE = "▁"  # ▁

# tokenizer.ggml.token_type values (llama.cpp llama_token_type)
_TYPE_NORMAL, _TYPE_UNKNOWN, _TYPE_CONTROL, _TYPE_USER, _TYPE_UNUSED, \
    _TYPE_BYTE = 1, 2, 3, 4, 5, 6


class SpTokenizer:
    """SPM unigram tokenizer over a (pieces, scores, types) vocab."""

    def __init__(self, pieces: Sequence[str], scores: Sequence[float],
                 types: Optional[Sequence[int]] = None,
                 bos_id: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 unk_id: int = 0,
                 add_bos: bool = True):
        self.pieces = list(pieces)
        self.scores = list(scores) if scores else [0.0] * len(self.pieces)
        self.types = (list(types) if types
                      else [_TYPE_NORMAL] * len(self.pieces))
        self._bos = bos_id
        self._eos = eos_id
        self._unk = unk_id
        self._add_bos = add_bos

        self._lookup: Dict[str, Tuple[int, float]] = {}
        self._byte_ids: Dict[int, int] = {}
        self._max_len = 1
        for i, p in enumerate(self.pieces):
            t = self.types[i] if i < len(self.types) else _TYPE_NORMAL
            if t == _TYPE_BYTE:
                # "<0xNN>" byte-fallback piece
                try:
                    self._byte_ids[int(p[3:5], 16)] = i
                except (ValueError, IndexError):
                    pass
                continue
            if t in (_TYPE_CONTROL, _TYPE_UNUSED, _TYPE_UNKNOWN):
                continue
            # keep the best-scoring piece for duplicate strings
            prev = self._lookup.get(p)
            if prev is None or self.scores[i] > prev[1]:
                self._lookup[p] = (i, self.scores[i])
            self._max_len = max(self._max_len, len(p))

    # ------------------------------------------------------------------
    @classmethod
    def from_gguf_metadata(cls, md: Dict) -> "SpTokenizer":
        pieces = md.get("tokenizer.ggml.tokens") or []
        scores = md.get("tokenizer.ggml.scores") or []
        types = md.get("tokenizer.ggml.token_type")
        bos = md.get("tokenizer.ggml.bos_token_id")
        eos = md.get("tokenizer.ggml.eos_token_id")
        unk = md.get("tokenizer.ggml.unknown_token_id", 0)
        add_bos = bool(md.get("tokenizer.ggml.add_bos_token", True))
        return cls(pieces, scores, types,
                   bos_id=int(bos) if bos is not None else None,
                   eos_id=int(eos) if eos is not None else None,
                   unk_id=int(unk), add_bos=add_bos)

    @classmethod
    def from_gguf(cls, path: str) -> "SpTokenizer":
        from .gguf import read_gguf

        g = read_gguf(path)
        try:
            return cls.from_gguf_metadata(g.metadata)
        finally:
            g.close()

    # ------------------------------------------------------------------
    def encode(self, text: str) -> List[int]:
        # SP normalization: spaces become ▁, and a leading ▁ marks the
        # word boundary at sequence start (llama/mistral convention)
        norm = _SPACE + text.replace(" ", _SPACE)
        ids = self._viterbi(norm)
        if self._add_bos and self._bos is not None:
            return [self._bos] + ids
        return ids

    def _viterbi(self, s: str) -> List[int]:
        """Unigram segmentation: max total piece score over the string."""
        n = len(s)
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        back: List[Optional[Tuple[int, int]]] = [None] * (n + 1)  # (start, id)
        best[0] = 0.0
        # byte fallback cost: below any real piece so it's a last resort
        byte_cost = -20.0
        for i in range(n):
            if best[i] == NEG:
                continue
            hi = min(n, i + self._max_len)
            for j in range(i + 1, hi + 1):
                hit = self._lookup.get(s[i:j])
                if hit is None:
                    continue
                cand = best[i] + hit[1]
                if cand > best[j]:
                    best[j] = cand
                    back[j] = (i, hit[0])
            # single-char fallback: byte pieces (or unk)
            j = i + 1
            nb = len(s[i:j].encode())
            cand = best[i] + byte_cost * nb
            if cand > best[j]:
                best[j] = cand
                back[j] = (i, -1)
        out: List[int] = []
        pos = n
        while pos > 0:
            assert back[pos] is not None
            start, pid = back[pos]
            if pid >= 0:
                out.append(pid)
            else:
                # byte-fallback (reversed append order handled below)
                bs = s[start:pos].encode()
                for b in reversed(bs):
                    out.append(self._byte_ids.get(b, self._unk))
            pos = start
        out.reverse()
        return out

    # ------------------------------------------------------------------
    def decode(self, ids: Sequence[int]) -> str:
        parts: List[bytes] = []
        for i in ids:
            if i < 0 or i >= len(self.pieces):
                continue
            t = self.types[i] if i < len(self.types) else _TYPE_NORMAL
            if t == _TYPE_BYTE:
                try:
                    parts.append(bytes([int(self.pieces[i][3:5], 16)]))
                    continue
                except (ValueError, IndexError):
                    pass
            if t == _TYPE_CONTROL:
                continue
            parts.append(self.pieces[i].replace(_SPACE, " ").encode())
        return b"".join(parts).decode("utf-8", errors="replace")

    # ------------------------------------------------------------------
    @property
    def eos_token_ids(self) -> List[int]:
        return [self._eos] if self._eos is not None else []

    @property
    def bos_token_id(self) -> Optional[int]:
        return self._bos

    @property
    def vocab_size(self) -> int:
        return len(self.pieces)
