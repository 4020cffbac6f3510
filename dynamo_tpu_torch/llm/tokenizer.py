"""Tokenizer abstraction: encode/decode + streaming incremental detokenization.

Backends:
- :class:`HfTokenizer` — a HuggingFace ``tokenizer.json`` from a *local*
  directory, read by :mod:`.tokenizer_json` (the port's own reader: the
  ``tokenizers`` and ``transformers`` libraries are not needed).
- :class:`ByteTokenizer` — self-contained byte-level tokenizer (vocab = 256
  bytes + specials). Lets the whole stack run hermetically with no
  downloaded artifacts; also the fixture tokenizer for tests.
- ``gguf-sp:`` / ``gguf-bpe:`` kinds of :func:`load_tokenizer` — the
  SentencePiece and byte-level BPE vocabularies a GGUF file embeds
  (:mod:`.sp_tokenizer`, :mod:`.bpe_tokenizer`).

Streaming pieces:
- :class:`DecodeStream` — incremental detokenization that never emits a torn
  multi-byte codepoint (prefix/read-offset algorithm).
- :class:`StopSequenceDecoder` — the "jail": holds back text that might be the
  start of a stop sequence until disambiguated, truncates at the match.

Reference capability: lib/llm/src/tokenizers.rs:39-236 (Encoder/Decoder,
DecodeStream, StopSequenceDecoder) and backend.rs stop handling.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Protocol, Sequence, Tuple


class Tokenizer(Protocol):
    def encode(self, text: str) -> List[int]: ...
    def decode(self, ids: Sequence[int]) -> str: ...
    @property
    def eos_token_ids(self) -> List[int]: ...
    @property
    def bos_token_id(self) -> Optional[int]: ...
    @property
    def vocab_size(self) -> int: ...


class ByteTokenizer:
    """Byte-level tokenizer: token i (< 256) is byte i; then BOS/EOS/PAD."""

    BOS = 256
    EOS = 257
    PAD = 258

    def __init__(self, add_bos: bool = False):
        self.add_bos = add_bos

    def encode(self, text: str) -> List[int]:
        ids = list(text.encode("utf-8"))
        if self.add_bos:
            ids = [self.BOS] + ids
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", errors="replace")

    @property
    def eos_token_ids(self) -> List[int]:
        return [self.EOS]

    @property
    def bos_token_id(self) -> Optional[int]:
        return self.BOS

    @property
    def vocab_size(self) -> int:
        return 259


class HfTokenizer:
    """HuggingFace tokenizer loaded from a *local* directory's
    ``tokenizer.json`` (offline-only). Encodes without adding special
    tokens and decodes without skipping them, as the JAX package's
    ``HfTokenizer`` calls ``tokenizers``."""

    def __init__(self, path: str):
        from .tokenizer_json import TokenizerJson

        tok_json = os.path.join(path, "tokenizer.json")
        if not os.path.exists(tok_json):
            # a slow-only tokenizer (tokenizer.model, vocab.json +
            # merges.txt) needs transformers, which the port does without
            raise NotImplementedError(
                f"{path} has no tokenizer.json; the torch port reads fast "
                f"tokenizers only (export one with transformers' "
                f"save_pretrained)")
        self._tok = TokenizerJson.from_file(tok_json)
        self._eos_ids, self._bos_id = _special_ids_from_config(path, self)

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(ids)

    def token_to_id(self, token: str) -> Optional[int]:
        return self._tok.token_to_id(token)

    @property
    def eos_token_ids(self) -> List[int]:
        return self._eos_ids

    @property
    def bos_token_id(self) -> Optional[int]:
        return self._bos_id

    @property
    def vocab_size(self) -> int:
        return self._tok.get_vocab_size()


def _special_ids_from_config(path: str, tok: "HfTokenizer"
                             ) -> Tuple[List[int], Optional[int]]:
    eos_ids: List[int] = []
    bos_id: Optional[int] = None
    # generation_config.json may carry a list of eos ids; tokenizer_config the names
    gc = os.path.join(path, "generation_config.json")
    if os.path.exists(gc):
        with open(gc) as f:
            g = json.load(f)
        e = g.get("eos_token_id")
        if isinstance(e, list):
            eos_ids = [int(x) for x in e]
        elif e is not None:
            eos_ids = [int(e)]
        if g.get("bos_token_id") is not None:
            bos_id = int(g["bos_token_id"])
    tc = os.path.join(path, "tokenizer_config.json")
    if os.path.exists(tc):
        with open(tc) as f:
            c = json.load(f)

        def _name(v):
            return v.get("content") if isinstance(v, dict) else v

        if not eos_ids and c.get("eos_token"):
            i = tok.token_to_id(_name(c["eos_token"]))
            if i is not None:
                eos_ids = [i]
        if bos_id is None and c.get("bos_token"):
            i = tok.token_to_id(_name(c["bos_token"]))
            if i is not None:
                bos_id = i
    return eos_ids, bos_id


def load_tokenizer(path_or_kind: str) -> Tokenizer:
    """``"byte"`` → ByteTokenizer; ``"gguf-sp:<file.gguf>"`` → the native
    SentencePiece tokenizer built from the GGUF's embedded SPM vocab;
    ``"gguf-bpe:<file.gguf>"`` → the native byte-level BPE tokenizer from
    the GGUF's tokens+merges; otherwise a local HF tokenizer directory."""
    if path_or_kind == "byte":
        return ByteTokenizer()
    if path_or_kind.startswith("gguf-sp:"):
        from .sp_tokenizer import SpTokenizer

        return SpTokenizer.from_gguf(path_or_kind[len("gguf-sp:"):])
    if path_or_kind.startswith("gguf-bpe:"):
        from .bpe_tokenizer import BpeTokenizer

        return BpeTokenizer.from_gguf(path_or_kind[len("gguf-bpe:"):])
    return HfTokenizer(path_or_kind)


class DecodeStream:
    """Incremental detokenization over a growing token list.

    Uses the prefix/read-offset algorithm: only emit text once the decoded
    suffix no longer ends in a replacement character (i.e. no torn UTF-8), so
    streamed chunks concatenate to exactly ``decode(all_tokens)``.
    """

    # How many trailing prompt tokens to keep as detokenization context (some
    # tokenizers render a token differently at sequence start vs mid-sequence).
    _CTX = 6

    def __init__(self, tokenizer: Tokenizer, prompt_ids: Sequence[int] = ()):
        self._tok = tokenizer
        self._ids: List[int] = list(prompt_ids[-self._CTX:])
        self._prefix_offset = len(self._ids)
        self._read_offset = len(self._ids)

    def step(self, token_id: int) -> str:
        """Feed one token; return newly-finalized text ('' if held back)."""
        self._ids.append(int(token_id))
        prefix = self._tok.decode(self._ids[self._prefix_offset : self._read_offset])
        full = self._tok.decode(self._ids[self._prefix_offset :])
        if full.endswith("�"):
            return ""  # torn multibyte char: wait for more tokens
        new = full[len(prefix) :]
        self._prefix_offset = self._read_offset
        self._read_offset = len(self._ids)
        return new

    def flush(self) -> str:
        """End-of-stream: release any text still held back (even if it ends in
        a torn codepoint, rendered as U+FFFD) so that the concatenation of all
        ``step()`` results plus ``flush()`` equals ``decode(all_tokens)``."""
        prefix = self._tok.decode(self._ids[self._prefix_offset : self._read_offset])
        full = self._tok.decode(self._ids[self._prefix_offset :])
        self._prefix_offset = self._read_offset = len(self._ids)
        return full[len(prefix) :]

    @property
    def token_ids(self) -> List[int]:
        return self._ids


class StopSequenceDecoder:
    """Holds back ("jails") emitted text that could be the start of a stop
    sequence; truncates the stream at a full match.

    ``feed(text) -> (visible_text, stopped)``; call ``flush()`` at end of
    stream to release any jailed text that never completed a stop sequence.
    """

    def __init__(self, stop_sequences: Sequence[str]):
        self._stops = [s for s in stop_sequences if s]
        self._jail = ""
        self.stopped = False

    def feed(self, text: str) -> Tuple[str, bool]:
        if self.stopped:
            return "", True
        if not self._stops:
            return text, False
        buf = self._jail + text
        # full match => truncate at earliest occurrence
        cut = -1
        for s in self._stops:
            i = buf.find(s)
            if i != -1 and (cut == -1 or i < cut):
                cut = i
        if cut != -1:
            self.stopped = True
            self._jail = ""
            return buf[:cut], True
        # partial match at the tail => jail it
        hold = 0
        for s in self._stops:
            for k in range(min(len(s) - 1, len(buf)), 0, -1):
                if buf.endswith(s[:k]):
                    hold = max(hold, k)
                    break
        if hold:
            self._jail = buf[-hold:]
            return buf[:-hold], False
        self._jail = ""
        return buf, False

    def flush(self) -> str:
        out, self._jail = self._jail, ""
        return out
