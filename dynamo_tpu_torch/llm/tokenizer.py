"""Tokenizer abstraction: encode/decode + streaming incremental detokenization.

Backend: :class:`ByteTokenizer` — self-contained byte-level tokenizer (vocab =
256 bytes + specials). Lets the whole stack run hermetically with no
downloaded artifacts; also the fixture tokenizer for tests.

Streaming pieces:
- :class:`DecodeStream` — incremental detokenization that never emits a torn
  multi-byte codepoint (prefix/read-offset algorithm).
- :class:`StopSequenceDecoder` — the "jail": holds back text that might be the
  start of a stop sequence until disambiguated, truncates at the match.

Reference capability: lib/llm/src/tokenizers.rs:39-236 (Encoder/Decoder,
DecodeStream, StopSequenceDecoder) and backend.rs stop handling.
"""

from __future__ import annotations

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


def load_tokenizer(path_or_kind: str) -> Tokenizer:
    """``"byte"`` -> :class:`ByteTokenizer`. HuggingFace, GGUF-embedded
    SentencePiece and byte-level BPE tokenizers are not ported yet: asking
    for one raises instead of serving through the wrong vocabulary."""
    if path_or_kind == "byte":
        return ByteTokenizer()
    raise NotImplementedError(
        f"tokenizer {path_or_kind!r}: only the byte tokenizer is available "
        f"in the torch port so far")


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
