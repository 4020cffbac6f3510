"""Token-block chunking and chained block hashing.

The whole KV subsystem (router radix index, reuse pool, transfer protocol)
keys on fixed-size token blocks with two 64-bit hashes per block:

- ``block_hash``  — hash of the block's own tokens (position independent).
- ``sequence_hash`` — chained hash folding in the parent block's sequence
  hash, so equal sequence_hash ⇒ equal full prefix. This is what prefix
  matching and block reuse key on.

The hashes are XXH3-64 from :mod:`.xxh3` (no ``xxhash`` dependency), equal
bit for bit to the JAX package's, so torch and JAX workers share one router
index and one KV cluster.

Reference capability: lib/llm/src/tokens.rs:30-226 (TokenBlock/TokenSequence)
and lib/llm/src/kv_router/indexer.rs:87-123 (xxh3 block hashing).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Sequence

from .xxh3 import xxh3_64

# Seed pinned so hashes are stable across processes/hosts (wire protocol).
_HASH_SEED = 1337


def hash_tokens(tokens: Sequence[int], seed: int = _HASH_SEED) -> int:
    """xxh3-64 over the little-endian u32 encoding of the tokens.

    Ids are masked to u32 so out-of-range values (which the preprocessor
    rejects at the API edge) can never raise from deep inside the KV path.
    """
    return xxh3_64(
        struct.pack(f"<{len(tokens)}I", *(t & 0xFFFFFFFF for t in tokens)),
        seed)


def chain_hash(parent_sequence_hash: Optional[int], block_hash: int) -> int:
    """Fold a block hash into the running sequence hash."""
    parent = parent_sequence_hash if parent_sequence_hash is not None else 0
    return xxh3_64(struct.pack("<QQ", parent, block_hash), _HASH_SEED)


def lora_chain_root(lora_id: int) -> Optional[int]:
    """Root of the sequence-hash chain for an adapter.

    ``lora_id`` salts the chain at its ROOT, so every sequence hash
    downstream is adapter-distinct: identical tokens under different LoRA
    adapters can never alias in the radix index (ref carries lora_id
    through the C ABI, lib/bindings/c/src/lib.rs:253-283; folding it into
    the hash is the indexer-side half it left as a TODO,
    kv_router/indexer.rs:104-110). ``lora_id == 0`` (base model) keeps
    chains bit-identical to the unsalted protocol."""
    if not lora_id:
        return None
    return xxh3_64(struct.pack("<Q", lora_id & 0xFFFFFFFFFFFFFFFF),
                   _HASH_SEED ^ 0x10AA)


@dataclass(frozen=True)
class TokenBlock:
    """A full block of ``block_size`` tokens with its two hashes."""

    tokens: tuple
    block_hash: int
    sequence_hash: int
    parent_sequence_hash: Optional[int] = None

    def __len__(self) -> int:
        return len(self.tokens)


@dataclass
class TokenSequence:
    """An append-only token stream chunked into hashed blocks.

    ``blocks`` holds completed blocks; ``partial`` the tail (< block_size).
    Appending tokens seals blocks as they fill, maintaining the hash chain.
    """

    block_size: int
    blocks: List[TokenBlock] = field(default_factory=list)
    partial: List[int] = field(default_factory=list)
    lora_id: int = 0            # salts the chain root (adapter-distinct)

    @classmethod
    def from_tokens(cls, tokens: Iterable[int], block_size: int,
                    lora_id: int = 0) -> "TokenSequence":
        seq = cls(block_size=block_size, lora_id=lora_id)
        seq.extend(tokens)
        return seq

    def extend(self, tokens: Iterable[int]) -> None:
        for t in tokens:
            self.append(int(t))

    def append(self, token: int) -> Optional[TokenBlock]:
        """Append one token; returns the newly sealed block if one completed."""
        self.partial.append(token)
        if len(self.partial) < self.block_size:
            return None
        parent = (self.blocks[-1].sequence_hash if self.blocks
                  else lora_chain_root(self.lora_id))
        bh = hash_tokens(self.partial)
        block = TokenBlock(
            tokens=tuple(self.partial),
            block_hash=bh,
            sequence_hash=chain_hash(parent, bh),
            parent_sequence_hash=parent,
        )
        self.blocks.append(block)
        self.partial = []
        return block

    @property
    def total_tokens(self) -> int:
        return len(self.blocks) * self.block_size + len(self.partial)

    def all_tokens(self) -> List[int]:
        out: List[int] = []
        for b in self.blocks:
            out.extend(b.tokens)
        out.extend(self.partial)
        return out

    def sequence_hashes(self) -> List[int]:
        return [b.sequence_hash for b in self.blocks]

    def block_hashes(self) -> List[int]:
        return [b.block_hash for b in self.blocks]


def compute_block_hashes(tokens: Sequence[int], block_size: int) -> List[int]:
    """Per-block content hashes for the full blocks of ``tokens`` (the router's
    match key stream; partial trailing block is excluded)."""
    return [
        hash_tokens(tokens[i : i + block_size])
        for i in range(0, len(tokens) - block_size + 1, block_size)
    ]


def compute_seq_hashes(tokens: Sequence[int], block_size: int,
                       lora_id: int = 0) -> List[int]:
    """Chained sequence hashes for the full blocks of ``tokens``; the chain
    root is salted by ``lora_id`` (0 = base model, unsalted)."""
    out: List[int] = []
    parent: Optional[int] = lora_chain_root(lora_id)
    for i in range(0, len(tokens) - block_size + 1, block_size):
        h = chain_hash(parent, hash_tokens(tokens[i : i + block_size]))
        out.append(h)
        parent = h
    return out
