"""The port's XXH3-64 and block-hash chain against ``xxhash`` and the JAX
package's ``dynamo_tpu.llm.tokens``.

- ``xxh3.xxh3_64`` equals ``xxhash.xxh3_64_intdigest`` bit for bit for
  every length 0-1100 (all seven length classes and several long-path
  blocks) under the three seeds the system uses (0, 1337, 1337 ^ 0x10AA),
  and under arbitrary seeds and lengths (hypothesis).
- ``hash_tokens``, ``chain_hash``, ``lora_chain_root``,
  ``compute_block_hashes``, ``compute_seq_hashes`` and ``TokenSequence``
  equal the JAX package's on seeded prompts (ids up to 2^32 + 5, which the
  u32 mask folds) at page sizes 8, 32, 48 and 64, with lora ids 0 and 7.
"""

import numpy as np
import pytest
import xxhash
from hypothesis import given, settings, strategies as st

from dynamo_tpu.llm import tokens as jt
from dynamo_tpu_torch.llm import tokens as tt
from dynamo_tpu_torch.llm.xxh3 import xxh3_64

SEEDS = (0, 1337, 1337 ^ 0x10AA)


@pytest.mark.parametrize("seed", SEEDS)
def test_xxh3_equals_xxhash_every_length(seed):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, 1100, dtype=np.uint8).tobytes()
    bad = [n for n in range(1101)
           if xxh3_64(data[:n], seed)
           != xxhash.xxh3_64_intdigest(data[:n], seed=seed)]
    assert bad == []


@settings(max_examples=60, deadline=None)
@given(data=st.binary(max_size=2500),
       seed=st.integers(min_value=0, max_value=2 ** 64 - 1))
def test_xxh3_equals_xxhash_property(data, seed):
    assert xxh3_64(data, seed) == xxhash.xxh3_64_intdigest(data, seed=seed)


def test_hash_primitives_match_jax():
    rng = np.random.default_rng(1)
    ids = [int(x) for x in rng.integers(0, 2 ** 32 + 6, 200)]
    ids += [2 ** 32 + 5, 2 ** 32, -1]
    for n in (0, 1, 2, 5, 8, 33, 48, 64, 200):
        assert tt.hash_tokens(ids[:n]) == jt.hash_tokens(ids[:n])
    for parent in (None, 0, 7, 2 ** 64 - 1):
        assert tt.chain_hash(parent, 12345) == jt.chain_hash(parent, 12345)
    for lora in (0, 7, 2 ** 63 + 11):
        assert tt.lora_chain_root(lora) == jt.lora_chain_root(lora)


@pytest.mark.parametrize("page", [8, 32, 48, 64])
def test_block_hash_chain_matches_jax(page):
    rng = np.random.default_rng(page)
    prompt = [int(x) for x in rng.integers(0, 2 ** 32 + 6, 4 * page + 5)]
    assert (tt.compute_block_hashes(prompt, page)
            == jt.compute_block_hashes(prompt, page))
    for lora in (0, 7):
        want = jt.compute_seq_hashes(prompt, page, lora_id=lora)
        assert len(want) == 4
        assert tt.compute_seq_hashes(prompt, page, lora_id=lora) == want
        a = tt.TokenSequence.from_tokens(prompt, page, lora_id=lora)
        b = jt.TokenSequence.from_tokens(prompt, page, lora_id=lora)
        assert a.sequence_hashes() == want
        assert a.block_hashes() == b.block_hashes()
        assert a.partial == b.partial and a.total_tokens == b.total_tokens
        assert [(x.tokens, x.parent_sequence_hash) for x in a.blocks] == \
            [(x.tokens, x.parent_sequence_hash) for x in b.blocks]
    # the adapter salt separates chains of the same tokens
    assert (tt.compute_seq_hashes(prompt, page, lora_id=7)[0]
            != tt.compute_seq_hashes(prompt, page)[0])
