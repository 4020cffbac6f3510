"""The port's tokenizers against ``tokenizers``, ``regex`` and the JAX
package's tokenizers.

- ``llm/_uniclass``: the ``\\p{L}``, ``\\p{N}`` and ``\\s`` sets equal
  ``regex``'s on every codepoint Python's ``unicodedata`` assigns, and
  ``\\p{L}`` and ``\\p{N}`` on every codepoint but the surrogates, and the
  GPT-2, Qwen2 and Llama-3 pre-tokenizer patterns split a seeded corpus as
  ``regex`` does.
- ``llm/tokenizer_json``: three tokenizers trained here with ``tokenizers``'
  own trainer (a few hundred merges each, with added special tokens) --
  byte-level BPE with Llama-3's ``Split`` + ``ByteLevel(use_regex=False)``
  + ``ignore_merges``, a Qwen2-style one with ``NFC``, and an SPM-style BPE
  with ``byte_fallback``, the ``Prepend``/``Replace`` normalizer and the
  ``Replace``/``ByteFallback``/``Fuse``/``Strip`` decoder -- plus variants
  (added-token flags, every ``Split`` behaviour, ``Metaspace``): ids and
  decodes (of whole and of random slices) equal ``tokenizers``' on a seeded
  corpus of ASCII, CRLF, digit runs, CJK, combining marks, emoji, NBSP,
  ideographic space, U+001C..U+001F and special tokens mid-text, with the
  merges serialised both as ``"a b"`` and as ``["a", "b"]``.
- ``HfTokenizer`` and ``DecodeStream``: streamed chunks equal the JAX
  package's over the JAX ``HfTokenizer``; eos/bos ids from the configs.
- ``BpeTokenizer`` / ``SpTokenizer`` (GGUF vocabularies) equal the JAX ones.
- A component the reader lacks raises at load.
"""

from __future__ import annotations

import json
import random
import unicodedata

import pytest
import regex
from tokenizers import (Regex, Tokenizer, decoders, models, normalizers,
                        pre_tokenizers, trainers)
from tokenizers import AddedToken

from dynamo_tpu.llm import bpe_tokenizer as jbpe
from dynamo_tpu.llm import sp_tokenizer as jsp
from dynamo_tpu.llm import tokenizer as jtok
from dynamo_tpu_torch.llm import _uniclass
from dynamo_tpu_torch.llm import bpe_tokenizer as tbpe
from dynamo_tpu_torch.llm import sp_tokenizer as tsp
from dynamo_tpu_torch.llm import tokenizer as ttok
from dynamo_tpu_torch.llm.tokenizer_json import (TokenizerJson,
                                                 UnsupportedTokenizer)

FRAGS = ["Hello", "world", "the", "quick", "brown", "fox", "jumps", "over",
         "lazy", "dog", "I'M", "don't", "we've", "12345", "3.14159", "2026",
         "\r\n", "\n\n", "\t", "  ", "   ", "日本語", "のテキスト", "中文",
         "café", "naïve", "é", "ạ̈", "😀", "👍🏽", "\xa0",
         "　", "\x1c", "\x1d\x1e\x1f", "Ｆｕｌｌ", "ß", "İstanbul", "ſ",
         "<", ">", "!!", "...", "$100", "#tag", "@user", "x_y", "CamelCase"]
SPECIALS = ["<|begin_of_text|>", "<|eot_id|>", "<|endoftext|>",
            "<|im_start|>", "<s>", "</s>"]
LLAMA3 = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|"
          r"\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
QWEN2 = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"
         r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")


def corpus(seed: int, n: int, specials=()) -> list:
    r = random.Random(seed)
    out = []
    for _ in range(n):
        parts = []
        for _ in range(r.randint(1, 30)):
            pool = FRAGS + list(specials) if r.random() < 0.1 else FRAGS
            parts.append(r.choice(pool))
            parts.append(r.choice(["", " ", " ", "  ", "\n"]))
        out.append("".join(parts))
    return out


TEXTS = corpus(99, 150, SPECIALS)


# ---------------------------------------------------------------------------
# _uniclass
# ---------------------------------------------------------------------------

def test_uniclass_sets_equal_regex_on_assigned_codepoints():
    assigned = "".join(chr(c) for c in range(0x110000)
                       if unicodedata.category(chr(c)) != "Cn")
    for pat in (r"\p{L}", r"\p{N}", r"\s", r"\S", r"\P{L}",
                r"[^\s\p{L}\p{N}]", r"[\S\p{N}]"):
        ours = set(_uniclass.compile_pattern(pat).findall(assigned))
        theirs = set(regex.findall(pat, assigned))
        assert ours == theirs, (pat, len(ours ^ theirs))
    # Python's re reads U+001C..U+001F as whitespace; White_Space does not
    assert not _uniclass.compile_pattern(r"\s").match("\x1c")


def test_uniclass_sets_equal_regex_on_every_codepoint():
    """Unassigned in Python's ``unicodedata`` too: the committed table is
    ``regex``'s, so letters and numbers of a newer Unicode (Sidetic,
    U+10940, is a letter from Unicode 17.0) split as ``regex`` splits
    them."""
    from dynamo_tpu_torch.llm import _unitable

    every = "".join(chr(c) for c in range(0x110000)
                    if not 0xD800 <= c <= 0xDFFF)
    for pat in (r"\p{L}", r"\p{N}"):
        ours = set(_uniclass.compile_pattern(pat).findall(every))
        theirs = set(regex.findall(pat, every))
        assert ours == theirs, (pat, len(ours ^ theirs))
    assert _uniclass.compile_pattern(r"\p{L}").match("\U00010940")
    assert unicodedata.category("\U00010940") == "Cn"
    assert _unitable.UNICODE_VERSION >= unicodedata.unidata_version


@pytest.mark.parametrize("pat", [tbpe._GPT2_PAT, tbpe._QWEN2_PAT, LLAMA3])
def test_pretokenizer_patterns_split_as_regex_does(pat):
    ours = _uniclass.compile_pattern(pat)
    theirs = regex.compile(pat)
    for s in TEXTS:
        assert ours.findall(s) == theirs.findall(s)


def test_uniclass_refuses_classes_it_does_not_spell_out():
    for pat in (r"\d+", r"\w", r"\p{Lu}", r"[\d]"):
        with pytest.raises(ValueError):
            _uniclass.translate(pat)


# ---------------------------------------------------------------------------
# tokenizer.json
# ---------------------------------------------------------------------------

def _train(tok: Tokenizer, specials, seed: int, alphabet=None, extra=0,
           **kw) -> Tokenizer:
    tr = trainers.BpeTrainer(
        vocab_size=len(specials) + (len(alphabet) if alphabet else 60)
        + 300 + extra, special_tokens=list(specials), show_progress=False,
        initial_alphabet=alphabet or [], **kw)
    tok.train_from_iterator(corpus(seed, 2500), tr)
    return tok


def _llama3() -> Tokenizer:
    t = Tokenizer(models.BPE(ignore_merges=True))
    t.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(LLAMA3), behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    t.decoder = decoders.ByteLevel()
    return _train(t, ["<|begin_of_text|>", "<|eot_id|>"], 1,
                  pre_tokenizers.ByteLevel.alphabet())


def _qwen2() -> Tokenizer:
    t = Tokenizer(models.BPE())
    t.normalizer = normalizers.NFC()
    t.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(QWEN2), behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    t.decoder = decoders.ByteLevel()
    return _train(t, ["<|endoftext|>", "<|im_start|>"], 2,
                  pre_tokenizers.ByteLevel.alphabet())


def _spm() -> Tokenizer:
    t = Tokenizer(models.BPE(byte_fallback=True, fuse_unk=True,
                             unk_token="<unk>"))
    t.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                         normalizers.Replace(" ", "▁")])
    t.decoder = decoders.Sequence([
        decoders.Replace("▁", " "), decoders.ByteFallback(), decoders.Fuse(),
        decoders.Strip(" ", 1, 0)])
    specials = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    return _train(t, specials, 3, limit_alphabet=60)


TRAINED = {"llama3": _llama3(), "qwen2": _qwen2(), "spm": _spm()}


def _variants():
    t = Tokenizer.from_str(TRAINED["llama3"].to_str())
    t.add_special_tokens([AddedToken("<|ls|>", lstrip=True, rstrip=True,
                                     special=True, normalized=False)])
    t.add_tokens([AddedToken("quick brown", normalized=True),
                  AddedToken("fox", single_word=True, normalized=False),
                  AddedToken("lazy", lstrip=True, normalized=True)])
    yield "added-token-flags", t
    for beh in ("removed", "merged_with_previous", "merged_with_next",
                "contiguous"):
        for invert in (False, True):
            t = Tokenizer.from_str(TRAINED["llama3"].to_str())
            t.pre_tokenizer = pre_tokenizers.Sequence([
                pre_tokenizers.Split(Regex(r"\p{N}+| "), behavior=beh,
                                     invert=invert),
                pre_tokenizers.ByteLevel(add_prefix_space=True)])
            yield f"split-{beh}-{invert}", t
    for scheme in ("always", "first", "never"):
        t = Tokenizer.from_str(TRAINED["spm"].to_str())
        t.normalizer = None
        t.pre_tokenizer = pre_tokenizers.Metaspace(prepend_scheme=scheme)
        t.decoder = decoders.Metaspace(prepend_scheme=scheme)
        yield f"metaspace-{scheme}", t
    t = Tokenizer.from_str(TRAINED["qwen2"].to_str())
    t.normalizer = normalizers.Sequence([
        normalizers.NFKC(), normalizers.Replace(Regex(r"\s+"), " ")])
    yield "nfkc-replace-regex", t


CASES = dict(TRAINED, **dict(_variants()))


def _spec(tok: Tokenizer, merges: str) -> dict:
    d = json.loads(tok.to_str())
    m = d["model"]["merges"]
    assert len(m) >= (250 if tok is not TRAINED["spm"] else 200)
    if merges == "strings":
        d["model"]["merges"] = [" ".join(p) if isinstance(p, list) else p
                                for p in m]
    else:
        d["model"]["merges"] = [p.split(" ") if isinstance(p, str) else p
                                for p in m]
    return d


@pytest.mark.parametrize("merges", ["strings", "pairs"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_tokenizer_json_matches_tokenizers(name, merges):
    spec = _spec(CASES[name], merges)
    ours = TokenizerJson(spec)
    ref = Tokenizer.from_str(json.dumps(spec))
    assert ours.get_vocab_size() == ref.get_vocab_size()
    rng = random.Random(7)
    for s in TEXTS:
        ids = ref.encode(s, add_special_tokens=False).ids
        assert ours.encode(s) == ids, s
        assert ours.decode(ids) == ref.decode(ids, skip_special_tokens=False)
        for _ in range(3):   # slices: torn UTF-8, lone byte pieces
            i = rng.randrange(len(ids) + 1)
            j = rng.randrange(i, len(ids) + 1)
            assert ours.decode(ids[i:j]) == ref.decode(
                ids[i:j], skip_special_tokens=False)
    for t in ("<|eot_id|>", "<s>", "Ġthe", "▁the", "nope-not-a-token"):
        assert ours.token_to_id(t) == ref.token_to_id(t)


def _write_dir(tmp_path, tok: Tokenizer, eos="<|eot_id|>"):
    tok.save(str(tmp_path / "tokenizer.json"))
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(
        {"eos_token": {"content": eos}, "bos_token": "<|begin_of_text|>"}))
    return str(tmp_path)


@pytest.mark.parametrize("name", sorted(TRAINED))
def test_decode_stream_chunks_match_jax(tmp_path, name):
    d = _write_dir(tmp_path, TRAINED[name])
    j, t = jtok.HfTokenizer(d), ttok.load_tokenizer(d)
    assert isinstance(t, ttok.HfTokenizer)
    assert (t.eos_token_ids, t.bos_token_id, t.vocab_size) == (
        j.eos_token_ids, j.bos_token_id, j.vocab_size)
    for s in TEXTS[:60]:
        ids = j.encode(s)
        assert t.encode(s) == ids
        cut = len(ids) // 3
        js, ts = jtok.DecodeStream(j, ids[:cut]), ttok.DecodeStream(
            t, ids[:cut])
        assert [ts.step(i) for i in ids[cut:]] == [js.step(i)
                                                    for i in ids[cut:]]
        assert ts.flush() == js.flush()


def test_special_ids_prefer_generation_config(tmp_path):
    d = _write_dir(tmp_path, TRAINED["llama3"])
    (tmp_path / "generation_config.json").write_text(json.dumps(
        {"eos_token_id": [1, 0], "bos_token_id": 0}))
    j, t = jtok.HfTokenizer(d), ttok.HfTokenizer(d)
    assert t.eos_token_ids == j.eos_token_ids == [1, 0]
    assert t.bos_token_id == j.bos_token_id == 0


@pytest.mark.parametrize("patch,what", [
    ({"model": {"type": "WordPiece", "vocab": {}}}, "model"),
    ({"normalizer": {"type": "Lowercase"}}, "normalizer"),
    ({"pre_tokenizer": {"type": "Whitespace"}}, "pre_tokenizer"),
    ({"decoder": {"type": "WordPiece"}}, "decoder"),
    ({"truncation": {"max_length": 8}}, "truncation"),
])
def test_unsupported_components_raise_at_load(patch, what):
    spec = json.loads(TRAINED["llama3"].to_str())
    spec.update(patch)
    with pytest.raises(UnsupportedTokenizer, match=what):
        TokenizerJson(spec)


def test_slow_only_tokenizer_dir_raises(tmp_path):
    (tmp_path / "tokenizer.model").write_bytes(b"\x00")
    with pytest.raises(NotImplementedError, match="tokenizer.json"):
        ttok.load_tokenizer(str(tmp_path))


# ---------------------------------------------------------------------------
# GGUF vocabularies
# ---------------------------------------------------------------------------

def _bpe_metadata(pre: str) -> dict:
    spec = json.loads(TRAINED["llama3"].to_str())
    vocab = spec["model"]["vocab"]
    tokens = [None] * len(vocab)
    for t, i in vocab.items():
        tokens[i] = t
    merges = [" ".join(m) if isinstance(m, list) else m
              for m in spec["model"]["merges"]]
    types = [3 if t.startswith("<|") else 1 for t in tokens]
    return {"tokenizer.ggml.tokens": tokens, "tokenizer.ggml.merges": merges,
            "tokenizer.ggml.token_type": types, "tokenizer.ggml.pre": pre,
            "tokenizer.ggml.bos_token_id": 0,
            "tokenizer.ggml.eos_token_id": 1}


def _sp_metadata(seed: int = 5) -> dict:
    """A synthetic SPM vocab: every 1-5 character piece of the corpus'
    words (spaces as ``▁``) with seeded scores, plus the byte pieces."""
    r = random.Random(seed)
    words = [w for f in FRAGS for w in f.split()] + ["▁" + f for f in FRAGS]
    found = sorted({w[a:a + n] for w in (w.replace(" ", "▁") for w in words)
                    for a in range(len(w)) for n in range(1, 6)})
    r.shuffle(found)
    pieces = (["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
              + found)
    types = [2, 3, 3] + [6] * 256 + [1] * len(found)
    scores = [0.0] * 259 + [-r.random() * 10 for _ in found]
    return {"tokenizer.ggml.model": "llama",
            "tokenizer.ggml.tokens": pieces, "tokenizer.ggml.scores": scores,
            "tokenizer.ggml.token_type": types,
            "tokenizer.ggml.bos_token_id": 1,
            "tokenizer.ggml.eos_token_id": 2}


@pytest.mark.parametrize("pre", ["default", "qwen2", "llama3"])
def test_gguf_bpe_tokenizer_matches_jax(pre):
    md = _bpe_metadata(pre)
    j = jbpe.BpeTokenizer.from_gguf_metadata(md)
    t = tbpe.BpeTokenizer.from_gguf_metadata(md)
    for s in TEXTS:
        ids = j.encode(s)
        assert t.encode(s) == ids
        assert t.decode(ids) == j.decode(ids)
    assert (t.eos_token_ids, t.bos_token_id, t.vocab_size) == (
        j.eos_token_ids, j.bos_token_id, j.vocab_size)


def test_gguf_sp_tokenizer_matches_jax():
    md = _sp_metadata()
    j = jsp.SpTokenizer.from_gguf_metadata(md)
    t = tsp.SpTokenizer.from_gguf_metadata(md)
    for s in TEXTS:
        ids = j.encode(s)
        assert t.encode(s) == ids
        assert t.decode(ids) == j.decode(ids)
    assert (t.eos_token_ids, t.bos_token_id, t.vocab_size) == (
        j.eos_token_ids, j.bos_token_id, j.vocab_size)


def test_load_tokenizer_gguf_kinds_match_jax(tmp_path):
    import numpy as np

    from dynamo_tpu_torch.llm.gguf import write_gguf

    w = {"token_embd.weight": np.zeros((4, 4), np.float32)}
    for kind, md in (("gguf-sp", _sp_metadata()),
                     ("gguf-bpe", {**_bpe_metadata("llama3"),
                                   "tokenizer.ggml.model": "gpt2"})):
        path = str(tmp_path / f"{kind}.gguf")
        write_gguf(path, {"general.architecture": "llama", **md}, w)
        j = jtok.load_tokenizer(f"{kind}:{path}")
        t = ttok.load_tokenizer(f"{kind}:{path}")
        assert type(t).__name__ == type(j).__name__
        for s in TEXTS[:40]:
            assert t.encode(s) == j.encode(s)
