"""Model deployment card (MDC): the canonical, serializable description of a
served model — where its artifacts live, which tokenizer/prompt template to
use, context length, and a checksum so distributed components can verify they
agree on the model.

Reference capability: lib/llm/src/model_card/model.rs:55-201 (ModelDeploymentCard,
mdcsum) and create.rs:41-143 (from_local_path).
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

# Default chat template used when the model dir has none (ChatML — a sane
# widely-understood default; models with their own template override it).
CHATML_TEMPLATE = (
    "{% if tools %}"
    "{{ '<|im_start|>system\nYou may call one of these tools by answering "
    "with JSON {\"name\": ..., \"parameters\": {...}}:\n' }}"
    "{% for tool in tools %}{{ tool['function'] | tojson }}{{ '\n' }}{% endfor %}"
    "{{ '<|im_end|>\n' }}"
    "{% endif %}"
    "{% for message in messages %}"
    "{{ '<|im_start|>' + message['role'] + '\n' + message['content'] + '<|im_end|>' + '\n' }}"
    "{% endfor %}"
    "{% if add_generation_prompt %}{{ '<|im_start|>assistant\n' }}{% endif %}"
)


@dataclass
class ModelDeploymentCard:
    name: str
    path: Optional[str] = None            # local dir with config/tokenizer/weights
    tokenizer: str = "byte"               # "byte" or a local tokenizer dir
    chat_template: Optional[str] = None   # jinja2 source
    context_length: int = 8192
    kv_block_size: int = 64
    eos_token_ids: List[int] = field(default_factory=list)
    bos_token_id: Optional[int] = None
    model_config: Dict[str, Any] = field(default_factory=dict)  # HF config.json
    model_type: str = "chat"              # "chat" | "completion" | "both"

    # ------------------------------------------------------------------
    @property
    def mdc_sum(self) -> str:
        """Stable checksum over the card's identifying fields."""
        ident = json.dumps(
            {
                "name": self.name,
                "tokenizer": self.tokenizer,
                "chat_template": self.chat_template,
                "context_length": self.context_length,
                "kv_block_size": self.kv_block_size,
                "eos": self.eos_token_ids,
            },
            sort_keys=True,
        )
        return hashlib.sha256(ident.encode()).hexdigest()[:16]

    def to_dict(self) -> Dict[str, Any]:
        """The card as registered under ``models/`` (JSON-ready)."""
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelDeploymentCard":
        """A card from a registration; fields this version lacks are
        dropped."""
        return cls(**{k: v for k, v in d.items()
                      if k in cls.__dataclass_fields__})

    # ------------------------------------------------------------------
    @classmethod
    def resolve(cls, spec: str,
                name: Optional[str] = None) -> "ModelDeploymentCard":
        """Build a card from a local directory, a GGUF file, or a HF repo id
        resolved from the local HF cache. The port never goes to the
        network: a repo id that is not in the cache raises.

        Reference capability: launch/dynamo-run/src/hub.rs (HF-repo auto-
        download when the model path is missing)."""
        if os.path.isfile(spec) and spec.endswith(".gguf"):
            return cls.from_gguf(spec, name)
        if os.path.exists(spec):
            return cls.from_local_path(spec, name)
        # an "org/name" shape (exactly one slash, relative) is a repo id
        if (spec.count("/") == 1 and not spec.startswith((".", "/"))
                and ".." not in spec):
            try:
                local = hf_cache_snapshot(spec)
            except FileNotFoundError as e:
                raise FileNotFoundError(
                    f"model {spec!r} is neither a local path nor an "
                    f"HF repo available in the local cache: {e}") from e
            # a failure past this point is a real model problem (corrupt
            # config/tokenizer), not a cache miss — let it surface as-is
            return cls.from_local_path(local, name or spec.split("/")[-1])
        raise FileNotFoundError(f"model path {spec!r} does not exist")

    @classmethod
    def from_gguf(cls, path: str,
                  name: Optional[str] = None) -> "ModelDeploymentCard":
        """Build a card from a GGUF model file: config (context length,
        eos ids) comes from the GGUF metadata; the tokenizer uses an
        adjacent tokenizer.json when present, else the GGUF-embedded vocab
        (``llama`` → native SP unigram, ``gpt2`` → native byte-level BPE,
        matching ref gguf_tokenizer.rs:121-125; ``dynamo-byte`` → the raw
        byte tokenizer, an explicit export extension).  An unrecognized or
        missing ``tokenizer.ggml.model`` next to an embedded vocab is a
        hard error — serving a model through a wrong tokenizer is worse
        than failing."""
        from .gguf import read_gguf

        g = read_gguf(path)
        md = g.metadata
        arch = g.architecture() or "gguf"
        card = cls(name=name or os.path.splitext(os.path.basename(path))[0],
                   path=path)
        ctx = md.get(f"{arch}.context_length")
        if ctx:
            card.context_length = int(ctx)
        try:
            eos = md.get("tokenizer.ggml.eos_token_id")
            bos = md.get("tokenizer.ggml.bos_token_id")
            if bos is not None:
                card.bos_token_id = int(bos)
            tok_dir = os.path.dirname(os.path.abspath(path))
            tok_model = md.get("tokenizer.ggml.model")
            if os.path.exists(os.path.join(tok_dir, "tokenizer.json")):
                card.tokenizer = tok_dir
            elif tok_model in ("llama", "gpt2"):
                if not md.get("tokenizer.ggml.tokens"):
                    raise ValueError(
                        f"GGUF {path} declares tokenizer.ggml.model="
                        f"{tok_model!r} but carries no tokenizer.ggml.tokens "
                        "vocab and no adjacent tokenizer.json")
                # embedded vocab: SPM unigram for llama/mistral exports,
                # byte-level BPE (tokens+merges) for Qwen2/GPT-2 family
                kind = "gguf-sp" if tok_model == "llama" else "gguf-bpe"
                card.tokenizer = f"{kind}:{os.path.abspath(path)}"
            elif tok_model == "dynamo-byte":
                # an EXPLICIT declaration that the model was trained on the
                # raw-byte vocab (test fixtures, tiny-byte presets);
                # card.tokenizer keeps its byte default
                pass
            elif tok_model is not None or md.get("tokenizer.ggml.tokens"):
                # never silently degrade to the byte tokenizer: a served
                # model that mis-tokenizes with rc=0 is worse than failing
                raise ValueError(
                    f"unsupported tokenizer.ggml.model {tok_model!r} in "
                    f"{path} and no adjacent tokenizer.json; supported: "
                    "'llama' (SPM unigram), 'gpt2' (byte-level BPE)")
            if eos is not None:
                card.eos_token_ids = [int(eos)]
            else:
                # no eos in the container: the serving tokenizer's eos must
                # still stop generation, or every request runs to max_tokens
                from .tokenizer import load_tokenizer

                card.eos_token_ids = list(
                    load_tokenizer(card.tokenizer).eos_token_ids)
        finally:
            g.close()
        return card

    @classmethod
    def from_local_path(cls, path: str, name: Optional[str] = None) -> "ModelDeploymentCard":
        """Build a card from a local HF-style model directory: its
        ``config.json`` sizes the model, its ``tokenizer.json`` (read by
        the port's own reader) tokenizes."""
        name = name or os.path.basename(os.path.normpath(path))
        card = cls(name=name, path=path)
        cfg_path = os.path.join(path, "config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                card.model_config = json.load(f)
            mpe = card.model_config.get("max_position_embeddings")
            if mpe:
                card.context_length = int(mpe)
        has_tokenizer = any(
            os.path.exists(os.path.join(path, f))
            for f in ("tokenizer.json", "tokenizer_config.json", "vocab.json",
                      "spiece.model", "tokenizer.model")
        )
        if has_tokenizer:
            card.tokenizer = path
            from .tokenizer import HfTokenizer

            tok = HfTokenizer(path)
            card.eos_token_ids = tok.eos_token_ids
            card.bos_token_id = tok.bos_token_id
        card.chat_template = _load_chat_template(path)
        return card

    @classmethod
    def synthetic(cls, name: str = "echo", **kw) -> "ModelDeploymentCard":
        """Card for the byte tokenizer / echo and test engines."""
        from .tokenizer import ByteTokenizer

        return cls(
            name=name,
            tokenizer="byte",
            chat_template=None,
            eos_token_ids=[ByteTokenizer.EOS],
            bos_token_id=ByteTokenizer.BOS,
            **kw,
        )


def _load_chat_template(path: str) -> Optional[str]:
    tc = os.path.join(path, "tokenizer_config.json")
    if os.path.exists(tc):
        with open(tc) as f:
            cfg = json.load(f)
        t = cfg.get("chat_template")
        if isinstance(t, str):
            return t
        if isinstance(t, list):  # named templates
            for entry in t:
                if entry.get("name") == "default":
                    return entry.get("template")
    sep = os.path.join(path, "chat_template.jinja")
    if os.path.exists(sep):
        with open(sep) as f:
            return f.read()
    return None


def hf_cache_snapshot(repo_id: str) -> str:
    """The local snapshot directory of ``repo_id`` ("org/name") in the HF
    cache, as ``huggingface_hub`` lays it out: ``$HF_HUB_CACHE``, else
    ``$HF_HOME/hub``, else ``~/.cache/huggingface/hub``; then
    ``models--org--name/refs/main`` names the revision under
    ``snapshots/``. Offline only; a miss raises FileNotFoundError."""
    cache = os.environ.get("HF_HUB_CACHE")
    if not cache:
        home = os.environ.get("HF_HOME") or os.path.join(
            os.path.expanduser("~"), ".cache", "huggingface")
        cache = os.path.join(home, "hub")
    repo = os.path.join(cache, "models--" + repo_id.replace("/", "--"))
    ref = os.path.join(repo, "refs", "main")
    if not os.path.isfile(ref):
        raise FileNotFoundError(f"no cached snapshot of {repo_id!r} under "
                                f"{cache} (looked for {ref})")
    with open(ref) as f:
        rev = f.read().strip()
    snap = os.path.join(repo, "snapshots", rev)
    if not os.path.isdir(snap):
        raise FileNotFoundError(f"{ref} names revision {rev!r}, but "
                                f"{snap} does not exist")
    return snap
