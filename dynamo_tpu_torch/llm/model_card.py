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
from dataclasses import dataclass, field
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

    # ------------------------------------------------------------------
    @classmethod
    def from_local_path(cls, path: str, name: Optional[str] = None) -> "ModelDeploymentCard":
        """Build a card from a local HF-style model directory: its
        ``config.json`` sizes the model; the byte tokenizer serves it."""
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
            # serving a real checkpoint through the byte tokenizer would
            # mis-tokenize every request: refuse until the HF tokenizer is
            # ported
            raise NotImplementedError(
                f"{path} ships its own tokenizer; only the byte tokenizer is "
                f"available in the torch port so far")
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
