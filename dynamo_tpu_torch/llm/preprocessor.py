"""Preprocessor: OpenAI request -> BackendInput (template, tokenize, stops).

This is the forward half of the request pipeline. It renders the chat
template (jinja2), tokenizes, assembles sampling/stop conditions, and attaches
requested annotations (``formatted_prompt``, ``token_ids``).

Reference capability: lib/llm/src/preprocessor.rs:63-359 (OpenAIPreprocessor,
prompt templating, stop-condition assembly, annotations).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import jinja2

from .model_card import CHATML_TEMPLATE, ModelDeploymentCard
from .protocols.common import (
    BackendInput,
    OutputOptions,
    SamplingOptions,
    StopConditions,
)
from .protocols.openai import ChatCompletionRequest, CompletionRequest, ProtocolError
from .tokenizer import Tokenizer, load_tokenizer

_JINJA_ENV = jinja2.Environment(
    loader=jinja2.BaseLoader(), trim_blocks=False, lstrip_blocks=False,
    # chat templates use tojson and raise_exception
    extensions=[],
)
_JINJA_ENV.globals["raise_exception"] = lambda msg: (_ for _ in ()).throw(
    ProtocolError(f"chat template error: {msg}")
)


def content_text(content: Any) -> str:
    """Message content as text: plain string, OpenAI multipart list of
    {'type':'text','text':...} parts, or None (tool-call messages)."""
    if isinstance(content, str):
        return content
    if isinstance(content, list):
        return "".join(p.get("text", "") for p in content
                       if isinstance(p, dict))
    return "" if content is None else str(content)


# VLM: image parts are replaced by a sentinel in the rendered prompt, then
# spliced back as placeholder TOKEN ids after segmented tokenization (the
# byte-level sentinel survives any template; token-level splicing is what
# HF processors do too — boi + N soft tokens + eoi per image)
_IMG_SENTINEL = "\x00<dynimg:{k}>\x00"
_IMG_SPLIT = re.compile("\x00<dynimg:(\\d+)>\x00")


def _decode_data_url(url: str):
    """data:image/png;base64,... -> uint8 HWC RGB numpy array, decoded by
    the port's own PNG reader (``_png``: PIL's ``convert("RGB")`` pixels
    bit for bit); any other format is a ProtocolError naming it."""
    import base64

    from . import _png

    if not url.startswith("data:"):
        raise ProtocolError(
            "only data: image URLs are supported (no egress from the "
            "serving host); send base64-embedded images")
    try:
        payload = url.split(",", 1)[1]
        raw = base64.b64decode(payload)
        return _png.decode(raw)
    except ProtocolError:
        raise
    except Exception as e:
        raise ProtocolError(f"could not decode image: {e}") from e


def image_kv_salt(lora_id: int, images: List[Any]) -> int:
    """KV block-hash chain salt for a VLM request: ``lora_id`` folded with a
    digest of the raw decoded pixel content. Computed HERE (frontend) and
    carried on ``BackendInput.kv_salt`` so the KV router's prefix-overlap
    scoring and the engine's published blocks hash under the SAME salt —
    identical (prompt, images) requests match across workers, while the same
    placeholder tokens with different images can never alias."""
    import hashlib

    import numpy as np

    h = hashlib.blake2b(digest_size=8)
    for im in images:
        arr = np.ascontiguousarray(np.asarray(im))
        h.update(arr.tobytes())
    digest = int.from_bytes(h.digest(), "little")
    return (lora_id ^ digest) & ((1 << 63) - 1)


def has_images(messages: List[Dict[str, Any]]) -> bool:
    """Whether any message carries an ``image_url`` part."""
    return any(isinstance(m.get("content"), list) and any(
        isinstance(p, dict) and p.get("type") == "image_url"
        for p in m["content"]) for m in messages)


def extract_images(messages: List[Dict[str, Any]]
                   ) -> Tuple[List[Any], List[Dict[str, Any]]]:
    """Pull image_url parts out of OpenAI multipart messages; each becomes
    a decoded pixel array plus an in-text sentinel marking its position."""
    images: List[Any] = []
    out = []
    for m in messages:
        c = m.get("content")
        if has_images([m]):
            parts = []
            for p in c:
                if isinstance(p, dict) and p.get("type") == "image_url":
                    url = (p.get("image_url") or {}).get("url", "")
                    images.append(_decode_data_url(url))
                    parts.append({"type": "text",
                                  "text": _IMG_SENTINEL.format(
                                      k=len(images) - 1)})
                else:
                    parts.append(p)
            m = {**m, "content": parts}
        out.append(m)
    return images, out


@dataclass
class PreprocessedRequest:
    backend_input: BackendInput
    formatted_prompt: Optional[str]
    annotations: Dict[str, Any]


class Preprocessor:
    """Stateless per-model preprocessor bound to a card + tokenizer."""

    def __init__(self, card: ModelDeploymentCard, tokenizer: Optional[Tokenizer] = None):
        self.card = card
        self.tokenizer = tokenizer or load_tokenizer(card.tokenizer)
        src = card.chat_template or CHATML_TEMPLATE
        self._template = _JINJA_ENV.from_string(src)

    # ------------------------------------------------------------------
    def render_chat(self, messages: List[Dict[str, Any]],
                    tools: Optional[List[Dict[str, Any]]] = None) -> str:
        # normalize OpenAI multipart content ([{'type':'text','text':...}])
        # and None (tool-call messages) to plain strings: chat templates
        # concatenate content directly
        msgs = [{**m, "content": content_text(m.get("content"))}
                for m in messages]
        try:
            return self._template.render(
                messages=msgs,
                tools=tools,
                add_generation_prompt=True,
                bos_token="",
                eos_token="",
            )
        except jinja2.TemplateError as e:
            raise ProtocolError(f"chat template failed: {e}") from e

    # ------------------------------------------------------------------
    def preprocess_chat(self, req: ChatCompletionRequest) -> PreprocessedRequest:
        images: List[Any] = []
        messages = req.messages
        if not bool(req.ext.get("use_raw_prompt")):
            images, messages = extract_images(messages)
        if bool(req.ext.get("use_raw_prompt")) and req.messages:
            # raw-prompt escape hatch: single user message passed through untemplated
            prompt = "".join(str(m.get("content", "")) for m in req.messages)
        else:
            # tool_choice='none' disables the matcher, so the tool list must
            # stay out of the prompt too — otherwise the template invites
            # tool-call JSON that would stream back as plain content
            tools = None if req.tool_choice == "none" else req.tools
            prompt = self.render_chat(messages, tools)
        if images:
            token_ids = self._encode_with_images(prompt, len(images))
        else:
            token_ids = self.tokenizer.encode(prompt)
        bi = self._assemble(
            token_ids,
            model=req.model,
            max_tokens=req.max_tokens,
            stop=req.stop,
            temperature=req.temperature,
            top_p=req.top_p,
            top_k=req.top_k,
            n=req.n,
            seed=req.seed,
            frequency_penalty=req.frequency_penalty,
            presence_penalty=req.presence_penalty,
            min_tokens=req.min_tokens,
            ignore_eos=req.ignore_eos,
            logprobs=(req.top_logprobs if req.top_logprobs is not None else 0)
            if req.logprobs else None,
        )
        if images:
            bi.images = images
            bi.kv_salt = image_kv_salt(bi.lora_id, images)
        if req.ext.get("no_spec"):
            # per-request speculative-decoding opt-out — also how the
            # frontend's brownout level >= 3 sheds spec's extra programs
            bi.no_spec = True
        annotations = self._annotations(req.ext, prompt, token_ids)
        bi.annotations = annotations
        return PreprocessedRequest(bi, prompt, annotations)

    def _encode_with_images(self, prompt: str, n_images: int) -> List[int]:
        """Segmented tokenization around image sentinels: text segments
        encode normally; each sentinel becomes [boi] + mm_tokens x
        [image_token_id] + [eoi] from the card's model config."""
        mc = self.card.model_config or {}
        # hub Gemma3 configs spell these *_index (image_token_index,
        # boi/eoi_token_index); newer transformers re-exports *_id — accept
        # both, or every real image request is rejected below
        img_id = mc.get("image_token_id", mc.get("image_token_index"))
        if img_id is None:
            raise ProtocolError(
                "this model takes no image input (no image_token_id in "
                "its config)")
        mm_tokens = int(mc.get("mm_tokens_per_image", 256))
        boi = mc.get("boi_token_id", mc.get("boi_token_index"))
        eoi = mc.get("eoi_token_id", mc.get("eoi_token_index"))
        ids: List[int] = []
        pieces = _IMG_SPLIT.split(prompt)
        # split() yields [text, idx, text, idx, ..., text]
        for i, piece in enumerate(pieces):
            if i % 2 == 0:
                if piece:
                    ids.extend(self.tokenizer.encode(piece))
            else:
                if int(piece) >= n_images:
                    raise ProtocolError("image sentinel out of range")
                if boi is not None:
                    ids.append(int(boi))
                ids.extend([int(img_id)] * mm_tokens)
                if eoi is not None:
                    ids.append(int(eoi))
        return ids

    def preprocess_completion(self, req: CompletionRequest) -> PreprocessedRequest:
        prompt: Optional[str]
        raw_prompt = req.prompt
        if (isinstance(raw_prompt, list) and len(raw_prompt) == 1
                and isinstance(raw_prompt[0], str)):
            raw_prompt = raw_prompt[0]  # single-element batch == plain string
        if isinstance(raw_prompt, list) and not raw_prompt:
            raise ProtocolError("prompt must not be empty")
        if isinstance(raw_prompt, list) and all(isinstance(x, str) for x in raw_prompt):
            raise ProtocolError(
                "multi-prompt batch completions are not supported yet; send one "
                "request per prompt")
        if isinstance(raw_prompt, str):
            prompt = raw_prompt
            token_ids = self.tokenizer.encode(prompt)
        elif isinstance(raw_prompt, list) and all(isinstance(x, int) for x in raw_prompt):
            prompt = None
            token_ids = list(raw_prompt)
            if any(t < 0 or t >= 1 << 32 for t in token_ids):
                raise ProtocolError("token ids must be in [0, 2^32)")
        else:
            raise ProtocolError("prompt must be a string or a list of token ids")
        bi = self._assemble(
            token_ids,
            model=req.model,
            max_tokens=req.max_tokens,
            stop=req.stop,
            temperature=req.temperature,
            top_p=req.top_p,
            top_k=req.top_k,
            n=req.n,
            seed=req.seed,
            frequency_penalty=req.frequency_penalty,
            presence_penalty=req.presence_penalty,
            min_tokens=req.min_tokens,
            ignore_eos=req.ignore_eos,
            logprobs=req.logprobs,
            echo=req.echo,
        )
        if req.ext.get("no_spec"):
            bi.no_spec = True   # see preprocess_chat
        annotations = self._annotations(req.ext, prompt, token_ids)
        bi.annotations = annotations
        return PreprocessedRequest(bi, prompt, annotations)

    # ------------------------------------------------------------------
    def _assemble(self, token_ids: List[int], *, model: str,
                  max_tokens: Optional[int], stop: List[str],
                  temperature: Optional[float], top_p: Optional[float],
                  top_k: Optional[int], n: int, seed: Optional[int],
                  frequency_penalty: Optional[float] = None,
                  presence_penalty: Optional[float] = None,
                  min_tokens: Optional[int] = None, ignore_eos: bool = False,
                  logprobs: Optional[int] = None, echo: bool = False) -> BackendInput:
        ctx = self.card.context_length
        if len(token_ids) >= ctx:
            raise ProtocolError(
                f"prompt of {len(token_ids)} tokens exceeds the model context "
                f"length of {ctx}"
            )
        budget = ctx - len(token_ids)
        mt = min(max_tokens, budget) if max_tokens is not None else budget
        if max_tokens is not None and max_tokens < 1:
            raise ProtocolError("max_tokens must be >= 1")
        return BackendInput(
            token_ids=token_ids,
            sampling=SamplingOptions(
                temperature=temperature,
                top_p=top_p,
                top_k=top_k,
                frequency_penalty=frequency_penalty,
                presence_penalty=presence_penalty,
                seed=seed,
                n=n,
            ),
            stop=StopConditions(
                max_tokens=mt,
                stop=list(stop),
                min_tokens=min_tokens,
                ignore_eos=ignore_eos,
            ),
            output=OutputOptions(logprobs=logprobs, echo=echo),
            eos_token_ids=list(self.card.eos_token_ids),
            model=model,
            mdc_sum=self.card.mdc_sum,
        )

    @staticmethod
    def _annotations(ext: Dict[str, Any], prompt: Optional[str],
                     token_ids: List[int]) -> Dict[str, Any]:
        want = set(ext.get("annotations", []) or [])
        out: Dict[str, Any] = {}
        if "formatted_prompt" in want and prompt is not None:
            out["formatted_prompt"] = prompt
        if "token_ids" in want:
            out["token_ids"] = token_ids
        return out
