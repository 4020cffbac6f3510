"""Engine-agnostic internal request/response protocol.

The preprocessor lowers OpenAI requests into :class:`BackendInput` (token ids +
sampling + stop conditions); engines stream back :class:`EngineOutput` deltas.
Reference capability: lib/llm/src/protocols/common.rs and
lib/llm/src/protocols/common/llm_backend.rs:1-126.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field, asdict
from typing import Any, Dict, List, Optional


class FinishReason(str, enum.Enum):
    EOS = "eos"          # hit an end-of-sequence token
    STOP = "stop"        # hit a stop string/token from the request
    LENGTH = "length"    # hit max_tokens / context limit
    CANCELLED = "cancelled"
    ERROR = "error"

    def to_openai(self) -> str:
        if self in (FinishReason.EOS, FinishReason.STOP):
            return "stop"
        if self is FinishReason.LENGTH:
            return "length"
        return "stop" if self is FinishReason.CANCELLED else "error"


@dataclass
class SamplingOptions:
    temperature: Optional[float] = None  # None/0 => greedy
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    frequency_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
    repetition_penalty: Optional[float] = None
    seed: Optional[int] = None
    n: int = 1

    @property
    def greedy(self) -> bool:
        return not self.temperature or self.temperature <= 0.0


@dataclass
class StopConditions:
    max_tokens: Optional[int] = None
    stop: List[str] = field(default_factory=list)          # stop strings
    stop_token_ids: List[int] = field(default_factory=list)
    min_tokens: Optional[int] = None
    ignore_eos: bool = False


@dataclass
class OutputOptions:
    logprobs: Optional[int] = None
    echo: bool = False  # completions-style prompt echo


@dataclass
class BackendInput:
    """What an engine consumes: pure tokens + generation config."""

    token_ids: List[int]
    sampling: SamplingOptions = field(default_factory=SamplingOptions)
    stop: StopConditions = field(default_factory=StopConditions)
    output: OutputOptions = field(default_factory=OutputOptions)
    eos_token_ids: List[int] = field(default_factory=list)
    model: Optional[str] = None
    mdc_sum: Optional[str] = None  # model deployment card checksum
    annotations: Dict[str, Any] = field(default_factory=dict)
    # LoRA adapter the request targets (0 = base model). Salts the KV
    # block-hash chain so adapter KV can never alias base/other-adapter KV
    # in prefix reuse or the router index (ref C ABI lib.rs:253-283).
    lora_id: int = 0
    # KV block-hash chain salt (0 = derive from lora_id / image content at
    # the engine). The frontend sets this for VLM requests — lora_id folded
    # with an image-content digest — so the KV router's prefix-overlap
    # scoring hashes with the SAME salt the engine publishes blocks under
    # (without it, KV-aware routing is silently a no-op for image prompts).
    kv_salt: int = 0
    # speculative decoding opt-out: the engine proposes zero drafts for
    # this request (its decode degenerates to plain single-token steps
    # inside the verify dispatch).
    no_spec: bool = False
    # cluster KV sharing (llm/kv_cluster/): the donor worker the router
    # elected for this request's prefix (0 = none). The receiving worker
    # fetches the blocks it lacks from this peer's host tier BEFORE the
    # request enters the engine — no registry round-trip on the worker.
    # kv_donor_blocks bounds the fetch to the consecutive prefix length
    # the router actually scored (the donor may have sealed more since).
    kv_donor: int = 0
    kv_donor_blocks: int = 0
    # Mid-stream resume (llm/resume.py): number of tokens at the TAIL of
    # ``token_ids`` that were already emitted to the client by a previous
    # (now dead) worker. The engine treats the full sequence as prefix —
    # restoring surviving KV / teacher-forcing the tail, never re-emitting
    # those tokens — and generation continues from position len(token_ids).
    # Sampled requests re-seed their RNG stream as a function of
    # (seed, resume_pos) so a resumed stream never replays the dead
    # worker's draws against a different KV state.
    resume_pos: int = 0
    # VLM: normalized pixel arrays ([3, H, W]; the engine's vision tower
    # encodes them at prefill). On the wire each image travels as
    # {"b64": base64 raw bytes, "shape": [...], "dtype": "..."} — nested
    # per-pixel int lists (~tens of MB per image as JSON numbers) are still
    # ACCEPTED on read for one release, but no longer produced.
    # Image k fills the k-th ``image_token_id`` placeholder run.
    images: Optional[List[Any]] = None

    def to_dict(self) -> Dict[str, Any]:
        if self.images is None:
            return asdict(self)
        import base64

        import numpy as np
        from dataclasses import replace

        # exclude the pixel arrays from asdict's deep copy; convert once
        d = asdict(replace(self, images=None))
        d["images"] = []
        for im in self.images:
            arr = np.ascontiguousarray(np.asarray(im))
            d["images"].append({
                "b64": base64.b64encode(arr.tobytes()).decode("ascii"),
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
            })
        return d

    @staticmethod
    def _decode_image(e: Any):
        """One wire image -> pixel array: base64 envelope or the legacy
        nested-list encoding (accepted for one release)."""
        if isinstance(e, dict) and "b64" in e:
            import base64

            import numpy as np
            return np.frombuffer(
                base64.b64decode(e["b64"]),
                dtype=np.dtype(e.get("dtype", "uint8"))
            ).reshape(e.get("shape", (-1,)))
        return e

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BackendInput":
        images = d.get("images")
        if images is not None:
            images = [cls._decode_image(e) for e in images]
        return cls(
            token_ids=list(d["token_ids"]),
            sampling=SamplingOptions(**d.get("sampling", {})),
            stop=StopConditions(**d.get("stop", {})),
            output=OutputOptions(**d.get("output", {})),
            eos_token_ids=list(d.get("eos_token_ids", [])),
            model=d.get("model"),
            mdc_sum=d.get("mdc_sum"),
            annotations=dict(d.get("annotations", {})),
            lora_id=int(d.get("lora_id", 0)),
            kv_salt=int(d.get("kv_salt", 0)),
            no_spec=bool(d.get("no_spec", False)),
            kv_donor=int(d.get("kv_donor", 0)),
            kv_donor_blocks=int(d.get("kv_donor_blocks", 0)),
            resume_pos=int(d.get("resume_pos", 0)),
            images=images,
        )


@dataclass
class EngineOutput:
    """One streamed step from a core engine: newly generated token ids (and
    optionally text, if the engine detokenizes itself)."""

    token_ids: List[int] = field(default_factory=list)
    text: Optional[str] = None
    cum_log_prob: Optional[float] = None
    logprobs: Optional[List[Dict[str, float]]] = None
    finish_reason: Optional[FinishReason] = None
    # human-readable cause when finish_reason == ERROR — surfaced all the
    # way to the SSE client instead of a silently terminated stream
    error: Optional[str] = None
    # typed-error triple accompanying ``error``: http-ish status plus the
    # stage/reason fields of the uniform error body, so an engine-side
    # 400/503 maps to that status at the HTTP edge (and over the wire)
    # instead of a generic 500
    error_code: Optional[int] = None
    error_stage: Optional[str] = None
    error_reason: Optional[str] = None
    # engine-side bookkeeping surfaced for routing/metrics
    kv_prefix_hit_tokens: Optional[int] = None
    index: int = 0  # choice index for n>1

    @property
    def finished(self) -> bool:
        return self.finish_reason is not None

    def to_dict(self) -> Dict[str, Any]:
        d = asdict(self)
        if self.finish_reason is not None:
            d["finish_reason"] = self.finish_reason.value
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "EngineOutput":
        fr = d.get("finish_reason")
        return cls(
            token_ids=list(d.get("token_ids", [])),
            text=d.get("text"),
            cum_log_prob=d.get("cum_log_prob"),
            logprobs=d.get("logprobs"),
            finish_reason=FinishReason(fr) if fr else None,
            error=d.get("error"),
            error_code=d.get("error_code"),
            error_stage=d.get("error_stage"),
            error_reason=d.get("error_reason"),
            kv_prefix_hit_tokens=d.get("kv_prefix_hit_tokens"),
            index=d.get("index", 0),
        )
