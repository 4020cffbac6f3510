"""Profile sweep: measure (batch, seq-len) -> TTFT/ITL for the SLA policy.

The SLA policy answers "how many replicas does this demand need?" with a
profile table: per (batch, seq_len) point, the measured time-to-first-token
and inter-token latency of ONE replica. The sweep drives anything with the
EngineCore submit/step surface — the port's torch engine on the card
(whose prefills and decode steps run the hand-written flash and paged
kernels), or :class:`SyntheticCore` (a deterministic CPU mock with a virtual clock) so
the table format, interpolation and policy wiring are testable everywhere.

Table format (JSON, ``--out profile.json``)::

    {"engine": "synthetic", "platform": "cpu", "version": 1,
     "points": [{"batch": 1, "seq_len": 128,
                 "ttft_s": 0.11, "itl_s": 0.009, "tok_s": 111.0}, ...]}

``capacity_per_replica(ttft_target, itl_target)`` inverts the table: the
largest concurrency (batch) at which BOTH measured latencies stay inside
the targets, linearly interpolated between measured batch points and taken
conservatively (min) across seq-len rows.

    python -m dynamo_tpu_torch.planner.profile --engine synthetic \
        --batches 1,2,4,8 --seq-lens 128,512 --out profile.json
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

log = logging.getLogger("dynamo_tpu_torch.planner")


@dataclass
class ProfilePoint:
    batch: int
    seq_len: int
    ttft_s: float
    itl_s: float
    tok_s: float

    def to_dict(self) -> Dict[str, Any]:
        return {"batch": self.batch, "seq_len": self.seq_len,
                "ttft_s": round(self.ttft_s, 6),
                "itl_s": round(self.itl_s, 6),
                "tok_s": round(self.tok_s, 2)}


class ProfileTable:
    """Measured points + the interpolations the SLA policy needs."""

    def __init__(self, points: Sequence[ProfilePoint],
                 meta: Optional[Dict[str, Any]] = None):
        if not points:
            raise ValueError("profile table needs at least one point")
        self.points = sorted(points, key=lambda p: (p.seq_len, p.batch))
        self.meta = dict(meta or {})

    # ------------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {**self.meta, "version": 1,
                "points": [p.to_dict() for p in self.points]}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ProfileTable":
        pts = [ProfilePoint(batch=int(p["batch"]),
                            seq_len=int(p["seq_len"]),
                            ttft_s=float(p["ttft_s"]),
                            itl_s=float(p["itl_s"]),
                            tok_s=float(p.get("tok_s", 0.0)))
               for p in d.get("points", [])]
        meta = {k: v for k, v in d.items() if k != "points"}
        return cls(pts, meta)

    @classmethod
    def load(cls, path: str) -> "ProfileTable":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)

    # ------------------------------------------------------------------
    def seq_lens(self) -> List[int]:
        return sorted({p.seq_len for p in self.points})

    def _row(self, seq_len: int) -> List[ProfilePoint]:
        return [p for p in self.points if p.seq_len == seq_len]

    @staticmethod
    def _max_batch_within(row: List[ProfilePoint], ttft_target: float,
                          itl_target: float) -> float:
        """Largest (fractional) batch in this row with ttft AND itl inside
        the targets, linearly interpolated between measured batch points.
        0 when even batch=min violates; the last measured batch when even
        it fits (the table can't see beyond its own sweep)."""
        if not row:
            return 0.0
        row = sorted(row, key=lambda p: p.batch)

        def viol(p: ProfilePoint) -> float:
            # worst relative overshoot across both targets (<= 1 fits)
            return max(p.ttft_s / ttft_target if ttft_target else 0.0,
                       p.itl_s / itl_target if itl_target else 0.0)

        prev = None
        for p in row:
            v = viol(p)
            if v > 1.0:
                if prev is None:
                    return 0.0
                pv = viol(prev)
                if v <= pv:          # non-monotonic noise: stop at prev
                    return float(prev.batch)
                # linear crossing between prev.batch and p.batch
                frac = (1.0 - pv) / (v - pv)
                return prev.batch + frac * (p.batch - prev.batch)
            prev = p
        return float(row[-1].batch)

    def capacity_per_replica(self, ttft_target: float, itl_target: float,
                             seq_len: Optional[int] = None) -> float:
        """Concurrent sequences one replica sustains inside both targets.
        Conservative: the minimum across seq-len rows (or the one row
        asked for). Never below 1 — a replica that can't make SLA at
        batch=1 still serves one sequence at a time."""
        lens = [seq_len] if seq_len is not None else self.seq_lens()
        caps = [self._max_batch_within(self._row(sl), ttft_target,
                                       itl_target) for sl in lens]
        return max(min(caps), 1.0)


# ---------------------------------------------------------------------------
# sweep harness
# ---------------------------------------------------------------------------
class SyntheticCore:
    """Deterministic EngineCore stand-in with a virtual clock: prefill costs
    ``ttft0 + a*seq_len + b*batch*seq_len`` seconds, each decode step costs
    ``itl0 + c*batch``. CPU-only, instant wall-clock — the profile sweep,
    table math and SLA policy are fully testable without an accelerator."""

    def __init__(self, max_batch: int, ttft0: float = 0.05,
                 a: float = 2e-4, b: float = 5e-5,
                 itl0: float = 0.008, c: float = 0.002):
        self.max_batch = max_batch
        self.ttft0, self.a, self.b = ttft0, a, b
        self.itl0, self.c = itl0, c
        self.now = 0.0                       # virtual seconds
        self._seqs: Dict[str, Dict[str, int]] = {}
        self._prefill_done = 0.0

    def clock(self) -> float:
        return self.now

    def submit(self, seq_id: str, request: Any) -> None:
        tokens = request["token_ids"] if isinstance(request, dict) \
            else request.token_ids
        stop = request["max_tokens"] if isinstance(request, dict) \
            else request.stop.max_tokens
        self._seqs[seq_id] = {"remaining": int(stop), "emitted": 0}
        seq_len = len(tokens)
        b = len(self._seqs)
        self._prefill_done = self.now + (
            self.ttft0 + self.a * seq_len + self.b * b * seq_len)

    def step(self) -> List[Any]:
        """One decode dispatch over the whole batch (first call finishes the
        prefill and emits the first tokens)."""
        if not self._seqs:
            return []
        if self._prefill_done > self.now:
            self.now = self._prefill_done
        else:
            self.now += self.itl0 + self.c * len(self._seqs)
        outs = []
        for sid, st in list(self._seqs.items()):
            st["remaining"] -= 1
            st["emitted"] += 1
            finished = st["remaining"] <= 0
            outs.append(_SynthOut(sid, "stop" if finished else None))
            if finished:
                del self._seqs[sid]
        return outs


class _SynthOut:
    __slots__ = ("seq_id", "finish")

    def __init__(self, seq_id: str, finish: Optional[str]):
        self.seq_id = seq_id
        self.finish = finish


def profile_core(core, batch: int, seq_len: int,
                 make_request: Callable[[int, int], Any],
                 clock: Callable[[], float],
                 tag: str = "prof") -> ProfilePoint:
    """Drive one (batch, seq_len) point through a submit/step core and
    measure TTFT (submit -> last first-token) and steady-state ITL."""
    t0 = clock()
    for i in range(batch):
        core.submit(f"{tag}{batch}x{seq_len}_{i}",
                    make_request(i, seq_len))
    done = 0
    first: Dict[str, float] = {}
    t_first = None
    post_tokens = 0
    total_tokens = 0
    while done < batch:
        outs = core.step()
        now = clock()
        counted = t_first is not None
        for so in outs:
            total_tokens += 1
            first.setdefault(so.seq_id, now - t0)
            if so.finish is not None:
                done += 1
        if counted:
            post_tokens += len(outs)
        elif len(first) == batch:
            t_first = now - t0
    wall = clock() - t0
    decode_wall = wall - t_first if t_first else 0.0
    itl = (decode_wall / (post_tokens / batch)
           if post_tokens and decode_wall > 0 else 0.0)
    ttfts = sorted(first.values())
    return ProfilePoint(
        batch=batch, seq_len=seq_len,
        ttft_s=ttfts[len(ttfts) // 2],
        itl_s=itl,
        tok_s=(total_tokens / wall if wall > 0 else 0.0))


def _torch_core_factory(model: Optional[str], model_path: Optional[str],
                        device: str, gen_tokens: int):
    """(make_core(batch, seq_len), make_request, meta) for the torch
    engine. A checkpoint directory's weights load once and every point's
    core shares them; a preset draws its weights from the seed per core,
    as the engine does."""
    from ..engine.engine import EngineCore, TorchEngineConfig
    from ..llm.protocols.common import BackendInput, StopConditions
    from ..models import llama

    params = None
    if model_path:
        from ..engine.loader import load_llama_params
        from ..llm.model_card import ModelDeploymentCard

        card = ModelDeploymentCard.resolve(model_path)
        mcfg = llama.LlamaConfig.from_hf_config(card.model_config)
        params = load_llama_params(model_path, mcfg, device)
    else:
        mcfg = llama.preset(model or "tiny-byte")
    mod = mcfg.vocab_size - 1

    def make_core(b: int, seq_len: int):
        ctx = max(2 * seq_len, 256)
        m = mcfg
        if not model_path and m.max_position < ctx:
            m = llama.preset(model or "tiny-byte", max_position=ctx)
        return EngineCore(TorchEngineConfig(
            model=m, page_size=64, max_batch=b, max_context=ctx,
            prefill_chunk=min(512, seq_len), device=device,
            enable_prefix_reuse=False), params=params)

    def make_request(i: int, sl: int):
        return BackendInput(
            token_ids=[(p * 31 + i * 7) % mod + 1 for p in range(sl)],
            stop=StopConditions(max_tokens=gen_tokens, ignore_eos=True))

    meta = {"platform": "cuda" if device == "cuda" else device,
            "model": model_path or model or "tiny-byte"}
    return make_core, make_request, meta


def run_profile(engine: str, batches: Sequence[int],
                seq_lens: Sequence[int], gen_tokens: int = 32,
                model: Optional[str] = None,
                synthetic_kw: Optional[Dict[str, float]] = None,
                model_path: Optional[str] = None,
                device: str = "cuda") -> ProfileTable:
    """The sweep: one fresh core per (batch, seq_len) point (decode always
    dispatches at full engine width — a max-sized engine would measure
    padding, not batch-b latency). ``engine="torch"`` sweeps the port's
    :class:`~..engine.engine.EngineCore` on ``device`` (the card unless
    the caller asks for the CPU) over a preset (``model``) or a
    checkpoint directory (``model_path``)."""
    if engine not in ("synthetic", "torch"):
        raise ValueError(f"profile engine {engine!r}: synthetic | torch")
    points: List[ProfilePoint] = []
    meta: Dict[str, Any] = {"engine": engine}
    torch_side = None
    for seq_len in seq_lens:
        for b in batches:
            if engine == "synthetic":
                core = SyntheticCore(max_batch=b, **(synthetic_kw or {}))
                clock = core.clock

                def make_request(i: int, sl: int):
                    return {"token_ids": list(range(1, sl + 1)),
                            "max_tokens": gen_tokens}
            else:
                import time

                if torch_side is None:
                    torch_side = _torch_core_factory(model, model_path,
                                                     device, gen_tokens)
                    meta.update(torch_side[2])
                make_core, make_request = torch_side[0], torch_side[1]
                core = make_core(b, seq_len)
                clock = time.monotonic
                # warm round: first launches outside the measurement
                profile_core(core, b, seq_len, make_request, clock,
                             tag="warm")
            points.append(profile_core(core, b, seq_len, make_request,
                                       clock))
            log.info("profiled %s", points[-1].to_dict())
            if engine == "torch":
                core.close()
    return ProfileTable(points, meta)


def main(argv=None) -> int:
    from ..utils.dynconfig import EnvDefaultsParser

    ap = EnvDefaultsParser(prog="dynamo-planner-profile")
    ap.add_argument("--engine", choices=("synthetic", "torch"),
                    default="synthetic")
    ap.add_argument("--model", default=None,
                    help="models.llama preset name (torch engine)")
    ap.add_argument("--model-path", default=None,
                    help="checkpoint directory (torch engine; instead of "
                         "--model)")
    ap.add_argument("--device", default="cuda",
                    help="torch engine device (cuda | cpu)")
    ap.add_argument("--batches", default="1,2,4,8")
    ap.add_argument("--seq-lens", default="128,512")
    ap.add_argument("--gen-tokens", type=int, default=32)
    ap.add_argument("--out", default="profile.json")
    args = ap.parse_args(argv)
    table = run_profile(
        args.engine,
        [int(x) for x in args.batches.split(",") if x],
        [int(x) for x in args.seq_lens.split(",") if x],
        gen_tokens=args.gen_tokens, model=args.model,
        model_path=args.model_path, device=args.device)
    table.save(args.out)
    print(f"profile: {len(table.points)} points -> {args.out}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main(sys.argv[1:]))
