"""What the KV paging lane's correctness gate reads, sound and broken, on
the card.

Builds the smoke's kvpage engine (``chip_smoke.KVPAGE_ENGINE``: Llama-3-8B
at full width and depth, random bf16 weights from the seed, a 20-page lane
over a 384-block host tier) and serves greedy streams through it, each
held to the dense path's teacher-forced logits over the lane's own tokens
(``chip_smoke.kvpage_stream_check``: per step the most |paged - dense|
logit, the relative L2 distance and the dense margin of the chosen token):

- sound: the 10240- and the 6144-token prompt from an empty tier, 16
  tokens each;
- then the 10240-token prompt again from its pinned prefix, 8 tokens a
  run, with each of ``chip_smoke.kvpage_fault``'s variants planted: none,
  a delayed upload with its wait kept, uncached decode windows (sound),
  the upload wait dropped with and without the delay, one cold segment
  dropped, bf16 online-softmax sums (faults).

Prints one JSON line a run and a summary line: the sound runs' largest
reading beside each fault's.

    python scripts/kvpage_faults.py      # needs one CUDA card
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SOUND = ("none", "delayed_upload", "uncached_window")
FAULTS = ("no_upload_wait_undelayed", "no_upload_wait", "drop_segment",
          "bf16_merge")


def main() -> int:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kvpage_faults: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    smi = cs.smi_line()
    cs.KVPAGE_LOGIT_LIMIT = float("inf")    # readings only: no limit yet
    m = llama.preset(cs.PRESET)
    dev = torch.device("cuda")
    params = llama.init_params(m, torch.Generator(device=dev).manual_seed(0),
                               dev)
    rng = np.random.default_rng(cs.KVPAGE_SEED)
    long_p, mid_p = (rng.integers(0, m.vocab_size, n).tolist()
                     for n in cs.KVPAGE_PROMPTS)
    eng = TorchEngine(TorchEngineConfig(model=m, device="cuda",
                                        **cs.KVPAGE_ENGINE), params)
    runs = []
    try:
        for key, prompt in (("long", long_p), ("mid", mid_p)):
            row = cs.kvpage_fault_run(torch, eng, prompt, "none",
                                      cs.KVPAGE_TOKENS)
            runs.append(dict(row, prompt=key, card=smi))
            print(json.dumps(runs[-1]), flush=True)
        for name in SOUND + FAULTS:
            row = cs.kvpage_fault_run(torch, eng, long_p, name, 8)
            runs.append(dict(row, prompt="long", card=smi))
            print(json.dumps(runs[-1]), flush=True)
    finally:
        eng.shutdown()

    def worst(rows, key):
        return max(r["teacher_forced"][key] for r in rows)

    sound = [r for r in runs if r["fault"] in SOUND]
    summary = dict(
        reading="summary", card=smi,
        sound=dict(runs=len(sound), worst_abs=worst(sound, "worst_abs"),
                   worst_rel=worst(sound, "worst_rel"),
                   worst_margin=worst(sound, "worst_margin")),
        faults={r["fault"]: dict(worst_abs=r["teacher_forced"]["worst_abs"],
                                 worst_rel=r["teacher_forced"]["worst_rel"],
                                 worst_margin=r["teacher_forced"][
                                     "worst_margin"])
                for r in runs if r["fault"] in FAULTS})
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
