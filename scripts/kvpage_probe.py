"""Where the KV paging lane's time goes, measured on the card.

Builds the smoke's kvpage engine (``chip_smoke.KVPAGE_ENGINE``: Llama-3-8B
at full width and depth, random bf16 weights from the seed, a 20-page lane
over a 384-block host tier) and drives one greedy 10240-token prompt
straight through ``EngineCore.step`` on this thread:

- each prefill chunk's host seconds, each ending in a synchronize;
- one late chunk again with the pager's prefetch off (the engine thread
  assembles every segment itself) beside one with it on;
- the last chunk, and the second decode window (8 steps), under
  ``torch.profiler``: host seconds, the device's kernel and copy time,
  and the top ops by host time;
- the lane's page-in totals (bytes, assembly and upload seconds).

Prints one JSON line a reading.

    python scripts/kvpage_probe.py      # needs one CUDA card
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _profiled(torch, fn) -> dict:
    """Host seconds of ``fn()`` (ending in a synchronize), the device time
    the profiler saw, and the ten ops with the most host time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    avg = prof.key_averages()
    # the device's own rows (kernels, copies): their spans, summed
    device_us = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    top = sorted(avg, key=lambda e: -e.self_cpu_time_total)[:10]
    return dict(host_s=host_s, device_s=device_us / 1e6,
                launches=sum(e.count for e in avg
                             if e.key == "cudaLaunchKernel"),
                top_host=[(e.key, e.count, e.self_cpu_time_total / 1e6)
                          for e in top])


def main() -> int:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kvpage_probe: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from dynamo_tpu_torch.engine.engine import EngineCore, TorchEngineConfig
    from dynamo_tpu_torch.llm.protocols.common import (BackendInput,
                                                       StopConditions)
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    smi = cs.smi_line()
    m = llama.preset(cs.PRESET)
    dev = torch.device("cuda")
    params = llama.init_params(m, torch.Generator(device=dev).manual_seed(0),
                               dev)
    core = EngineCore(TorchEngineConfig(model=m, device="cuda",
                                        **cs.KVPAGE_ENGINE), params)
    kp = core.kvpager
    prompt = np.random.default_rng(cs.KVPAGE_SEED).integers(
        0, m.vocab_size, cs.KVPAGE_PROMPTS[0]).tolist()
    core.submit("long", BackendInput(token_ids=prompt, stop=StopConditions(
        max_tokens=17, ignore_eos=True)))

    def step():
        core.step()
        torch.cuda.synchronize()

    n_chunks = -(-len(prompt) // core.cfg.prefill_chunk)
    chunks = []
    while kp.prefill_chunks < n_chunks - 3:
        t0 = time.perf_counter()
        step()
        chunks.append(time.perf_counter() - t0)
    print(json.dumps(dict(reading="prefill_chunks_s", chunks=chunks,
                          card=smi)), flush=True)
    for prefetch in (0, kp.pcfg.prefetch):
        kp.pager.prefetch = prefetch
        a0, t0 = kp.assemble_seconds, time.perf_counter()
        step()
        print(json.dumps(dict(reading="late_chunk", prefetch=prefetch,
                              host_s=time.perf_counter() - t0,
                              assemble_s=kp.assemble_seconds - a0,
                              card=smi)), flush=True)
    print(json.dumps(dict(reading="late_chunk_profile", **_profiled(
        torch, step), card=smi)), flush=True)
    step()              # the first decode window: it pins its slots
    print(json.dumps(dict(reading="decode_window_profile", steps=8,
                          **_profiled(torch, step), card=smi)), flush=True)
    while core.has_work:
        step()
    print(json.dumps(dict(reading="pagein", **kp.pagein_stats(),
                          faults=kp.pager.faults, pageins=kp.pager.pageins,
                          card=smi)), flush=True)
    core.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
