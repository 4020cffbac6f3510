"""Where the flash kernel's time goes, on the card (a measurement tool).

    python -m dynamo_tpu_torch.ops.flash_probe

Needs one CUDA card and ``nvcc``; prints JSON lines:

1. ``mma_sync`` — the card's ``mma.sync.m16n8k16`` bf16 -> f32 rate from a
   microbenchmark (8 independent accumulators per warp) with 1, 2 and 4
   warps per SM sub-partition: the ceiling of any kernel built on it.
2. ``ablation`` — ``csrc/flash_attention.cu`` at the Llama-3-8B serve
   shapes beside copies of it with one piece removed (the K fragment loads,
   the V fragment loads, the exponentials). The copies compute wrong
   results and are only timed: the time a piece's removal saves is what
   that piece costs on the kernel's critical path.
3. ``library`` — the kernels that ``F.scaled_dot_product_attention`` runs
   for the same inputs (names from ``torch.profiler``) and its time.

Times are means over 30 launches by CUDA events, with a spin kernel holding
the card while the host enqueues them.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import torch
import torch.nn.functional as F

from . import _build
from .attention import _FLASH_ARGS, flash_attention_plain

_MMA_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void mma_rate(float* out, int iters, long long* cycles) {
    uint32_t a[4] = {0x3f803f80u, 0x3f803f80u, 0x3f803f80u, 0x3f803f80u};
    const uint32_t b0 = 0x3c003c00u ^ threadIdx.x, b1 = 0x3c003c00u;
    float c[8][4] = {};
    const long long t0 = clock64();
    for (int i = 0; i < iters; ++i) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
            asm volatile(
                "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                : "+f"(c[n][0]), "+f"(c[n][1]), "+f"(c[n][2]), "+f"(c[n][3])
                : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                  "r"(b1));
    }
    const long long t1 = clock64();
    float s = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) s += c[n][0] + c[n][1] + c[n][2] + c[n][3];
    out[blockIdx.x * blockDim.x + threadIdx.x] = s;
    if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}
extern "C" int mma_rate_run(float* out, int blocks, int threads, int iters,
                            long long* cycles) {
    mma_rate<<<blocks, threads>>>(out, iters, cycles);
    return (int)cudaGetLastError();
}
"""

# one piece of the flash kernel removed (source text -> replacement)
_ABLATIONS = {
    "intact": [],
    "no_k_fragment_loads": [(
        "dtt::ldsm_x4(bk, Ks + n * 16 * LD + kk * 16);",
        "bk[0] = bk[1] = bk[2] = bk[3] = 0x3c003c00u ^ (n + kk);")],
    "no_v_fragment_loads": [(
        "dtt::ldsm_x4_trans(bv[n], Vs + kk * 16 * LD + n * 16);",
        "bv[n][0] = bv[n][1] = bv[n][2] = bv[n][3] = 0x3c003c00u ^ n;")],
    "no_exponentials": [
        ("dtt::fast_exp2(fmaf(s[n][e], sc, -m[i]))",
         "fmaf(s[n][e], sc, -m[i])"),
        ("? 0.f : dtt::fast_exp2(s[n][e] - m[i]);",
         "? 0.f : (s[n][e] - m[i]);")],
}


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _time_ms(fn, iters: int = 30) -> float:
    fn()
    # dynalint: ok(host-sync) card-only probe: timing fences
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    # dynalint: ok(host-sync) card-only probe: timing fences
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _compile(name: str, src: str) -> subprocess.Popen:
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / f"probe_{name}.cu"
    cu.write_text(src)
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
         str(cu.with_suffix(".so")), str(cu)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _load(name: str, proc: subprocess.Popen) -> ctypes.CDLL:
    out, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for probe {name}:\n{out}")
    return ctypes.CDLL(str(_build.BUILD_DIR / f"probe_{name}.so"))


def _inputs(B, T, S, Hq, Hkv, Dh):
    """Every lane prefills the last T positions of an S-token context."""
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn(shape, generator=g, device="cuda")
               .to(torch.bfloat16) for shape in
               ((B, T, Hq, Dh), (B, S, Hkv, Dh), (B, S, Hkv, Dh)))
    k_pos = torch.arange(S, dtype=torch.int32, device="cuda")[None] \
        .repeat(B, 1)
    q_pos = torch.arange(S - T, S, dtype=torch.int32, device="cuda")[None] \
        .repeat(B, 1)
    k_valid = torch.ones((B, S), dtype=torch.bool, device="cuda")
    return q, k, v, q_pos, k_pos, k_valid


def _launch(fn, q, k, v, q_pos, k_pos, k_valid):
    B, T, Hq, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
             k_pos.data_ptr(), k_valid.data_ptr(), out.data_ptr(),
             B, T, S, Hq, Hkv, Dh, *q.stride()[:3], *k.stride()[:3],
             *v.stride()[:3], Dh ** -0.5, 0.0, 0,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash probe launch failed (cudaError {err})")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("flash_probe needs a CUDA card")
    flash_src = (_build.CSRC / "flash_attention.cu").read_text()
    procs = {"mma_rate": _compile("mma_rate", _MMA_SRC)}
    for name, patches in _ABLATIONS.items():
        src = flash_src
        for old, new in patches:
            if src.count(old) != 1:
                raise RuntimeError(f"ablation {name}: source text changed")
            src = src.replace(old, new)
        procs[name] = _compile(name, src)
    libs = {name: _load(name, p) for name, p in procs.items()}

    run = libs["mma_rate"].mma_rate_run
    run.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 4000
    for warps in (1, 2, 4):              # per SM sub-partition
        threads = 128 * warps
        out = torch.empty(sms * threads, device="cuda")
        cycles = torch.zeros(sms, dtype=torch.int64, device="cuda")
        ms = _time_ms(lambda: run(out.data_ptr(), sms, threads, iters,
                                  cycles.data_ptr()), 3)
        n_mma = sms * threads // 32 * iters * 8
        _emit({"probe": "mma_sync", "warps_per_subpartition": warps,
               "tflops": n_mma * 4096 / ms / 1e9,
               "cycles_per_mma_per_subpartition":
                   # dynalint: ok(host-sync) card-only probe: reads a measured
                   # counter
                   cycles.float().mean().item() / (iters * 8) / warps})

    for case, shape in (("llama3-8b-full-lanes", (2, 512, 1024, 32, 8, 128)),
                        ("llama3-8b-first-chunk", (1, 512, 512, 32, 8, 128))):
        x = _inputs(*shape)
        want = flash_attention_plain(*x).float()
        row = {"probe": "ablation", "case": case}
        for name in _ABLATIONS:
            fn = getattr(libs[name], "dtt_flash_attention")
            fn.argtypes = _FLASH_ARGS
            fn.restype = ctypes.c_int
            row[f"{name}_ms"] = _time_ms(lambda: _launch(fn, *x))
            if name == "intact":
                # dynalint: ok(host-sync) card-only probe: reads the kernel's
                # error against its plain version
                row["intact_max_abs_err"] = (
                    _launch(fn, *x).float() - want).abs().max().item()
        _emit(row)

        q, k, v, q_pos, k_pos, k_valid = x
        mask = (k_valid[:, None, :]
                & (k_pos[:, None, :] <= q_pos[:, :, None]))[:, None]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)

        ms = _time_ms(sdpa)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sdpa()
            # dynalint: ok(host-sync) card-only probe: fences the profiled call
            torch.cuda.synchronize()
        kernels = sorted(
            ((e.key[:120], e.device_time_total) for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA),
            key=lambda kv: -kv[1])
        _emit({"probe": "library", "case": case, "sdpa_ms": ms,
               "kernels_us": kernels})
    _emit({"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
