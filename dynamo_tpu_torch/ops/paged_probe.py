"""The paged decode kernel beside other builds of it, on the card (a
measurement tool).

    python -m dynamo_tpu_torch.ops.paged_probe [--baseline DIR] [--variants]

Needs one CUDA card and ``nvcc``. Times the paged kernel at the paged cases
of ``chip_smoke.py`` (:data:`PAGED_CASES`, the same inputs) and holds every
build it times against the plain version (2e-2). Prints JSON lines:

1. ``build`` — ptxas's registers and spills for each build's instances.
2. ``baseline`` (with ``--baseline DIR``, repeatable) — the paged kernel
   of another checkout of the repository, its own ``ops/attention.py``
   wrapper and ``csrc/paged_attention.cu`` built into ``DIR/build/``, timed
   in turns with this tree's: baseline, this, this, baseline.
3. ``variant`` (with ``--variants``) — copies of ``csrc/paged_attention.cu``
   with other constants (tokens per warp tile, warps a block, the merge's
   launch; text patches) and another grid target (blocks an SM), each held
   against the plain version and timed beside this tree's kernel in the same
   loop; and two ablations, timed only: every block exiting at once (the
   launches' floor) and the split kernel without its merge.

Times are means over 50 launches by CUDA events, with a spin kernel holding
the card while the host enqueues them.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
import types
from pathlib import Path

import torch

from . import _build
from . import attention as tatt
from .flash_probe import _compile, _time_ms

TOL = 2e-2

# chip_smoke.py's paged cases: name -> paged_inputs() shape and the
# wrapper's keywords
PAGED_CASES = {
    "llama3-8b": {},
    "llama3-8b-window-softcap": {"softcap": 50.0, "window": 512},
    "llama3-8b-b8-len1024": {"lengths_l": [1024] * 8},
    "llama3-8b-b1-len2048": {"lengths_l": [2048], "B": 1},
    # six lanes as the serve phase decodes them: the longest is the
    # 1496-token prompt plus its 32 completion tokens, a 25-page table
    "llama3-8b-serve-decode": {"lengths_l": [24, 40, 64, 96, 160, 1528],
                               "B": 6, "P": 25},
    "gemma2-9b-paged-dh256": {"softcap": 50.0, "window": 256, "Hq": 16,
                              "Hkv": 8, "Dh": 256},
    # Gemma3-4B's decode (the vlm phase): 8 q / 4 kv heads at Dh 256, the
    # sliding layers' 1024-token window, no softcap
    "gemma3-4b": {"window": 1024, "Hq": 8, "Hkv": 4, "Dh": 256},
    # the llama-3.2-1b speculative draft's greedy step: one lane at the
    # reuse prompt's length, head dim 64
    "llama-3.2-1b-draft": {"lengths_l": [1500], "B": 1, "P": 24, "Dh": 64},
    # the tiny presets' heads at Dh 16: tiny-byte (the CLI's default
    # model) and tiny-gemma (one kv head), over the same 2048-token table
    "tiny-byte": {"Hq": 4, "Hkv": 2, "Dh": 16},
    "tiny-gemma": {"Hq": 4, "Hkv": 1, "Dh": 16},
}

# name -> (source text, replacement) patches of csrc/paged_attention.cu; a
# variant whose shared memory does not fit at a head dim records the error
_VARIANTS = {
    "tile32": [("constexpr int TK = 16;", "constexpr int TK = 32;")],
    "warps8": [("constexpr int NW = 4;", "constexpr int NW = 8;")],
    # the merge kernel launched after the split kernel, not as its
    # programmatic dependent
    "no_pdl": [("programmaticStreamSerializationAllowed = 1;",
                "programmaticStreamSerializationAllowed = 0;")],
}
# timed only (their outputs are wrong): what the fixed costs are
_ABLATIONS = {
    # every block exits at once: the two launches and the merge alone
    "launch_floor": [("if (lo >= hi) return;", "if (true) return;")],
    # the split kernel alone, its merge never launched
    "no_merge": [("if (e != cudaSuccess || nsplit == 1) return e;",
                  "return e;")],
}
_GRID_TARGETS = (8,)               # blocks an SM, beside the default


def paged_inputs(device, lengths_l=(1, 64, 100, 777, 1024, 1500, 2000, 2048),
                 B=8, P=32, Hq=32, Hkv=8, Dh=128, page=64):
    """One decode step over a shuffled page pool: lane b attends to
    ``lengths_l[b]`` tokens of a [B, P] page table whose unused entries
    stay the scratch page 0. Returns (q, k_pages, v_pages, page_tables,
    lengths) on ``device``."""
    dev = torch.device(device)
    n_pages = B * P + 1
    g = torch.Generator(device=dev).manual_seed(2)
    bf = torch.bfloat16
    q = torch.randn((B, Hq, Dh), generator=g, device=dev).to(bf)
    kp = torch.randn((Hkv, n_pages, page, Dh), generator=g, device=dev).to(bf)
    vp = torch.randn((Hkv, n_pages, page, Dh), generator=g, device=dev).to(bf)
    perm = torch.randperm(n_pages - 1, generator=torch.Generator()
                          .manual_seed(3)) + 1
    pt = torch.zeros((B, P), dtype=torch.int32)
    for b, n in enumerate(lengths_l):
        need = -(-n // page)
        pt[b, :need] = perm[b * P:b * P + need].to(torch.int32)
    # dynalint: ok(host-sync) card-only probe: builds its inputs before any
    # timing
    lengths = torch.tensor(list(lengths_l), dtype=torch.int32, device=dev)
    # dynalint: ok(host-sync) card-only probe: builds its inputs before any
    # timing
    return q, kp, vp, pt.to(dev), lengths


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _load_tree(root: Path, tag: str):
    """Another checkout's ``ops/attention.py`` and ``ops/_build.py``, as a
    package of their own (their build goes into ``root/build/``)."""
    ops = root / "dynamo_tpu_torch" / "ops"
    pkg = f"_paged_probe_{tag}"
    mod = types.ModuleType(pkg)
    mod.__path__ = [str(ops)]
    sys.modules[pkg] = mod
    for name in ("_build", "attention"):
        spec = importlib.util.spec_from_file_location(f"{pkg}.{name}",
                                                      ops / f"{name}.py")
        m = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = m
        spec.loader.exec_module(m)
    return sys.modules[f"{pkg}.attention"]


def _variant_call(lib: ctypes.CDLL, blocks_per_sm: int):
    """paged_attention's launch with another build of the kernel and
    another grid target."""
    fn = lib.dtt_paged_attention
    fn.argtypes = tatt._PAGED_ARGS
    fn.restype = ctypes.c_int
    granule = lib.dtt_paged_granule
    granule.argtypes = [ctypes.c_int]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def call(q, kp, vp, pt, lengths, softcap=None, window=None):
        B, Hq, Dh = q.shape
        Hkv, n_pages, page, _ = kp.shape
        P = pt.shape[1]
        split, nsplit = tatt.paged_split_plan(
            B, Hq, Hkv, Dh, P, page, n_sm, granule=granule(Dh),
            blocks_per_sm=blocks_per_sm)
        out = torch.empty_like(q)
        ws = torch.empty(B * Hq * nsplit * (Dh + 2), device=q.device)
        err = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), pt.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(), ws.data_ptr(), B, Hq,
                 Hkv, Dh, n_pages, page, P, split, nsplit, Dh ** -0.5,
                 float(softcap or 0.0), int(window or 0),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"paged probe launch failed (cudaError {err})")
        return out
    return call


def _check(name: str, case: str, fn, x, kw) -> float:
    got = fn(*x, **kw).float()
    want = tatt.paged_attention_plain(*x, **kw).float()
    # dynalint: ok(host-sync) card-only probe: reads the kernel's error against
    # its plain version
    err = (got - want).abs().max().item()
    if not (torch.isfinite(got).all() and err <= TOL):
        raise AssertionError(f"{name} disagrees at {case}: {err}")
    return err


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, action="append", default=[],
                    help="root of another checkout whose paged kernel is "
                         "timed in turns with this tree's (repeatable)")
    ap.add_argument("--variants", action="store_true",
                    help="time copies of the kernel with other constants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("paged_probe needs a CUDA card")

    src = (_build.CSRC / "paged_attention.cu").read_text()
    procs = {}
    if args.variants:
        for name, patches in {**_VARIANTS, **_ABLATIONS}.items():
            text = src
            for old, new in patches:
                if text.count(old) != 1:
                    raise RuntimeError(f"variant {name}: source text changed")
                text = text.replace(old, new)
            procs[name] = _compile(f"paged_{name}", text)
    libs = _build.build_all()
    bases = {}
    for root in args.baseline:
        bases[root.name] = _load_tree(root.resolve(), root.name)
        bases[root.name]._build.build_all()
    calls = {"this": tatt.paged_attention}
    ptxas = {"this": _build.ptxas_instances(
        _build.build_log.get("paged_attention", ""))}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{out}")
        ptxas[name] = _build.ptxas_instances(out)
        calls[name] = _variant_call(ctypes.CDLL(str(
            _build.BUILD_DIR / f"probe_paged_{name}.so")),
            tatt.PAGED_BLOCKS_PER_SM)
    if args.variants:
        for bps in _GRID_TARGETS:
            calls[f"grid{bps}"] = _variant_call(libs["paged_attention"], bps)
    for tag, base in bases.items():
        ptxas[tag] = _build.ptxas_instances(
            base._build.build_log.get("paged_attention", ""))
    _emit({"probe": "build", "ptxas": ptxas})

    for case, kw in PAGED_CASES.items():
        shape = {k: v for k, v in kw.items() if k not in ("softcap",
                                                          "window")}
        opts = {k: kw[k] for k in ("softcap", "window") if k in kw}
        x = paged_inputs("cuda", **shape)
        B, Hq, Dh = x[0].shape
        Hkv, _, page, _ = x[1].shape
        split, nsplit = tatt.paged_split_plan(
            B, Hq, Hkv, Dh, x[3].shape[1], page,
            tatt._sm_count(torch.cuda.current_device()))
        this_err = _check("this", case, tatt.paged_attention, x, opts)
        for tag, base in bases.items():
            if Dh not in base.KERNEL_HEAD_DIMS:     # an older tree
                continue
            row = {"probe": "baseline", "baseline": tag, "case": case,
                   "split": split, "splits": nsplit,
                   "baseline_max_abs_err": _check(
                       tag, case, base.paged_attention, x, opts),
                   "max_abs_err": this_err, "baseline_ms": [], "ms": []}
            for who in ("baseline", "this", "this", "baseline"):
                fn = base.paged_attention if who == "baseline" \
                    else tatt.paged_attention
                row["ms" if who == "this" else "baseline_ms"].append(
                    _time_ms(lambda: fn(*x, **opts), 50))
            _emit(row)
        if len(calls) > 1:
            row = {"probe": "variant", "case": case}
            timed = []
            for name, fn in calls.items():
                if name in _ABLATIONS:        # timed only, wrong outputs
                    continue
                try:
                    row[f"{name}_max_abs_err"] = _check(name, case, fn, x,
                                                        opts)
                    timed.append((name, fn))
                except RuntimeError as e:      # shared memory too large
                    row[f"{name}_error"] = str(e)
            timed += [(n, fn) for n, fn in calls.items() if n in _ABLATIONS]
            for name, fn in [*timed, ("this_again", calls["this"])]:
                row[f"{name}_ms"] = _time_ms(lambda: fn(*x, **opts), 50)
            _emit(row)
    _emit({"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
