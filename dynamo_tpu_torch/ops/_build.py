"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each ``csrc/*.cu`` file compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface under ``build/dynamo_tpu_torch/`` at
the repository root. A library's file name carries a hash of its source, the
shared headers and the flags, so an edited kernel rebuilds and an unchanged
one is reused, and a library builds under a lock that holds across
processes (:mod:`dynamo_tpu_torch.utils.buildcache`). All sources compile in
parallel, one ``nvcc`` process each. Nothing here runs at import time: the
first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Sequence

from ..utils.buildcache import artifact, build_once

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dynamo_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, ctypes._CFuncPtr] = {}
# per-source compiler output of this process's builds (ptxas registers,
# shared memory, spills); empty for libraries found already built
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _library_path(src: Path, headers: Sequence[Path]) -> Path:
    return artifact(BUILD_DIR, f"{src.stem}.so",
                    [src.read_bytes(), *(h.read_bytes() for h in headers),
                     " ".join(NVCC_FLAGS).encode()])


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile (if needed) and load every kernel library; returns them by
    source stem. Raises with the compiler's output if a build fails."""
    with _lock:
        if _libs:
            return _libs
        headers = sorted(CSRC.glob("*.cuh"))
        sources = sorted(CSRC.glob("*.cu"))

        def one(src: Path):
            try:
                out = build_once(
                    _library_path(src, headers),
                    lambda tmp: [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC),
                                 "-o", str(tmp), str(src)],
                    f"nvcc failed for {src.name}")
            except RuntimeError as e:
                return str(e)
            if out is not None:
                build_log[src.stem] = out
            return None

        with ThreadPoolExecutor(max(1, len(sources))) as pool:
            failures = [f for f in pool.map(one, sources) if f]
        if failures:
            raise RuntimeError("\n".join(failures))
        for src in sources:
            _libs[src.stem] = ctypes.CDLL(str(_library_path(src, headers)))
        return _libs


def kernel(source: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry ``symbol`` of ``csrc/<source>.cu``, with its argument
    types declared (every pointer and the stream as ``c_void_p``); it
    returns the launch's ``cudaError_t``."""
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(build_all()[source], symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def ptxas_instances(log: str) -> Dict[str, List[str]]:
    """ptxas's register and spill lines (``nvcc -Xptxas -v``) for each
    kernel instance of one build log, keyed ``name<template args>``."""
    out: dict = {}
    name = None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            sym = m.group(1)
            k = re.search(r"([a-z][a-z_]*_kernel)I((?:L[ib]\d+E)+)E", sym)
            args = re.findall(r"L[ib](\d+)E", k.group(2)) if k else []
            name = f"{k.group(1)}<{','.join(args)}>" if k else sym
            out[name] = []
        elif name and ("registers" in ln or "spill" in ln):
            out[name].append(ln.replace("ptxas info    :", "").strip())
    return out
