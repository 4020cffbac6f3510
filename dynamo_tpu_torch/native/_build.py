"""Build the port's native helpers with ``g++`` at first use.

Three targets, each from one C++ source of this directory (they share
``msgpack.hpp``):

- ``dynstore``: the store server, an executable;
- ``libdynamo_dataplane.so``: the data-plane server, bound by
  ``runtime/native_dataplane.py``;
- ``libdynamo_kv.so``: the C-ABI KV-event publisher, bound by
  ``llm/kv_router/native.py``.

Each builds with ``g++ -O2 -std=c++17`` into ``build/dynamo_tpu_torch/native/``
at the repository root, through :mod:`dynamo_tpu_torch.utils.buildcache`:
a file name that carries a hash of its source, the shared header and the
flags, a lock that holds across processes, and a temporary name moved into
place. :func:`build_all` builds the three at once. Nothing here runs at
import time.
"""

from __future__ import annotations

import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Tuple

from ..utils.buildcache import artifact, build_once

SRC = Path(__file__).resolve().parent
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "dynamo_tpu_torch" / "native")
CXX_FLAGS = ["-O2", "-std=c++17"]
_SHARED = ["-fPIC", "-shared"]
#: target -> (source, flags before the source, flags after it)
TARGETS: Dict[str, Tuple[str, List[str], List[str]]] = {
    "dynstore": ("dynstore.cpp", [], []),
    "libdynamo_dataplane.so": ("dataplane.cpp", _SHARED, ["-lpthread"]),
    "libdynamo_kv.so": ("kv_publisher.cpp", _SHARED, ["-lpthread"]),
}


def _artifact(target: str) -> Path:
    src, pre, post = TARGETS[target]
    return artifact(BUILD_DIR, target, [
        (SRC / src).read_bytes(), (SRC / "msgpack.hpp").read_bytes(),
        " ".join(CXX_FLAGS + pre + post).encode()])


def build(target: str) -> Path:
    """The path of ``target`` (a key of :data:`TARGETS`), compiled first if
    this source has not been built yet. Raises ``RuntimeError`` when there
    is no ``g++`` or the compiler fails, with its output."""
    out = _artifact(target)
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: the native {target} cannot be "
                           "built")
    src, pre, post = TARGETS[target]
    build_once(out, lambda tmp: [cxx, *CXX_FLAGS, *pre, "-o", str(tmp),
                                 str(SRC / src), *post],
               f"g++ failed for {src}")
    return out


def build_all() -> Dict[str, Path]:
    """Every target, its missing ones compiled in parallel (one ``g++``
    each)."""
    with ThreadPoolExecutor(len(TARGETS)) as pool:
        return dict(zip(TARGETS, pool.map(build, TARGETS)))
