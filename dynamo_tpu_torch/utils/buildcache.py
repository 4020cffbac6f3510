"""Content-addressed native builds, shared by the CUDA kernel builder
(``ops/_build.py``) and the host-helper builder (``native/_build.py``).

An artifact's file name carries a hash of everything that shapes it
(sources, headers, flags), so an edited source rebuilds and an unchanged
one is reused. Several processes may ask for the same artifact at once
(test workers, a fleet's children): it builds under an exclusive ``flock``
on a lock file of its own beside it, into a temporary name that is moved
into place only when the compiler succeeds.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Callable, Iterable, List, Optional


def artifact(build_dir: Path, name: str, inputs: Iterable[bytes]) -> Path:
    """``build_dir/<stem>-<hash>.<ext>`` for ``name`` ("stem.ext" or a bare
    stem), the hash taken over ``inputs`` in order."""
    h = hashlib.sha256()
    for part in inputs:
        h.update(part)
    stem, dot, ext = name.partition(".")
    return build_dir / f"{stem}-{h.hexdigest()[:16]}{dot}{ext}"


def build_once(out: Path, command: Callable[[Path], List[str]],
               failed: str) -> Optional[str]:
    """Make ``out`` by running ``command(tmp)``, which must write ``tmp``,
    unless it exists. Returns the compiler's output when this call
    compiled, None when the artifact was there (built earlier or by
    another process meanwhile). Raises ``RuntimeError``, ``failed`` then
    the compiler's output, when it fails."""
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / f".{out.name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return None
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        try:
            r = subprocess.run(command(tmp), stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"{failed}:\n{r.stdout}")
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
    return r.stdout
