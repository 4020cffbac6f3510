"""Runtime configuration layering: defaults <- DYN_* environment <- CLI.

The reference layers figment defaults under ``DYN_*`` environment variables
under explicit flags (lib/runtime/src/config.rs:26-176). Here the same
precedence is expressed through argparse: every runtime flag's DEFAULT is
resolved from the environment, so a flag given on the command line always
wins, and an env var beats the built-in default.

Lookup order for a flag ``--port`` of binary ``dynamo-http``:

1. ``DYN_HTTP_PORT``   (binary-scoped: DYN_<PROG>_<FLAG>; lets two binaries
   on one host get different values for a same-named flag)
2. ``DYN_PORT``        (global: DYN_<FLAG>; e.g. DYN_STORE applies to every
   binary at once)
3. the built-in default.

A malformed env value (e.g. DYN_PORT=abc for an int flag, or a value outside
the flag's ``choices``) is logged and ignored rather than crashing startup.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Any, Optional

log = logging.getLogger("dynamo_tpu_torch.config")


def _norm(s: str) -> str:
    return s.replace("-", "_").upper()


def env_name(flag: str, prog: Optional[str] = None) -> str:
    base = _norm(flag.lstrip("-"))
    if prog:
        p = _norm(prog)
        if p.startswith("DYNAMO_"):
            p = p[len("DYNAMO_"):]
        return f"DYN_{p}_{base}"
    return "DYN_" + base


def env_default(flag: str, default: Any = None, cast: Optional[type] = None,
                prog: Optional[str] = None, choices=None) -> Any:
    """The default for ``flag``: the binary-scoped then global DYN_* env
    value when set, else ``default``. ``cast`` converts the env string."""
    raw = None
    for name in ((env_name(flag, prog),) if prog else ()) + (env_name(flag),):
        raw = os.environ.get(name)
        if raw is not None:
            break
    if raw is None:
        return default
    if cast is None and default is not None:
        cast = type(default)
    try:
        if cast is bool:
            val = raw.lower() not in ("", "0", "false", "no")
        else:
            val = cast(raw) if cast else raw
    except (TypeError, ValueError):
        log.warning("ignoring malformed %s=%r for flag %s", name, raw, flag)
        return default
    if choices is not None and val not in choices:
        log.warning("ignoring %s=%r: not one of %s", name, raw, list(choices))
        return default
    return val


class EnvDefaultsParser(argparse.ArgumentParser):
    """ArgumentParser whose ``add_argument`` resolves defaults through the
    DYN_* environment, giving the reference's defaults<-env<-flags layering
    to every binary that uses it."""

    def add_argument(self, *names, **kw):  # type: ignore[override]
        flag = next((n for n in names if n.startswith("--")), None)
        if flag is not None and "default" in kw and kw.get("action") not in (
                "store_true", "store_false", "append"):
            kw["default"] = env_default(flag, kw["default"], kw.get("type"),
                                        prog=self.prog,
                                        choices=kw.get("choices"))
        elif flag is not None and kw.get("action") == "store_true":
            if env_default(flag, False, bool, prog=self.prog):
                kw["default"] = True
        return super().add_argument(*names, **kw)
