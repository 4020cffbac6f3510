"""Rule ``blocking-async``: no blocking calls inside ``async def``.

A blocking call on the event loop doesn't slow one request — it freezes
EVERY coroutine sharing the loop for its full duration: heartbeats miss,
leases expire, deadline timers fire late, and the chaos soak reads it as a
fleet-wide stall. The fix is ``await asyncio.sleep``, ``asyncio.to_thread``,
``run_in_executor``, or the async variant of the library.

Detection resolves import aliases through the module's import map, so
``import time as _time; _time.sleep(...)`` and ``from subprocess import
run; run(...)`` are both caught. Only the *immediate* enclosing function
matters: a sync helper defined inside an async def runs wherever it is
called from and is the callee's problem (same convention as the legacy
unbounded-await gate).

Calls made through ``asyncio.to_thread(fn, ...)`` / ``run_in_executor``
pass the function uncalled, so they never parse as a Call and need no
special-casing.
"""

from __future__ import annotations

import ast
from typing import List

from ..core import Finding, Module, Rule, register

#: canonical dotted names that park the loop when called directly
BLOCKING_CALLS = {
    "time.sleep",
    "subprocess.run", "subprocess.call", "subprocess.check_call",
    "subprocess.check_output", "subprocess.getoutput",
    "requests.get", "requests.post", "requests.put", "requests.patch",
    "requests.delete", "requests.head", "requests.request",
    "urllib.request.urlopen",
    "socket.create_connection", "socket.getaddrinfo",
    "socket.gethostbyname",
    "os.system", "os.waitpid",
}


@register
class BlockingAsyncRule(Rule):
    name = "blocking-async"
    description = ("blocking call (time.sleep / subprocess / requests / "
                   "socket) directly inside an async def")

    def check_module(self, mod: Module) -> List[Finding]:
        extra = set(self.options.get("extra_calls", ()))
        blocking = BLOCKING_CALLS | extra
        out: List[Finding] = []
        dup: dict = {}
        for node in mod.nodes():
            if not isinstance(node, ast.Call):
                continue
            canonical = mod.resolve_call(node)
            if canonical not in blocking:
                continue
            fn = mod.enclosing_function(node)
            if not isinstance(fn, ast.AsyncFunctionDef):
                continue
            # discriminate repeats so one baseline entry can never
            # grandfather a second, newly added call of the same shape
            key = f"{fn.name}:{canonical}"
            n = dup.get(key, 0) + 1
            dup[key] = n
            if n > 1:
                key = f"{key}#{n}"
            out.append(Finding(
                rule=self.name, path=mod.rel, line=node.lineno,
                message=(f"{canonical}() blocks the event loop inside "
                         f"async def {fn.name} — use the async equivalent "
                         f"or asyncio.to_thread()"),
                key=key))
        return out
