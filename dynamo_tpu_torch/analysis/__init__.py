"""dynalint — static analysis for the port's serving control plane.

The port's copy of the JAX package's ``analysis`` framework, run over
``dynamo_tpu_torch/`` and ``chip_smoke.py``: every hang, dropped task or
unguarded shared field in async serving code becomes a stuck request at
fleet scale, and every hidden device->host sync on the dispatch path
stalls the host enqueue, so whole bug classes are caught at commit time.

Pieces:

- :mod:`.core` — ``Finding``/``Rule``/``Module`` plus the rule registry and
  the ``# dynalint: ok(<rule>) <reason>`` suppression scanner;
- :mod:`.baseline` — checked-in grandfather file for pre-existing findings
  (every entry carries a one-line justification);
- :mod:`.runner` — walks paths, runs rules, applies suppressions +
  baseline, renders text/JSON;
- :mod:`.dataflow` — def-use chains and the torch device-taint lattice;
- :mod:`.rules` — the rule implementations (importing it populates the
  registry).

Everything here is stdlib-only (``ast``/``re``/``json``) — importing the
package never pulls in torch or the runtime, so the gate stays cheap.

Entry point: ``python -m dynamo_tpu_torch.cli.dynalint``.
"""

from .core import (Finding, Module, Rule, all_rules, get_rule,  # noqa: F401
                   register)
from .runner import LintResult, run_lint  # noqa: F401
