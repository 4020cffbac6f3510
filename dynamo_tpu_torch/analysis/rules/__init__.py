"""dynalint rule implementations.

Importing this package registers every rule with the framework registry
(:func:`dynamo_tpu_torch.analysis.core.all_rules` triggers the import).
Each rule lives in its own module; adding a rule = adding a module here
with a ``@register``-decorated ``Rule`` subclass and importing it below.

The JAX package's ``tracer-leak`` and ``recompile-hazard`` rules stay out:
both reason about ``jax.jit`` tracing (host state captured by a traced
body, a Python value that forks a new compiled program), and the port
neither traces nor jit-compiles — its kernels are built once by ``nvcc``
and launched eagerly. Their counterpart arrives with CUDA-graph capture:
a capture-hazard rule (a host sync, allocation or shape-varying launch
inside a captured region).
"""

from . import await_lock          # noqa: F401
from . import blocking_async      # noqa: F401
from . import fire_forget         # noqa: F401
from . import flow_accounting     # noqa: F401
from . import host_sync           # noqa: F401
from . import knob_drift          # noqa: F401
from . import lock_discipline     # noqa: F401
from . import loop_blocking_path  # noqa: F401
from . import metrics_catalog     # noqa: F401
from . import silent_except       # noqa: F401
from . import store_key_drift     # noqa: F401
from . import unbounded_await     # noqa: F401
from . import wire_field_drift    # noqa: F401
