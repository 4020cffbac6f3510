"""KV paging: a virtual-memory subsystem for the decode working set.

Serves contexts far beyond the device KV pool by bounding device
residency to a page budget and streaming the cold tail through staged
host-to-device uploads, layer by layer, with online-softmax merging; see
:mod:`.runner` for the serving integration and the JAX package's
``docs/long_context.md`` for the operator-facing model.
"""

from .pager import PageScheduler, PageinPlan
from .runner import PagedEngine, PagedConfig

__all__ = ["PageScheduler", "PageinPlan", "PagedEngine", "PagedConfig"]
