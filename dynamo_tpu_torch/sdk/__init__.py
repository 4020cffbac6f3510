"""Deployment SDK of the port: declare serving graphs as decorated Python
classes, and the card allocator the local orchestrators share.

    from dynamo_tpu_torch.sdk import service, dynamo_endpoint, depends

    @service(namespace="dynamo")
    class Backend:
        @dynamo_endpoint()
        async def generate(self, request, ctx):
            yield ...

    @service(namespace="dynamo", resources={"gpu": 0})
    class Frontend:
        backend = depends(Backend)

        @dynamo_endpoint()
        async def generate(self, request, ctx):
            async for x in self.backend.generate(request):
                yield x

    Frontend.link(Backend)   # deployable graph

Run locally with ``python -m dynamo_tpu_torch.cli.serve module:Frontend``
(``sdk.serve.LocalServe``: one process per service worker, cards granted
by :class:`CudaAllocator`). The JAX package's ``sdk``, decorators and graph
order alike; the deploy half (manifests, artifacts, the operator) comes
with ROADMAP Queue 1 item 12e.

Reference capability: deploy/dynamo/sdk (service.py:32-120, decorators.py:
26-101, dependency.py) re-expressed without the BentoML dependency.
"""

from .allocator import Allocation, AllocationError, CudaAllocator
from .service import (ServiceConfig, async_on_start, depends, dynamo_endpoint,
                      service)

__all__ = ["Allocation", "AllocationError", "CudaAllocator", "service",
           "dynamo_endpoint", "depends", "async_on_start", "ServiceConfig"]
