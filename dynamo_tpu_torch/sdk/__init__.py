"""Service SDK of the port: the card allocator the local orchestrators share.

The JAX package's ``sdk`` also holds the service decorators and the
``serve`` orchestrator; those come with the deploy slice (ROADMAP Queue 1
item 12e).
"""

from .allocator import Allocation, AllocationError, CudaAllocator

__all__ = ["Allocation", "AllocationError", "CudaAllocator"]
