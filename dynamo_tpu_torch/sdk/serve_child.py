"""Per-worker child entry for the `serve` orchestrator.

    python -m dynamo_tpu_torch.sdk.serve_child pkg.module:ServiceClass \
        --store host:port

Instantiates the @service class, connects the distributed runtime (on the
native data plane unless ``DYNAMO_TPU_DATAPLANE`` says otherwise), wires
``depends()`` clients, runs @async_on_start hooks, then serves every
@dynamo_endpoint on the service's component. Prints a READY line on stdout
once all endpoints are registered (the orchestrator gates on it).

The JAX package's ``dynamo_tpu/sdk/serve_child.py``, with two differences
of the port's own:

- the service object is constructed BEFORE the runtime connects (JAX:
  after), so a service that brings up an engine in its constructor (the
  graphs' ``Worker``) does so while no liveness lease exists to lapse;
- the process runs under the runtime's :class:`~dynamo_tpu_torch.runtime.
  worker.Worker` shell: SIGTERM deregisters the service (lease revoke),
  lets in-flight streams finish within ``DYN_DRAIN_TIMEOUT``, closes the
  runtime and ends the service's tasks (an engine shuts down and frees its
  card) before the process exits. The JAX child dies on SIGTERM at once.

Reference capability: deploy/dynamo/sdk/cli/serve_dynamo.py:96-190.
"""

from __future__ import annotations

import argparse
import asyncio
import contextvars
import importlib
import logging
import sys
from typing import Optional, Type

from ..runtime.component import DistributedRuntime
from ..runtime.worker import Worker
from ..utils.logging_ext import init_logging
from .service import BoundClient, ServiceConfig, ServiceSpec

log = logging.getLogger("dynamo_tpu_torch.sdk.child")

READY_MARKER = "DYNAMO_SERVICE_READY"
_SERVICE: contextvars.ContextVar = contextvars.ContextVar("dynamo_service")


def load_class(spec: str) -> Type:
    mod_name, _, cls_name = spec.partition(":")
    mod = importlib.import_module(mod_name)
    cls = getattr(mod, cls_name)
    if not hasattr(cls, "_dynamo_spec"):
        raise SystemExit(f"{spec} is not a @service class")
    return cls


class _ServiceRuntime:
    """The runtime as the process shell drains and closes it: closing ends
    the service's own tasks first, so a worker's shutdown (last spans and
    metrics, the engine freeing its card) still has an open runtime."""

    def __init__(self, drt: DistributedRuntime, end_tasks):
        self.drt = drt
        self._end_tasks = end_tasks

    @property
    def _active(self):
        return self.drt._active

    async def prepare_drain(self) -> None:
        await self.drt.prepare_drain()

    async def close(self) -> None:
        await self._end_tasks()
        await self.drt.close()


async def run_service(cls: Type, store: str, ready_event=None,
                      shell: Optional[Worker] = None) -> None:
    """Serve ``cls`` until cancelled. Under ``shell``, a shutdown signal
    deregisters the service, drains its in-flight streams, ends the tasks
    it started (a booted worker and its engine) and closes the runtime;
    the shell then cancels this coroutine. Cancelled by its caller, it
    ends those tasks and closes the runtime itself."""
    spec: ServiceSpec = cls._dynamo_spec
    obj = cls()
    obj.config = ServiceConfig.load().for_service(cls)
    host, port = store.split(":")
    drt = await DistributedRuntime(store_host=host,
                                   store_port=int(port)).connect()
    # every task started from here on carries this service in its context
    # (several services may share one loop in process)
    ctx_token = _SERVICE.set(obj)
    home = asyncio.current_task()

    async def end_tasks() -> None:
        me = asyncio.current_task()
        mine = [t for t in asyncio.all_tasks()
                if t not in (me, home) and t.get_context().get(_SERVICE) is obj]
        for t in mine:
            t.cancel()
        await asyncio.gather(*mine, return_exceptions=True)

    if shell is not None:
        shell.add_runtime(_ServiceRuntime(drt, end_tasks))
    try:
        obj.runtime = drt
        obj._dyn_clients = {}
        for attr, dep in spec.dependencies.items():
            tspec: ServiceSpec = dep.target._dynamo_spec
            client = await drt.namespace(tspec.namespace) \
                .component(tspec.name).endpoint(dep.endpoint).client().start()
            obj._dyn_clients[attr] = BoundClient(client, dep.endpoint)
        for hook in spec.on_start:
            await getattr(obj, hook)()
        component = drt.namespace(spec.namespace).component(spec.name)
        for ep_name, attr in spec.endpoints.items():
            await component.endpoint(ep_name).serve(getattr(obj, attr))
        print(f"{READY_MARKER} {spec.name} worker={drt.worker_id:x}",
              flush=True)
        if ready_event is not None:
            ready_event.set()
        await asyncio.Event().wait()
    finally:
        if shell is None:
            await end_tasks()
            await drt.close()
        _SERVICE.reset(ctx_token)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser("dynamo-serve-child")
    ap.add_argument("service", help="pkg.module:ServiceClass")
    ap.add_argument("--store", default="127.0.0.1:4222")
    args = ap.parse_args(argv)
    init_logging()
    sys.path.insert(0, ".")
    cls = load_class(args.service)
    shell = Worker()
    shell.execute(lambda token: run_service(cls, args.store, shell=shell))


if __name__ == "__main__":
    main()
