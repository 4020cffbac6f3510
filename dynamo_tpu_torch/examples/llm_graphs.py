"""Deployable LLM serving graphs (the reference's agg / agg_router /
disagg_router shapes) as @service classes wrapping the port's binaries.

    # aggregated: HTTP frontend + one engine worker
    python -m dynamo_tpu_torch.cli.serve \
        dynamo_tpu_torch.examples.llm_graphs:AggGraph \
        --config examples/configs/agg.yaml

    # KV-routed: frontend + KV router + replicated workers
    python -m dynamo_tpu_torch.cli.serve \
        dynamo_tpu_torch.examples.llm_graphs:AggRouterGraph \
        --config examples/configs/agg_router.yaml

    # disaggregated: + prefill workers pulling the shared queue (two cards
    # on the GPU: one for the decode worker, one for the prefill worker)
    python -m dynamo_tpu_torch.cli.serve \
        dynamo_tpu_torch.examples.llm_graphs:DisaggRouterGraph \
        --config examples/configs/disagg_router.yaml --total-chips 2

Per-service options come from the config section named after the class
(Frontend/Router/Worker/PrefillWorker); any key is the matching CLI flag of
the wrapped binary with dashes as underscores (e.g. ``extra_engine_args``).
A section's ``engine: jax`` (the repo's configs are written for the JAX
package) serves on the port's ``torch`` worker, which computes the same
model. ``Worker`` and ``PrefillWorker`` build their engine when the service
is constructed, which ``sdk.serve_child`` does before it connects the
runtime: no liveness lease exists while an 8B bring-up holds the process.

The repo's ``examples/llm_graphs.py`` on the port. Reference capability:
examples/llm/components/* + examples/llm/configs/*.yaml (frontend.py:29-87,
kv_router.py, worker.py:37-198, prefill_worker.py:46-158).
"""

from __future__ import annotations

import asyncio

from dynamo_tpu_torch.sdk import (ServiceConfig, async_on_start,
                                  dynamo_endpoint, service)


def _args(parse, config, **forced):
    ns = parse([])
    for k, v in {**config, **forced}.items():
        setattr(ns, k, v)
    return ns


async def _boot(coro_factory) -> asyncio.Task:
    ready = asyncio.Event()
    task = asyncio.create_task(coro_factory(ready))
    waiter = asyncio.ensure_future(ready.wait())
    done, _ = await asyncio.wait({task, waiter},
                                 return_when=asyncio.FIRST_COMPLETED)
    if task in done:
        waiter.cancel()
        task.result()   # surface the boot failure
    return task


async def _serve_http(args, drt, ready) -> None:
    """The discovery frontend until cancelled (``run_http`` returns once
    it listens; its server is stopped here)."""
    from dynamo_tpu_torch.cli.http import run_http

    svc = await run_http(args, ready_event=ready, drt=drt)
    try:
        await asyncio.Event().wait()
    finally:
        await svc.stop()


@service(namespace="dynamo", name="frontend")
class Frontend:
    """OpenAI HTTP frontend with store-watched model discovery."""

    @async_on_start
    async def boot(self):
        from dynamo_tpu_torch.cli.http import parse_args

        args = _args(parse_args, self.config)
        self._task = await _boot(lambda ev: _serve_http(args, self.runtime,
                                                        ev))


@service(namespace="dynamo", name="router")
class Router:
    """KV-aware router service over the worker component."""

    @async_on_start
    async def boot(self):
        from dynamo_tpu_torch.cli.router import parse_args, run_router

        args = _args(parse_args, self.config)
        self._task = await _boot(lambda ev: run_router(
            args, ready_event=ev, drt=self.runtime))


@service(namespace="dynamo", name="backend", resources={"gpu": 1})
class Worker:
    """Engine worker (``engine: torch`` by default, a config's ``jax`` too;
    ``engine: echo`` for hermetic runs)."""

    def __init__(self):
        from dynamo_tpu_torch.cli.worker import make_engine, parse_args
        from dynamo_tpu_torch.fleet.registry import worker_engine

        self._args = _args(parse_args,
                           ServiceConfig.load().for_service(type(self)),
                           component="backend")
        self._args.engine = worker_engine(self._args.engine)
        self._engine = make_engine(self._args)

    @async_on_start
    async def boot(self):
        from dynamo_tpu_torch.cli.worker import run_worker

        self._task = await _boot(lambda ev: run_worker(
            self._args, ready_event=ev, drt=self.runtime,
            engine=self._engine))


@service(namespace="dynamo", name="prefill", resources={"gpu": 1})
class PrefillWorker:
    """Zero-registration prefill worker pulling the shared queue."""

    def __init__(self):
        from dynamo_tpu_torch.cli.prefill_worker import make_engine, parse_args

        self._args = _args(parse_args,
                           ServiceConfig.load().for_service(type(self)))
        self._engine = make_engine(self._args)

    @async_on_start
    async def boot(self):
        from dynamo_tpu_torch.cli.prefill_worker import run_prefill_worker

        self._task = await _boot(lambda ev: run_prefill_worker(
            self._args, ready_event=ev, drt=self.runtime,
            engine=self._engine))


# --- graphs -----------------------------------------------------------
@service(namespace="dynamo", name="agg_graph")
class AggGraph:
    pass


AggGraph.link(Frontend).link(Worker)


@service(namespace="dynamo", name="agg_router_graph")
class AggRouterGraph:
    pass


AggRouterGraph.link(Frontend).link(Router).link(Worker)


@service(namespace="dynamo", name="disagg_router_graph")
class DisaggRouterGraph:
    pass


DisaggRouterGraph.link(Frontend).link(Router).link(Worker) \
    .link(PrefillWorker)
