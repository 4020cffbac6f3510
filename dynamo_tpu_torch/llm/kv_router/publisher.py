"""Worker-side KV event publishing.

``KvEventPublisher`` bridges the engine's page-pool hooks (block sealed /
blocks freed) to the event plane without ever stalling the engine step loop:
events go into an unbounded in-memory queue; a background task drains and
publishes. The transport is pluggable (in-process function in tests, the
distributed runtime's event plane in ``cli/worker.py``).

Reference capability: lib/llm/src/kv_router/publisher.rs:32-60 (mpsc ->
NATS), and the C-ABI publish path (lib/bindings/c) that engines call.
"""

from __future__ import annotations

import asyncio
import logging
import threading
from typing import Awaitable, Callable, List, Optional

from ..tokens import TokenBlock
from .protocols import (
    KvCacheEvent,
    KvRemovedEvent,
    KvStoredEvent,
    RouterEvent,
    StoredBlock,
)

log = logging.getLogger("dynamo_tpu_torch.kv_events")

PublishFn = Callable[[str, dict], Awaitable[None]]


class KvEventPublisher:
    """Thread-safe producer, asyncio consumer.

    The engine thread calls ``block_stored``/``blocks_removed`` (cheap, no IO);
    ``run`` drains and hands RouterEvents to the transport publish function.
    """

    def __init__(self, worker_id: int, publish: PublishFn,
                 subject: str = "kv_events"):
        self.worker_id = worker_id
        self.subject = subject
        self._publish = publish
        self._event_id = 0
        self._buf: List[KvCacheEvent] = []
        self._lock = threading.Lock()
        self._task: Optional[asyncio.Task] = None
        self._wake: Optional[asyncio.Event] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self.published = 0

    # -- engine-thread side (hooks for PagePool) ------------------------
    def block_stored(self, seq_id: str, block: TokenBlock, page: int,
                     lora_id: int = 0) -> None:
        ev = KvCacheEvent(
            event_id=self._next_id(),
            stored=KvStoredEvent(
                blocks=[StoredBlock(block_hash=block.sequence_hash,
                                    tokens_hash=block.block_hash)],
                parent_hash=block.parent_sequence_hash,
                lora_id=lora_id,
            ))
        self._push(ev)

    def blocks_removed(self, seq_hashes: List[int]) -> None:
        """Fired when sealed blocks are EVICTED from the device pool (with
        block reuse, sequence release keeps blocks matchable — only eviction
        removes them from this worker's prefix cache)."""
        ev = KvCacheEvent(
            event_id=self._next_id(),
            removed=KvRemovedEvent(block_hashes=list(seq_hashes)))
        self._push(ev)

    def _next_id(self) -> int:
        with self._lock:
            self._event_id += 1
            return self._event_id

    def _push(self, ev: KvCacheEvent) -> None:
        with self._lock:
            self._buf.append(ev)
        wake, loop = self._wake, self._loop
        if wake is not None and loop is not None:
            try:
                loop.call_soon_threadsafe(wake.set)
            except RuntimeError:
                pass  # loop closed; the 0.2s poll in _run still drains

    # -- asyncio side ---------------------------------------------------
    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._wake = asyncio.Event()
        self._task = asyncio.create_task(self._run(), name="kv-event-pub")

    async def stop(self) -> None:
        if self._task:
            await self.flush()
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def flush(self) -> None:
        await self._drain()

    async def _drain(self) -> None:
        with self._lock:
            batch, self._buf = self._buf, []
        for i, ev in enumerate(batch):
            try:
                await self._publish(
                    self.subject,
                    RouterEvent(self.worker_id, ev).to_dict())
            except Exception:
                # transport outage (e.g. store reconnecting): put the
                # unsent tail back IN ORDER and retry on a later beat —
                # the router's index depends on event order per worker
                with self._lock:
                    self._buf = batch[i:] + self._buf
                raise
            self.published += 1

    async def _run(self) -> None:
        assert self._wake is not None
        while True:
            try:
                await self._drain()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 - keep the pump alive
                log.debug("kv event publish deferred (%s); retrying",
                          e)
            try:
                await asyncio.wait_for(self._wake.wait(), timeout=0.2)
                self._wake.clear()
            except asyncio.TimeoutError:
                pass
