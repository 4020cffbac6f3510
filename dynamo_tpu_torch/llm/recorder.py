"""JSONL record/replay of event streams.

Capture any dict-event stream (KV events, router decisions) to a JSONL file
with timestamps, and replay it later — deterministic router tests and offline
analysis. :class:`Recorder` supports pause/resume, predicate filtering, and
auto-stop bounds (max events / max duration); :class:`KvRecorder` taps the
live event plane directly (``attach`` subscribes a component's ``kv_events``
subject) and replays a capture straight into a ``KvIndexer`` — so a recorded
production stream can drive router tests bit-for-bit.

The JAX package's ``dynamo_tpu/llm/recorder.py``, line for line: the JSONL
lines are the same, field for field (timestamps apart). Reference
capability: lib/llm/src/recorder.rs:38-291 (Recorder with
pause/resume + event bounds) and KvRecorder (event-plane tap + indexer feed,
recorder.rs KvRecorder::new / send_events).
"""

from __future__ import annotations

import json
import time
from typing import (Any, AsyncIterator, Callable, Dict, Iterator, List,
                    Optional)

EventFilter = Callable[[Dict[str, Any]], bool]


class Recorder:
    """Append-only JSONL event capture.

    - ``filter_fn``: events failing the predicate are counted in
      ``skipped`` and not written.
    - ``max_events`` / ``max_duration_s``: the recorder auto-stops once
      either bound is reached (``stopped`` turns True; further events are
      skipped) — bounded captures on unbounded streams.
    - :meth:`pause` / :meth:`resume`: gate recording without tearing down
      the file or the subscriptions feeding it.
    """

    def __init__(self, path: str, filter_fn: Optional[EventFilter] = None,
                 max_events: Optional[int] = None,
                 max_duration_s: Optional[float] = None):
        self.path = path
        self._f = open(path, "a")
        self.filter_fn = filter_fn
        self.max_events = max_events
        self.max_duration_s = max_duration_s
        self.count = 0
        self.skipped = 0
        self.paused = False
        self.stopped = False
        self._t0 = time.monotonic()

    # ------------------------------------------------------------------
    def elapsed(self) -> float:
        return time.monotonic() - self._t0

    def pause(self) -> None:
        self.paused = True

    def resume(self) -> None:
        self.paused = False

    def record(self, event: Dict[str, Any]) -> bool:
        """Write one event; returns False when gated (paused/stopped/
        filtered) — the caller's stream keeps flowing either way."""
        if self.stopped or self.paused:
            self.skipped += 1
            return False
        if (self.max_duration_s is not None
                and self.elapsed() >= self.max_duration_s):
            self.stopped = True
            self.skipped += 1
            return False
        if self.filter_fn is not None and not self.filter_fn(event):
            self.skipped += 1
            return False
        self._f.write(json.dumps({"ts": time.time(), "event": event}) + "\n")
        self.count += 1
        if self.max_events is not None and self.count >= self.max_events:
            self.stopped = True
        return True

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        # stop BEFORE closing: a live event-plane tap (attach) has no
        # unsubscribe surface, so record() must gate every later event
        # instead of raising on a closed file
        self.stopped = True
        self._f.close()

    def __enter__(self) -> "Recorder":
        return self

    def __exit__(self, *a) -> None:
        self.close()


def _iter_paced(path: str, speed: Optional[float]) -> Iterator[tuple]:
    """Shared parse-and-pace core of :func:`replay` / :func:`areplay`:
    yields ``(delay_s, event)``, where ``delay_s`` is how long a paced
    replay waits BEFORE delivering the event (0.0 unpaced). The two
    public replays differ ONLY in how they sleep."""
    prev_ts: Optional[float] = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            delay = 0.0
            if speed and prev_ts is not None:
                delay = max(0.0, (rec["ts"] - prev_ts) / speed)
            prev_ts = rec["ts"]
            yield delay, rec["event"]


def replay(path: str, speed: Optional[float] = None
           ) -> Iterator[Dict[str, Any]]:
    """Yield recorded events; ``speed`` (e.g. 1.0) reproduces original pacing,
    None replays as fast as possible.

    Offline/sync use only: pacing blocks in ``time.sleep``. From a running
    event loop (replaying a capture into a live router/indexer) use
    :func:`areplay` — a paced sync replay on the loop would freeze every
    other coroutine for the capture's full duration.
    """
    for delay, event in _iter_paced(path, speed):
        if delay > 0:
            time.sleep(delay)
        yield event


async def areplay(path: str, speed: Optional[float] = None
                  ) -> "AsyncIterator[Dict[str, Any]]":
    """Async :func:`replay`: paces with ``asyncio.sleep`` so a live replay
    shares the loop instead of parking it."""
    import asyncio

    for delay, event in _iter_paced(path, speed):
        # sleep(0) on the unpaced path is a bare yield: replaying a large
        # capture must not park every other coroutine on the loop
        await asyncio.sleep(delay)
        yield event


class KvRecorder(Recorder):
    """Recorder wired to the KV event plane.

    Two ingestion paths:
    - hand :meth:`publish` to a :class:`KvEventPublisher` as its transport
      (records instead of, or alongside, publishing);
    - :meth:`attach` subscribes a live component's ``kv_events`` subject and
      records every RouterEvent payload that flows — the production tap.

    Replay feeds a ``KvIndexer`` (or anything with ``apply_sync``)
    directly, reproducing the radix-tree state the live router had.
    """

    async def publish(self, subject: str, payload: Dict[str, Any]) -> None:
        self.record({"subject": subject, "payload": payload})

    async def attach(self, component, subject: Optional[str] = None
                     ) -> "KvRecorder":
        """Subscribe ``component``'s KV-event subject; every payload is
        recorded (subject to pause/filter/bounds)."""
        from .kv_router.protocols import KV_EVENT_SUBJECT

        subject = subject or KV_EVENT_SUBJECT

        async def on_event(payload: Dict[str, Any]) -> None:
            self.record({"subject": subject, "payload": payload})

        await component.subscribe(subject, on_event)
        return self

    # ------------------------------------------------------------------
    def replay_into(self, apply: Callable[[Dict[str, Any]], None],
                    speed: Optional[float] = None) -> int:
        n = 0
        for ev in replay(self.path, speed=speed):
            apply(ev["payload"])
            n += 1
        return n

    async def replay_into_async(self, apply: Callable[[Dict[str, Any]],
                                                      None],
                                speed: Optional[float] = None) -> int:
        """:meth:`replay_into` for a running event loop: paced replays
        into a LIVE indexer/router must not block its loop."""
        n = 0
        async for ev in areplay(self.path, speed=speed):
            apply(ev["payload"])
            n += 1
        return n

    def replay_into_indexer(self, indexer, speed: Optional[float] = None,
                            worker_ids: Optional[List[int]] = None) -> int:
        """Feed the capture straight into a KvIndexer: each payload parses
        as a RouterEvent and applies in recorded order. ``worker_ids``
        restricts the replay to a subset of workers (per-worker analysis of
        a cluster-wide capture). Returns events applied."""
        from .kv_router.protocols import RouterEvent

        n = 0
        for ev in replay(self.path, speed=speed):
            rev = RouterEvent.from_dict(ev["payload"])
            if worker_ids is not None and rev.worker_id not in worker_ids:
                continue
            indexer.apply_sync(rev)
            n += 1
        return n
