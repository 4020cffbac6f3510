"""ctypes binding for the native KV-event publisher
(``dynamo_tpu_torch/native/kv_publisher.cpp``).

The C ABI is the engine-integration surface the reference exposes from
lib/bindings/c (dynamo_llm_init / dynamo_kv_event_publish_stored /
dynamo_kv_event_publish_removed / dynamo_llm_shutdown): native engines link
it and report KV block store/evict without touching Python. Events arrive on
the ``{ns}.{component}.kv_events`` subject as RouterEvent JSON — exactly what
:class:`..kv_router.indexer.KvIndexer` consumes from the Python publisher.

The library is built from the port's own source at first use
(:mod:`dynamo_tpu_torch.native._build`), so it always has the lora-tagged
``_v2`` entry. It holds ONE process-global connection (matching the
reference's C binding); instantiate one publisher per process.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple


def _load_lib() -> ctypes.CDLL:
    from ...native._build import build

    lib = ctypes.CDLL(str(build("libdynamo_kv.so")))
    lib.dynamo_llm_init.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int64]
    lib.dynamo_llm_init.restype = ctypes.c_int
    lib.dynamo_kv_event_publish_stored_v2.argtypes = [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_size_t, ctypes.c_int,
        ctypes.c_uint64, ctypes.c_uint64]
    lib.dynamo_kv_event_publish_stored_v2.restype = ctypes.c_int
    lib.dynamo_kv_event_publish_removed.argtypes = [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_uint64), ctypes.c_size_t]
    lib.dynamo_kv_event_publish_removed.restype = ctypes.c_int
    lib.dynamo_llm_shutdown.argtypes = []
    lib.dynamo_llm_shutdown.restype = ctypes.c_int
    return lib


class NativeKvPublisher:
    """Engine-side KV event publisher backed by the C library.

    Publishes on a background native thread — calls here never block on the
    network, mirroring the reference's mpsc->publisher design. The
    constructor connects to the store, so an asyncio caller runs it in an
    executor.
    """

    def __init__(self, host: str, port: int, namespace: str, component: str,
                 worker_id: int):
        self._lib = _load_lib()
        rc = self._lib.dynamo_llm_init(
            host.encode(), port, namespace.encode(), component.encode(),
            worker_id)
        if rc != 0:
            raise RuntimeError(
                f"dynamo_llm_init failed (rc={rc}): store at {host}:{port} "
                "unreachable or publisher already initialized in-process")
        self._event_id = 0

    def _next_id(self) -> int:
        self._event_id += 1
        return self._event_id

    def publish_stored(self, blocks: Sequence[Tuple[int, int]],
                       parent_hash: Optional[int] = None,
                       lora_id: int = 0) -> int:
        """blocks = [(block_hash a.k.a. sequence hash, tokens_hash), ...].

        The hashes must already be lora-salted at the chain root (see
        tokens.lora_chain_root); ``lora_id`` rides the wire for parity with
        the reference C ABI and consumer-side auditing."""
        n = len(blocks)
        bh = (ctypes.c_uint64 * n)(*[b for b, _ in blocks])
        th = (ctypes.c_uint64 * n)(*[t for _, t in blocks])
        eid = self._next_id()
        rc = self._lib.dynamo_kv_event_publish_stored_v2(
            eid, bh, th, n, int(parent_hash is not None), parent_hash or 0,
            lora_id)
        if rc != 0:
            raise RuntimeError("publisher not initialized")
        return eid

    def publish_removed(self, block_hashes: List[int]) -> int:
        n = len(block_hashes)
        bh = (ctypes.c_uint64 * n)(*block_hashes)
        eid = self._next_id()
        rc = self._lib.dynamo_kv_event_publish_removed(eid, bh, n)
        if rc != 0:
            raise RuntimeError("publisher not initialized")
        return eid

    def shutdown(self) -> None:
        self._lib.dynamo_llm_shutdown()
