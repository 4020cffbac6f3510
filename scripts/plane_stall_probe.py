"""Where the asyncio data plane's stalls come from, in a fresh process.

``chip_smoke.py``'s plane probe reads the asyncio plane at milliseconds an
item with the process's CPU idle on some hosts, while the native plane
beside it runs at tens of microseconds. This script reads, each in turn
and each capped at ``chip_smoke.PROBE_ITEMS_S``, a stream of 2000 small
frames (the probe's EngineOutput data frame):

- ``port_asyncio`` and ``port_native``: ``chip_smoke.probe_turn`` on each
  of the port's planes, over a native dynstore;
- ``bare_per_frame``: a plain asyncio server and client on one loop, no
  code of the port, the server writing one frame a ``write`` and
  awaiting ``drain`` after each (the asyncio plane's pattern);
- ``bare_yield``: the same with the server yielding to the loop after
  each frame, so the reader keeps up;
- ``bare_coalesced``: the same frames, 64 a ``write``.

Prints one JSON line a case (µs an item, this process's CPU µs an item,
the item gaps over 1 ms, their sum and the largest) and one line with
the host's kernel release and the client socket's buffer sizes.

    python scripts/plane_stall_probe.py
"""

from __future__ import annotations

import asyncio
import json
import os
import platform
import socket
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITEMS = 2000


def frame() -> bytes:
    from dynamo_tpu_torch.llm.protocols.common import EngineOutput
    from dynamo_tpu_torch.runtime import wire

    item = EngineOutput(token_ids=[12345], cum_log_prob=-1.5,
                        kv_prefix_hit_tokens=1024).to_dict()
    return wire.pack([{wire.KIND_KEY: "data"}, json.dumps(item).encode()])


async def bare(mode: str, cap_s: float) -> dict:
    """One stream of ITEMS frames from a plain asyncio server to a client
    on this loop, the server writing as ``mode`` says."""
    data = frame()
    batch = 64 if mode == "bare_coalesced" else 1

    async def serve(reader, writer):
        await reader.readexactly(1)                 # the client's request
        for i in range(0, ITEMS, batch):
            writer.write(data * min(batch, ITEMS - i))
            await writer.drain()
            if mode == "bare_yield":
                await asyncio.sleep(0)
        writer.close()

    server = await asyncio.start_server(serve, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    sock = writer.get_extra_info("socket")
    bufs = dict(rcvbuf=sock.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF),
                sndbuf=sock.getsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF),
                nodelay=sock.getsockopt(socket.IPPROTO_TCP,
                                        socket.TCP_NODELAY))
    t0 = last = time.perf_counter()
    c0 = time.process_time()
    writer.write(b"r")
    gaps, got = [], 0
    try:
        while got < ITEMS:
            n = int.from_bytes(await reader.readexactly(4), "big")
            await reader.readexactly(n)
            got += 1
            now = time.perf_counter()
            gaps.append(now - last)
            last = now
            if now - t0 > cap_s:
                break
    finally:
        writer.close()
        server.close()
    return dict(_row(got, time.perf_counter() - t0, time.process_time() - c0,
                     gaps), client_socket=bufs)


def _row(items: int, wall: float, cpu: float, gaps: list) -> dict:
    slow = [g for g in gaps if g > 1e-3]
    return dict(items=items, us_per_item=1e6 * wall / items,
                cpu_us_per_item=1e6 * cpu / items, gaps_over_1ms=len(slow),
                gaps_over_1ms_s=sum(slow), max_gap_ms=1e3 * max(gaps))


async def run() -> None:
    import chip_smoke as cs
    from dynamo_tpu_torch.runtime.store_server import NativeStoreServer

    print(json.dumps({"kernel": platform.release(),
                      "python": sys.version.split()[0]}), flush=True)
    store = NativeStoreServer(host="127.0.0.1", port=0)
    port = await store.start()
    try:
        for mode in ("python", "native"):
            row = await cs.probe_turn(port, mode, f"stall-{mode}",
                                      parts_too=False)
            print(json.dumps({"case": f"port_{'asyncio' if mode == 'python'
                                               else mode}", **row}),
                  flush=True)
    finally:
        await store.stop()
    for mode in ("bare_per_frame", "bare_yield", "bare_coalesced"):
        print(json.dumps({"case": mode,
                          **await bare(mode, cs.PROBE_ITEMS_S)}),
              flush=True)


def main() -> int:
    sys.path.insert(0, ROOT)
    asyncio.run(run())
    return 0


if __name__ == "__main__":
    sys.exit(main())
