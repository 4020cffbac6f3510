"""The port's wire codec against ``msgpack`` and the JAX package's framing.

``dynamo_tpu_torch/runtime/_msgpack.py`` replaces ``msgpack`` (absent on
the card's machine); every frame of the store protocol and the data plane
goes through it, so it must write ``msgpack.packb(obj, use_bin_type=True)``'s
bytes exactly and read them as ``msgpack.unpackb(body, raw=False)`` does.
"""

import asyncio
import math
import struct

import msgpack
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu.runtime import wire as jwire
from dynamo_tpu_torch.runtime import _msgpack
from dynamo_tpu_torch.runtime import wire as twire

# ints at every encoding boundary, and their neighbours
_EDGES = [0, 0x7f, 0x80, 0xff, 0x100, 0xffff, 0x10000, 0xffffffff,
          0x100000000, 0xffffffffffffffff, -1, -0x20, -0x21, -0x80, -0x81,
          -0x8000, -0x8001, -0x80000000, -0x80000001, -0x8000000000000000]
ints = st.one_of(st.sampled_from(_EDGES),
                 st.integers(min_value=-2 ** 63, max_value=2 ** 64 - 1))
floats = st.one_of(st.floats(allow_nan=True, allow_infinity=True),
                   st.sampled_from([0.0, -0.0, math.inf, -math.inf, 1e308,
                                    5e-324]))
# str lengths around the fixstr/str8/str16 boundaries, non-BMP included
texts = st.one_of(st.text(max_size=40),
                  st.sampled_from(["a" * 31, "a" * 32, "é" * 128,
                                   "\U0001f600" * 70, "x" * 255, "y" * 256,
                                   "z" * 65536]))
blobs = st.one_of(st.binary(max_size=300),
                  st.sampled_from([b"", b"\0" * 255, b"\1" * 256,
                                   b"\2" * 65536]))
scalars = st.one_of(st.none(), st.booleans(), ints, floats, texts, blobs,
                    blobs.map(bytearray))
objects = st.recursive(
    scalars,
    lambda inner: st.one_of(
        st.lists(inner, max_size=20),
        st.lists(inner, max_size=20).map(tuple),
        st.dictionaries(st.one_of(texts, blobs), inner, max_size=20)),
    max_leaves=60)


def _same(a, b) -> bool:
    """Equal, with NaN equal to NaN and the float sign of zero kept."""
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or (
            a == b and math.copysign(1, a) == math.copysign(1, b))
    if type(a) is not type(b):
        return False
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    return a == b


@settings(max_examples=300, deadline=None)
@given(objects)
def test_pack_is_byte_identical_and_round_trips(obj):
    want = msgpack.packb(obj, use_bin_type=True)
    got = _msgpack.packb(obj)
    assert got == want
    assert _same(_msgpack.unpackb(want), msgpack.unpackb(want, raw=False))
    # a bytearray and a memoryview of the frame read the same
    assert _same(_msgpack.unpackb(bytearray(want)),
                 msgpack.unpackb(want, raw=False))
    assert _same(_msgpack.unpackb(memoryview(want)),
                 msgpack.unpackb(want, raw=False))


@settings(max_examples=100, deadline=None)
@given(objects, st.data())
def test_truncated_input_fails_as_msgpack_does(obj, data):
    body = msgpack.packb(obj, use_bin_type=True)
    if len(body) < 2:
        return
    cut = data.draw(st.integers(min_value=0, max_value=len(body) - 1))
    with pytest.raises(ValueError) as want:
        msgpack.unpackb(body[:cut], raw=False)
    with pytest.raises(ValueError) as got:
        _msgpack.unpackb(body[:cut])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("obj", [
    np.int64(1), np.float32(1.5), np.bool_(True), {1, 2}, 1 + 2j, object(),
    2 ** 64, -2 ** 63 - 1, "\ud800",
    memoryview(np.arange(6, dtype=np.int32))[::2],
], ids=["np.int64", "np.float32", "np.bool_", "set", "complex", "object",
        "2**64", "-2**63-1", "surrogate", "strided-view"])
def test_pack_refuses_what_msgpack_refuses(obj):
    with pytest.raises(Exception) as want:
        msgpack.packb(obj, use_bin_type=True)
    with pytest.raises(Exception) as got:
        _msgpack.packb(obj)
    assert type(got.value) is type(want.value)
    if isinstance(want.value, TypeError):
        assert str(got.value) == str(want.value)


def test_pack_accepts_what_msgpack_coerces_by_type():
    import enum

    class Level(enum.IntEnum):
        HIGH = 3

    class Name(str):
        pass

    for obj in (np.float64(2.5), Level.HIGH, Name("x"), True, {"k": (1,)},
                memoryview(np.arange(3, dtype=np.int32)),
                memoryview(b"abc")):
        assert _msgpack.packb(obj) == msgpack.packb(obj, use_bin_type=True)


@pytest.mark.parametrize("depth", [511, 512])
def test_pack_nesting_limit(depth):
    obj: list = []
    inner = obj
    for _ in range(depth):
        inner.append([])
        inner = inner[0]
    try:
        want = msgpack.packb(obj, use_bin_type=True)
    except ValueError:
        with pytest.raises(ValueError):
            _msgpack.packb(obj)
    else:
        assert _msgpack.packb(obj) == want


@pytest.mark.parametrize("body,kind", [
    (b"", ValueError), (b"\xc1", ValueError), (b"\x01\x02", ValueError),
    (b"\x81\x01\x02", ValueError), (b"\x81\x91\x01\x02", ValueError),
    (b"\x81\xc0\x02", ValueError), (b"\xa1\xff", UnicodeDecodeError),
    (b"\x91" * 1025 + b"\xc0", ValueError),
], ids=["empty", "c1", "extra", "int-key", "list-key", "nil-key",
        "bad-utf8", "deep"])
def test_unpack_refuses_what_msgpack_refuses(body, kind):
    with pytest.raises(kind) as want:
        msgpack.unpackb(body, raw=False)
    with pytest.raises(kind) as got:
        _msgpack.unpackb(body)
    assert str(got.value) == str(want.value)
    assert type(got.value).__name__ == type(want.value).__name__


def test_unpack_keeps_bytes_keys_and_deep_nesting():
    for body in (b"\x81\xc4\x01\x80\x01", b"\x91" * 1024 + b"\xc0"):
        assert _msgpack.unpackb(body) == msgpack.unpackb(body, raw=False)


def test_large_bin_payload_passes_through():
    blob = bytes(range(256)) * 4096          # 1 MiB, a KV block's order
    frame = [{"kind": "data", "ctype": "bin"}, blob]
    body = _msgpack.packb(frame)
    assert body == msgpack.packb(frame, use_bin_type=True)
    assert _msgpack.unpackb(body)[1] == blob


# ---------------------------------------------------------------------------
# frames: the port's wire module against the JAX package's
# ---------------------------------------------------------------------------

FRAMES = [
    {"op": "put", "id": 7, "key": "dynamo/components/backend/generate:1f",
     "value": b"\x00\x01", "lease": 2 ** 40},
    {"push": "watch", "wid": 3, "key": "models/chat/m:i-1f", "value": None,
     "deleted": True},
    [{"kind": "request", "endpoint": "generate", "context_id": "c-1",
      "deadline": 1792243177.25, "trace": ["t", "s"], "priority": "batch"},
     b'{"token_ids": [1, 2, 3]}'],
    [{"kind": "data"}, b'{"token_ids": [5], "finish_reason": null}'],
    [{"kind": "error", "message": "shed", "code": 429, "stage": "worker",
      "reason": "queue_full", "retry_after": 0.5}, None],
]


@pytest.mark.parametrize("obj", FRAMES, ids=lambda o: str(o)[:24])
def test_frames_equal_the_jax_wire(obj):
    assert twire.pack(obj) == jwire.pack(obj)
    if isinstance(obj, list):
        assert twire.pack_two_part(*obj) == jwire.pack_two_part(*obj)
        assert twire.unpack_two_part(obj) == jwire.unpack_two_part(obj)


def test_wire_field_registry_equals_jax():
    assert twire.WIRE_FIELDS == jwire.WIRE_FIELDS
    for name in dir(jwire):
        if name.endswith("_KEY"):
            assert getattr(twire, name) == getattr(jwire, name), name
    assert twire.MAX_FRAME == jwire.MAX_FRAME


@pytest.mark.parametrize("bad", [[1, 2, 3], "x", [[1], None]])
def test_unpack_two_part_rejects_malformed(bad):
    with pytest.raises(ValueError) as j:
        jwire.unpack_two_part(bad)
    with pytest.raises(ValueError) as t:
        twire.unpack_two_part(bad)
    assert str(t.value) == str(j.value)


async def test_frame_reader_resumes_after_a_cancel_mid_frame():
    async def body():
        reader = asyncio.StreamReader()
        fr = twire.FrameReader(reader)
        frame = jwire.pack([{"kind": "data"}, b"payload" * 10])
        nxt = jwire.pack([{"kind": "sentinel"}, None])
        # header and part of the body: the read parks on the body
        reader.feed_data(frame[:9])
        task = asyncio.ensure_future(fr.read())
        await asyncio.sleep(0.01)
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        assert fr._pending_len == len(frame) - 4
        reader.feed_data(frame[9:] + nxt)
        assert await fr.read() == [{"kind": "data"}, b"payload" * 10]
        assert await fr.read() == [{"kind": "sentinel"}, None]
        # a cancel inside the header leaves nothing consumed
        reader.feed_data(frame[:2])
        task = asyncio.ensure_future(fr.read())
        await asyncio.sleep(0.01)
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        reader.feed_data(frame[2:])
        assert (await fr.read())[1] == b"payload" * 10
        reader.feed_data(struct.pack(">I", twire.MAX_FRAME + 1))
        with pytest.raises(ValueError):
            await fr.read()

    await asyncio.wait_for(body(), 10)
