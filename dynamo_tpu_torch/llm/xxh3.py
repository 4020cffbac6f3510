"""XXH3-64 in pure Python, bit for bit equal to ``XXH3_64bits_withSeed``.

The KV block-hash chain is the system's wire contract with the router, the
KV cluster and disagg: a torch worker has to produce the same 64-bit hashes
as a JAX worker, which uses the ``xxhash`` package. That package is not part
of the port's dependencies, so this module carries the algorithm itself,
transcribed from the xxHash project (Cyan4973/xxHash, ``xxhash.h`` v0.8.x,
BSD-2-Clause): the seven length classes (0, 1-3, 4-8, 9-16, 17-128,
129-240, >240 bytes), the 192-byte default secret, the seed-derived custom
secret of the long path (``XXH3_initCustomSecret``), its 64-byte stripes
over 8 accumulators with a scramble after every 16 stripes, and the
128-bit multiply-folds of the merge.

Integers are Python ints masked to 64 bits. Cost: a few microseconds for a
16-byte chain hash, tens of microseconds for a 256-byte block (the engine
hashes each prompt block once, at admission).
"""

from __future__ import annotations

import struct
from typing import Dict, Tuple

M64 = 0xFFFFFFFFFFFFFFFF
M32 = 0xFFFFFFFF

P32_1 = 0x9E3779B1
P32_2 = 0x85EBCA77
P32_3 = 0xC2B2AE3D
P64_1 = 0x9E3779B185EBCA87
P64_2 = 0xC2B2AE3D27D4EB4F
P64_3 = 0x165667B19E3779F9
P64_4 = 0x85EBCA77C2B2AE63
P64_5 = 0x27D4EB2F165667C5
PRIME_MX1 = 0x165667919E3779F9
PRIME_MX2 = 0x9FB21C651E98DF25

K_SECRET = bytes.fromhex(
    "b8fe6c3923a44bbe7c01812cf721ad1cded46de9839097db7240a4a4b7b3671f"
    "cb79e64eccc0e578825ad07dccff7221b8084674f743248ee03590e6813a264c"
    "3c2852bb91c300cb88d0658b1b532ea371644897a20df94e3819ef46a9deacd8"
    "a8fa763fe39c343ff9dcbbc7c70b4f1d8a51e04bcdb45931c89f7ec9d9787364"
    "eac5ac8334d3ebc3c581a0fffa1363eb170ddd51b7f0da49d316552629d4689e"
    "2b16be587d47a1fc8ff8b8d17ad031ce45cb3a8f95160428afd7fbcabb4b407e")
assert len(K_SECRET) == 192

SECRET_SIZE_MIN = 136
STRIPE_LEN = 64
SECRET_CONSUME_RATE = 8
SECRET_LASTACC_START = 7
SECRET_MERGEACCS_START = 11
MIDSIZE_STARTOFFSET = 3
MIDSIZE_LASTOFFSET = 17

_u32 = struct.Struct("<I").unpack_from
_u64 = struct.Struct("<Q").unpack_from
_u64x8 = struct.Struct("<8Q").unpack_from


def _r32(b: bytes, off: int) -> int:
    return _u32(b, off)[0]


def _r64(b: bytes, off: int) -> int:
    return _u64(b, off)[0]


def _mul128_fold64(a: int, b: int) -> int:
    p = a * b
    return (p ^ (p >> 64)) & M64


def _xorshift(v: int, s: int) -> int:
    return v ^ (v >> s)


def _rotl64(v: int, r: int) -> int:
    return ((v << r) | (v >> (64 - r))) & M64


def _swap32(v: int) -> int:
    return int.from_bytes(v.to_bytes(4, "little"), "big")


def _swap64(v: int) -> int:
    return int.from_bytes(v.to_bytes(8, "little"), "big")


def _xxh64_avalanche(h: int) -> int:
    h ^= h >> 33
    h = (h * P64_2) & M64
    h ^= h >> 29
    h = (h * P64_3) & M64
    return h ^ (h >> 32)


def _avalanche(h: int) -> int:
    h = _xorshift(h, 37)
    h = (h * PRIME_MX1) & M64
    return _xorshift(h, 32)


def _rrmxmx(h: int, length: int) -> int:
    h ^= _rotl64(h, 49) ^ _rotl64(h, 24)
    h = (h * PRIME_MX2) & M64
    h ^= (h >> 35) + length
    h = (h * PRIME_MX2) & M64
    return _xorshift(h, 28)


# ---------------------------------------------------------------------------
# short and mid-size inputs (seed applied directly, default secret)
# ---------------------------------------------------------------------------

def _len_1to3(b: bytes, n: int, sec: bytes, seed: int) -> int:
    c1, c2, c3 = b[0], b[n >> 1], b[n - 1]
    combined = (c1 << 16) | (c2 << 24) | c3 | (n << 8)
    bitflip = ((_r32(sec, 0) ^ _r32(sec, 4)) + seed) & M64
    return _xxh64_avalanche(combined ^ bitflip)


def _len_4to8(b: bytes, n: int, sec: bytes, seed: int) -> int:
    seed ^= _swap32(seed & M32) << 32
    in1 = _r32(b, 0)
    in2 = _r32(b, n - 4)
    bitflip = ((_r64(sec, 8) ^ _r64(sec, 16)) - seed) & M64
    in64 = (in2 + (in1 << 32)) & M64
    return _rrmxmx(in64 ^ bitflip, n)


def _len_9to16(b: bytes, n: int, sec: bytes, seed: int) -> int:
    bitflip1 = ((_r64(sec, 24) ^ _r64(sec, 32)) + seed) & M64
    bitflip2 = ((_r64(sec, 40) ^ _r64(sec, 48)) - seed) & M64
    lo = _r64(b, 0) ^ bitflip1
    hi = _r64(b, n - 8) ^ bitflip2
    acc = (n + _swap64(lo) + hi + _mul128_fold64(lo, hi)) & M64
    return _avalanche(acc)


def _mix16(b: bytes, off: int, sec: bytes, soff: int, seed: int) -> int:
    lo = _r64(b, off)
    hi = _r64(b, off + 8)
    return _mul128_fold64(lo ^ ((_r64(sec, soff) + seed) & M64),
                          hi ^ ((_r64(sec, soff + 8) - seed) & M64))


def _len_17to128(b: bytes, n: int, sec: bytes, seed: int) -> int:
    acc = (n * P64_1) & M64
    if n > 32:
        if n > 64:
            if n > 96:
                acc += _mix16(b, 48, sec, 96, seed)
                acc += _mix16(b, n - 64, sec, 112, seed)
            acc += _mix16(b, 32, sec, 64, seed)
            acc += _mix16(b, n - 48, sec, 80, seed)
        acc += _mix16(b, 16, sec, 32, seed)
        acc += _mix16(b, n - 32, sec, 48, seed)
    acc += _mix16(b, 0, sec, 0, seed)
    acc += _mix16(b, n - 16, sec, 16, seed)
    return _avalanche(acc & M64)


def _len_129to240(b: bytes, n: int, sec: bytes, seed: int) -> int:
    acc = (n * P64_1) & M64
    for i in range(8):
        acc += _mix16(b, 16 * i, sec, 16 * i, seed)
    acc_end = _mix16(b, n - 16, sec, SECRET_SIZE_MIN - MIDSIZE_LASTOFFSET,
                     seed)
    acc = _avalanche(acc & M64)
    for i in range(8, n // 16):
        acc_end += _mix16(b, 16 * i, sec, 16 * (i - 8) + MIDSIZE_STARTOFFSET,
                          seed)
    return _avalanche((acc + acc_end) & M64)


# ---------------------------------------------------------------------------
# long inputs (> 240 bytes): stripes over 8 accumulators
# ---------------------------------------------------------------------------

_custom_secrets: Dict[int, Tuple[bytes, Tuple[Tuple[int, ...], ...],
                                 Tuple[int, ...], Tuple[int, ...]]] = {}


def _init_custom_secret(seed: int) -> bytes:
    """``XXH3_initCustomSecret``: the default secret with the seed added to
    the low and subtracted from the high word of every 16-byte pair."""
    out = bytearray(len(K_SECRET))
    for i in range(len(K_SECRET) // 16):
        lo = (_r64(K_SECRET, 16 * i) + seed) & M64
        hi = (_r64(K_SECRET, 16 * i + 8) - seed) & M64
        struct.pack_into("<QQ", out, 16 * i, lo, hi)
    return bytes(out)


def _long_secret(seed: int):
    """(secret, per-stripe keys, scramble keys, last-stripe keys) for a
    seed, derived once and kept (three seeds are live in this system)."""
    got = _custom_secrets.get(seed)
    if got is None:
        sec = K_SECRET if seed == 0 else _init_custom_secret(seed)
        n_stripes = (len(sec) - STRIPE_LEN) // SECRET_CONSUME_RATE
        stripe_keys = tuple(_u64x8(sec, SECRET_CONSUME_RATE * s)
                            for s in range(n_stripes))
        scramble = _u64x8(sec, len(sec) - STRIPE_LEN)
        last = _u64x8(sec, len(sec) - STRIPE_LEN - SECRET_LASTACC_START)
        got = (sec, stripe_keys, scramble, last)
        if len(_custom_secrets) < 64:
            _custom_secrets[seed] = got
    return got


def _accumulate_512(acc: list, data: Tuple[int, ...],
                    keys: Tuple[int, ...]) -> None:
    for lane in range(8):
        v = data[lane]
        k = v ^ keys[lane]
        acc[lane ^ 1] = (acc[lane ^ 1] + v) & M64
        acc[lane] = (acc[lane] + (k & M32) * (k >> 32)) & M64


def _scramble(acc: list, keys: Tuple[int, ...]) -> None:
    for lane in range(8):
        a = _xorshift(acc[lane], 47) ^ keys[lane]
        acc[lane] = (a * P32_1) & M64


def _hash_long(b: bytes, n: int, seed: int) -> int:
    sec, stripe_keys, scramble, last = _long_secret(seed)
    per_block = len(stripe_keys)                 # 16 stripes a block
    block_len = STRIPE_LEN * per_block
    nb_blocks = (n - 1) // block_len
    acc = [P32_3, P64_1, P64_2, P64_3, P64_4, P32_2, P64_5, P32_1]
    for blk in range(nb_blocks):
        base = blk * block_len
        for s in range(per_block):
            _accumulate_512(acc, _u64x8(b, base + s * STRIPE_LEN),
                            stripe_keys[s])
        _scramble(acc, scramble)
    base = nb_blocks * block_len
    for s in range(((n - 1) - base) // STRIPE_LEN):
        _accumulate_512(acc, _u64x8(b, base + s * STRIPE_LEN),
                        stripe_keys[s])
    _accumulate_512(acc, _u64x8(b, n - STRIPE_LEN), last)
    result = (n * P64_1) & M64
    for i in range(4):
        off = SECRET_MERGEACCS_START + 16 * i
        result += _mul128_fold64(acc[2 * i] ^ _r64(sec, off),
                                 acc[2 * i + 1] ^ _r64(sec, off + 8))
    return _avalanche(result & M64)


def xxh3_64(data: bytes, seed: int = 0) -> int:
    """XXH3-64 of ``data`` with a 64-bit ``seed`` (``XXH3_64bits_withSeed``;
    ``xxhash.xxh3_64_intdigest(data, seed=seed)``)."""
    b = bytes(data)
    n = len(b)
    seed &= M64
    sec = K_SECRET
    if n <= 16:
        if n > 8:
            return _len_9to16(b, n, sec, seed)
        if n >= 4:
            return _len_4to8(b, n, sec, seed)
        if n:
            return _len_1to3(b, n, sec, seed)
        return _xxh64_avalanche(seed ^ (_r64(sec, 56) ^ _r64(sec, 64)))
    if n <= 128:
        return _len_17to128(b, n, sec, seed)
    if n <= 240:
        return _len_129to240(b, n, sec, seed)
    return _hash_long(b, n, seed)
