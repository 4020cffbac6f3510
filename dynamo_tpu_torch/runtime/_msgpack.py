"""A pure-Python MessagePack codec with the bytes of ``msgpack``'s packer.

The port's card has no ``msgpack``, yet every frame of the store protocol
and the data plane must stay byte-compatible with the JAX package's wire
(``msgpack.packb(obj, use_bin_type=True)`` / ``msgpack.unpackb(body,
raw=False)``), so a JAX process and a torch process can share a store and a
router. This module is written from the MessagePack spec and reproduces what
that call pair does:

- ints take the smallest encoding (positive fixint, negative fixint, then
  uint8/int8, uint16/int16, uint32/int32, uint64/int64); beyond 64 bits
  packing raises ``OverflowError``;
- floats are always float64 (``0xcb``);
- ``str`` is UTF-8 in fixstr/str8/str16/str32; ``bytes``, ``bytearray``
  and C-contiguous ``memoryview`` are bin8/16/32;
- ``list`` and ``tuple`` are arrays, ``dict`` is a map in insertion order;
- subclasses of these types pack as their base type; any other type
  (``numpy.int64``, ``set``, ...) raises ``TypeError`` and is never coerced;
- nesting deeper than 511 containers raises ``ValueError`` on pack, deeper
  than 1024 raises :class:`StackError` on unpack.

Unpacking returns lists for arrays, refuses map keys other than ``str`` and
``bytes`` (``strict_map_key``), decodes str payloads strictly, and raises
``ValueError("Unpack failed: incomplete input")`` on truncated input,
:class:`ExtraData` on trailing bytes and :class:`FormatError` on the unused
``0xc1`` byte. Ext types come back as :class:`ExtType` (timestamps too);
the wire never carries them, and the packer writes none.

The packer appends to one ``bytearray`` with precompiled ``struct`` formats;
bin payloads are copied in one slice, with no per-element work, so KV block
payloads ride through at memcpy speed.
"""

from __future__ import annotations

import struct
from typing import Any, NamedTuple

__all__ = ["packb", "unpackb", "ExtType", "ExtraData", "FormatError",
           "StackError"]

PACK_NEST_LIMIT = 511     # msgpack's DEFAULT_RECURSE_LIMIT
UNPACK_STACK_LIMIT = 1024  # containers open at once in msgpack's unpacker


class ExtraData(ValueError):
    """Bytes left over after one complete object."""

    def __init__(self, unpacked: Any, extra: bytes):
        super().__init__("unpack(b) received extra data.")
        self.unpacked = unpacked
        self.extra = extra


class FormatError(ValueError):
    """A byte that begins no MessagePack object (``0xc1``)."""


class StackError(ValueError):
    """More nested containers than the unpacker keeps open."""


class ExtType(NamedTuple):
    code: int
    data: bytes


_BB = struct.Struct(">BB")
_BH = struct.Struct(">BH")
_BI = struct.Struct(">BI")
_BQ = struct.Struct(">BQ")
_Bb = struct.Struct(">Bb")
_Bh = struct.Struct(">Bh")
_Bi = struct.Struct(">Bi")
_Bq = struct.Struct(">Bq")
_Bd = struct.Struct(">Bd")


def _type_name(o: Any) -> str:
    t = type(o)
    mod = t.__module__
    return t.__qualname__ if mod == "builtins" else f"{mod}.{t.__qualname__}"


def _pack_int(o: int, out: bytearray) -> None:
    if 0 <= o < 0x80:
        out.append(o)
    elif -0x20 <= o < 0:
        out.append(o & 0xff)
    elif 0 <= o:
        if o <= 0xff:
            out += _BB.pack(0xcc, o)
        elif o <= 0xffff:
            out += _BH.pack(0xcd, o)
        elif o <= 0xffffffff:
            out += _BI.pack(0xce, o)
        elif o <= 0xffffffffffffffff:
            out += _BQ.pack(0xcf, o)
        else:
            raise OverflowError("Integer value out of range")
    elif o >= -0x80:
        out += _Bb.pack(0xd0, o)
    elif o >= -0x8000:
        out += _Bh.pack(0xd1, o)
    elif o >= -0x80000000:
        out += _Bi.pack(0xd2, o)
    elif o >= -0x8000000000000000:
        out += _Bq.pack(0xd3, o)
    else:
        raise OverflowError("Integer value out of range")


def _pack_bin_header(n: int, out: bytearray) -> None:
    if n <= 0xff:
        out += _BB.pack(0xc4, n)
    elif n <= 0xffff:
        out += _BH.pack(0xc5, n)
    elif n <= 0xffffffff:
        out += _BI.pack(0xc6, n)
    else:
        raise ValueError("bin data too large")


def _pack_container_header(n: int, fix: int, c16: int, out: bytearray) -> None:
    if n < 16:
        out.append(fix | n)
    elif n <= 0xffff:
        out += _BH.pack(c16, n)
    elif n <= 0xffffffff:
        out += _BI.pack(c16 + 1, n)
    else:
        raise ValueError("container too large")


def _pack(o: Any, out: bytearray, limit: int) -> None:
    if limit < 0:
        raise ValueError("recursion limit exceeded.")
    if o is None:
        out.append(0xc0)
    elif o is True:
        out.append(0xc3)
    elif o is False:
        out.append(0xc2)
    elif isinstance(o, int):
        _pack_int(o, out)
    elif isinstance(o, float):
        out += _Bd.pack(0xcb, o)
    elif isinstance(o, (bytes, bytearray)):
        _pack_bin_header(len(o), out)
        out += o
    elif isinstance(o, str):
        s = o.encode("utf-8")
        n = len(s)
        if n < 32:
            out.append(0xa0 | n)
        elif n <= 0xff:
            out += _BB.pack(0xd9, n)
        elif n <= 0xffff:
            out += _BH.pack(0xda, n)
        elif n <= 0xffffffff:
            out += _BI.pack(0xdb, n)
        else:
            raise ValueError("unicode string is too large")
        out += s
    elif isinstance(o, dict):
        _pack_container_header(len(o), 0x80, 0xde, out)
        for k, v in o.items():
            _pack(k, out, limit - 1)
            _pack(v, out, limit - 1)
    elif isinstance(o, (list, tuple)):
        _pack_container_header(len(o), 0x90, 0xdc, out)
        for v in o:
            _pack(v, out, limit - 1)
    elif isinstance(o, memoryview):
        if not o.c_contiguous:
            raise BufferError(
                "memoryview: underlying buffer is not C-contiguous")
        _pack_bin_header(o.nbytes, out)
        out += o.cast("B") if o.ndim != 1 or o.format != "B" else o
    else:
        raise TypeError(f"can not serialize {_type_name(o)!r} object")


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)``, byte for byte."""
    out = bytearray()
    _pack(obj, out, PACK_NEST_LIMIT)
    return bytes(out)


# ---------------------------------------------------------------------------
# unpacking: one loop over an explicit stack of open containers (no Python
# recursion, so 1024 nested containers unpack as in msgpack's C unpacker)
# ---------------------------------------------------------------------------

_INCOMPLETE = "Unpack failed: incomplete input"

# first byte -> the struct of its value or length, for 0xc4-0xdf
_U8 = struct.Struct(">B")
_U16 = struct.Struct(">H")
_U32 = struct.Struct(">I")
_U64 = struct.Struct(">Q")
_I8 = struct.Struct(">b")
_I16 = struct.Struct(">h")
_I32 = struct.Struct(">i")
_I64 = struct.Struct(">q")
_F32 = struct.Struct(">f")
_F64 = struct.Struct(">d")

_SCALARS = {0xca: _F32, 0xcb: _F64, 0xcc: _U8, 0xcd: _U16, 0xce: _U32,
            0xcf: _U64, 0xd0: _I8, 0xd1: _I16, 0xd2: _I32, 0xd3: _I64}
_BIN = {0xc4: _U8, 0xc5: _U16, 0xc6: _U32}
_STR = {0xd9: _U8, 0xda: _U16, 0xdb: _U32}
_ARRAY = {0xdc: _U16, 0xdd: _U32}
_MAP = {0xde: _U16, 0xdf: _U32}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_EXT = {0xc7: _U8, 0xc8: _U16, 0xc9: _U32}

_NO_KEY = object()


def unpackb(data: Any) -> Any:
    """``msgpack.unpackb(data, raw=False)``: one object, lists for arrays,
    ``str``/``bytes`` map keys only."""
    buf = data if isinstance(data, bytes) else bytes(data)
    n = len(buf)
    pos = 0
    # open containers: [container, items still to read, pending map key]
    stack: list = []
    while True:
        if pos >= n:
            raise ValueError(_INCOMPLETE)
        b = buf[pos]
        pos += 1
        ln = -1       # >= 0: a container of this many items opens
        is_map = False
        if b < 0x80:
            obj = b
        elif b >= 0xe0:
            obj = b - 0x100
        elif b >= 0xa0 and b < 0xc0:
            end = pos + (b & 0x1f)
            if end > n:
                raise ValueError(_INCOMPLETE)
            obj = buf[pos:end].decode("utf-8")
            pos = end
        elif b >= 0x90 and b < 0xa0:
            ln = b & 0x0f
        elif b < 0x90:
            ln = b & 0x0f
            is_map = True
        elif b == 0xc0:
            obj = None
        elif b == 0xc2:
            obj = False
        elif b == 0xc3:
            obj = True
        elif b in _SCALARS:
            s = _SCALARS[b]
            if pos + s.size > n:
                raise ValueError(_INCOMPLETE)
            (obj,) = s.unpack_from(buf, pos)
            pos += s.size
        elif b in _STR or b in _BIN:
            s = _STR.get(b) or _BIN[b]
            if pos + s.size > n:
                raise ValueError(_INCOMPLETE)
            (m,) = s.unpack_from(buf, pos)
            pos += s.size
            end = pos + m
            if end > n:
                raise ValueError(_INCOMPLETE)
            obj = buf[pos:end]
            if b in _STR:
                obj = obj.decode("utf-8")
            pos = end
        elif b in _ARRAY or b in _MAP:
            is_map = b in _MAP
            s = _MAP[b] if is_map else _ARRAY[b]
            if pos + s.size > n:
                raise ValueError(_INCOMPLETE)
            (ln,) = s.unpack_from(buf, pos)
            pos += s.size
        elif b in _FIXEXT or b in _EXT:
            if b in _FIXEXT:
                m = _FIXEXT[b]
            else:
                s = _EXT[b]
                if pos + s.size > n:
                    raise ValueError(_INCOMPLETE)
                (m,) = s.unpack_from(buf, pos)
                pos += s.size
            end = pos + 1 + m
            if end > n:
                raise ValueError(_INCOMPLETE)
            obj = ExtType(_I8.unpack_from(buf, pos)[0], buf[pos + 1:end])
            pos = end
        else:  # 0xc1
            raise FormatError()
        if ln > 0:
            # msgpack's default length limits, checked at the header as
            # msgpack does: no array longer than the input, no map longer
            # than half of it
            if is_map and ln > n // 2:
                raise ValueError(f"{ln} exceeds max_map_len({n // 2})")
            if not is_map and ln > n:
                raise ValueError(f"{ln} exceeds max_array_len({n})")
            if len(stack) >= UNPACK_STACK_LIMIT:
                raise StackError()
            stack.append([{} if is_map else [], ln, _NO_KEY])
            continue
        if ln == 0:
            obj = {} if is_map else []
        # hand the finished object to the open containers, closing each
        # one this completes
        while True:
            if not stack:
                if pos != n:
                    raise ExtraData(obj, buf[pos:])
                return obj
            top = stack[-1]
            cont = top[0]
            if isinstance(cont, list):
                cont.append(obj)
            elif top[2] is _NO_KEY:
                if not isinstance(obj, (str, bytes)):
                    raise ValueError(f"{type(obj).__name__} is not allowed "
                                     f"for map key when strict_map_key=True")
                top[2] = obj
                break
            else:
                cont[top[2]] = obj
                top[2] = _NO_KEY
            top[1] -= 1
            if top[1]:
                break
            stack.pop()
            obj = cont
