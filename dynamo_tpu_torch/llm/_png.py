"""PNG decoding to RGB pixels, with ``zlib``, ``struct`` and numpy only.

The frontend turns a ``data:image/png;base64,...`` URL into the uint8 HWC
RGB array the engine normalizes (:func:`decode`). The result is the array
``PIL.Image.open(...).convert("RGB")`` gives for the same bytes, bit for
bit: every filter type (None, Sub, Up, Average, Paeth), Adam7 interlacing,
and colour types 0 (grey, at 1, 2, 4 and 8 bits: sub-byte grey scales to
0..255 as PIL's ``L;2``/``L;4`` unpackers do, 1-bit grey is 0 or 255),
2 (RGB), 3 (palette, at 1, 2, 4 and 8 bits), 4 (grey and alpha) and 6
(RGBA). Alpha is dropped, not composited; a ``tRNS`` chunk changes no
pixel. Anything else raises :class:`ProtocolError` naming what it is:
other formats (JPEG, GIF, WebP, ...), 16-bit samples, a palette index
past the ``PLTE`` entries, a bad CRC, truncated data, or more than
:data:`MAX_PIXELS` pixels or :data:`MAX_SIDE` a side.

:func:`encode` writes a plain 8-bit RGB PNG (tests and the card smoke
build image requests with it); :func:`encode_raw` writes any layout
:func:`decode` reads, one chosen filter type a row.

Reference capability: the image decode the reference's frontends delegate
to PIL.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .protocols.openai import ProtocolError

SIGNATURE = b"\x89PNG\r\n\x1a\n"

# Adam7 passes: (x0, y0, dx, dy)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))

# samples per pixel of each colour type, and the bit depths served
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8), 2: (8,), 3: (1, 2, 4, 8), 4: (8,), 6: (8,)}
# sub-byte grey -> 0..255 (PIL's "1", "L;2" and "L;4" unpackers)
_GREY_SCALE = {1: 255, 2: 0x55, 4: 0x11, 8: 1}

# a larger image is refused (a request's IHDR may claim any size). The
# tower sees 896 x 896; 4096 x 4096 keeps 4K screenshots and 12-megapixel
# photos, and the side limit bounds the h + n - 1 steps of the wavefront
# unfilter (PIL itself takes up to 89,478,485 pixels, in C)
MAX_PIXELS = 4096 * 4096
MAX_SIDE = 8192

_MAGIC = ((b"\xff\xd8\xff", "JPEG"), (b"GIF87a", "GIF"), (b"GIF89a", "GIF"),
          (b"BM", "BMP"), (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"),
          (b"\x00\x00\x01\x00", "ICO"), (b"8BPS", "PSD"))


def _sniff(raw: bytes) -> str:
    """The image format ``raw`` starts like ("PNG", "JPEG", ...)."""
    if raw.startswith(SIGNATURE):
        return "PNG"
    if raw[:4] == b"RIFF" and raw[8:12] == b"WEBP":
        return "WebP"
    for magic, name in _MAGIC:
        if raw.startswith(magic):
            return name
    return "unknown"


def _chunks(raw: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(raw):
        n, kind = struct.unpack(">I4s", raw[pos:pos + 8])
        data = raw[pos + 8:pos + 8 + n]
        crc = raw[pos + 8 + n:pos + 12 + n]
        if len(data) != n or len(crc) != 4:
            raise ProtocolError("truncated PNG chunk")
        if zlib.crc32(kind + data) != struct.unpack(">I", crc)[0]:
            raise ProtocolError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, data
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ProtocolError("PNG ends without an IEND chunk")


def _unfilter(data: memoryview, pos: int, h: int, stride: int,
              bpp: int) -> Tuple[np.ndarray, int]:
    """``h`` filtered scanlines of ``stride`` bytes from ``data[pos:]``
    -> (uint8 [h, stride], position after them)."""
    need = h * (stride + 1)
    if pos + need > len(data):
        raise ProtocolError("truncated PNG image data")
    rows = np.frombuffer(data[pos:pos + need], np.uint8).reshape(h, stride + 1)
    ftypes = rows[:, 0]
    if int(ftypes.max()) > 4:
        raise ProtocolError(f"PNG filter type {int(ftypes.max())} is not "
                            f"defined")
    if int(ftypes.max()) >= 3:
        return _unfilter_wavefront(ftypes, rows[:, 1:], bpp), pos + need
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype = int(ftypes[y])
        cur = rows[y, 1:]
        if ftype == 0:
            row = cur.copy()
        elif ftype == 2:
            row = cur + prev
        else:
            # Sub: a running sum along each byte lane of the pixel, mod 256
            row = np.empty(stride, np.uint8)
            for k in range(min(bpp, stride)):
                row[k::bpp] = np.cumsum(cur[k::bpp], dtype=np.uint8)
        out[y] = row
        prev = row
    return out, pos + need


def _unfilter_wavefront(ftypes: np.ndarray, cur: np.ndarray,
                        bpp: int) -> np.ndarray:
    """Any mix of the five filters, Average (3) and Paeth (4) included.

    Pixel (y, x) needs only (y, x-1), (y-1, x) and (y-1, x-1), which lie
    on the two anti-diagonals before its own, so the pixels of one
    anti-diagonal are undone together: h + n - 1 vector steps where a
    byte loop would take h * n * bpp. Both arrays carry a zero row above
    the image and a zero column left of it, so a diagonal and its three
    neighbours are strided slices of the flattened pixels."""
    h, stride = cur.shape
    n = stride // bpp                    # pixels a row (bytes below 8 bits)
    src = np.zeros((h + 1, n + 1, bpp), np.uint8)
    src[1:, 1:] = cur.reshape(h, n, bpp)
    out = np.zeros_like(src)
    src, flat = src.reshape(-1, bpp), out.reshape(-1, bpp)
    ft = ftypes.reshape(h, 1).astype(np.int16)
    paeth_only = bool((ftypes == 4).all())      # most photos' encoding
    zero = np.zeros(1, np.int16)
    for d in range(h + n - 1):
        y0, y1 = max(0, d - n + 1), min(h - 1, d)
        s = y0 * n + n + d + 2           # pixel (y0, d - y0) of the padded
        e = y1 * n + n + d + 3           # one past pixel (y1, d - y1)
        a = flat[s - 1:e - 1:n].astype(np.int16)            # left
        b = flat[s - n - 1:e - n - 1:n].astype(np.int16)    # up
        c = flat[s - n - 2:e - n - 2:n].astype(np.int16)    # up-left
        ac, bc = a - c, b - c
        pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(ac + bc)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        if not paeth_only:
            pred = np.choose(ft[y0:y1 + 1], (zero, a, b, (a + b) >> 1, pred))
        flat[s:e:n] = (src[s:e:n] + pred).astype(np.uint8)
    return out[1:, 1:].reshape(h, stride)


def _samples(rows: np.ndarray, w: int, bits: int, ch: int) -> np.ndarray:
    """Unfiltered scanlines [h, stride] -> samples [h, w, ch]."""
    h = rows.shape[0]
    if bits == 8:
        return rows[:, :w * ch].reshape(h, w, ch)
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)     # MSB first
    s = (rows[:, :, None] >> shifts) & ((1 << bits) - 1)
    return s.reshape(h, -1)[:, :w * ch].reshape(h, w, ch)


def decode(raw: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, 3] RGB, as PIL's ``convert("RGB")``."""
    fmt = _sniff(raw)
    if fmt != "PNG":
        raise ProtocolError(
            f"cannot decode a {fmt} image: this server decodes PNG only; "
            f"send the image as PNG")
    ihdr = None
    palette: Optional[np.ndarray] = None
    idat: List[bytes] = []
    for kind, data in _chunks(raw):
        if kind == b"IHDR":
            if len(data) != 13:
                raise ProtocolError("malformed PNG IHDR chunk")
            ihdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"PLTE":
            if len(data) % 3 or not data:
                raise ProtocolError("malformed PNG PLTE chunk")
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(data)
    if ihdr is None:
        raise ProtocolError("PNG has no IHDR chunk")
    w, h, bits, ctype, comp, filt, interlace = ihdr
    if ctype not in _CHANNELS:
        raise ProtocolError(f"PNG colour type {ctype} is not defined")
    if bits not in _DEPTHS[ctype]:
        raise ProtocolError(
            f"cannot decode a PNG of colour type {ctype} at {bits} bits a "
            f"sample: this server decodes 8-bit PNG (and sub-byte grey or "
            f"palette) only")
    if comp != 0 or filt != 0 or interlace not in (0, 1):
        raise ProtocolError("PNG uses an undefined compression, filter or "
                            "interlace method")
    if w == 0 or h == 0:
        raise ProtocolError("PNG has no pixels")
    if w * h > MAX_PIXELS or max(w, h) > MAX_SIDE:
        raise ProtocolError(f"PNG of {w}x{h} pixels exceeds the limit of "
                            f"{MAX_PIXELS} pixels and {MAX_SIDE} a side")
    if ctype == 3 and palette is None:
        raise ProtocolError("palette PNG has no PLTE chunk")
    ch = _CHANNELS[ctype]
    bpp = max(1, bits * ch // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    geometry = []           # (x0, y0, dx, dy, pass width, height, stride)
    for x0, y0, dx, dy in passes:
        pw = (w - x0 + dx - 1) // dx
        ph = (h - y0 + dy - 1) // dy
        if pw > 0 and ph > 0:   # an empty pass has no bytes at all
            geometry.append((x0, y0, dx, dy, pw, ph,
                             (pw * ch * bits + 7) // 8))
    need = sum(ph * (stride + 1) for *_, ph, stride in geometry)
    try:
        # inflate no more than the image needs (a bomb stops here)
        data = memoryview(zlib.decompressobj().decompress(b"".join(idat),
                                                          need))
    except zlib.error as e:
        raise ProtocolError(f"PNG image data does not inflate: {e}") from e
    if len(data) < need:
        raise ProtocolError("truncated PNG image data")
    samples = np.zeros((h, w, ch), np.uint8)
    pos = 0
    for x0, y0, dx, dy, pw, ph, stride in geometry:
        rows, pos = _unfilter(data, pos, ph, stride, bpp)
        samples[y0::dy, x0::dx] = _samples(rows, pw, bits, ch)
    if ctype == 3:
        if int(samples.max()) >= len(palette):
            raise ProtocolError(
                f"palette PNG indexes entry {int(samples.max())} of a "
                f"{len(palette)}-entry PLTE")
        return palette[samples[:, :, 0]]
    if ctype in (0, 4):
        g = samples[:, :, 0] * np.uint8(_GREY_SCALE[bits])
        return np.repeat(g[:, :, None], 3, axis=2)
    return np.ascontiguousarray(samples[:, :, :3])


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def _filter_row(ftype: int, row: np.ndarray, prev: np.ndarray,
                bpp: int) -> np.ndarray:
    r = row.astype(np.int32)
    b = prev.astype(np.int32)
    a = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]])[:len(r)]
    c = np.concatenate([np.zeros(bpp, np.int32), b[:-bpp]])[:len(r)]
    if ftype == 0:
        pred = np.zeros_like(r)
    elif ftype == 1:
        pred = a
    elif ftype == 2:
        pred = b
    elif ftype == 3:
        pred = (a + b) >> 1
    else:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return ((r - pred) & 0xFF).astype(np.uint8)


def _pack(samples: np.ndarray, bits: int) -> np.ndarray:
    """samples [h, w, ch] -> scanline bytes [h, stride]."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1).astype(np.uint8)
    if bits == 8:
        return flat
    per = 8 // bits
    n = flat.shape[1]
    padded = np.zeros((h, -(-n // per) * per), np.uint8)
    padded[:, :n] = flat
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    return (padded.reshape(h, -1, per) << shifts).sum(
        axis=2, dtype=np.uint16).astype(np.uint8)


def encode_raw(samples: np.ndarray, color_type: int, bits: int = 8,
               palette: Optional[np.ndarray] = None,
               interlace: bool = False,
               filters: Sequence[int] = (0,),
               trns: Optional[bytes] = None) -> bytes:
    """PNG bytes of ``samples`` ([H, W, channels] uint8 sample values at
    ``bits`` each) as ``color_type``; scanline ``i`` of each pass takes
    filter ``filters[i % len(filters)]``."""
    h, w = samples.shape[:2]
    ch = _CHANNELS[color_type]
    samples = samples.reshape(h, w, ch)
    bpp = max(1, bits * ch // 8)
    out = bytearray()
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.shape[0] == 0 or sub.shape[1] == 0:
            continue
        rows = _pack(sub, bits)
        prev = np.zeros(rows.shape[1], np.uint8)
        for i, row in enumerate(rows):
            ftype = int(filters[i % len(filters)])
            out.append(ftype)
            out += _filter_row(ftype, row, prev, bpp).tobytes()
            prev = row
    body = [_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bits, color_type,
                                        0, 0, int(interlace)))]
    if palette is not None:
        body.append(_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    if trns is not None:
        body.append(_chunk(b"tRNS", trns))
    body.append(_chunk(b"IDAT", zlib.compress(bytes(out))))
    body.append(_chunk(b"IEND", b""))
    return SIGNATURE + b"".join(body)


def encode(rgb: np.ndarray) -> bytes:
    """uint8 [H, W, 3] -> an 8-bit RGB PNG, filter Paeth on every row
    (the filter an encoder's adaptive choice mostly takes on photos)."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode takes uint8 [H, W, 3], got {rgb.dtype} "
                         f"{rgb.shape}")
    return encode_raw(rgb, 2, filters=(4,))
