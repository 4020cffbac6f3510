"""The safetensors format without the ``safetensors`` library.

A file is an 8-byte little-endian header length N, N bytes of JSON (name ->
``{"dtype", "shape", "data_offsets": [begin, end]}`` relative to the end of
the header; ``__metadata__`` is free-form and ignored), then the raw
little-endian buffers.

:class:`SafetensorsFile` maps the file and hands out zero-copy views
(:class:`ShardSet` does so across a directory's shards):
:meth:`~SafetensorsFile.get_numpy` as numpy (BF16 as its ``uint16`` bits,
numpy having no bf16) and :meth:`~SafetensorsFile.get_tensor` as a CPU
torch tensor (BF16 viewed as ``torch.bfloat16``). The mapping is
copy-on-write, so the views are writable for torch and the file is never
modified. :meth:`~SafetensorsFile.raw` says where a tensor's bytes lie,
for a loader that reads them straight into its own staging buffers
(``engine/loader.py``). :func:`save_file` writes numpy arrays or torch tensors, one
buffer after another straight to the file.
"""

from __future__ import annotations

import json
import math
import mmap
import os
import struct
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

# safetensors dtype -> (numpy dtype of the stored bits, torch dtype)
_DTYPES: Dict[str, Tuple[np.dtype, torch.dtype]] = {
    "F64": (np.dtype("<f8"), torch.float64),
    "F32": (np.dtype("<f4"), torch.float32),
    "F16": (np.dtype("<f2"), torch.float16),
    "BF16": (np.dtype("<u2"), torch.bfloat16),
    "I64": (np.dtype("<i8"), torch.int64),
    "I32": (np.dtype("<i4"), torch.int32),
    "I16": (np.dtype("<i2"), torch.int16),
    "I8": (np.dtype("i1"), torch.int8),
    "U8": (np.dtype("u1"), torch.uint8),
    "BOOL": (np.dtype("?"), torch.bool),
}
_TORCH_NAMES = {t: name for name, (_, t) in _DTYPES.items()}
_NUMPY_NAMES = {np.dtype("<f8"): "F64", np.dtype("<f4"): "F32",
                np.dtype("<f2"): "F16", np.dtype("<i8"): "I64",
                np.dtype("<i4"): "I32", np.dtype("<i2"): "I16",
                np.dtype("i1"): "I8", np.dtype("u1"): "U8",
                np.dtype("?"): "BOOL"}


class SafetensorsFile:
    """One ``*.safetensors`` file, memory-mapped."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            head = f.read(8)
            if len(head) < 8:
                raise ValueError(f"{path}: not a safetensors file")
            (n,) = struct.unpack("<Q", head)
            size = os.fstat(f.fileno()).st_size
            if n > size - 8:
                raise ValueError(f"{path}: header length {n} exceeds the "
                                 f"file ({size} bytes)")
            header = json.loads(f.read(n))
            self._mm = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
                        if size else None)
        header.pop("__metadata__", None)
        self._start = 8 + n
        self._info: Dict[str, Dict[str, Any]] = {}
        for name, info in header.items():
            if info["dtype"] not in _DTYPES:
                raise NotImplementedError(
                    f"{path}: tensor {name!r} has dtype {info['dtype']}, "
                    f"which the port does not read")
            begin, end = info["data_offsets"]
            itemsize = _DTYPES[info["dtype"]][0].itemsize
            count = int(np.prod(info["shape"], dtype=np.int64))
            if end - begin != count * itemsize or \
                    self._start + end > size:
                raise ValueError(f"{path}: tensor {name!r} has offsets "
                                 f"{begin}..{end} for {count} x {itemsize} "
                                 f"bytes")
            self._info[name] = info

    def keys(self) -> List[str]:
        return list(self._info)

    def nbytes(self, name: str) -> int:
        begin, end = self._info[name]["data_offsets"]
        return end - begin

    def get_numpy(self, name: str) -> np.ndarray:
        """A zero-copy numpy view; BF16 comes back as ``uint16`` bits."""
        info = self._info[name]
        np_dt = _DTYPES[info["dtype"]][0]
        begin, end = info["data_offsets"]
        count = (end - begin) // np_dt.itemsize
        if count == 0:
            return np.zeros(info["shape"], np_dt)
        return np.frombuffer(self._mm, dtype=np_dt, count=count,
                             offset=self._start + begin).reshape(
            info["shape"])

    def get_tensor(self, name: str) -> torch.Tensor:
        """A zero-copy CPU tensor in the stored dtype."""
        info = self._info[name]
        arr = self.get_numpy(name)
        t = torch.from_numpy(arr)
        if info["dtype"] == "BF16":
            t = t.view(torch.bfloat16)
        return t

    def raw(self, name: str) -> "RawTensor":
        """Where the tensor's bytes lie in the file, for reading them
        straight into a staging buffer (no mapping, no host copy)."""
        info = self._info[name]
        return RawTensor(self.path, self._start + info["data_offsets"][0],
                         _DTYPES[info["dtype"]][1], tuple(info["shape"]))

    def close(self) -> None:
        # views handed out keep the mapping alive until they are freed
        self._mm = None


@dataclass(frozen=True)
class RawTensor:
    """A row-major little-endian tensor stored at ``offset`` in ``path``."""

    path: str
    offset: int
    dtype: torch.dtype
    shape: Tuple[int, ...]

    def numel(self) -> int:
        return math.prod(self.shape)

    def element_size(self) -> int:
        return self.dtype.itemsize

    def read(self, f, start: int, out: torch.Tensor) -> None:
        """Fill the uint8 tensor ``out`` with the bytes at ``start`` of the
        tensor's data, from the open binary file ``f``."""
        view = memoryview(out.numpy())
        done = 0
        while done < len(view):
            n = os.preadv(f.fileno(), [view[done:]],
                          self.offset + start + done)
            if n <= 0:
                raise ValueError(f"{self.path}: short read at "
                                 f"{self.offset + start + done}")
            done += n


class ShardSet:
    """Every ``*.safetensors`` shard of a directory: tensor name -> file."""

    def __init__(self, path: str):
        import glob

        files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
        if not files:
            raise FileNotFoundError(f"no *.safetensors in {path}")
        self.files = [SafetensorsFile(fn) for fn in files]
        self._where: Dict[str, SafetensorsFile] = {}
        for f in self.files:
            for name in f.keys():
                self._where[name] = f

    def keys(self) -> List[str]:
        return list(self._where)

    def raw(self, name: str) -> RawTensor:
        return self._where[name].raw(name)

    def close(self) -> None:
        for f in self.files:
            f.close()


def _describe(name: str, value: Union[np.ndarray, torch.Tensor]
              ) -> Tuple[str, List[int], int]:
    """(safetensors dtype, shape, byte size) of one value to write."""
    if isinstance(value, torch.Tensor):
        if value.dtype not in _TORCH_NAMES:
            raise TypeError(f"{name}: unsupported tensor dtype {value.dtype}")
        return (_TORCH_NAMES[value.dtype], list(value.shape),
                value.numel() * value.element_size())
    a = np.asarray(value)
    if a.dtype.name == "bfloat16":         # an ml_dtypes array
        return "BF16", list(a.shape), a.nbytes
    dt = _NUMPY_NAMES.get(a.dtype.newbyteorder("<")
                          if a.dtype.byteorder == ">" else a.dtype)
    if dt is None:
        raise TypeError(f"{name}: unsupported array dtype {a.dtype}")
    return dt, list(a.shape), a.nbytes


def _row_major_bytes(value: Union[np.ndarray, torch.Tensor]) -> memoryview:
    """The value's bytes in row-major order, little-endian. A
    non-contiguous input (a transposed view, say) is copied first: writing
    its underlying buffer as is would silently drop the transpose."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.view(torch.int16)
        arr = t.numpy()
    else:
        arr = np.ascontiguousarray(value)
        if arr.dtype.name == "bfloat16":
            arr = arr.view(np.uint16)
        elif arr.dtype.byteorder == ">":
            arr = arr.astype(arr.dtype.newbyteorder("<"))
    return memoryview(arr.reshape(-1).view(np.uint8))


def save_file(tensors: Mapping[str, Union[np.ndarray, torch.Tensor]],
              path: str, metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` to ``path`` in the safetensors format: buffers in
    name order, each streamed to the file (no whole-file copy in memory),
    the header padded to 8 bytes as the library pads it."""
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    off = 0
    order = sorted(tensors)
    for name in order:
        dt, shape, nbytes = _describe(name, tensors[name])
        header[name] = {"dtype": dt, "shape": shape,
                        "data_offsets": [off, off + nbytes]}
        off += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in order:
            buf = _row_major_bytes(tensors[name])
            begin, end = header[name]["data_offsets"]
            if len(buf) != end - begin:
                raise AssertionError(f"{name}: {len(buf)} bytes for "
                                     f"{end - begin}")
            f.write(buf)
    os.replace(tmp, path)
