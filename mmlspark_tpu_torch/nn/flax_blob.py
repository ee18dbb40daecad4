"""Reader and writer of the flax variables blob, without flax or msgpack.

The JAX package saves a model's variables with `flax.serialization.to_bytes`
and reads them with `from_bytes`. That format is msgpack
(https://github.com/msgpack/msgpack/blob/master/spec.md) of a nested map
with str keys whose leaves are:

- arrays: ext type 1 holding msgpack `(shape, dtype name, C-order bytes)`;
- numpy scalars: ext type 3, the same payload of a 0-d array;
- python scalars, strings, None, bools;
- arrays over MAX_CHUNK_SIZE bytes: a map
  {"__msgpack_chunked_array__": True, "shape": {"0": d0, ...},
   "chunks": {"0": flat chunk, ...}} of flat chunks of at most
  MAX_CHUNK_SIZE bytes each (flax/serialization.py `_chunk`).

This module reads and writes exactly that subset, so ModelBundle files
saved by the JAX package load in the port and the reverse. The writer
picks the smallest encoding of each value as msgpack's packer does, so the
bytes equal flax's for the same tree. numpy has no bfloat16: a bfloat16
leaf reads into a torch.bfloat16 tensor, and one is written back as
"bfloat16".
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

__all__ = ["to_bytes", "from_bytes", "MAX_CHUNK_SIZE"]

MAX_CHUNK_SIZE = 2 ** 30
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


# --------------------------------------------------------------------- #
# writer                                                                #
# --------------------------------------------------------------------- #

def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for limit, code, fmt in ((0xFF, 0xCC, ">B"), (0xFFFF, 0xCD, ">H"),
                                 (0xFFFFFFFF, 0xCE, ">I"), (2 ** 64 - 1, 0xCF, ">Q")):
            if v <= limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"integer {v} does not fit msgpack")
    else:
        for limit, code, fmt in ((-2 ** 7, 0xD0, ">b"), (-2 ** 15, 0xD1, ">h"),
                                 (-2 ** 31, 0xD2, ">i"), (-2 ** 63, 0xD3, ">q")):
            if v >= limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"integer {v} does not fit msgpack")


def _pack_len(out: bytearray, n: int, fix_base: int | None, fix_max: int,
              codes: tuple) -> None:
    if fix_base is not None and n <= fix_max:
        out.append(fix_base | n)
        return
    for limit, code, fmt in zip((0xFF, 0xFFFF, 0xFFFFFFFF), codes, (">B", ">H", ">I")):
        if code is not None and n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise OverflowError(f"length {n} does not fit msgpack")


def _pack_str(out: bytearray, s: str) -> None:
    data = s.encode("utf-8")
    _pack_len(out, len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB))
    out += data


def _pack_bin(out: bytearray, data: bytes) -> None:
    _pack_len(out, len(data), None, 0, (0xC4, 0xC5, 0xC6))
    out += data


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _pack_len(out, len(data), None, 0, (0xC7, 0xC8, 0xC9))
    out.append(code)
    out += data


def _array_payload(arr) -> bytes:
    """msgpack (shape, dtype name, raw bytes) of one array (flax
    `_ndarray_to_bytes`)."""
    if isinstance(arr, torch.Tensor):
        if arr.dtype != torch.bfloat16:
            raise TypeError(f"torch leaves must be bfloat16, got {arr.dtype}")
        t = arr.detach().cpu().contiguous()
        shape, name = tuple(t.shape), "bfloat16"
        raw = t.view(torch.int16).numpy().tobytes()
    else:
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise ValueError("Object and structured dtypes not supported "
                             "for serialization of ndarrays.")
        shape, name, raw = arr.shape, arr.dtype.name, arr.tobytes("C")
    out = bytearray()
    _pack_len(out, 3, 0x90, 15, (None, 0xDC, 0xDD))
    _pack_len(out, len(shape), 0x90, 15, (None, 0xDC, 0xDD))
    for d in shape:
        _pack_int(out, int(d))
    _pack_str(out, name)
    _pack_bin(out, raw)
    return bytes(out)


def _pack(out: bytearray, v: Any) -> None:
    if v is None:
        out.append(0xC0)
    elif v is True:
        out.append(0xC3)
    elif v is False:
        out.append(0xC2)
    elif type(v) is int:
        _pack_int(out, v)
    elif type(v) is float:
        out.append(0xCB)
        out += struct.pack(">d", v)
    elif type(v) is str:
        _pack_str(out, v)
    elif type(v) is bytes:
        _pack_bin(out, v)
    elif type(v) is dict:
        _pack_len(out, len(v), 0x80, 15, (None, 0xDE, 0xDF))
        for key, val in v.items():
            _pack(out, key)
            _pack(out, val)
    elif isinstance(v, (np.ndarray, torch.Tensor)):
        _pack_ext(out, _EXT_NDARRAY, _array_payload(v))
    elif isinstance(v, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _array_payload(np.asarray(v)))
    else:
        raise TypeError(f"cannot serialize {type(v).__name__} in a flax blob")


def _itemsize(arr) -> int:
    return arr.element_size() if isinstance(arr, torch.Tensor) else arr.dtype.itemsize


def _nbytes(arr) -> int:
    return (arr.numel() if isinstance(arr, torch.Tensor) else arr.size) * _itemsize(arr)


def _chunk(arr) -> dict:
    flat = arr.reshape(-1)
    size = max(1, int(MAX_CHUNK_SIZE / _itemsize(arr)))
    chunks = [flat[i:i + size] for i in range(0, flat.shape[0], size)]
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _state_dict(tree: Any) -> Any:
    """flax `to_state_dict` of nested dicts / lists / tuples, with
    oversized arrays chunked."""
    if isinstance(tree, dict):
        return {str(k): _state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    if isinstance(tree, (np.ndarray, torch.Tensor)) and _nbytes(tree) > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def to_bytes(tree: Any) -> bytes:
    """The bytes `flax.serialization.to_bytes(tree)` gives for a tree of
    str-keyed dicts (lists and tuples become "0", "1", ... maps) with
    numpy-array, numpy-scalar and python-scalar leaves."""
    out = bytearray()
    _pack(out, _state_dict(tree))
    return bytes(out)


# --------------------------------------------------------------------- #
# reader                                                                #
# --------------------------------------------------------------------- #

class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw        # strings as bytes (flax's array payloads)

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated flax blob")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def _unpack_fmt(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def _str(self, n: int):
        data = bytes(self._take(n))
        return data if self.raw else data.decode("utf-8")

    def read(self) -> Any:
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self._unpack_fmt(ints[b])
        lengths = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I",   # str
                   0xC4: ">B", 0xC5: ">H", 0xC6: ">I",   # bin
                   0xDC: ">H", 0xDD: ">I",               # array
                   0xDE: ">H", 0xDF: ">I",               # map
                   0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}   # ext
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(fixext[b])
        if b not in lengths:
            raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
        n = self._unpack_fmt(lengths[b])
        if b in (0xD9, 0xDA, 0xDB):
            return self._str(n)
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self._take(n))
        if b in (0xDC, 0xDD):
            return self._array(n)
        if b in (0xDE, 0xDF):
            return self._map(n)
        return self._ext(n)

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _ext(self, n: int) -> Any:
        code = struct.unpack(">b", self._take(1))[0]
        payload = bytes(self._take(n))
        if code == _EXT_NDARRAY:
            return _array_from_payload(payload)
        if code == _EXT_NPSCALAR:
            return _array_from_payload(payload)[()]
        raise ValueError(f"unsupported msgpack ext type {code} in a flax blob")


def _array_from_payload(payload: bytes):
    shape, name, raw = _Reader(payload, raw=True).read()
    name = name.decode() if isinstance(name, bytes) else name
    shape = tuple(shape)
    if name == "bfloat16":
        flat = torch.frombuffer(bytearray(raw), dtype=torch.bfloat16) if raw else \
            torch.empty(0, dtype=torch.bfloat16)
        return flat.reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape, order="C")


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            if isinstance(chunks[0], torch.Tensor):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def from_bytes(data: bytes) -> Any:
    """The state dict `flax.serialization.msgpack_restore(data)` gives:
    nested dicts with numpy-array (or torch bfloat16) leaves."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the flax blob")
    return _unchunk(tree)
