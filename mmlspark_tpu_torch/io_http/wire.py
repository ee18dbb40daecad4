"""Length-prefixed zero-copy binary row protocol — the shared wire codec
for the serving hot path and the streaming fleet-worker shuffle.

A copy of mmlspark_tpu/io_http/wire.py.

A frame carries one table: a small JSON meta blob plus N dtype-tagged
column blocks whose payloads are raw little-endian array bytes, so the
receiving side decodes each column with a single ``np.frombuffer`` (no
per-value parse, no intermediate lists).  Layout (all integers
little-endian):

    offset  size       field
    0       4          magic  b"MSWR"
    4       1          version (currently 1)
    5       1          flags (reserved, 0)
    6       2          u16  column count
    8       4          u32  row count
    12      4          u32  meta length
    16      meta       UTF-8 JSON meta blob
    ...     per column:
              u16      name length
              name     UTF-8 column name
              u8       dtype tag (see _DTYPE_TAGS)
              u8       ndim
              ndim*u32 shape (dim 0 == row count)
              u32      payload byte length
              payload  raw C-order little-endian array bytes

Columns with non-numeric dtypes (object / str / lists) ride in
``meta["json_columns"]`` using the same ``{"dtype": ..., "values": ...}``
shape as the streaming JSON columnar encoding, so any table the JSON
path can carry, the binary path can too.

Version negotiation: a decoder rejects frames whose major version it
does not know (`WireError`); servers answer such requests 415 and the
client falls back to JSON.  The codec is deliberately self-contained
(numpy + stdlib only) so both ends of every wire can import it.
"""
from __future__ import annotations

import json
import struct
from typing import Any

import numpy as np

WIRE_CONTENT_TYPE = "application/x-mmlspark-rows"
WIRE_MAGIC = b"MSWR"
WIRE_VERSION = 1

_HEADER = struct.Struct("<4sBBHII")  # magic, version, flags, ncols, nrows, meta_len

# fixed-width dtypes that travel as raw bytes; everything else falls back
# to the JSON columnar encoding inside the meta blob
_DTYPE_TAGS: "dict[str, int]" = {
    "float64": 1, "float32": 2,
    "int64": 3, "int32": 4, "int16": 5, "int8": 6,
    "uint64": 7, "uint32": 8, "uint16": 9, "uint8": 10,
    "bool": 11,
}
_TAG_DTYPES = {v: np.dtype(k) for k, v in _DTYPE_TAGS.items()}


class WireError(ValueError):
    """Malformed or version-incompatible binary frame."""


def _binary_dtype(col: Any) -> "np.dtype | None":
    if not isinstance(col, np.ndarray):
        return None
    name = col.dtype.name
    if name not in _DTYPE_TAGS:
        return None
    return col.dtype


def encode_message(meta: "dict[str, Any]", cols: "dict[str, Any]",
                   n_rows: "int | None" = None) -> bytes:
    """One table -> one frame. Numeric ndarray columns become raw byte
    blocks; anything else (lists, object arrays) is folded into
    ``meta["json_columns"]`` with the JSON columnar shape."""
    meta = dict(meta)
    blocks: "list[bytes]" = []
    json_cols: "dict[str, Any]" = dict(meta.get("json_columns") or {})
    rows = n_rows
    for name, col in cols.items():
        dt = _binary_dtype(col)
        if dt is None:
            if isinstance(col, np.ndarray):
                json_cols[name] = {"dtype": str(col.dtype),
                                   "values": col.tolist()}
                n = col.shape[0] if col.ndim else 1
            else:
                json_cols[name] = {"dtype": "list", "values": list(col)}
                n = len(json_cols[name]["values"])
        else:
            arr = np.ascontiguousarray(col)
            if arr.dtype.byteorder == ">":  # big-endian host arrays
                arr = arr.astype(arr.dtype.newbyteorder("<"))
            payload = arr.tobytes()
            nm = name.encode("utf-8")
            head = struct.pack("<H", len(nm)) + nm
            head += struct.pack("<BB", _DTYPE_TAGS[dt.name], arr.ndim)
            head += struct.pack(f"<{arr.ndim}I", *arr.shape)
            head += struct.pack("<I", len(payload))
            blocks.append(head + payload)
            n = arr.shape[0] if arr.ndim else 1
        if rows is None:
            rows = n
    if json_cols:
        meta["json_columns"] = json_cols
    meta_b = json.dumps(meta).encode("utf-8")
    header = _HEADER.pack(WIRE_MAGIC, WIRE_VERSION, 0, len(blocks),
                          int(rows or 0), len(meta_b))
    return b"".join([header, meta_b, *blocks])


def decode_message(buf: "bytes | bytearray | memoryview"
                   ) -> "tuple[dict[str, Any], dict[str, np.ndarray]]":
    """One frame -> (meta, columns). Numeric columns are zero-copy
    ``np.frombuffer`` views over the frame buffer (read-only — copy
    before mutating); JSON-columnar entries in ``meta["json_columns"]``
    are materialized alongside them."""
    view = memoryview(buf)
    if len(view) < _HEADER.size:
        raise WireError(f"frame too short ({len(view)} bytes)")
    magic, version, _flags, ncols, nrows, meta_len = _HEADER.unpack_from(view)
    if magic != WIRE_MAGIC:
        raise WireError(f"bad magic {magic!r}")
    if version != WIRE_VERSION:
        raise WireError(f"unsupported wire version {version} "
                        f"(this codec speaks {WIRE_VERSION})")
    off = _HEADER.size
    if off + meta_len > len(view):
        raise WireError("truncated meta blob")
    try:
        meta = json.loads(bytes(view[off:off + meta_len]).decode("utf-8"))
    except Exception as e:  # noqa: BLE001 — any parse failure is a bad frame
        raise WireError(f"bad meta blob: {e}") from e
    off += meta_len
    cols: "dict[str, np.ndarray]" = {}
    for _ in range(ncols):
        try:
            (name_len,) = struct.unpack_from("<H", view, off)
            off += 2
            name = bytes(view[off:off + name_len]).decode("utf-8")
            off += name_len
            tag, ndim = struct.unpack_from("<BB", view, off)
            off += 2
            shape = struct.unpack_from(f"<{ndim}I", view, off)
            off += 4 * ndim
            (nbytes,) = struct.unpack_from("<I", view, off)
            off += 4
        except struct.error as e:
            raise WireError(f"truncated column header: {e}") from e
        dt = _TAG_DTYPES.get(tag)
        if dt is None:
            raise WireError(f"unknown dtype tag {tag}")
        count = int(np.prod(shape, dtype=np.int64)) if ndim else 1
        if nbytes != count * dt.itemsize or off + nbytes > len(view):
            raise WireError(f"column {name!r}: payload size mismatch")
        arr = np.frombuffer(view, dtype=dt, count=count,
                            offset=off).reshape(shape)
        off += nbytes
        if ndim and shape[0] != nrows:
            raise WireError(
                f"column {name!r}: dim 0 is {shape[0]}, frame says {nrows}")
        cols[name] = arr
    for name, doc in (meta.get("json_columns") or {}).items():
        dtype, values = doc["dtype"], doc["values"]
        cols[name] = (list(values) if dtype == "list"
                      else np.array(values, dtype=dtype))
    return meta, cols


def is_wire_content_type(content_type: "str | None") -> bool:
    """True when an HTTP Content-Type / Accept value names the binary
    row protocol (parameters after ';' ignored)."""
    if not content_type:
        return False
    return content_type.split(";", 1)[0].strip().lower() == WIRE_CONTENT_TYPE


def accepts_wire(headers: "dict | None") -> bool:
    """True when a request's Accept header asks for binary replies."""
    if not headers:
        return False
    for k, v in headers.items():
        if k.lower() == "accept":
            return any(is_wire_content_type(part)
                       for part in str(v).split(","))
    return False


def content_type_of(headers: "dict | None") -> "str | None":
    if not headers:
        return None
    for k, v in headers.items():
        if k.lower() == "content-type":
            return v
    return None


def encode_features_request(values: "np.ndarray") -> bytes:
    """Client-side helper: one scoring request's feature row(s) as a
    frame with the single ``features`` column (f64, shape (n, F))."""
    feats = np.asarray(values, np.float64)
    if feats.ndim == 1:
        feats = feats[None, :]
    return encode_message({}, {"features": feats})


def decode_features_request(entity: bytes, n_features: int) -> np.ndarray:
    """Server-side inverse of encode_features_request: (n, F) f64 matrix.
    Raises WireError when the frame lacks a conforming features block."""
    _meta, cols = decode_message(entity)
    feats = cols.get("features")
    if not isinstance(feats, np.ndarray):
        raise WireError("frame has no 'features' column")
    if feats.ndim == 1:
        feats = feats[None, :]
    if feats.ndim != 2 or feats.shape[1] != n_features:
        raise WireError(f"features shape {feats.shape} != (n, {n_features})")
    return np.ascontiguousarray(feats, np.float64)


def encode_reply(value_col: str, value: Any) -> bytes:
    """One scoring reply as a frame: a single-row f64 column named after
    the output column (vector outputs ride as shape (1, K))."""
    arr = np.asarray(value, np.float64)
    arr = arr[None] if arr.ndim in (0, 1) else arr
    return encode_message({"value_col": value_col}, {value_col: arr})


def decode_reply(entity: bytes) -> "tuple[str, np.ndarray]":
    """(value_col, values) from a binary reply frame."""
    meta, cols = decode_message(entity)
    col = meta.get("value_col")
    if col is None or col not in cols:
        raise WireError("reply frame missing value column")
    return col, np.asarray(cols[col])
