"""Tabular ingestion/egress for `Table` — csv, parquet, pandas.

A copy of mmlspark_tpu/core/table_io.py; `DeviceTable` holds torch tensors
on the table's device where the reference holds jax arrays.

The reference reads its benchmark datasets through Spark's JVM readers
(`spark.read.csv` in every sample notebook; `DatasetUtils`,
core/test/benchmarks/.../Benchmarks.scala:114-125). Here ingestion is
framework-native:

- `read_csv`: a multithreaded C++ cell parser (native/kernels.cpp
  `mmlspark_csv_parse`) does the numeric heavy lifting; columns where any
  cell fails numeric parse come back as string columns. Quoted files route
  to the csv-module slow path (full quoting semantics, correctness first).
  Pure-Python fallback when no toolchain is available.
- `read_parquet`/`write_parquet`: pyarrow, gated (clear error if absent).
- `from_pandas`/`to_pandas`: direct column interop.

Paths go through `utils.storage`, so file:// and remote schemes work
anywhere a local path does.
"""

from __future__ import annotations

import io as _io
from typing import Sequence

import numpy as np
import torch

from ..utils import storage
from .schema import Table

__all__ = [
    "read_csv",
    "write_csv",
    "read_parquet",
    "write_parquet",
    "from_pandas",
    "to_pandas",
    "DeviceTable",
    "device_column",
]

# jax's dtype canonicalisation with x64 off: what `jnp.asarray` and
# `jax.device_put` make of a host array in the reference
_X64_OFF = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
            np.dtype(np.uint64): np.uint32, np.dtype(np.complex128): np.complex64}


def device_column(arr, device: "str | torch.device") -> torch.Tensor:
    """One host array on `device` as a tensor, in the dtype the reference's
    upload gives it: float64 as float32, int64 as int32, uint64 as uint32,
    complex128 as complex64; every other dtype as it is."""
    arr = np.asarray(arr)
    arr = arr.astype(_X64_OFF.get(arr.dtype, arr.dtype), copy=False)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


class DeviceTable:
    """A lightweight dict of DEVICE-resident columns.

    The device-side counterpart of `Table` that the pipeline fusion engine
    (`core/fusion.py`) runs on: columns live as tensors between fused
    stage boundaries, so a fused
    run pays one upload at entry and one read-back at exit instead of a
    host round-trip per stage.  Only the pieces fusion needs — no metadata,
    no list columns, no mutation: derive new tables with `with_columns`.
    """

    __slots__ = ("_cols",)

    def __init__(self, cols: dict):
        self._cols = dict(cols)

    @classmethod
    def from_host(cls, cols: dict, shardings: "dict | None" = None,
                  device: str = "cuda") -> "DeviceTable":
        """Upload host ndarrays (one copy per column) to `device` with jax's
        x64-off dtypes (`device_column`): float64 uploads as float32, int64
        as int32. Asking for "cuda" without a card raises RuntimeError.

        `shardings` maps columns to a mesh (parallel/mesh.py), the port's
        form of the reference's per-column `P(data)` placements: a listed
        column uploads only this rank's block of rows on the mesh's data
        axis (`shard_bounds`; the rows must divide by the axis, as a
        fused chunk's rung does), an unlisted one uploads whole."""
        from .kernels import resolve_device

        dev = resolve_device(device)
        if shardings:
            from ..parallel.mesh import DATA_AXIS, shard_bounds

            blocks = {}
            for name, arr in cols.items():
                mesh = shardings.get(name)
                if mesh is not None:
                    data = mesh.axis(DATA_AXIS)
                    n_pad, lo, hi = shard_bounds(len(arr), data)
                    if n_pad != len(arr):
                        raise ValueError(f"column {name!r}: {len(arr)} rows do not split "
                                         f"over a data axis of {data.size}")
                    arr = arr[lo:hi]
                blocks[name] = arr
            cols = blocks
        return cls({name: device_column(arr, dev) for name, arr in cols.items()})

    @property
    def columns(self) -> list:
        return list(self._cols)

    def __getitem__(self, name: str):
        return self._cols[name]

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def __len__(self) -> int:
        return len(self._cols)

    def with_columns(self, cols: dict) -> "DeviceTable":
        merged = dict(self._cols)
        merged.update(cols)
        return DeviceTable(merged)

    def to_host(self) -> dict:
        """Materialize every column back to host ndarrays (one read-back
        per column)."""
        return {name: arr.detach().cpu().numpy() for name, arr in self._cols.items()}


def read_csv(
    path: str,
    header: bool = True,
    delimiter: str = ",",
    column_names: Sequence[str] | None = None,
    encoding: str = "utf-8",
) -> Table:
    """Read a CSV file into a Table (numeric columns as float64 arrays,
    text columns as python-string lists)."""
    data = storage.read_bytes(path)
    return _parse_csv_bytes(data, header, delimiter, column_names, encoding)


_FAST_PATH_ENCODINGS = {"utf-8", "ascii", "iso8859-1", "cp1252"}


def _parse_csv_bytes(data, header, delimiter, column_names, encoding) -> Table:
    import codecs

    if len(delimiter) != 1:
        raise ValueError(f"delimiter must be one character, got {delimiter!r}")
    if not data.strip():
        return Table({})
    enc_name = codecs.lookup(encoding).name
    if b'"' in data or enc_name not in _FAST_PATH_ENCODINGS or ord(delimiter) > 127:
        # quoted cells (embedded delimiters/newlines), a non-ASCII-
        # compatible encoding (utf-16 etc, where byte-level newline
        # indexing is wrong), or a non-ASCII delimiter (the C parser splits
        # on a single byte; a multi-byte UTF-8 delimiter would split rows on
        # its first byte only): full csv-module semantics
        return _read_csv_slow(data, header, delimiter, column_names, encoding)

    if not data.endswith(b"\n"):
        data += b"\n"
    buf = np.frombuffer(data, np.uint8)
    row_starts = np.flatnonzero(buf == ord("\n")) + 1
    offsets = np.concatenate([[0], row_starts]).astype(np.int64)
    # drop blank rows anywhere: bare "\n" (len 1) and bare "\r\n" (len 2)
    lens = np.diff(offsets)
    blank = (lens == 1) | ((lens == 2) & (buf[offsets[:-1]] == ord("\r")))
    offsets = np.concatenate([offsets[:-1][~blank], offsets[-1:]])

    first_line = data[offsets[0]:offsets[1]].decode(encoding).rstrip("\r\n")
    cols_in_file = first_line.split(delimiter)
    n_cols = len(cols_in_file)
    if header:
        names = column_names or [c.strip() for c in cols_in_file]
        offsets = offsets[1:]
    else:
        names = list(column_names or [f"c{i}" for i in range(n_cols)])
    if len(names) != n_cols:
        raise ValueError(f"{len(names)} names for {n_cols} columns")
    n_rows = len(offsets) - 1
    if n_rows <= 0:
        return Table({n: np.asarray([], np.float64) for n in names})

    from .. import native

    parsed = native.csv_parse(data, offsets, n_cols, delimiter)
    if parsed is None:
        return _read_csv_slow(data, header, delimiter, column_names, encoding)
    values, ok = parsed

    cols: dict[str, object] = {}
    text_cols = [j for j in range(n_cols) if not ok[:, j].all()]
    text_data: dict[int, list[str]] = {j: [] for j in text_cols}
    if text_cols:
        # decode only the columns that failed numeric parse, slicing by the
        # SAME row offsets the C parser used (splitlines would desync on
        # interior blank rows, which the offsets filter dropped)
        for i in range(n_rows):
            line = data[offsets[i]:offsets[i + 1]].decode(encoding)
            parts = line.rstrip("\r\n").split(delimiter)
            for j in text_cols:
                cell = parts[j].strip() if j < len(parts) else ""
                text_data[j].append(cell)
    for j, name in enumerate(names):
        cols[name] = text_data[j] if j in text_cols else values[:, j]
    return Table(cols)


def _read_csv_slow(data, header, delimiter, column_names, encoding) -> Table:
    """csv-module path: full quoting semantics / no-toolchain fallback."""
    import csv

    rows = list(csv.reader(_io.StringIO(data.decode(encoding)),
                           delimiter=delimiter))
    rows = [r for r in rows if r]
    if not rows:
        return Table({})
    if header:
        names = column_names or [c.strip() for c in rows[0]]
        rows = rows[1:]
    else:
        names = list(column_names or [f"c{i}" for i in range(len(rows[0]))])
    cols: dict[str, object] = {}
    for j, name in enumerate(names):
        raw = [(r[j].strip() if j < len(r) else "") for r in rows]
        numeric: list[float] = []
        is_num = True
        for cell in raw:
            if cell == "":
                numeric.append(float("nan"))
                continue
            if "_" in cell or not cell.isascii():
                # Python float() accepts "1_000" and non-ASCII Unicode
                # digits ("١٢٣") but the native path's strtod does not;
                # treat both as text so the schema is path-independent
                # (hex is already aligned via looks_hex in kernels.cpp)
                is_num = False
                break
            try:
                numeric.append(float(cell))
            except ValueError:
                is_num = False
                break
        cols[name] = np.asarray(numeric, np.float64) if is_num else raw
    return Table(cols)


def write_csv(table: Table, path: str, delimiter: str = ",",
              header: bool = True, encoding: str = "utf-8") -> None:
    import csv

    buf = _io.StringIO()
    w = csv.writer(buf, delimiter=delimiter, lineterminator="\n")
    names = table.columns
    if header:
        w.writerow(names)
    cols = [table[n] for n in names]
    for i in range(len(table)):
        w.writerow([c[i] for c in cols])
    storage.write_bytes(path, buf.getvalue().encode(encoding))


def _require_pyarrow():
    try:
        import pyarrow  # noqa: F401
        import pyarrow.parquet  # noqa: F401

        return pyarrow
    except ImportError as e:  # pragma: no cover - environment-dependent
        raise ImportError(
            "parquet support needs pyarrow; install it or use read_csv"
        ) from e


def read_parquet(path: str) -> Table:
    pa = _require_pyarrow()
    import pyarrow.parquet as pq

    with storage.open_read(path) as fh:
        tbl = pq.read_table(pa.BufferReader(fh.read()))
    import pyarrow.types as pat

    cols: dict[str, object] = {}
    for name in tbl.column_names:
        ca = tbl[name].combine_chunks()
        t = ca.type
        if pat.is_fixed_size_list(t):
            # vector column written by write_parquet: restore (n, d)
            flat = ca.flatten().to_numpy(zero_copy_only=False)
            cols[name] = flat.reshape(len(ca), t.list_size)
        elif pat.is_floating(t):
            cols[name] = ca.to_numpy(zero_copy_only=False)
        elif pat.is_integer(t) or pat.is_boolean(t):
            if ca.null_count:
                # nullable ints have no numpy dtype: floats + NaN (documented
                # lossy past 2^53); null-free ints keep their exact dtype
                cols[name] = ca.cast(pa.float64()).to_numpy(
                    zero_copy_only=False)
            else:
                cols[name] = ca.to_numpy(zero_copy_only=False)
        else:
            cols[name] = ca.to_pylist()
    return Table(cols)


def write_parquet(table: Table, path: str) -> None:
    pa = _require_pyarrow()
    import pyarrow.parquet as pq

    arrays, names = [], []
    for name in table.columns:
        col = table[name]
        names.append(name)
        if isinstance(col, np.ndarray) and col.ndim == 2:
            # vector column: FixedSizeList keeps the row width in the
            # schema so read_parquet can restore the (n, d) ndarray
            flat = pa.array(np.ascontiguousarray(col).reshape(-1))
            arrays.append(pa.FixedSizeListArray.from_arrays(
                flat, col.shape[1]))
        elif isinstance(col, np.ndarray):
            arrays.append(pa.array(col))
        else:
            arrays.append(pa.array(list(col)))
    sink = pa.BufferOutputStream()
    pq.write_table(pa.table(dict(zip(names, arrays))), sink)
    storage.write_bytes(path, sink.getvalue().to_pybytes())


def from_pandas(df) -> Table:
    """pandas.DataFrame -> Table (float columns as float64 arrays, the rest
    as python lists)."""
    cols: dict[str, object] = {}
    for name in df.columns:
        s = df[name]
        if s.dtype.kind in "fiub":
            cols[str(name)] = s.to_numpy(np.float64, na_value=np.nan) \
                if s.dtype.kind == "f" else s.to_numpy()
        else:
            cols[str(name)] = s.tolist()
    return Table(cols)


def to_pandas(table: Table):
    import pandas as pd

    cols: dict[str, object] = {}
    for n in table.columns:
        col = table[n]
        if isinstance(col, np.ndarray) and col.ndim > 1:
            # pandas columns are 1-D: vector/matrix columns (probability,
            # features, ...) become object columns of per-row lists
            cols[n] = col.tolist()
        elif isinstance(col, np.ndarray):
            cols[n] = col
        else:
            cols[n] = list(col)
    return pd.DataFrame(cols)
