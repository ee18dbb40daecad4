"""The port's tabular ingest (mmlspark_tpu_torch.core.table_io and the native
CSV parser) against the JAX package's, on the CPU: every case of
tests/test_table_io.py through both packages' `read_csv` on the same bytes
gives equal Tables (numbers bit for bit, NaN in the same places, equal
strings), `write_csv` writes the same bytes, both `csv_parse`s give the same
bits, and `DeviceTable` uploads with the dtypes `jnp.asarray` gives."""

import os
import shutil
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import mmlspark_tpu.native as ref_native  # noqa: E402
from mmlspark_tpu.core import table_io as ref_io  # noqa: E402
from mmlspark_tpu.core.schema import Table as RefTable  # noqa: E402
from mmlspark_tpu.utils import datagen as ref_datagen  # noqa: E402
from mmlspark_tpu_torch import native  # noqa: E402
from mmlspark_tpu_torch.core import DeviceTable, Table, table_io  # noqa: E402
from mmlspark_tpu_torch.utils import datagen  # noqa: E402
from test_torch_tabular_common import assert_same_table  # noqa: E402


CSV = (
    "age,income,city,score\n"
    "25,50000,Seattle,1.5\n"
    "31,,Boston,2.25\n"
    "47,82000,New York,-3.5\n"
)


def _big_numeric():
    x = np.random.default_rng(0).normal(size=(5000, 6))
    body = "\n".join(",".join(f"{v:.10g}" for v in row) for row in x)
    return ("a,b,c,d,e,f\n" + body + "\n").encode()


# tests/test_table_io.py's files, as (id, bytes, read_csv keywords)
READ_CASES = [
    ("mixed_types", CSV.encode(), {}),
    ("quoted_fields", b'name,val\n"Smith, John",3\nPlain,4\n', {}),
    ("no_header", b"1,2\n3,4\n", {"header": False}),
    ("no_header_names", b"1,2\n3,4\n", {"header": False, "column_names": ["a", "b"]}),
    ("short_rows", b"a,b\n1,2\n3\n", {}),
    ("interior_blank_lines", b"a,b\r\n1,x\r\n\r\n2,y\r\n\n3,z\r\n", {}),
    ("utf16", "a,b\n1,héllo\n".encode("utf-16"), {"encoding": "utf-16"}),
    ("hex_cells", b"a,b\n0x1A,2\n0x2B,3\n", {}),
    ("large_numeric", _big_numeric(), {}),
    ("empty", b"\n\n", {}),
    ("header_only", b"a,b\n", {}),
    ("spaced_cells", b"a, b, c\n1, x y, \n2, ?, 3.5\n", {}),
    ("non_ascii_delimiter", "a§b\n1§x\n2§y\n".encode(), {"delimiter": "§"}),
]


@pytest.mark.parametrize("data,kw", [c[1:] for c in READ_CASES], ids=[c[0] for c in READ_CASES])
def test_read_csv_equals_the_reference(tmp_path, data, kw):
    path = tmp_path / "t.csv"
    path.write_bytes(data)
    assert_same_table(table_io.read_csv(str(path), **kw), ref_io.read_csv(str(path), **kw))


@pytest.mark.parametrize("data", [CSV.encode(), _big_numeric(),
                                  b"a,b\r\n1,x\r\n\r\n2,y\r\n\n3,z\r\n"],
                         ids=["mixed", "large", "blank_lines"])
def test_native_and_slow_paths_agree_as_in_the_reference(data):
    for io in (table_io, ref_io):
        fast = io._parse_csv_bytes(data, True, ",", None, "utf-8")
        slow = io._read_csv_slow(data, True, ",", None, "utf-8")
        assert fast.columns == slow.columns
    assert_same_table(table_io._parse_csv_bytes(data, True, ",", None, "utf-8"),
                      ref_io._parse_csv_bytes(data, True, ",", None, "utf-8"))
    assert_same_table(table_io._read_csv_slow(data, True, ",", None, "utf-8"),
                      ref_io._read_csv_slow(data, True, ",", None, "utf-8"))


def test_multichar_delimiter_rejected_by_both(tmp_path):
    path = tmp_path / "d.csv"
    path.write_text("a::b\n1::2\n")
    for io in (table_io, ref_io):
        with pytest.raises(ValueError, match="one character"):
            io.read_csv(str(path), delimiter="::")


def test_no_native_lib_takes_the_csv_module_path(monkeypatch):
    monkeypatch.setattr(native, "csv_parse", lambda *a, **k: None)
    monkeypatch.setattr(ref_native, "csv_parse", lambda *a, **k: None)
    data = CSV.encode()
    assert_same_table(table_io._parse_csv_bytes(data, True, ",", None, "utf-8"),
                      ref_io._parse_csv_bytes(data, True, ",", None, "utf-8"))


def _random_csv(seed: int, rows: int = 300, cols: int = 7) -> bytes:
    """Numbers, hex cells, blanks, text and short rows, with and without \\r."""
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(rows):
        cells = []
        for j in range(cols):
            r = rng.random()
            if r < 0.1:
                cells.append("")
            elif r < 0.15:
                cells.append(f"0x{rng.integers(0, 4096):X}")
            elif r < 0.2:
                cells.append(str(rng.choice(["abc", "1e5x", "nan", "-inf", " 7 ", "1_0"])))
            else:
                cells.append(f"{rng.normal() * 10.0 ** rng.integers(-5, 6):.12g}")
        if rng.random() < 0.1:
            cells = cells[:rng.integers(1, cols)]
        lines.append(",".join(cells) + ("\r" if rng.random() < 0.2 else ""))
    return ("\n".join(lines) + "\n").encode()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_csv_parse_gives_the_reference_bits(seed):
    assert native.available() and ref_native.available()
    data = _random_csv(seed)
    buf = np.frombuffer(data, np.uint8)
    offsets = np.concatenate([[0], np.flatnonzero(buf == ord("\n")) + 1]).astype(np.int64)
    for threads in (1, 3):
        port = native.csv_parse(data, offsets, 7, ",", n_threads=threads)
        ref = ref_native.csv_parse(data, offsets, 7, ",", n_threads=threads)
        np.testing.assert_array_equal(port[1], ref[1])
        nan = np.isnan(ref[0])
        np.testing.assert_array_equal(np.isnan(port[0]), nan)
        np.testing.assert_array_equal(port[0][~nan].view(np.uint64), ref[0][~nan].view(np.uint64))
    assert native.csv_parse(data, offsets, 7, "§") is None
    assert ref_native.csv_parse(data, offsets, 7, "§") is None


def test_a_library_older_than_its_source_is_rebuilt(tmp_path, monkeypatch):
    """A .so built before kernels.cpp gained the CSV parser is rebuilt, not
    loaded without the symbol."""
    src = tmp_path / "kernels.cpp"
    shutil.copy(native._SRC, src)
    stale = tmp_path / "_build" / "libmmlsparktputorch.so"
    stale.parent.mkdir()
    stale.write_bytes(b"stale")
    old = time.time() - 3600
    os.utime(stale, (old, old))
    monkeypatch.setattr(native, "_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_SRC", str(src))
    path = native._compile()
    assert path == str(stale) and stale.read_bytes() != b"stale"
    import ctypes

    assert hasattr(ctypes.CDLL(path), "mmlspark_csv_parse")


@pytest.mark.parametrize("delimiter", [",", ";"])
def test_write_csv_writes_the_reference_bytes(tmp_path, delimiter):
    cols = {"x": np.asarray([1.5, np.nan, -2.25]), "name": ["ab", "c,d", 'q"uote'],
            "n": np.asarray([1, 2, 3])}
    port, ref = tmp_path / "p.csv", tmp_path / "r.csv"
    table_io.write_csv(Table(cols), str(port), delimiter=delimiter)
    ref_io.write_csv(RefTable(cols), str(ref), delimiter=delimiter)
    assert port.read_bytes() == ref.read_bytes()
    assert_same_table(table_io.read_csv(str(port), delimiter=delimiter),
                      ref_io.read_csv(str(ref), delimiter=delimiter))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_datagen_csv_roundtrip_equals_the_reference(tmp_path, seed):
    specs = lambda mod: [  # noqa: E731
        mod.ColumnSpec("d", "double", low=-5, high=5, null_fraction=0.2 if seed else 0.0),
        mod.ColumnSpec("i", "int", low=0, high=50),
        mod.ColumnSpec("s", "string", length=6),
        mod.ColumnSpec("c", "category", cardinality=3),
    ]
    port = datagen.generate_table(specs(datagen), n_rows=64, seed=seed)
    ref = ref_datagen.generate_table(specs(ref_datagen), n_rows=64, seed=seed)
    table_io.write_csv(port, str(tmp_path / "p.csv"))
    ref_io.write_csv(ref, str(tmp_path / "r.csv"))
    assert (tmp_path / "p.csv").read_bytes() == (tmp_path / "r.csv").read_bytes()
    assert_same_table(table_io.read_csv(str(tmp_path / "p.csv")),
                      ref_io.read_csv(str(tmp_path / "r.csv")))


def test_parquet_roundtrips_as_the_reference(tmp_path):
    pytest.importorskip("pyarrow")
    cols = {"x": np.asarray([1.0, np.nan, 3.0]), "s": ["u", "v", "w"],
            "id": np.asarray([2 ** 60 + 1, 7], np.int64).repeat([2, 1]),
            "v": np.asarray([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]], np.float32)}
    table_io.write_parquet(Table(cols), str(tmp_path / "p.parquet"))
    ref_io.write_parquet(RefTable(cols), str(tmp_path / "r.parquet"))
    for path in ("p.parquet", "r.parquet"):
        assert_same_table(table_io.read_parquet(str(tmp_path / path)),
                          ref_io.read_parquet(str(tmp_path / path)))


def test_pandas_interop_as_the_reference():
    pd = pytest.importorskip("pandas")
    df = pd.DataFrame({"a": [1.0, np.nan], "b": ["x", "y"], "i": [3, 4]})
    assert_same_table(table_io.from_pandas(df), ref_io.from_pandas(df))
    cols = {"p": np.asarray([[0.2, 0.8], [0.6, 0.4]]), "y": np.asarray([1.0, 0.0]),
            "s": ["u", "v"]}
    port, ref = table_io.to_pandas(Table(cols)), ref_io.to_pandas(RefTable(cols))
    assert list(port.columns) == list(ref.columns)
    for c in ref.columns:
        assert port[c].tolist() == ref[c].tolist()


HOST = {"f64": np.linspace(-1, 1, 5), "f32": np.arange(5, dtype=np.float32),
        "i64": np.arange(-2, 3, dtype=np.int64), "i32": np.arange(5, dtype=np.int32),
        "u64": np.arange(5, dtype=np.uint64), "u8": np.arange(5, dtype=np.uint8),
        "i16": np.arange(5, dtype=np.int16), "f16": np.arange(5, dtype=np.float16),
        "bool": np.arange(5) % 2 == 0, "c128": np.arange(5) * (1 + 2j),
        "mat": np.arange(10, dtype=np.float64).reshape(5, 2) / 3}


def test_device_table_uploads_with_jax_dtypes_and_reads_back():
    dt = DeviceTable.from_host(HOST, device="cpu")
    back = dt.to_host()
    assert dt.columns == list(HOST) and len(dt) == len(HOST) and "f64" in dt
    for name, arr in HOST.items():
        want = np.asarray(jnp.asarray(arr))
        assert isinstance(dt[name], torch.Tensor) and dt[name].device.type == "cpu"
        assert back[name].dtype == want.dtype, name
        np.testing.assert_array_equal(back[name], want, err_msg=name)
    more = dt.with_columns({"z": torch.zeros(5)})
    assert more.columns == list(HOST) + ["z"] and "z" not in dt


def test_device_table_refuses_shardings_and_a_missing_card():
    """`shardings` uploads this rank's block of a listed column's rows (on
    a mesh object outside a process group this rank is shard 0) and the
    others whole; rows that do not split over the data axis, and "cuda"
    without a card, raise. Several ranks: tests/test_torch_fusion_mesh.py."""
    from mmlspark_tpu_torch.parallel.mesh import Mesh

    dt = DeviceTable.from_host(HOST, shardings={"f64": Mesh((0, 1, 2, 3, 4))}, device="cpu")
    whole = DeviceTable.from_host(HOST, device="cpu")
    assert torch.equal(dt["f64"], whole["f64"][:1])
    for name in HOST:
        if name != "f64":
            assert torch.equal(dt[name], whole[name]), name
    with pytest.raises(ValueError, match="do not split"):
        DeviceTable.from_host(HOST, shardings={"f64": Mesh((0, 1))}, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            DeviceTable.from_host(HOST)
