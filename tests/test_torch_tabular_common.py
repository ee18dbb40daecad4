"""Shared helpers of the port's tabular parity tests (test_torch_table_io,
test_torch_ops, test_torch_featurize, test_torch_text,
test_torch_automl_train, test_torch_datagen): the same stage built in both
packages, run on the same table, its outputs compared value for value and
bit for bit, and saved stages loaded across the packages."""

import datetime

import numpy as np
import torch

from mmlspark_tpu.core import serialize as ref_serialize
from mmlspark_tpu.core.pipeline import Estimator as RefEstimator
from mmlspark_tpu.core.schema import Table as RefTable
from mmlspark_tpu_torch.core import serialize
from mmlspark_tpu_torch.core.pipeline import Estimator
from mmlspark_tpu_torch.core.schema import Table


def assert_same_value(a, b, where=""):
    """Equal values: arrays of one dtype and shape, bit for bit with NaN in
    the same places; sequences element by element; scalars equal (NaN equal
    to NaN). A tensor or a jax array is compared as the numpy array it holds."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    if hasattr(b, "__array__") and not isinstance(b, (np.ndarray, list, tuple, np.generic)):
        b = np.asarray(b)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), (where, type(a), type(b))
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype, a.shape, b.shape)
        if a.dtype.kind == "f":
            nan = np.isnan(b)
            np.testing.assert_array_equal(np.isnan(a), nan, err_msg=where)
            np.testing.assert_array_equal(a[~nan].view(f"u{a.itemsize}"),
                                          b[~nan].view(f"u{b.itemsize}"), err_msg=where)
        else:
            np.testing.assert_array_equal(a, b, err_msg=where)
        return
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        assert isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)), (where, a, b)
        assert len(a) == len(b), (where, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_value(x, y, f"{where}[{i}]")
        return
    if isinstance(a, dict) or isinstance(b, dict):
        assert isinstance(a, dict) and isinstance(b, dict) and list(a) == list(b), (where, a, b)
        for k in a:
            assert_same_value(a[k], b[k], f"{where}.{k}")
        return
    assert type(a) is type(b) or (isinstance(a, (datetime.datetime,)) and a == b), (where, a, b)
    if isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), (where, a, b)
    else:
        assert a == b, (where, a, b)


def assert_same_table(port, ref, meta: bool = True):
    """Equal column names in order, every column by assert_same_value, and
    equal column metadata."""
    assert port.columns == ref.columns, (port.columns, ref.columns)
    for c in ref.columns:
        assert_same_value(port[c], ref[c], c)
        if meta:
            assert_same_value(dict(port.meta(c)), dict(ref.meta(c)), f"meta {c}")


def both_tables(cols: dict, meta: "dict | None" = None):
    """The same columns as a port Table and a reference Table."""
    return Table(cols, meta), RefTable(cols, meta)


def fitted(stage, table):
    """A transformer, or the model an estimator fits on `table`."""
    if isinstance(stage, (Estimator, RefEstimator)):
        return stage.fit(table)
    return stage


def assert_loads_across(port_stage, ref_stage, tmp_path, port_table, ref_table):
    """Each package's stage saved and loaded by the other package (the port
    by `save_stage` -> reference `load_stage`, and back) transforms the
    other package's table as the other package's own stage does."""
    want_port = port_stage.transform(port_table)
    want_ref = ref_stage.transform(ref_table)
    serialize.save_stage(port_stage, str(tmp_path / "port"))
    as_ref = ref_serialize.load_stage(str(tmp_path / "port"))
    assert type(as_ref).__module__.startswith("mmlspark_tpu."), type(as_ref)
    assert_same_table(as_ref.transform(ref_table), want_ref)
    ref_serialize.save_stage(ref_stage, str(tmp_path / "ref"))
    as_port = serialize.load_stage(str(tmp_path / "ref"))
    assert type(as_port).__module__.startswith("mmlspark_tpu_torch."), type(as_port)
    assert_same_table(as_port.transform(port_table), want_port)
    return as_port, as_ref


def times_ten(table):
    """A module-level Table -> Table function, so that Lambda saves it."""
    return table.with_column("y", table["x"] * 10)


def plus_one(v):
    """A module-level per-row function, so that UDFTransformer saves it."""
    return v + 1
