"""The port's ops stages (mmlspark_tpu_torch.ops) against the JAX package's,
on the CPU: each stage built alike in both packages, run on the same table
(the cases of tests/test_ops.py and a few more), gives equal outputs and
metadata, numeric columns bit for bit; a stage saved by either package
loads in the other and transforms the same; `Cacher(device="cpu")` gives
the dtypes `jax.device_put` gives, and the stages read a cached column as
the reference's read a jax array."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import mmlspark_tpu.ops as ref_ops  # noqa: E402
import mmlspark_tpu_torch.ops as ops  # noqa: E402
from mmlspark_tpu.core.schema import CATEGORY_VALUES  # noqa: E402
from test_torch_tabular_common import (  # noqa: E402
    assert_loads_across,
    assert_same_table,
    assert_same_value,
    both_tables,
    fitted,
    plus_one,
    times_ten,
)


def run_both(make, cols, meta=None, tmp_path=None):
    """`make(module)` built from the port's and the reference's ops, fitted
    where it is an estimator and run on the same table: equal outputs. With
    `tmp_path`, the fitted stages also load across the packages."""
    pt, rt = both_tables(cols, meta)
    port, ref = fitted(make(ops), pt), fitted(make(ref_ops), rt)
    out_port, out_ref = port.transform(pt), ref.transform(rt)
    assert_same_table(out_port, out_ref)
    if tmp_path is not None:
        assert_loads_across(port, ref, tmp_path, pt, rt)
    return out_port, out_ref


def raises_both(make, cols, exc, match=None):
    pt, rt = both_tables(cols)
    for module, table in ((ops, pt), (ref_ops, rt)):
        with pytest.raises(exc, match=match):
            fitted(make(module), table).transform(table)


ABC = {"a": [1], "b": [2], "c": [3]}
NUMS = {"x": np.array([1.0, np.nan, 3.0, 4.5]), "i": np.array([3, 1, 3, 2]),
        "s": ["b", "a", None, "b"], "f": np.array([0.5, np.nan, 2.0, np.nan], np.float32)}


@pytest.mark.parametrize("make,cols", [
    (lambda m: m.DropColumns(cols=["a"]), ABC),
    (lambda m: m.DropColumns(cols=["a", "zz"], ignore_missing=True), ABC),
    (lambda m: m.SelectColumns(cols=["c", "a"]), ABC),
    (lambda m: m.RenameColumn(input_col="a", output_col="z"), ABC),
    (lambda m: m.Repartition(n=4), ABC),
    (lambda m: m.Repartition(n=2), {}),
], ids=["drop", "drop_missing", "select", "rename", "repartition", "repartition_empty"])
def test_column_stages(tmp_path, make, cols):
    run_both(make, cols, tmp_path=tmp_path)


@pytest.mark.parametrize("make,exc", [
    (lambda m: m.DropColumns(cols=["nope"]), KeyError),
    (lambda m: m.SelectColumns(cols=["nope"]), KeyError),
    (lambda m: m.Repartition(n=0), ValueError),
], ids=["drop", "select", "repartition"])
def test_column_stages_refuse_alike(make, exc):
    raises_both(make, ABC, exc)


@pytest.mark.parametrize("cols", [{"k": [1, 2], "vs": [[10, 20], [30]]},
                                  {"k": np.array([1.5, 2.5, 3.5]), "vs": [["a"], [], ["b", "c"]]}],
                         ids=["ints", "strings_and_empty"])
def test_explode(tmp_path, cols):
    run_both(lambda m: m.Explode(input_col="vs"), cols, tmp_path=tmp_path)
    run_both(lambda m: m.Explode(input_col="vs", output_col="v"), cols)


def test_lambda_and_udf(tmp_path):
    cols = {"x": np.array([1.0, 2.0])}
    run_both(lambda m: m.Lambda(times_ten), cols, tmp_path=tmp_path / "lambda")
    run_both(lambda m: m.UDFTransformer(input_col="x", output_col="y", udf=plus_one), cols,
             tmp_path=tmp_path / "udf")
    run_both(lambda m: m.UDFTransformer(input_col="x", output_col="y", udf=plus_one,
                                        vectorized=True), cols)
    for m in (ops, ref_ops):
        with pytest.raises(TypeError, match="importable"):
            m.Lambda(lambda t: t).save(str(tmp_path / "anon"))


@pytest.mark.parametrize("mapping,case", [({"cat": "dog", "category": "class"}, True),
                                          ({"Cat": "dog", "s": "S"}, False)],
                         ids=["longest_match", "case_sensitive"])
def test_text_preprocessor(tmp_path, mapping, case):
    run_both(lambda m: m.TextPreprocessor(input_col="s", output_col="o", map=mapping,
                                          normalize_case=case),
             {"s": ["the cat sat", "category", "Cats sit"]}, tmp_path=tmp_path)


@pytest.mark.parametrize("cols", [{"y": [0, 0, 0, 1]}, {"y": ["a", "b", "b", "c", "c", "c"]},
                                  {"y": np.array([1.0, 2.0, 2.0])}], ids=["ints", "strings", "floats"])
def test_class_balancer(tmp_path, cols):
    run_both(lambda m: m.ClassBalancer(input_col="y"), cols, tmp_path=tmp_path)


@pytest.mark.parametrize("cols", [{"c": ["b", "a", "b", None]}, {"c": [10, 20, 10]},
                                  {"c": np.array([2.5, np.nan, 1.0, 2.5])}],
                         ids=["strings_null", "ints", "floats_nan"])
def test_value_indexer_and_index_to_value(tmp_path, cols):
    out, _ = run_both(lambda m: m.ValueIndexer(input_col="c", output_col="i"), cols,
                      tmp_path=tmp_path)
    ref_out = ref_ops.ValueIndexer(input_col="c", output_col="i").fit(
        both_tables(cols)[1]).transform(both_tables(cols)[1])
    pt, rt = out, ref_out
    assert_same_table(ops.IndexToValue(input_col="i", output_col="c2").transform(pt),
                      ref_ops.IndexToValue(input_col="i", output_col="c2").transform(rt))


def test_value_indexer_refuses_alike():
    for m in (ops, ref_ops):
        model = m.ValueIndexer(input_col="c", output_col="i").fit(
            both_tables({"c": ["a"]})[0 if m is ops else 1])
        with pytest.raises(ValueError, match="unseen"):
            model.transform(both_tables({"c": ["zzz"]})[0 if m is ops else 1])
    raises_both(lambda m: m.IndexToValue(input_col="c", output_col="o"), {"c": [0, 1]},
                ValueError, "metadata")


@pytest.mark.parametrize("mode,value", [("Mean", None), ("Median", None), ("Custom", -1)])
def test_clean_missing_data(tmp_path, mode, value):
    kw = {"custom_value": value} if value is not None else {}
    out, _ = run_both(lambda m: m.CleanMissingData(input_cols=["x", "f", "i"],
                                                   output_cols=["x", "f2", "i"],
                                                   cleaning_mode=mode, **kw),
                      NUMS, tmp_path=tmp_path)
    assert out["f2"].dtype == np.float32 and out["x"].dtype == np.float64


def test_clean_missing_data_refuses_alike():
    raises_both(lambda m: m.CleanMissingData(input_cols=["x"], output_cols=[]), NUMS,
                ValueError, "align")
    raises_both(lambda m: m.CleanMissingData(input_cols=["x"], output_cols=["x"],
                                             cleaning_mode="Custom"), NUMS, ValueError, "custom")


@pytest.mark.parametrize("target", ["boolean", "byte", "short", "integer", "long", "float",
                                    "double", "string", "toCategorical", "clearCategorical"])
def test_data_conversion(tmp_path, target):
    cols = {"x": np.array([1.5, 2.5, -3.0]), "s": ["1", "2", "7"], "i": np.array([1, 0, 2])}
    meta = {"i": {CATEGORY_VALUES: ["a", "b", "c"]}}
    run_both(lambda m: m.DataConversion(cols=["x", "i"], convert_to=target), cols, meta,
             tmp_path=tmp_path)
    if target not in ("toCategorical", "clearCategorical", "string"):
        run_both(lambda m: m.DataConversion(cols=["s"], convert_to=target), cols)


def test_data_conversion_dates_and_refusal():
    cols = {"d": ["2024-01-02 03:04:05", "1999-12-31 23:59:59"]}
    run_both(lambda m: m.DataConversion(cols=["d"], convert_to="date"), cols)
    run_both(lambda m: m.DataConversion(cols=["d"], convert_to="date",
                                        date_time_format="%Y-%m-%d %H:%M:%S"), cols)
    raises_both(lambda m: m.DataConversion(cols=["d"], convert_to="nope"), cols, ValueError)


@pytest.mark.parametrize("flags", [{}, {"counts": False}, {"basic": False},
                                   {"sample": False, "percentiles": False}],
                         ids=["all", "no_counts", "no_basic", "no_quantiles"])
def test_summarize_data(tmp_path, flags):
    cols = {"x": np.array([1.0, 2.0, 3.0, np.nan]), "s": ["a", "b", "a", None],
            "n": np.array([np.nan] * 4), "v": np.array([5, 5, 6, 7])}
    run_both(lambda m: m.SummarizeData(**flags), cols, tmp_path=tmp_path)


@pytest.mark.parametrize("kw", [{"mode": "Head", "count": 5},
                                {"mode": "RandomSample", "percent": 0.5, "seed": 1},
                                {"mode": "RandomSample", "percent": 0.1},
                                {"mode": "AssignToPartition", "num_parts": 4},
                                {"mode": "AssignToPartition", "num_parts": 3, "seed": 9,
                                 "new_col_name": "bucket"}],
                         ids=["head", "random_half", "random_tenth", "assign", "assign_seeded"])
def test_partition_sample(tmp_path, kw):
    run_both(lambda m: m.PartitionSample(**kw),
             {"x": np.arange(100), "s": [str(i) for i in range(100)]}, tmp_path=tmp_path)


@pytest.mark.parametrize("kw", [{}, {"strategy": "collect"}, {"collapse_group": False},
                                {"col_names": ["avg"], "keys": ["k", "j"]}],
                         ids=["mean", "collect", "broadcast", "two_keys"])
def test_ensemble_by_key(tmp_path, kw):
    cols = {"k": ["a", "a", "b", "a"], "j": [1, 2, 1, 1],
            "v": np.array([1.0, 3.0, 5.0, 0.25])}
    run_both(lambda m: m.EnsembleByKey(**{"keys": ["k"], "cols": ["v"], **kw}), cols,
             tmp_path=tmp_path)
    run_both(lambda m: m.EnsembleByKey(keys=["k"], cols=["w"]),
             {"k": ["a", "a", "b"], "w": np.array([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]])})


def test_multi_column_adapter(tmp_path):
    run_both(lambda m: m.MultiColumnAdapter(base_stage=m.ValueIndexer(),
                                            input_cols=["c1", "c2"], output_cols=["i1", "i2"]),
             {"c1": ["a", "b"], "c2": ["x", "x"]}, tmp_path=tmp_path)
    raises_both(lambda m: m.MultiColumnAdapter(base_stage=m.ValueIndexer(),
                                               input_cols=["c1"], output_cols=[]),
                {"c1": ["a"]}, ValueError, "align")


@pytest.mark.parametrize("make", [
    lambda m: m.FixedMiniBatchTransformer(batch_size=2),
    lambda m: m.FixedMiniBatchTransformer(batch_size=7),
    lambda m: m.DynamicMiniBatchTransformer(),
    lambda m: m.DynamicMiniBatchTransformer(max_batch_size=3),
    lambda m: m.TimeIntervalMiniBatchTransformer(interval_ms=100, arrival_time_col="t"),
    lambda m: m.TimeIntervalMiniBatchTransformer(interval_ms=100, arrival_time_col="t",
                                                 max_batch_size=1),
    lambda m: m.TimeIntervalMiniBatchTransformer(interval_ms=100),
], ids=["fixed2", "fixed7", "dynamic", "dynamic_cap3", "interval", "interval_cap1",
        "interval_no_times"])
def test_minibatch_and_flatten(tmp_path, make):
    cols = {"x": np.arange(5), "s": [str(i) for i in range(5)],
            "t": np.array([0, 10, 500, 510, 900])}
    batched, ref_batched = run_both(make, cols, tmp_path=tmp_path)
    assert_same_table(ops.FlattenBatch().transform(batched),
                      ref_ops.FlattenBatch().transform(ref_batched))


def test_minibatch_refuses_alike():
    raises_both(lambda m: m.FixedMiniBatchTransformer(batch_size=0), {"x": [1]}, ValueError)
    raises_both(lambda m: m.TimeIntervalMiniBatchTransformer(interval_ms=5, arrival_time_col="t"),
                {"t": np.array([5, 1])}, ValueError, "sorted")
    for m in (ops, ref_ops):
        with pytest.raises(ValueError):
            m.TimeIntervalMiniBatchTransformer(interval_ms=0)


def test_checkpoint_data_writes_the_reference_snapshot(tmp_path):
    cols = {"x": np.arange(3, dtype=np.float64), "s": ["a", "b", "c"],
            "m": np.ones((3, 2), np.float32)}
    pt, rt = both_tables(cols)
    assert_same_table(ops.CheckpointData(to_disk=True, path=str(tmp_path / "port")).transform(pt),
                      ref_ops.CheckpointData(to_disk=True, path=str(tmp_path / "ref")).transform(rt))
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "ref.npz") as b:
        assert a.files == b.files == ["x", "m"]
        for k in a.files:
            assert_same_value(a[k], b[k], k)
    raises_both(lambda m: m.CheckpointData(to_disk=True), cols, ValueError, "path")


def test_get_value_at_and_to_vector():
    vec = np.arange(6, dtype=np.float64).reshape(3, 2)
    assert_same_value(ops.get_value_at(vec, 1), ref_ops.get_value_at(vec, 1))
    assert_same_value(ops.to_vector([[1, 2], [3, 4]]), ref_ops.to_vector([[1, 2], [3, 4]]))


# ---- Cacher: columns on the device, and stages reading them ---- #

CACHED = {"f64": np.array([1.0, np.nan, 3.25, 4.0]), "f32": np.arange(4, dtype=np.float32),
          "i64": np.array([3, 1, 0, 2]), "u8": np.arange(4, dtype=np.uint8),
          "bool": np.array([True, False, True, True]), "s": ["a", "b", "a", "c"],
          "m": np.arange(8, dtype=np.float64).reshape(4, 2) / 3}


def test_cacher_puts_columns_on_the_device_with_jax_dtypes():
    pt, rt = both_tables(CACHED)
    port = ops.Cacher(device="cpu").transform(pt)
    ref = ref_ops.Cacher().transform(rt)
    for name in CACHED:
        if isinstance(CACHED[name], np.ndarray):
            assert isinstance(port[name], torch.Tensor) and port[name].device.type == "cpu"
        assert_same_value(port[name], ref[name], name)
    assert ops.Cacher(device="cpu", disable=True).transform(pt) is pt
    assert_same_value(port.gather([0, 2])["f64"], ref.gather([0, 2])["f64"])


def test_cacher_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is there")
    with pytest.raises(RuntimeError, match="cuda"):
        ops.Cacher().transform(both_tables(CACHED)[0])


@pytest.mark.parametrize("gathered", [False, True], ids=["cached", "cached_then_gathered"])
@pytest.mark.parametrize("make", [
    lambda m: m.CleanMissingData(input_cols=["f64", "f32"], output_cols=["a", "b"]),
    lambda m: m.CleanMissingData(input_cols=["f64"], output_cols=["a"], cleaning_mode="Median"),
    lambda m: m.ClassBalancer(input_col="i64"),
    lambda m: m.ValueIndexer(input_col="i64", output_col="o"),
    lambda m: m.EnsembleByKey(keys=["s"], cols=["f64"]),
    lambda m: m.TimeIntervalMiniBatchTransformer(interval_ms=2, arrival_time_col="u8"),
], ids=["clean_mean", "clean_median", "balancer", "indexer", "ensemble", "interval"])
def test_stages_read_a_cached_column_as_the_reference(make, gathered):
    """A stage after a Cacher reads the device column as the reference's
    reads its jax array: the same output from the f32 (x64-off) values."""
    pt, rt = both_tables(CACHED)
    pt, rt = ops.Cacher(device="cpu").transform(pt), ref_ops.Cacher().transform(rt)
    if gathered:   # a row gather leaves a list of 0-d device arrays
        pt, rt = pt.gather([0, 2, 3]), rt.gather([0, 2, 3])
    port, ref = fitted(make(ops), pt), fitted(make(ref_ops), rt)
    out_port, out_ref = port.transform(pt), ref.transform(rt)
    for c in out_ref.columns:
        if c not in CACHED:
            assert_same_value(out_port[c], out_ref[c], c)


def test_index_to_value_and_get_value_at_read_a_cached_column():
    cols = {"i": np.array([0, 2, 1]), "m": np.arange(6.0).reshape(3, 2)}
    meta = {"i": {CATEGORY_VALUES: ["x", "y", "z"]}}
    pt, rt = both_tables(cols, meta)
    pt, rt = ops.Cacher(device="cpu").transform(pt), ref_ops.Cacher().transform(rt)
    pt, rt = pt.with_meta("i", meta["i"]), rt.with_meta("i", meta["i"])
    assert_same_table(ops.IndexToValue(input_col="i", output_col="v").transform(pt).drop("i", "m"),
                      ref_ops.IndexToValue(input_col="i", output_col="v").transform(rt).drop("i", "m"))
    assert_same_value(ops.get_value_at(pt["m"], 1), np.asarray(ref_ops.get_value_at(rt["m"], 1)))


def test_ops_exports_match_the_reference():
    assert sorted(n for n in dir(ops) if not n.startswith("_") and n[0].isupper()) == \
        sorted(n for n in dir(ref_ops) if not n.startswith("_") and n[0].isupper())
    assert {"get_value_at", "to_vector"} <= set(dir(ops))
