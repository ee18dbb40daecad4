"""The port's featurization (mmlspark_tpu_torch.ops.featurize: AssembleFeatures,
AssembleFeaturesModel, Featurize) against the JAX package's, on the CPU:
on mixed tables (numeric, vector, categorical metadata, low-cardinality
strings, free text, None) both packages choose equal specs and assemble
matrices equal bit for bit, with equal feature names; a fitted featurizer
saved by either package loads in the other."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import mmlspark_tpu.ops as ref_ops  # noqa: E402
import mmlspark_tpu_torch.ops as ops  # noqa: E402
from mmlspark_tpu.core.schema import CATEGORY_VALUES  # noqa: E402
from mmlspark_tpu_torch.utils import datagen  # noqa: E402
from test_torch_tabular_common import (  # noqa: E402
    assert_loads_across,
    assert_same_table,
    assert_same_value,
    both_tables,
)


def mixed(n: int = 60, seed: int = 0):
    """Every kind AssembleFeatures takes: numeric (with NaN), an int
    column, a vector column, an indexed categorical (CATEGORY_VALUES
    metadata), low-cardinality single-token strings with None, a
    high-cardinality string column, and free text."""
    rng = np.random.default_rng(seed)
    num = rng.normal(size=n)
    num[rng.random(n) < 0.1] = np.nan
    cols = {
        "num": num,
        "count": rng.integers(0, 9, n),
        "vec": rng.normal(size=(n, 3)),
        "cat": rng.integers(0, 4, n).astype(np.float64),
        "segment": [None if r < 0.1 else str(v) for r, v in
                    zip(rng.random(n), rng.choice(["a", "b", "c"], n))],
        "ids": [f"id{i}" for i in rng.integers(0, 1000, n)],
        "text": [" ".join(rng.choice(["red", "green", "blue", "fox", "dog"],
                                     rng.integers(1, 5))) for _ in range(n)],
    }
    return cols, {"cat": {CATEGORY_VALUES: ["w", "x", "y", "z"]}}


def specs_and_matrix(make, cols, meta, tmp_path=None):
    pt, rt = both_tables(cols, meta)
    port, ref = make(ops).fit(pt), make(ref_ops).fit(rt)
    out_port, out_ref = port.transform(pt), ref.transform(rt)
    assert_same_table(out_port, out_ref)
    if tmp_path is not None:
        assert_loads_across(port, ref, tmp_path, pt, rt)
    return port, ref, out_port


@pytest.mark.parametrize("kw", [
    {},
    {"number_of_features": 16},
    {"number_of_features": 16, "max_one_hot_cardinality": 2},
    {"number_of_features": 8, "max_one_hot_cardinality": 0},
    {"number_of_features": 8, "one_hot_encode_categoricals": False},
    {"columns_to_featurize": ["vec", "segment", "num"], "features_col": "f"},
], ids=["defaults", "hash16", "cap2", "always_hash", "no_one_hot", "chosen_columns"])
def test_assemble_features_equal_specs_and_matrices(tmp_path, kw):
    cols, meta = mixed()
    port, ref, out = specs_and_matrix(lambda m: m.AssembleFeatures(**kw), cols, meta, tmp_path)
    assert port.specs == ref.specs
    features = out[kw.get("features_col", "features")]
    assert features.dtype == np.float32


def test_assemble_features_tests_ops_cases():
    """tests/test_ops.py's TestFeaturize and TestLowCardinalityLevels tables."""
    cols = {"num": np.array([1.0, 2.0]), "vec": np.array([[1.0, 2.0], [3.0, 4.0]]),
            "cat": ["p", "q"], "txt": ["hello world", "hello"]}
    pt, rt = both_tables(cols)
    pt = ops.ValueIndexer(input_col="cat", output_col="cat").fit(pt).transform(pt)
    rt = ref_ops.ValueIndexer(input_col="cat", output_col="cat").fit(rt).transform(rt)
    port = ops.AssembleFeatures(number_of_features=16).fit(pt)
    ref = ref_ops.AssembleFeatures(number_of_features=16).fit(rt)
    assert port.specs == ref.specs
    assert_same_table(port.transform(pt), ref.transform(rt))
    for cols, kw in (({"segment": ["a", "b", "c", "a"], "text": ["hello world", "x", "y", "z"],
                       "ids": [f"id{i}" for i in range(4)]},
                      {"number_of_features": 16, "max_one_hot_cardinality": 3}),
                     ({"segment": ["a", "b"]}, {"number_of_features": 8,
                                                "max_one_hot_cardinality": 0})):
        pt, rt = both_tables(cols)
        assert_same_table(ops.AssembleFeatures(**kw).fit(pt).transform(pt),
                          ref_ops.AssembleFeatures(**kw).fit(rt).transform(rt))


def test_unseen_levels_and_none_assemble_as_the_reference(tmp_path):
    fit_cols = {"segment": ["a", "b", "a"], "num": np.array([1.0, 2.0, 3.0])}
    pt, rt = both_tables(fit_cols)
    port, ref = ops.AssembleFeatures().fit(pt), ref_ops.AssembleFeatures().fit(rt)
    new_p, new_r = both_tables({"segment": ["b", "zzz", None], "num": np.array([np.nan, 0, 5])})
    assert_same_table(port.transform(new_p), ref.transform(new_r))
    assert_loads_across(port, ref, tmp_path, new_p, new_r)


def test_assemble_features_refuses_alike():
    cols = {"d": [{"a": 1}, {"b": 2}]}
    for m, t in zip((ops, ref_ops), both_tables(cols)):
        with pytest.raises(TypeError, match="cannot featurize"):
            m.AssembleFeatures().fit(t)


@pytest.mark.parametrize("kw", [
    {"feature_columns": {"f1": ["num"], "f2": ["num", "vec", "segment"]}},
    {"feature_columns": {"all": ["num", "count", "vec", "cat", "segment", "ids", "text"]},
     "number_of_features": 32},
    {"feature_columns": {"f": ["segment", "text"]}, "max_one_hot_cardinality": 1},
], ids=["two_outputs", "every_kind", "cap1"])
def test_featurize_equal_pipelines(tmp_path, kw):
    cols, meta = mixed(n=80, seed=3)
    pt, rt = both_tables(cols, meta)
    port, ref = ops.Featurize(**kw).fit(pt), ref_ops.Featurize(**kw).fit(rt)
    assert [s.specs for s in port.stages] == [s.specs for s in ref.stages]
    assert_same_table(port.transform(pt), ref.transform(rt))
    assert_loads_across(port, ref, tmp_path, pt, rt)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_featurize_random_datagen_tables(seed):
    """Random constrained tables (utils.datagen): every column assembled."""
    specs = datagen.random_specs(8, seed=seed, kinds=("double", "int", "string", "category",
                                                     "vector"))
    table = datagen.generate_table(specs, 50, seed=seed)
    cols = {c: table[c] for c in table.columns}
    meta = {c: dict(table.meta(c)) for c in table.columns if table.meta(c)}
    # category columns hold their level strings, so they assemble as levels
    pt, rt = both_tables(cols, meta)
    kw = {"feature_columns": {"features": list(cols)}, "number_of_features": 16}
    port, ref = ops.Featurize(**kw), ref_ops.Featurize(**kw)
    try:
        want = ref.fit(rt).transform(rt)
    except (TypeError, ValueError) as e:
        with pytest.raises(type(e)):
            port.fit(pt).transform(pt)
        return
    assert_same_table(port.fit(pt).transform(pt), want)


def test_a_fitted_featurizer_reads_cached_columns_as_the_reference():
    cols, meta = mixed(n=30, seed=5)
    numeric = {k: v for k, v in cols.items() if isinstance(v, np.ndarray)}
    pt, rt = both_tables(numeric, meta)
    port, ref = ops.AssembleFeatures().fit(pt), ref_ops.AssembleFeatures().fit(rt)
    cp = ops.Cacher(device="cpu").transform(pt).with_meta("cat", meta["cat"])
    cr = ref_ops.Cacher().transform(rt).with_meta("cat", meta["cat"])
    assert_same_value(port.transform(cp)["features"], ref.transform(cr)["features"])
