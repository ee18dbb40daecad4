"""The port's seeded table generator (mmlspark_tpu_torch.utils.datagen)
against the JAX package's, on the CPU: every function gives the same
values bit for bit, from the same `np.random.Generator` draws."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu.utils import datagen as ref_datagen  # noqa: E402
from mmlspark_tpu_torch.utils import datagen  # noqa: E402
from test_torch_tabular_common import assert_same_table, assert_same_value  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmarks", "data")


def _specs(mod, null: float):
    return [mod.ColumnSpec("d", "double", low=-5, high=5, null_fraction=null),
            mod.ColumnSpec("i", "int", low=0, high=50, null_fraction=null),
            mod.ColumnSpec("b", "bool", null_fraction=null),
            mod.ColumnSpec("s", "string", length=6, null_fraction=null),
            mod.ColumnSpec("c", "category", cardinality=3, null_fraction=null),
            mod.ColumnSpec("e", "category", values=["x", 7, 2.5]),
            mod.ColumnSpec("v", "vector", length=4, null_fraction=null)]


@pytest.mark.parametrize("null", [0.0, 0.2, 1.0])
@pytest.mark.parametrize("seed", [0, 5])
def test_generate_table_equals_the_reference(seed, null):
    assert_same_table(datagen.generate_table(_specs(datagen, null), 40, seed=seed),
                      ref_datagen.generate_table(_specs(ref_datagen, null), 40, seed=seed))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_specs_and_their_tables_equal_the_reference(seed):
    port, ref = datagen.random_specs(12, seed=seed), ref_datagen.random_specs(12, seed=seed)
    assert [vars(s) for s in port] == [vars(s) for s in ref]
    assert_same_table(datagen.generate_table(port, 25, seed=seed),
                      ref_datagen.generate_table(ref, 25, seed=seed))
    kinds = ("int", "vector")
    assert [vars(s) for s in datagen.random_specs(5, seed=seed, kinds=kinds)] == \
        [vars(s) for s in ref_datagen.random_specs(5, seed=seed, kinds=kinds)]


def test_column_spec_refuses_alike():
    for mod in (datagen, ref_datagen):
        with pytest.raises(ValueError, match="unknown column kind"):
            mod.ColumnSpec("x", "complex")
        with pytest.raises(ValueError, match="null_fraction"):
            mod.ColumnSpec("x", null_fraction=1.5)


def test_digits_to_images_equals_the_reference():
    x = np.random.default_rng(0).integers(0, 17, size=(9, 64))
    assert_same_value(datagen.digits_to_images(x), ref_datagen.digits_to_images(x))
    assert_same_value(datagen.digits_to_images(x.astype(np.float32)),
                      ref_datagen.digits_to_images(x.astype(np.float32)))


@pytest.mark.parametrize("name", sorted(f for f in os.listdir(DATA) if f.endswith(".csv"))[:4])
def test_load_label_csv_equals_the_reference(name):
    port, ref = datagen.load_label_csv(os.path.join(DATA, name)), \
        ref_datagen.load_label_csv(os.path.join(DATA, name))
    assert_same_value(list(port), list(ref))


@pytest.mark.parametrize("n,seed,frac", [(1797, 0, 0.8), (100, 3, 0.5), (7, 1, 0.9)])
def test_holdout_split_equals_the_reference(n, seed, frac):
    assert_same_value(list(datagen.holdout_split(n, seed, frac)),
                      list(ref_datagen.holdout_split(n, seed, frac)))


def test_datagen_exports_match_the_reference():
    assert sorted(datagen.__all__) == sorted(ref_datagen.__all__)
