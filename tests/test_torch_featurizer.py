"""The port's `ImageFeaturizer` (mmlspark_tpu_torch/nn/featurizer.py)
against the JAX package's, on a CIFAR ResNet-20 at 16 x 16 whose seeded
weights both packages load (the port through nn/carry.py's
`load_variables`).

The truncated forward agrees within 1e-4 at every cut and at an explicit
layer (f32 throughout, only the order of sums differs). Where the images
are resized first (24 -> 16, "bilinear"), the port's resize and
`jax.image.resize` differ by up to ~1e-4 on 0-255 values
(tests/test_torch_image_ops.py), which the network carries to the
features: 1e-3 there.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmlspark_tpu.core.schema import Table as JaxTable  # noqa: E402
from mmlspark_tpu.nn.featurizer import ImageFeaturizer as JaxFeaturizer  # noqa: E402
from mmlspark_tpu.nn.models import ModelBundle as JaxBundle  # noqa: E402
from mmlspark_tpu_torch.core import Table  # noqa: E402
from mmlspark_tpu_torch.core.schema import SCORE_KIND  # noqa: E402
from mmlspark_tpu_torch.nn import ImageFeaturizer, ModelBundle  # noqa: E402
from mmlspark_tpu_torch.nn.carry import module_variables  # noqa: E402

SHAPE = (16, 16, 3)


def _seeded(tree, rng, path=()):
    """Every leaf of `tree` drawn anew: kernels N(0, 1/fan_in), BatchNorm
    scales near 1 (flax zero-inits some), variances positive."""
    if isinstance(tree, dict):
        return {k: _seeded(v, rng, path + (k,)) for k, v in tree.items()}
    shape, leaf = np.shape(tree), path[-1]
    if leaf == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        v = rng.standard_normal(shape) / np.sqrt(fan_in)
    elif leaf == "scale":
        v = 1.0 + 0.2 * rng.standard_normal(shape)
    elif leaf == "var":
        v = 0.5 + np.abs(rng.standard_normal(shape))
    else:
        v = 0.1 * rng.standard_normal(shape)
    return v.astype(np.float32)


@pytest.fixture(scope="module")
def bundles():
    model = ModelBundle.init("resnet20_cifar", SHAPE, num_outputs=10).module
    tree = _seeded(module_variables(model), np.random.default_rng(0))
    prep = {"mean": [120.0, 115.0, 100.0], "std": [60.0, 58.0, 57.0]}
    port = ModelBundle(architecture="resnet20_cifar", config={"num_outputs": 10},
                       variables=tree, input_shape=SHAPE, preprocess=prep)
    ref = JaxBundle(architecture="resnet20_cifar", config={"num_outputs": 10},
                    variables=jax.tree.map(jnp.asarray, tree), input_shape=SHAPE,
                    preprocess=prep)
    return port, ref


def _images(n, h, w, seed=1):
    return np.random.default_rng(seed).integers(0, 256, size=(n, h, w, 3), dtype=np.uint8)


def _featurize(bundles, x, **params):
    port, ref = bundles
    got = ImageFeaturizer(input_col="image", output_col="f", device="cpu",
                          mini_batch_size=4, **params).set_model(port)
    want = JaxFeaturizer(input_col="image", output_col="f", mini_batch_size=4,
                         **params).set_model(ref)
    return (got, got.transform(Table({"image": x, "id": np.arange(len(x))})),
            want, want.transform(JaxTable({"image": x, "id": np.arange(len(x))})))


@pytest.mark.parametrize("params", [{"cut_output_layers": 0}, {"cut_output_layers": 1},
                                    {"cut_output_layers": 2},
                                    {"layer_name": "stage1_block2"}],
                         ids=["cut0", "cut1", "cut2", "layer_name"])
def test_features_match_jax(bundles, params):
    x = _images(6, 16, 16)
    got_stage, got, want_stage, want = _featurize(bundles, x, **params)
    assert got_stage._fetch_name() == want_stage._fetch_name()
    g, w = np.asarray(got["f"]), np.asarray(want["f"])
    assert g.shape == w.shape and g.ndim == 2 and g.dtype == np.float64
    np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * max(1.0, np.abs(w).max()))


def test_layer_names_match_jax(bundles):
    port, ref = bundles
    assert port.layer_names() == ref.layer_names()


def test_resize_path_matches_jax(bundles):
    """24 x 24 images resized to the bundle's 16 x 16 on the stage's
    device, then featurized."""
    x = _images(5, 24, 24, seed=2)
    _, got, _, want = _featurize(bundles, x, layer_name="pooled_features")
    g, w = np.asarray(got["f"]), np.asarray(want["f"])
    assert g.shape == w.shape == (5, 64)
    np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3 * max(1.0, np.abs(w).max()))


def test_resize_to_overrides_the_bundle_shape(bundles):
    x = _images(3, 16, 16, seed=3)
    _, got, _, want = _featurize(bundles, x, layer_name="pooled_features",
                                 resize_to=(8, 8))
    np.testing.assert_allclose(np.asarray(got["f"]), np.asarray(want["f"]), rtol=1e-3,
                               atol=1e-3 * max(1.0, np.abs(np.asarray(want["f"])).max()))


def test_output_is_float64_features_and_the_image_column_stays(bundles):
    x = _images(3, 24, 24, seed=4)
    _, got, _, _ = _featurize(bundles, x)
    assert got.meta("f")[SCORE_KIND] == "features"
    assert np.asarray(got["f"]).dtype == np.float64
    np.testing.assert_array_equal(got["image"], x)
    np.testing.assert_array_equal(got["id"], np.arange(3))


def test_feature_maps_are_flattened(bundles):
    """A spatial layer's (n, h, w, c) output comes back as (n, h * w * c)."""
    x = _images(2, 16, 16, seed=5)
    _, got, _, want = _featurize(bundles, x, layer_name="stage2_block0")
    g, w = np.asarray(got["f"]), np.asarray(want["f"])
    assert g.shape == w.shape == (2, 4 * 4 * 64)
    np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * max(1.0, np.abs(w).max()))


def test_without_a_model_raises():
    with pytest.raises(ValueError, match="no model"):
        ImageFeaturizer(device="cpu").transform(Table({"image": _images(1, 4, 4)}))
