"""The port's superpixels and ImageLIME (automl/lime.py) held against the
JAX package's, on the CPU.

Superpixel labels equal the JAX package's except at pixels whose two
nearest final centres lie within a relative 1e-5 (an exact tie flips with
the summation order). `ImageLIME`'s weights are within 1e-9 of the JAX
package's when both explain the same host-numpy model (its scores do not
depend on the package), and two runs are bit-equal. tests/test_automl.py's
LIME cases run on the port.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu.automl import ImageLIME as JaxLIME  # noqa: E402
from mmlspark_tpu.automl import superpixels as jax_superpixels  # noqa: E402
from mmlspark_tpu.core.pipeline import PipelineStage as JaxStage  # noqa: E402
from mmlspark_tpu.core.schema import Table as JaxTable  # noqa: E402
from mmlspark_tpu_torch.automl import ImageLIME, SuperpixelTransformer, superpixels  # noqa: E402
from mmlspark_tpu_torch.automl.lime import slic_distances  # noqa: E402
from mmlspark_tpu_torch.core.pipeline import PipelineStage  # noqa: E402
from mmlspark_tpu_torch.core.schema import Table  # noqa: E402

NEAR = 1e-5


def near_ties(img, cell_size: int) -> np.ndarray:
    """Pixels whose two smallest squared distances lie within NEAR."""
    d = np.sort(slic_distances(img, cell_size=cell_size, device="cpu"), axis=-1)
    return (d[..., 1] - d[..., 0]) <= NEAR * np.maximum(d[..., 0], np.finfo(np.float32).tiny)


def images():
    rng = np.random.default_rng(0)
    return {
        "random_f32_32": rng.random((32, 32, 3)).astype(np.float32),
        "uint8_48x40": rng.integers(0, 256, (48, 40, 3)).astype(np.uint8),
        "blocks_f32_64": np.kron(rng.integers(0, 4, (4, 4, 3)) * 60.0,
                                 np.ones((16, 16, 1))).astype(np.float32),
        "rgba_uint8_40": rng.integers(0, 256, (40, 40, 4)).astype(np.uint8),
    }


class TestSuperpixels:
    @pytest.mark.parametrize("name", sorted(images()))
    @pytest.mark.parametrize("cell_size", [8, 16])
    def test_labels_match_the_jax_package_off_near_ties(self, name, cell_size):
        img = images()[name]
        want, k = jax_superpixels(img, cell_size=cell_size)
        got, k2 = superpixels(img, cell_size=cell_size, device="cpu")
        assert k == k2 and got.dtype == np.int32 and got.shape == img.shape[:2]
        differ = np.asarray(want) != got
        assert not (differ & ~near_ties(img, cell_size)).any(), int(differ.sum())
        assert got.max() < k

    def test_superpixel_transformer(self):
        imgs = np.random.default_rng(0).random((2, 16, 16, 3)).astype(np.float32)
        out = SuperpixelTransformer(cell_size=8, device="cpu").transform(Table({"image": imgs}))
        assert np.asarray(out["superpixels"]).shape == (2, 16, 16)


class PatchModel(PipelineStage):
    """Scores the top-left 8x8 patch mean (tests/test_automl.py's model),
    plus a second class from another patch: host numpy, so both
    packages' LIME see the same scores."""

    def transform(self, table):
        x = np.asarray(table["image"], np.float64)
        a = x[:, :8, :8, :].mean(axis=(1, 2, 3)) / 255.0
        b = x[:, 8:, 4:12, 1].mean(axis=(1, 2)) / 255.0
        return table.with_column("probability", np.stack([a, b], axis=1))


class JaxPatchModel(JaxStage):
    def transform(self, table):
        return PatchModel.transform(self, table)


class TestImageLIME:
    def test_finds_the_informative_region(self):
        class OneClass(PipelineStage):
            def transform(self, table):
                x = np.asarray(table["image"], np.float64)
                return table.with_column("probability", x[:, :8, :8, :].mean(axis=(1, 2, 3)))

        img = np.full((16, 16, 3), 200.0, np.float32)
        out = ImageLIME(model=OneClass(), cell_size=8, num_samples=64,
                        prediction_col="probability", seed=1, device="cpu").transform(
            Table({"image": img[None]}))
        w = np.asarray(out["weights"][0])
        labels = np.asarray(out["superpixels"])[0]
        assert np.argmax(w) == labels[2, 2]

    @pytest.mark.parametrize("target_class", [None, 1])
    def test_weights_match_the_jax_package(self, target_class):
        rng = np.random.default_rng(5)
        imgs = rng.integers(0, 256, (2, 24, 24, 3)).astype(np.float32)
        params = dict(cell_size=8, num_samples=120, prediction_col="probability", seed=4,
                      target_class=target_class)
        jout = JaxLIME(model=JaxPatchModel(), **params).transform(JaxTable({"image": imgs}))
        pout = ImageLIME(model=PatchModel(), device="cpu", **params).transform(
            Table({"image": imgs}))
        again = ImageLIME(model=PatchModel(), device="cpu", **params).transform(
            Table({"image": imgs}))
        jl, pl = np.asarray(jout["superpixels"]), np.asarray(pout["superpixels"])
        compared = 0
        for i in range(len(imgs)):
            differ = jl[i] != pl[i]
            assert not (differ & ~near_ties(imgs[i], 8)).any()
            if differ.any():
                continue        # a flipped tie changes that image's design matrix
            jw, pw = np.asarray(jout["weights"][i]), np.asarray(pout["weights"][i])
            assert pw.shape == jw.shape == (9,)
            assert np.all(np.abs(pw - jw) <= 1e-9)
            np.testing.assert_array_equal(np.asarray(again["weights"][i]), pw)
            compared += 1
        assert compared >= 1
