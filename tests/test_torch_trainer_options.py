"""The port's DNNLearner options against the JAX package's: every
optimizer, the squared loss, remat (tests/test_nn.py:222-236), fused epochs
(:204-220), small tables (:396-410), and the refusals. Fits held against the
JAX package at tests/test_torch_trainer_common.py's gate; remat against no
remat and fused against streamed byte for byte.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)


from mmlspark_tpu.core.schema import Table as JaxTable  # noqa: E402
from mmlspark_tpu.nn.trainer import DNNLearner as JaxLearner  # noqa: E402
from mmlspark_tpu_torch.core import Table  # noqa: E402
from mmlspark_tpu_torch.nn import DNNLearner  # noqa: E402
from test_torch_trainer_common import (  # noqa: E402
    ATOL, RTOL, assert_same_fit, carry, fit_both, jax_init, port_bytes, vector_table)


class TestDNNLearnerOptions:
    @pytest.mark.parametrize("optimizer", ["adamw", "sgd", "momentum", "rmsprop"])
    def test_every_optimizer_trains_as_the_jax_package(self, optimizer):
        x, y = vector_table(n=128, seed=4)
        jb = jax_init("mlp", (16,), features=(16,), num_outputs=2)
        jm, pm = fit_both(jb, x, y, epochs=2, batch_size=32, bfloat16=False,
                          optimizer=optimizer, learning_rate=0.05)
        assert_same_fit(jm, pm, x)

    def test_mse_regression(self):
        x, y = vector_table(n=128, seed=5)
        y = x[:, 0] * 2.0 - x[:, 1]
        jb = jax_init("mlp", (16,), features=(16,), num_outputs=1)
        jm, pm = fit_both(jb, x, y, epochs=2, batch_size=32, bfloat16=False, loss="mse")
        pred = np.asarray(pm.transform(Table({"features": x}))["prediction"])
        want = np.asarray(jm.transform(JaxTable({"features": x}))["prediction"])
        assert pred.shape == (128,)
        np.testing.assert_allclose(pred, want, rtol=RTOL, atol=ATOL)

    def test_remat_trains_identically(self):
        """remat and no remat give the same bytes, and the JAX package's
        remat fit (a BN model: the mutable-stats remat path)."""
        rng = np.random.default_rng(11)
        x = rng.normal(size=(64, 8, 8, 3)).astype(np.float32)
        y = (x[:, :, :, 0].mean(axis=(1, 2)) > 0).astype(np.float64)
        config = dict(stage_sizes=(1, 1), num_filters=4, num_outputs=2)
        jb = jax_init("resnet", (8, 8, 3), **config)
        fits = {}
        for remat in (False, True):
            est = DNNLearner(architecture="resnet", epochs=1, batch_size=32, seed=5,
                             use_mesh=False, bfloat16=False, remat=remat, device="cpu")
            est.init_bundle = carry(jb)
            fits[remat] = est.fit(Table({"features": x, "label": y}))
        assert port_bytes(fits[True]) == port_bytes(fits[False])
        ref = JaxLearner(architecture="resnet", epochs=1, batch_size=32, seed=5,
                         use_mesh=False, bfloat16=False, remat=True)
        ref.init_bundle = jb
        assert_same_fit(ref.fit(JaxTable({"features": x, "label": y})), fits[True], x)

    def test_init_bundle_path_warm_start(self, tmp_path):
        """A bundle file the JAX package saved starts both fits."""
        x, y = vector_table(n=128, seed=6)
        path = str(tmp_path / "init.bundle")
        jax_init("mlp", (16,), features=(16,), num_outputs=2).save(path)
        params = dict(architecture="mlp", epochs=2, batch_size=32, bfloat16=False,
                      use_mesh=False, init_bundle_path=path)
        jm = JaxLearner(**params).fit(JaxTable({"features": x, "label": y}))
        pm = DNNLearner(device="cpu", **params).fit(Table({"features": x, "label": y}))
        assert_same_fit(jm, pm, x)

    def test_fused_epochs_match_per_step_loop(self):
        rng = np.random.default_rng(9)
        x = rng.normal(size=(96, 10)).astype(np.float32)
        y = (x[:, 0] > 0).astype(np.float64)

        def fit(fused):
            return DNNLearner(architecture="mlp", epochs=2, batch_size=32, seed=3,
                              use_mesh=False, bfloat16=False, fused_epochs=fused,
                              device="cpu").fit(Table({"features": x, "label": y}))

        assert port_bytes(fit(True)) == port_bytes(fit(False))

    def test_small_table_still_trains(self):
        # tests/test_nn.py:396-410: batch_size > n still takes steps
        x, y = vector_table(n=50)
        model = DNNLearner(architecture="mlp", model_config={"features": (16,)}, epochs=30,
                           batch_size=128, learning_rate=0.02, use_mesh=False, bfloat16=False,
                           device="cpu").fit(Table({"features": x, "label": y}))
        assert (model.transform(Table({"features": x}))["prediction"] == y).mean() > 0.8

    def test_elastic_workers_and_missing_card_raise(self):
        x, y = vector_table(n=32)
        with pytest.raises(NotImplementedError, match="item 15"):
            DNNLearner(elastic_workers=2, device="cpu").fit(Table({"features": x, "label": y}))
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="cuda"):
                DNNLearner(use_mesh=False).fit(Table({"features": x, "label": y}))
