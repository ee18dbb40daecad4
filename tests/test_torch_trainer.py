"""The port's DNNLearner against the JAX package's: the reference's
TestDNNLearner cases (tests/test_nn.py:168-330). Each keeps its own
assertion (accuracy, frozen leaves, ...) and is also held against the JAX
DNNLearner fitted from one carried-over `init_bundle`, with the same table,
seed, batches and step keys, at tests/test_torch_trainer_common.py's gate.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from mmlspark_tpu_torch.core import Table  # noqa: E402
from mmlspark_tpu_torch.nn import DNNModel  # noqa: E402
from test_torch_trainer_common import (  # noqa: E402
    BF16_TOL, assert_same_fit, fit_both, image_table, jax_init, vector_table)


class TestDNNLearner:
    def test_fit_mlp_learns(self):
        x, y = vector_table(n=512)
        jb = jax_init("mlp", (16,), features=(32,), num_outputs=2)
        jm, pm = fit_both(jb, x, y, epochs=20, batch_size=64, learning_rate=0.01,
                          bfloat16=False)
        assert isinstance(pm, DNNModel)
        assert (pm.transform(Table({"features": x}))["prediction"] == y).mean() > 0.9
        assert_same_fit(jm, pm, x)

    def test_bn_model_trains(self):
        x, y = image_table()
        jb = jax_init("resnet", (8, 8, 3), stage_sizes=(1,), num_filters=8, num_outputs=4)
        jm, pm = fit_both(jb, x, y, epochs=15, batch_size=32, learning_rate=0.01,
                          bfloat16=False)
        assert (pm.transform(Table({"features": x}))["prediction"] == y).mean() > 0.5
        assert "batch_stats" in pm.bundle.variables
        assert_same_fit(jm, pm, x)

    @pytest.mark.parametrize("impl", ["dense", "flash"])
    def test_transformer_sequence_task(self, impl):
        """The JAX package runs its flash core as the chunked tier off the
        TPU; the port runs K2's plain version and the ported backward."""
        rng = np.random.default_rng(7)
        x = rng.normal(size=(192, 12, 3)).astype(np.float32)
        y = (x[:, :, 0].mean(axis=1) > 0).astype(np.float64)
        jb = jax_init("transformer", (12, 3), num_layers=1, d_model=32, num_heads=2, d_ff=64,
                      attention_impl=impl, num_outputs=2)
        jm, pm = fit_both(jb, x, y, epochs=8, batch_size=64, learning_rate=3e-3,
                          bfloat16=False)
        acc = float((np.asarray(pm.transform(Table({"features": x}))["prediction"]) == y).mean())
        assert acc > 0.8, acc
        assert_same_fit(jm, pm, x)

    def test_transformer_dropout_and_bf16_params(self):
        """Dropout draws flax's masks, so the two fits stay together; bf16
        compute keeps f32 parameters (pos_embed included)."""
        rng = np.random.default_rng(8)
        x = rng.normal(size=(96, 8, 2)).astype(np.float32)
        y = (x[:, :, 0].mean(axis=1) > 0).astype(np.float64)
        jb = jax_init("transformer", (8, 2), num_layers=1, d_model=16, num_heads=2, d_ff=32,
                      dropout_rate=0.1, num_outputs=2, dtype=jnp.bfloat16)
        jm, pm = fit_both(jb, x, y, epochs=2, batch_size=32)
        assert pm.bundle.variables["params"]["pos_embed"].dtype == np.float32
        assert_same_fit(jm, pm, x, tol=BF16_TOL)

    def test_transformer_token_inputs(self):
        rng = np.random.default_rng(0)
        x = rng.integers(0, 50, size=(128, 10))
        y = (x[:, 0] >= 25).astype(np.float64)
        jb = jax_init("transformer", (10,), vocab_size=50, num_layers=1, d_model=16,
                      num_heads=2, d_ff=32, num_outputs=2)
        jm, pm = fit_both(jb, x, y, epochs=3, batch_size=32, learning_rate=3e-3,
                          bfloat16=False)
        feats = pm.set(fetch_dict={"feat": "pooled_features"})
        assert_same_fit(jm, pm, x)
        out = DNNModel.transform(feats, Table({"features": x}))
        assert np.asarray(out["raw_prediction"]).shape == (128, 2)

    def test_transfer_freeze(self):
        x, y = vector_table(n=128)
        jb = jax_init("mlp", (16,), features=(16,), num_outputs=2)
        before = np.array(jb.variables["params"]["dense_0"]["kernel"])
        head = np.array(jb.variables["params"]["head"]["kernel"])
        jm, pm = fit_both(jb, x, y, epochs=2, batch_size=32, bfloat16=False,
                          trainable_prefixes=["head"])
        after = pm.bundle.variables["params"]
        np.testing.assert_array_equal(after["dense_0"]["kernel"], before)
        assert not np.array_equal(after["head"]["kernel"], head)
        assert_same_fit(jm, pm, x)
