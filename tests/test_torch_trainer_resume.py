"""Checkpointed DNNLearner fits in the port (tests/test_nn.py:238-256 and
tests/test_elastic.py's TestDNNElastic): resumed and uninterrupted fits give
the same bytes, at an epoch boundary and mid-epoch, fused or streamed; a
seed mismatch ignores the snapshot. Snapshots resume across the packages in
both directions, and a bundle the port saves loads in the JAX package.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmlspark_tpu.core.schema import Table as JaxTable  # noqa: E402
from mmlspark_tpu.nn.models import ModelBundle as JaxBundle  # noqa: E402
from mmlspark_tpu.nn.trainer import DNNLearner as JaxLearner  # noqa: E402
from mmlspark_tpu_torch.core import Table  # noqa: E402
from mmlspark_tpu_torch.nn import DNNLearner  # noqa: E402
from mmlspark_tpu_torch.resilience.elastic import Preempted, set_active_guard  # noqa: E402
from test_torch_trainer_common import (  # noqa: E402
    BF16_TOL, TripGuard, assert_same_fit, carry, image_table, jax_init, port_bytes,
    vector_table)


@pytest.fixture(autouse=True)
def _no_leaked_guard():
    yield
    set_active_guard(None)


def _dnn(ckpt_dir=None, epochs=4, fused=True, seed=7, init=None):
    kw = dict(checkpoint_dir=ckpt_dir, checkpoint_every_n=1) if ckpt_dir else {}
    est = DNNLearner(architecture="mlp", model_config={"features": (16,)}, epochs=epochs,
                     batch_size=64, use_mesh=False, bfloat16=False, seed=seed,
                     fused_epochs=fused, device="cpu", **kw)
    est.init_bundle = init
    return est


class TestCheckpointResume:
    def test_checkpoint_resume(self, tmp_path):
        # tests/test_nn.py:238-256, and the resumed fit equals the
        # uninterrupted one byte for byte
        x, y = vector_table()
        tbl = Table({"features": x, "label": y})
        ck = str(tmp_path / "ckpts")
        _dnn(ck, epochs=3).fit(tbl)
        resumed = _dnn(ck, epochs=5).fit(tbl)
        assert "prediction" in resumed.transform(Table({"features": x})).columns
        assert port_bytes(resumed) == port_bytes(_dnn(epochs=5).fit(tbl))

    def test_epoch_boundary_resume_byte_identical(self, tmp_path):
        x, y = vector_table()
        tbl = Table({"features": x, "label": y})
        ref = port_bytes(_dnn().fit(tbl))
        ck = str(tmp_path / "ck")
        set_active_guard(TripGuard(3))
        with pytest.raises(Preempted) as ei:
            _dnn(ck).fit(tbl)
        assert ei.value.checkpoint_path
        set_active_guard(None)
        assert port_bytes(_dnn(ck).fit(tbl)) == ref

    @pytest.mark.parametrize("trip", [2, 5, 7])
    def test_mid_epoch_resume_byte_identical(self, tmp_path, trip):
        x, y = vector_table()
        tbl = Table({"features": x, "label": y})
        ref = port_bytes(_dnn(fused=False).fit(tbl))
        ck = str(tmp_path / "ck")
        set_active_guard(TripGuard(trip))
        with pytest.raises(Preempted):
            _dnn(ck, fused=False).fit(tbl)
        set_active_guard(None)
        assert port_bytes(_dnn(ck, fused=False).fit(tbl)) == ref
        # the fused path resumes the same mid-epoch cursor by streaming
        assert port_bytes(_dnn(ck).fit(tbl)) == ref

    def test_seed_mismatch_ignores_checkpoint(self, tmp_path):
        x, y = vector_table()
        tbl = Table({"features": x, "label": y})
        ck = str(tmp_path / "ck")
        _dnn(ck, epochs=2).fit(tbl)
        assert port_bytes(_dnn(ck, epochs=2, seed=99).fit(tbl)) == \
            port_bytes(_dnn(epochs=2, seed=99).fit(tbl))

    @pytest.mark.parametrize("writer", ["jax", "port"])
    @pytest.mark.parametrize("frozen", [False, True], ids=["all", "freeze"])
    def test_snapshots_resume_across_packages(self, tmp_path, writer, frozen):
        """One package fits 2 epochs with snapshots; the other resumes them
        to 4 and lands on the first package's uninterrupted 4-epoch fit
        (optimizer moments and BatchNorm statistics carried). A BN model
        with adamw and, once, a frozen stem."""
        x, y = image_table(n=64, hw=6)
        jb = jax_init("resnet", (6, 6, 3), stage_sizes=(1,), num_filters=4, num_outputs=4)
        kw = dict(epochs=2, batch_size=32, use_mesh=False, bfloat16=False, seed=3,
                  optimizer="adamw", learning_rate=0.01, checkpoint_dir=str(tmp_path / "ck"),
                  trainable_prefixes=["stage0", "head"] if frozen else None)

        def jax_fit(**over):
            est = JaxLearner(architecture="resnet", **{**kw, **over})
            est.init_bundle = jb
            return est.fit(JaxTable({"features": x, "label": y}))

        def port_fit(**over):
            est = DNNLearner(architecture="resnet", device="cpu", **{**kw, **over})
            est.init_bundle = carry(jb)
            return est.fit(Table({"features": x, "label": y}))

        first, second = (jax_fit, port_fit) if writer == "jax" else (port_fit, jax_fit)
        first()
        resumed = second(epochs=4)
        ref = first(epochs=4, checkpoint_dir=None)
        jm, pm = (ref, resumed) if writer == "jax" else (resumed, ref)
        assert_same_fit(jm, pm, x)

    def test_bundle_saved_by_the_port_loads_in_the_jax_package(self, tmp_path):
        x, y = image_table(n=32, hw=6)
        pm = DNNLearner(architecture="resnet", model_config={"stage_sizes": (1,),
                                                             "num_filters": 4},
                        epochs=1, batch_size=16, use_mesh=False, device="cpu"
                        ).fit(Table({"features": x, "label": y}))
        path = str(tmp_path / "m.bundle")
        pm.bundle.save(path)
        jb = JaxBundle.load(path)
        assert jb.config["dtype"] == "bfloat16"
        ref = np.asarray(jax.jit(jb.module.apply)(jb.variables, jnp.asarray(x)))
        got = np.asarray(pm.transform(Table({"features": x}))["raw_prediction"])
        np.testing.assert_allclose(got, ref, rtol=BF16_TOL, atol=BF16_TOL)
