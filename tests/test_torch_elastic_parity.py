"""The port's elastic fits held against the JAX package's on the CPU.

- `parallel.dp` is a copy: its outputs equal the reference's byte for
  byte on the same seeded inputs;
- the elastic GBDT is the same numpy on the same BinMapper boundaries, so
  its `model_digest` equals the reference's byte for byte at P=1, at P=3
  and under the kill/add hook;
- a DNN `grad` request with the same flat params goes to a reference
  worker and to a port worker: each shard's partial and loss agree within
  the trainer gate (rtol 2e-4, atol 2e-5), and a 6-step elastic fit from
  the reference's initial variables ends within it too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu.core.schema import Table as RefTable  # noqa: E402
from mmlspark_tpu.io_http.schema import HTTPRequestData as RefRequest  # noqa: E402
from mmlspark_tpu.parallel import dp as ref_dp  # noqa: E402
from mmlspark_tpu.resilience import elastic_fleet as ref_ef  # noqa: E402
from mmlspark_tpu_torch.core.schema import Table  # noqa: E402
from mmlspark_tpu_torch.io_http.schema import HTTPRequestData  # noqa: E402
from mmlspark_tpu_torch.parallel import dp  # noqa: E402
from mmlspark_tpu_torch.resilience.elastic_fleet import ElasticWorkerFactory  # noqa: E402

from test_torch_elastic_common import (DNN_KW, GBDT_KW, LocalFleet, cls_data,  # noqa: E402
                                       dnn_fit, gbdt_fit, kill_add_hook, post_fn, raw_post,
                                       reg_data)

RTOL, ATOL = 2e-4, 2e-5


def _ref_fleet(d):
    fleet = LocalFleet(d, factory=ref_ef.ElasticWorkerFactory)
    return fleet, post_fn(fleet, RefRequest, RefTable)


def ref_gbdt_fit(d, x, y, n_workers, *, iters=5, hook=None):
    fleet, post = _ref_fleet(d)
    fit = ref_ef.ElasticGBDTFit(d, num_iterations=iters, n_workers=n_workers, num_virtual=8,
                                fleet=fleet, post=post, step_hook=hook, **GBDT_KW)
    for _ in range(n_workers):
        fleet.add()
    return fit, fit.fit(x, y)


def ref_dnn_fit(d, x, y, n_workers, *, epochs=1):
    fleet, post = _ref_fleet(d)
    fit = ref_ef.ElasticDNNFit(d, epochs=epochs, n_workers=n_workers, num_virtual=8,
                               fleet=fleet, post=post, **DNN_KW)
    for _ in range(n_workers):
        fleet.add()
    return fit, fit.fit(x, y)


def _ref_flat(params) -> np.ndarray:
    from jax.flatten_util import ravel_pytree

    vec, _ = ravel_pytree(params)
    return np.asarray(vec, np.float32)


class TestDpIsACopy:
    def test_shard_math_and_codec(self):
        for n, v in ((64, 16), (1000, 32), (7, 3)):
            assert dp.shard_assignment(n, v).tobytes() == ref_dp.shard_assignment(n, v).tobytes()
        for world in (1, 3, 5):
            for r in range(world):
                assert dp.shards_of_member(r, world, 32) == ref_dp.shards_of_member(r, world, 32)
        assert dp.global_batch_order(100, 8, 3, 7).tobytes() == \
            ref_dp.global_batch_order(100, 8, 3, 7).tobytes()
        a = np.random.default_rng(1).normal(size=(3, 5)).astype(np.float32)
        assert dp.encode_array(a) == ref_dp.encode_array(a)

    def test_histograms_splits_and_folds(self):
        rng = np.random.default_rng(3)
        n, f, nb = 500, 6, 16
        bins = rng.integers(0, nb, size=(n, f)).astype(np.int32)
        grad, hess = rng.normal(size=n), rng.uniform(0.1, 1.0, size=n)
        node = rng.integers(0, 4, size=n).astype(np.int32)
        got = dp.hist_partial(bins, grad, hess, node, [3, 0, 1], nb)
        want = ref_dp.hist_partial(bins, grad, hess, node, [3, 0, 1], nb)
        assert got.tobytes() == want.tobytes()
        parent = tuple(float(v) for v in got[0, 0].sum(axis=0))
        for kw in ({}, {"lambda_l2": 1.0, "min_data_in_leaf": 5}):
            assert dp.best_split(got[0], parent, **kw) == ref_dp.best_split(want[0], parent, **kw)
        parts = {s: rng.normal(size=(4, 3)) for s in (5, 1, 9)}
        assert dp.fold_partials(parts, 16).tobytes() == ref_dp.fold_partials(parts, 16).tobytes()
        assert dp.leaf_value(1.5, 2.0, lambda_l2=0.5, learning_rate=0.1) == \
            ref_dp.leaf_value(1.5, 2.0, lambda_l2=0.5, learning_rate=0.1)


class TestGBDTDigest:
    @pytest.mark.parametrize("world", [1, 3])
    def test_model_digest_equals_the_reference(self, tmp_path, world):
        x, y = reg_data()
        port, booster = gbdt_fit(str(tmp_path / "port"), x, y, world)
        ref, ref_booster = ref_gbdt_fit(str(tmp_path / "ref"), x, y, world)
        assert port.model_digest() == ref.model_digest()
        np.testing.assert_allclose(booster.predict(x), np.asarray(ref_booster.predict(x)),
                                   rtol=1e-6, atol=1e-6)

    def test_kill_and_add_digest_equals_the_reference_calm_fit(self, tmp_path):
        x, y = reg_data()
        ref, _ = ref_gbdt_fit(str(tmp_path / "ref"), x, y, 1, iters=6)
        port, _ = gbdt_fit(str(tmp_path / "chaos"), x, y, 2, iters=6,
                           hook=kill_add_hook(2, 4))
        assert port.model_digest() == ref.model_digest()
        causes = [r["cause"] for r in port.reshards]
        assert "death" in causes and "join" in causes

    def test_binary_objective(self, tmp_path):
        rng = np.random.default_rng(2)
        x = rng.normal(size=(200, 5))
        y = (x[:, 0] - x[:, 2] > 0).astype(np.float64)
        port, _ = gbdt_fit(str(tmp_path / "port"), x, y, 2, objective="binary")
        fleet, post = _ref_fleet(str(tmp_path / "ref"))
        ref = ref_ef.ElasticGBDTFit(str(tmp_path / "ref"), num_iterations=5, n_workers=2,
                                    num_virtual=8, fleet=fleet, post=post,
                                    **{**GBDT_KW, "objective": "binary"})
        fleet.add(), fleet.add()
        ref.fit(x, y)
        assert port.model_digest() == ref.model_digest()


class TestDNNParity:
    def test_one_grad_request_matches_a_reference_worker(self, tmp_path):
        x, y = cls_data()
        # one driver of each package writes its spec (a one-step fit)
        ref_fit, _ = ref_dnn_fit(str(tmp_path / "ref"), x, y, 1, epochs=1)
        port_fit, _ = dnn_fit(str(tmp_path / "port"), x, y, 1, epochs=1)
        params = _ref_flat(ref_fit._params)
        body = {"op": "grad", "world_epoch": 1, "step": 0,
                "params": dp.encode_array(params),
                "batch": [int(r) for r in dp.global_batch_order(len(y), 8, 1, 0)[0]]}
        conf = {"op": "configure", "world_epoch": 1, "shards": list(range(8))}
        ref_h = ref_ef.ElasticWorkerFactory(str(tmp_path / "ref"), guard=False)()
        port_h = ElasticWorkerFactory(str(tmp_path / "port"), guard=False)()
        docs = []
        for h, table, req in ((ref_h, RefTable, RefRequest), (port_h, Table, HTTPRequestData)):
            for b in (conf, body):
                code, doc = raw_post(h, b, table, req)
                assert code == 200, doc
            docs.append(doc)
        ref_doc, port_doc = docs
        assert set(ref_doc["partials"]) == set(port_doc["partials"]) and ref_doc["partials"]
        for s in ref_doc["partials"]:
            np.testing.assert_allclose(dp.decode_array(port_doc["partials"][s]),
                                       ref_dp.decode_array(ref_doc["partials"][s]),
                                       rtol=RTOL, atol=ATOL)
            assert port_doc["loss"][s][1] == ref_doc["loss"][s][1]
            np.testing.assert_allclose(port_doc["loss"][s][0], ref_doc["loss"][s][0],
                                       rtol=RTOL, atol=ATOL)

    def test_six_step_fit_from_the_reference_init(self, tmp_path):
        x, y = cls_data()
        ref_fit, ref_bundle = ref_dnn_fit(str(tmp_path / "ref"), x, y, 2, epochs=1)
        from mmlspark_tpu.nn.models import ModelBundle as RefBundle

        init = RefBundle.init("mlp", x.shape[1:], seed=0, features=[8], num_outputs=2)
        port_fit, bundle = dnn_fit(str(tmp_path / "port"), x, y, 3, epochs=1,
                                   init_variables={"params": init.variables["params"]})
        assert port_fit.step == ref_fit.step == 6
        np.testing.assert_allclose(port_fit.params_flat(), _ref_flat(ref_fit._params),
                                   rtol=RTOL, atol=ATOL)
        # the returned bundle holds the same parameters as the flat vector
        np.testing.assert_allclose(
            np.asarray(bundle.variables["params"]["head"]["kernel"]),
            np.asarray(ref_bundle.variables["params"]["head"]["kernel"]),
            rtol=RTOL, atol=ATOL)
