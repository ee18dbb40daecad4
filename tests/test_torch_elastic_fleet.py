"""The port's elastic data-parallel training (resilience/elastic_fleet.py):
tests/test_elastic_fleet.py's fast tier on the port's modules — the shard
math of the copied `parallel.dp`, the worker protocol (world-epoch fence,
preemption drain), digest parity at any world size and under kill/add,
resume, the zombie fence, autoscaler wiring, metrics and the diagnose
table — through in-process handlers on the CPU. The slow tier repeats the
chaos schedule against real `ServingFleet` worker processes.
"""

import hashlib
import json
import os
import signal
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu_torch.core.schema import Table  # noqa: E402
from mmlspark_tpu_torch.io_http.autoscale import FleetAutoscaler  # noqa: E402
from mmlspark_tpu_torch.observability.fleet import GAUGE_MERGE_POLICIES  # noqa: E402
from mmlspark_tpu_torch.observability.metrics import (MetricsRegistry,  # noqa: E402
                                                      set_default_registry)
from mmlspark_tpu_torch.parallel import dp  # noqa: E402
from mmlspark_tpu_torch.resilience.elastic import TrainingCheckpointer  # noqa: E402
from mmlspark_tpu_torch.resilience.elastic_fleet import (WORLD_SIZE_GAUGE,  # noqa: E402
                                                         ElasticDNNFit, ElasticGBDTFit,
                                                         ElasticWorkerFactory, FlatParams)
from mmlspark_tpu_torch.resilience.policy import FakeClock  # noqa: E402

from test_torch_elastic_common import (cls_data, dnn_fit, gbdt_fit,  # noqa: E402
                                       kill_add_hook, raw_post, reg_data)


# --------------------------------------------------------------------- #
# dp: the partition-invariant shard math                                #
# --------------------------------------------------------------------- #


class TestShardMath:
    def test_virtual_shard_is_content_addressed(self):
        for rid in (0, 1, 17, 123456789):
            want = int.from_bytes(hashlib.blake2b(
                str(rid).encode(), digest_size=8).digest(), "big") % 32
            assert dp.virtual_shard_of(rid, 32) == want
        a = dp.shard_assignment(64, 16)
        assert a.dtype == np.int32 and a.shape == (64,)
        assert all(a[i] == dp.virtual_shard_of(i, 16) for i in range(64))

    @pytest.mark.parametrize("world", [1, 2, 3, 4, 5, 7])
    def test_shards_partition_exactly(self, world):
        owned = [dp.shards_of_member(r, world, 32) for r in range(world)]
        flat = [s for lst in owned for s in lst]
        assert sorted(flat) == list(range(32))
        for r, lst in enumerate(owned):
            for s in lst:
                assert dp.owner_of_shard(s, world) == r

    def test_rank_outside_world_raises(self):
        with pytest.raises(ValueError):
            dp.shards_of_member(3, 3, 32)
        with pytest.raises(ValueError):
            dp.owner_of_shard(0, 0)

    def test_fold_partials_ignores_insertion_order(self):
        rng = np.random.default_rng(0)
        parts = {s: rng.normal(size=5) for s in (9, 0, 3, 14)}
        a = dp.fold_partials(dict(sorted(parts.items())), 16)
        b = dp.fold_partials(dict(reversed(sorted(parts.items()))), 16)
        assert a.tobytes() == b.tobytes()
        with pytest.raises(ValueError):
            dp.fold_partials({}, 16)

    def test_global_batch_order_matches_trainer_stream(self):
        order = dp.global_batch_order(10, 4, 2, seed=7)
        assert order.shape == (4, 4) and order.dtype == np.int64
        rng = np.random.default_rng(7)
        want = []
        for _ in range(2):
            perm = rng.permutation(10)
            want += [perm[0:4], perm[4:8]]
        np.testing.assert_array_equal(order, np.stack(want))
        np.testing.assert_array_equal(order, dp.global_batch_order(10, 4, 2, 7))

    def test_global_batch_order_small_n_clamps_batch(self):
        order = dp.global_batch_order(3, 8, 1, seed=0)
        assert order.shape == (1, 3)
        assert sorted(order[0].tolist()) == [0, 1, 2]

    def test_wire_codec_roundtrip(self):
        for a in (np.arange(12, dtype=np.float32).reshape(3, 4),
                  np.array([1, -2, 3], np.int64), np.zeros((2, 0), np.float64)):
            b = dp.decode_array(dp.encode_array(a))
            assert b.dtype == a.dtype and b.shape == a.shape
            np.testing.assert_array_equal(a, b)

    def test_hist_partial_matches_naive_reference(self):
        rng = np.random.default_rng(3)
        n, f, nb = 40, 3, 6
        bins = rng.integers(0, nb, size=(n, f)).astype(np.int32)
        grad = rng.normal(size=n)
        hess = rng.uniform(0.1, 1.0, size=n)
        node = rng.integers(0, 3, size=n).astype(np.int32)
        got = dp.hist_partial(bins, grad, hess, node, [2, 0], nb)
        assert got.shape == (2, f, nb, 3)
        want = np.zeros_like(got)
        for slot, nd in enumerate([0, 2]):
            for i in range(n):
                if node[i] != nd:
                    continue
                for j in range(f):
                    want[slot, j, bins[i, j]] += [grad[i], hess[i], 1]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)

    def test_best_split_picks_first_max_and_honors_floors(self):
        hist = np.zeros((1, 3, 3))
        hist[0, 0] = [-4.0, 4.0, 4.0]
        hist[0, 2] = [4.0, 4.0, 4.0]
        parent = (0.0, 8.0, 8.0)
        sp = dp.best_split(hist, parent, min_data_in_leaf=1)
        assert (sp["feature"], sp["bin"]) == (0, 0)
        assert sp["gain"] == pytest.approx(4.0)
        assert sp["left"] == (-4.0, 4.0, 4.0) and sp["right"] == (4.0, 4.0, 4.0)
        assert dp.best_split(hist, parent, min_data_in_leaf=5) is None
        assert dp.best_split(hist[:, :1, :], parent) is None

    def test_tree_builder_roundtrip_through_walk(self):
        t = dp.TreeBuilder(5)
        left, right = t.alloc_pair()
        t.set_split(0, feature=1, threshold_bin=2, left=left, right=right, gain=1.0)
        t.set_leaf(left, -0.5)
        t.set_leaf(right, 0.5)
        bins = np.array([[0, 1], [0, 4]], np.int32)
        np.testing.assert_allclose(dp.walk_tree_dict(t.to_dict(), bins), [-0.5, 0.5])


# --------------------------------------------------------------------- #
# zombie fencing in TrainingCheckpointer.load_latest                    #
# --------------------------------------------------------------------- #


class TestZombieFence:
    def _store(self, tmp_path):
        ck = TrainingCheckpointer(str(tmp_path / "ck"))
        for epoch in (1, 2, 3):
            ck.save(f"epoch-{epoch}".encode(), tag=f"e{epoch}",
                    meta={"world_epoch": epoch, "kind": "gbdt"})
        return ck

    def test_newer_world_epoch_is_refused(self, tmp_path):
        ck = self._store(tmp_path)
        assert ck.load_latest()[0] == b"epoch-3"
        payload, entry = ck.load_latest(max_world_epoch=2)
        assert payload == b"epoch-2" and entry["meta"]["world_epoch"] == 2
        assert ck.load_latest(max_world_epoch=0) is None

    def test_refusals_are_counted(self, tmp_path):
        ck = self._store(tmp_path)
        reg = MetricsRegistry()
        old = set_default_registry(reg)
        try:
            ck.load_latest(max_world_epoch=1)
        finally:
            set_default_registry(old)
        assert "mmlspark_tpu_checkpoint_refused_total 2" in reg.render_prometheus()


# --------------------------------------------------------------------- #
# worker protocol: fencing, errors, preemption drain                    #
# --------------------------------------------------------------------- #


def _spec_dir(tmp_path):
    """A checkpoint dir holding a real GBDT spec (written by a micro-fit)
    that fresh handlers can lazy-load."""
    d = str(tmp_path / "proto")
    x, y = reg_data(n=40)
    gbdt_fit(d, x, y, 1, iters=1, num_virtual=4)
    return d


def _configured(tmp_path, epoch=7):
    h = ElasticWorkerFactory(_spec_dir(tmp_path), guard=False)()
    code, doc = raw_post(h, {"op": "configure", "world_epoch": epoch,
                             "shards": [0, 1, 2, 3],
                             "model": {"init_score": 0.0, "trees": []}})
    assert code == 200 and doc == {"ok": True, "world_epoch": epoch}
    return h


class TestWorkerProtocol:
    def test_configure_status_roundtrip(self, tmp_path):
        h = _configured(tmp_path)
        code, doc = raw_post(h, {"op": "status"})
        assert code == 200
        assert doc["kind"] == "gbdt" and doc["world_epoch"] == 7
        assert doc["shards"] == [0, 1, 2, 3]
        assert set(doc["counters"]) == {"builds", "hits"}
        assert doc["counters"]["builds"] >= 1        # the worker binned its table

    def test_stale_epoch_is_fenced_not_computed(self, tmp_path):
        h = _configured(tmp_path)
        code, doc = raw_post(h, {"op": "hist", "world_epoch": 6, "nodes": [0], "step": 0})
        assert code == 200 and doc.get("stale") is True and doc["world_epoch"] == 7

    def test_unknown_op_is_a_500_reply_not_a_crash(self, tmp_path):
        h = _configured(tmp_path)
        code, doc = raw_post(h, {"op": "frobnicate", "world_epoch": 7})
        assert code == 500 and "unknown op" in doc["error"]
        assert raw_post(h, {"op": "status"})[0] == 200

    def test_preemption_drain_finishes_reply_then_exits_75(self, tmp_path):
        exits = []

        class _Factory(ElasticWorkerFactory):
            _exit = staticmethod(exits.append)

        old_handler = signal.getsignal(signal.SIGTERM)
        try:
            h = _Factory(_spec_dir(tmp_path), guard=True)()
            os.kill(os.getpid(), signal.SIGTERM)
            code, _ = raw_post(h, {"op": "status"})
            assert code == 200
            deadline = time.monotonic() + 5.0
            while not exits and time.monotonic() < deadline:
                time.sleep(0.02)
            assert exits == [75]
        finally:
            signal.signal(signal.SIGTERM, old_handler)

    def test_missing_spec_is_an_error_reply(self, tmp_path):
        h = ElasticWorkerFactory(str(tmp_path / "nowhere"), guard=False)()
        code, doc = raw_post(h, {"op": "configure", "world_epoch": 1, "shards": [0]})
        assert code == 500 and "error" in doc


# --------------------------------------------------------------------- #
# driver: digest parity at any world size, chaos, resume                #
# --------------------------------------------------------------------- #


class TestDigestParity:
    def test_gbdt_p1_vs_p3_byte_identical(self, tmp_path):
        x, y = reg_data()
        fit1, b1 = gbdt_fit(str(tmp_path / "p1"), x, y, 1)
        fit3, b3 = gbdt_fit(str(tmp_path / "p3"), x, y, 3)
        assert fit1.model_digest() == fit3.model_digest()
        np.testing.assert_array_equal(b1.predict(x), b3.predict(x))
        assert np.sqrt(np.mean((b1.predict(x) - y) ** 2)) < np.std(y)

    def test_dnn_p1_vs_p4_byte_identical(self, tmp_path):
        x, y = cls_data()
        fit1, _ = dnn_fit(str(tmp_path / "p1"), x, y, 1)
        fit4, _ = dnn_fit(str(tmp_path / "p4"), x, y, 4)
        assert fit1.params_digest() == fit4.params_digest()
        assert fit1.step == fit4.step > 0

    def test_gbdt_chaos_kill_and_add_digest_identical(self, tmp_path):
        x, y = reg_data()
        fit1, _ = gbdt_fit(str(tmp_path / "calm"), x, y, 1, iters=6)
        fitc, _ = gbdt_fit(str(tmp_path / "chaos"), x, y, 2, iters=6,
                           hook=kill_add_hook(2, 4))
        assert fitc.model_digest() == fit1.model_digest()
        causes = [r["cause"] for r in fitc.reshards]
        assert "death" in causes and "join" in causes

    def test_dnn_chaos_kill_and_add_digest_identical(self, tmp_path):
        x, y = cls_data()
        fit1, _ = dnn_fit(str(tmp_path / "calm"), x, y, 1)
        fitc, _ = dnn_fit(str(tmp_path / "chaos"), x, y, 2, hook=kill_add_hook(3, 6))
        assert fitc.params_digest() == fit1.params_digest()
        causes = [r["cause"] for r in fitc.reshards]
        assert "death" in causes and "join" in causes

    def test_gbdt_resume_from_checkpoint_same_digest(self, tmp_path):
        d = str(tmp_path / "resume")
        x, y = reg_data()
        first, _ = gbdt_fit(d, x, y, 2, iters=6, checkpoint_every_n=3)
        second, _ = gbdt_fit(d, x, y, 2, iters=6, checkpoint_every_n=3)
        assert second.reshards[0]["cause"] == "resume"
        assert second.model_digest() == first.model_digest()
        assert second.world_epoch > first.world_epoch

    def test_dnn_resume_from_checkpoint_same_digest(self, tmp_path):
        d = str(tmp_path / "resume")
        x, y = cls_data()
        calm, _ = dnn_fit(str(tmp_path / "calm"), x, y, 1)
        # a first fit that stops at step 5: its step-5 snapshot resumes
        stop = {"at": 5}

        def hook(fit):
            if fit.step == stop["at"]:
                raise KeyboardInterrupt

        with pytest.raises(KeyboardInterrupt):
            dnn_fit(d, x, y, 2, hook=hook, checkpoint_every_n=5)
        second, _ = dnn_fit(d, x, y, 2)
        assert second.reshards[0]["cause"] == "resume"
        assert second.params_digest() == calm.params_digest()

    def test_ctor_validation(self, tmp_path):
        with pytest.raises(ValueError, match="checkpoint_dir"):
            ElasticGBDTFit("")
        with pytest.raises(ValueError, match="n_workers"):
            ElasticGBDTFit(str(tmp_path / "a"), n_workers=0)
        with pytest.raises(ValueError, match="num_virtual"):
            ElasticGBDTFit(str(tmp_path / "b"), n_workers=4, num_virtual=2)
        with pytest.raises(ValueError, match="objective"):
            ElasticGBDTFit(str(tmp_path / "c"), objective="poisson")

    def test_cuda_without_a_card_raises_before_the_spec(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        d = str(tmp_path / "nocard")
        x, y = cls_data()
        fit = ElasticDNNFit(d, fleet=object(), post=lambda url, body: None)
        with pytest.raises(RuntimeError, match="cuda"):
            fit.fit(x, y)
        assert not os.path.exists(os.path.join(d, "spec.json"))

    def test_estimator_param_validation(self, tmp_path):
        from mmlspark_tpu_torch.gbdt.estimators import GBDTClassifier, GBDTRegressor
        from mmlspark_tpu_torch.nn.models import ModelBundle
        from mmlspark_tpu_torch.nn.trainer import DNNLearner

        x, y = reg_data(n=32)
        t = Table({"features": x, "label": y})
        with pytest.raises(ValueError, match="bagging"):
            GBDTRegressor(elastic_workers=1, bagging_fraction=0.5, device="cpu",
                          checkpoint_dir=str(tmp_path / "g")).fit(t)
        with pytest.raises(ValueError, match="feature_fraction"):
            GBDTRegressor(elastic_workers=1, feature_fraction=0.5, device="cpu",
                          checkpoint_dir=str(tmp_path / "g2")).fit(t)
        with pytest.raises(ValueError, match="binary"):
            GBDTClassifier(elastic_workers=1, objective="multiclass", device="cpu",
                           checkpoint_dir=str(tmp_path / "g3")).fit(
                Table({"features": x, "label": (x[:, 0] > 0).astype(np.float64)}))
        learner = DNNLearner(elastic_workers=1, device="cpu",
                             checkpoint_dir=str(tmp_path / "d"))
        learner.init_bundle = ModelBundle.init("mlp", (4,), features=[4], num_outputs=2)
        with pytest.raises(ValueError, match="warm start"):
            learner.fit(Table({"features": x.astype(np.float32),
                               "label": (y > 0).astype(np.int64)}))
        with pytest.raises(ValueError, match="trainable_prefixes"):
            DNNLearner(elastic_workers=1, device="cpu", trainable_prefixes=["head"],
                       checkpoint_dir=str(tmp_path / "d2")).fit(
                Table({"features": x.astype(np.float32),
                       "label": (y > 0).astype(np.int64)}))


class TestFlatParams:
    @pytest.mark.parametrize("arch,shape,cfg", [
        ("mlp", (5,), {"features": [7, 3], "num_outputs": 2}),
        ("simple_cnn", (8, 8, 1), {"num_outputs": 3}),
    ])
    def test_flat_is_the_sorted_flax_leaves_and_inverts(self, arch, shape, cfg):
        from mmlspark_tpu_torch.nn.carry import module_variables
        from mmlspark_tpu_torch.nn.models import ModelBundle
        from mmlspark_tpu_torch.resilience.elastic_fleet import _sorted_leaves

        module = ModelBundle.init(arch, shape, seed=3, **cfg).module
        flat = FlatParams(module)
        params = [p.detach() for _, p in module.named_parameters()]
        vec = flat.flatten(params).numpy()
        want = np.concatenate([np.asarray(leaf).reshape(-1) for leaf in
                               _sorted_leaves(module_variables(module)["params"])])
        assert vec.tobytes() == want.astype(np.float32).tobytes()
        back = flat.unflatten(torch.as_tensor(vec))
        for a, b in zip(back, params):
            assert torch.equal(a, b)


# --------------------------------------------------------------------- #
# autoscaler wiring + metrics + diagnose table                          #
# --------------------------------------------------------------------- #


class _StubFleet:
    def __init__(self, n=1):
        self.n = n

    n_live = property(lambda self: self.n)

    def dead_slots(self):
        return []

    def scale_to(self, n):
        self.n = n
        return []


def _training_sig(**over):
    sig = {"queue_depth": 0.0, "p99_latency_s": 0.0, "shed_rate": 0.0,
           "burn_rate": 0.0, "step_p99_latency_s": 0.0, "straggler_wait_s": 0.0}
    sig.update(over)
    return sig


class TestAutoscalerWiring:
    def _scaler(self, fleet, sig, **kw):
        kw.setdefault("hysteresis_ticks", 2)
        kw.setdefault("cooldown_s", 30.0)
        return FleetAutoscaler(fleet, lambda: dict(sig), clock=FakeClock(), **kw)

    @pytest.mark.parametrize("key,value", [
        ("step_p99_latency_s", 2.0), ("straggler_wait_s", 0.9)])
    def test_training_slo_pressure_scales_up(self, key, value):
        fleet = _StubFleet(1)
        scaler = self._scaler(fleet, _training_sig(**{key: value}), extra_up={
            "step_p99_latency_s": 1.0, "straggler_wait_s": 0.5})
        assert scaler.tick() == "up"
        assert fleet.n_live == 2

    def test_fit_builds_wired_autoscaler(self, tmp_path):
        fit = ElasticGBDTFit(str(tmp_path / "a"), fleet=_StubFleet(2))
        scaler = fit.autoscaler(up_step_p99_s=2.0, up_straggler_s=0.25)
        assert scaler.fleet is fit.fleet
        assert scaler.extra_up == {"step_p99_latency_s": 2.0, "straggler_wait_s": 0.25}
        sig = fit.signals()
        for key in ("queue_depth", "p99_latency_s", "shed_rate", "burn_rate",
                    "step_p99_latency_s", "straggler_wait_s"):
            assert key in sig


class TestMetrics:
    def test_world_size_gauge_has_explicit_merge_policy(self):
        assert GAUGE_MERGE_POLICIES[WORLD_SIZE_GAUGE] == "last"

    def test_fit_emits_world_size_reshard_and_straggler(self, tmp_path):
        reg = MetricsRegistry()
        x, y = reg_data(n=48)

        def hook(fit):
            if fit.step == 2 and fit.fleet.n_live > 1:
                fit.fleet.remove_first()

        gbdt_fit(str(tmp_path / "m"), x, y, 2, iters=4, hook=hook, metrics=reg)
        text = reg.render_prometheus()
        assert f"{WORLD_SIZE_GAUGE} 1" in text
        assert 'mmlspark_tpu_training_reshard_total{cause="join"} 1' in text
        assert 'mmlspark_tpu_training_reshard_total{cause="death"} 1' in text
        assert "mmlspark_tpu_training_straggler_wait_seconds" in text


class TestDiagnoseTable:
    def _diagnose(self):
        import pathlib
        import sys

        tools = str(pathlib.Path(__file__).parents[1] / "tools")
        if tools not in sys.path:
            sys.path.insert(0, tools)
        import diagnose

        return diagnose

    def test_jax_package_diagnose_renders_a_port_fit(self, tmp_path):
        d = str(tmp_path / "live")
        x, y = reg_data(n=48)
        gbdt_fit(d, x, y, 2, iters=3)
        out = self._diagnose().diagnose_training(d)
        assert "elastic gbdt fit" in out and "step=3" in out
        assert "http://local/" in out and "re-shards" in out

    def test_dnn_status_file(self, tmp_path):
        d = str(tmp_path / "dnn")
        x, y = cls_data()
        dnn_fit(d, x, y, 2, epochs=1)
        with open(os.path.join(d, "elastic_status.json")) as fh:
            doc = json.load(fh)
        assert doc["kind"] == "dnn" and doc["world_size"] == 2 and doc["step"] == 6
        out = self._diagnose().diagnose_training(d)
        assert "elastic dnn fit" in out and "P=2" in out


# --------------------------------------------------------------------- #
# slow tier: REAL worker processes, SIGKILL chaos                       #
# --------------------------------------------------------------------- #


def _chaos_hook(every=3):
    state = {"last": -1}

    def hook(fit):
        if fit.step and fit.step % every == 0 and fit.step != state["last"]:
            state["last"] = fit.step
            dead = fit.fleet.dead_slots()
            if dead:
                fit.fleet.respawn(dead[0])
            else:
                fit.fleet.kill(0)
    return hook


@pytest.mark.slow
class TestRealFleetChaos:
    """Kill AND add real workers every few steps for a DNN and a GBDT fit:
    the final model is byte-identical to an undisturbed P=1 run."""

    def test_gbdt_real_process_kill_add_digest_identical(self, tmp_path):
        x, y = reg_data(n=256, f=6)
        base, _ = gbdt_fit(str(tmp_path / "base"), x, y, 1, iters=8)
        fit = ElasticGBDTFit(
            str(tmp_path / "real"), objective="regression", num_iterations=8,
            num_leaves=7, max_bin=15, min_data_in_leaf=1, seed=0, n_workers=2,
            num_virtual=8, request_timeout_s=120.0, step_hook=_chaos_hook(),
            device="cpu")
        fit.fit(x, y)
        assert fit.model_digest() == base.model_digest()
        causes = [r["cause"] for r in fit.reshards]
        assert "death" in causes and "join" in causes

    def test_dnn_real_process_kill_add_digest_identical(self, tmp_path):
        x, y = cls_data(n=48)
        base, _ = dnn_fit(str(tmp_path / "base"), x, y, 1)
        fit = ElasticDNNFit(
            str(tmp_path / "real"), architecture="mlp", model_config={"features": [8]},
            loss="softmax_ce", learning_rate=0.05, epochs=2, batch_size=8, seed=0,
            n_workers=2, num_virtual=8, request_timeout_s=120.0,
            step_hook=_chaos_hook(every=4), device="cpu")
        fit.fit(x, y)
        assert fit.params_digest() == base.params_digest()
        causes = [r["cause"] for r in fit.reshards]
        assert "death" in causes and "join" in causes

    def test_sigkill_inside_reshard_barrier(self, tmp_path):
        x, y = reg_data(n=256, f=6)
        base, _ = gbdt_fit(str(tmp_path / "base"), x, y, 1, iters=8)
        state = {"killed_step": False, "killed_barrier": False}

        def step_hook(fit):
            if fit.step == 2 and not state["killed_step"]:
                state["killed_step"] = True
                fit.fleet.kill(0)

        def barrier_hook(fit):
            if state["killed_step"] and not state["killed_barrier"]:
                state["killed_barrier"] = True
                fit.fleet.kill(fit.fleet.live_slots()[0])

        fit = ElasticGBDTFit(
            str(tmp_path / "real"), objective="regression", num_iterations=8,
            num_leaves=7, max_bin=15, min_data_in_leaf=1, seed=0, n_workers=3,
            num_virtual=8, request_timeout_s=120.0, step_hook=step_hook,
            barrier_hook=barrier_hook, device="cpu")
        fit.fit(x, y)
        assert state["killed_barrier"]
        assert fit.model_digest() == base.model_digest()
        assert 1 in [r["world_size"] for r in fit.reshards]
