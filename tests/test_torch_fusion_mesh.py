"""The port's fused pipelines under a mesh of several ranks (core/fusion.py,
one process a rank) held to tests/test_sharded_fusion.py, case for case:
a mesh changes where a fused segment's work lands (each rank its block of
every chunk's rows, params whole or placed by a kernel's `mesh_fn`),
never what it produces. The ranks are a module-scoped pool of 4 spawned
gloo ranks on the CPU running tests/test_torch_fusion_mesh_jobs.py (no
jax in a rank); the reference side runs on the CPU devices of
tests/conftest.py.

Tolerances: the GBDT traversal is held byte for byte (no arithmetic
depends on the row count); the data-parallel MLP at ATOL, RTOL = 5e-5,
1e-4 (tests/test_torch_fusion.py's, a GEMM over fewer rows sums in
another order) and the tensor-parallel MLP at 2e-4, 2e-4
(tests/test_parallel.py:113-126). The ranks of a mesh are always
byte-equal among themselves.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from mmlspark_tpu.core.fusion import fuse as ref_fuse  # noqa: E402
from mmlspark_tpu.core.pipeline import pipeline_model as ref_pipeline_model  # noqa: E402
from mmlspark_tpu.core.schema import Table as RefTable  # noqa: E402
from mmlspark_tpu.gbdt.estimators import GBDTRegressor as RefRegressor  # noqa: E402
from mmlspark_tpu.nn.models import ModelBundle as RefBundle  # noqa: E402
from mmlspark_tpu.nn.runner import DeepModelTransformer as RefRunner  # noqa: E402
from mmlspark_tpu.ops.conversion import DataConversion as RefConversion  # noqa: E402
from mmlspark_tpu.parallel.mesh import make_mesh as ref_make_mesh  # noqa: E402
from mmlspark_tpu_torch.core import Table, fuse, pipeline_model  # noqa: E402
from mmlspark_tpu_torch.core.dataplane import ExecutableCache, ShapeBucketer  # noqa: E402
from mmlspark_tpu_torch.nn.models import ModelBundle  # noqa: E402
from mmlspark_tpu_torch.parallel import RankPool  # noqa: E402
from mmlspark_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: E402

import test_torch_fusion_mesh_jobs as jobs  # noqa: E402

WORLD = 4
ATOL, RTOL = 5e-5, 1e-4          # tests/test_torch_fusion.py:65
TP_TOL = 2e-4                    # tests/test_parallel.py:113-126


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(WORLD, backend="gloo", workdir=str(tmp_path_factory.mktemp("ranks")),
                 timeout_s=120, threads=1)
    yield p
    p.close()


def _bundles(f=16, outputs=4, features=(16, 8)):
    """(JAX bundle, port bundle) of one MLP: the JAX package's init,
    carried to the port as numpy. Widths divide by 2, so the
    tensor-parallel body qualifies on a model axis of 2."""
    jb = RefBundle.init("mlp", (f,), seed=0, num_outputs=outputs, features=features)
    port = ModelBundle(architecture="mlp", config=dict(jb.config),
                       variables=jax.tree.map(np.asarray, jb.variables), input_shape=(f,))
    return jb, port


def _x(n, f=16, seed=3):
    return np.random.default_rng(seed).normal(size=(n, f)).astype(np.float32)


def _members(results):
    got = [r for r in results if r is not None]
    assert got, "no rank of the mesh answered"
    return sorted(got, key=lambda r: r["shard"])


def _same_on_every_rank(results, col):
    blobs = {np.ascontiguousarray(r["cols"][col]).tobytes() for r in results}
    assert len(blobs) == 1, f"the ranks hold {len(blobs)} different {col!r} columns"
    return results[0]["cols"][col]


def _gbdt(rng, n=64):
    """The JAX package's fitted regressor, and its model text."""
    ref = RefRegressor(features_col="features", label_col="label", num_iterations=4,
                       num_leaves=7).fit(RefTable({"features": rng.normal(size=(n, 3)),
                                                   "label": rng.normal(size=n)}))
    return ref, ref.booster.to_text()


def _f32_features(rng, n):
    # float32-representable: the kernel's ready() check refuses values
    # device binning would re-bucket
    return rng.normal(size=(n, 3)).astype(np.float32).astype(np.float64)


# --------------------------------------------------------------------- #
# byte-identity                                                          #
# --------------------------------------------------------------------- #


class TestShardedByteIdentity:
    def test_data_parallel_vs_single_vs_staged_ragged(self, pool):
        # 103 = 3 full 32-row chunks + a ragged 7-row tail: the tail pads
        # to a mesh-divisible rung (a multiple of 4) and the padding slices
        # off identically on every rank
        jb, port = _bundles()
        x = _x(103)
        res = _members(pool.run(jobs.fused_mlp, port.to_bytes(), x, 32, 4))
        assert [r["shard"] for r in res] == [0, 1, 2, 3]
        got = _same_on_every_rank(res, "output")
        single = fuse(pipeline_model(*jobs._mlp_stages(port.to_bytes(), 32)),
                      mini_batch_size=32, device="cpu")
        one = np.asarray(single.transform(Table({"x": x}))["output"])
        ref4 = ref_fuse(ref_pipeline_model(
            RefRunner(input_col="x", mini_batch_size=32).set_model(jb),
            RefConversion(cols=["output"], convert_to="float")),
            mini_batch_size=32, mesh=ref_make_mesh(n_data=4, devices=jax.devices()[:4]))
        want = np.asarray(ref4.transform(RefTable({"x": x}))["output"])
        assert got.dtype == one.dtype == want.dtype and got.shape == (103, 4)
        np.testing.assert_allclose(got, one, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
        stats = res[0]["stats"]
        assert stats["mesh_shape"] == "4x1"
        seg = stats["segments"][0]
        assert seg["kind"] == "fused" and seg["mesh_shape"] == "4x1"
        # MLP weights whole on every rank; DataConversion is parameterless
        assert seg["param_placements"] == ["replicated", "none"]
        assert seg["rows_real"] == 103 and (103 + seg["rows_padded"]) % 4 == 0
        assert "mesh=4x1" in res[0]["describe"] and "eager" not in res[0]["describe"]

    def test_tensor_parallel_2d_mesh(self, pool):
        jb, port = _bundles()
        fetch = {"out": "logits", "prob": "probability"}
        x = _x(70, seed=5)
        res = _members(pool.run(jobs.fused_mlp, port.to_bytes(), x, 32, 2, 2, fetch))
        assert len(res) == WORLD
        single = fuse(pipeline_model(*jobs._mlp_stages(port.to_bytes(), 32, fetch)),
                      mini_batch_size=32, device="cpu").transform(Table({"x": x}))
        # the JAX package's staged transform: its own test's oracle for the
        # fused 2-D mesh (tests/test_sharded_fusion.py:80-99), whose
        # shard_map the installed jax refuses (ROADMAP Queue 3)
        ref = RefRunner(input_col="x", mini_batch_size=32, fetch_dict=fetch) \
            .set_model(jb).transform(RefTable({"x": x}))
        for c in fetch:
            got = _same_on_every_rank(res, c)
            np.testing.assert_allclose(got, np.asarray(single[c]), atol=TP_TOL, rtol=TP_TOL)
            np.testing.assert_allclose(got, np.asarray(ref[c]), atol=TP_TOL, rtol=TP_TOL)
        seg = res[0]["stats"]["segments"][0]
        assert seg["mesh_shape"] == "2x2"
        # the kernel's mesh_fn swapped in the column-parallel body and
        # placed the dense params itself; its gathers keep it eager
        assert seg["param_placements"] == ["custom"] and seg["eager"]
        assert all(r["eager"] for r in res)
        assert "mesh=2x2" in res[0]["describe"] and "eager" in res[0]["describe"]

    def test_gbdt_rows_sharded_params_replicated(self, pool, rng):
        ref, text = _gbdt(rng)
        score = _f32_features(rng, 81)
        res = _members(pool.run(jobs.fused_gbdt, text, score, 32, 4))
        got = _same_on_every_rank(res, "prediction")
        model = jobs.gbdt_model(text)
        staged = np.asarray(model.transform(Table({"features": score}))["prediction"])
        one = np.asarray(fuse(pipeline_model(model), mini_batch_size=32, device="cpu")
                         .transform(Table({"features": score}))["prediction"])
        ref4 = np.asarray(ref_fuse(ref_pipeline_model(ref), mini_batch_size=32,
                                   mesh=ref_make_mesh(n_data=4, devices=jax.devices()[:4]))
                          .transform(RefTable({"features": score}))["prediction"])
        assert got.tobytes() == one.tobytes() == staged.tobytes() == ref4.tobytes()
        assert res[0]["stats"]["segments"][0]["param_placements"] == ["custom"]
        # "custom" here still means whole on every rank: the binning table
        # and tree arrays
        assert all(r["params_whole"] for r in res)

    def test_shard_skew_gauge_recorded(self, pool):
        _, port = _bundles()
        res = _members(pool.run(jobs.skew, port.to_bytes(), _x(64), 32, 4, "skew-test"))
        for r in res:
            assert r["ratio"] >= 1.0 and r["gauge"] == r["ratio"]
            # the armed ledger noted each rank's readback once
            assert r["shards"] == [f"rank{k}" for k in range(WORLD)]
        assert len({r["ratio"] for r in res}) == 1


# --------------------------------------------------------------------- #
# cache-key isolation                                                    #
# --------------------------------------------------------------------- #


class TestCacheKeys:
    def test_family_key_without_mesh_is_the_pr5_key(self):
        base = ("seg", ("x", "float32", (16,)))
        assert ExecutableCache.family_key(base) is base

    def test_family_key_differs_across_mesh_shapes(self):
        base = ("seg", ("x", "float32", (16,)))
        spec = (("mlp", "replicated"), ("x", "P(data)"))
        k4 = ExecutableCache.family_key(
            base, mesh_shape=(("data", 4), ("model", 1)), sharding_spec=spec)
        k2 = ExecutableCache.family_key(
            base, mesh_shape=(("data", 2), ("model", 1)), sharding_spec=spec)
        assert k4 != base and k2 != base and k4 != k2

    def test_segment_keys_carry_mesh_only_when_sharded(self):
        # a mesh's key needs no process group: only its shape and placements
        _, port = _bundles()
        ins = {"x": np.zeros((32, 16), np.float32)}

        def seg(mesh=None):
            return fuse(pipeline_model(*jobs._mlp_stages(port.to_bytes(), 32)),
                        mini_batch_size=32, device="cpu", mesh=mesh)._ensure_segments()[0]

        s1 = seg()
        assert s1._family_key(ins)[0] == id(s1)     # the bare base, no mesh part
        s4, s2 = seg(Mesh((0, 1, 2, 3))), seg(Mesh((0, 1)))
        k4, k2 = s4._family_key(ins), s2._family_key(ins)
        assert k4[1][0] == "mesh" and k2[1][0] == "mesh"
        assert k4[1][1] == (("data", 4), ("model", 1)) and k2[1][1:] != k4[1][1:]
        assert k4[1][2] == (("DeepModelTransformer", "replicated"),
                            ("DataConversion", "none"), ("x", "P(data)"))

    def test_bucket_ladder_is_mesh_divisible(self):
        for step in ShapeBucketer(32, multiple_of=8).ladder:
            assert step % 8 == 0
        for step in ShapeBucketer(32, shards=4).ladder:
            assert step % 4 == 0


# --------------------------------------------------------------------- #
# steady state                                                           #
# --------------------------------------------------------------------- #


class TestSteadyState:
    def test_zero_recompiles_at_fixed_mesh_shape(self, pool):
        _, port = _bundles()
        # every rung the 32-row ladder can mint: full chunks plus ragged
        # tails of 7 (-> 8) and 16 rows
        warm = [_x(n, seed=n) for n in (103, 80, 64)]
        more = [_x(n, seed=100 + n) for n in (103, 80, 64, 40, 96, 7)]
        for r in _members(pool.run(jobs.steady, port.to_bytes(), warm, more, 32, 4)):
            before, after = r["before"], r["after"]
            assert after["misses"] == before["misses"]
            assert after["recompiles"] == before["recompiles"]
            assert after["hits"] > before["hits"]


# --------------------------------------------------------------------- #
# fallback: no mesh / a one-rank mesh is the exact single path           #
# --------------------------------------------------------------------- #


class TestFallback:
    def test_no_mesh_and_one_device_mesh_are_single_chip(self):
        _, port = _bundles()

        def fused(mesh=None):
            return fuse(pipeline_model(*jobs._mlp_stages(port.to_bytes(), 32)),
                        mini_batch_size=32, device="cpu", mesh=mesh)

        plain, trivial = fused(), fused(make_mesh(n_data=1))
        x = _x(20)
        out_p = np.asarray(plain.transform(Table({"x": x}))["output"])
        out_t = np.asarray(trivial.transform(Table({"x": x}))["output"])
        assert out_t.tobytes() == out_p.tobytes()
        for fm in (plain, trivial):
            seg = fm._ensure_segments()[0]
            assert fm._mesh is None and seg.mesh is None
            assert set(seg._param_placements) == {"single"}
            assert fm.last_stats["mesh_shape"] == "1"
            assert "param_placements" not in fm.last_stats["segments"][0]
            key = seg._family_key({"x": np.zeros((8, 16), np.float32)})
            assert key[0] == id(seg)

    def test_fuse_with_mesh_on_fused_model_reattaches(self):
        _, port = _bundles()
        fm = fuse(pipeline_model(*jobs._mlp_stages(port.to_bytes(), 32)), mini_batch_size=32,
                  device="cpu")
        mesh = Mesh((0, 1, 2, 3))
        assert fuse(fm) is fm
        assert fuse(fm, mesh=mesh) is fm
        assert fm._effective_mesh() is mesh
        fm.set_mesh(None)
        assert fm._effective_mesh() is None


# --------------------------------------------------------------------- #
# mesh threading: streaming + serving                                    #
# --------------------------------------------------------------------- #


class TestMeshThreading:
    def test_streaming_query_auto_fuses_under_mesh(self, pool, rng):
        from mmlspark_tpu_torch.streaming.query import StreamingQuery
        from mmlspark_tpu_torch.streaming.sources import MemorySource

        _, text = _gbdt(rng)
        batches = [_f32_features(rng, n) for n in (50, 64, 9)]
        res = _members(pool.run(jobs.stream, text, batches, 32, 2))
        lead, follower = res
        assert not lead["following"] and follower["following"]
        assert lead["batches"] == follower["runs"] == 3 and lead["mesh_shape"] == "2x1"
        source = MemorySource()
        q = StreamingQuery(source=source, transform=pipeline_model(jobs.gbdt_model(text)),
                           device="cpu")
        for b in batches:
            source.add_rows(Table({"features": b}))
            q.process_all_available()
        one = np.asarray(q.sink.table()["prediction"])
        q.stop()
        assert lead["prediction"].tobytes() == one.tobytes()
        # a query of a mesh of one rank is the plain query
        q1 = StreamingQuery(source=MemorySource(), transform=pipeline_model(
            jobs.gbdt_model(text)), mesh=make_mesh(n_data=1), device="cpu")
        assert not q1.following and q1._led is None
        q1.stop()

    def test_serve_model_threads_mesh(self, pool, rng):
        _, text = _gbdt(rng)
        feats = _f32_features(rng, 24)
        bodies = [json.dumps(dict(zip("abc", row.tolist()))).encode() for row in feats]
        res = _members(pool.run(jobs.serve, text, bodies, 2))
        lead, follower = res
        assert lead["disabled"] is None and lead["resident_batches"] > 0
        assert lead["data_axis"] == 2 and all(r % 2 == 0 for r in lead["ladder"])
        # the follower ran every resident dispatch and fetch, then stopped
        done = follower["followed"]
        assert done["dispatches"] == done["fetches"] > 0
        model = jobs.gbdt_model(text)
        want = [json.dumps({"prediction": float(v)}).encode() for v in
                np.asarray(model.transform(Table({"features": feats}))["prediction"])]
        assert lead["replies"] == want and lead["forced"] == want

    def test_serve_recommender_threads_mesh(self, pool):
        from mmlspark_tpu_torch.recommendation import SAR

        rng = np.random.default_rng(11)
        rows = [(float(u), float(i), 1.0) for u in range(12)
                for i in rng.choice(10, size=4, replace=False)]
        arr = np.asarray(rows, np.float64)
        cols = {"user": arr[:, 0], "item": arr[:, 1], "rating": arr[:, 2]}
        users = [u % 12 for u in range(20)]
        res = _members(pool.run(jobs.serve_sar, cols, users, 2))
        lead, follower = res
        assert lead["resident_batches"] > 0 and lead["placements"] == ["replicated"]
        assert follower["followed"]["dispatches"] > 0
        model = SAR(support_threshold=1, device="cpu").fit(Table(dict(cols)))
        recs = model.recommend_for_all_users(k=10)
        row = {int(u): i for i, u in enumerate(np.asarray(recs["user"]))}
        ids, ratings = np.asarray(recs["recommendations"]), np.asarray(recs["ratings"])
        want = [json.dumps({"recommendations": ids[row[u]].tolist(),
                            "ratings": ratings[row[u]].tolist()}).encode() for u in users]
        assert lead["replies"] == want


# --------------------------------------------------------------------- #
# sharded uploads                                                        #
# --------------------------------------------------------------------- #


class TestShardedUpload:
    def test_from_host_uploads_a_ranks_block(self, pool):
        cols = {"a": np.arange(24, dtype=np.float64).reshape(8, 3),
                "b": np.arange(8, dtype=np.int64)}
        res = _members(pool.run(jobs.upload, cols, 4, ["a"]))
        for r in res:
            i = r["shard"]
            # the listed column: this rank's 2 rows, in the x64-off dtype
            np.testing.assert_array_equal(r["cols"]["a"], cols["a"][2 * i:2 * i + 2]
                                          .astype(np.float32))
            # the unlisted one whole
            np.testing.assert_array_equal(r["cols"]["b"], cols["b"].astype(np.int32))


# --------------------------------------------------------------------- #
# a lead and its followers fail instead of hanging                       #
# --------------------------------------------------------------------- #


class TestLeadFailures:
    def test_a_gone_follower_and_a_missing_stop_raise(self, pool, rng):
        _, text = _gbdt(rng)
        res = [r for r in pool.run(jobs.gone, text, _f32_features(rng, 16), 3.0)
               if r is not None]
        lead, follower = res
        assert lead["lead"] is not None and lead["lead_s"] < 60, lead
        assert "failed earlier" in lead["again"]
        assert follower["follow"] is not None and follower["follow_s"] < 60, follower
