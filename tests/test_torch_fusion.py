"""The port's pipeline fusion (mmlspark_tpu_torch/core/fusion.py) held to the
JAX package's: tests/test_fusion.py's cases through the port on the CPU
(where a fused segment runs its composition eagerly, under the same cache
accounting as the card's CUDA graphs), the plan text equal to the JAX
package's for the same stages, the port's fused output equal to the JAX
package's STAGED output (bit for bit for the GBDT and ops kernels, at
tests/test_torch_nn_runner.py's tolerance for DeepModelTransformer), and
saved FusedPipelineModels loading in either package. TestStreamingIntegration
holds the port's StreamingQuery, which fuses its PipelineModel transform,
against the staged transform and the JAX package's streamed bytes."""

from __future__ import annotations

import json
import threading
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from mmlspark_tpu.core import fuse as ref_fuse  # noqa: E402
from mmlspark_tpu.core import pipeline_model as ref_pipeline_model  # noqa: E402
from mmlspark_tpu.core import plan_fusion as ref_plan_fusion  # noqa: E402
from mmlspark_tpu.core.schema import Table as RefTable  # noqa: E402
from mmlspark_tpu.core.serialize import load_stage as ref_load_stage  # noqa: E402
from mmlspark_tpu.gbdt.estimators import GBDTClassifier as RefClassifier  # noqa: E402
from mmlspark_tpu.gbdt.estimators import GBDTRegressor as RefRegressor  # noqa: E402
from mmlspark_tpu.image.transformer import ImageTransformer as RefImageTransformer  # noqa: E402
from mmlspark_tpu.nn.models import ModelBundle as RefBundle  # noqa: E402
from mmlspark_tpu.nn.runner import DeepModelTransformer as RefRunner  # noqa: E402
from mmlspark_tpu.ops.conversion import DataConversion as RefConversion  # noqa: E402
from mmlspark_tpu.ops.ensemble import EnsembleByKey as RefEnsemble  # noqa: E402
from mmlspark_tpu.ops.featurize import AssembleFeatures as RefAssemble  # noqa: E402
from mmlspark_tpu.ops.missing import CleanMissingData as RefCleanMissing  # noqa: E402
from mmlspark_tpu_torch.core import (  # noqa: E402
    DeviceKernel,
    DeviceTable,
    FusedPipelineModel,
    fuse,
    pipeline_model,
    plan_fusion,
)
from mmlspark_tpu_torch.core.dataplane import ShapeBucketer  # noqa: E402
from mmlspark_tpu_torch.core.params import Param  # noqa: E402
from mmlspark_tpu_torch.core.pipeline import PipelineStage, Timer, Transformer  # noqa: E402
from mmlspark_tpu_torch.core.schema import Table  # noqa: E402
from mmlspark_tpu_torch.core.serialize import load_stage, register_stage  # noqa: E402
from mmlspark_tpu_torch.gbdt.booster import Booster  # noqa: E402
from mmlspark_tpu_torch.gbdt.estimators import GBDTClassifier, GBDTRegressionModel  # noqa: E402
from mmlspark_tpu_torch.image.transformer import ImageTransformer  # noqa: E402
from mmlspark_tpu_torch.nn.models import ModelBundle  # noqa: E402
from mmlspark_tpu_torch.nn.runner import DeepModelTransformer  # noqa: E402
from mmlspark_tpu_torch.ops.conversion import DataConversion  # noqa: E402
from mmlspark_tpu_torch.ops.ensemble import EnsembleByKey  # noqa: E402
from mmlspark_tpu_torch.ops.featurize import AssembleFeatures  # noqa: E402
from mmlspark_tpu_torch.ops.missing import CleanMissingData  # noqa: E402

# tests/test_torch_nn_runner.py's tolerance between the packages' forwards
# (tests/test_attention.py:159), and its bf16 one
ATOL, RTOL = 5e-5, 1e-4
BF16_TOL = 3e-2


def _mlp_pair(input_col="features", f=8, outputs=3, **kw):
    """(JAX stage, port stage) over the same weights: the JAX package's
    init, carried to the port as numpy."""
    jb = RefBundle.init("mlp", (f,), seed=0, num_outputs=outputs)
    port = ModelBundle(architecture="mlp", config=dict(jb.config),
                       variables=jax.tree.map(np.asarray, jb.variables), input_shape=(f,))
    return (RefRunner(input_col=input_col, **kw).set_model(jb),
            DeepModelTransformer(input_col=input_col, device="cpu", **kw).set_model(port))


def _mlp(input_col="features", f=8, outputs=3, **kw):
    return _mlp_pair(input_col, f, outputs, **kw)[1]


def _cols(n=50, f=8, seed=0, dtype=np.float64) -> dict:
    rng = np.random.default_rng(seed)
    return {c: rng.normal(size=n).astype(dtype) for c in "abcdefgh"[:f]}


def _table(n=50, f=8, seed=0, dtype=np.float64):
    return Table(_cols(n, f, seed, dtype))


def _fuse(model, **kw):
    return fuse(model, device="cpu", **kw)


def _ref_gbdt_regressor(x, y, **kw):
    """The JAX package's fit and the port's model over its trees."""
    ref = RefRegressor(features_col="features", label_col="label", **kw).fit(
        RefTable({"features": x, "label": y}))
    port = GBDTRegressionModel(features_col="features", prediction_col="prediction")
    port.booster = Booster.from_text(ref.booster.to_text(), device="cpu")
    return ref, port


@register_stage
class _DoubleOnHost(Transformer):
    """A deliberately non-fusable stage (no device_kernel)."""

    col = Param("x", "column", ptype=str)

    def _transform(self, table: Table) -> Table:
        return table.with_column(
            self.col_name(), np.asarray(table[self.col_name()]) * 2)

    def col_name(self):
        return self.get("col")


@register_stage
class _AddOneOnDevice(Transformer):
    col = Param("x", "column", ptype=str)

    def _transform(self, table: Table) -> Table:
        c = self.get("col")
        return table.with_column(
            c, np.asarray(table[c], np.float32) + np.float32(1))

    def device_kernel(self):
        c = self.get("col")
        return DeviceKernel(
            fn=lambda p, cols: {c: cols[c].to(torch.float32) + 1},
            input_cols=(c,), output_cols=(c,), out_dtypes={c: np.float32})


def _assert_identical(staged, fused):
    """tests/test_fusion.py's TestByteIdentity._assert_identical, for a
    staged table of either package."""
    assert staged.columns == fused.columns
    for c in staged.columns:
        s, f = staged[c], fused[c]
        if isinstance(s, np.ndarray):
            assert s.dtype == f.dtype, c
            assert s.tobytes() == f.tobytes(), c
        else:
            assert list(s) == list(f), c
        assert staged.meta(c) == fused.meta(c), c


def _assert_close(ref_staged, fused, cols, atol=ATOL, rtol=RTOL):
    """The JAX package's staged table against the port's fused one: the
    same columns, dtypes and metadata; `cols` within the tolerance, the
    rest byte for byte."""
    assert ref_staged.columns == fused.columns
    for c in ref_staged.columns:
        s, f = np.asarray(ref_staged[c]), np.asarray(fused[c])
        assert s.dtype == f.dtype, c
        if c in cols:
            np.testing.assert_allclose(f, s, atol=atol, rtol=rtol, err_msg=c)
        else:
            assert s.tobytes() == f.tobytes(), c
        assert ref_staged.meta(c) == fused.meta(c), c


# --------------------------------------------------------------------- #
# planning
# --------------------------------------------------------------------- #


class TestPlanFusion:
    def test_maximal_runs_partition(self):
        plan = plan_fusion([_AddOneOnDevice(), _AddOneOnDevice(),
                            _DoubleOnHost(), _AddOneOnDevice()])
        assert [s.fused for s in plan.segments] == [True, False, True]
        assert [len(s.stages) for s in plan.segments] == [2, 1, 1]
        assert plan.n_fused_stages == 3 and plan.n_stages == 4
        assert plan.fusion_ratio == pytest.approx(0.75)

    def test_reasons_surface_for_host_stages(self):
        plan = plan_fusion([_DoubleOnHost(), EnsembleByKey(keys=["k"], cols=["v"])])
        reasons = [sp.reason for s in plan.segments for sp in s.stages]
        assert "no device kernel declared" in reasons[0]
        assert "data-dependent output shape" in reasons[1]
        assert "HOST" in plan.describe()

    def test_nested_pipeline_models_flatten_into_runs(self):
        inner = pipeline_model(_AddOneOnDevice(), _AddOneOnDevice())
        plan = plan_fusion([_AddOneOnDevice(), inner])
        assert len(plan.segments) == 1 and plan.segments[0].fused
        assert len(plan.segments[0].stages) == 3

    def test_transfer_counts(self):
        plan = plan_fusion([_AddOneOnDevice(), _AddOneOnDevice(),
                            _DoubleOnHost(), _AddOneOnDevice()])
        fused, staged = plan.transfers_per_batch()
        assert fused == 4      # 2 fused segments x (1 in + 1 out)
        assert staged == 6     # 3 device stages x (1 in + 1 out)

    def test_broken_declaration_stays_on_host(self):
        class Broken(_AddOneOnDevice):
            def device_kernel(self):
                raise RuntimeError("boom")

        plan = plan_fusion([Broken()])
        assert not plan.segments[0].fused
        assert "device_kernel() failed" in plan.segments[0].stages[0].reason

    def test_fuse_is_idempotent_and_wraps_bare_transformers(self):
        fm = _fuse(pipeline_model(_AddOneOnDevice()))
        assert fuse(fm) is fm
        single = _fuse(_AddOneOnDevice())
        assert isinstance(single, FusedPipelineModel)
        with pytest.raises(TypeError):
            fuse(object())

    def test_describe_text_equals_the_jax_package(self):
        """The same stages planned by both packages print the same plan:
        every device_kernel's columns, labels, reasons and sharding text."""
        cols = _cols(60)
        ref_t, t = RefTable(dict(cols)), Table(dict(cols))
        rng = np.random.default_rng(2)
        x = rng.normal(size=(200, 8)).astype(np.float32).astype(np.float64)
        ref_gbdt, gbdt = _ref_gbdt_regressor(x, x[:, 0], num_iterations=3, num_leaves=7)
        ref_cls = RefClassifier(num_iterations=2).fit(RefTable({"features": x, "label": x[:, 0] > 0}))
        cls = GBDTClassifier(num_iterations=2, device="cpu").fit(
            Table({"features": x, "label": x[:, 0] > 0}))
        ref_run, run = _mlp_pair(fetch_dict={"out": "logits", "p": "probability"})

        def stages(clean, asm, conv, ens, img):
            return [clean(input_cols=["a"], output_cols=["a"], cleaning_mode="Mean"),
                    asm(columns_to_featurize=list("abcdefgh")), conv]

        ref_stages = [RefCleanMissing(input_cols=["a"], output_cols=["a"],
                                      cleaning_mode="Mean").fit(ref_t),
                      RefAssemble(columns_to_featurize=list("abcdefgh")).fit(ref_t),
                      ref_gbdt, RefConversion(cols=["prediction"], convert_to="float"),
                      RefEnsemble(keys=["k"], cols=["v"]), ref_run, ref_cls,
                      RefConversion(cols=["prediction"], convert_to="string"),
                      RefImageTransformer(input_col="image", output_col="o").resize(4, 4)]
        port_stages = [CleanMissingData(input_cols=["a"], output_cols=["a"],
                                        cleaning_mode="Mean").fit(t),
                       AssembleFeatures(columns_to_featurize=list("abcdefgh")).fit(t),
                       gbdt, DataConversion(cols=["prediction"], convert_to="float"),
                       EnsembleByKey(keys=["k"], cols=["v"]), run, cls,
                       DataConversion(cols=["prediction"], convert_to="string"),
                       ImageTransformer(input_col="image", output_col="o").resize(4, 4)]
        ref_plan, plan = ref_plan_fusion(ref_stages), plan_fusion(port_stages)
        assert plan.describe() == ref_plan.describe()
        assert plan.describe(donate=True, pipeline_depth=1) == \
            ref_plan.describe(donate=True, pipeline_depth=1)
        assert "kernel=fused_traverse" in plan.describe()
        assert [s.fused for s in plan.segments] == [True, False, True, False, True]

    def test_multi_rank_mesh_raises_naming_the_item(self, tmp_path):
        """Fusion under a mesh of several ranks (once refused) runs: the
        GBDT regressor fused on 2 spawned gloo ranks (every rank its block
        of each chunk, jobs of tests/test_torch_fusion_mesh_jobs.py) equals
        the one-process fused and staged transforms byte for byte on every
        rank, and a one-rank mesh is the single-device path."""
        import test_torch_fusion_mesh_jobs as jobs

        from mmlspark_tpu_torch.parallel import RankPool
        from mmlspark_tpu_torch.parallel.mesh import Mesh

        rng = np.random.default_rng(7)
        ref, port = _ref_gbdt_regressor(rng.normal(size=(64, 3)), rng.normal(size=64),
                                        num_iterations=3, num_leaves=5)
        x = rng.normal(size=(45, 3)).astype(np.float32).astype(np.float64)
        with RankPool(2, backend="gloo", workdir=str(tmp_path), timeout_s=120) as pool:
            res = pool.run(jobs.fused_gbdt, port.booster.to_text(), x, 16, 2)
        staged = np.asarray(port.transform(Table({"features": x}))["prediction"])
        for r in res:
            assert r["stats"]["mesh_shape"] == "2x1"
            assert r["cols"]["prediction"].tobytes() == staged.tobytes()
        fm = _fuse(pipeline_model(_AddOneOnDevice()))
        assert fm.set_mesh(Mesh([0, 1])) is fm and fm._effective_mesh().size == 2
        one = _fuse(pipeline_model(_AddOneOnDevice()), mesh=Mesh([0]))
        t = Table({"x": np.arange(4, dtype=np.float32)})
        assert one.transform(t)["x"].tolist() == [1.0, 2.0, 3.0, 4.0]
        assert one._effective_mesh() is None and one.last_stats["mesh_shape"] == "1"


# --------------------------------------------------------------------- #
# DeviceTable
# --------------------------------------------------------------------- #


class TestDeviceTable:
    def test_round_trip_and_with_columns(self):
        dt = DeviceTable.from_host({"x": np.arange(4.0, dtype=np.float32)}, device="cpu")
        assert "x" in dt and dt.columns == ["x"] and len(dt) == 1
        dt2 = dt.with_columns({"y": dt["x"] * 2})
        host = dt2.to_host()
        assert host["y"].tolist() == [0.0, 2.0, 4.0, 6.0]
        # derivation never mutates the parent
        assert dt.columns == ["x"]

    def test_uploads_narrow_as_the_jax_package(self):
        from mmlspark_tpu.core.table_io import DeviceTable as RefDeviceTable

        cols = {"f": np.arange(3.0), "i": np.arange(3), "u": np.arange(3, dtype=np.uint8)}
        ours = DeviceTable.from_host(cols, device="cpu").to_host()
        theirs = RefDeviceTable.from_host(cols).to_host()
        for c in cols:
            assert ours[c].dtype == theirs[c].dtype, c
            assert ours[c].tobytes() == theirs[c].tobytes(), c


# --------------------------------------------------------------------- #
# byte identity, fused vs staged
# --------------------------------------------------------------------- #


class TestByteIdentity:
    def test_f32_featurize_clean_model_postprocess_chain(self):
        cols = _cols(57)
        rng = np.random.default_rng(3)
        cat = rng.integers(0, 4, size=57).astype(np.float64)
        nanify = cols["a"].copy()
        nanify[::9] = np.nan
        tables = []
        for table in (Table, RefTable):
            t = table(dict(cols)).with_column("cat", cat, meta={"category_values": list("wxyz")})
            tables.append(t)
        t, ref_t = tables
        ref_run, runner = _mlp_pair(f=12)
        asm = AssembleFeatures(columns_to_featurize=[*"abcdefgh", "cat"]).fit(t)
        ref_asm = RefAssemble(columns_to_featurize=[*"abcdefgh", "cat"]).fit(ref_t)
        t, ref_t = t.with_column("a", nanify), ref_t.with_column("a", nanify)
        conv = DataConversion(cols=["out"], convert_to="float")
        ref_conv = RefConversion(cols=["out"], convert_to="float")
        staged_model = pipeline_model(asm, runner, conv)
        fused_model = _fuse(pipeline_model(asm, runner, conv), mini_batch_size=16)
        runner.set(fetch_dict={"out": "logits"})
        ref_run.set(fetch_dict={"out": "logits"})
        staged = staged_model.transform(t)
        fused = fused_model.transform(t)
        assert fused_model.last_stats["segments"][0]["kind"] == "fused"
        _assert_identical(staged, fused)
        ref_staged = ref_pipeline_model(ref_asm, ref_run, ref_conv).transform(ref_t)
        _assert_close(ref_staged, fused, {"out"})

    def test_f32_clean_missing_fuses_and_matches(self):
        x = np.arange(40, dtype=np.float32)
        x[::7] = np.nan
        t = Table({"a": x})
        cm = CleanMissingData(input_cols=["a"], output_cols=["a_clean"],
                              cleaning_mode="Median").fit(t)
        fm = _fuse(pipeline_model(cm, _AddOneOnDevice(col="a_clean")))
        staged = _AddOneOnDevice(col="a_clean").transform(cm.transform(t))
        fused = fm.transform(t)
        assert fm.last_stats["segments"][0]["kind"] == "fused"
        _assert_identical(staged, fused)
        ref_t = RefTable({"a": x})
        ref_cm = RefCleanMissing(input_cols=["a"], output_cols=["a_clean"],
                                 cleaning_mode="Median").fit(ref_t)
        ref_staged = ref_cm.transform(ref_t)
        got = _fuse(pipeline_model(cm)).transform(t)
        _assert_identical(ref_staged, got)

    def test_f64_clean_missing_falls_back_and_matches(self):
        x = np.arange(40, dtype=np.float64)
        x[::7] = np.nan
        t = Table({"a": x})
        cm = CleanMissingData(input_cols=["a"], output_cols=["a_clean"],
                              cleaning_mode="Mean").fit(t)
        fm = _fuse(pipeline_model(cm))
        fused = fm.transform(t)
        seg = fm.last_stats["segments"][0]
        assert seg["kind"] == "host_fallback" and "float64" in seg["reason"]
        _assert_identical(cm.transform(t), fused)

    def test_bf16_runner_fused_matches_staged(self):
        cols = _cols(33)
        t, ref_t = Table(dict(cols)), RefTable(dict(cols))
        asm = AssembleFeatures(columns_to_featurize=list("abcdefgh")).fit(t)
        ref_asm = RefAssemble(columns_to_featurize=list("abcdefgh")).fit(ref_t)
        # the CPU's bf16 GEMM may round a row differently at another row
        # count, so both paths run batches of 8 rows (the tail padded to 8)
        ref_run, runner = _mlp_pair(bfloat16=True, mini_batch_size=8)
        staged = pipeline_model(asm, runner).transform(t)
        fm = _fuse(pipeline_model(asm, runner), mini_batch_size=8, shape_buckets=False)
        fused = fm.transform(t)
        assert fm.last_stats["segments"][0]["kind"] == "fused"
        _assert_identical(staged, fused)
        ref_staged = ref_pipeline_model(ref_asm, ref_run).transform(ref_t)
        _assert_close(ref_staged, fused, {"output"}, atol=BF16_TOL, rtol=BF16_TOL)

    def test_int_conversion_fused_matches_staged(self):
        cols = {"x": np.asarray([1.0, -2.5, 3.9, -0.1, 7.0], np.float32),
                "y": np.asarray([0, 1, 2, 0, 5], np.int32)}
        t, ref_t = Table(dict(cols)), RefTable(dict(cols))
        for target in ("integer", "short", "byte", "boolean", "float"):
            conv = DataConversion(cols=["x", "y"], convert_to=target)
            fm = _fuse(pipeline_model(conv))
            fused = fm.transform(t)
            assert fm.last_stats["segments"][0]["kind"] == "fused", target
            _assert_identical(conv.transform(t), fused)
            _assert_identical(RefConversion(cols=["x", "y"], convert_to=target).transform(ref_t),
                              fused)

    def test_conversion_f64_input_falls_back(self):
        t = Table({"x": np.asarray([1.0, 2.0])})  # float64
        conv = DataConversion(cols=["x"], convert_to="float")
        fm = _fuse(pipeline_model(conv))
        fused = fm.transform(t)
        assert fm.last_stats["segments"][0]["kind"] == "host_fallback"
        _assert_identical(conv.transform(t), fused)

    def test_gbdt_regression_fuses_and_matches(self):
        rng = np.random.default_rng(5)
        # float32-representable float64 features: the binning bit-identity
        # precondition the ready() check enforces
        X = rng.normal(size=(300, 6)).astype(np.float32).astype(np.float64)
        X[::11, 0] = np.nan
        y = 2 * np.nan_to_num(X[:, 0]) + np.sin(X[:, 1])
        ref, model = _ref_gbdt_regressor(X, y, num_iterations=12, num_leaves=15)
        t = Table({"features": X, "label": y})
        fm = _fuse(pipeline_model(model), mini_batch_size=128)
        assert fm.plan().segments[0].fused
        fused = fm.transform(t)
        assert fm.last_stats["segments"][0]["kind"] == "fused"
        _assert_identical(model.transform(t), fused)
        _assert_identical(ref.transform(RefTable({"features": X, "label": y})), fused)

    def test_gbdt_regression_declines_values_off_the_f32_grid(self):
        rng = np.random.default_rng(6)
        X = rng.normal(size=(120, 3)).astype(np.float32).astype(np.float64)
        _, model = _ref_gbdt_regressor(X, X[:, 0], num_iterations=3, num_leaves=7)
        fm = _fuse(pipeline_model(model))
        odd = X.copy()
        odd[0, 0] = 0.1
        out = fm.transform(Table({"features": odd}))
        seg = fm.last_stats["segments"][0]
        assert seg["kind"] == "host_fallback" and "float32" in seg["reason"]
        _assert_identical(model.transform(Table({"features": odd})), out)

    def test_gbdt_classifier_declares_host_reason(self):
        rng = np.random.default_rng(6)
        X = rng.normal(size=(120, 4))
        y = (X[:, 0] > 0).astype(np.float64)
        t = Table({"features": X, "label": y})
        model = GBDTClassifier(features_col="features", label_col="label",
                               num_iterations=5, device="cpu").fit(t)
        plan = plan_fusion([model])
        assert not plan.segments[0].fused
        assert "float64" in plan.segments[0].stages[0].reason
        fm = _fuse(pipeline_model(model))
        _assert_identical(model.transform(t), fm.transform(t))

    def test_empty_table_runs_host_path(self):
        t = Table({"x": np.asarray([], np.float32)})
        fm = _fuse(pipeline_model(_AddOneOnDevice()))
        out = fm.transform(t)
        assert out["x"].shape == (0,)
        assert fm.last_stats["segments"][0]["kind"] == "host_fallback"


# --------------------------------------------------------------------- #
# host sandwich / segmentation at runtime / saved models
# --------------------------------------------------------------------- #


class TestHostSandwich:
    def test_non_fusable_stage_mid_pipeline(self):
        t = Table({"x": np.arange(20, dtype=np.float32)})
        stages = [_AddOneOnDevice(), _AddOneOnDevice(), _DoubleOnHost(), _AddOneOnDevice()]
        staged = pipeline_model(*stages).transform(t)
        fm = _fuse(pipeline_model(*stages))
        fused = fm.transform(t)
        kinds = [s["kind"] for s in fm.last_stats["segments"]]
        assert kinds == ["fused", "host", "fused"]
        assert staged["x"].tobytes() == fused["x"].tobytes()

    def test_serialization_round_trip(self, tmp_path):
        t = Table({"x": np.arange(10, dtype=np.float32)})
        fm = _fuse(pipeline_model(_AddOneOnDevice(), _DoubleOnHost(), _AddOneOnDevice()),
                   mini_batch_size=4)
        expected = fm.transform(t)
        path = str(tmp_path / "fm")
        fm.save(path)
        loaded = PipelineStage.load(path)
        assert isinstance(loaded, FusedPipelineModel)
        assert loaded.get("mini_batch_size") == 4
        # the device is a runtime placement, not saved state
        assert loaded.get("device") == "cuda"
        loaded.set(device="cpu")
        assert loaded.transform(t)["x"].tobytes() == expected["x"].tobytes()

    @pytest.mark.parametrize("writer", ["port", "ref"])
    def test_saved_model_loads_in_the_other_package(self, tmp_path, writer):
        """A FusedPipelineModel of ops stages saved by one package loads in
        the other with its Params, and both score the table alike."""
        x = np.arange(30, dtype=np.float32)
        x[::4] = np.nan
        cols = {"a": x, "b": np.linspace(-1, 1, 30).astype(np.float32)}
        path = str(tmp_path / "fm")
        if writer == "port":
            t = Table(dict(cols))
            clean = CleanMissingData(input_cols=["a"], output_cols=["a"],
                                     cleaning_mode="Mean").fit(t)
            asm = AssembleFeatures(columns_to_featurize=["a", "b"]).fit(t)
            fm = _fuse(pipeline_model(clean, asm), mini_batch_size=8)
            want = fm.transform(t)
            fm.save(path)
            other = ref_load_stage(path)
            got = other.transform(RefTable(dict(cols)))
        else:
            t = RefTable(dict(cols))
            clean = RefCleanMissing(input_cols=["a"], output_cols=["a"],
                                    cleaning_mode="Mean").fit(t)
            asm = RefAssemble(columns_to_featurize=["a", "b"]).fit(t)
            fm = ref_fuse(ref_pipeline_model(clean, asm), mini_batch_size=8)
            want = fm.transform(t)
            fm.save(path)
            other = load_stage(path)
            other.set(device="cpu")
            got = other.transform(Table(dict(cols)))
        assert type(other).__name__ == "FusedPipelineModel"
        assert other.get("mini_batch_size") == 8
        assert got.columns == want.columns
        for c in want.columns:
            assert np.asarray(got[c]).tobytes() == np.asarray(want[c]).tobytes(), c


# --------------------------------------------------------------------- #
# ragged tails through the bucket ladder
# --------------------------------------------------------------------- #


class TestRaggedLadder:
    def test_ragged_sizes_are_identical_and_stop_recompiling(self):
        runner = _mlp()
        asm = AssembleFeatures(columns_to_featurize=list("abcdefgh")).fit(_table(16))
        fm = _fuse(pipeline_model(asm, runner), mini_batch_size=16)
        staged = pipeline_model(asm, runner)
        for n in ShapeBucketer(16).ladder:          # every bucket builds once
            fm.transform(_table(n, seed=n))
        seg = fm._segments[0]
        warm = seg._exec_cache.stats()
        for i, n in enumerate((3, 7, 1, 29, 16, 2, 41, 5)):
            t = _table(n, seed=100 + i)
            s, f = staged.transform(t), fm.transform(t)
            for c in s.columns:
                if c == "output":
                    # the CPU's f32 GEMM may round a row differently at
                    # another row count (the staged runner pads to 64 rows,
                    # the fused segment to the bucket): f32 rounding apart
                    np.testing.assert_allclose(f[c], s[c], rtol=1e-6, atol=1e-6,
                                               err_msg=str(n))
                else:
                    assert s[c].tobytes() == f[c].tobytes(), (n, c)
        soaked = seg._exec_cache.stats()
        assert soaked["misses"] == warm["misses"]
        assert soaked["recompiles"] == warm["recompiles"]
        assert soaked["hits"] > warm["hits"]

    def test_buckets_off_pads_to_mini_batch(self):
        fm = _fuse(pipeline_model(_AddOneOnDevice()), mini_batch_size=8, shape_buckets=False)
        out = fm.transform(Table({"x": np.arange(13, dtype=np.float32)}))
        assert out["x"].tolist() == [float(i + 1) for i in range(13)]

    def test_fully_fusable_chain_moves_two_transfers_per_batch(self):
        rng = np.random.default_rng(12)
        t = Table({"features": rng.normal(size=(64, 8)).astype(np.float32)})
        fm = _fuse(pipeline_model(_mlp(), DataConversion(cols=["output"], convert_to="float")),
                   mini_batch_size=16)
        fm.transform(t)
        stats = fm.last_stats
        n_batches = 4
        assert stats["segments"][0]["kind"] == "fused"
        assert stats["uploads"] == n_batches
        assert stats["downloads"] == n_batches
        assert (stats["uploads"] + stats["downloads"]) / n_batches <= 2
        _, staged = fm.plan().transfers_per_batch()
        assert staged == 4

    def test_prefetch_depth_zero_is_identical(self):
        t = _table(37)
        asm = AssembleFeatures(columns_to_featurize=list("abcdefgh")).fit(t)
        outs = []
        for depth in (0, 2):
            fm = _fuse(pipeline_model(asm, _mlp()), mini_batch_size=8, prefetch_depth=depth)
            outs.append(fm.transform(t)["output"].tobytes())
        assert outs[0] == outs[1]

    def test_resident_lag2_warm_and_dispatches_keep_their_rows(self):
        """The resident session's schedule on the CPU: a lag-2 warm over
        repeated rungs, then batches of different rows in flight at once,
        each fetched to its own rows."""
        rng = np.random.default_rng(13)
        x = rng.normal(size=(64, 8)).astype(np.float32)
        fm = _fuse(pipeline_model(_mlp(), DataConversion(cols=["output"], convert_to="float")))
        ex = fm.resident_executor()
        assert ex.warm({"features": x[:3]}, [16, 16, 8, 16], readback_lag=2) == 4
        outs = [ex.dispatch({"features": x[i:i + 16]}) for i in range(0, 64, 16)]
        got = np.concatenate([ex.fetch(o, 16)["output"] for o in outs])
        want = fm.transform(Table({"features": x}))["output"]
        assert got.tobytes() == want.tobytes()
        st = ex.stats()
        assert st["dispatches"] == 8 and st["round_trips"] == 8 and st["donate_buffers"]


# --------------------------------------------------------------------- #
# observability
# --------------------------------------------------------------------- #


class TestObservability:
    def test_fusion_ratio_gauge_and_spans(self):
        from mmlspark_tpu_torch.observability.metrics import get_registry
        from mmlspark_tpu_torch.observability.tracing import get_tracer

        fm = _fuse(pipeline_model(_AddOneOnDevice(), _DoubleOnHost()), fused_label="ratio-test")
        tracer = get_tracer()
        before = len(tracer.spans())
        fm.transform(Table({"x": np.arange(8, dtype=np.float32)}))
        names = [s.name for s in tracer.spans()[before:]]
        assert "pipeline.fused_segment" in names
        gauge = get_registry().gauge(
            "mmlspark_tpu_pipeline_fusion_ratio",
            labels=("pipeline", "mesh_shape")).labels(pipeline="ratio-test", mesh_shape="1")
        assert gauge.value == pytest.approx(0.5)

    def test_timer_reports_device_host_split_for_fused(self):
        fm = _fuse(pipeline_model(_AddOneOnDevice(), _DoubleOnHost()))
        timer = Timer(fm)
        timer.transform(Table({"x": np.arange(8, dtype=np.float32)}))
        assert timer.last_segments is not None
        assert [s["kind"] for s in timer.last_segments] == ["fused", "host"]
        fused_seg, host_seg = timer.last_segments
        assert fused_seg["seconds"] == pytest.approx(
            fused_seg["device_seconds"] + fused_seg["host_seconds"])
        assert host_seg["device_seconds"] == 0.0
        assert host_seg["host_seconds"] == host_seg["seconds"]

    def test_timer_plain_stage_has_no_segments(self):
        timer = Timer(_DoubleOnHost())
        timer.transform(Table({"x": np.arange(4.0)}))
        assert timer.last_segments is None


# --------------------------------------------------------------------- #
# serving integration
# --------------------------------------------------------------------- #


def _post(url: str, payload: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


class TestServingIntegration:
    def test_serve_model_auto_fuses_pipeline_models(self):
        from mmlspark_tpu_torch.io_http.serving import serve_model

        fm = _fuse(pipeline_model(_mlp(f=2, outputs=2)), mini_batch_size=16)
        # warm every ladder bucket deterministically with the (n, 2) float64
        # features layout the serving handler stacks
        for n in ShapeBucketer(16).ladder:
            fm.transform(Table({"features": np.ones((n, 2), np.float64)}))
        seg = fm._segments[0]
        warm = seg._exec_cache.stats()
        srv = serve_model(fm, input_cols=["a", "b"], output_col="output", max_batch_size=16)
        try:
            def fire(n):
                errs = []

                def one(i):
                    try:
                        _post(srv.url, {"a": float(i), "b": 1.0})
                    except Exception as e:  # noqa: BLE001
                        errs.append(repr(e))

                ts = [threading.Thread(target=one, args=(i,)) for i in range(n)]
                for th in ts:
                    th.start()
                for th in ts:
                    th.join(timeout=30)
                assert not errs, errs

            for n in (1, 4, 8, 3, 7, 12, 16, 2, 9, 5):
                fire(n)
        finally:
            srv.stop()
        soaked = seg._exec_cache.stats()
        assert soaked["misses"] == warm["misses"]
        assert soaked["recompiles"] == warm["recompiles"]
        assert soaked["hits"] > warm["hits"]

    def test_serve_model_fuse_opt_out(self):
        from mmlspark_tpu_torch.io_http import serving as serving_mod

        captured = {}
        orig = serving_mod.ServingServer

        class Capture(orig):
            def __init__(self, handler, **kw):
                captured["handler"] = handler
                super().__init__(handler, **kw)

            def start(self):
                return self

            def stop(self):
                pass

        serving_mod.ServingServer, restore = Capture, orig
        try:
            serving_mod.serve_model(pipeline_model(_AddOneOnDevice()), input_cols=["x"],
                                    fuse_pipeline=False, device="cpu")
        finally:
            serving_mod.ServingServer = restore
        assert captured["handler"] is not None


# --------------------------------------------------------------------- #
# the image chain
# --------------------------------------------------------------------- #


class TestStreamingIntegration:
    """tests/test_fusion.py's TestStreamingIntegration: a StreamingQuery
    fuses a PipelineModel transform (on `device`, the CPU here), and its
    sunk bytes equal the staged transform's and the JAX package's streamed
    ones."""

    def test_query_auto_fuses_and_matches_staged(self):
        from mmlspark_tpu.core.fusion import DeviceKernel as RefKernel
        from mmlspark_tpu.core.pipeline import Transformer as RefTransformer
        from mmlspark_tpu.streaming import MemorySink as RefSink
        from mmlspark_tpu.streaming import MemorySource as RefSource
        from mmlspark_tpu.streaming.query import StreamingQuery as RefQuery
        from mmlspark_tpu_torch.streaming import MemorySink, MemorySource
        from mmlspark_tpu_torch.streaming.query import StreamingQuery

        class _RefAddOne(RefTransformer):
            """tests/test_fusion.py's _AddOneOnDevice, in the JAX package."""

            def _transform(self, table):
                return table.with_column("x", np.asarray(table["x"], np.float32) + np.float32(1))

            def device_kernel(self):
                return RefKernel(fn=lambda p, cols: {"x": cols["x"].astype("float32") + 1},
                                 input_cols=("x",), output_cols=("x",),
                                 out_dtypes={"x": np.float32})

        model = pipeline_model(_AddOneOnDevice(), _AddOneOnDevice())
        src, sink = MemorySource(), MemorySink()
        q = StreamingQuery(src, model, sink, device="cpu")
        assert isinstance(q.transform, FusedPipelineModel)
        assert q.transform.get("device") == "cpu"
        x = np.arange(6, dtype=np.float32)
        t = Table({"x": x})
        src.add_rows(t)
        assert q.process_all_available() == 1
        staged = model.transform(t)
        assert sink.table()["x"].tobytes() == staged["x"].tobytes()
        assert q.transform.last_stats["n_fused_stages"] == 2

        ref_src, ref_sink = RefSource(), RefSink()
        rq = RefQuery(ref_src, ref_pipeline_model(_RefAddOne(), _RefAddOne()), ref_sink)
        ref_src.add_rows(RefTable({"x": x}))
        assert rq.process_all_available() == 1
        assert sink.table()["x"].tobytes() == np.asarray(ref_sink.table()["x"]).tobytes()

    def test_query_fuse_opt_out_keeps_model(self):
        from mmlspark_tpu_torch.streaming import MemorySink, MemorySource
        from mmlspark_tpu_torch.streaming.query import StreamingQuery

        model = pipeline_model(_AddOneOnDevice())
        q = StreamingQuery(MemorySource(), model, MemorySink(), fuse_pipeline=False)
        assert q.transform is model

    def test_query_on_cuda_without_a_card_raises(self):
        from mmlspark_tpu_torch.streaming import MemorySink, MemorySource
        from mmlspark_tpu_torch.streaming.query import StreamingQuery

        if torch.cuda.is_available():
            pytest.skip("a card is present: cuda is not refused here")
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            StreamingQuery(MemorySource(), pipeline_model(_AddOneOnDevice()), MemorySink())


class TestImageChainCache:
    def test_fused_op_chain_builds_once_a_shape(self):
        """The port runs the op chain eagerly (nothing to compile), so the
        JAX test's compile count becomes the fused segment's: one build a
        shape, reused across transforms."""
        rng = np.random.default_rng(7)
        it = ImageTransformer(input_col="image", output_col="o", device="cpu") \
            .resize(8, 8).blur(3, 3)
        fm = _fuse(pipeline_model(it), mini_batch_size=8)
        t = Table({"image": rng.uniform(0, 255, size=(6, 10, 10, 3))})
        first = fm.transform(t)
        seg = fm._segments[0]
        assert seg._exec_cache.stats()["misses"] == 1
        second = fm.transform(t)
        assert seg._exec_cache.stats()["misses"] == 1
        assert first["o"].tobytes() == second["o"].tobytes()
        fm.transform(Table({"image": rng.uniform(0, 255, size=(3, 12, 12, 3))}))
        assert seg._exec_cache.stats()["misses"] == 2
        assert seg._exec_cache.stats()["recompiles"] == 0      # a new family, not a rung

    def test_image_chain_fused_matches_staged(self):
        rng = np.random.default_rng(8)
        imgs = rng.uniform(0, 255, size=(9, 10, 10, 3))
        t = Table({"image": imgs})
        it = ImageTransformer(input_col="image", output_col="o", device="cpu") \
            .resize(8, 8).gray(keep_channels=True).threshold(90.0)
        staged = it.transform(t)
        fm = _fuse(pipeline_model(it), mini_batch_size=4)
        fused = fm.transform(t)
        assert fm.last_stats["segments"][0]["kind"] == "fused"
        assert staged["o"].tobytes() == fused["o"].tobytes()
        assert staged.meta("o") == fused.meta("o")
        ref = RefImageTransformer(input_col="image", output_col="o") \
            .resize(8, 8).gray(keep_channels=True).threshold(90.0)
        ref_staged = ref.transform(RefTable({"image": imgs}))
        # the port's resize against jax.image.resize (tests/test_torch_image_ops.py)
        np.testing.assert_allclose(fused["o"], ref_staged["o"], atol=5e-3)
        assert ref_staged.meta("o") == fused.meta("o")

    def test_ragged_image_column_falls_back(self):
        rng = np.random.default_rng(9)
        imgs = [rng.uniform(size=(10, 10, 3)), rng.uniform(size=(12, 12, 3))]
        t = Table({"image": imgs})
        it = ImageTransformer(input_col="image", output_col="o", device="cpu").resize(8, 8)
        fm = _fuse(pipeline_model(it))
        fused = fm.transform(t)
        assert fm.last_stats["segments"][0]["kind"] == "host_fallback"
        staged = it.transform(t)
        assert staged["o"].tobytes() == fused["o"].tobytes()

    def test_featurizer_fused_matches_staged(self):
        """ImageFeaturizer's kernel: resize -> truncated forward -> flatten
        in one segment, equal to the staged stage byte for byte."""
        from mmlspark_tpu_torch.nn.featurizer import ImageFeaturizer

        rng = np.random.default_rng(10)
        jb = RefBundle.init("resnet", (8, 8, 3), seed=0, num_outputs=4, stage_sizes=(1,),
                            num_filters=4)
        bundle = ModelBundle(architecture="resnet", config=dict(jb.config),
                             variables=jax.tree.map(np.asarray, jb.variables),
                             input_shape=(8, 8, 3))
        feat = ImageFeaturizer(input_col="image", output_col="f", device="cpu",
                               mini_batch_size=4).set_model(bundle)
        t = Table({"image": rng.uniform(0, 255, size=(6, 12, 12, 3)).astype(np.float32)})
        staged = feat.transform(t)
        fm = _fuse(pipeline_model(feat), mini_batch_size=4)
        fused = fm.transform(t)
        assert fm.last_stats["segments"][0]["kind"] == "fused"
        _assert_identical(staged, fused)
