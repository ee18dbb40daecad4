"""The port's instrumented stages (mmlspark_tpu_torch/observability/stage.py)
and plot helpers (mmlspark_tpu_torch/plot.py) held against the JAX
package's: the same wrapped transforms give the same tables, series and
recorder events; stages saved by one package load in the other; the plot
arrays (confusion matrix, ROC curve, AUC) are equal with `ax=False`, which
needs no matplotlib."""

from __future__ import annotations

import importlib
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tests.test_torch_streaming_common import PORT, REF, both, canon, ns  # noqa: E402


def _inner(m):
    stages = importlib.import_module(f"{m.name}.ops.stages")
    return stages.SelectColumns(cols=["a", "b"])


def _table(m, n=12, seed=0):
    rng = np.random.default_rng(seed)
    return m.Table({"a": rng.normal(size=n), "b": rng.integers(0, 5, n).astype(np.float64),
                    "c": rng.normal(size=n)})


def _failing(m):
    """A transformer that raises, of package `m`."""
    class Failing(m.pipeline.Transformer):
        def _transform(self, table):
            raise RuntimeError("inner stage failed")

    return Failing()


class TestInstrumentedTransformer:
    def test_metrics_span_and_passthrough(self):
        def run(m):
            reg = m.metrics.MetricsRegistry()
            tracer = m.tracing.Tracer(enabled=True)
            st = m.stage.InstrumentedTransformer(_inner(m), stage_name="select")
            st.metrics, st.tracer = reg, tracer
            t = _table(m)
            out = st.transform(t)
            st.transform(t)
            snap = reg.snapshot()
            hist = snap["mmlspark_tpu_pipeline_stage_seconds"]["samples"][0]
            rows = snap["mmlspark_tpu_pipeline_stage_rows_total"]["samples"][0]
            off = m.stage.InstrumentedTransformer(_inner(m), disable=True)
            off.metrics = m.metrics.MetricsRegistry()
            off_out = off.transform(t)
            return [out, hist["labels"], hist["count"], rows["value"],
                    [s.name for s in tracer.spans()], st.last_elapsed is not None,
                    off_out, off.metrics.snapshot()]

        out, labels, count, rows, spans, timed, off_out, off_snap = both(run)
        assert out.columns == ["a", "b"] and labels == {"stage": "select"}
        assert count == 2 and rows == 24 and spans == ["stage:select", "stage:select"]
        assert timed and off_out.columns == ["a", "b"] and off_snap == {}

    def test_save_load_roundtrip_and_across_packages(self, tmp_path):
        outs = {}
        for src in (REF, PORT):
            m = ns(src)
            st = m.stage.InstrumentedTransformer(_inner(m), stage_name="sel")
            path = str(tmp_path / src)
            st.save(path)
            for dst in (REF, PORT):
                d = ns(dst)
                loaded = d.pipeline.PipelineStage.load(path)
                assert type(loaded).__module__ == f"{dst}.observability.stage"
                assert loaded.get("stage_name") == "sel"
                assert type(loaded.get("inner")).__name__ == "SelectColumns"
                outs[(src, dst)] = canon(loaded.transform(_table(d)))
        assert len(set(map(repr, outs.values()))) == 1


class TestFlightRecorderTransformer:
    def test_events_exemplars_and_metrics(self):
        def run(m):
            reg = m.metrics.MetricsRegistry()
            tracer = m.tracing.Tracer(enabled=True)
            rec = m.recorder.FlightRecorder(capacity=32)
            st = m.stage.FlightRecorderTransformer(_inner(m), stage_name="sel")
            st.metrics, st.tracer, st.recorder = reg, tracer, rec
            out = st.transform(_table(m))
            events = [(e["kind"], sorted(e["data"])) for e in rec.events()]
            samples = reg.snapshot()["mmlspark_tpu_pipeline_stage_recorded_seconds"]["samples"]
            return [out, events, [s["labels"] for s in samples], samples[0]["count"]]

        out, events, labels, count = both(run)
        assert ("stage.transform", ["elapsed_s", "rows", "stage", "trace_id"]) in events
        assert labels == [{"stage": "sel"}] and count == 1

    def test_exception_dumps_the_ring_and_reraises(self, tmp_path):
        def run(m, d):
            st = m.stage.FlightRecorderTransformer(_failing(m), stage_name="boom",
                                                   flight_recorder_dir=str(d / "fr"))
            st.metrics = m.metrics.MetricsRegistry()
            with pytest.raises(RuntimeError, match="inner stage failed"):
                st.transform(_table(m))
            dumps = sorted(os.listdir(d / "fr"))
            kinds = [e["kind"] for e in st.recorder.events()]
            return [len(dumps), "stage.exception" in kinds]

        assert both(run, tmp_path) == [1, True]

    def test_save_load_keeps_params_across_packages(self, tmp_path):
        for src, dst in ((REF, PORT), (PORT, REF), (PORT, PORT)):
            m, d = ns(src), ns(dst)
            st = m.stage.FlightRecorderTransformer(
                _inner(m), stage_name="sel", ring_capacity=64, tick_interval_s=1.5,
                flight_recorder_dir=str(tmp_path / "dumps"))
            path = str(tmp_path / f"{src}-{dst}")
            st.save(path)
            loaded = d.pipeline.PipelineStage.load(path)
            assert type(loaded).__module__ == f"{dst}.observability.stage"
            assert loaded.get("ring_capacity") == 64 and loaded.get("tick_interval_s") == 1.5
            assert loaded.get("flight_recorder_dir") == str(tmp_path / "dumps")
            loaded.metrics = d.metrics.MetricsRegistry()
            assert loaded.transform(_table(d)).columns == ["a", "b"]
            assert loaded.recorder.dump_dir == str(tmp_path / "dumps")


def _scored(m, n=200, seed=3):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n).astype(np.float64)
    s = np.clip(y * 0.3 + rng.normal(0.35, 0.25, n), 0, 1)
    pred = (s > 0.5).astype(np.float64)
    return m.Table({"label": y, "scores": s, "scored_labels": pred})


class TestPlot:
    def test_confusion_matrix_arrays_without_rendering(self):
        def run(m):
            t = _scored(m)
            mat, ax = m.plot.plot_confusion_matrix(t, ax=False)
            return [m.plot.confusion_matrix(t), mat, ax]

        direct, mat, ax = both(run)
        assert ax is None and np.array_equal(direct, mat)
        assert mat.shape == (2, 2) and mat.sum() == 200 and mat.dtype == np.int64

    def test_multiclass_confusion_matrix(self):
        def run(m):
            rng = np.random.default_rng(5)
            y = rng.integers(0, 4, 50).astype(np.float64)
            p = np.where(rng.random(50) < 0.7, y, rng.integers(0, 4, 50)).astype(np.float64)
            return m.plot.confusion_matrix(m.Table({"label": y, "pred": p}),
                                           prediction_col="pred")

        mat = both(run)
        assert mat.shape == (4, 4) and mat.sum() == 50

    def test_roc_arrays_and_auc_without_rendering(self):
        def run(m):
            (fpr, tpr, thr), auc, ax = m.plot.plot_roc(_scored(m), ax=False)
            return [fpr, tpr, thr, auc, ax]

        fpr, tpr, thr, auc, ax = both(run)
        assert ax is None and 0.5 < auc <= 1.0
        assert fpr[0] == 0.0 and tpr[-1] == 1.0 and len(fpr) == len(tpr) == len(thr)

    def test_ax_false_works_without_matplotlib(self, monkeypatch):
        port = ns(PORT)
        for name in [k for k in sys.modules if k == "matplotlib" or k.startswith("matplotlib.")]:
            monkeypatch.delitem(sys.modules, name)
        monkeypatch.setitem(sys.modules, "matplotlib", None)     # import fails
        mat, ax = port.plot.plot_confusion_matrix(_scored(port), ax=False)
        _, auc, ax2 = port.plot.plot_roc(_scored(port), ax=False)
        assert ax is None and ax2 is None and mat.sum() == 200 and auc > 0.5
        with pytest.raises(ImportError):
            port.plot.plot_roc(_scored(port))

    def test_renders_when_matplotlib_is_there(self):
        pytest.importorskip("matplotlib")
        port = ns(PORT)
        _, ax = port.plot.plot_confusion_matrix(_scored(port))
        assert ax.get_title() == "confusion matrix" and len(ax.texts) == 4
        _, _, ax = port.plot.plot_roc(_scored(port))
        assert ax.get_title() == "ROC" and len(ax.lines) == 2
