"""The port's phase profiler (mmlspark_tpu_torch/observability/profiler.py)
and profiling utilities held against the JAX package's: the mirror of
tests/test_profiler.py's TestLedgerUnits, TestServingHotPath,
TestPerfettoRoundTrip and TestFleetAttribution. The deterministic
scenarios (FakeClock ledgers, fleet merges) run in both packages and must
give equal records, attribution rows, rendered tables and series; the live
server compares its phase set and ledger count, and each package's
coverage band.

TestBenchGate is not mirrored: it tests tools/bench_gate.py, a tool of the
JAX package's benchmark, not a module of the package.

Cost analysis must run nothing (the port's dispatched callables replay
CUDA graphs): TestCostRunsNothing holds that an armed ledger's `cost`
never calls the dispatched callable and leaves every kernel counter and
the segment's forward and replay counts as they were."""

from __future__ import annotations

import json
import os
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tests.test_torch_streaming_common import PORT, REF, both, canon, ns  # noqa: E402


def _fake_clock(m):
    return __import__(f"{m.name}.resilience.policy", fromlist=["FakeClock"]).FakeClock()


def _prof(m, clock=None, **kw):
    return m.profiler.Profiler(registry=m.metrics.MetricsRegistry(),
                               clock=clock if clock is not None else _fake_clock(m),
                               enabled=True, **kw)


# --------------------------------------------------------------------- #
# the vocabulary and the series                                         #
# --------------------------------------------------------------------- #


class TestVocabulary:
    def test_phases_and_series_are_the_reference_s(self):
        ref, port = ns(REF), ns(PORT)
        assert port.profiler.PHASES == ref.profiler.PHASES
        assert port.profiler.PROFILER_SERIES == ref.profiler.PROFILER_SERIES
        for name in ("PHASE_SECONDS", "SHARD_SECONDS", "ROWS_REAL_TOTAL",
                     "ROWS_PADDED_TOTAL", "LEDGERS_TOTAL", "PHASE_LABEL"):
            assert getattr(port.profiler, name) == getattr(ref.profiler, name)
        assert sorted(port.profiler.__all__) == sorted(ref.profiler.__all__)


# --------------------------------------------------------------------- #
# ledger units on FakeClock                                             #
# --------------------------------------------------------------------- #


class TestLedgerUnits:
    def test_phase_bracket_times_on_injected_clock(self):
        def run(m):
            clock = _fake_clock(m)
            prof = _prof(m, clock)
            led = prof.ledger("fused", "seg0")
            with led.phase("compute"):
                clock.advance(0.005)
            with led.phase("queue"):
                clock.advance(0.001)
            with led.phase("queue"):  # same phase accumulates
                clock.advance(0.002)
            led.add("d2h", 0.0005)
            led.done(rtt_s=0.010)
            return [prof.records(), prof.attribution()]

        (rec,), (row,) = both(run)
        assert rec["phases"]["compute"] == pytest.approx(0.005)
        assert rec["phases"]["queue"] == pytest.approx(0.003)
        assert rec["phases"]["d2h"] == pytest.approx(0.0005)
        assert rec["rtt_s"] == pytest.approx(0.010)
        assert row["kind"] == "fused" and row["segment"] == "seg0"
        assert row["phase_us"]["compute"] == pytest.approx(5000.0)
        assert row["phase_sum_us"] == pytest.approx(8500.0)
        assert row["coverage"] == pytest.approx(0.85)

    def test_pad_accounting_and_waste(self):
        def run(m):
            prof = _prof(m)
            led = prof.ledger("request", "host")
            led.note_pad(rows_real=6, rows_target=8)
            led.done(rtt_s=0.001)
            return prof.attribution()

        (row,) = both(run)
        assert row["rows_real"] == 6 and row["rows_padded"] == 2
        assert row["pad_waste"] == pytest.approx(0.25)

    def test_shard_attribution_names_slowest(self):
        def run(m):
            prof = _prof(m)
            led = prof.ledger("fused", "seg0@2x1")
            led.note_shard("cpu:0", 0.002, rows=128)
            led.note_shard("cpu:1", 0.006, rows=128)
            led.done(rtt_s=0.008)
            return [prof.attribution(), m.profiler.render_attribution(prof.attribution())]

        (row,), text = both(run)
        assert row["slowest_shard"] == "cpu:1"
        assert row["shard_skew"] == pytest.approx(3.0)
        assert row["shards"][0]["rows"] == 128
        assert "<- slowest" in text

    def test_phase_vocabulary_is_closed(self):
        def run(m):
            led = _prof(m).ledger("fused", "s")
            msgs = []
            with pytest.raises(ValueError) as e:
                led.phase("warmup")
            msgs.append(str(e.value))
            with pytest.raises(ValueError) as e:
                led.add("warmup", 0.1)
            msgs.append(str(e.value))
            led.done()
            return msgs

        both(run)

    def test_negative_add_clamps_to_zero(self):
        def run(m):
            prof = _prof(m)
            led = prof.ledger("fused", "s")
            led.add("h2d", -0.5)
            led.done()
            return prof.records()

        (rec,) = both(run)
        assert rec["phases"]["h2d"] == 0.0

    def test_disarmed_path_is_shared_null_ledger(self):
        def run(m):
            prof = m.profiler.Profiler(registry=m.metrics.MetricsRegistry(), enabled=False)
            led = prof.ledger("request", "host")
            shared = led is m.profiler.NULL_LEDGER and led.armed is False
            with led.phase("compute"):
                pass
            assert led.cost("k", lambda *a: 1 / 0, 1) is None
            led.done(rtt_s=1.0)
            return [shared, prof.records(), prof.snapshot()]

        shared, records, snap = both(run)
        assert shared and records == []
        assert snap == {"enabled": False, "ledgers": 0, "attribution": []}

    def test_pooling_recycles_after_commit(self):
        def run(m):
            prof = _prof(m)
            led = prof.ledger("fused", "s")
            led.add("compute", 0.001)
            led.done(rtt_s=0.002)
            prof.flush()
            (rec,) = prof.records()
            led2 = prof.ledger("fused", "s2")
            return [led2 is led, led2.phases, led2.segment, rec["phases"]]

        assert both(run) == [True, {}, "s2", {"compute": 0.001}]

    def test_reads_flush_the_async_commit_queue(self):
        def run(m):
            prof = _prof(m)
            prof.ledger("fused", "s").done(rtt_s=0.001)
            return prof.snapshot()

        snap = both(run)
        assert snap["ledgers"] == 1 and snap["enabled"] is True

    def test_registry_series_and_labels(self):
        def run(m):
            prof = _prof(m)
            led = prof.ledger("request", "host")
            led.add("compute", 0.002)
            led.note_pad(3, 4)
            led.done(rtt_s=0.003)
            prof.flush()
            return [prof.registry.snapshot(), prof.registry.render_prometheus()]

        snap, text = both(run)
        p = ns(PORT).profiler
        samples = snap[p.PHASE_SECONDS]["samples"]
        assert all(s["labels"]["phase"] in p.PHASES for s in samples)
        assert any(s["labels"] == {"kind": "request", "segment": "host",
                                   "phase": "compute"} for s in samples)
        assert snap[p.LEDGERS_TOTAL]["samples"][0]["value"] == 1
        assert snap[p.ROWS_REAL_TOTAL]["samples"][0]["value"] == 3
        assert snap[p.ROWS_PADDED_TOTAL]["samples"][0]["value"] == 1
        assert p.PHASE_SECONDS in text

    def test_recorder_receives_ledger_events(self):
        def run(m):
            rec = m.recorder.FlightRecorder(capacity=16)
            prof = m.profiler.Profiler(registry=m.metrics.MetricsRegistry(), recorder=rec,
                                       clock=_fake_clock(m), enabled=True)
            led = prof.ledger("fused", "seg1")
            led.add("compute", 0.004)
            led.note_pad(5, 8)
            led.done(rtt_s=0.005)
            prof.flush()
            return [(e["kind"], e["data"]) for e in rec.events()]

        events = both(run)
        assert [d["segment"] for k, d in events if k == "profiler.ledger"] == ["seg1"]


# --------------------------------------------------------------------- #
# serving hot path: phase sum vs measured RTT                           #
# --------------------------------------------------------------------- #


class TestServingHotPath:
    def test_phase_decomposition_covers_request_rtt(self):
        def run(m):
            def handler(table):
                t = m.http_schema.parse_request(table)
                return m.http_schema.make_reply(
                    t.with_column("y", np.asarray(t["x"], dtype=float) * 2), "y")

            prof = m.profiler.Profiler(registry=m.metrics.MetricsRegistry(), enabled=True)
            prev = m.profiler.set_default_profiler(prof)
            srv = m.serving.ServingServer(handler, metrics=m.metrics.MetricsRegistry()).start()
            replies = []
            try:
                for i in range(8):
                    req = urllib.request.Request(
                        srv.url, data=json.dumps({"x": float(i)}).encode(),
                        headers={"Content-Type": "application/json"}, method="POST")
                    replies.append(urllib.request.urlopen(req, timeout=10).read())
                info = srv._profiler_info()
            finally:
                srv.stop()
                m.profiler.set_default_profiler(prev)
            rows = [r for r in prof.attribution() if r["kind"] == "request"]
            assert rows, "no request ledgers committed on the hot path"
            row = rows[0]
            # the phase sum explains the request RTT: not a sliver of it,
            # not more than it (a live server, so a generous band)
            assert row["coverage"] is not None and 0.35 <= row["coverage"] <= 1.15
            txt = m.profiler.render_attribution(rows)
            assert "request" in txt and "cov%" in txt
            return [replies, row["count"], sorted(row["phase_us"]), info["enabled"],
                    [r["kind"] for r in info["attribution"]]]

        replies, count, phases, enabled, kinds = both(run)
        assert count == 8 and "queue" in phases and "compute" in phases
        assert enabled is True and "request" in kinds

    def test_default_profiler_starts_disarmed(self):
        port = ns(PORT)
        fresh = port.profiler.Profiler()
        assert fresh.enabled is False
        assert port.profiler.get_profiler() is port.profiler.get_profiler()

    def test_fused_segment_records_when_armed(self):
        """core/fusion.py's ledger is the profiler's now: an armed fused run
        of a device-capable stage on the CPU commits one `fused` ledger with
        the phases the JAX package's does."""
        def run(m):
            missing = __import__(f"{m.name}.ops.missing", fromlist=["CleanMissingData"])
            v = np.array([1.0, np.nan, 3.0, 4.0, np.nan], np.float32)
            t = m.Table({"v": v})
            model = missing.CleanMissingData(input_cols=["v"], output_cols=["w"],
                                             cleaning_mode="Mean").fit(t)
            fm = m.fusion.fuse(m.pipeline.pipeline_model(model), **m.dev)
            prof = m.profiler.Profiler(registry=m.metrics.MetricsRegistry(), enabled=True)
            prev = m.profiler.set_default_profiler(prof)
            try:
                out = fm.transform(t)
            finally:
                m.profiler.set_default_profiler(prev)
            (row,) = prof.attribution()
            return [out, row["kind"], row["segment"], sorted(row["phase_us"]),
                    row["rows_real"], row["rows_padded"], row["count"]]

        out = both(run)
        assert out[1:3] == ["fused", "seg0"] and "compute" in out[3]


# --------------------------------------------------------------------- #
# Perfetto round trip: phase child-spans                                #
# --------------------------------------------------------------------- #


class TestPerfettoRoundTrip:
    def test_phase_child_spans_export_and_reload(self, tmp_path):
        def run(m, d):
            tracer = m.tracing.Tracer(enabled=True)
            prof = m.profiler.Profiler(registry=m.metrics.MetricsRegistry(), tracer=tracer,
                                       enabled=True, spans=True)
            with tracer.start_span("serving.score") as span:
                led = prof.ledger("request", "host", span=span)
                for p in ("prepare", "compute", "d2h"):
                    with led.phase(p):
                        pass
                led.done(rtt_s=0.001)
            prof.flush()
            path = str(d / "trace.jsonl")
            n = tracer.export_jsonl(path)
            events = m.tracing.load_jsonl(path)
            by_parent = m.tracing.phase_children(events, parent_span_id=span.span_id)
            blob = json.dumps({"traceEvents": events})
            assert json.loads(blob)["traceEvents"]
            return [n >= 4, sorted(by_parent.get(span.span_id, {})),
                    sorted(e["name"] for e in events)]

        ok, phases, names = both(run, tmp_path)
        assert ok and phases == ["compute", "d2h", "prepare"]

    def test_spans_are_opt_in(self):
        def run(m):
            tracer = m.tracing.Tracer(enabled=True)
            prof = m.profiler.Profiler(registry=m.metrics.MetricsRegistry(), tracer=tracer,
                                       enabled=True)
            with tracer.start_span("serving.score") as span:
                led = prof.ledger("request", "host", span=span)
                with led.phase("compute"):
                    pass
                led.done(rtt_s=0.001)
            prof.flush()
            return sorted(s.name for s in tracer.spans())

        assert both(run) == ["serving.score"]


# --------------------------------------------------------------------- #
# fleet aggregation across replicas                                     #
# --------------------------------------------------------------------- #


class TestFleetAttribution:
    def test_two_replica_merge_via_aggregator_snapshot(self):
        def run(m):
            texts = {}
            for rid, compute_s, shard_s in (("r0", 0.002, 0.004), ("r1", 0.006, 0.001)):
                reg = m.metrics.MetricsRegistry()
                prof = m.profiler.Profiler(registry=reg, clock=_fake_clock(m), enabled=True)
                led = prof.ledger("fused", "seg0")
                led.add("compute", compute_s)
                led.add("h2d", 0.001)
                led.note_pad(10, 16)
                led.note_shard(f"chip:{rid}", shard_s, rows=64)
                led.done(rtt_s=compute_s + 0.001)
                prof.flush()
                texts[rid] = reg.render_prometheus()
            agg = m.fleet.MetricsAggregator()
            for rid, text in texts.items():
                agg.push(rid, text)
            rows = m.profiler.attribution_from_snapshot(agg.snapshot())
            return [texts, rows, m.profiler.render_attribution(rows, title="fleet")]

        _texts, rows, _text = both(run)
        (row,) = [r for r in rows if r["segment"] == "seg0"]
        assert row["count"] == 2
        assert row["phase_us"]["compute"] == pytest.approx(4000.0)
        assert row["rows_real"] == 20 and row["rows_padded"] == 12
        assert row["slowest_shard"] == "chip:r0"
        assert row["shard_skew"] == pytest.approx(4.0)

    def test_port_and_reference_replicas_merge(self):
        """A fleet of one JAX-package replica and one port replica: the
        port's exposition merges with the reference's as its own does."""
        texts = {}
        for rid, pkg, compute_s in (("r0", REF, 0.002), ("r1", PORT, 0.006)):
            m = ns(pkg)
            reg = m.metrics.MetricsRegistry()
            prof = m.profiler.Profiler(registry=reg, clock=_fake_clock(m), enabled=True)
            led = prof.ledger("fused", "seg0")
            led.add("compute", compute_s)
            led.done(rtt_s=compute_s)
            prof.flush()
            texts[rid] = reg.render_prometheus()
        out = {}
        for pkg in (REF, PORT):
            m = ns(pkg)
            agg = m.fleet.MetricsAggregator()
            for rid, text in texts.items():
                agg.push(rid, text)
            out[pkg] = m.profiler.attribution_from_snapshot(agg.snapshot())
        assert canon(out[PORT]) == canon(out[REF])
        assert out[PORT][0]["phase_us"]["compute"] == pytest.approx(4000.0)

    def test_single_registry_snapshot_matches_live_attribution(self):
        def run(m):
            reg = m.metrics.MetricsRegistry()
            prof = m.profiler.Profiler(registry=reg, clock=_fake_clock(m), enabled=True)
            led = prof.ledger("request", "host")
            led.add("queue", 0.001)
            led.add("compute", 0.003)
            led.done(rtt_s=0.005)
            prof.flush()
            return [prof.attribution(), m.profiler.attribution_from_snapshot(reg.snapshot())]

        (live,), (snap,) = both(run)
        assert snap["phase_us"]["compute"] == pytest.approx(live["phase_us"]["compute"])
        assert snap["phase_sum_us"] == pytest.approx(live["phase_sum_us"])


# --------------------------------------------------------------------- #
# cost analysis runs nothing                                            #
# --------------------------------------------------------------------- #


class TestFlushWaitsForACommitInFlight:
    def test_attribution_waits_for_a_ledger_another_thread_popped(self):
        """A read flushes before it copies the aggregate. The committer
        (here a thread calling `flush`, as the background drainer does) is
        parked between its pop of the only ledger and that ledger's
        commit: `attribution()` on another thread must wait for the commit
        and then see the row, not return an empty table."""
        import threading

        port = ns(PORT)
        prof = port.profiler.Profiler(registry=port.metrics.MetricsRegistry(), enabled=True)
        prof._ensure_drainer = lambda: None      # this test's thread is the committer
        popped, release, read_done = threading.Event(), threading.Event(), threading.Event()
        commit = prof._commit

        def parked(led):
            popped.set()
            assert release.wait(30)
            commit(led)

        prof._commit = parked
        led = prof.ledger("fused", "seg0")
        led.add("compute", 0.002)
        led.done(rtt_s=0.003)
        committer = threading.Thread(target=prof.flush)
        committer.start()
        assert popped.wait(30)
        rows = []

        def read():
            rows.extend(prof.attribution())
            read_done.set()

        reader = threading.Thread(target=read)
        reader.start()
        try:
            assert not read_done.wait(0.5), \
                "attribution() returned while a popped ledger was uncommitted"
        finally:
            release.set()
            committer.join(30)
            reader.join(30)
        (row,) = rows
        assert (row["kind"], row["segment"]) == ("fused", "seg0")
        assert "compute" in row["phase_us"]


class TestCostRunsNothing:
    def test_cost_is_none_and_calls_nothing(self):
        """The JAX package's answer for a callable it cannot lower, here for
        every callable: None, and the dispatched callable is not called."""
        port = ns(PORT)
        calls = []

        def dispatched(*args):
            calls.append(args)

        prof = _prof(port)
        led = prof.ledger("fused", "seg0")
        x = torch.ones(4, 8)
        assert led.cost(("fam", 4), dispatched, (x,)) is None
        assert port.profiler.cost_analysis_of(dispatched, (x,)) is None
        led.add("compute", 0.001)
        led.done(rtt_s=0.001)
        assert calls == []
        (row,) = prof.attribution()
        assert row["gflops"] is None and row["achieved_gflops_per_s"] is None

    def test_armed_fused_transformer_counts_and_replays_unchanged(self):
        """An armed fused run of the flash-attention transformer: `cost` is
        called on each dispatch and runs nothing, so the segment's forwards
        equal its dispatches, replays stay 0 on the CPU, and every kernel
        counter (core.kernels.LAUNCH_COUNTERS) is where the disarmed run
        leaves it."""
        from mmlspark_tpu_torch.core import kernels
        from mmlspark_tpu_torch.nn import DeepModelTransformer, ModelBundle

        port = ns(PORT)
        bundle = ModelBundle.init("transformer", (16,), seed=0, attention_impl="flash",
                                  num_layers=2, d_model=32, num_heads=2, d_ff=64,
                                  vocab_size=64, max_len=16, num_outputs=3)
        tokens = np.random.default_rng(0).integers(0, 64, size=(40, 16)).astype(np.float64)
        t = port.Table({"features": tokens})
        results = {}
        for armed in (False, True):
            runner = DeepModelTransformer(input_col="features", device="cpu",
                                          fetch_dict={"probability": "probability"}
                                          ).set_model(bundle)
            fm = port.fusion.fuse(port.pipeline.pipeline_model(runner), device="cpu",
                                  mini_batch_size=16)
            before = [(f.__name__, f.launches) for f in kernels.LAUNCH_COUNTERS]
            prof = port.profiler.Profiler(registry=port.metrics.MetricsRegistry(),
                                          enabled=armed)
            prev = port.profiler.set_default_profiler(prof)
            try:
                out = fm.transform(t)
            finally:
                port.profiler.set_default_profiler(prev)
            seg = fm._ensure_segments()[0]
            after = [(f.__name__, f.launches) for f in kernels.LAUNCH_COUNTERS]
            results[armed] = dict(out=np.asarray(out["probability"]), forwards=seg.forwards,
                                  replays=seg.replays, counters=after == before,
                                  attribution=prof.attribution())
        off, on = results[False], results[True]
        assert on["forwards"] == off["forwards"] == 3          # 40 rows in 16-row chunks
        assert on["replays"] == off["replays"] == 0
        assert on["counters"] and off["counters"]
        np.testing.assert_array_equal(on["out"], off["out"])
        (row,) = on["attribution"]
        assert row["kind"] == "fused" and row["phase_us"].get("compute", 0.0) >= 0.0
        assert "compute" in row["phase_us"] and row["gflops"] is None
        assert off["attribution"] == []


# --------------------------------------------------------------------- #
# utils/profiling                                                       #
# --------------------------------------------------------------------- #


class TestProfilingUtils:
    def test_profile_fn_stats_match_the_reference_on_a_fake_clock(self):
        def run(m):
            profiling = __import__(f"{m.name}.utils.profiling", fromlist=["profile_fn"])
            ticks = iter(np.arange(0.0, 100.0, 0.5).tolist())
            reg = m.metrics.MetricsRegistry()
            out, stats = profiling.profile_fn(lambda x: np.asarray(x) * 2, [1.0, 2.0],
                                              warmup=2, iters=3, registry=reg,
                                              name="double", clock=lambda: next(ticks))
            return [out, stats, reg.snapshot()]

        out, stats, _snap = both(run)
        assert stats["iters"] == 3 and stats["steady_s"] == 0.5
        assert "device_steady_s" not in stats             # no CUDA tensor here

    def test_device_trace_writes_a_chrome_trace_with_annotations(self, tmp_path, monkeypatch):
        from mmlspark_tpu_torch.utils import profiling

        monkeypatch.delenv("MMLSPARK_TPU_TRACE_DIR", raising=False)
        with profiling.device_trace(None) as target:
            assert target is None                     # unset: a no-op
        with profiling.device_trace(str(tmp_path / "tr")) as target:
            with profiling.annotate("port.region"):
                torch.ones(8, 8) @ torch.ones(8, 8)
        path = profiling.device_trace.last_path
        assert path and os.path.dirname(path) == target and os.path.exists(path)
        with open(path) as fh:
            names = {e.get("name") for e in json.load(fh)["traceEvents"]}
        assert "port.region" in names
        monkeypatch.setenv("MMLSPARK_TPU_TRACE_DIR", str(tmp_path / "env"))
        with profiling.device_trace(None) as target:
            pass
        assert target == str(tmp_path / "env") and os.listdir(target)

    def test_block_until_ready_passes_cpu_trees_through(self):
        from mmlspark_tpu_torch.utils import profiling

        tree = {"a": torch.ones(2), "b": [np.zeros(1), (torch.zeros(3),)]}
        assert profiling.block_until_ready(tree) is tree

        class Outs(tuple):
            pass

        waited = []
        outs = Outs((torch.ones(1),))
        outs.event = type("E", (), {"synchronize": lambda self: waited.append(1)})()
        assert profiling.block_until_ready(outs) is outs and waited == [1]
