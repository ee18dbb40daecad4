"""The port's telemetry timeline (mmlspark_tpu_torch/observability/
timeline.py) held to the JAX package's: tests/test_timeline.py's
TestStoreDurability, TestAlertRule, TestAlertEngine, TestRegressionWatch,
TestTimelineRecorder, TestRecorderDumpRetention, TestAutoscalerTrend,
TestWindowedBurnSignal and TestGatewayTimeline through the port on the
CPU; a store written by either package opened by the other, with the same
segment bytes and the same query answers; and AlertRule accepting and
rejecting the same expressions in both. All clock-driven tests run on a
fake clock.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu_torch.observability.metrics import MetricsRegistry
from mmlspark_tpu_torch.observability.recorder import (DUMP_PREFIX,
                                                 FlightRecorder)
from mmlspark_tpu_torch.observability.timeline import (AlertEngine, AlertRule,
                                                 RegressionWatch,
                                                 TimelineRecorder,
                                                 TimelineStore)
from mmlspark_tpu_torch.resilience.policy import FakeClock

_QUEUE = "mmlspark_tpu_serving_queue_depth"
_LATENCY = "mmlspark_tpu_serving_latency_seconds"
_SEEN = "mmlspark_tpu_serving_requests_seen_total"


# --------------------------------------------------------------------- #
# snapshot builders (registry-shaped dicts, no registry needed)         #
# --------------------------------------------------------------------- #


def _counter(v: float, labels=None) -> dict:
    return {"kind": "counter",
            "samples": [{"labels": dict(labels or {}), "value": v}]}


def _gauge(v: float, labels=None) -> dict:
    return {"kind": "gauge",
            "samples": [{"labels": dict(labels or {}), "value": v}]}


def _hist(count: float, total: float, buckets: dict, labels=None) -> dict:
    return {"kind": "histogram",
            "samples": [{"labels": dict(labels or {}), "count": count,
                         "sum": total, "buckets": dict(buckets)}]}


# --------------------------------------------------------------------- #
# store durability                                                      #
# --------------------------------------------------------------------- #


class TestStoreDurability:
    def test_append_rotate_prune_on_fake_clock(self, tmp_path):
        store = TimelineStore(str(tmp_path), keep=2, segment_samples=4)
        clk = FakeClock()
        for i in range(12):
            store.append(clk.monotonic(), {_SEEN: _counter(5.0 * i)})
            clk.advance(2.0)
        segs = store.segments()
        # 12 samples / 4 per segment = 3 sealed; keep=2 pruned the first
        assert [s["seq"] for s in segs] == [2, 3]
        assert all(s["intact"] and s["samples"] == 4 for s in segs)
        # the retained window is samples 4..11 (t = 8..22)
        ts = [t for t, _f in store.samples()]
        assert ts == [8.0, 10.0, 12.0, 14.0, 16.0, 18.0, 20.0, 22.0]

    def test_restart_continues_sequence_and_queries(self, tmp_path):
        clk = FakeClock()
        store = TimelineStore(str(tmp_path), segment_samples=4)
        for i in range(5):
            store.append(clk.monotonic(), {_SEEN: _counter(10.0 * i)})
            clk.advance(1.0)
        # a fresh process opens the same directory and keeps appending
        store2 = TimelineStore(str(tmp_path), segment_samples=4)
        for i in range(5, 9):
            store2.append(clk.monotonic(), {_SEEN: _counter(10.0 * i)})
            clk.advance(1.0)
        seqs = [s["seq"] for s in store2.segments()]
        assert seqs == sorted(set(seqs)), "restart reused a sequence"
        # counter increase over a window spanning the restart: samples at
        # t=2..7 hold 20..70 -> exact growth 50, rate 10/s
        assert store2.increase(_SEEN, 5.0, at=7.0) == pytest.approx(50.0)
        assert store2.rate(_SEEN, 5.0, at=7.0) == pytest.approx(10.0)

    def test_truncated_segment_quarantined(self, tmp_path):
        store = TimelineStore(str(tmp_path), segment_samples=3)
        for i in range(6):
            store.append(float(i), {_QUEUE: _gauge(float(i))})
        segs = store.segments()
        assert len(segs) == 2
        path = segs[0]["path"]
        raw = open(path, "rb").read()
        with open(path, "wb") as fh:          # torn write: tail lost
            fh.write(raw[:len(raw) - 7])
        ok, detail, doc = TimelineStore.verify_file(path)
        assert (ok, doc) == (False, None) and detail == "truncated"
        fresh = TimelineStore(str(tmp_path))
        inv = {s["seq"]: s["intact"] for s in fresh.segments()}
        assert inv == {1: False, 2: True}
        # reads fall back to the newest intact segment, never raise
        assert [t for t, _f in fresh.samples()] == [3.0, 4.0, 5.0]

    def test_bit_flip_fails_checksum_and_falls_back(self, tmp_path):
        store = TimelineStore(str(tmp_path), segment_samples=3)
        for i in range(6):
            store.append(float(i), {_SEEN: _counter(float(i))})
        path = store.segments()[1]["path"]
        raw = bytearray(open(path, "rb").read())
        raw[len(raw) // 2] ^= 0x40            # one flipped bit, mid-payload
        with open(path, "wb") as fh:
            fh.write(bytes(raw))
        ok, detail, _doc = TimelineStore.verify_file(path)
        assert not ok and detail == "checksum-mismatch"
        fresh = TimelineStore(str(tmp_path))
        assert [t for t, _f in fresh.samples()] == [0.0, 1.0, 2.0]
        assert fresh.last_value(_SEEN) == 2.0

    def test_verify_detail_taxonomy(self, tmp_path):
        p = str(tmp_path / "seg-00000001.bin")
        assert TimelineStore.verify_file(p)[1] == "missing"
        open(p, "wb").write(b"xy")
        assert TimelineStore.verify_file(p)[1] == "short-header"
        import hashlib
        import struct
        hdr = struct.Struct(">8s16sQ")
        payload = b"not json"
        digest = hashlib.blake2b(payload, digest_size=16).digest()
        open(p, "wb").write(hdr.pack(b"WRONGMAG", digest, len(payload)))
        assert TimelineStore.verify_file(p)[1] == "bad-magic"
        open(p, "wb").write(
            hdr.pack(b"MMLTLSEG", digest, len(payload)) + payload)
        assert TimelineStore.verify_file(p)[1] == "bad-payload"

    def test_queries_exact_across_segment_boundary(self, tmp_path):
        """The boundary is an encoding detail: windows spanning it give
        the same numbers a single flat log would."""
        store = TimelineStore(str(tmp_path), segment_samples=3)
        buckets = {"0.1": 0.0, "0.5": 0.0, "+Inf": 0.0}
        for i in range(8):                    # segments: [0,1,2][3,4,5][6,7]
            buckets = {"0.1": 100.0 * i, "0.5": 100.0 * i,
                       "+Inf": 100.0 * i}
            snap = {
                _SEEN: _counter(7.0 * i),
                _QUEUE: _gauge(2.0 * i),      # slope 1.0/s at 2s cadence
                _LATENCY: _hist(100.0 * i, 5.0 * i, buckets),
            }
            store.append(2.0 * i, snap)
        # window [6, 14] spans the 2nd boundary: counter 21 -> 49
        assert store.increase(_SEEN, 8.0, at=14.0) == pytest.approx(28.0)
        assert store.rate(_SEEN, 8.0, at=14.0) == pytest.approx(3.5)
        assert store.slope(_QUEUE, 8.0, at=14.0) == pytest.approx(1.0)
        assert store.avg_over(_QUEUE, 8.0, at=14.0) == pytest.approx(10.0)
        assert store.max_over(_QUEUE, 8.0, at=14.0) == pytest.approx(14.0)
        assert store.min_over(_QUEUE, 8.0, at=14.0) == pytest.approx(6.0)
        # histogram deltas across the boundary: all growth in the 0.1
        # bucket, so q=0.5 interpolates to half the first bound
        assert store.quantile_over(_LATENCY, 0.5, 8.0, at=14.0) == \
            pytest.approx(0.05)

    def test_label_matchers_select_series(self, tmp_path):
        store = TimelineStore(str(tmp_path))
        for i in range(4):
            snap = {_QUEUE: {"kind": "gauge", "samples": [
                {"labels": {"server": "a"}, "value": 10.0 * i},
                {"labels": {"server": "b"}, "value": 1.0 * i},
            ]}}
            store.append(float(i), snap)
        assert store.max_over(_QUEUE, 10.0, {"server": "b"}, at=3.0) == 3.0
        assert store.max_over(_QUEUE, 10.0, {"server": "a"}, at=3.0) == 30.0
        assert store.max_over(_QUEUE, 10.0, at=3.0) == 30.0  # all series
        both = store.series(_QUEUE)
        assert len(both) == 2

    def test_counter_reset_never_counts_negative(self, tmp_path):
        store = TimelineStore(str(tmp_path))
        for t, v in [(0.0, 100.0), (1.0, 120.0), (2.0, 5.0), (3.0, 25.0)]:
            store.append(t, {_SEEN: _counter(v)})   # replica restart at t=2
        # growth 20 before the reset + 20 after; the -115 drop is ignored
        assert store.increase(_SEEN, 3.0, at=3.0) == pytest.approx(40.0)

    def test_compaction_preserves_every_query(self, tmp_path):
        store = TimelineStore(str(tmp_path), segment_samples=3, keep=8)
        for i in range(9):
            store.append(2.0 * i, {_SEEN: _counter(4.0 * i),
                                   _QUEUE: _gauge(float(i % 5))})
        before = (store.increase(_SEEN, 10.0, at=16.0),
                  store.avg_over(_QUEUE, 10.0, at=16.0),
                  store.slope(_QUEUE, 6.0, at=16.0),
                  [t for t, _f in store.samples()])
        removed = store.compact()
        assert removed == 3
        files = [f for f in os.listdir(tmp_path) if f.startswith("seg-")]
        assert len(files) == 1
        after = (store.increase(_SEEN, 10.0, at=16.0),
                 store.avg_over(_QUEUE, 10.0, at=16.0),
                 store.slope(_QUEUE, 6.0, at=16.0),
                 [t for t, _f in store.samples()])
        assert before == after
        # a fresh open reads the merged segment the same way
        fresh = TimelineStore(str(tmp_path))
        assert [t for t, _f in fresh.samples()] == before[3]
        # appends after compaction start a new segment, queries still span
        store.append(18.0, {_SEEN: _counter(40.0), _QUEUE: _gauge(4.0)})
        # window [14, 18] spans merged segment + fresh one: 28 -> 32 -> 40
        assert store.increase(_SEEN, 4.0, at=18.0) == pytest.approx(12.0)

    def test_series_tombstone_on_disappearance(self, tmp_path):
        store = TimelineStore(str(tmp_path))
        store.append(0.0, {_QUEUE: _gauge(5.0), _SEEN: _counter(1.0)})
        store.append(1.0, {_SEEN: _counter(2.0)})   # gauge family gone
        flats = [f for _t, f in store.samples()]
        assert any(k.startswith(_QUEUE) for k in flats[0])
        assert not any(k.startswith(_QUEUE) for k in flats[1])

    def test_ctor_validation(self, tmp_path):
        with pytest.raises(ValueError):
            TimelineStore(str(tmp_path), keep=0)
        with pytest.raises(ValueError):
            TimelineStore(str(tmp_path), segment_samples=1)



# --------------------------------------------------------------------- #
# alert rules + engine                                                  #
# --------------------------------------------------------------------- #


class TestAlertRule:
    @pytest.mark.parametrize("expr", [
        "rate(mmlspark_tpu_serving_requests_seen_total[60s]) > 5",
        "increase(x_total[300s]) >= 10",
        'avg_over(q{server="a"}[30s]) < 0.5',
        "quantile(0.99, mmlspark_tpu_serving_latency_seconds[120s]) > 0.25",
        'mmlspark_tpu_serving_queue_depth{server="a"} > 3',
    ])
    def test_grammar_accepts(self, expr):
        AlertRule("r", expr)

    @pytest.mark.parametrize("expr", [
        "",                                     # empty
        "rate(x_total) > 5",                    # windowed func, no window
        "quantile(x[60s]) > 1",                 # quantile without q
        "avg_over(x[60s]) != 5",                # unsupported operator
        "rate(x[60s]) > 5 and rate(y[60s]) > 5",  # one comparison per rule
        "x{bad matcher}[60s] > 1",              # unquoted label value
    ])
    def test_grammar_rejects(self, expr):
        with pytest.raises(ValueError):
            AlertRule("r", expr)

    def test_rule_evaluates_against_store(self, tmp_path):
        store = TimelineStore(str(tmp_path))
        for i in range(5):
            store.append(float(i), {_SEEN: _counter(10.0 * i)})
        hit, value = AlertRule(
            "hot", f"rate({_SEEN}[4s]) > 5").breached(store, at=4.0)
        assert hit and value == pytest.approx(10.0)
        hit, _v = AlertRule(
            "cold", f"rate({_SEEN}[4s]) > 50").breached(store, at=4.0)
        assert not hit


class TestAlertEngine:
    def _store(self, tmp_path, values, cadence=2.0):
        store = TimelineStore(str(tmp_path))
        t = 0.0
        for v in values:
            store.append(t, {_QUEUE: _gauge(v)})
            t += cadence
        return store

    def test_pending_until_for_s_then_firing_then_recovery(self, tmp_path):
        clk = FakeClock()
        store = TimelineStore(str(tmp_path))
        rule = AlertRule("hot", f"avg_over({_QUEUE}[4s]) > 50",
                         for_s=4.0, severity="page")
        engine = AlertEngine(store, [rule], clock=clk)
        for i, v in enumerate([1.0, 1.0, 100.0, 100.0, 100.0, 100.0,
                               1.0, 1.0, 1.0]):
            t = 2.0 * i
            store.append(t, {_QUEUE: _gauge(v)})
            engine.evaluate(at=t)
        states = []
        engine2 = AlertEngine(store, [rule], clock=clk)
        for t in [0.0, 2.0, 4.0, 6.0, 8.0, 10.0, 12.0, 16.0]:
            states.append(engine2.evaluate(at=t)["hot"]["state"])
        # breach starts at t=4 (avg over [0,4] window with the spike),
        # fires once it has held for_s=4 continuously, clears on recovery
        assert states[0:2] == ["ok", "ok"]
        assert "pending" in states and "firing" in states
        assert states.index("firing") > states.index("pending")
        assert states[-1] == "ok"
        assert engine2.firing() == []

    def test_firing_edge_records_event_and_dumps_once(self, tmp_path):
        clk = FakeClock()
        store = TimelineStore(str(tmp_path / "segments"))
        fr = FlightRecorder(dump_dir=str(tmp_path / "dumps"), clock=clk,
                            registry=MetricsRegistry(), process="t")
        engine = AlertEngine(store, [AlertRule(
            "hot", f"{_QUEUE} > 50", for_s=0.0, severity="page",
            dump=True)], clock=clk, recorder=fr)
        for t, v in [(0.0, 1.0), (2.0, 99.0), (4.0, 99.0), (6.0, 1.0)]:
            store.append(t, {_QUEUE: _gauge(v)})
            engine.evaluate(at=t)
        alerts = [e for e in fr.events() if e["kind"] == "timeline.alert"]
        assert len(alerts) == 1               # edge-triggered, not level
        assert alerts[0]["data"]["rule"] == "hot"
        assert alerts[0]["data"]["severity"] == "page"
        dumps = os.listdir(tmp_path / "dumps")
        assert len(dumps) == 1 and dumps[0].startswith(DUMP_PREFIX)

    def test_alert_state_gauge_lands_in_next_sample(self, tmp_path):
        """The engine's state gauges live in the recorder overlay, so the
        durable history itself says what was firing (one sample late by
        design: evaluation follows the append)."""
        clk = FakeClock()
        reg = MetricsRegistry()
        g = reg.gauge(_QUEUE, "q")
        store = TimelineStore(str(tmp_path))
        engine = AlertEngine(store, [AlertRule(
            "hot", f"{_QUEUE} > 50", severity="page")], clock=clk)
        rec = TimelineRecorder(store, reg, clock=clk, alerts=engine)
        for v in [1.0, 99.0, 99.0, 99.0]:
            g.set(v)
            rec.sample()
            clk.sleep(2.0)
        series = store.series("mmlspark_tpu_timeline_alert_state_count")
        assert len(series) == 1
        (lbl_json, pts), = series.items()
        lbl = json.loads(lbl_json)
        assert lbl == {"rule": "hot", "severity": "page", "series": _QUEUE}
        # state computed at sample k lands in sample k+1 (eval follows
        # append): ok at t=0 -> recorded at t=2; firing at t=2 -> t=4
        assert [v for _t, v in pts] == [0.0, 2.0, 2.0]

    def test_bad_series_cannot_stop_evaluation(self, tmp_path):
        store = TimelineStore(str(tmp_path))
        store.append(0.0, {_QUEUE: _gauge(99.0)})
        engine = AlertEngine(store, [
            AlertRule("broken", "no_such_series_at_all[1s] > 0"),
            AlertRule("fine", f"{_QUEUE} > 50")], clock=FakeClock())
        res = engine.evaluate(at=0.0)
        assert res["fine"]["state"] == "firing"
        assert res["broken"]["state"] == "ok"


# --------------------------------------------------------------------- #
# regression watch                                                      #
# --------------------------------------------------------------------- #


def _latency_history(store, shift_at_s: float, until_s: float,
                     cadence: float = 2.0) -> None:
    """Cumulative serving-latency histogram: 10 fast requests (0.1
    bucket) per tick until `shift_at_s`, then 10 slow ones (1.0 bucket)
    — the p99 regression the watch must catch."""
    fast = slow = 0.0
    t = 0.0
    while t <= until_s:
        if t > 0:
            if t <= shift_at_s:
                fast += 10.0
            else:
                slow += 10.0
        buckets = {"0.1": fast, "1.0": fast + slow, "+Inf": fast + slow}
        store.append(t, {_LATENCY: _hist(fast + slow, 0.1 * fast + slow,
                                         buckets)})
        t += cadence


class TestRegressionWatch:
    def test_p99_drift_breaches_noise_band(self, tmp_path):
        store = TimelineStore(str(tmp_path), segment_samples=8)
        _latency_history(store, shift_at_s=30.0, until_s=40.0)
        watch = RegressionWatch(baseline_chunks=3, current_s=10.0,
                                min_baseline_points=3)
        rows = {r["series"]: r for r in watch.evaluate(store, at=40.0)}
        assert rows["serving_p99"]["breached"]
        assert rows["serving_p99"]["current"] > \
            rows["serving_p99"]["mean"] + rows["serving_p99"]["band"]

    def test_stable_history_stays_quiet(self, tmp_path):
        store = TimelineStore(str(tmp_path), segment_samples=8)
        _latency_history(store, shift_at_s=1e9, until_s=40.0)
        watch = RegressionWatch(baseline_chunks=3, current_s=10.0,
                                min_baseline_points=3)
        rows = watch.evaluate(store, at=40.0)
        assert rows and not any(r["breached"] for r in rows)

    def test_warming_store_is_silent(self, tmp_path):
        store = TimelineStore(str(tmp_path))
        _latency_history(store, shift_at_s=1e9, until_s=8.0)
        watch = RegressionWatch(baseline_chunks=3, current_s=10.0)
        assert watch.evaluate(store, at=8.0) == []
        assert RegressionWatch().evaluate(TimelineStore(
            str(tmp_path / "empty"))) == []

    def test_breach_surfaces_through_alert_engine(self, tmp_path):
        store = TimelineStore(str(tmp_path), segment_samples=8)
        _latency_history(store, shift_at_s=30.0, until_s=40.0)
        clk = FakeClock()
        fr = FlightRecorder(dump_dir=str(tmp_path / "dumps"), clock=clk,
                            registry=MetricsRegistry(), process="w")
        engine = AlertEngine(store, clock=clk, recorder=fr)
        engine.attach_watch(RegressionWatch(
            baseline_chunks=3, current_s=10.0, min_baseline_points=3))
        res = engine.evaluate(at=40.0)
        assert res["regression:serving_p99"]["state"] == "firing"
        kinds = [e["kind"] for e in fr.events()]
        assert "timeline.regression" in kinds


# --------------------------------------------------------------------- #
# TimelineRecorder                                                      #
# --------------------------------------------------------------------- #


class TestTimelineRecorder:
    def test_overlay_makes_segments_self_describing(self, tmp_path):
        clk = FakeClock()
        reg = MetricsRegistry()
        reg.gauge(_QUEUE, "q").set(3.0)
        rec = TimelineRecorder(str(tmp_path), reg, clock=clk,
                               segment_samples=4)
        for _ in range(6):
            rec.sample()
            clk.sleep(5.0)
        store = TimelineStore(str(tmp_path))
        assert store.last_value(
            "mmlspark_tpu_timeline_samples_total") == 6.0
        assert store.last_value(
            "mmlspark_tpu_timeline_segments_count") >= 1.0
        assert store.last_value(
            "mmlspark_tpu_timeline_last_sample_age_seconds") == 5.0
        assert store.last_value(_QUEUE) == 3.0

    def test_background_loop_samples_on_injected_clock(self, tmp_path):
        reg = MetricsRegistry()
        reg.gauge(_QUEUE, "q").set(1.0)
        rec = TimelineRecorder(str(tmp_path), reg, interval_s=0.01)
        rec.start()
        try:
            deadline = time.monotonic() + 30.0
            while rec.store.last_time() is None:
                assert time.monotonic() < deadline
                time.sleep(0.01)
        finally:
            rec.stop()
        assert TimelineStore(str(tmp_path)).last_value(_QUEUE) == 1.0

    def test_callable_source(self, tmp_path):
        rec = TimelineRecorder(str(tmp_path),
                               lambda: {_QUEUE: _gauge(7.0)},
                               clock=FakeClock())
        rec.sample()
        assert rec.store.last_value(_QUEUE) == 7.0


# --------------------------------------------------------------------- #
# flight-recorder keep-N (satellite: dump retention)                    #
# --------------------------------------------------------------------- #


class TestRecorderDumpRetention:
    def test_keep_n_prunes_oldest_and_counts(self, tmp_path):
        reg = MetricsRegistry()
        clk = FakeClock()
        fr = FlightRecorder(dump_dir=str(tmp_path), clock=clk,
                            registry=reg, process="p", keep=2)
        paths = []
        for i in range(5):
            fr.record("tick", i=i)
            paths.append(fr.dump("manual"))
            clk.advance(1.0)
        names = sorted(n for n in os.listdir(tmp_path)
                       if n.endswith(".jsonl"))
        assert len(names) == 2
        # the two newest dumps survived
        assert {os.path.join(str(tmp_path), n) for n in names} == \
            set(paths[-2:])
        snap = reg.snapshot()
        fam = snap["mmlspark_tpu_recorder_dumps_pruned_total"]
        assert fam["samples"][0]["value"] == 3.0

    def test_keep_none_retains_everything(self, tmp_path):
        fr = FlightRecorder(dump_dir=str(tmp_path),
                            registry=MetricsRegistry(), process="p")
        for _ in range(4):
            fr.dump("manual")
        assert len(os.listdir(tmp_path)) == 4

    def test_other_processes_dumps_untouched(self, tmp_path):
        other = str(tmp_path / f"{DUMP_PREFIX}other-1-000.jsonl")
        open(other, "w").write("{}\n")
        fr = FlightRecorder(dump_dir=str(tmp_path),
                            registry=MetricsRegistry(), process="mine",
                            keep=1)
        for _ in range(3):
            fr.dump("manual")
        assert os.path.exists(other)
        mine = [n for n in os.listdir(tmp_path) if "mine" in n]
        assert len(mine) == 1

    def test_keep_validated(self, tmp_path):
        with pytest.raises(ValueError):
            FlightRecorder(dump_dir=str(tmp_path), keep=0)


# --------------------------------------------------------------------- #
# autoscaler trend signals (timeline wiring)                            #
# --------------------------------------------------------------------- #


class _StubFleet:
    def __init__(self, n: int = 1):
        self.n = n

    @property
    def n_live(self) -> int:
        return self.n

    def dead_slots(self):
        return []

    def scale_to(self, n):
        self.n = n
        return []


def _calm_sig():
    return {"queue_depth": 0.0, "p99_latency_s": 0.0,
            "shed_rate": 0.0, "burn_rate": 0.0}


class TestAutoscalerTrend:
    def _rising_queue_store(self, tmp_path, slope=0.5, cadence=2.0,
                            n=31):
        store = TimelineStore(str(tmp_path))
        for i in range(n):
            t = cadence * i
            store.append(t, {_QUEUE: _gauge(slope * t)})
        return store

    def test_trend_signals_join_read_signals(self, tmp_path):
        from mmlspark_tpu_torch.io_http.autoscale import FleetAutoscaler

        store = self._rising_queue_store(tmp_path)
        scaler = FleetAutoscaler(
            _StubFleet(1), _calm_sig, clock=FakeClock(),
            metrics=MetricsRegistry(), timeline=store,
            trend_window_s=60.0)
        sig = scaler.read_signals()
        assert sig["queue_depth_slope"] == pytest.approx(0.5)
        assert "p99_latency_slope" in sig

    def test_rising_slope_scales_up_before_absolute_threshold(
            self, tmp_path):
        """Queue at 30 is still under up_queue_depth=100, but the trend
        says it will not stay there — the slope threshold pages first."""
        from mmlspark_tpu_torch.io_http.autoscale import FleetAutoscaler

        store = self._rising_queue_store(tmp_path)
        fleet = _StubFleet(1)
        scaler = FleetAutoscaler(
            fleet, _calm_sig, clock=FakeClock(),
            metrics=MetricsRegistry(), timeline=store,
            trend_window_s=60.0, up_queue_depth=100.0,
            up_queue_slope=0.2)
        assert scaler.tick() == "up"
        assert fleet.n_live == 2
        assert "queue_depth_slope" in scaler.state()["pressure"]

    def test_slope_blocks_scale_down_while_rising(self, tmp_path):
        from mmlspark_tpu_torch.io_http.autoscale import FleetAutoscaler

        store = self._rising_queue_store(tmp_path)
        fleet = _StubFleet(3)
        clk = FakeClock()
        scaler = FleetAutoscaler(
            fleet, _calm_sig, clock=clk, metrics=MetricsRegistry(),
            timeline=store, trend_window_s=60.0, up_queue_depth=100.0,
            up_queue_slope=10.0,       # slope 0.5 is NOT pressure...
            hysteresis_ticks=2, cooldown_s=0.0)
        clk.advance(60.0)
        for _ in range(6):             # ...but 0.5 > 10*0.5-fraction? no:
            scaler.tick()              # 0.5 <= 5.0, so calm — downs happen
        assert fleet.n_live < 3
        # now a steep rise: slope above threshold*down_fraction blocks calm
        steep = TimelineStore(str(tmp_path / "steep"))
        for i in range(31):
            steep.append(2.0 * i, {_QUEUE: _gauge(12.0 * i)})
        fleet2 = _StubFleet(3)
        scaler2 = FleetAutoscaler(
            fleet2, _calm_sig, clock=FakeClock(),
            metrics=MetricsRegistry(), timeline=steep,
            trend_window_s=60.0, up_queue_depth=1e9,
            up_queue_slope=10.0, hysteresis_ticks=2, cooldown_s=0.0)
        scaler2.clock.advance(60.0)
        acts = [scaler2.tick() for _ in range(6)]
        assert "down" not in acts

    def test_no_timeline_means_no_trend_keys(self):
        from mmlspark_tpu_torch.io_http.autoscale import FleetAutoscaler

        scaler = FleetAutoscaler(_StubFleet(1), _calm_sig,
                                 clock=FakeClock(),
                                 metrics=MetricsRegistry())
        sig = scaler.read_signals()
        assert "queue_depth_slope" not in sig
        assert scaler.tick() in ("none", "down")

    def test_recorder_accepted_where_store_expected(self, tmp_path):
        """Wiring convenience: passing the TimelineRecorder (what the
        fleet holds) unwraps to its store."""
        from mmlspark_tpu_torch.io_http.autoscale import FleetAutoscaler

        rec = TimelineRecorder(str(tmp_path),
                               lambda: {_QUEUE: _gauge(0.0)},
                               clock=FakeClock())
        scaler = FleetAutoscaler(_StubFleet(1), _calm_sig,
                                 clock=FakeClock(),
                                 metrics=MetricsRegistry(), timeline=rec)
        assert scaler.timeline is rec.store


# --------------------------------------------------------------------- #
# SLO windowed burn (satellite: one-tick spikes are noise)              #
# --------------------------------------------------------------------- #


class TestWindowedBurnSignal:
    def _engine_and_state(self):
        from mmlspark_tpu_torch.observability.slo import (SLOEngine,
                                                    availability_slo)

        clock = FakeClock()
        state = {"snap": {
            _SEEN: _counter(0.0),
            "mmlspark_tpu_serving_requests_failed_total": _counter(0.0)}}
        src = type("Src", (), {"snapshot": lambda self: state["snap"]})()
        eng = SLOEngine(src, slos=[availability_slo(
            "avail", 0.99, total=_SEEN,
            bad="mmlspark_tpu_serving_requests_failed_total")],
            clock=clock, windows={"short": 60.0, "long": 600.0})
        return eng, state, clock

    def test_one_tick_spike_does_not_reach_scaleup_threshold(self):
        eng, state, clock = self._engine_and_state()
        seen = bad = 0.0
        # five quiet evaluations at 10s cadence
        for _ in range(5):
            seen += 100.0
            state["snap"][_SEEN] = _counter(seen)
            eng.evaluate()
            clock.advance(10.0)
        # one hot evaluation: half the new traffic fails
        seen += 100.0
        bad += 50.0
        state["snap"][_SEEN] = _counter(seen)
        state["snap"]["mmlspark_tpu_serving_requests_failed_total"] = \
            _counter(bad)
        res = eng.evaluate()["avail"]
        spike = max(res["burn_rates"].values())
        assert spike > 8.0                    # the raw gauge DID spike
        sig = eng.signals()
        # ...but the autoscaler signal is the short-window average over
        # six evaluations, five of them zero-burn
        assert sig["burn_rate"] == pytest.approx(spike / 6.0)
        assert sig["burn_rate"] < spike / 2.0

        from mmlspark_tpu_torch.io_http.autoscale import FleetAutoscaler

        fleet = _StubFleet(1)
        scaler = FleetAutoscaler(fleet, eng, clock=clock,
                                 metrics=MetricsRegistry(),
                                 up_burn_rate=spike / 2.0)
        assert scaler.tick() != "up"
        assert fleet.n_live == 1

    def test_sustained_burn_still_pages(self):
        eng, state, clock = self._engine_and_state()
        seen = bad = 0.0
        for _ in range(7):                    # every evaluation is hot
            seen += 100.0
            bad += 50.0
            state["snap"][_SEEN] = _counter(seen)
            state["snap"]["mmlspark_tpu_serving_requests_failed_total"] \
                = _counter(bad)
            eng.evaluate()
            clock.advance(10.0)
        sig = eng.signals()
        assert sig["burn_rate"] > 8.0         # the average converged up




# --------------------------------------------------------------------- #
# gateway wiring (opt-in timeline_dir)                                  #
# --------------------------------------------------------------------- #


class TestGatewayTimeline:
    def test_gateway_records_history_and_shutdown_edge(self, tmp_path):
        import urllib.request

        from mmlspark_tpu_torch.io_http.gateway import ServingGateway
        from tests.test_torch_gateway import _EchoServer

        srv = _EchoServer("a")
        gw = ServingGateway(urls=[srv.url],
                            timeline_dir=str(tmp_path / "history"),
                            timeline_interval_s=3600.0).start()
        try:
            body = json.dumps({"x": 1.0}).encode()
            req = urllib.request.Request(
                gw.url, data=body,
                headers={"Content-Type": "application/json"})
            urllib.request.urlopen(req, timeout=30).read()
        finally:
            gw.stop()
            srv.stop()
        store = TimelineStore(str(tmp_path / "history"))
        # the start-of-loop sample plus the shutdown-edge sample
        assert store.last_value(
            "mmlspark_tpu_timeline_samples_total") >= 2.0
        # the shutdown-edge sample caught the forwarded request
        names = set(store.kinds())
        assert any(n.startswith("mmlspark_tpu_gateway_") for n in names)

    def test_fleet_rejects_timeline_without_rendezvous(self, tmp_path):
        from mmlspark_tpu_torch.io_http.serving import ServingFleet

        with pytest.raises(ValueError, match="timeline"):
            ServingFleet(lambda: None, n_hosts=1, rendezvous=False,
                         timeline_dir=str(tmp_path))



# --------------------------------------------------------------------- #
# the port against the JAX package                                      #
# --------------------------------------------------------------------- #


def _write_history(store_cls, root: str) -> None:
    """Twelve samples over three segments, one of each family kind."""
    store = store_cls(root, keep=8, segment_samples=4)
    for i in range(12):
        buckets = {"0.1": 10.0 * i, "1.0": 12.0 * i, "+Inf": 12.0 * i}
        store.append(2.0 * i, {
            _SEEN: _counter(7.0 * i, {"replica": "fleet"}),
            _QUEUE: {"kind": "gauge", "samples": [
                {"labels": {"server": "a"}, "value": float(i % 5)},
                {"labels": {"server": "b"}, "value": 0.5 * i}]},
            _LATENCY: _hist(12.0 * i, 0.9 * i, buckets),
        })


def _answers(store) -> tuple:
    return (
        [(s["seq"], s["samples"], s["intact"]) for s in store.segments()],
        [t for t, _f in store.samples()],
        store.increase(_SEEN, 10.0, at=22.0),
        store.rate(_SEEN, 8.0, at=20.0),
        store.slope(_QUEUE, 12.0, {"server": "b"}, at=22.0),
        store.avg_over(_QUEUE, 10.0, at=22.0),
        store.max_over(_QUEUE, 22.0, {"server": "a"}, at=22.0),
        store.min_over(_QUEUE, 6.0, at=22.0),
        store.quantile_over(_LATENCY, 0.99, 10.0, at=22.0),
        store.last_value(_SEEN),
        sorted(store.kinds().items()),
        store.series(_QUEUE),
    )


class TestStoreAcrossPackages:
    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_store_opens_in_the_other_package(self, tmp_path, writer):
        from mmlspark_tpu.observability.timeline import TimelineStore as RefStore

        write_cls, read_cls = ((TimelineStore, RefStore) if writer == "port"
                               else (RefStore, TimelineStore))
        _write_history(write_cls, str(tmp_path / "x"))
        _write_history(read_cls, str(tmp_path / "own"))
        crossed = _answers(read_cls(str(tmp_path / "x")))
        assert crossed == _answers(read_cls(str(tmp_path / "own")))
        assert crossed == _answers(write_cls(str(tmp_path / "x")))
        # the segment files themselves are the same bytes
        names = sorted(f for f in os.listdir(tmp_path / "x") if f.startswith("seg-"))
        assert names == sorted(f for f in os.listdir(tmp_path / "own")
                               if f.startswith("seg-"))
        for n in names:
            assert (tmp_path / "x" / n).read_bytes() == (tmp_path / "own" / n).read_bytes()

    def test_quarantine_verdicts_agree(self, tmp_path):
        from mmlspark_tpu.observability.timeline import TimelineStore as RefStore

        _write_history(TimelineStore, str(tmp_path))
        segs = TimelineStore(str(tmp_path)).segments()
        raw = open(segs[0]["path"], "rb").read()
        with open(segs[0]["path"], "wb") as fh:          # torn tail
            fh.write(raw[:-5])
        raw = bytearray(open(segs[1]["path"], "rb").read())
        raw[len(raw) // 2] ^= 0x10                       # flipped bit
        with open(segs[1]["path"], "wb") as fh:
            fh.write(bytes(raw))
        for s in segs:
            assert TimelineStore.verify_file(s["path"])[:2] == \
                RefStore.verify_file(s["path"])[:2]
        assert _answers(TimelineStore(str(tmp_path))) == _answers(RefStore(str(tmp_path)))

    def test_compacted_store_crosses(self, tmp_path):
        from mmlspark_tpu.observability.timeline import TimelineStore as RefStore

        _write_history(RefStore, str(tmp_path))
        before = _answers(TimelineStore(str(tmp_path)))
        assert RefStore(str(tmp_path), keep=8, segment_samples=4).compact() == \
            len(before[0])                    # every old segment, merged into one
        after = _answers(TimelineStore(str(tmp_path)))
        assert after[1:] == before[1:]


_EXPRESSIONS = [
    "rate(mmlspark_tpu_serving_requests_seen_total[60s]) > 5",
    "increase(x_total[300s]) >= 10",
    'avg_over(q{server="a"}[30s]) < 0.5',
    "quantile(0.99, mmlspark_tpu_serving_latency_seconds[120s]) > 0.25",
    'mmlspark_tpu_serving_queue_depth{server="a"} > 3',
    "max_over(q[5m]) <= 1e-3",
    "min_over(q[2h]) == 4",
    "slope(q[90s]) > -1",
    "q > 1",
    "",
    "rate(x_total) > 5",
    "quantile(x[60s]) > 1",
    "avg_over(x[60s]) != 5",
    "rate(x[60s]) > 5 and rate(y[60s]) > 5",
    "x{bad matcher}[60s] > 1",
    "unknown_fn(x[60s]) > 1",
    "rate(x[60]) > 1",
    'q{a="1",b="2"} > 0',
]


class TestAlertRuleAcrossPackages:
    @pytest.mark.parametrize("expr", _EXPRESSIONS)
    def test_same_expressions_accepted(self, expr):
        from mmlspark_tpu.observability.timeline import AlertRule as RefRule

        def outcome(cls):
            try:
                cls("r", expr)
            except ValueError:
                return "rejected"
            return "accepted"

        assert outcome(AlertRule) == outcome(RefRule)

    def test_same_states_step_by_step(self, tmp_path):
        from mmlspark_tpu.observability.timeline import AlertEngine as RefEngine
        from mmlspark_tpu.observability.timeline import AlertRule as RefRule
        from mmlspark_tpu.observability.timeline import TimelineStore as RefStore

        trails = []
        for store_cls, engine_cls, rule_cls, sub in (
                (TimelineStore, AlertEngine, AlertRule, "port"),
                (RefStore, RefEngine, RefRule, "ref")):
            clk = FakeClock()
            store = store_cls(str(tmp_path / sub))
            engine = engine_cls(store, [
                rule_cls("hot", f"avg_over({_QUEUE}[4s]) > 50", for_s=4.0,
                         severity="page"),
                rule_cls("fast", f"rate({_SEEN}[6s]) > 3")], clock=clk)
            trail = []
            for i, v in enumerate([1.0, 1.0, 100.0, 100.0, 100.0, 100.0, 1.0,
                                   1.0, 1.0]):
                store.append(2.0 * i, {_QUEUE: _gauge(v), _SEEN: _counter(4.0 * i * i)})
                trail.append((engine.evaluate(at=2.0 * i), engine.firing()))
            trails.append(trail)
        assert repr(trails[0]) == repr(trails[1])
