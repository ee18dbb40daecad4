"""The checkpointer's host chain in the port (mmlspark_tpu_torch): `atomic_write`,
`TrainingCheckpointer`, `PreemptionGuard`, and the metrics registry, tracer
and flight recorder they report through.

These are copies of the JAX package's host modules, so they are held to its
own tests: tests/test_elastic.py:65-232 and a subset of
tests/test_observability.py's TestRegistry, TestTracer and
TestFlightRecorder (:59, :202, :509), run here on the port's modules. A
snapshot written by either package's checkpointer loads in the other's,
byte for byte. The tracer's device annotation is torch.profiler's
record_function.
"""

import json
import os
import signal
import threading

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu.resilience.elastic import TrainingCheckpointer as JaxCheckpointer  # noqa: E402
from mmlspark_tpu_torch.observability import (  # noqa: E402
    CHROME_EVENT_KEYS,
    FlightRecorder,
    MetricsRegistry,
    Tracer,
    get_registry,
    load_dump,
    load_jsonl,
    set_default_tracer,
)
from mmlspark_tpu_torch.observability import tracing  # noqa: E402
from mmlspark_tpu_torch.observability.metrics import METRIC_NAME_RE  # noqa: E402
from mmlspark_tpu_torch.resilience import FakeClock  # noqa: E402
from mmlspark_tpu_torch.resilience.elastic import (  # noqa: E402
    RESUMABLE_EXIT_CODE,
    Preempted,
    PreemptionGuard,
    TrainingCheckpointer,
    get_active_guard,
    preempt_now,
    set_active_guard,
)
from mmlspark_tpu_torch.utils.storage import atomic_write  # noqa: E402


@pytest.fixture(autouse=True)
def _no_leaked_guard():
    yield
    set_active_guard(None)


class TestAtomicWrite:
    def test_bytes_and_str_roundtrip(self, tmp_path):
        p = str(tmp_path / "sub" / "a.bin")   # parent dir auto-created
        atomic_write(p, b"\x00\x01payload")
        assert open(p, "rb").read() == b"\x00\x01payload"
        atomic_write(p, "text")               # replace in place
        assert open(p, "rb").read() == b"text"

    def test_no_stray_tmp_files(self, tmp_path):
        for i in range(5):
            atomic_write(str(tmp_path / "f"), f"v{i}".encode())
        assert os.listdir(str(tmp_path)) == ["f"]

    def test_remote_scheme_rejected(self):
        with pytest.raises(ValueError, match="local-only"):
            atomic_write("wasbs://container@acct/x", b"")


class TestTrainingCheckpointer:
    def test_roundtrip_with_meta_and_lineage(self, tmp_path):
        ck = TrainingCheckpointer(str(tmp_path), keep=5)
        ck.save(b"one", tag="epoch-0001", meta={"epoch": 1})
        ck.save(b"two", tag="epoch-0002", meta={"epoch": 2})
        payload, entry = ck.load_latest()
        assert payload == b"two"
        assert entry["meta"] == {"epoch": 2}
        assert entry["parent_seq"] == 0
        assert TrainingCheckpointer(str(tmp_path)).load_latest()[0] == b"two"

    def test_retention_unlinks_old_files(self, tmp_path):
        ck = TrainingCheckpointer(str(tmp_path), keep=2)
        for i in range(5):
            ck.save(f"p{i}".encode(), tag=f"t{i}")
        assert [e["seq"] for e in ck.entries()] == [3, 4]
        assert len([n for n in os.listdir(str(tmp_path)) if n.endswith(".bin")]) == 2

    def test_empty_store_loads_none(self, tmp_path):
        assert TrainingCheckpointer(str(tmp_path)).load_latest() is None

    def test_truncated_snapshot_falls_back(self, tmp_path):
        ck = TrainingCheckpointer(str(tmp_path))
        ck.save(b"good-old", tag="a")
        path = ck.save(b"bad-new", tag="b")
        with open(path, "r+b") as fh:
            fh.truncate(os.path.getsize(path) - 2)
        payload, entry = TrainingCheckpointer(str(tmp_path)).load_latest()
        assert payload == b"good-old" and entry["tag"] == "a"

    def test_bitflip_detected_by_checksum(self, tmp_path):
        ck = TrainingCheckpointer(str(tmp_path))
        ck.save(b"intact", tag="a")
        path = ck.save(b"flipped", tag="b")
        blob = bytearray(open(path, "rb").read())
        blob[-1] ^= 0x01
        with open(path, "wb") as fh:
            fh.write(bytes(blob))
        ok, detail, _ = TrainingCheckpointer.verify_file(path)
        assert (ok, detail) == (False, "checksum-mismatch")
        assert TrainingCheckpointer(str(tmp_path)).load_latest()[0] == b"intact"

    def test_corrupt_manifest_rebuilds_from_files(self, tmp_path):
        ck = TrainingCheckpointer(str(tmp_path))
        ck.save(b"p0", tag="e0")
        ck.save(b"p1", tag="e1")
        with open(str(tmp_path / "manifest.json"), "w") as fh:
            fh.write('{"entries": ')          # torn manifest write
        ck2 = TrainingCheckpointer(str(tmp_path))
        assert [e["tag"] for e in ck2.entries()] == ["e0", "e1"]
        assert ck2.load_latest()[0] == b"p1"
        ck2.save(b"p2", tag="e2")
        assert ck2.entries()[-1]["seq"] == 2

    def test_deleted_manifest_rebuilds_from_files(self, tmp_path):
        ck = TrainingCheckpointer(str(tmp_path))
        ck.save(b"p0", tag="e0")
        os.unlink(str(tmp_path / "manifest.json"))
        assert TrainingCheckpointer(str(tmp_path)).load_latest()[0] == b"p0"

    def test_tag_sanitized(self, tmp_path):
        path = TrainingCheckpointer(str(tmp_path)).save(b"x", tag="../../evil tag")
        assert os.path.dirname(path) == str(tmp_path)
        assert "/" not in os.path.basename(path)[5:]

    def test_corrupt_counter_incremented(self, tmp_path):
        def total():
            for line in get_registry().render_prometheus().splitlines():
                if line.startswith("mmlspark_tpu_checkpoint_corrupt_total"):
                    return float(line.rsplit(" ", 1)[1])
            return 0.0

        path = TrainingCheckpointer(str(tmp_path)).save(b"x", tag="t")
        before = total()
        with open(path, "wb") as fh:
            fh.write(b"garbage")
        TrainingCheckpointer(str(tmp_path)).load_latest()
        assert total() > before

    def test_age_gauge_keeps_the_jax_packages_name(self, tmp_path):
        TrainingCheckpointer(str(tmp_path)).save(b"x", tag="t")
        text = get_registry().render_prometheus()
        assert "mmlspark_tpu_checkpoint_last_age_seconds " in text
        assert "mmlspark_tpu_checkpoint_writes_total " in text


@pytest.mark.parametrize("writer,reader", [(JaxCheckpointer, TrainingCheckpointer),
                                           (TrainingCheckpointer, JaxCheckpointer)],
                         ids=["jax_to_port", "port_to_jax"])
def test_snapshots_cross_between_the_packages(tmp_path, writer, reader):
    payload = json.dumps({"kind": "gbdt", "rounds": 7}).encode("utf-8")
    ck = writer(str(tmp_path), keep=2)
    ck.save(b"older", tag="round-000003", meta={"rounds_done": 3})
    path = ck.save(payload, tag="round-000007", meta={"rounds_done": 7})
    assert os.path.basename(path) == "ckpt-00000001-round-000007.bin"
    with open(path, "rb") as fh:
        blob = fh.read()
    assert blob[:8] == b"MMLTCKPT" and blob.endswith(payload)
    got, entry = reader(str(tmp_path)).load_latest()
    assert got == payload and entry["meta"] == {"rounds_done": 7}
    assert reader.verify_file(path) == (True, "ok", payload)
    # the reader appends to the writer's lineage
    reader(str(tmp_path), keep=2).save(b"next", tag="round-000009")
    assert writer(str(tmp_path)).load_latest()[0] == b"next"


class TripGuard(PreemptionGuard):
    """Injectable preemption: drains after the Nth step-boundary poll."""

    def __init__(self, after: int, **kw):
        kw.setdefault("install", False)
        super().__init__(**kw)
        self.polls = 0
        self.after = after

    def should_checkpoint(self) -> bool:
        self.polls += 1
        if self.polls >= self.after:
            self.request_drain("test-trip")
        return super().should_checkpoint()


class TestPreemptionGuard:
    def test_drain_and_deadline_on_fake_clock(self):
        clock = FakeClock()
        g = PreemptionGuard(install=False, clock=clock, drain_deadline_s=30)
        assert not g.draining and not g.should_checkpoint()
        assert g.remaining_s() == 30
        g.request_drain("test")
        assert g.draining and g.should_checkpoint()
        clock.advance(29)
        assert not g.deadline_exceeded()
        clock.advance(2)
        assert g.deadline_exceeded() and g.remaining_s() == 0.0

    def test_request_drain_idempotent(self):
        clock = FakeClock()
        g = PreemptionGuard(install=False, clock=clock, drain_deadline_s=10)
        g.request_drain("first")
        clock.advance(5)
        g.request_drain("second")            # must NOT restamp the deadline
        assert g.remaining_s() == 5

    def test_complete_returns_resumable_exit_code(self, tmp_path):
        g = PreemptionGuard(install=False)
        g.request_drain()
        assert g.complete(str(tmp_path / "ck")) == RESUMABLE_EXIT_CODE == 75

    def test_context_manager_sets_active_guard(self):
        assert get_active_guard() is None
        with PreemptionGuard(install=False) as g:
            assert get_active_guard() is g
        assert get_active_guard() is None

    def test_sigterm_flips_drain(self):
        with PreemptionGuard() as g:
            assert g.installed
            os.kill(os.getpid(), signal.SIGTERM)
            assert g.draining
        assert not g.installed

    def test_preempt_now_writes_and_raises(self):
        g = PreemptionGuard(install=False)
        preempt_now(g, lambda: "/never", "noop")   # not draining: no-op
        g.request_drain()
        wrote = []
        with pytest.raises(Preempted) as ei:
            preempt_now(g, lambda: wrote.append("ck") or "/ck", "loop")
        assert wrote == ["ck"]
        assert ei.value.checkpoint_path == "/ck"
        assert ei.value.exit_code == RESUMABLE_EXIT_CODE

    def test_preempt_now_skips_write_past_deadline(self):
        clock = FakeClock()
        g = PreemptionGuard(install=False, clock=clock, drain_deadline_s=1)
        g.request_drain()
        clock.advance(2)
        with pytest.raises(Preempted) as ei:
            preempt_now(g, lambda: pytest.fail("wrote past deadline"), "loop")
        assert ei.value.checkpoint_path is None

    def test_preempt_now_polls_the_active_guard(self):
        set_active_guard(TripGuard(2))
        preempt_now(None, lambda: "/first", "loop")          # poll 1: keeps going
        with pytest.raises(Preempted) as ei:
            preempt_now(None, lambda: "/second", "loop")     # poll 2: drains
        assert ei.value.checkpoint_path == "/second"


class TestRegistry:
    def test_counter_gauge_basics(self):
        reg = MetricsRegistry()
        c = reg.counter("mmlspark_tpu_test_events_total", "events")
        c.inc()
        c.inc(2.5)
        assert c.value == 3.5
        with pytest.raises(ValueError):
            c.inc(-1)
        g = reg.gauge("mmlspark_tpu_test_queue_depth", "depth")
        g.set(7)
        g.inc()
        g.dec(3)
        assert g.value == 5.0

    def test_redeclare_idempotent_mismatch_rejected(self):
        reg = MetricsRegistry()
        c1 = reg.counter("mmlspark_tpu_test_a_total", "doc")
        assert reg.counter("mmlspark_tpu_test_a_total") is c1
        with pytest.raises(ValueError):
            reg.gauge("mmlspark_tpu_test_a_total")
        with pytest.raises(ValueError):
            reg.counter("mmlspark_tpu_test_a_total", labels=("x",))
        with pytest.raises(ValueError):
            reg.counter("bad_name_total")

    def test_histogram_time_on_fake_clock(self):
        clk = FakeClock()
        reg = MetricsRegistry(clock=clk)
        h = reg.histogram("mmlspark_tpu_test_latency_seconds", "", buckets=(0.01, 0.1, 1.0))
        for dt in (0.05, 0.5, 30.0):
            with h.time():
                clk.advance(dt)
        assert h.count == 3
        assert h.sum == pytest.approx(30.55)
        assert h.buckets() == {0.01: 0, 0.1: 1, 1.0: 2, float("inf"): 3}

    def test_render_prometheus_format(self):
        reg = MetricsRegistry(clock=FakeClock())
        reg.counter("mmlspark_tpu_test_reqs_total", "requests",
                    labels=("server",)).labels(server="s0").inc(4)
        reg.histogram("mmlspark_tpu_test_lat_seconds", "latency",
                      buckets=(0.1, 1.0)).observe(0.05)
        reg.register_callback("mmlspark_tpu_test_cache_hits_total", "cache", lambda: 9,
                              kind="counter")
        text = reg.render_prometheus()
        lines = text.strip().split("\n")
        for line in lines:
            if not line.startswith("# "):
                assert METRIC_NAME_RE.match(line.split("{")[0].split(" ")[0]), line
                float(line.rsplit(" ", 1)[1])
        assert 'mmlspark_tpu_test_reqs_total{server="s0"} 4' in lines
        assert 'mmlspark_tpu_test_lat_seconds_bucket{le="+Inf"} 1' in lines
        assert "mmlspark_tpu_test_cache_hits_total 9" in lines

    def test_concurrent_increments_do_not_drop(self):
        c = MetricsRegistry().counter("mmlspark_tpu_test_race_total")

        def work():
            for _ in range(2000):
                c.inc()

        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert c.value == 16000


class TestTracer:
    def test_parent_child_nesting(self):
        tr = Tracer(clock=FakeClock())
        with tr.start_span("outer", batch_id=7) as outer:
            with tr.start_span("inner") as inner:
                assert inner.parent is outer
                assert inner.trace_id == outer.trace_id
                assert inner.find_arg("batch_id") == 7
                assert tr.current_span() is inner
            assert tr.current_span() is outer
        assert tr.current_span() is None
        assert [s.name for s in tr.spans()] == ["inner", "outer"]

    def test_span_durations_on_fake_clock(self):
        clk = FakeClock()
        tr = Tracer(clock=clk)
        with tr.start_span("work"):
            clk.advance(0.25)
        (span,) = tr.spans()
        assert span.dur_us == pytest.approx(250_000.0)

    def test_export_jsonl_round_trip(self, tmp_path):
        clk = FakeClock()
        tr = Tracer(clock=clk)
        with tr.start_span("a", rows=4):
            clk.advance(0.1)
        path = str(tmp_path / "trace.jsonl")
        assert tr.export_jsonl(path) == 1
        (ev,) = load_jsonl(path)
        assert all(k in ev for k in CHROME_EVENT_KEYS)
        assert ev["name"] == "a" and ev["ph"] == "X" and ev["args"]["rows"] == 4

    def test_ring_buffer_bounds_retention(self):
        tr = Tracer(clock=FakeClock(), max_spans=4)
        for i in range(10):
            with tr.start_span(f"s{i}"):
                pass
        assert [s.name for s in tr.spans()] == ["s6", "s7", "s8", "s9"]

    def test_device_annotation_is_torch_record_function(self):
        ann = tracing._device_annotation("gbdt.round")
        assert isinstance(ann, torch.profiler.record_function)
        assert ann.name == "gbdt.round"

    def test_annotated_spans_appear_in_a_torch_profile(self):
        tr = Tracer(clock=FakeClock(), annotate_device=True)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with tr.start_span("ckpt.save"):
                torch.ones(4).sum()
        assert "ckpt.save" in {e.key for e in prof.key_averages()}
        assert [s.name for s in tr.spans()] == ["ckpt.save"]


class TestFlightRecorder:
    def _rec(self, tmp_path=None, **kw):
        kw.setdefault("clock", FakeClock())
        if tmp_path is not None:
            kw.setdefault("dump_dir", str(tmp_path))
        return FlightRecorder(**kw)

    def test_ring_bounds_and_drop_count(self):
        rec = self._rec(capacity=4)
        for i in range(10):
            rec.record("e", i=i)
        evs = rec.events()
        assert [e["data"]["i"] for e in evs] == [6, 7, 8, 9]
        assert rec.drop_count == 6
        assert [e["seq"] for e in evs] == [7, 8, 9, 10]

    def test_disarmed_recorder_is_inert(self, tmp_path):
        rec = self._rec(tmp_path, enabled=False)
        rec.record("e")
        assert rec.events() == []
        assert rec.trigger_dump("anything", force=True) is None
        assert list(tmp_path.iterdir()) == []

    def test_dump_round_trips_through_schema_load(self, tmp_path):
        reg = MetricsRegistry()
        reg.counter("mmlspark_tpu_test_total", "t").inc(3)
        rec = self._rec(tmp_path, registry=reg, process="unit")
        rec.record_request(trace_id="ab" * 16, route="resident", bucket=8, queue_depth=2,
                           latency_s=0.004, status=200)
        rec.record_transition("preemption", "checkpointed", checkpoint="/ck")
        meta, events = load_dump(rec.dump("manual", note="unit"))
        assert meta["process"] == "unit" and meta["trigger"] == "manual"
        assert meta["events"] == 2 and meta["events_dropped"] == 0
        assert [e["kind"] for e in events] == ["metrics.snapshot", "serving.request",
                                               "transition"]
        assert events[0]["data"]["snapshot"]["mmlspark_tpu_test_total"]["samples"][0][
            "value"] == 3.0

    def test_dump_cooldown_and_force(self, tmp_path):
        clock = FakeClock()
        rec = self._rec(tmp_path, clock=clock, dump_cooldown_s=30.0)
        rec.record("e")
        assert rec.trigger_dump("slo_burn") is not None
        clock.advance(5.0)
        assert rec.trigger_dump("slo_burn") is None
        assert rec.trigger_dump("sigterm", force=True) is not None

    def test_dump_header_discloses_ring_and_span_loss(self, tmp_path):
        tr = Tracer(clock=FakeClock(), max_spans=2)
        old = set_default_tracer(tr)
        try:
            for i in range(5):
                with tr.start_span(f"s{i}"):
                    pass
            rec = self._rec(tmp_path, capacity=2)
            for i in range(5):
                rec.record("e", i=i)
            meta, _ = load_dump(rec.dump("manual"))
        finally:
            set_default_tracer(old)
        assert meta["events_dropped"] == 3 and meta["spans_lost"] == 3

    def test_load_dump_rejects_bad_schema(self, tmp_path):
        p = tmp_path / "flight-x.jsonl"
        p.write_text(json.dumps({"kind": "not-a-header"}) + "\n")
        with pytest.raises(ValueError, match="recorder.meta"):
            load_dump(str(p))
        p.write_text(json.dumps({"kind": "recorder.meta", "schema": 99}) + "\n")
        with pytest.raises(ValueError, match="unknown dump schema"):
            load_dump(str(p))

    def test_preemption_is_recorded(self, tmp_path):
        from mmlspark_tpu_torch.observability import set_default_recorder

        rec = self._rec(tmp_path)
        old = set_default_recorder(rec)
        try:
            g = PreemptionGuard(install=False)
            g.request_drain("unit")
            with pytest.raises(Preempted):
                preempt_now(g, lambda: "/ck", "loop")
        finally:
            set_default_recorder(old)
        steps = [(e["kind"], e["data"].get("component"), e["data"].get("action"))
                 for e in rec.events()]
        assert steps == [("transition", "preemption", "drain_requested"),
                         ("transition", "preemption", "checkpointed")]
        assert any(p.name.startswith("flight-") for p in tmp_path.iterdir())


@pytest.fixture
def clean_sanitizer(monkeypatch):
    from mmlspark_tpu_torch.observability import sanitizer

    monkeypatch.delenv("MMLSPARK_TPU_SANITIZE", raising=False)
    sanitizer.reset()
    yield sanitizer
    sanitizer.reset()


def test_sanitizer_is_plain_when_off_and_names_a_lock_cycle(clean_sanitizer, tmp_path):
    """tests/test_graftlint.py:370-410 on the port's copy: the lock
    factories give plain locks while it is off; on, an inverted order of two
    locks raises LockOrderError and forces a flight-recorder dump."""
    sanitizer = clean_sanitizer
    assert not isinstance(sanitizer.make_lock("x"), sanitizer.SanitizedLock)
    rec = FlightRecorder(dump_dir=str(tmp_path), process="sanit", clock=FakeClock())
    sanitizer.enable(hard_fail=True, recorder=rec)
    a, b = sanitizer.make_lock("jobs"), sanitizer.make_lock("stats")
    with a:
        with b:
            pass
    with pytest.raises(sanitizer.LockOrderError):
        with b:
            with a:
                pass
    cycles = [v for v in sanitizer.violations() if v["kind"] == "lock_cycle"]
    assert len(cycles) == 1 and cycles[0]["locks"] == ["jobs", "stats"]
    (dump,) = tmp_path.glob("*.jsonl")
    assert json.loads(dump.read_text().splitlines()[0])["trigger"] == "sanitizer.lock_cycle"
