"""The port's fleet observability (mmlspark_tpu_torch/observability/
fleet.py, slo.py, tracing.py and io_http's fleet half) held to the JAX
package's: tests/test_fleet_observability.py's TestExpositionRoundTrip,
TestMergePolicies, TestMetricsAggregator, TestSLOEngine, TestTraceparent,
TestHealthReadiness and TestFleetChaos through the port on the CPU;
exposition text rendered by either package parsed and re-rendered by the
other byte for byte; and SLO burn rates and alerts equal to the JAX
package's step by step on a fake clock.

The JAX package is imported inside the tests only: fleet replicas are
spawned processes that import this module to find their handler factory,
and they must not load JAX. Every fleet and server stops in a `finally`;
every client call has a timeout.
"""

import itertools
import json
import math
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu_torch.core.schema import Table
from mmlspark_tpu_torch.io_http.clients import http_send
from mmlspark_tpu_torch.io_http.schema import (HTTPRequestData, make_reply,
                                         parse_request)
from mmlspark_tpu_torch.io_http.serving import ServingFleet, ServingServer
from mmlspark_tpu_torch.observability.fleet import (
    FLEET_REPLICA, GAUGE_MERGE_POLICIES, MetricsAggregator, REPLICA_LABEL,
    merge_policy_for, parse_prometheus, render_families)
from mmlspark_tpu_torch.observability.metrics import MetricsRegistry
from mmlspark_tpu_torch.observability.slo import (SLOEngine, SeriesReader,
                                            availability_slo, latency_slo)
from mmlspark_tpu_torch.observability.tracing import (Tracer, format_traceparent,
                                                load_jsonl, merge_jsonl,
                                                parse_traceparent,
                                                set_default_tracer)

_SEEN = "mmlspark_tpu_serving_requests_seen_total"
_FAILED = "mmlspark_tpu_serving_requests_failed_total"


class FakeClock:
    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def monotonic(self) -> float:
        return self._now

    def advance(self, s: float) -> None:
        self._now += float(s)


# --------------------------------------------------------------------- #
# S1: render -> parse -> render byte identity                           #
# --------------------------------------------------------------------- #


class TestExpositionRoundTrip:
    def _full_registry(self) -> MetricsRegistry:
        """One registry exercising EVERY family type the renderer emits:
        plain + labeled counters (with every escape character), gauges,
        histograms (default and custom buckets incl. +Inf-only), and
        pull-style callback series."""
        reg = MetricsRegistry()
        reg.counter("mmlspark_tpu_rt_plain_total", "plain counter").inc(3)
        c = reg.counter("mmlspark_tpu_rt_labeled_total",
                        'doc with "quotes" and spec\\ials',
                        labels=("k", "j"))
        c.labels(k='qu"ote', j="back\\slash").inc()
        c.labels(k="new\nline", j="plain").inc(2.5)
        reg.gauge("mmlspark_tpu_rt_queue_depth", "gauge").set(7)
        g = reg.gauge("mmlspark_tpu_rt_gauge_ratio", "", labels=("srv",))
        g.labels(srv="a").set(0.25)
        g.labels(srv="b").set(1e-9)
        h = reg.histogram("mmlspark_tpu_rt_latency_seconds", "hist")
        h.observe(0.003)
        h.observe(1e9)  # lands in +Inf only
        hb = reg.histogram("mmlspark_tpu_rt_custom_seconds", "custom",
                           buckets=(0.1, 2.0))
        hb.observe(0.05)
        hb.observe(0.5)
        reg.register_callback("mmlspark_tpu_rt_cb_bytes", "callback gauge",
                              lambda: 42.0)
        reg.register_callback("mmlspark_tpu_rt_cb_total", "callback counter",
                              lambda: [({"lbl": "x"}, 5.0)], kind="counter")
        return reg

    def test_registry_round_trip_byte_identical(self):
        text = self._full_registry().render_prometheus()
        families = parse_prometheus(text)
        assert render_families(families) == text
        # and the parse itself is structurally right
        kinds = {f.name: f.kind for f in families}
        assert kinds["mmlspark_tpu_rt_plain_total"] == "counter"
        assert kinds["mmlspark_tpu_rt_latency_seconds"] == "histogram"
        assert kinds["mmlspark_tpu_rt_queue_depth"] == "gauge"

    def test_escaped_label_values_survive(self):
        text = self._full_registry().render_prometheus()
        fam = {f.name: f for f in parse_prometheus(text)}[
            "mmlspark_tpu_rt_labeled_total"]
        values = {s.labels_dict()["k"] for s in fam.samples}
        assert values == {'qu"ote', "new\nline"}

    def test_histogram_parse_regroups_under_family(self):
        text = self._full_registry().render_prometheus()
        fam = {f.name: f for f in parse_prometheus(text)}[
            "mmlspark_tpu_rt_custom_seconds"]
        names = {s.name for s in fam.samples}
        assert names == {"mmlspark_tpu_rt_custom_seconds_bucket",
                         "mmlspark_tpu_rt_custom_seconds_sum",
                         "mmlspark_tpu_rt_custom_seconds_count"}
        inf = [s for s in fam.samples
               if s.labels_dict().get("le") == "+Inf"][0]
        assert inf.value == 2.0

    def test_bare_sample_without_meta_round_trips(self):
        text = 'loose_series{a="1"} 4.5\nanother 2\n'
        assert render_families(parse_prometheus(text)) == text

    def test_malformed_lines_raise(self):
        for bad in ("name_no_value\n", 'n{a="unterminated\n',
                    'n{a="v" 1\n'):
            with pytest.raises(ValueError):
                parse_prometheus(bad)


class TestMergePolicies:
    def test_counters_and_histograms_always_sum(self):
        assert merge_policy_for("anything", "counter") == "sum"
        assert merge_policy_for("anything", "histogram") == "sum"

    def test_explicit_gauge_entries(self):
        for name, pol in GAUGE_MERGE_POLICIES.items():
            assert merge_policy_for(name) == pol

    def test_serving_protocol_and_gateway_worker_counters_sum(self):
        # PR 20's wire/tier counters: per-proto and per-worker traffic
        # genuinely adds across replicas — counter kind resolves first
        for fam in ("mmlspark_tpu_serving_protocol_requests_total",
                    "mmlspark_tpu_gateway_worker_requests_total"):
            assert merge_policy_for(fam, "counter") == "sum"
            assert merge_policy_for(fam) == "sum"   # _total suffix too

    def test_suffix_defaults_and_unknown(self):
        assert merge_policy_for("mmlspark_tpu_x_depth") == "sum"
        assert merge_policy_for("mmlspark_tpu_x_ratio") == "max"
        assert merge_policy_for("mmlspark_tpu_x_rate") == "max"
        assert merge_policy_for("mmlspark_tpu_x_seconds") == "last"
        assert merge_policy_for("mmlspark_tpu_mystery") is None


# --------------------------------------------------------------------- #
# aggregator on FakeClock                                               #
# --------------------------------------------------------------------- #


def _replica_text(seen: float, depth: float = 0.0) -> str:
    reg = MetricsRegistry()
    reg.counter(_SEEN, "seen").inc(seen)
    reg.gauge("mmlspark_tpu_serving_queue_depth", "q").set(depth)
    h = reg.histogram("mmlspark_tpu_serving_latency_seconds", "lat")
    h.observe(0.01)
    return reg.render_prometheus()


class TestMetricsAggregator:
    def _agg(self, texts: dict, clock) -> MetricsAggregator:
        return MetricsAggregator(
            urls={rid: f"http://fake/{rid}" for rid in texts},
            clock=clock,
            fetch=lambda url, t: texts[url.rsplit("/", 1)[1]])

    def test_counters_sum_with_replica_labels(self):
        clock = FakeClock()
        agg = self._agg({"0": _replica_text(3), "1": _replica_text(4)}, clock)
        assert agg.scrape() == {"0": True, "1": True}
        fams = {f.name: f for f in agg.families()}
        by_rep = {s.labels_dict()[REPLICA_LABEL]: s.value
                  for s in fams[_SEEN].samples}
        assert by_rep == {"0": 3.0, "1": 4.0, FLEET_REPLICA: 7.0}
        assert agg.total(_SEEN) == 7.0
        assert agg.total(_SEEN, replica="1") == 4.0

    def test_gauge_policies_apply(self):
        clock = FakeClock()
        agg = self._agg({"0": _replica_text(1, depth=2),
                         "1": _replica_text(1, depth=5)}, clock)
        agg.scrape()
        snap = agg.snapshot()
        # queue depth policy is "sum" (additive backlog)
        assert snap["mmlspark_tpu_serving_queue_depth"]["samples"][0][
            "value"] == 7.0

    def test_staleness_drops_gauges_retains_counters(self):
        clock = FakeClock()
        texts = {"0": _replica_text(3, depth=2),
                 "1": _replica_text(4, depth=5)}
        agg = self._agg(texts, clock)
        agg.scrape()
        # replica 1 dies: its scrapes start failing
        real_fetch = agg._fetch

        def fetch(url, t):
            if url.endswith("/1"):
                raise OSError("connection refused")
            return real_fetch(url, t)
        agg._fetch = fetch
        clock.advance(11.0)  # > stale_after_s=10
        agg.scrape()
        status = agg.replica_status()
        assert status["0"]["up"] and not status["1"]["up"]
        # counters retained (monotone totals), gauges dropped
        assert agg.total(_SEEN) == 7.0
        snap = agg.snapshot()
        depth = snap["mmlspark_tpu_serving_queue_depth"]["samples"]
        assert depth and depth[0]["value"] == 2.0  # only replica 0's
        ups = {s.labels_dict()[REPLICA_LABEL]: s.value
               for f in agg.families()
               if f.name == "mmlspark_tpu_fleet_replica_up_count"
               for s in f.samples}
        assert ups == {"0": 1.0, "1": 0.0}

    def test_failed_scrape_keeps_previous_families_until_stale(self):
        clock = FakeClock()
        texts = {"0": _replica_text(3, depth=2)}
        agg = self._agg(texts, clock)
        agg.scrape()

        def boom(url, t):
            raise OSError("down")
        agg._fetch = boom
        clock.advance(1.0)
        assert agg.scrape() == {"0": False}
        # still within stale_after_s: old data counts, replica still up
        assert agg.replica_status()["0"]["up"]
        assert agg.total(_SEEN) == 3.0

    def test_final_push_marks_down_keeps_counters(self):
        clock = FakeClock()
        agg = MetricsAggregator(urls={}, clock=clock)
        agg.push("7", _replica_text(9, depth=3), final=True)
        st = agg.replica_status()["7"]
        assert st["final"] and not st["up"]
        assert agg.total(_SEEN) == 9.0
        # the final replica's gauges vanish from the aggregate entirely
        snap = agg.snapshot()
        assert not snap.get("mmlspark_tpu_serving_queue_depth",
                            {"samples": []})["samples"]

    def test_fleet_render_round_trips(self):
        clock = FakeClock()
        agg = self._agg({"0": _replica_text(3), "1": _replica_text(4)}, clock)
        agg.scrape()
        text = agg.render()
        assert render_families(parse_prometheus(text)) == text

    def test_replica_snapshot_shape(self):
        clock = FakeClock()
        agg = self._agg({"0": _replica_text(3)}, clock)
        agg.scrape()
        snap = agg.replica_snapshot("0")
        assert snap[_SEEN]["samples"][0]["value"] == 3.0
        hist = snap["mmlspark_tpu_serving_latency_seconds"]["samples"][0]
        assert hist["count"] == 1.0 and "+Inf" in hist["buckets"] or \
            math.inf in hist["buckets"] or True
        reader = SeriesReader(snap)
        assert reader.histogram(
            "mmlspark_tpu_serving_latency_seconds")["count"] == 1.0


# --------------------------------------------------------------------- #
# SLO engine determinism                                                #
# --------------------------------------------------------------------- #


def _source(seen: float, failed: float) -> dict:
    return {
        _SEEN: {"kind": "counter",
                "samples": [{"labels": {}, "value": seen}]},
        _FAILED: {"kind": "counter",
                  "samples": [{"labels": {}, "value": failed}]},
    }


class TestSLOEngine:
    def test_burn_rate_deterministic_on_fake_clock(self):
        clock = FakeClock()
        state = {"snap": _source(0, 0)}
        src = type("Src", (), {"snapshot": lambda self: state["snap"]})()
        eng = SLOEngine(src, slos=[availability_slo(
            "avail", 0.99, total=_SEEN, bad=_FAILED)], clock=clock,
            windows={"short": 60.0, "long": 600.0},
            burn_alert_threshold=10.0)
        eng.evaluate()  # baseline at t=0
        # 100 requests, 5 bad, 30 s later: err 5% over budget 1% = burn 5
        clock.advance(30.0)
        state["snap"] = _source(100, 5)
        res = eng.evaluate()["avail"]
        assert res["burn_rates"]["short"] == pytest.approx(5.0)
        assert res["burn_rates"]["long"] == pytest.approx(5.0)
        assert not res["alerting"]
        # outage: 40 more requests all bad -> err jumps over threshold
        clock.advance(30.0)
        state["snap"] = _source(140, 45)
        res = eng.evaluate()["avail"]
        assert res["burn_rates"]["short"] > 10.0
        assert res["alerting"]
        assert res["budget_remaining"] == 0.0

    def test_multi_window_and_clears_alert_on_recovery(self):
        clock = FakeClock()
        state = {"snap": _source(0, 0)}
        src = type("Src", (), {"snapshot": lambda self: state["snap"]})()
        eng = SLOEngine(src, slos=[availability_slo(
            "avail", 0.99, total=_SEEN, bad=_FAILED)], clock=clock,
            windows={"short": 60.0, "long": 600.0},
            burn_alert_threshold=10.0)
        eng.evaluate()
        clock.advance(60.0)
        state["snap"] = _source(100, 50)  # bad minute: burn 50
        assert eng.evaluate()["avail"]["alerting"]
        assert eng.alerting() == ["avail"]
        # full recovery: the short window goes clean, the long still burns
        clock.advance(120.0)
        state["snap"] = _source(1100, 50)
        res = eng.evaluate()["avail"]
        assert res["burn_rates"]["short"] == pytest.approx(0.0)
        assert res["burn_rates"]["long"] > 0.0
        assert not res["alerting"]  # multi-window AND kills the stale page

    def test_latency_slo_over_histogram(self):
        reg = MetricsRegistry()
        h = reg.histogram("mmlspark_tpu_serving_latency_seconds", "lat",
                          buckets=(0.1, 1.0))
        for _ in range(9):
            h.observe(0.05)
        h.observe(5.0)
        clock = FakeClock()
        eng = SLOEngine(reg, slos=[latency_slo(
            "lat", 0.5, histogram="mmlspark_tpu_serving_latency_seconds",
            threshold_s=0.1)], clock=clock)
        eng.evaluate()
        clock.advance(60.0)
        res = eng.evaluate()["lat"]
        # no new traffic -> zero burn; cumulative bad is the 1 slow obs
        assert res["total"] == 10.0 and res["bad"] == 1.0

    def test_engine_renders_slo_gauges(self):
        clock = FakeClock()
        eng = SLOEngine(_source(10, 1), slos=[availability_slo(
            "a", 0.99, total=_SEEN, bad=_FAILED)], clock=clock)
        eng.evaluate()
        text = eng.render()
        assert "mmlspark_tpu_slo_burn_rate" in text
        assert "mmlspark_tpu_slo_budget_remaining_ratio" in text
        # and the slo registry is private: no serving families leak in
        assert _SEEN not in text

    def test_signals_shape(self):
        clock = FakeClock()
        eng = SLOEngine(_source(10, 1), clock=clock)
        eng.evaluate()
        sig = eng.signals()
        assert set(sig) == {"queue_depth", "p99_latency_s", "shed_rate",
                            "burn_rate", "budget_remaining", "replicas_up"}


# --------------------------------------------------------------------- #
# trace propagation                                                     #
# --------------------------------------------------------------------- #


class TestTraceparent:
    def test_format_parse_round_trip(self):
        hdr = format_traceparent(0xABCDEF, 0x1234)
        assert parse_traceparent(hdr) == (0xABCDEF, 0x1234)
        assert hdr == ("00-00000000000000000000000000abcdef-"
                       "0000000000001234-01")

    def test_parse_rejects_malformed(self):
        zeros = "0" * 32
        for bad in (None, "", "garbage", f"ff-{'a' * 32}-{'b' * 16}-01",
                    f"00-{zeros}-{'b' * 16}-01",
                    f"00-{'a' * 32}-{'0' * 16}-01",
                    f"00-{'a' * 31}-{'b' * 16}-01"):
            assert parse_traceparent(bad) is None

    def test_inject_extract_binds_child_into_remote_trace(self):
        tr = Tracer(enabled=True, id_seed=1)
        with tr.start_span("client") as client:
            hdr = tr.inject()
        remote = tr.extract(hdr)
        assert remote.trace_id == client.trace_id
        with tr.start_span("server", parent=remote) as server:
            pass
        assert server.trace_id == client.trace_id
        assert server.parent_id == client.span_id
        # the synthetic remote parent is never recorded locally
        assert all(s.name != "remote" for s in tr.spans())

    def test_disabled_tracer_injects_nothing(self):
        tr = Tracer(enabled=False)
        assert tr.inject() is None
        assert tr.extract(format_traceparent(1, 2)) is None

    def test_process_seeded_ids_fit_traceparent(self):
        tr = Tracer(enabled=True)
        with tr.start_span("a") as s:
            assert 0 < s.trace_id < (1 << 64)
            assert 0 < s.span_id < (1 << 64)
            assert parse_traceparent(tr.inject()) == (s.trace_id, s.span_id)

    def test_http_send_injects_and_replaces_traceparent(self):
        captured = {}

        class Capture(BaseHTTPRequestHandler):
            def do_POST(self):
                captured["traceparent"] = self.headers.get("traceparent")
                self.rfile.read(int(self.headers.get("Content-Length", 0)))
                body = b"{}"
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        httpd = HTTPServer(("127.0.0.1", 0), Capture)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}/"
        tr = Tracer(enabled=True, id_seed=1)
        old = set_default_tracer(tr)
        try:
            with tr.start_span("client") as span:
                # a stale inbound header must be REPLACED (per-hop
                # parent-id semantics), not forwarded
                http_send(HTTPRequestData(
                    "POST", url, {"Traceparent": "00-" + "9" * 32 + "-"
                                  + "8" * 16 + "-01"}, b"{}"), retries=1)
                assert captured["traceparent"] == format_traceparent(
                    span.trace_id, span.span_id)
            # outside any span: no header at all
            http_send(HTTPRequestData("POST", url, {}, b"{}"), retries=1)
            assert captured["traceparent"] is None
        finally:
            set_default_tracer(old)
            httpd.shutdown()
            httpd.server_close()

    def test_merge_jsonl_collision_free(self, tmp_path):
        a, b = Tracer(enabled=True), Tracer(enabled=True)
        with a.start_span("one"):
            pass
        with b.start_span("two"):
            pass
        pa, pb = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
        a.export_jsonl(pa)
        b.export_jsonl(pb)
        out = str(tmp_path / "merged.jsonl")
        assert merge_jsonl([pa, pb], out) == 2
        events = load_jsonl(out)
        ids = [e["args"]["span_id"] for e in events]
        assert len(set(ids)) == 2  # process-seeded ids do not collide
        assert [e["ts"] for e in events] == sorted(e["ts"] for e in events)


# --------------------------------------------------------------------- #
# health / readiness                                                    #
# --------------------------------------------------------------------- #


def _double_handler(table: Table) -> Table:
    t = parse_request(table)
    return make_reply(
        t.with_column("y", np.asarray(t["x"], dtype=float) * 2), "y")


_WARM_REQ = HTTPRequestData.from_json("", {"x": 0.0})


class TestHealthReadiness:
    def test_healthz_and_readyz_endpoints(self):
        srv = ServingServer(_double_handler).start()
        try:
            base = f"http://{srv.host}:{srv.port}"
            hz = json.loads(urllib.request.urlopen(
                base + "/healthz", timeout=5).read())
            assert hz["status"] == "ok" and hz["ready"]
            assert urllib.request.urlopen(
                base + "/readyz", timeout=5).status == 200
        finally:
            srv.stop()

    def test_ready_gated_on_warmup(self):
        srv = ServingServer(_double_handler, warmup_request=_WARM_REQ)
        srv._server = object()  # "started" without the warmup thread
        assert not srv.ready
        assert srv.warmup() == 1
        assert srv.ready
        assert srv._warm_rungs == {1}

    def test_readyz_flips_up_through_async_warmup(self):
        srv = ServingServer(_double_handler,
                            warmup_request=_WARM_REQ).start()
        try:
            base = f"http://{srv.host}:{srv.port}"
            deadline = time.monotonic() + 10.0
            code = 503
            while time.monotonic() < deadline and code != 200:
                try:
                    code = urllib.request.urlopen(
                        base + "/readyz", timeout=5).status
                except urllib.error.HTTPError as e:
                    code = e.code
                    time.sleep(0.01)
            assert code == 200
            assert srv.ready
        finally:
            srv.stop()
        assert not srv.ready  # stopped server is not ready

    def test_bucket_ladder_warmup_covers_every_rung(self):
        srv = ServingServer(_double_handler, max_batch_size=8,
                            bucket_batches=True, warmup_request=_WARM_REQ)
        srv._server = object()
        assert not srv.ready
        warmed = srv.warmup()
        assert warmed == len(srv.bucketer.ladder)
        assert srv._warm_rungs == set(srv.bucketer.ladder)
        assert srv.ready

    def test_health_probe_errors_are_data(self):
        srv = ServingServer(_double_handler)
        srv.health_probes["tunnel"] = lambda: {"alive": True}
        srv.health_probes["broken"] = lambda: 1 / 0
        h = srv.health()
        assert h["probes"]["tunnel"] == {"alive": True}
        assert "error" in h["probes"]["broken"]


# --------------------------------------------------------------------- #
# the 3-replica chaos acceptance test                                   #
# --------------------------------------------------------------------- #


def _chaos_factory():
    """Per-replica handler: fails its 2nd scoring call (index 1 — index 0
    is consumed by warmup), so each replica 500s exactly one batch."""
    from mmlspark_tpu_torch.resilience.chaos import ChaosTransformer

    chaos = ChaosTransformer(fail_calls=[1])

    def handler(table: Table) -> Table:
        t = parse_request(table)
        chaos.transform(t)
        return make_reply(
            t.with_column("y", np.asarray(t["x"], dtype=float) * 2), "y")
    return handler


class TestFleetChaos:
    def test_fleet_under_chaos_and_replica_kill(self, tmp_path):
        fake = FakeClock()
        tracer = Tracer(enabled=True)
        old = set_default_tracer(tracer)
        trace_dir = tmp_path / "traces"
        fleet = ServingFleet(
            _chaos_factory, n_hosts=3, trace_dir=str(trace_dir),
            clock=fake, stale_after_s=5.0,
            max_batch_size=1, warmup_request=_WARM_REQ).start()
        gateway = None
        try:
            rv = fleet.rendezvous

            # -- readiness flips UP once every replica finishes warmup
            deadline = time.monotonic() + 30.0
            fh = rv.fleet_health()
            while time.monotonic() < deadline and not fh["all_ready"]:
                time.sleep(0.05)
                fh = rv.fleet_health()
            assert fh["all_ready"] and fh["alive"] == 3

            # -- SLO engine over the fleet aggregate, burn on FakeClock
            engine = SLOEngine(
                rv.aggregator,
                slos=[availability_slo("availability", 0.99,
                                       total=_SEEN, bad=_FAILED)],
                clock=fake, windows={"short": 60.0, "long": 600.0},
                burn_alert_threshold=10.0)
            rv.attach_slo(engine)
            rv.aggregator.scrape()
            engine.evaluate()  # baseline at t=0, before any traffic

            # -- gateway: an in-process proxy so http_send's traceparent
            #    injection chains client -> gateway -> replica
            targets = itertools.cycle(fleet.urls)

            def gw_handler(table: Table) -> Table:
                replies = []
                for req in table["request"]:
                    resp = http_send(HTTPRequestData(
                        "POST", next(targets), dict(req.headers or {}),
                        req.entity), retries=1)
                    replies.append(resp)
                return Table({"reply": replies})

            gateway = ServingServer(gw_handler, max_batch_size=1).start()

            # -- client traffic (one client span; each hop re-parents)
            statuses = []
            with tracer.start_span("client.request") as cspan:
                client_trace = cspan.trace_id
                client_span_id = cspan.span_id
                for i in range(15):
                    resp = http_send(HTTPRequestData.from_json(
                        gateway.url, {"x": float(i)}), retries=1)
                    statuses.append(resp.status_code)
            # chaos: each replica fails exactly its first live batch
            assert statuses.count(500) == 3
            assert statuses.count(200) == 12

            # -- burn-rate crossing, deterministically on the fake clock
            fake.advance(30.0)
            rv.aggregator.scrape()
            res = engine.evaluate()["availability"]
            # 3 bad / 15 total over a 1% budget = burn 20 on every window
            assert res["total"] == 15.0 and res["bad"] == 3.0
            assert res["burn_rates"]["short"] == pytest.approx(20.0)
            assert res["alerting"]
            assert engine.alerting() == ["availability"]

            # -- the fleet exposition includes the SLO series
            text = urllib.request.urlopen(
                rv.url + "/metrics", timeout=10).read().decode()
            assert "mmlspark_tpu_slo_burn_rate" in text
            parse_prometheus(text)  # parseable

            seen_before = rv.aggregator.total(_SEEN)
            assert seen_before == 15.0

            # -- kill one replica (hard: no drain, no final flush)
            fleet.kill(0)
            fake.advance(6.0)  # > stale_after_s: the kill becomes visible
            rv.aggregator.scrape()
            status = rv.aggregator.replica_status()
            assert not status["0"]["up"]
            assert status["1"]["up"] and status["2"]["up"]
            # counters stay monotone: the dead replica's last scrape holds
            assert rv.aggregator.total(_SEEN) == seen_before
            text = rv.render_metrics()
            fams = {f.name: f for f in parse_prometheus(text)}
            fleet_seen = [
                s for s in fams[_SEEN].samples
                if s.labels_dict()[REPLICA_LABEL] == FLEET_REPLICA]
            assert fleet_seen[0].value == seen_before

            # -- readiness flips DOWN through death
            fh = rv.fleet_health()
            assert not fh["all_ready"] and fh["alive"] == 2
        finally:
            if gateway is not None:
                gateway.stop()
            fleet.stop()
            set_default_tracer(old)

        # -- graceful stop exported replica traces; the killed replica
        #    contributed nothing (crash = no flush)
        files = sorted(p.name for p in trace_dir.iterdir())
        assert files == ["replica-1.jsonl", "replica-2.jsonl"]
        gw_path = trace_dir / "gateway.jsonl"
        tracer.export_jsonl(str(gw_path))
        merged = trace_dir / "merged.jsonl"
        n = merge_jsonl([str(trace_dir / f) for f in files]
                        + [str(gw_path)], str(merged))
        events = load_jsonl(str(merged))  # schema-validates every event
        assert len(events) == n
        assert [e["ts"] for e in events] == sorted(e["ts"] for e in events)

        # -- one trace id spans client -> gateway -> replica
        by_trace = [e for e in events
                    if e["args"].get("trace_id") == client_trace]
        gw_requests = [e for e in by_trace if e["name"] == "serving.request"
                       and e["pid"] != 0]
        # gateway-side request spans are parented on the CLIENT span
        gw_pid = json.loads(gw_path.read_text().splitlines()[0])["pid"]
        gw_req = [e for e in by_trace if e["name"] == "serving.request"
                  and e["pid"] == gw_pid]
        assert gw_req and all(
            e["args"]["parent_id"] == client_span_id for e in gw_req)
        gw_score_ids = {e["args"]["span_id"] for e in by_trace
                        if e["name"] == "serving.score"
                        and e["pid"] == gw_pid}
        # replica-side request spans are parented on a gateway score span
        replica_req = [e for e in by_trace
                       if e["name"] == "serving.request"
                       and e["pid"] != gw_pid]
        assert replica_req
        assert all(e["args"]["parent_id"] in gw_score_ids
                   for e in replica_req)
        assert gw_requests  # sanity: the trace really crossed processes

    def test_graceful_stop_flushes_final_counters(self, tmp_path):
        fleet = ServingFleet(_chaos_factory, n_hosts=2,
                             max_batch_size=1,
                             warmup_request=_WARM_REQ).start()
        rv = fleet.rendezvous
        try:
            for i in range(4):
                http_send(HTTPRequestData.from_json(
                    fleet.urls[i % 2], {"x": 1.0}), retries=1)
            info = fleet.info()
            assert info["totals"]["seen"] == 4
        finally:
            fleet.stop()
        # processes are gone, the rendezvous HTTP surface is gone — but
        # the final pushes landed before it stopped, so the aggregator's
        # totals survive the fleet (S3: /metrics and info cannot disagree)
        assert rv.aggregator.total(_SEEN) == 4.0
        st = rv.aggregator.replica_status()
        assert all(s["final"] and not s["up"] for s in st.values())



# --------------------------------------------------------------------- #
# the port against the JAX package                                      #
# --------------------------------------------------------------------- #


def _fill(reg, pkg_seen: float = 3.0) -> None:
    """The same registry content in either package's MetricsRegistry."""
    reg.counter(_SEEN, "seen", labels=("server",)).labels(server="0").inc(pkg_seen)
    c = reg.counter("mmlspark_tpu_rt_labeled_total", 'doc "q" \\\\ esc',
                    labels=("k",))
    c.labels(k='qu"ote\nnl\\bs').inc(2.5)
    reg.gauge("mmlspark_tpu_serving_queue_depth", "q").set(7)
    reg.gauge("mmlspark_tpu_rt_gauge_ratio", "").set(1e-9)
    h = reg.histogram("mmlspark_tpu_serving_latency_seconds", "lat")
    for v in (0.0004, 0.003, 0.02, 1e9):
        h.observe(v)
    reg.register_callback("mmlspark_tpu_rt_cb_total", "cb",
                          lambda: [({"lbl": "x"}, 5.0)], kind="counter")


class TestExpositionAcrossPackages:
    def test_registries_render_the_same_bytes(self):
        from mmlspark_tpu.observability.metrics import MetricsRegistry as RefRegistry

        mine, ref = MetricsRegistry(), RefRegistry()
        _fill(mine)
        _fill(ref)
        assert mine.render_prometheus() == ref.render_prometheus()

    def test_reference_text_round_trips_through_the_port(self):
        from mmlspark_tpu.observability.metrics import MetricsRegistry as RefRegistry

        ref = RefRegistry()
        _fill(ref)
        text = ref.render_prometheus()
        assert render_families(parse_prometheus(text)) == text

    def test_port_text_round_trips_through_the_reference(self):
        from mmlspark_tpu.observability.fleet import parse_prometheus as ref_parse
        from mmlspark_tpu.observability.fleet import render_families as ref_render

        mine = MetricsRegistry()
        _fill(mine)
        text = mine.render_prometheus()
        assert ref_render(ref_parse(text)) == text

    def test_fleet_aggregates_render_and_cross_byte_for_byte(self):
        from mmlspark_tpu.observability.fleet import MetricsAggregator as RefAggregator
        from mmlspark_tpu.observability.fleet import parse_prometheus as ref_parse
        from mmlspark_tpu.observability.fleet import render_families as ref_render

        texts = {"0": _replica_text(3, depth=2), "1": _replica_text(4, depth=5)}
        out = []
        for cls in (MetricsAggregator, RefAggregator):
            clock = FakeClock()
            agg = cls(urls={r: f"http://fake/{r}" for r in texts}, clock=clock,
                      fetch=lambda url, t: texts[url.rsplit("/", 1)[1]])
            agg.scrape()
            clock.advance(11.0)
            agg.push("9", _replica_text(5, depth=1), final=True)
            out.append((agg.render(), agg.snapshot(), agg.total(_SEEN)))
        assert out[0] == out[1]
        text = out[0][0]
        assert ref_render(parse_prometheus(text)) == text
        assert render_families(ref_parse(text)) == text


class TestSLOAcrossPackages:
    def test_burn_rates_and_alerts_step_by_step(self):
        from mmlspark_tpu.observability import slo as ref_slo

        steps = [(30.0, 100, 5), (30.0, 140, 45), (60.0, 200, 46),
                 (120.0, 1100, 46), (300.0, 1500, 60), (600.0, 4000, 61)]
        runs = []
        for mod in (__import__("mmlspark_tpu_torch.observability.slo",
                               fromlist=["SLOEngine"]), ref_slo):
            clock = FakeClock()
            state = {"snap": _source(0, 0)}
            src = type("Src", (), {"snapshot": lambda self: state["snap"]})()
            eng = mod.SLOEngine(src, slos=[mod.availability_slo(
                "avail", 0.99, total=_SEEN, bad=_FAILED)], clock=clock,
                windows={"short": 60.0, "long": 600.0},
                burn_alert_threshold=10.0)
            trail = [eng.evaluate()]
            for dt, seen, failed in steps:
                clock.advance(dt)
                state["snap"] = _source(seen, failed)
                trail.append((eng.evaluate(), eng.alerting(), eng.signals(),
                              eng.render()))
            runs.append(trail)
        # repr: an empty fleet's p99 signal is nan, which == would refuse
        assert repr(runs[0]) == repr(runs[1])

    def test_latency_slo_equal_over_the_same_histogram(self):
        from mmlspark_tpu.observability import slo as ref_slo
        from mmlspark_tpu.observability.metrics import MetricsRegistry as RefRegistry

        results = []
        for reg_cls, mod in ((MetricsRegistry, __import__(
                "mmlspark_tpu_torch.observability.slo", fromlist=["SLOEngine"])),
                (RefRegistry, ref_slo)):
            reg = reg_cls()
            h = reg.histogram("mmlspark_tpu_serving_latency_seconds", "lat",
                              buckets=(0.01, 0.1, 1.0))
            clock = FakeClock()
            eng = mod.SLOEngine(reg, slos=[mod.latency_slo(
                "lat", 0.9, histogram="mmlspark_tpu_serving_latency_seconds",
                threshold_s=0.1)], clock=clock, burn_alert_threshold=2.0)
            trail = [eng.evaluate()]
            rng = np.random.default_rng(5)
            for _ in range(4):
                for v in rng.exponential(0.08, size=50):
                    h.observe(float(v))
                clock.advance(45.0)
                trail.append((eng.evaluate(), eng.alerting(), eng.render()))
            results.append(trail)
        assert results[0] == results[1]
