"""The port's single-server serving stack (mmlspark_tpu_torch/io_http/
serving.py, schema.py, journal.py) held to the JAX package's:
tests/test_serving.py's TestContinuousLatency, TestBatchMode (the journal's
restart replay included), TestConcurrentLoad and TestServeModelLatency and
tests/test_io_http.py's TestServing and TestSchema through the port on the
CPU; journals written by one package replayed by the other; and both
packages serving a GBDT regressor with the same trees (fitted by the JAX
package, loaded into the port from its model string), their reply bytes
equal for the same requests. Every server stops in a `finally` and every
client call has a timeout."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu_torch.core.schema import Table  # noqa: E402
from mmlspark_tpu_torch.io_http import (  # noqa: E402
    HTTPRequestData,
    HTTPResponseData,
    ServingServer,
    make_reply,
    parse_request,
    serve_model,
)


def _post(url: str, payload: dict, timeout=10) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(url: str, timeout=10) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _echo_handler(table: Table) -> Table:
    t = parse_request(table)
    return make_reply(t.with_column("doubled", np.asarray(t["x"]) * 2), "doubled")


class TestContinuousLatency:
    def test_p50_single_digit_ms(self):
        """The continuous-path latency gate: warm jitted-step serving must
        answer at single-digit-ms p50 (reference claim ~1 ms,
        docs/mmlspark-serving.md:10-11; our gate is p50 < 10 ms, p99 < 50 ms
        on a shared CI CPU)."""
        srv = ServingServer(_echo_handler, max_latency_ms=0.2).start()
        try:
            for _ in range(20):                      # warm-up
                _post(srv.url, {"x": 1.0})
            srv.reset_latency_stats()
            for i in range(200):
                out = _post(srv.url, {"x": float(i)})
                assert out == {"doubled": 2.0 * i}
            stats = srv.latency_stats()
        finally:
            srv.stop()
        assert stats["n"] == 200
        print(f"serving latency p50={stats['p50_ms']:.2f}ms "
              f"p99={stats['p99_ms']:.2f}ms")
        assert stats["p50_ms"] < 10.0, stats
        assert stats["p99_ms"] < 50.0, stats

    def test_keepalive_client_rtt_no_transport_stall(self):
        """Full CLIENT round trip over a persistent HTTP/1.1 connection —
        the measurement the server-side window can't make. Regression gate
        for the Nagle/delayed-ACK class: an unbuffered two-segment
        response stalls ~40 ms per round trip behind the peer's delayed
        ACK, while the fixed path (buffered single-segment response +
        TCP_NODELAY) answers in ~1 ms. The 20 ms bar separates the two
        regimes with wide CI-noise margin."""
        import http.client
        import json as _json

        srv = ServingServer(_echo_handler, max_latency_ms=0.2).start()
        try:
            conn = http.client.HTTPConnection(srv.host, srv.port, timeout=30)
            body = _json.dumps({"x": 1.0}).encode()

            def post():
                conn.request("POST", srv.api_path, body=body,
                             headers={"Content-Type": "application/json"})
                r = conn.getresponse()
                r.read()
                assert r.status == 200

            for _ in range(20):
                post()
            lat = []
            for _ in range(100):
                t0 = time.perf_counter()
                post()
                lat.append(time.perf_counter() - t0)
            conn.close()
        finally:
            srv.stop()
        p50 = sorted(lat)[50] * 1e3
        assert p50 < 20.0, f"keep-alive client RTT p50 {p50:.1f} ms — " \
            "transport stall (Nagle/delayed-ACK) regression"

    def test_latency_in_info_endpoint(self):
        srv = ServingServer(_echo_handler).start()
        try:
            _post(srv.url, {"x": 3.0})
            info = _get(srv.url)
            assert info["answered"] == 1
            assert info["latency"]["n"] == 1
            assert info["latency"]["p50_ms"] > 0
        finally:
            srv.stop()


class TestBatchMode:
    def test_micro_batch_query_lifecycle(self):
        """Streaming query over a batch-mode server: ticks drain + score +
        reply without a caller-driven loop; handler errors 500 their batch
        but the query keeps serving."""
        import json as _json
        import urllib.request

        from mmlspark_tpu_torch.io_http import MicroBatchQuery

        srv = ServingServer(mode="batch").start()
        calls = {"n": 0}

        def handler(batch):
            calls["n"] += 1
            if calls["n"] == 2:
                raise RuntimeError("boom")
            replies = [
                HTTPResponseData(
                    200, "ok", {"Content-Type": "application/json"},
                    _json.dumps(
                        {"doubled": _json.loads(r.entity)["x"] * 2}
                    ).encode(),
                )
                for r in batch["request"]
            ]
            return Table({"id": list(batch["id"]), "reply": replies})

        q = MicroBatchQuery(srv, handler, trigger_interval_s=0.01).start()
        try:
            def post(x):
                req = urllib.request.Request(
                    srv.url, data=_json.dumps({"x": x}).encode(),
                    headers={"Content-Type": "application/json"},
                )
                try:
                    with urllib.request.urlopen(req, timeout=10) as r:
                        return r.status, _json.loads(r.read())
                except urllib.error.HTTPError as e:
                    return e.code, _json.loads(e.read())

            status, body = post(21)
            assert (status, body["doubled"]) == (200, 42)
            status2, body2 = post(1)          # second batch: handler raises
            assert status2 == 500 and "boom" in body2["error"]
            status3, body3 = post(5)          # query survived the error
            assert (status3, body3["doubled"]) == (200, 10)
            # counters increment AFTER the client unblocks — poll briefly
            deadline = time.monotonic() + 5.0
            while q.batches_processed < 3 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert q.batches_processed >= 3 and q.rows_processed >= 3
            assert isinstance(q.exception, RuntimeError)
        finally:
            q.stop()
            srv.stop()
        assert q.await_termination(1.0)

    def test_micro_batch_partial_answer_500s(self):
        """A handler that silently drops rows must 500 the whole batch
        (otherwise the dropped requests would park and re-serve forever)."""
        import json as _json
        import urllib.request

        from mmlspark_tpu_torch.io_http import MicroBatchQuery

        srv = ServingServer(mode="batch").start()

        def partial_handler(batch):
            return Table({"id": [], "reply": []})   # answers nothing

        q = MicroBatchQuery(srv, partial_handler, trigger_interval_s=0.01).start()
        try:
            req = urllib.request.Request(
                srv.url, data=b"{}",
                headers={"Content-Type": "application/json"},
            )
            try:
                with urllib.request.urlopen(req, timeout=10) as r:
                    status = r.status
            except urllib.error.HTTPError as e:
                status = e.code
                body = _json.loads(e.read())
                assert "must reply to every id" in body["error"]
            assert status == 500
            assert isinstance(q.exception, ValueError)
        finally:
            q.stop()
            srv.stop()

    def test_kill_and_restart_replays_exactly_once(self, tmp_path):
        """Durable serving (reference checkpointLocation contract,
        DistributedHTTPSource.scala:308-343): requests accepted before a
        crash are replayed by the restarted query and answered EXACTLY
        once — the journal records one reply per accepted id, duplicates
        are suppressed, and compaction trims completed pairs."""
        import json as _json
        import urllib.request

        from mmlspark_tpu_torch.io_http import MicroBatchQuery, ServingJournal

        ckpt = str(tmp_path / "ckpt")
        handled: list[str] = []

        def handler(batch):
            ids = list(batch["id"])
            handled.extend(str(i) for i in ids)
            replies = [
                HTTPResponseData(
                    200, "ok", {"Content-Type": "application/json"},
                    _json.dumps({"y": _json.loads(r.entity)["x"] + 1}).encode(),
                )
                for r in batch["request"]
            ]
            return Table({"id": ids, "reply": replies})

        # ---- incarnation 1: accept requests, serve NO batches, "crash" ---
        srv1 = ServingServer(mode="batch", checkpoint_dir=ckpt,
                             reply_timeout_s=0.2).start()
        for x in range(3):
            req = urllib.request.Request(
                srv1.url, data=_json.dumps({"x": x}).encode(),
                headers={"Content-Type": "application/json"},
            )
            try:
                urllib.request.urlopen(req, timeout=5)
            except urllib.error.HTTPError as e:
                assert e.code == 504        # no query running: client times out
        srv1.stop()                          # crash before any processing

        # ---- incarnation 2: same checkpoint dir -> replay ---------------
        srv2 = ServingServer(mode="batch", checkpoint_dir=ckpt).start()
        assert len(srv2.get_batch()) == 3    # recovery re-parked all three
        q = MicroBatchQuery(srv2, handler, trigger_interval_s=0.01,
                            compact_every_batches=0).start()
        deadline = time.monotonic() + 10.0
        while len(handled) < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        q.stop()
        assert sorted(handled) == ["0", "1", "2"]      # each exactly once
        j = srv2.journal
        assert not j.unanswered()
        for i in "012":
            resp = j.reply_of(i)
            assert resp is not None and resp.status_code == 200
            assert resp.json()["y"] == int(i) + 1
        # duplicate replies are dropped at the journal (exactly-once)
        srv2._pending["1"] = srv2._pending.get("1") or None  # no-op guard
        srv2.reply(["1"], [HTTPResponseData(200, "dup")])
        assert j.reply_of("1").json()["y"] == 2        # original answer kept
        # commit trimming: completed pairs leave the journal file
        assert j.compact() == 3
        srv2.stop()

        # ---- incarnation 3: nothing left to replay ----------------------
        srv3 = ServingServer(mode="batch", checkpoint_dir=ckpt).start()
        assert len(srv3.get_batch()) == 0
        srv3.stop()

    def test_journal_transient_failure_stays_replayable(self, tmp_path):
        """A handler error 500s the live client but must NOT commit as the
        request's durable answer: the journal keeps it unanswered, and the
        restarted query (with a healthy handler) replays it (the
        reference's failed-micro-batch rerun semantics)."""
        import json as _json
        import urllib.request

        from mmlspark_tpu_torch.io_http import MicroBatchQuery

        ckpt = str(tmp_path / "ckpt")
        srv = ServingServer(mode="batch", checkpoint_dir=ckpt).start()

        def broken(batch):
            raise RuntimeError("transient")

        q = MicroBatchQuery(srv, broken, trigger_interval_s=0.01).start()
        req = urllib.request.Request(
            srv.url, data=b'{"x": 7}',
            headers={"Content-Type": "application/json"})
        try:
            urllib.request.urlopen(req, timeout=10)
            raise AssertionError("expected a 500")
        except urllib.error.HTTPError as e:
            assert e.code == 500
        q.stop()
        assert list(srv.journal.unanswered()) == ["0"]   # not committed
        srv.stop()

        # restart with a healthy handler: the request replays and commits
        srv2 = ServingServer(mode="batch", checkpoint_dir=ckpt).start()

        def healthy(batch):
            replies = [HTTPResponseData(200, "ok", {}, b'{"done": true}')
                       for _ in batch["request"]]
            return Table({"id": list(batch["id"]), "reply": replies})

        q2 = MicroBatchQuery(srv2, healthy, trigger_interval_s=0.01).start()
        deadline = time.monotonic() + 10
        while srv2.journal.unanswered() and time.monotonic() < deadline:
            time.sleep(0.02)
        q2.stop()
        assert not srv2.journal.unanswered()
        assert srv2.journal.reply_of("0").status_code == 200
        srv2.stop()

    def test_journal_torn_tail_truncated_on_load(self, tmp_path):
        """A crash mid-append leaves a partial record; the loader must
        TRUNCATE it on disk — appending after a torn line would fuse the
        next record onto it and a later restart would silently lose
        everything from that point on."""
        import os

        from mmlspark_tpu_torch.io_http import ServingJournal
        from mmlspark_tpu_torch.io_http.schema import HTTPRequestData

        ckpt = str(tmp_path / "ckpt")
        j = ServingJournal(ckpt)
        j.record_accept("0", HTTPRequestData(entity=b"a"))
        j.close()
        with open(j.path, "a") as fh:
            fh.write('{"t": "accept", "id": "1", "ent')   # torn tail
        size_torn = os.path.getsize(j.path)
        j2 = ServingJournal(ckpt)
        assert list(j2.unanswered()) == ["0"]
        assert os.path.getsize(j2.path) < size_torn       # tail dropped
        j2.record_accept("2", HTTPRequestData(entity=b"c"))
        j2.close()
        # the post-crash append parses cleanly on the NEXT restart
        j3 = ServingJournal(ckpt)
        assert sorted(j3.unanswered()) == ["0", "2"]
        j3.close()

    def test_journal_same_process_retry_after_transient_failure(self, tmp_path):
        """A journaled batch that fails once is retried by the SAME query
        once the handler recovers — no restart needed."""
        import urllib.request

        from mmlspark_tpu_torch.io_http import MicroBatchQuery

        srv = ServingServer(mode="batch",
                            checkpoint_dir=str(tmp_path / "ckpt")).start()
        state = {"fail": True}

        def flaky(batch):
            if state["fail"]:
                state["fail"] = False
                raise RuntimeError("first tick fails")
            replies = [HTTPResponseData(200, "ok", {}, b'{"ok":1}')
                       for _ in batch["request"]]
            return Table({"id": list(batch["id"]), "reply": replies})

        q = MicroBatchQuery(srv, flaky, trigger_interval_s=0.01).start()
        try:
            req = urllib.request.Request(
                srv.url, data=b'{"x":1}',
                headers={"Content-Type": "application/json"})
            try:
                urllib.request.urlopen(req, timeout=10)
            except urllib.error.HTTPError as e:
                assert e.code == 500          # client saw the failure
            deadline = time.monotonic() + 10
            while srv.journal.unanswered() and time.monotonic() < deadline:
                time.sleep(0.02)
            assert not srv.journal.unanswered()
            assert srv.journal.reply_of("0").status_code == 200
        finally:
            q.stop()
            srv.stop()

    def test_journal_live_clients_and_id_resume(self, tmp_path):
        """With a live query, journaled serving answers clients normally;
        a restarted server resumes ids past the journaled range."""
        import json as _json
        import urllib.request

        from mmlspark_tpu_torch.io_http import MicroBatchQuery

        ckpt = str(tmp_path / "ckpt")
        srv = ServingServer(mode="batch", checkpoint_dir=ckpt).start()

        def handler(batch):
            replies = [
                HTTPResponseData(200, "ok", {}, b'{"ok": true}')
                for _ in batch["request"]
            ]
            return Table({"id": list(batch["id"]), "reply": replies})

        q = MicroBatchQuery(srv, handler, trigger_interval_s=0.01).start()
        try:
            req = urllib.request.Request(
                srv.url, data=b'{"x": 0}',
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=10) as r:
                assert r.status == 200
        finally:
            q.stop()
            srv.stop()
        srv2 = ServingServer(mode="batch", checkpoint_dir=ckpt).start()
        try:
            assert next(srv2._id_counter) == 1   # past journaled id 0
        finally:
            srv2.stop()

    def test_get_batch_reply_roundtrip(self):
        """Caller-driven micro-batch: requests park until get_batch drains
        them and reply() completes each exchange (HTTPSource semantics)."""
        srv = ServingServer(mode="batch").start()
        results = {}

        def client(i):
            results[i] = _post(srv.url, {"x": float(i)})

        threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        try:
            for t in threads:
                t.start()
            # wait until all four requests are parked
            import time

            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                batch = srv.get_batch()
                if len(batch) == 4:
                    break
                time.sleep(0.01)
            assert len(batch) == 4
            scored = parse_request(batch)
            out = make_reply(
                scored.with_column("y", np.asarray(scored["x"]) + 1), "y"
            )
            srv.reply_table(out.with_column("id", batch["id"]))
            for t in threads:
                t.join(timeout=5)
        finally:
            srv.stop()
        assert len(results) == 4
        for i, r in results.items():
            assert r == {"y": i + 1.0}

    def test_mode_guards(self):
        cont = ServingServer(_echo_handler)
        with pytest.raises(RuntimeError):
            cont.get_batch()
        with pytest.raises(ValueError):
            ServingServer(mode="continuous")  # no handler
        with pytest.raises(ValueError):
            ServingServer(_echo_handler, mode="nope")


class TestConcurrentLoad:
    def test_parallel_clients_all_answered(self):
        """8 client threads x 25 requests: every request answered correctly,
        counters consistent under concurrency (the reference's serving
        counters are part of its metrics surface,
        DistributedHTTPSource.scala:98-107)."""
        srv = ServingServer(_echo_handler, max_batch_size=16,
                            max_latency_ms=2.0).start()
        errors = []

        def client(tid):
            try:
                for i in range(25):
                    v = float(tid * 1000 + i)
                    out = _post(srv.url, {"x": v})
                    assert out == {"doubled": 2 * v}, out
            except Exception as e:  # noqa: BLE001 — collected for the assert
                errors.append((tid, repr(e)))

        threads = [threading.Thread(target=client, args=(t,)) for t in range(8)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not errors, errors
            assert srv.requests_seen == 200
            assert srv.requests_answered == 200
            assert srv.latency_stats()["n"] == 200
        finally:
            srv.stop()


class TestServeModelLatency:
    def test_model_serving_latency(self):
        """End-to-end: a fitted GBDT behind serve_model answers warm requests
        within the latency gate (persistent jitted scoring step)."""
        from mmlspark_tpu_torch.gbdt import GBDTClassifier

        rng = np.random.default_rng(0)
        x = rng.normal(size=(200, 4))
        y = (x[:, 0] > 0).astype(np.float64)
        model = GBDTClassifier(num_iterations=5, num_leaves=7, device="cpu").fit(
            Table({"features": x, "label": y})
        )
        srv = serve_model(model, input_cols=["f0", "f1", "f2", "f3"], device="cpu",
                          max_latency_ms=0.2)
        try:
            row = {f"f{j}": float(x[0, j]) for j in range(4)}
            for _ in range(10):                      # warm-up + compile
                _post(srv.url, row)
            srv.reset_latency_stats()
            for _ in range(50):
                out = _post(srv.url, row)
            assert out["prediction"] in (0.0, 1.0)
            stats = srv.latency_stats()
        finally:
            srv.stop()
        print(f"model serving p50={stats['p50_ms']:.2f}ms "
              f"p99={stats['p99_ms']:.2f}ms")
        assert stats["p50_ms"] < 25.0, stats



class TestServing:
    def test_serving_roundtrip_and_latency(self):
        def handler(table: Table) -> Table:
            t = parse_request(table)
            x = np.asarray(t["x"], np.float64)
            return make_reply(t.with_column("y", x * 2), "y")

        srv = ServingServer(handler, max_latency_ms=2.0).start()
        try:
            # warm the path once, then measure
            def post(v):
                req = urllib.request.Request(
                    srv.url, data=json.dumps({"x": v}).encode(),
                    headers={"Content-Type": "application/json"},
                )
                with urllib.request.urlopen(req, timeout=5) as r:
                    return json.loads(r.read())

            assert post(3.0)["y"] == 6.0
            t0 = time.perf_counter()
            for i in range(20):
                assert post(float(i))["y"] == 2.0 * i
            avg_ms = (time.perf_counter() - t0) / 20 * 1e3
            assert avg_ms < 250, f"serving too slow: {avg_ms:.1f} ms"
            assert srv.requests_answered >= 21
        finally:
            srv.stop()

    def test_serving_batches_concurrent_requests(self):
        seen_batches = []

        def handler(table: Table) -> Table:
            seen_batches.append(len(table))
            t = parse_request(table)
            return make_reply(t, "x")

        srv = ServingServer(handler, max_latency_ms=50.0, max_batch_size=16).start()
        try:
            results = []

            def post(v):
                req = urllib.request.Request(
                    srv.url, data=json.dumps({"x": v}).encode())
                with urllib.request.urlopen(req, timeout=10) as r:
                    results.append(json.loads(r.read())["x"])

            threads = [threading.Thread(target=post, args=(float(i),)) for i in range(8)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            assert sorted(results) == [float(i) for i in range(8)]
            assert max(seen_batches) > 1  # batching actually happened
        finally:
            srv.stop()

    def test_serve_model_end_to_end(self):
        from mmlspark_tpu_torch.gbdt import GBDTClassifier

        rng = np.random.default_rng(0)
        x = rng.normal(size=(300, 2))
        y = (x[:, 0] > 0).astype(np.float64)
        model = GBDTClassifier(num_iterations=5, num_leaves=7, device="cpu").fit(
            Table({"features": x, "label": y})
        )
        srv = serve_model(model, input_cols=["f0", "f1"], device="cpu")
        try:
            req = urllib.request.Request(
                srv.url, data=json.dumps({"f0": 2.0, "f1": 0.0}).encode())
            with urllib.request.urlopen(req, timeout=30) as r:
                out = json.loads(r.read())
            assert out["prediction"] == 1.0
        finally:
            srv.stop()

    def test_info_endpoint(self):
        srv = ServingServer(lambda t: make_reply(parse_request(t), "x")).start()
        try:
            with urllib.request.urlopen(srv.url, timeout=5) as r:
                info = json.loads(r.read())
            assert info["name"] == "mmlspark_tpu.serving"
        finally:
            srv.stop()


class TestSchema:
    def test_parse_request_flattens_numeric_and_vector(self):
        reqs = [HTTPRequestData.from_json("http://x", {"a": 1.5, "v": [1, 2]}),
                HTTPRequestData.from_json("http://x", {"a": 2.5, "v": [3, 4]})]
        t = parse_request(Table({"request": reqs}))
        np.testing.assert_allclose(t["a"], [1.5, 2.5])
        np.testing.assert_allclose(t["v"], [[1, 2], [3, 4]])

    def test_make_reply_json(self):
        t = Table({"y": np.asarray([1.0, 2.0])})
        out = make_reply(t, "y")
        assert out["reply"][0].json() == {"y": 1.0}



# --------------------------------------------------------------------- #
# across the packages
# --------------------------------------------------------------------- #


class TestJournalAcrossPackages:
    """A journal written by one package is replayed by the other: the same
    unanswered set, the same request bytes, the same reply records."""

    @pytest.mark.parametrize("writer", ["port", "ref"])
    def test_journal_written_by_one_package_replays_in_the_other(self, tmp_path, writer):
        from mmlspark_tpu.io_http import journal as ref_journal
        from mmlspark_tpu.io_http import schema as ref_schema
        from mmlspark_tpu_torch.io_http import journal as port_journal
        from mmlspark_tpu_torch.io_http import schema as port_schema

        (w_journal, w_schema), (r_journal, _) = (
            ((port_journal, port_schema), (ref_journal, ref_schema)) if writer == "port"
            else ((ref_journal, ref_schema), (port_journal, port_schema)))
        ckpt = str(tmp_path / "ckpt")
        j = w_journal.ServingJournal(ckpt)
        for i in range(4):
            j.record_accept(str(i), w_schema.HTTPRequestData(
                method="POST", url="/", headers={"Content-Type": "application/json"},
                entity=json.dumps({"x": i}).encode()))
        j.record_reply("1", w_schema.HTTPResponseData(
            200, "OK", {"Content-Type": "application/json"}, b'{"y": 2}'))
        j.close()
        other = r_journal.ServingJournal(ckpt)
        try:
            pending = other.unanswered()
            assert sorted(pending) == ["0", "2", "3"]
            assert [json.loads(pending[i].entity)["x"] for i in ("0", "2", "3")] == [0, 2, 3]
            assert pending["0"].headers == {"Content-Type": "application/json"}
            assert other.reply_of("1").json() == {"y": 2}
            assert other.max_id() == 3
        finally:
            other.close()

    def test_port_server_replays_a_journal_of_the_jax_package(self, tmp_path):
        from mmlspark_tpu.io_http import ServingJournal as RefJournal
        from mmlspark_tpu.io_http.schema import HTTPRequestData as RefRequest
        from mmlspark_tpu_torch.io_http import MicroBatchQuery

        ckpt = str(tmp_path / "ckpt")
        j = RefJournal(ckpt)
        for i in range(3):
            j.record_accept(str(i), RefRequest(entity=json.dumps({"x": i}).encode()))
        j.close()
        handled = []

        def handler(batch):
            ids = list(batch["id"])
            handled.extend(ids)
            replies = [HTTPResponseData(200, "ok", {}, json.dumps(
                {"y": json.loads(r.entity)["x"] * 10}).encode()) for r in batch["request"]]
            return Table({"id": ids, "reply": replies})

        srv = ServingServer(mode="batch", checkpoint_dir=ckpt).start()
        q = MicroBatchQuery(srv, handler, trigger_interval_s=0.01,
                            compact_every_batches=0).start()
        try:
            deadline = time.monotonic() + 10
            while len(handled) < 3 and time.monotonic() < deadline:
                time.sleep(0.02)
        finally:
            q.stop()
            srv.stop()
        assert sorted(handled) == ["0", "1", "2"]
        again = RefJournal(ckpt)
        try:
            assert not again.unanswered()
            assert again.reply_of("2").json() == {"y": 20}
        finally:
            again.close()


def _same_tree_models():
    """A GBDT regressor fitted by the JAX package and the port's model over
    the same trees (its model string), on f32-representable features."""
    from mmlspark_tpu.core.schema import Table as RefTable
    from mmlspark_tpu.gbdt.estimators import GBDTRegressor as RefRegressor
    from mmlspark_tpu_torch.gbdt.booster import Booster
    from mmlspark_tpu_torch.gbdt.estimators import GBDTRegressionModel

    rng = np.random.default_rng(17)
    x = rng.normal(size=(300, 4)).astype(np.float32).astype(np.float64)
    y = x @ np.asarray([1.0, -2.0, 0.5, 3.0]) + rng.normal(scale=0.1, size=300)
    ref = RefRegressor(num_iterations=6, num_leaves=7).fit(RefTable({"features": x, "label": y}))
    port = GBDTRegressionModel()
    port.booster = Booster.from_text(ref.booster.to_text(), device="cpu")
    return ref, port, x


class TestSameTreesAcrossPackages:
    """Both packages serve the same trees: equal reply bytes, JSON and the
    binary wire, on every route each package takes."""

    def test_reply_bytes_equal(self):
        from mmlspark_tpu.io_http.schema import HTTPRequestData as RefRequest
        from mmlspark_tpu.io_http.serving import serve_model as ref_serve_model
        from mmlspark_tpu_torch.io_http import wire

        ref, port, x = _same_tree_models()
        cols = ["x0", "x1", "x2", "x3"]
        rows = [dict(zip(cols, map(float, x[i]))) for i in range(24)]
        replies = {}
        for name, srv in (
                ("ref", ref_serve_model(ref, cols, max_batch_size=8,
                                        warmup_request=RefRequest.from_json("/", rows[0]))),
                ("port", serve_model(port, cols, max_batch_size=8, device="cpu",
                                     warmup_request=HTTPRequestData.from_json("/", rows[0])))):
            try:
                deadline = time.monotonic() + 60
                while not srv.ready:
                    assert time.monotonic() < deadline, f"{name} server never ready"
                    time.sleep(0.02)
                assert srv.hot_path is not None and srv.hot_path.disabled is None
                out = []
                for route in ("resident", "native", "host", None):
                    srv.hot_path.force_path = route
                    for row in rows:
                        req = urllib.request.Request(srv.url, data=json.dumps(row).encode(),
                                                     headers={"Content-Type": "application/json"})
                        with urllib.request.urlopen(req, timeout=30) as r:
                            out.append(r.read())
                    for row in rows[:4]:
                        req = urllib.request.Request(
                            srv.url, data=wire.encode_features_request(
                                np.asarray([row[c] for c in cols])),
                            headers={"Content-Type": wire.WIRE_CONTENT_TYPE,
                                     "Accept": wire.WIRE_CONTENT_TYPE})
                        with urllib.request.urlopen(req, timeout=30) as r:
                            out.append(r.read())
                replies[name] = out
            finally:
                srv.stop()
        assert replies["port"] == replies["ref"]
        assert len(set(replies["port"][:24])) > 1
