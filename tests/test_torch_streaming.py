"""The port's structured streaming (mmlspark_tpu_torch/streaming) held
against the JAX package's, scenario by scenario: the mirror of
tests/test_streaming.py. Every scenario runs once in each package over the
same seeded inputs; the two results must be equal (tables byte for byte),
and the reference test's own assertions then hold on the port's result.
Queries that fuse run the port on `device="cpu"`."""

from __future__ import annotations

import importlib
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tests.test_torch_streaming_common import PORT, both, canon, ns  # noqa: E402


def _tbl(m, lo, hi):
    return m.Table({"x": np.arange(float(lo), float(hi))})


# --------------------------------------------------------------------------- #
# commit log


class TestCommitLog:
    def test_plan_then_commit_roundtrip(self, tmp_path):
        def run(m, d):
            log = m.st.CommitLog(str(d))
            seen = [log.last_committed()]
            log.plan(0, None, {"rows": 3})
            seen += [log.planned(0), log.last_committed()]
            log.commit(0)
            log.close()
            log2 = m.st.CommitLog(str(d))
            seen += [log2.last_committed(), log2.planned(0)]
            log2.close()
            with open(log2.path, "rb") as fh:
                seen.append(fh.read())
            return seen

        seen = both(run, tmp_path)
        assert seen[:4] == [-1, {"start": None, "end": {"rows": 3}}, -1, 0]
        assert seen[4]["end"] == {"rows": 3}

    def test_torn_tail_is_truncated_on_disk(self, tmp_path):
        def run(m, d):
            log = m.st.CommitLog(str(d))
            log.plan(0, None, {"rows": 1})
            log.commit(0)
            log.close()
            with open(log.path, "ab") as fh:
                fh.write(b'{"t": "plan", "batch_id": 1, "sta')   # crash mid-append
            log2 = m.st.CommitLog(str(d))
            out = [log2.planned(1), log2.last_committed()]
            with open(log2.path, "rb") as fh:
                out.append(fh.read())
            log2.close()
            return out

        planned, last, data = both(run, tmp_path)
        assert planned is None and last == 0
        assert b'"batch_id": 1' not in data
        assert data.endswith(b'{"t": "commit", "batch_id": 0}\n')

    def test_state_snapshots_and_pruning(self, tmp_path):
        def run(m, d):
            log = m.st.CommitLog(str(d))
            log.write_state(0, {"ops": [{"n": 1}]})
            log.write_state(1, {"ops": [{"n": 2}]})
            out = [log.read_state(1)]
            log.prune_state(keep_from=1)
            out += [log.read_state(0), log.read_state(1), sorted(os.listdir(d))]
            log.close()
            return out

        out = both(run, tmp_path)
        assert out[:3] == [{"ops": [{"n": 2}]}, None, {"ops": [{"n": 2}]}]

    def test_compact_keeps_last_committed_plan(self, tmp_path):
        def run(m, d):
            log = m.st.CommitLog(str(d))
            for b in range(5):
                log.plan(b, {"rows": b}, {"rows": b + 1})
                log.commit(b)
            dropped = log.compact()
            log.close()
            log2 = m.st.CommitLog(str(d))
            out = [dropped, log2.last_committed(), log2.planned(4), log2.planned(0)]
            log2.close()
            return out

        dropped, last, p4, p0 = both(run, tmp_path)
        assert dropped > 0 and last == 4
        assert p4 == {"start": {"rows": 4}, "end": {"rows": 5}}
        assert p0 is None


# --------------------------------------------------------------------------- #
# sources


class TestSources:
    def test_memory_source_offsets_and_trim(self):
        def run(m):
            src = m.st.MemorySource()
            out = [src.get_offset()]
            src.add_rows(_tbl(m, 0, 3))
            end = src.get_offset()
            out += [end, src.get_batch(None, end)]
            src.commit(end)
            src.add_rows(_tbl(m, 3, 5))
            end2 = src.get_offset()
            out.append(src.get_batch(end, end2))
            with pytest.raises(ValueError, match="trimmed"):
                src.get_batch(None, end2)         # committed rows are gone
            return out

        out = both(run)
        assert out[0] is None and out[1] == {"rows": 3}
        assert list(out[2]["x"]) == [0, 1, 2] and list(out[3]["x"]) == [3, 4]

    def test_directory_source_delta_batches(self, tmp_path):
        def run(m, d):
            d = str(d / "in")
            os.makedirs(d)
            src = m.st.DirectorySource(d, "*.csv")
            out = [src.get_offset()]
            m.table_io.write_csv(_tbl(m, 0, 2), os.path.join(d, "a-000.csv"))
            end1 = src.get_offset()
            out += [end1, src.get_batch(None, end1)]
            m.table_io.write_csv(_tbl(m, 2, 5), os.path.join(d, "a-001.csv"))
            end2 = src.get_offset()
            out += [src.get_batch(end1, end2), src.empty_range(end2, end2)]
            # dot-prefixed temp files are invisible (atomic-writer contract)
            with open(os.path.join(d, ".tmp-b.csv"), "w") as fh:
                fh.write("x\n1\n")
            out.append(src.get_offset() == end2)
            return out

        out = both(run, tmp_path)
        assert out[0] is None and out[1] == {"files": ["a-000.csv"]}
        assert list(out[2]["x"]) == [0, 1] and list(out[3]["x"]) == [2, 3, 4]
        assert out[4] is True and out[5] is True

    def test_socket_source_lines(self):
        def run(m):
            server = socket.create_server(("127.0.0.1", 0))
            host, port = server.getsockname()

            def feed():
                conn, _ = server.accept()
                conn.sendall(b"alpha\nbeta\ngam")
                time.sleep(0.05)
                conn.sendall(b"ma\n")
                conn.close()

            t = threading.Thread(target=feed, daemon=True)
            t.start()
            src = m.st.SocketSource(host, port)
            try:
                deadline = time.monotonic() + 5
                while time.monotonic() < deadline:
                    off = src.get_offset()
                    if off and off["rows"] >= 3:
                        break
                    time.sleep(0.01)
                batch = src.get_batch(None, {"rows": 3})
            finally:
                src.close()
                server.close()
            t.join(timeout=2)
            return batch

        assert list(both(run)["value"]) == ["alpha", "beta", "gamma"]


# --------------------------------------------------------------------------- #
# sinks


class TestSinks:
    def test_memory_sink_idempotent(self):
        def run(m):
            sink = m.st.MemorySink()
            sink.add_batch(0, _tbl(m, 0, 2))
            sink.add_batch(0, _tbl(m, 50, 99))       # replay: dropped
            sink.add_batch(1, _tbl(m, 2, 3))
            return [sink.table(), sink.batch_ids()]

        table, ids = both(run)
        assert list(table["x"]) == [0, 1, 2] and ids == [0, 1]

    def test_parquet_sink_idempotent_and_atomic(self, tmp_path):
        pytest.importorskip("pyarrow")

        def run(m, d):
            sink = m.st.ParquetSink(str(d))
            sink.add_batch(0, _tbl(m, 0, 2))
            sink.add_batch(1, _tbl(m, 2, 4))
            sink.add_batch(0, _tbl(m, 50, 99))       # replay: existing part wins
            names = sorted(os.listdir(str(d)))
            table = sink.table()
            sink.add_batch(2, m.Table({}))          # empty batch: no file
            return [names, table, len(os.listdir(str(d)))]

        names, table, n = both(run, tmp_path)
        assert names == ["part-000000000.parquet", "part-000000001.parquet"]
        assert list(table["x"]) == [0, 1, 2, 3] and n == 2

    def test_foreach_batch_sink(self):
        def run(m):
            seen = []
            sink = m.st.ForeachBatchSink(lambda t, bid: seen.append((bid, t.num_rows)))
            sink.add_batch(7, _tbl(m, 0, 3))
            return seen

        assert both(run) == [(7, 3)]

    def test_powerbi_sink_posts_rows_in_batches(self):
        """PowerBISink (not in the reference's tests): the same POSTs of the
        same rows in both packages, through an injected client."""
        def run(m):
            posted = []

            class Client:
                def send_all(self, reqs):
                    posted.extend((r.method, r.url, json.loads(r.entity)) for r in reqs)
                    return [m.http_schema.HTTPResponseData(200, "OK") for _ in reqs]

            sink = m.st.PowerBISink("http://powerbi.invalid/rows", batch_size=2,
                                    client=Client())
            sink.add_batch(0, _tbl(m, 0, 5))
            sink.add_batch(1, m.Table({"x": np.zeros(0)}))   # empty: no POST
            return [posted, sink.requests_sent]

        posted, sent = both(run)
        assert sent == 3 and [len(p[2]) for p in posted] == [2, 2, 1]


# --------------------------------------------------------------------------- #
# stateful operators


class TestStatefulOperators:
    def test_grouped_running_aggregate(self):
        def run(m):
            agg = m.st.GroupedAggregator(group_col="k", value_col="v", agg="mean")
            agg.transform(m.Table({"k": ["a", "b"], "v": np.array([2.0, 10.0])}))
            return agg.transform(m.Table({"k": ["a"], "v": np.array([4.0])}))

        out = both(run)
        assert list(out["k"]) == ["a", "b"]
        assert list(out["aggregate"]) == [3.0, 10.0]   # running mean

    def test_grouped_state_doc_roundtrip(self):
        def run(m):
            a = m.st.GroupedAggregator(group_col="k", agg="count")
            a.transform(m.Table({"k": ["x", "x", "y"]}))
            b = m.st.GroupedAggregator(group_col="k", agg="count")
            doc = json.loads(json.dumps(a.state_doc()))
            b.load_state_doc(doc)
            return [doc, b.transform(m.Table({"k": ["y"]}))]

        _doc, out = both(run)
        assert list(out["aggregate"]) == [2.0, 2.0]

    def test_state_doc_loads_across_packages(self):
        """A state doc the JAX package's operator wrote resumes in the port's
        operator and folds the next batch to the same table."""
        ref, port = ns("mmlspark_tpu"), ns(PORT)
        a = ref.st.WindowedAggregator(time_col="t", window_s=10.0, group_col="g",
                                      agg="count", watermark_delay_s=2.0)
        a.transform(ref.Table({"t": np.array([1.0, 4.0, 13.0]), "g": ["a", "b", "a"]}))
        b = port.st.WindowedAggregator(time_col="t", window_s=10.0, group_col="g",
                                       agg="count", watermark_delay_s=2.0)
        b.load_state_doc(json.loads(json.dumps(a.state_doc())))
        nxt = {"t": np.array([15.0, 24.0]), "g": ["b", "a"]}
        assert canon(b.transform(port.Table(dict(nxt)))) == canon(
            a.transform(ref.Table(dict(nxt))))

    def test_windowed_watermark_and_late_drop(self):
        def run(m):
            w = m.st.WindowedAggregator(time_col="t", window_s=10.0, agg="count",
                                        watermark_delay_s=5.0)
            out1 = w.transform(m.Table({"t": np.array([1.0, 2.0, 12.0])}))
            wm = w.watermark()
            out2 = w.transform(m.Table({"t": np.array([16.0, 3.0])}))
            late = w.late_rows_dropped
            out3 = w.transform(m.Table({"t": np.array([17.0])}))
            return [out1, wm, out2, late, out3]

        out1, wm, out2, late, out3 = both(run)
        # watermark = 12 - 5 = 7: no window end (10, 20, ...) passed yet
        assert out1.num_rows == 0 and wm == 7.0
        # 3.0 predates the batch-start watermark (7) -> dropped as late
        assert late == 1
        # new watermark 11 >= window [0,10) end -> emitted exactly once
        assert list(out2["window_start"]) == [0.0] and list(out2["aggregate"]) == [2.0]
        assert 0.0 not in list(out3["window_start"])   # never re-emitted

    def test_windowed_groups_and_flush(self):
        def run(m):
            # delay large enough that no window finalizes before flush()
            w = m.st.WindowedAggregator(time_col="t", window_s=10.0, group_col="g",
                                        value_col="v", agg="sum",
                                        watermark_delay_s=100.0)
            w.transform(m.Table({"t": np.array([1.0, 2.0, 11.0]),
                                 "g": ["a", "b", "a"],
                                 "v": np.array([1.0, 2.0, 4.0])}))
            return [w.flush(), w.flush().num_rows]

        rest, n_after = both(run)
        got = {(s, g): v for s, g, v in zip(
            rest["window_start"], rest["g"], rest["aggregate"])}
        assert got == {(0.0, "a"): 1.0, (0.0, "b"): 2.0, (10.0, "a"): 4.0}
        assert n_after == 0        # state evicted

    def test_save_load_mid_stream(self, tmp_path):
        def run(m, d):
            w = m.st.WindowedAggregator(time_col="t", window_s=10.0, agg="count",
                                        watermark_delay_s=0.0)
            w.transform(m.Table({"t": np.array([1.0, 15.0])}))
            w.save(str(d / "w"))
            w2 = m.pipeline.PipelineStage.load(str(d / "w"))
            o1 = w.transform(m.Table({"t": np.array([25.0])}))
            o2 = w2.transform(m.Table({"t": np.array([25.0])}))
            return [o1, o2]

        o1, o2 = both(run, tmp_path)
        assert list(o1["window_start"]) == list(o2["window_start"]) == [10.0]
        assert list(o1["aggregate"]) == list(o2["aggregate"])

    def test_saved_operator_loads_in_the_other_package(self, tmp_path):
        ref, port = ns("mmlspark_tpu"), ns(PORT)
        w = ref.st.WindowedAggregator(time_col="t", window_s=10.0, agg="count",
                                      watermark_delay_s=0.0)
        w.transform(ref.Table({"t": np.array([1.0, 15.0])}))
        w.save(str(tmp_path / "w"))
        w2 = port.pipeline.PipelineStage.load(str(tmp_path / "w"))
        assert type(w2).__module__ == "mmlspark_tpu_torch.streaming.state"
        assert canon(w2.transform(port.Table({"t": np.array([25.0])}))) == canon(
            w.transform(ref.Table({"t": np.array([25.0])})))


# --------------------------------------------------------------------------- #
# the driver


class TestStreamingQuery:
    def test_memory_to_memory_incremental(self):
        def run(m):
            src, sink = m.st.MemorySource(), m.st.MemorySink()
            q = m.st.StreamingQuery(src, None, sink, **m.dev)
            src.add_rows(_tbl(m, 0, 3))
            n = [q.process_all_available(), q.process_all_available()]
            src.add_rows(_tbl(m, 3, 5))
            n.append(q.process_all_available())
            return [n, sink.table(), q.batches_processed, q.rows_processed,
                    q.last_progress["batch_id"]]

        n, table, batches, rows, last = both(run)
        assert n == [1, 0, 1]
        assert list(table["x"]) == [0, 1, 2, 3, 4]
        assert batches == 2 and rows == 5 and last == 1

    def test_background_trigger_loop(self):
        def run(m):
            src, sink = m.st.MemorySource(), m.st.MemorySink()
            q = m.st.StreamingQuery(src, None, sink, trigger_interval_s=0.01,
                                    **m.dev).start()
            try:
                active = q.is_active
                src.add_rows(_tbl(m, 0, 4))
                deadline = time.monotonic() + 5
                while q.batches_processed < 1 and time.monotonic() < deadline:
                    time.sleep(0.01)
                processed = q.batches_processed >= 1
            finally:
                q.stop()
            return [active, processed, q.await_termination(1.0), sink.table()]

        active, processed, ended, table = both(run)
        assert active and processed and ended
        assert list(table["x"]) == [0, 1, 2, 3]

    def test_stateful_rollback_on_sink_failure(self, tmp_path):
        """A failed batch must not leak half-folded operator state into the
        retry — the WAL plan makes the retry identical, so the committed
        aggregate counts every row exactly once."""
        def run(m, d):
            agg = m.st.GroupedAggregator(group_col="k", agg="count")
            src = m.st.MemorySource()

            class FlakySink(m.st.MemorySink):
                def __init__(self):
                    super().__init__()
                    self.failures_left = 1

                def add_batch(self, batch_id, table):
                    if self.failures_left > 0:
                        self.failures_left -= 1
                        raise OSError("sink hiccup")
                    super().add_batch(batch_id, table)

            sink = FlakySink()
            q = m.st.StreamingQuery(src, agg, sink, checkpoint_dir=str(d), **m.dev)
            src.add_rows(m.Table({"k": ["a", "a", "b"]}))
            with pytest.raises(OSError):
                q.process_next()
            retried = q.process_next()        # retry of the SAME planned batch
            return [retried, sink.table()]

        retried, out = both(run, tmp_path)
        assert retried
        assert dict(zip(out["k"], out["aggregate"])) == {"a": 2.0, "b": 1.0}

    def test_transform_callable_and_pipeline_stage(self):
        def run(m):
            src, sink = m.st.MemorySource(), m.st.MemorySink()
            q = m.st.StreamingQuery(src, lambda t: t.with_column("y", t["x"] * 2),
                                    sink, **m.dev)
            src.add_rows(_tbl(m, 0, 3))
            q.process_all_available()
            return sink.table()

        assert list(both(run)["y"]) == [0, 2, 4]

    def test_checkpoint_restart_skips_committed(self, tmp_path):
        def run(m, d):
            inp = str(d / "in")
            os.makedirs(inp)
            m.table_io.write_csv(_tbl(m, 0, 3), os.path.join(inp, "f-000.csv"))
            ck = str(d / "ck")
            q1 = m.st.StreamingQuery(m.st.DirectorySource(inp, "*.csv"), None,
                                     m.st.MemorySink(), checkpoint_dir=ck, **m.dev)
            n1 = q1.process_all_available()
            q1.stop()
            # restart: committed files are not re-read; only new ones flow
            m.table_io.write_csv(_tbl(m, 3, 4), os.path.join(inp, "f-001.csv"))
            sink2 = m.st.MemorySink()
            q2 = m.st.StreamingQuery(m.st.DirectorySource(inp, "*.csv"), None, sink2,
                                     checkpoint_dir=ck, **m.dev)
            n2 = q2.process_all_available()
            q2.stop()
            with open(os.path.join(ck, "commits.jsonl"), "rb") as fh:
                wal = fh.read()
            return [n1, n2, sink2.table(), wal]

        n1, n2, table, _wal = both(run, tmp_path)
        assert n1 == n2 == 1 and list(table["x"]) == [3.0]

    def test_stateful_query_recovers_operator_state(self, tmp_path):
        def run(m, d):
            inp = str(d / "in")
            os.makedirs(inp)
            ck = str(d / "ck")
            m.table_io.write_csv(m.Table({"k": ["a", "a"]}), os.path.join(inp, "f-000.csv"))
            q1 = m.st.StreamingQuery(m.st.DirectorySource(inp, "*.csv"),
                                     m.st.GroupedAggregator(group_col="k", agg="count"),
                                     m.st.MemorySink(), checkpoint_dir=ck, **m.dev)
            q1.process_all_available()
            q1.stop()
            m.table_io.write_csv(m.Table({"k": ["a", "b"]}), os.path.join(inp, "f-001.csv"))
            sink2 = m.st.MemorySink()
            q2 = m.st.StreamingQuery(m.st.DirectorySource(inp, "*.csv"),
                                     m.st.GroupedAggregator(group_col="k", agg="count"),
                                     sink2, checkpoint_dir=ck, **m.dev)
            q2.process_all_available()
            q2.stop()
            return sink2.table()

        out = both(run, tmp_path)
        # "a" counts BOTH files: the restart restored the running state
        assert dict(zip(out["k"], out["aggregate"])) == {"a": 3.0, "b": 1.0}

    def test_checkpoint_written_by_one_package_resumes_in_the_other(self, tmp_path):
        """The WAL and state snapshots are one format: a query of the JAX
        package commits a batch, the port's query resumes after it."""
        ref, port = ns("mmlspark_tpu"), ns(PORT)
        inp, ck = str(tmp_path / "in"), str(tmp_path / "ck")
        os.makedirs(inp)
        ref.table_io.write_csv(ref.Table({"k": ["a", "a"]}), os.path.join(inp, "f-000.csv"))
        q1 = ref.st.StreamingQuery(ref.st.DirectorySource(inp, "*.csv"),
                                   ref.st.GroupedAggregator(group_col="k", agg="count"),
                                   ref.st.MemorySink(), checkpoint_dir=ck)
        q1.process_all_available()
        q1.stop()
        ref.table_io.write_csv(ref.Table({"k": ["a", "b"]}), os.path.join(inp, "f-001.csv"))
        sink2 = port.st.MemorySink()
        q2 = port.st.StreamingQuery(port.st.DirectorySource(inp, "*.csv"),
                                    port.st.GroupedAggregator(group_col="k", agg="count"),
                                    sink2, checkpoint_dir=ck, device="cpu")
        assert q2.process_all_available() == 1
        q2.stop()
        out = sink2.table()
        assert dict(zip(out["k"], out["aggregate"])) == {"a": 3.0, "b": 1.0}

    def test_device_cuda_without_a_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: cuda is not refused here")
        port = ns(PORT)
        model = port.pipeline.pipeline_model(
            port.st.GroupedAggregator(group_col="k", agg="count"))
        with pytest.raises(RuntimeError, match="cuda"):
            port.st.StreamingQuery(port.st.MemorySource(), model, port.st.MemorySink())
        with pytest.raises(RuntimeError, match="cuda"):
            port.st.StreamingQuery(port.st.MemorySource(), model, port.st.MemorySink(),
                                   device="cuda")


# --------------------------------------------------------------------------- #
# serving parity


def _doubling_handler_for(m):
    def handler(batch):
        replies = [
            m.http_schema.HTTPResponseData(
                200, "ok", {"Content-Type": "application/json"},
                json.dumps({"doubled": json.loads(r.entity)["x"] * 2}).encode())
            for r in batch["request"]]
        return m.Table({"id": list(batch["id"]), "reply": replies})
    return handler


def _post(url: str, payload: dict) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


class TestServingSource:
    def test_requires_batch_mode(self):
        def run(m):
            srv = m.serving.ServingServer(lambda t: t)      # continuous mode
            with pytest.raises(ValueError, match="batch") as e:
                m.st.ServingSource(srv)
            return str(e.value)

        both(run)

    def test_streaming_query_serves_same_replies_as_micro_batch_path(self):
        """A ServingSource-backed StreamingQuery answers requests with the
        byte-same bodies as the MicroBatchQuery serving path, in both
        packages."""
        def run(m):
            handler = _doubling_handler_for(m)
            srv_a = m.serving.ServingServer(mode="batch").start()
            srv_b = m.serving.ServingServer(mode="batch").start()
            qa = m.io_http.MicroBatchQuery(srv_a, handler, trigger_interval_s=0.01).start()
            qb = m.st.StreamingQuery(m.st.ServingSource(srv_b), handler,
                                     m.st.ReplySink(srv_b), trigger_interval_s=0.01,
                                     **m.dev).start()
            try:
                pairs = [(_post(srv_a.url, {"x": x}), _post(srv_b.url, {"x": x}))
                         for x in (3, 11, 20)]
                return [pairs, qb.batches_processed >= 1, qb.exception is None]
            finally:
                qa.stop()
                qb.stop()
                srv_a.stop()
                srv_b.stop()

        pairs, progressed, clean = both(run)
        assert all(a == b for a, b in pairs) and progressed and clean

    def test_serving_offsets_are_pending_ids(self):
        def run(m):
            srv = m.serving.ServingServer(mode="batch").start()
            src = m.st.ServingSource(srv)
            try:
                first = src.get_offset()
                results: list[dict] = []
                t = threading.Thread(
                    target=lambda: results.append(_post(srv.url, {"x": 1})), daemon=True)
                t.start()
                deadline = time.monotonic() + 5
                while src.get_offset() is None and time.monotonic() < deadline:
                    time.sleep(0.01)
                end = src.get_offset()
                batch = src.get_batch(None, end)
                same_ids = list(batch["id"]) == end["ids"]
                m.st.ReplySink(srv).add_batch(0, _doubling_handler_for(m)(batch))
                t.join(timeout=5)
                return [first, len(end["ids"]), same_ids, results]
            finally:
                srv.stop()

        assert both(run) == [None, 1, True, [{"doubled": 2}]]


    def test_offset_leaves_the_batch_in_flight_out(self):
        """The lookahead asks for the offset after `start` while start's
        batch still runs, its requests still pending. The JAX package's
        ServingSource offers them again, so the query scores them twice and
        journals a second reply once commit has compacted the journal (a
        fault of the reference, ROADMAP Queue 3); the port's offset is the
        reference's without the ids in flight."""
        offsets = {}
        for pkg in ("mmlspark_tpu", PORT):
            m = ns(pkg)
            srv = m.serving.ServingServer(mode="batch", reply_timeout_s=5.0).start()
            src = m.st.ServingSource(srv, max_rows=4)
            posters = [threading.Thread(target=lambda i=i: _post(srv.url, {"x": i}), daemon=True)
                       for i in range(6)]
            try:
                for th in posters:
                    th.start()
                deadline = time.monotonic() + 5
                while len(srv.get_batch()) < 6 and time.monotonic() < deadline:
                    time.sleep(0.01)
                offsets[pkg] = (src.get_offset(None), src.get_offset({"ids": ["0", "1"]}))
                m.st.ReplySink(srv).add_batch(0, _doubling_handler_for(m)(
                    src.get_batch(None, {"ids": [str(i) for i in range(6)]})))
            finally:
                for th in posters:
                    th.join(timeout=10)
                srv.stop()
        (ref_first, ref_next), (first, nxt) = offsets["mmlspark_tpu"], offsets[PORT]
        assert first == ref_first == {"ids": ["0", "1", "2", "3"]}
        assert ref_next == {"ids": ["0", "1", "2", "3"]}
        assert nxt == {"ids": [i for i in ref_next["ids"] if i not in ("0", "1")] + ["4", "5"]}

    def test_journaled_stream_answers_each_request_once(self, tmp_path):
        """A journaled server streamed by a query with its source lookahead:
        the lookahead asks for the next offset while a batch is in flight.
        The port leaves that batch's ids out, so every request is scored
        and journaled once; the replies are the JAX package's bodies. (The
        JAX package's ServingSource re-plans the in-flight ids, scores them
        a second time and, once commit has compacted the journal, journals
        a second reply: a fault of the reference, ROADMAP Queue 3.)"""
        import collections

        def run(m, d):
            handler = _doubling_handler_for(m)
            scored = collections.Counter()

            def slow(batch):
                scored.update(str(i) for i in batch["id"])
                time.sleep(0.05)                      # the lookahead overlaps this
                return handler(batch)

            srv = m.serving.ServingServer(mode="batch", checkpoint_dir=str(d / "j")).start()
            journaled = collections.Counter()
            record = srv.journal.record_reply

            def counted(ex_id, resp):
                ok = record(ex_id, resp)
                journaled[str(ex_id)] += int(ok)
                return ok

            srv.journal.record_reply = counted
            q = m.st.StreamingQuery(m.st.ServingSource(srv, max_rows=4), slow,
                                    m.st.ReplySink(srv), checkpoint_dir=str(d / "ck"),
                                    trigger_interval_s=0.005, **m.dev).start()
            out = [None] * 12
            try:
                def client(i):
                    out[i] = _post(srv.url, {"x": i})

                threads = [threading.Thread(target=client, args=(i,)) for i in range(12)]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(timeout=30)
                time.sleep(0.3)                       # let a stray re-plan land
            finally:
                q.stop()
                srv.stop()
            return out, scored, journaled

        results = {}
        for pkg in ("mmlspark_tpu", PORT):
            d = tmp_path / pkg
            d.mkdir()
            results[pkg] = run(ns(pkg), d)
        replies, scored, journaled = results[PORT]
        assert replies == results["mmlspark_tpu"][0] == [{"doubled": 2 * i} for i in range(12)]
        assert len(scored) == 12 and set(scored.values()) == {1}, scored
        assert len(journaled) == 12 and set(journaled.values()) == {1}, journaled


# --------------------------------------------------------------------------- #
# end-to-end: files -> featurize -> GBDT -> parquet, with kill/restart


def _training_columns(n=80, seed=7):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=n)
    b = rng.normal(size=n)
    y = 2.0 * a - b + 0.01 * rng.normal(size=n)
    return {"a": a, "b": b, "label": y}


def _fit_reference_pipeline(tmp_path):
    """The scoring pipeline fitted by the JAX package and saved; both
    packages load the one saved model (the port's GBDT loads the JAX
    package's booster)."""
    ref = ns("mmlspark_tpu")
    from mmlspark_tpu.gbdt.estimators import GBDTRegressor
    from mmlspark_tpu.ops.featurize import Featurize

    model = ref.pipeline.Pipeline([
        Featurize(feature_columns={"features": ["a", "b"]}),
        GBDTRegressor(num_iterations=5, num_leaves=7, label_col="label"),
    ]).fit(ref.Table(_training_columns()))
    path = str(tmp_path / "model")
    model.save(path)
    return path


def _load(m, path):
    """The saved model in package `m`; the port's stages score on the CPU
    (a loaded booster holds "cuda" until told otherwise)."""
    importlib.import_module(f"{m.name}.gbdt.estimators")
    importlib.import_module(f"{m.name}.ops.featurize")
    model = m.pipeline.PipelineStage.load(path)
    if m.is_port:
        for s in model.get("stages"):
            if hasattr(s, "to"):
                s.to("cpu")
    return model


@pytest.mark.slow
class TestEndToEnd:
    def test_stream_matches_batch_transform(self, tmp_path):
        """DirectorySource -> Featurize -> GBDT -> ParquetSink over files
        appended WHILE the query runs equals one batch transform."""
        pytest.importorskip("pyarrow")
        path = _fit_reference_pipeline(tmp_path)

        def run(m, d):
            model = _load(m, path)
            inp = str(d / "in")
            os.makedirs(inp)
            sink = m.st.ParquetSink(str(d / "out"))
            q = m.st.StreamingQuery(m.st.DirectorySource(inp, "*.csv"), model, sink,
                                    checkpoint_dir=str(d / "ck"),
                                    trigger_interval_s=0.01, **m.dev).start()
            rng = np.random.default_rng(11)
            chunks = []
            try:
                for i in range(4):
                    chunk = m.Table({"a": rng.normal(size=5), "b": rng.normal(size=5),
                                     "label": rng.normal(size=5)})
                    chunks.append(chunk)
                    tmp = os.path.join(inp, f".tmp-{i:03d}.csv")
                    m.table_io.write_csv(chunk, tmp)
                    os.replace(tmp, os.path.join(inp, f"chunk-{i:03d}.csv"))
                    time.sleep(0.05)
                deadline = time.monotonic() + 30
                while q.rows_processed < 20 and time.monotonic() < deadline:
                    time.sleep(0.02)
            finally:
                q.stop()
            whole = chunks[0]
            for c in chunks[1:]:
                whole = whole.concat(c)
            expected = model.transform(whole)
            got = sink.table()
            assert q.exception is None
            assert got.num_rows == expected.num_rows == 20
            np.testing.assert_array_equal(np.asarray(got["prediction"]),
                                          np.asarray(expected["prediction"]))
            return np.asarray(got["prediction"])

        out = {}
        for pkg in ("mmlspark_tpu", PORT):
            d = tmp_path / pkg
            d.mkdir()
            out[pkg] = run(ns(pkg), d)
        np.testing.assert_allclose(out[PORT], out["mmlspark_tpu"], rtol=1e-6, atol=1e-6)

    def test_kill_mid_stream_restart_is_exactly_once(self, tmp_path):
        """SIGKILL the port's driver process mid-batch, restart from the
        checkpoint, and the sink's total output is byte-identical to the
        one-shot batch transform — no duplicates, no gaps."""
        pytest.importorskip("pyarrow")
        path = _fit_reference_pipeline(tmp_path)
        port = ns(PORT)
        model = _load(port, path)
        d = str(tmp_path / "in")
        os.makedirs(d)
        out, ck = str(tmp_path / "out"), str(tmp_path / "ck")
        rng = np.random.default_rng(23)
        chunks = []
        for i in range(8):
            chunk = port.Table({"a": rng.normal(size=4), "b": rng.normal(size=4),
                                "label": rng.normal(size=4)})
            chunks.append(chunk)
            port.table_io.write_csv(chunk, os.path.join(d, f"chunk-{i:03d}.csv"))
        driver = os.path.join(str(tmp_path), "driver.py")
        with open(driver, "w") as fh:
            fh.write(
                "import sys, time\n"
                "import mmlspark_tpu_torch.gbdt.estimators  # registers stages\n"
                "import mmlspark_tpu_torch.ops.featurize\n"
                "from mmlspark_tpu_torch.core.pipeline import PipelineStage\n"
                "from mmlspark_tpu_torch.streaming import (DirectorySource,\n"
                "    ParquetSink, StreamingQuery)\n"
                "model_dir, d, out, ck, slow = sys.argv[1:6]\n"
                "model = PipelineStage.load(model_dir)\n"
                "for s in model.get('stages'):\n"
                "    if hasattr(s, 'to'):\n"
                "        s.to('cpu')\n"
                "def transform(t):\n"
                "    o = model.transform(t)\n"
                "    time.sleep(float(slow))\n"   # widen the kill window
                "    return o\n"
                "src = DirectorySource(d, '*.csv', max_files_per_trigger=1)\n"
                "q = StreamingQuery(src, transform, ParquetSink(out),\n"
                "                   checkpoint_dir=ck, device='cpu')\n"
                "q.process_all_available()\n"
                "print('DONE', q.batches_processed, flush=True)\n")
        from tests.conftest import subprocess_env

        env = subprocess_env()
        env["JAX_PLATFORMS"] = "cpu"
        p1 = subprocess.Popen([sys.executable, driver, path, d, out, ck, "0.3"],
                              env=env, stdout=subprocess.PIPE)
        try:
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                parts = ([n for n in os.listdir(out) if n.startswith("part-")]
                         if os.path.isdir(out) else [])
                if len(parts) >= 2 or p1.poll() is not None:
                    break
                time.sleep(0.02)
            assert p1.poll() is None, "driver finished before it was killed"
            p1.send_signal(signal.SIGKILL)
        finally:
            p1.wait(timeout=30)
        p2 = subprocess.run([sys.executable, driver, path, d, out, ck, "0"], env=env,
                            capture_output=True, text=True, timeout=300)
        assert p2.returncode == 0, p2.stderr[-2000:]
        whole = chunks[0]
        for c in chunks[1:]:
            whole = whole.concat(c)
        expected = model.transform(whole)
        got = port.st.ParquetSink(out).table()
        assert got.num_rows == expected.num_rows    # no duplicates, no gaps
        np.testing.assert_array_equal(np.asarray(got["prediction"]),
                                      np.asarray(expected["prediction"]))
        np.testing.assert_array_equal(np.asarray(got["a"]), np.asarray(expected["a"]))
