"""The port's partition-parallel streaming (mmlspark_tpu_torch/streaming:
shuffle, partition, joins, state backends, per-partition checkpoints,
the fleet worker protocol) held against the JAX package's: the mirror of
tests/test_partition.py. Each scenario runs in both packages over the
same seeded batches and the results must be equal byte for byte; the
reference test's invariant (any P is byte-identical to P=1) then holds on
the port's. The slow tier runs the port's fleet workers and driver kill
and compares with the JAX package's P=1 output."""

from __future__ import annotations

import importlib
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tests.test_torch_streaming_common import (  # noqa: E402
    PORT, REF, assert_byte_identical, both, canon, ns)


def _key_for_partition(m, p: int, num_partitions: int, prefix: str = "k") -> str:
    for i in range(1000):
        k = f"{prefix}{i}"
        if m.st.partition_of(k, num_partitions) == p:
            return k
    raise AssertionError("no key found")


def _grouped_batches(m, seed: int = 3, n_batches: int = 5, rows: int = 40,
                     keys: int = 16):
    rng = np.random.default_rng(seed)
    return [m.Table({"k": [f"k{int(i)}" for i in rng.integers(0, keys, rows)],
                     "v": rng.normal(size=rows)})
            for _ in range(n_batches)]


def _drive(q, src, batches) -> None:
    for b in batches:
        src.add_rows(b)
        q.process_all_available()


def _oracle(m, batches, op):
    src, sink = m.st.MemorySource(), m.st.MemorySink()
    q = m.st.StreamingQuery(src, op, sink, **m.dev)
    _drive(q, src, batches)
    q.stop()
    return sink.table()


# --------------------------------------------------------------------------- #
# shuffle primitives


class TestShuffle:
    def test_stable_hash_is_process_stable(self):
        """Routing must not depend on the process: a fresh interpreter
        computes the same digests, and the port's equal the JAX
        package's."""
        from tests.conftest import subprocess_env

        def run(m):
            return [m.st.stable_hash("alpha"), m.st.stable_hash(7), m.st.stable_hash(2.5)]

        local = both(run)
        out = subprocess.run(
            [sys.executable, "-c",
             "from mmlspark_tpu_torch.streaming import stable_hash\n"
             "print(stable_hash('alpha'), stable_hash(7), stable_hash(2.5))"],
            env=subprocess_env(), capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr[-2000:]
        assert [int(x) for x in out.stdout.split()] == local

    def test_split_is_disjoint_and_order_preserving(self):
        def run(m):
            rng = np.random.default_rng(0)
            t = m.Table({"k": [f"k{int(i)}" for i in rng.integers(0, 9, 60)],
                         "v": np.arange(60.0)})
            return [t, m.st.split_by_partition(t, "k", 4)]

        t, parts = both(run)
        port = ns(PORT)
        assert sum(p.num_rows for p in parts) == 60
        for pid, part in enumerate(parts):
            for k in part["k"]:
                assert port.st.partition_of(k, 4) == pid       # disjoint keys
            vs = list(part["v"])
            assert vs == sorted(vs)
        for key in set(t["k"]):
            pid = port.st.partition_of(key, 4)
            got = [v for k, v in zip(parts[pid]["k"], parts[pid]["v"]) if k == key]
            want = [v for k, v in zip(t["k"], t["v"]) if k == key]
            assert got == want

    def test_split_empty_and_p1(self):
        def run(m):
            t = m.Table({"k": ["a"], "v": np.array([1.0])})
            same = m.st.split_by_partition(t, "k", 1) == [t]
            parts = m.st.split_by_partition(m.Table({"k": [], "v": np.zeros(0)}), "k", 3)
            return [same, parts]

        same, parts = both(run)
        assert same and len(parts) == 3
        assert all(p.num_rows == 0 for p in parts)
        assert all("v" in p.columns for p in parts)    # schema survives

    def test_keyed_shuffle_standalone_annotates(self):
        def run(m):
            t = m.Table({"k": ["a", "b", "c"], "v": np.arange(3.0)})
            out = m.st.KeyedShuffle(key_col="k", num_partitions=3).transform(t)
            return [out, [m.st.partition_of(k, 3) for k in ("a", "b", "c")]]

        out, want = both(run)
        assert list(out["partition"]) == want
        assert list(out["k"]) == ["a", "b", "c"]


class TestSplitPipeline:
    def test_marker_splits_pre_and_chain(self):
        def run(m):
            pre = m.st.StreamTableJoin(key_col="k", table_path="x.csv")
            sh = m.st.KeyedShuffle(key_col="k", num_partitions=2)
            agg = m.st.GroupedAggregator(group_col="k")
            p, s, c = m.st.split_pipeline_at_shuffle(m.pipeline.pipeline_model(pre, sh, agg))
            return p == [pre] and s is sh and c == [agg]

        assert both(run) is True

    def test_no_marker_is_all_chain(self):
        def run(m):
            agg = m.st.GroupedAggregator(group_col="k")
            p, s, c = m.st.split_pipeline_at_shuffle(agg)
            return p == [] and s is None and c == [agg]

        assert both(run) is True

    @pytest.mark.parametrize("case", ["two_shuffles", "callable", "stateful_first",
                                      "key_mismatch", "no_key"])
    def test_invalid_pipelines_rejected_alike(self, case):
        def run(m):
            pm = m.pipeline.pipeline_model
            if case == "two_shuffles":
                exc, match = ValueError, "at most one"
                fn = lambda: m.st.split_pipeline_at_shuffle(pm(  # noqa: E731
                    m.st.KeyedShuffle(key_col="k"), m.st.KeyedShuffle(key_col="k")))
            elif case == "callable":
                exc, match = TypeError, "Transformer"
                fn = lambda: m.st.split_pipeline_at_shuffle(lambda t: t)  # noqa: E731
            else:
                if case == "stateful_first":
                    exc, match = ValueError, "AFTER the KeyedShuffle"
                    tr = pm(m.st.GroupedAggregator(group_col="k"),
                            m.st.KeyedShuffle(key_col="k", num_partitions=2))
                elif case == "key_mismatch":
                    exc, match = ValueError, "must match"
                    tr = pm(m.st.KeyedShuffle(key_col="k", num_partitions=2),
                            m.st.GroupedAggregator(group_col="other"))
                else:
                    exc, match = ValueError, "key_col"
                    tr = m.st.GroupedAggregator(group_col="k")
                fn = lambda: m.st.ParallelStreamingQuery(  # noqa: E731
                    m.st.MemorySource(), tr, m.st.MemorySink(), **m.dev)
            with pytest.raises(exc, match=match) as e:
                fn()
            return str(e.value)

        both(run)

    def test_prefix_on_cuda_without_a_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: cuda is not refused here")
        port = ns(PORT)
        pm = port.pipeline.pipeline_model(
            port.st.StreamTableJoin(key_col="k", table_path="x.csv"),
            port.st.KeyedShuffle(key_col="k", num_partitions=2),
            port.st.GroupedAggregator(group_col="k"))
        with pytest.raises(RuntimeError, match="cuda"):
            port.st.ParallelStreamingQuery(port.st.MemorySource(), pm, port.st.MemorySink())


# --------------------------------------------------------------------------- #
# state backends


class TestStateBackends:
    def test_spill_equals_memory(self, tmp_path):
        pytest.importorskip("pyarrow")

        def run(m, d):
            mem = m.st.GroupedAggregator(group_col="k", value_col="v", agg="mean")
            spl = m.st.GroupedAggregator(group_col="k", value_col="v", agg="mean",
                                         state_backend="spill", spill_dir=str(d),
                                         spill_hot_keys=2)
            rng = np.random.default_rng(1)
            outs = []
            for _ in range(4):
                t = m.Table({"k": [f"k{int(i)}" for i in rng.integers(0, 12, 30)],
                             "v": rng.normal(size=30)})
                a, b = mem.transform(t), spl.transform(t)
                assert_byte_identical(a, b)
                outs.append(a)
            return [outs, spl.spilled_bytes > 0, mem.spilled_bytes]

        _outs, spilled, mem_spilled = both(run, tmp_path)
        assert spilled and mem_spilled == 0     # 12 keys, 2 hot: cold file

    def test_spill_state_doc_roundtrip(self, tmp_path):
        pytest.importorskip("pyarrow")

        def run(m, d):
            mk = lambda sub: m.st.GroupedAggregator(  # noqa: E731
                group_col="k", value_col="v", agg="sum", state_backend="spill",
                spill_dir=str(d / sub), spill_hot_keys=1)
            spl = mk("a")
            spl.transform(m.Table({"k": ["a", "b", "c"], "v": np.array([1.0, 2.0, 3.0])}))
            doc = json.loads(json.dumps(spl.state_doc()))
            spl2 = mk("b")
            spl2.load_state_doc(doc)
            nxt = m.Table({"k": ["a"], "v": np.array([10.0])})
            a, b = spl.transform(nxt), spl2.transform(nxt)
            assert_byte_identical(a, b)
            return [doc, a]

        both(run, tmp_path)

    def test_state_doc_is_arrival_order_invariant(self):
        def run(m):
            a = m.st.GroupedAggregator(group_col="k", value_col="v", agg="sum")
            b = m.st.GroupedAggregator(group_col="k", value_col="v", agg="sum")
            a.transform(m.Table({"k": ["x", "y"], "v": np.array([1.0, 2.0])}))
            b.transform(m.Table({"k": ["y", "x"], "v": np.array([2.0, 1.0])}))
            return [json.dumps(a.state_doc()), json.dumps(b.state_doc())]

        a, b = both(run)
        assert a == b

    def test_spilling_backend_faults_cold_keys_back(self, tmp_path):
        pytest.importorskip("pyarrow")

        def run(m, d):
            b = m.st.SpillingStateBackend(str(d), hot_keys=1)
            b.acc("a")[0] += 1
            b.acc("b")[0] += 1
            b.end_batch()                          # evicts "a" to parquet
            out = [b.spilled_bytes > 0, len(b)]
            acc = b.acc("a")                       # fault back
            return out + [b.faults, float(acc[0])]

        assert both(run, tmp_path) == [True, 2, 1, 1.0]


# --------------------------------------------------------------------------- #
# per-partition checkpoint files


class TestPartitionCheckpoints:
    def test_write_read_newest_at_or_before(self, tmp_path):
        def run(m, d):
            log = m.st.CommitLog(str(d))
            log.write_partition_state(0, 0, {"n": 0})
            log.write_partition_state(0, 3, {"n": 3})
            log.write_partition_state(1, 1, {"n": 10})
            out = [log.read_partition_state(0, 5), log.read_partition_state(0, 2),
                   log.read_partition_state(1, 4), log.read_partition_state(2, 5)]
            log.close()
            return out

        assert both(run, tmp_path) == [{"n": 3}, {"n": 0}, {"n": 10}, None]

    def test_prune_keeps_each_partitions_newest(self, tmp_path):
        def run(m, d):
            log = m.st.CommitLog(str(d))
            log.write_partition_state(0, 0, {"n": 0})
            log.write_partition_state(0, 4, {"n": 4})
            log.write_partition_state(1, 1, {"n": 10})    # old but current
            log.prune_state(keep_from=4)
            names = sorted(n for n in os.listdir(str(d)) if n.startswith("state-p"))
            out = [names, log.read_partition_state(1, 4)]
            log.close()
            return out

        names, p1 = both(run, tmp_path)
        assert names == ["state-p0000-000000004.json", "state-p0001-000000001.json"]
        assert p1 == {"n": 10}


# --------------------------------------------------------------------------- #
# streaming joins


class TestStreamStreamJoin:
    def test_pairs_within_window_across_batches(self):
        def run(m):
            j = m.st.StreamStreamJoin(join_window_s=5.0)
            out1 = j.transform(m.Table({
                "key": ["a", "a"], "time": np.array([1.0, 3.0]),
                "side": ["left", "right"], "value": np.array([10.0, 20.0])}))
            out2 = j.transform(m.Table({
                "key": ["a"], "time": np.array([7.0]),
                "side": ["left"], "value": np.array([30.0])}))
            out3 = j.transform(m.Table({
                "key": ["a"], "time": np.array([20.0]),
                "side": ["right"], "value": np.array([40.0])}))
            return [out1, out2, out3]

        out1, out2, out3 = both(run)
        assert list(out1["key"]) == ["a"]
        assert list(out1["left_value"]) == [10.0] and list(out1["right_value"]) == [20.0]
        assert list(out2["left_time"]) == [7.0] and list(out2["right_time"]) == [3.0]
        assert out3.num_rows == 0             # outside every window

    def test_no_match_across_keys(self):
        def run(m):
            j = m.st.StreamStreamJoin(join_window_s=10.0)
            return j.transform(m.Table({
                "key": ["a", "b"], "time": np.array([1.0, 1.0]),
                "side": ["left", "right"], "value": np.array([1.0, 2.0])}))

        assert both(run).num_rows == 0

    def test_watermark_drops_late_and_evicts_buffers(self):
        def run(m):
            j = m.st.StreamStreamJoin(join_window_s=2.0, watermark_delay_s=1.0)
            j.transform(m.Table({"key": ["a"], "time": np.array([100.0]),
                                 "side": ["left"], "value": np.array([1.0])}))
            seen = [j.watermark()]
            out = j.transform(m.Table({"key": ["a"], "time": np.array([50.0]),
                                       "side": ["right"], "value": np.array([2.0])}))
            seen += [out.num_rows, j.late_rows_dropped]
            j.transform(m.Table({"key": ["b"], "time": np.array([200.0]),
                                 "side": ["left"], "value": np.array([3.0])}))
            seen.append(j.buffered_rows)
            j.transform(m.Table({"key": [], "time": np.zeros(0),
                                 "side": [], "value": np.zeros(0)}))
            return seen + [j.buffered_rows]

        # eviction uses the watermark as of batch START: the last batch
        # sees watermark 199, horizon 197, and drops the stale "a"@100
        assert both(run) == [99.0, 0, 1, 2, 1]

    def test_state_doc_roundtrip_continues_identically(self):
        def run(m):
            a = m.st.StreamStreamJoin(join_window_s=5.0)
            a.transform(m.Table({
                "key": ["a", "b"], "time": np.array([1.0, 2.0]),
                "side": ["left", "left"], "value": np.array([1.0, 2.0])}))
            b = m.st.StreamStreamJoin(join_window_s=5.0)
            b.load_state_doc(json.loads(json.dumps(a.state_doc())))
            nxt = m.Table({"key": ["a"], "time": np.array([4.0]),
                           "side": ["right"], "value": np.array([9.0])})
            x, y = a.transform(nxt), b.transform(nxt)
            assert_byte_identical(x, y)
            return x

        assert both(run).num_rows == 1


class TestStreamTableJoin:
    @staticmethod
    def _static(m, d, cols=None, name="dim.csv") -> str:
        path = str(d / name)
        m.table_io.write_csv(m.Table(cols or {"key": ["a", "b"],
                                              "weight": np.array([1.5, 2.5])}), path)
        return path

    def test_left_fills_unmatched(self, tmp_path):
        def run(m, d):
            j = m.st.StreamTableJoin(table_path=self._static(m, d))
            return j.transform(m.Table({"key": ["a", "zz", "b"], "v": np.arange(3.0)}))

        out = both(run, tmp_path)
        assert list(out["key"]) == ["a", "zz", "b"]
        w = np.asarray(out["weight"])
        assert w[0] == 1.5 and np.isnan(w[1]) and w[2] == 2.5

    def test_inner_drops_unmatched(self, tmp_path):
        def run(m, d):
            j = m.st.StreamTableJoin(table_path=self._static(m, d), how="inner")
            return j.transform(m.Table({"key": ["zz", "a"], "v": np.arange(2.0)}))

        out = both(run, tmp_path)
        assert list(out["key"]) == ["a"] and list(out["v"]) == [1.0]

    def test_duplicate_static_key_rejected(self, tmp_path):
        def run(m, d):
            path = self._static(m, d, {"key": ["a", "a"], "w": np.zeros(2)}, "dup.csv")
            j = m.st.StreamTableJoin(table_path=path)
            with pytest.raises(ValueError, match="duplicate") as e:
                j.transform(m.Table({"key": ["a"]}))
            return str(e.value).replace(path, "<path>")

        both(run, tmp_path)

    def test_colliding_column_prefixed(self, tmp_path):
        def run(m, d):
            path = self._static(m, d, {"key": ["a"], "v": np.array([9.0])})
            return m.st.StreamTableJoin(table_path=path).transform(
                m.Table({"key": ["a"], "v": np.array([1.0])}))

        out = both(run, tmp_path)
        assert list(out["v"]) == [1.0] and list(out["right_v"]) == [9.0]


# --------------------------------------------------------------------------- #
# the parallel query, thread mode: byte identity with P=1


def _parallel(m, P: int, stage, src, sink, **kw):
    pm = m.pipeline.pipeline_model(
        m.st.KeyedShuffle(key_col=stage.partition_key_col(), num_partitions=P), stage)
    return m.st.ParallelStreamingQuery(src, pm, sink, workers="thread", **m.dev, **kw)


class TestParallelThreadMode:
    @pytest.mark.parametrize("P", [2, 4])
    def test_grouped_matches_p1(self, P):
        def run(m):
            batches = _grouped_batches(m)
            mk = lambda: m.st.GroupedAggregator(  # noqa: E731
                group_col="k", value_col="v", agg="sum")
            oracle = _oracle(m, batches, mk())
            src, sink = m.st.MemorySource(), m.st.MemorySink()
            q = _parallel(m, P, mk(), src, sink)
            _drive(q, src, batches)
            q.stop()
            assert_byte_identical(sink.table(), oracle)
            return [sink.table(), q.last_progress["num_partitions"],
                    q.last_progress["workers"]]

        _t, n, workers = both(run)
        assert n == P and workers == "thread"

    def test_join_matches_p1_at_p4_with_late_rows(self):
        def run(m):
            rng = np.random.default_rng(7)
            batches = []
            t = 0.0
            for _ in range(6):
                n = 24
                times = t + rng.uniform(0, 8, n)
                times[0] = max(0.0, t - 30.0)      # a late straggler
                batches.append(m.Table({
                    "key": [f"k{int(i)}" for i in rng.integers(0, 6, n)],
                    "time": times,
                    "side": [["left", "right"][int(s)] for s in rng.integers(0, 2, n)],
                    "value": rng.normal(size=n)}))
                t += 8.0
            mk = lambda: m.st.StreamStreamJoin(join_window_s=4.0,  # noqa: E731
                                               watermark_delay_s=5.0)
            oracle = _oracle(m, batches, mk())
            src, sink = m.st.MemorySource(), m.st.MemorySink()
            q = _parallel(m, 4, mk(), src, sink)
            _drive(q, src, batches)
            q.stop()
            assert_byte_identical(sink.table(), oracle)
            return sink.table()

        assert both(run).num_rows > 0

    def test_windowed_emission_needs_global_time_hints(self):
        """One partition's slice carries the max event time; the OTHER
        partition's window must still finalize."""
        def run(m):
            ka, kb = _key_for_partition(m, 0, 2), _key_for_partition(m, 1, 2)
            batches = [
                m.Table({"g": [ka, kb], "t": np.array([5.0, 6.0]), "v": np.array([1.0, 2.0])}),
                m.Table({"g": [kb], "t": np.array([25.0]), "v": np.array([3.0])}),
            ]
            mk = lambda: m.st.WindowedAggregator(  # noqa: E731
                time_col="t", window_s=10.0, group_col="g", value_col="v",
                agg="sum", watermark_delay_s=0.0)
            oracle = _oracle(m, batches, mk())
            assert ka in list(oracle["g"]) and kb in list(oracle["g"])
            src, sink = m.st.MemorySource(), m.st.MemorySink()
            q = m.st.ParallelStreamingQuery(
                src, m.pipeline.pipeline_model(
                    m.st.KeyedShuffle(key_col="g", num_partitions=2), mk()),
                sink, workers="thread", **m.dev)
            _drive(q, src, batches)
            q.stop()
            assert_byte_identical(sink.table(), oracle)
            return sink.table()

        both(run)

    def test_stateless_chain_restores_source_order(self, tmp_path):
        def run(m, d):
            path = str(d / "dim.csv")
            m.table_io.write_csv(m.Table({"key": ["a", "b", "c"],
                                          "weight": np.array([1.0, 2.0, 3.0])}), path)
            rng = np.random.default_rng(5)
            batches = [m.Table({"key": [str(c) for c in rng.choice(list("abcdz"), 20)],
                                "v": rng.normal(size=20)}) for _ in range(3)]
            oracle = _oracle(m, batches, m.st.StreamTableJoin(table_path=path))
            src, sink = m.st.MemorySource(), m.st.MemorySink()
            q = m.st.ParallelStreamingQuery(
                src, m.pipeline.pipeline_model(
                    m.st.KeyedShuffle(key_col="key", num_partitions=3),
                    m.st.StreamTableJoin(table_path=path)),
                sink, workers="thread", **m.dev)
            _drive(q, src, batches)
            q.stop()
            # row ORDER matters: the hidden row tag restores source order
            assert_byte_identical(sink.table(), oracle)
            return sink.table()

        both(run, tmp_path)

    def test_incremental_checkpoints_and_prune(self, tmp_path):
        def run(m, d):
            ka, kb = _key_for_partition(m, 0, 2), _key_for_partition(m, 1, 2)
            src, sink = m.st.MemorySource(), m.st.MemorySink()
            q = m.st.ParallelStreamingQuery(
                src, m.pipeline.pipeline_model(
                    m.st.KeyedShuffle(key_col="k", num_partitions=2),
                    m.st.GroupedAggregator(group_col="k", agg="count")),
                sink, workers="thread", checkpoint_dir=str(d), **m.dev)
            src.add_rows(m.Table({"k": [ka, kb]}))
            q.process_all_available()
            written = [q.last_progress["partition_states_written"]]
            src.add_rows(m.Table({"k": [ka]}))      # partition 1 untouched
            q.process_all_available()
            written.append(q.last_progress["partition_states_written"])
            q.stop()
            names = sorted(n for n in os.listdir(str(d)) if n.startswith("state-p"))
            states = []
            for n in names:
                with open(os.path.join(str(d), n), "rb") as fh:
                    states.append(fh.read())
            return [written, names, states]

        written, names, _states = both(run, tmp_path)
        assert written == [2, 1]
        assert names == ["state-p0000-000000001.json", "state-p0001-000000000.json"]

    def test_restart_recovery_matches_p1_restart(self, tmp_path):
        def run_pkg(m, d):
            inp = str(d / "in")
            os.makedirs(inp)
            rng = np.random.default_rng(9)

            def add_file(i):
                m.table_io.write_csv(
                    m.Table({"k": [f"k{int(x)}" for x in rng.integers(0, 8, 10)],
                             "v": rng.normal(size=10)}),
                    os.path.join(inp, f"f-{i:03d}.csv"))

            def run(ck, sink, parallel):
                agg = m.st.GroupedAggregator(group_col="k", value_col="v", agg="mean")
                src = m.st.DirectorySource(inp, "*.csv", max_files_per_trigger=1)
                if parallel:
                    q = m.st.ParallelStreamingQuery(
                        src, m.pipeline.pipeline_model(
                            m.st.KeyedShuffle(key_col="k", num_partitions=2), agg),
                        sink, workers="thread", checkpoint_dir=ck, **m.dev)
                else:
                    q = m.st.StreamingQuery(src, agg, sink, checkpoint_dir=ck, **m.dev)
                q.process_all_available()
                q.stop()

            for i in range(2):
                add_file(i)
            ck1, ck2 = str(d / "ck1"), str(d / "ck2")
            s1a, s2a = m.st.MemorySink(), m.st.MemorySink()
            run(ck1, s1a, parallel=False)
            run(ck2, s2a, parallel=True)
            for i in range(2, 4):
                add_file(i)
            s1b, s2b = m.st.MemorySink(), m.st.MemorySink()
            run(ck1, s1b, parallel=False)
            run(ck2, s2b, parallel=True)
            assert_byte_identical(s2a.table(), s1a.table())
            assert_byte_identical(s2b.table(), s1b.table())
            return [s2a.table(), s2b.table()]

        both(run_pkg, tmp_path)

    def test_sink_failure_rolls_back_every_partition(self, tmp_path):
        def run(m, d):
            class FlakySink(m.st.MemorySink):
                def __init__(self):
                    super().__init__()
                    self.failures_left = 1

                def add_batch(self, batch_id, table):
                    if self.failures_left > 0:
                        self.failures_left -= 1
                        raise OSError("sink hiccup")
                    super().add_batch(batch_id, table)

            src, sink = m.st.MemorySource(), FlakySink()
            q = m.st.ParallelStreamingQuery(
                src, m.pipeline.pipeline_model(
                    m.st.KeyedShuffle(key_col="k", num_partitions=2),
                    m.st.GroupedAggregator(group_col="k", agg="count")),
                sink, workers="thread", checkpoint_dir=str(d), **m.dev)
            src.add_rows(m.Table({"k": ["a", "a", "b"]}))
            with pytest.raises(OSError):
                q.process_next()
            retried = q.process_next()               # retry of the same plan
            q.stop()
            return [retried, sink.table()]

        retried, out = both(run, tmp_path)
        assert retried
        assert dict(zip(out["k"], out["aggregate"])) == {"a": 2.0, "b": 1.0}

    def test_fused_prefix_runs_before_the_shuffle(self):
        """The port fuses the pre-shuffle stages on `device` (the CPU here):
        a device-capable prefix (CleanMissingData over a float32 column)
        runs as one fused segment on the driver and the P=2 output is the
        JAX package's bytes and its own P=1 run's."""
        def run(m):
            missing = importlib.import_module(f"{m.name}.ops.missing")
            rng = np.random.default_rng(4)
            batches = []
            for _ in range(3):
                v = rng.normal(size=30).astype(np.float32)
                v[rng.integers(0, 30, 5)] = np.nan
                batches.append(m.Table({"k": [f"k{int(i)}" for i in rng.integers(0, 8, 30)],
                                        "v": v}))
            clean = missing.CleanMissingData(input_cols=["v"], output_cols=["v"],
                                             cleaning_mode="Mean").fit(batches[0])
            mk = lambda: m.st.GroupedAggregator(  # noqa: E731
                group_col="k", value_col="v", agg="sum")
            outs = []
            for P in (1, 2):
                src, sink = m.st.MemorySource(), m.st.MemorySink()
                q = m.st.ParallelStreamingQuery(
                    src, m.pipeline.pipeline_model(
                        clean, m.st.KeyedShuffle(key_col="k", num_partitions=P), mk()),
                    sink, workers="thread", **m.dev)
                if m.is_port:
                    assert isinstance(q._pre, m.fusion.FusedPipelineModel)
                    assert q._pre.plan().n_fused_stages == 1
                _drive(q, src, batches)
                q.stop()
                outs.append(sink.table())
            assert_byte_identical(outs[0], outs[1])
            return outs[1]

        both(run)


# --------------------------------------------------------------------------- #
# the fleet worker protocol (in-process, no processes)


def _call(m, handler, body: dict):
    out = handler(m.Table({"request": [m.http_schema.HTTPRequestData.from_json("/", body)]}))
    resp = out["reply"][0]
    return resp.status_code, json.loads(resp.entity)


def _worker(m, op=None):
    blob = m.serialize.stage_to_blob(m.pipeline.pipeline_model(
        op or m.st.GroupedAggregator(group_col="k", agg="count")))
    return m.st.PartitionWorkerFactory(blob, "q")()


def _apply_body(m, p, bid, keys):
    return {"op": "apply", "partition": p, "batch_id": bid,
            "rows": m.partition_mod._encode_rows(m.Table({"k": keys})), "hints": {}}


class TestPartitionWorkerProtocol:
    def test_apply_fold_and_idempotent_replay(self):
        def run(m):
            h = _worker(m)
            first = _call(m, h, _apply_body(m, 0, 0, ["a", "a", "b"]))
            # a re-sent apply for the SAME batch returns the cached reply
            again = _call(m, h, _apply_body(m, 0, 0, ["a", "a", "b"]))
            first[1].pop("seconds")
            again[1].pop("seconds")
            return [first, again]

        (code, doc), again = both(run)
        assert code == 200 and again == (200, doc)
        assert doc["rows"]["columns"]["aggregate"]["values"] == [2.0, 1.0]

    def test_fresh_partition_past_bid0_needs_state(self):
        def run(m):
            h = _worker(m)
            out = [_call(m, h, _apply_body(m, 1, 5, ["a"]))]
            out.append(_call(m, h, {"op": "load_state", "partition": 1, "batch_id": 4,
                                    "state": {"ops": [{"groups": {"a": [3, 3.0, 1.0, 1.0]}}]}}))
            code, doc = _call(m, h, _apply_body(m, 1, 5, ["a"]))
            doc.pop("seconds")
            return out + [(code, doc)]

        need, loaded, (code, doc) = both(run)
        assert need[0] == 200 and need[1].get("need_state")
        assert loaded == (200, {"ok": True})
        assert code == 200 and doc["rows"]["columns"]["aggregate"]["values"] == [4.0]

    def test_gap_in_batch_ids_needs_state(self):
        def run(m):
            h = _worker(m)
            _call(m, h, _apply_body(m, 0, 0, ["a"]))
            return _call(m, h, _apply_body(m, 0, 2, ["a"]))   # skipped bid 1

        code, doc = both(run)
        assert code == 200 and doc.get("need_state") and doc["have"] == 0

    def test_status_and_unknown_op(self):
        def run(m):
            h = _worker(m)
            _call(m, h, _apply_body(m, 0, 0, ["a"]))
            return [_call(m, h, {"op": "status"}), _call(m, h, {"op": "bogus"})]

        (code, doc), (bad_code, bad_doc) = both(run)
        assert code == 200 and doc["partitions"] == [0] and doc["last"] == {"0": 0}
        assert bad_code == 500 and "error" in bad_doc

    def test_workers_answer_each_others_drivers(self):
        """The protocol is one protocol: the port's worker folds a JSON
        apply the JAX package encoded, and the JAX package decodes the
        port's reply to the same table."""
        ref, port = ns(REF), ns(PORT)
        body = _apply_body(ref, 0, 0, ["a", "b", "a"])
        code, doc = _call(port, _worker(port), body)
        rcode, rdoc = _call(ref, _worker(ref), body)
        assert code == rcode == 200
        assert canon(ref.partition_mod._decode_rows(doc["rows"])) == canon(
            ref.partition_mod._decode_rows(rdoc["rows"]))


class TestBinaryWireProtocol:
    """The binary row codec (io_http/wire.py) in the fleet apply op: same
    fold, same reply fields, and the output table is byte-identical to the
    JSON columnar encoding's — in both packages."""

    @staticmethod
    def _table(m, seed=7):
        rng = np.random.default_rng(seed)
        keys = np.array(list("abcd"))[rng.integers(0, 4, 32)]
        return m.Table({"k": keys.tolist(), "v": rng.normal(size=32)})

    @staticmethod
    def _binary_apply(m, handler, table, p=0, bid=0):
        ent = m.wire.encode_message(
            {"op": "apply", "partition": p, "batch_id": bid, "hints": {}},
            {c: table[c] for c in table.columns}, n_rows=table.num_rows)
        req = m.http_schema.HTTPRequestData(
            "POST", "/", {"Content-Type": m.wire.WIRE_CONTENT_TYPE}, ent)
        return handler(m.Table({"request": [req]}))["reply"][0]

    def _sum_worker(self, m):
        return _worker(m, m.st.GroupedAggregator(group_col="k", value_col="v", agg="sum"))

    def test_binary_apply_byte_identical_to_json(self):
        def run(m):
            table = self._table(m)
            code, doc = _call(m, self._sum_worker(m), {
                "op": "apply", "partition": 0, "batch_id": 0,
                "rows": m.partition_mod._encode_rows(table), "hints": {}})
            assert code == 200
            json_out = m.partition_mod._decode_rows(doc["rows"])
            resp = self._binary_apply(m, self._sum_worker(m), table)
            assert resp.status_code == 200
            assert m.wire.is_wire_content_type(m.wire.content_type_of(resp.headers))
            meta, cols = m.wire.decode_message(resp.entity)
            assert meta["state"] == doc["state"] and meta["watermark"] == doc["watermark"]
            assert sorted(cols) == sorted(json_out.columns)
            for c in json_out.columns:
                a, b = np.asarray(json_out[c]), np.asarray(cols[c])
                assert a.dtype == b.dtype and a.shape == b.shape, c
                assert a.tobytes() == b.tobytes(), c
            return [json_out, meta["state"]]

        both(run)

    def test_binary_replay_idempotent_and_need_state_stays_json(self):
        def run(m):
            h = self._sum_worker(m)
            table = self._table(m)
            r1 = self._binary_apply(m, h, table, bid=0)
            r2 = self._binary_apply(m, h, table, bid=0)    # replay: cached fold
            r3 = self._binary_apply(m, h, table, bid=5)
            return [r1.entity == r2.entity,
                    m.wire.is_wire_content_type(m.wire.content_type_of(r3.headers)),
                    json.loads(r3.entity)]

        same, framed, doc = both(run)
        assert same and not framed and doc.get("need_state")


# --------------------------------------------------------------------------- #
# PartitionSupervisor over the port's fleet shape (stub fleet)


class _StubFleet:
    def __init__(self):
        self.dead: list[int] = []
        self.respawned: list[int] = []

    def dead_slots(self):
        return list(self.dead)

    def respawn(self, slot):
        self.dead.remove(slot)
        self.respawned.append(slot)
        return f"http://respawned-{slot}/"


class TestPartitionSupervisor:
    def test_respawns_dead_slots(self):
        from mmlspark_tpu_torch.resilience import PartitionSupervisor

        fleet = _StubFleet()
        sup = PartitionSupervisor(fleet, poll_interval_s=0.01).start()
        try:
            fleet.dead.append(1)
            deadline = time.monotonic() + 5
            while not fleet.respawned and time.monotonic() < deadline:
                time.sleep(0.01)
            assert fleet.respawned == [1] and fleet.dead == []
            assert sup.respawns == 1 and sup.state == "running"
        finally:
            sup.stop()
        assert sup.state == "stopped"

    def test_escalates_when_budget_runs_dry(self):
        from mmlspark_tpu_torch.resilience import PartitionSupervisor, RestartPolicy

        fleet = _StubFleet()
        failures = []
        sup = PartitionSupervisor(
            fleet, RestartPolicy(max_restarts=1, window_s=300.0), poll_interval_s=0.01,
            on_failure=lambda f, slot: failures.append(slot)).start()
        try:
            fleet.dead.append(0)
            deadline = time.monotonic() + 5
            while not fleet.respawned and time.monotonic() < deadline:
                time.sleep(0.01)
            fleet.dead.append(0)              # second death inside window
            deadline = time.monotonic() + 5
            while sup.state != "failed" and time.monotonic() < deadline:
                time.sleep(0.01)
            assert sup.state == "failed" and failures == [0] and fleet.respawned == [0]
        finally:
            sup.stop()

    def test_query_supervisor_restarts_a_streaming_query(self):
        """QuerySupervisor (port resilience/supervisor.py) supervises the
        port's StreamingQuery: a query whose retry budget runs dry on a
        failing sink terminates, the supervisor restarts it, and the replayed
        batch lands once — as under the JAX package's supervisor."""
        def run(m):
            sup_mod = importlib.import_module(f"{m.name}.resilience.supervisor")
            policy = importlib.import_module(f"{m.name}.resilience.policy")
            src = m.st.MemorySource()
            src.add_rows(m.Table({"x": np.arange(4.0)}))

            class FailOnce(m.st.MemorySink):
                failures_left = 1

                def add_batch(self, bid, table):
                    if self.failures_left:
                        self.failures_left -= 1
                        raise OSError("sink is down")
                    super().add_batch(bid, table)

            sink = FailOnce()
            q = m.st.StreamingQuery(
                src, None, sink, trigger_interval_s=0.01, **m.dev,
                batch_retry_policy=policy.RetryPolicy(max_retries=0, base_ms=1.0, seed=0))
            sup = sup_mod.QuerySupervisor(
                q, sup_mod.RestartPolicy(max_restarts=3, window_s=60.0,
                                         backoff=policy.RetryPolicy(max_retries=3, base_ms=1.0,
                                                                    seed=0)),
                poll_interval_s=0.01).start()
            try:
                deadline = time.monotonic() + 10
                while not sink.batch_ids() and time.monotonic() < deadline:
                    time.sleep(0.01)
            finally:
                sup.stop()
            return [sup.restarts, sink.table(), sink.batch_ids()]

        restarts, table, ids = both(run)
        assert restarts == 1 and ids == [0]
        assert list(table["x"]) == [0.0, 1.0, 2.0, 3.0]


# --------------------------------------------------------------------------- #
# slow tier: the port's fleet worker processes + kill/restart byte identity


def _ref_expected(batches_seed, n_batches, rows, keys):
    ref = ns(REF)
    return _oracle(ref, _grouped_batches(ref, seed=batches_seed, n_batches=n_batches,
                                         rows=rows, keys=keys),
                   ref.st.GroupedAggregator(group_col="k", value_col="v", agg="sum"))


def _fleet_query(port, P, tmp_path, **kw):
    src, sink = port.st.MemorySource(), port.st.MemorySink()
    q = port.st.ParallelStreamingQuery(
        src, port.pipeline.pipeline_model(
            port.st.KeyedShuffle(key_col="k", num_partitions=P),
            port.st.GroupedAggregator(group_col="k", value_col="v", agg="sum")),
        sink, workers="fleet", checkpoint_dir=str(tmp_path / "ck"), device="cpu", **kw)
    return q, src, sink


@pytest.mark.slow
class TestFleetMode:
    def test_fleet_matches_p1_and_survives_worker_kill(self, tmp_path):
        """P=2 fleet workers, both killed while a batch streams: the driver
        heals and the output equals the JAX package's P=1 run byte for
        byte."""
        port = ns(PORT)
        batches = _grouped_batches(port, seed=21, n_batches=6, rows=400, keys=24)
        expected = _ref_expected(21, 6, 400, 24)
        q, src, sink = _fleet_query(port, 2, tmp_path)
        try:
            _drive(q, src, batches[:2])
            assert q._fleet is not None and q._fleet.n_live == 2

            def _kill_all():
                for slot in range(2):
                    try:
                        q._fleet.kill(slot)
                    except Exception:  # noqa: BLE001 — already dead
                        pass

            src.add_rows(batches[2])
            killer = threading.Timer(0.05, _kill_all)
            killer.start()
            q.process_all_available()
            killer.join()
            _drive(q, src, batches[3:])
            assert q._fleet.dead_slots() == []     # healed
        finally:
            q.stop()
        assert_byte_identical(sink.table(), expected)

    def test_binary_wire_fleet_run_byte_identical(self, tmp_path):
        port = ns(PORT)
        batches = _grouped_batches(port, seed=11, n_batches=4, rows=200, keys=16)
        expected = _ref_expected(11, 4, 200, 16)
        q, src, sink = _fleet_query(port, 2, tmp_path, binary_wire=True)
        try:
            _drive(q, src, batches)
        finally:
            q.stop()
        assert_byte_identical(sink.table(), expected)

    def test_chaos_soak_repeated_kills_under_supervision(self, tmp_path):
        from mmlspark_tpu_torch.resilience import PartitionSupervisor, RestartPolicy

        port = ns(PORT)
        batches = _grouped_batches(port, seed=33, n_batches=9, rows=60, keys=32)
        expected = _ref_expected(33, 9, 60, 32)
        q, src, sink = _fleet_query(port, 4, tmp_path, num_workers=2)
        sup = None
        kills = 0
        try:
            for i, b in enumerate(batches):
                src.add_rows(b)
                q.process_all_available()
                if sup is None:
                    sup = PartitionSupervisor(
                        q._fleet, RestartPolicy(max_restarts=100, window_s=300.0),
                        poll_interval_s=0.05).start()
                if i in (2, 5, 7):
                    q._fleet.kill(i % 2)
                    kills += 1
            deadline = time.monotonic() + 30
            while q._fleet.dead_slots() and time.monotonic() < deadline:
                time.sleep(0.05)
            assert q._fleet.dead_slots() == []
        finally:
            if sup is not None:
                sup.stop()
            q.stop()
        assert kills == 3
        assert_byte_identical(sink.table(), expected)


_DRIVER = """\
import sys, time
from mmlspark_tpu_torch.core.pipeline import Transformer, pipeline_model
from mmlspark_tpu_torch.streaming import (DirectorySource, GroupedAggregator,
    KeyedShuffle, ParallelStreamingQuery, ParquetSink)

d, out, ck, slow = sys.argv[1:5]

class SlowDown(Transformer):          # driver-side: widens the kill window
    def _transform(self, t):
        time.sleep(float(slow))
        return t

pm = pipeline_model(
    SlowDown(),
    KeyedShuffle(key_col="k", num_partitions=4),
    GroupedAggregator(group_col="k", value_col="v", agg="sum"))
src = DirectorySource(d, "*.csv", max_files_per_trigger=1)
q = ParallelStreamingQuery(src, pm, ParquetSink(out), checkpoint_dir=ck,
                           workers="thread", device="cpu")
q.process_all_available()
q.stop()
print("DONE", q.batches_processed, flush=True)
"""


@pytest.mark.slow
class TestDriverKillAtP4:
    def test_sigkill_mid_stream_byte_identical_to_p1(self, tmp_path):
        """SIGKILL the port's P=4 driver mid-batch, restart from the
        checkpoint: the parquet output equals the JAX package's P=1 no-kill
        run byte for byte."""
        pytest.importorskip("pyarrow")
        from tests.conftest import subprocess_env

        port, ref = ns(PORT), ns(REF)
        d = str(tmp_path / "in")
        os.makedirs(d)
        rng = np.random.default_rng(41)
        for i in range(6):
            port.table_io.write_csv(
                port.Table({"k": [f"k{int(x)}" for x in rng.integers(0, 10, 20)],
                            "v": rng.normal(size=20)}),
                os.path.join(d, f"f-{i:03d}.csv"))
        driver = os.path.join(str(tmp_path), "driver.py")
        with open(driver, "w") as fh:
            fh.write(_DRIVER)
        out, ck = str(tmp_path / "out"), str(tmp_path / "ck")
        env = subprocess_env()
        env["JAX_PLATFORMS"] = "cpu"
        p1 = subprocess.Popen([sys.executable, driver, d, out, ck, "0.3"],
                              env=env, stdout=subprocess.PIPE)
        try:
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                parts = ([n for n in os.listdir(out) if n.startswith("part-")]
                         if os.path.isdir(out) else [])
                if len(parts) >= 2 or p1.poll() is not None:
                    break
                time.sleep(0.02)
            assert p1.poll() is None, "driver finished before the kill"
            p1.send_signal(signal.SIGKILL)
        finally:
            p1.wait(timeout=30)
        p2 = subprocess.run([sys.executable, driver, d, out, ck, "0"], env=env,
                            capture_output=True, text=True, timeout=300)
        assert p2.returncode == 0, p2.stderr[-2000:]
        assert "DONE" in p2.stdout
        oracle_sink = ref.st.ParquetSink(str(tmp_path / "oracle"))
        q = ref.st.StreamingQuery(
            ref.st.DirectorySource(d, "*.csv", max_files_per_trigger=1),
            ref.st.GroupedAggregator(group_col="k", value_col="v", agg="sum"),
            oracle_sink, checkpoint_dir=str(tmp_path / "ock"))
        assert q.process_all_available() == 6
        q.stop()
        assert_byte_identical(port.st.ParquetSink(out).table(), oracle_sink.table())
