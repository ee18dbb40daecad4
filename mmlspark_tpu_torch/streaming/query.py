"""StreamingQuery: the micro-batch driver loop.

Reference: Spark's `StreamingQuery` / `MicroBatchExecution` — the loop
that ties a Source, the query plan, and a Sink together: plan the next
batch's offset range into the WAL, materialize it, run the plan, hand it
to the sink keyed by batch id, then record the commit. The reference
rides this engine for everything ("deploy any streaming query as a web
service", docs/mmlspark-serving.md); here the engine itself is ~300
lines because the "query plan" is just a core.pipeline Transformer.

The perf story is capture-once/stream-forever: the SAME Transformer
instance scores every micro-batch, so a PipelineModel transform is fused
(core/fusion.py) on `device` ("cuda" by default, as every entry point of
the port; "cpu" runs the composition eagerly): each fused segment
captures one CUDA graph per padded batch shape on batch 0 and every later
batch of that shape replays it — streaming throughput equals
batch-transform throughput once warm.

A copy of mmlspark_tpu/streaming/query.py with that `device`; asking for
"cuda" without a card raises when the query is built.

Under a `mesh` of several ranks (one process a rank) every rank builds
the query. Shard 0 alone plans each batch into the WAL, reads the source,
runs the transform, writes the sink and commits; each fused run of its
transform is led (core/fusion.py `_MeshLead`): the micro-batch's upload
columns go to every rank, and every rank scores its block of the rows.
The other ranks only follow those runs — `process_all_available()` or
`start()` there run the follow loop until shard 0's `stop()` — and open
no commit log, read no source and write no sink.

Exactly-once recovery (see checkpoint.py for the WAL format): on
restart, state snapshots restore stateful operators to the last
committed batch, the planned-but-uncommitted batch replays against its
RECORDED offset range, and idempotent sinks drop what a pre-crash
attempt already wrote. The kill-and-restart test in
tests/test_streaming.py asserts the end state is byte-identical to a
one-shot batch transform.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

from ..core.dataplane import Lookahead
from ..core.schema import Table
from ..observability.sanitizer import make_rlock
from ..observability.metrics import get_registry
from ..observability.tracing import get_tracer
from ..resilience.policy import RetryPolicy, is_fatal_exception
from .checkpoint import CommitLog
from .sinks import MemorySink, Sink
from .sources import Source
from .state import StatefulOperator

__all__ = ["StreamingQuery"]


def _walk_stages(stage: Any) -> list:
    """Flatten a Transformer / PipelineModel tree into its leaf stages
    (Pipeline-ish stages expose a `stages` param holding children)."""
    out = []
    children = None
    if hasattr(stage, "get"):
        try:
            children = stage.get("stages")
        except (KeyError, AttributeError):
            children = None
    if children:
        for child in children:
            out.extend(_walk_stages(child))
    else:
        out.append(stage)
    return out


class StreamingQuery:
    """Drives source -> transform -> sink micro-batches.

    `transform` may be any core.pipeline Transformer/PipelineModel (its
    stateful operators are auto-discovered and checkpointed), a plain
    callable Table -> Table, or None (pass-through). With a
    `checkpoint_dir` the query is restartable with exactly-once output
    (given a replayable source and an idempotent sink); without one it is
    a best-effort in-memory stream.
    """

    def __init__(self, source: Source, transform: Any = None,
                 sink: "Sink | None" = None, *,
                 checkpoint_dir: "str | None" = None,
                 trigger_interval_s: float = 0.1,
                 compact_every: int = 100,
                 batch_retry_policy: "RetryPolicy | None" = None,
                 source_lookahead: int = 1,
                 name: str = "query",
                 metrics: Any = None,
                 tracer: Any = None,
                 fuse_pipeline: bool = True,
                 mesh: Any = None,
                 device: str = "cuda") -> None:
        self.source = source
        self.device = device
        # PipelineModel transforms score through the whole-pipeline fusion
        # path (core/fusion.py): adjacent device-capable stages run as one
        # composition per micro-batch on `device`. FusedPipelineModel still
        # exposes the `stages` param, so stateful-operator discovery below
        # walks the same leaves either way. A given FusedPipelineModel
        # keeps its own `device`.
        if fuse_pipeline and transform is not None:
            from ..core.fusion import FusedPipelineModel
            from ..core.pipeline import PipelineModel

            if (isinstance(transform, PipelineModel)
                    and not isinstance(transform, FusedPipelineModel)):
                from ..core.fusion import fuse
                from ..core.kernels import resolve_device

                resolve_device(device)
                transform = fuse(transform, mesh=mesh, device=device)
            elif mesh is not None and isinstance(transform,
                                                 FusedPipelineModel):
                transform.set_mesh(mesh)
        self.transform = transform
        # a fused transform under a mesh of several ranks: shard 0 leads
        # its runs, every other rank only follows them
        from ..core.fusion import _on_mesh

        self._led = _on_mesh(transform)
        self.following = (self._led is not None
                          and self._led._effective_mesh().shard_index != 0)
        if self.following:
            checkpoint_dir = None
        self.sink = sink if sink is not None else MemorySink()
        self.name = name
        self.trigger_interval_s = trigger_interval_s
        self.compact_every = compact_every
        # finite per-failure-streak retry budget (was: retry forever on a
        # fixed interval); when it runs dry the query TERMINATES with
        # `exception` set so a resilience.QuerySupervisor can decide
        # whether to restart it
        self.batch_retry_policy = (
            batch_retry_policy if batch_retry_policy is not None
            else RetryPolicy(max_retries=3, base_ms=1e3 * trigger_interval_s,
                             max_ms=30_000.0, seed=0))
        # plain callables aren't walked — a closure owns its own state
        self._ops: list[StatefulOperator] = (
            [s for s in _walk_stages(transform)
             if isinstance(s, StatefulOperator)]
            if hasattr(transform, "transform") else [])
        # Async data plane: read ahead on the SOURCE only — batch N+1's
        # get_offset/get_batch overlap batch N's transform + sink write.
        # Planning and commit stay strictly ordered in process_next, so
        # exactly-once and kill-restart replay are untouched; a stale or
        # failed lookahead is discarded and the source re-read in line.
        # Single-slot (values > 1 behave as 1).
        self._lookahead = (Lookahead(name=f"source-{name}")
                           if source_lookahead > 0 else None)
        self._log = CommitLog(checkpoint_dir) if checkpoint_dir else None
        # blocking_ok: this is the one-batch-at-a-time pipeline mutex —
        # its holder performs the WAL plan/commit and sink write (all
        # I/O) by design; it still participates in lock-order checking
        self._lock = make_rlock("StreamingQuery._lock", blocking_ok=True)
        self._stop = threading.Event()
        self._closed = False
        self._failed = False
        self._thread: "threading.Thread | None" = None
        self._exception: "BaseException | None" = None
        self._last_end: "dict | None" = None
        self._next_id = 0
        self.batches_processed = 0
        self.rows_processed = 0
        self.last_progress: dict = {}
        # telemetry: every series labeled by query name; a restarted query
        # (new object, same name) keeps accumulating the same children
        self.tracer = tracer
        reg = metrics if metrics is not None else get_registry()
        self.metrics = reg
        lbl = {"query": name}
        self._m_batches = reg.counter(
            "mmlspark_tpu_streaming_batches_total",
            "micro-batches committed", labels=("query",)).labels(**lbl)
        self._m_rows = reg.counter(
            "mmlspark_tpu_streaming_rows_total",
            "rows through committed micro-batches",
            labels=("query",)).labels(**lbl)
        self._m_batch_seconds = reg.histogram(
            "mmlspark_tpu_streaming_batch_seconds",
            "micro-batch wall time, source read to sink write",
            labels=("query",)).labels(**lbl)
        self._m_wal_plan = reg.histogram(
            "mmlspark_tpu_streaming_wal_plan_seconds",
            "WAL plan-record write time", labels=("query",)).labels(**lbl)
        self._m_wal_commit = reg.histogram(
            "mmlspark_tpu_streaming_wal_commit_seconds",
            "WAL commit-record write time", labels=("query",)).labels(**lbl)
        self._m_lookahead = reg.gauge(
            "mmlspark_tpu_streaming_lookahead_hit_ratio",
            "fraction of source reads served by the lookahead",
            labels=("query",)).labels(**lbl)
        if self._log is not None:
            self._recover()
        if self._led is not None and not self.following:
            self._led._open_lead()

    # -- recovery --------------------------------------------------------- #

    def _recover(self) -> None:
        last = self._log.last_committed()
        if last < 0:
            return
        plan = self._log.planned(last)
        # a committed batch always has a plan (plan precedes commit), but a
        # compacted pre-upgrade log might not — start over in that case
        self._last_end = plan["end"] if plan else None
        self._next_id = last + 1
        self._recover_state(last)

    def _recover_state(self, last: int) -> None:
        """Restore stateful-operator state to the last committed batch
        (overridden by ParallelStreamingQuery for per-partition docs)."""
        if not self._ops:
            return
        doc = self._log.read_state(last)
        if doc:
            for op, op_doc in zip(self._ops, doc.get("ops", [])):
                op.load_state_doc(op_doc)

    # -- one micro-batch --------------------------------------------------- #

    def _apply(self, batch: Table) -> Table:
        if self.transform is None:
            return batch
        if hasattr(self.transform, "transform"):
            return self.transform.transform(batch)
        return self.transform(batch)

    # The four state/apply hooks factor everything a partition-parallel
    # subclass must change out of process_next, which keeps the WAL
    # ordering (plan -> snapshot -> apply -> state write -> sink ->
    # commit, rollback on any failure) in exactly one place.

    def _snapshot_state(self):
        """Pre-batch state capture, restored by `_restore_state` if the
        attempt fails."""
        return [op.state_doc() for op in self._ops]

    def _restore_state(self, saved) -> None:
        for op, doc in zip(self._ops, saved):
            op.load_state_doc(doc)

    def _apply_batch(self, bid: int, batch: Table) -> Table:
        return self._apply(batch)

    def _write_state(self, bid: int) -> None:
        """Persist post-fold state BEFORE the sink write, so a replayed
        batch restores its operators to the state that preceded the
        crashed attempt."""
        if self._log is not None and self._ops:
            self._log.write_state(
                bid, {"ops": [op.state_doc() for op in self._ops]})

    def _post_commit(self, bid: int) -> None:
        """Commit-time hook (after the WAL commit record)."""

    def _read_ahead(self, start: "dict | None"):
        """Background source read for the batch AFTER the current one:
        (end_offset, batch-or-None). Deterministic per the Source contract
        (get_batch(start, end) always yields the same rows), so a result
        claimed after a failed attempt's replay is still exact."""
        end = self.source.get_offset(start)
        if end is None or end == start or self.source.empty_range(start, end):
            return end, None
        return end, self.source.get_batch(start, end)

    def process_next(self) -> bool:
        """Run at most one micro-batch; False when no new data is
        available. Raises on batch failure (the background loop catches,
        records, and retries — state is rolled back either way, and the
        WAL plan makes the retry deterministic)."""
        if self.following:
            raise RuntimeError("a following rank runs process_all_available() or start(): "
                               "shard 0 plans, reads and commits the batches")
        with self._lock:
            bid = self._next_id
            ahead = None
            replay = self._log.planned(bid) if self._log is not None else None
            if replay is not None:
                start, end = replay["start"], replay["end"]
                if self.source.empty_range(start, end):
                    # an empty plan can only come from a crash between
                    # plan and commit of a batch whose data vanished
                    # (non-replayable source); commit it as a no-op
                    self._commit(bid, end, rows=0)
                    return True
            else:
                start = self._last_end
                hit = False
                if self._lookahead is not None:
                    hit, pre = self._lookahead.take(start)
                if hit and pre[1] is not None:
                    end, ahead = pre
                else:
                    # no pending read-ahead, or it saw no data when it ran
                    # — poll fresh so rows that arrived since aren't missed
                    end = self.source.get_offset(start)
                if end is None or end == start or \
                        self.source.empty_range(start, end):
                    return False
                if self._log is not None:
                    with self._m_wal_plan.time():
                        self._log.plan(bid, start, end)
            saved = self._snapshot_state()
            t0 = time.monotonic()
            tr = self.tracer if self.tracer is not None else get_tracer()
            with tr.start_span("streaming.batch", query=self.name,
                               batch_id=bid) as span:
                try:
                    batch = (ahead if ahead is not None
                             else self.source.get_batch(start, end))
                    # overlap the NEXT batch's source read with this batch's
                    # transform + sink write (keyed by its start offset; a
                    # replay or restart simply misses and reads in line)
                    if self._lookahead is not None:
                        nxt = end
                        self._lookahead.submit(
                            nxt, lambda: self._read_ahead(nxt))
                    out = self._apply_batch(bid, batch)
                    self._write_state(bid)
                    self.sink.add_batch(bid, out)
                except BaseException:
                    # a failed attempt must not leak half-folded state into
                    # the retry: restore the pre-batch snapshots
                    self._restore_state(saved)
                    raise
                span.set(rows=batch.num_rows)
                self._commit(bid, end, rows=batch.num_rows,
                             duration_s=time.monotonic() - t0)
            return True

    def _commit(self, bid: int, end: "dict | None", rows: int,
                duration_s: float = 0.0) -> None:
        if self._log is not None:
            with self._m_wal_commit.time():
                self._log.commit(bid)
            if self._ops:
                self._log.prune_state(keep_from=bid)
            if self.compact_every and (bid + 1) % self.compact_every == 0:
                self._log.compact()
        self._post_commit(bid)
        self.source.commit(end)
        self._last_end = end
        self._next_id = bid + 1
        self.batches_processed += 1
        self.rows_processed += rows
        self.last_progress = {
            "batch_id": bid, "num_rows": rows,
            "duration_s": duration_s, "end_offset": end,
        }
        self._m_batches.inc()
        if rows:
            self._m_rows.inc(rows)
        self._m_batch_seconds.observe(duration_s)
        if self._lookahead is not None:
            self.last_progress["lookahead_hits"] = self._lookahead.hits
            self.last_progress["lookahead_misses"] = self._lookahead.misses
            seen = self._lookahead.hits + self._lookahead.misses
            if seen:
                self._m_lookahead.set(self._lookahead.hits / seen)

    def process_all_available(self) -> int:
        """Drain everything currently available (Spark's availableNow
        trigger); returns batches processed. On a following rank: follow
        shard 0's fused runs until its stop(); returns the runs."""
        if self.following:
            return self._led._follow()["runs"]
        n = 0
        while self.process_next():
            n += 1
        return n

    # -- lifecycle --------------------------------------------------------- #

    def start(self) -> "StreamingQuery":
        if self._closed:
            raise RuntimeError(
                f"query {self.name!r} was stopped; build a new query over "
                "the same checkpoint_dir to resume")
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError(f"query {self.name!r} is already running")
        self._stop.clear()
        with self._lock:
            self._failed = False
        self._thread = threading.Thread(
            target=self._follow if self.following else self._run,
            name=f"streaming-query-{self.name}", daemon=True)
        self._thread.start()
        return self

    def _follow(self) -> None:
        try:
            self._led._follow()
        except Exception as e:  # noqa: BLE001 — recorded like a failed batch
            with self._lock:
                self._exception = e
                self._failed = True

    def _run(self) -> None:
        sess = None
        while not self._stop.is_set():
            try:
                progressed = self.process_next()
            except Exception as e:  # noqa: BLE001 — classified below
                with self._lock:
                    self._exception = e
                if sess is None:
                    sess = self.batch_retry_policy.session()
                if is_fatal_exception(e) or not sess.should_retry():
                    # budget spent (or the error cannot heal): terminate
                    # with `exception` set — a QuerySupervisor above takes
                    # it from here; the WAL plan keeps a later replay exact
                    with self._lock:
                        self._failed = True
                    # last chance to get the black box out before the
                    # loop dies: record the fatal error and dump
                    try:
                        from ..observability.recorder import get_recorder

                        rec = get_recorder()
                        rec.record("streaming.fatal", query=self.name,
                                   batch_id=self._next_id,
                                   error=f"{type(e).__name__}: {e}")
                        rec.trigger_dump("exception", force=True,
                                         query=self.name)
                    except Exception:  # noqa: BLE001 — never mask the fail
                        pass
                    return
                # interruptible backoff: stop() must not wait it out
                sess.backoff(wait=self._stop.wait)
                continue
            sess = None
            if progressed:
                # a recovered query must not look failed forever
                with self._lock:
                    self._exception = None
            else:
                self._stop.wait(self.trigger_interval_s)

    @property
    def is_active(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def failed(self) -> bool:
        """True when the batch retry budget ran dry (or a fatal error hit)
        and the query terminated on its own."""
        return self._failed

    @property
    def exception(self) -> "BaseException | None":
        return self._exception

    def await_termination(self, timeout_s: "float | None" = None) -> bool:
        """Block until stop() (or forever); True if terminated."""
        if self._thread is None:
            return True
        self._thread.join(timeout_s)
        return not self._thread.is_alive()

    def stop(self) -> None:
        """Idempotent: signals the loop, joins it, and closes resources
        exactly once — safe on a never-started or already-stopped query."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        if self._closed:
            return
        self._closed = True
        if self._led is not None and not self.following:
            # after the loop: the followers stop when shard 0 does
            self._led._close_lead()
        if self._lookahead is not None:
            # join any in-flight background read before closing the source
            self._lookahead.discard()
        if self._log is not None:
            self._log.close()
        self.source.close()
        self.sink.close()
