"""Partition-parallel streaming: P shuffle partitions run one query's
stateful chain concurrently — in threads, or across a fleet of worker
processes.

Reference: Spark's stateful streaming execution — `groupBy(key)` hashes
rows across N tasks, each task owns the state for its keys, and the
driver's checkpoint ties their progress into one exactly-once commit.
Here `ParallelStreamingQuery` subclasses the micro-batch driver loop and
replaces only its state/apply hooks: the WAL plan/commit protocol,
replay rules, and sink idempotence are untouched, which is why the
kill-restart byte-identity gate keeps holding at P > 1.

Per batch the driver: runs pre-shuffle stages, computes GLOBAL time
hints (max event time per time column — every partition's watermark
advances on the whole batch, not its slice), splits rows with the
process-stable keyed hash (shuffle.py), fans slices out to the
partition workers (ALL partitions when the chain is stateful — a
complete-mode aggregate emits every group each batch and watermark
finalization fires on empty slices too), barriers, and merges by a
canonical stable sort (the last stateful operator's `merge_sort_cols`;
a hidden row tag restores source order for stateless chains). Because
keys are disjoint across partitions and per-key row order is preserved,
the merged batch is byte-identical to the P=1 run's.

Checkpoints are per-partition and INCREMENTAL: only partitions whose
state doc changed write a `state-p####-#########.json` snapshot
(deterministic serialization — state docs are key-sorted), and recovery
reads each partition's newest snapshot at or before the last commit.

Fleet mode reuses the serving production machinery end to end: workers
are `ServingFleet` processes (their lifecycle — respawn, rolling_swap,
flight-recorder dumps) speaking a small JSON protocol, the driver
routes `query/p<i>` by consistent hash through a `TargetPool`, and
membership flows through the fleet watch protocol. A worker that dies
mid-batch is respawned and answers `need_state`; the driver re-pushes
the committed state and re-sends the slice — partition-level retry,
byte-identity preserved.

A copy of mmlspark_tpu/streaming/partition.py. The driver fuses the
pre-shuffle stages (core/fusion.py) on `device` ("cuda" by default), so
the device work runs there once per batch; the post-shuffle chain is host
work, and a fleet worker is a spawned `ServingFleet` replica that rebuilds
only that chain and so never creates a CUDA context.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Any

import numpy as np

from ..core.pipeline import pipeline_model
from ..core.schema import Table, find_unused_column_name
from ..observability.tracing import get_tracer
from .query import StreamingQuery, _walk_stages
from .shuffle import KeyedShuffle, split_by_partition
from .state import StatefulOperator

__all__ = ["ParallelStreamingQuery", "ThreadPartitionWorker",
           "PartitionWorkerFactory", "split_pipeline_at_shuffle"]


# --------------------------------------------------------------------- #
# shared helpers (driver threads AND fleet worker processes)            #
# --------------------------------------------------------------------- #


def _encode_rows(table: Table) -> dict:
    """JSON-safe columnar encoding. float64 survives the round trip
    exactly (json emits shortest-roundtrip reprs), so worker replies
    merge byte-identical to in-process transforms."""
    cols = {}
    for name in table.columns:
        col = table[name]
        if isinstance(col, np.ndarray):
            cols[name] = {"dtype": str(col.dtype), "values": col.tolist()}
        else:
            cols[name] = {"dtype": "list", "values": list(col)}
    return {"columns": cols}


def _decode_rows(doc: dict) -> Table:
    cols: dict[str, Any] = {}
    for name, spec in (doc or {}).get("columns", {}).items():
        if spec["dtype"] == "list":
            cols[name] = list(spec["values"])
        else:
            cols[name] = np.array(spec["values"],
                                  dtype=np.dtype(spec["dtype"]))
    return Table(cols)


def _chain_ops(chain: Any) -> "list[StatefulOperator]":
    if chain is None:
        return []
    return [s for s in _walk_stages(chain) if isinstance(s, StatefulOperator)]


def _set_time_hints(ops: "list[StatefulOperator]", hints: dict) -> None:
    if not hints:
        return
    for op in ops:
        try:
            tc = op.get("time_col")
        except (KeyError, AttributeError):
            continue
        h = hints.get(tc)
        if h is not None:
            op.set_time_hint(float(h))


def _load_ops_doc(ops: "list[StatefulOperator]", doc: "dict | None") -> None:
    docs = (doc or {}).get("ops") or []
    for i, op in enumerate(ops):
        if i < len(docs):
            op.load_state_doc(docs[i] or {})
        else:
            op.reset_state()


def _ops_watermark(ops: "list[StatefulOperator]") -> "float | None":
    wms = [op.watermark() for op in ops if hasattr(op, "watermark")]
    wms = [w for w in wms if w is not None]
    return min(wms) if wms else None


def _ops_spilled(ops: "list[StatefulOperator]") -> int:
    return int(sum(getattr(op, "spilled_bytes", 0) or 0 for op in ops))


def _clone_chain(chain: Any) -> Any:
    """Independent per-partition copy of the chain, state included.
    Registered stages round-trip through the no-pickle blob codec;
    anything else (ad-hoc local Transformer subclasses) deep-copies."""
    if chain is None:
        return None
    from ..core.serialize import stage_from_blob, stage_to_blob

    try:
        return stage_from_blob(stage_to_blob(chain))
    except Exception:  # noqa: BLE001 — unregistered stage: copy in-process
        import copy

        return copy.deepcopy(chain)


def _stable_sort(table: Table, cols: "list[str]") -> Table:
    """Stable sort by `cols` (ties keep input order) — the canonical
    merge order that reconstructs the P=1 output from partition
    outputs."""
    n = table.num_rows
    if n <= 1:
        return table
    keycols = [table[c] for c in cols]
    order = sorted(range(n),
                   key=lambda i: tuple(kc[i] for kc in keycols))
    return table.gather(np.array(order, dtype=np.int64))


def split_pipeline_at_shuffle(transform: Any):
    """(pre_stages, shuffle_stage_or_None, chain_stages) — the stage
    lists on either side of the pipeline's KeyedShuffle marker. With no
    marker every stage is partition-local."""
    if transform is None:
        return [], None, []
    if not hasattr(transform, "transform"):
        raise TypeError(
            "ParallelStreamingQuery needs a Transformer/PipelineModel "
            "transform (plain callables cannot be cloned per partition)")
    stages = _walk_stages(transform)
    shuffles = [s for s in stages if isinstance(s, KeyedShuffle)]
    if len(shuffles) > 1:
        raise ValueError("a pipeline may hold at most one KeyedShuffle")
    if not shuffles:
        return [], None, stages
    i = stages.index(shuffles[0])
    return stages[:i], shuffles[0], stages[i + 1:]


# --------------------------------------------------------------------- #
# thread workers                                                        #
# --------------------------------------------------------------------- #


class _Task:
    __slots__ = ("bid", "table", "hints", "event", "out", "error",
                 "enq_t", "lag_s")

    def __init__(self, bid: int, table: Table, hints: dict):
        self.bid = bid
        self.table = table
        self.hints = hints
        self.event = threading.Event()
        self.out: "Table | None" = None
        self.error: "BaseException | None" = None
        self.enq_t = time.perf_counter()
        self.lag_s = 0.0


class ThreadPartitionWorker:
    """One partition's chain on its own thread behind an input queue.
    The GIL bounds pure-python speedup, but any slice work that releases
    it — numpy kernels, native scorers, outbound IO — overlaps across
    partitions, and the barrier semantics match fleet mode exactly."""

    def __init__(self, partition: int, chain: Any,
                 ops: "list[StatefulOperator]", query_name: str = "query",
                 tracer: Any = None, depth_gauge: Any = None):
        self.partition = partition
        self.chain = chain
        self.ops = ops
        self.query_name = query_name
        self.tracer = tracer
        self._depth = depth_gauge
        self._q: "queue.Queue[_Task | None]" = queue.Queue()
        self._thread = threading.Thread(
            target=self._run,
            name=f"partition-{query_name}-{partition}", daemon=True)
        self._thread.start()

    @property
    def queue_depth(self) -> int:
        return self._q.qsize()

    def submit(self, bid: int, table: Table, hints: dict) -> _Task:
        task = _Task(bid, table, hints)
        self._q.put(task)
        if self._depth is not None:
            self._depth.set(self._q.qsize())
        return task

    def _run(self) -> None:
        while True:
            task = self._q.get()
            if task is None:
                return
            tr = self.tracer if self.tracer is not None else get_tracer()
            try:
                with tr.start_span("streaming.partition",
                                   query=self.query_name,
                                   batch_id=task.bid,
                                   partition=self.partition) as span:
                    _set_time_hints(self.ops, task.hints)
                    task.out = (self.chain.transform(task.table)
                                if self.chain is not None else task.table)
                    span.set(rows=task.table.num_rows)
            except BaseException as e:  # noqa: BLE001 — driver re-raises
                task.error = e
            finally:
                task.lag_s = time.perf_counter() - task.enq_t
                if self._depth is not None:
                    self._depth.set(self._q.qsize())
                task.event.set()

    def stop(self, timeout_s: float = 5.0) -> None:
        self._q.put(None)
        self._thread.join(timeout_s)


# --------------------------------------------------------------------- #
# fleet workers                                                         #
# --------------------------------------------------------------------- #


class PartitionWorkerFactory:
    """Picklable `ServingFleet` handler factory speaking the partition-
    worker protocol. The chain travels as a registry blob (base64 zip,
    no pickle), so a spawned process rebuilds it from scratch.

    JSON ops over POST /:

      {"op": "apply", "partition", "batch_id", "rows", "hints"}
          -> {"rows", "state", "watermark", "spilled_bytes", "seconds"}
          -> {"need_state": true}  when the worker cannot prove its held
             state is exactly batch_id-1 (fresh spawn, remapped
             partition, or a desync after failover) — the driver pushes
             the committed state and re-sends
      {"op": "load_state", "partition", "batch_id", "state"} -> {"ok"}
      {"op": "status"} -> held partitions, last batch ids, watermarks

    A re-sent `apply` for the batch a worker just folded returns the
    cached reply instead of folding twice — per-batch idempotence, same
    rule as the sinks.
    """

    def __init__(self, blob: "str | None", query_name: str = "query"):
        self.blob = blob
        self.query_name = query_name

    def __call__(self):
        from ..core.serialize import stage_from_blob
        from ..io_http.schema import HTTPResponseData
        from ..io_http.wire import (WIRE_CONTENT_TYPE, content_type_of,
                                    decode_message, encode_message,
                                    is_wire_content_type)

        blob = self.blob
        query_name = self.query_name
        chains: dict[int, Any] = {}
        chain_ops: dict[int, list] = {}
        last: dict[int, int] = {}            # partition -> folded through
        cache: dict[int, tuple] = {}         # p -> (bid, meta_doc, out)

        def _fresh(p: int) -> None:
            c = stage_from_blob(blob) if blob else None
            chains[p] = c
            chain_ops[p] = _chain_ops(c)

        def _apply(body: dict, in_table: "Table | None" = None):
            """-> (doc, out_table): out_table None for control replies
            (need_state); otherwise the handler frames the rows in the
            REQUEST's protocol — JSON columnar, or the shared binary
            wire when the driver opted in (`binary_wire=True`)."""
            p = int(body["partition"])
            bid = int(body["batch_id"])
            hit = cache.get(p)
            if hit is not None and hit[0] == bid:
                return hit[1], hit[2]
            if p not in chains:
                if bid != 0:
                    return {"need_state": True, "have": last.get(p)}, None
                _fresh(p)
                last[p] = -1
            if last.get(p, -2) != bid - 1:
                return {"need_state": True, "have": last.get(p)}, None
            t0 = time.perf_counter()
            table = (in_table if in_table is not None
                     else _decode_rows(body["rows"]))
            ops = chain_ops[p]
            _set_time_hints(ops, body.get("hints") or {})
            out = (chains[p].transform(table)
                   if chains[p] is not None else table)
            reply = {
                "state": {"ops": [op.state_doc() for op in ops]},
                "watermark": _ops_watermark(ops),
                "spilled_bytes": _ops_spilled(ops),
                "seconds": time.perf_counter() - t0,
            }
            last[p] = bid
            cache[p] = (bid, reply, out)
            return reply, out

        def _load_state(body: dict) -> dict:
            p = int(body["partition"])
            _fresh(p)
            _load_ops_doc(chain_ops[p], body.get("state"))
            last[p] = int(body["batch_id"])
            cache.pop(p, None)
            return {"ok": True}

        def _status() -> dict:
            return {
                "query": query_name,
                "partitions": sorted(chains),
                "last": {str(p): b for p, b in sorted(last.items())},
                "watermarks": {str(p): _ops_watermark(chain_ops[p])
                               for p in sorted(chains)},
                "spilled_bytes": {str(p): _ops_spilled(chain_ops[p])
                                  for p in sorted(chains)},
            }

        def handler(table: Table) -> Table:
            replies = []
            for req in table["request"]:
                try:
                    binary = is_wire_content_type(
                        content_type_of(req.headers))
                    in_table = None
                    if binary:
                        body, cols = decode_message(req.entity)
                        # frombuffer views are read-only; ops may fold
                        # in place, so pay one memcpy per array column
                        in_table = Table({
                            k: (np.array(v) if isinstance(v, np.ndarray)
                                else v)
                            for k, v in cols.items()})
                    else:
                        body = req.json() or {}
                    op = body.get("op")
                    if op == "apply":
                        doc, out = _apply(body, in_table)
                        if out is not None:
                            if binary:
                                replies.append(HTTPResponseData(
                                    200, "OK",
                                    {"Content-Type": WIRE_CONTENT_TYPE},
                                    encode_message(
                                        doc,
                                        {c: out[c] for c in out.columns},
                                        n_rows=out.num_rows)))
                                continue
                            doc = {"rows": _encode_rows(out), **doc}
                    elif op == "load_state":
                        doc = _load_state(body)
                    elif op == "status":
                        doc = _status()
                    else:
                        raise ValueError(f"unknown op {op!r}")
                    code, reason = 200, "OK"
                except Exception as e:  # noqa: BLE001 — reply, don't die
                    doc = {"error": f"{type(e).__name__}: {e}"}
                    code, reason = 500, "handler error"
                replies.append(HTTPResponseData(
                    code, reason, entity=json.dumps(doc).encode()))
            return Table({"reply": replies})

        return handler


# --------------------------------------------------------------------- #
# the parallel query                                                    #
# --------------------------------------------------------------------- #


class ParallelStreamingQuery(StreamingQuery):
    """StreamingQuery whose stateful chain runs P-way partition-parallel.

    The pipeline splits at its `KeyedShuffle` stage (stages before it
    run on the driver; stages after run per partition) — or, with no
    marker stage, `key_col`/`num_partitions` place the whole transform
    partition-local. Stateful operators must key their state by the
    shuffle key (`partition_key_col`); output, checkpoints, and
    kill-restart replay are byte-identical to the P=1 run.

    `workers="thread"` runs partitions on driver threads;
    `workers="fleet"` spawns `ServingFleet` worker processes (or attaches
    to a caller-supplied `fleet`) and routes slices by consistent hash.
    The pre-shuffle stages run fused on `device` on the driver.
    """

    def __init__(self, source, transform: Any = None,
                 sink=None, *,
                 key_col: "str | None" = None,
                 num_partitions: "int | None" = None,
                 workers: str = "thread",
                 num_workers: "int | None" = None,
                 fleet: Any = None,
                 fleet_kw: "dict | None" = None,
                 worker_request_timeout_s: float = 60.0,
                 binary_wire: bool = False,
                 timeline_dir: "str | None" = None,
                 device: str = "cuda",
                 **kw: Any) -> None:
        if workers not in ("thread", "fleet"):
            raise ValueError("workers must be 'thread' or 'fleet'")
        pre, shuffle, chain_stages = split_pipeline_at_shuffle(transform)
        if shuffle is not None:
            key_col = key_col or shuffle.get("key_col")
            num_partitions = num_partitions or shuffle.get("num_partitions")
        if not key_col:
            raise ValueError(
                "key_col is required (directly or via a KeyedShuffle stage)")
        self.model = transform
        self.key_col = key_col
        self.num_partitions = int(num_partitions or 2)
        self._worker_mode = workers
        self._num_workers = int(num_workers or self.num_partitions)
        self._worker_request_timeout_s = worker_request_timeout_s
        # opt-in: ship fleet apply slices over the length-prefixed binary
        # wire (io_http/wire.py) instead of JSON columnar — same rows,
        # same replies, no float round-tripping through decimal strings
        self.binary_wire = bool(binary_wire)
        if any(isinstance(s, StatefulOperator) for s in pre):
            raise ValueError(
                "stateful operators must come AFTER the KeyedShuffle — "
                "driver-side state cannot be partitioned")
        self._pre = None
        if pre:
            from ..core.fusion import fuse
            from ..core.kernels import resolve_device

            resolve_device(device)
            self._pre = fuse(pipeline_model(*pre), device=device)
        self._chain = (pipeline_model(*chain_stages)
                       if chain_stages else None)
        self._template_ops = _chain_ops(self._chain)
        self._stateful = bool(self._template_ops)
        for op in self._template_ops:
            kc = op.partition_key_col()
            if kc != key_col:
                raise ValueError(
                    f"{type(op).__name__} keys its state by {kc!r} but "
                    f"the shuffle routes by {key_col!r}; they must match "
                    "for state to stay partition-local")
        self._sort_cols = (self._template_ops[-1].merge_sort_cols()
                           if self._stateful else None)
        if self._stateful and not self._sort_cols:
            raise ValueError(
                f"{type(self._template_ops[-1]).__name__} declares no "
                "merge_sort_cols — its output cannot be merged "
                "deterministically across partitions")
        tcols = set()
        for op in self._template_ops:
            if type(op).set_time_hint is StatefulOperator.set_time_hint:
                continue                      # base no-op: not time-aware
            try:
                tcols.add(op.get("time_col"))
            except (KeyError, AttributeError):
                pass
        self._time_cols = sorted(c for c in tcols if c)
        self._fresh_doc = {"ops": [op.state_doc()
                                   for op in self._template_ops]}
        P = self.num_partitions
        self._committed_docs: list = [
            json.loads(json.dumps(self._fresh_doc)) for _ in range(P)]
        self._committed_ser: list = [
            json.dumps(self._fresh_doc, sort_keys=True)] * P
        self._pending: dict[int, dict] = {}
        self._pending_commit: dict[int, tuple] = {}
        self._last_state_bid: dict[int, int] = {}
        self._pinfo: dict[int, dict] = {p: {} for p in range(P)}
        self._states_written = 0
        self.shuffle_seconds = 0.0           # cumulative split + merge
        self.partition_seconds = 0.0         # cumulative barrier wall
        self._started_workers = False
        self._workers_stopped = False
        self._workers_list: "list[ThreadPartitionWorker] | None" = None
        self._chains: "list | None" = None
        self._chain_ops_list: "list | None" = None
        self._fleet = fleet
        self._own_fleet = fleet is None
        self._fleet_kw = dict(fleet_kw or {})
        self._pool = None
        self._send_pool = None
        self._blob = None
        if workers == "thread":
            self._chains = [_clone_chain(self._chain) for _ in range(P)]
            self._chain_ops_list = [_chain_ops(c) for c in self._chains]
        elif self._chain is not None:
            from ..core.serialize import stage_to_blob

            self._blob = stage_to_blob(self._chain)
        super().__init__(source, None, sink, fuse_pipeline=False,
                         device=device, **kw)
        reg = self.metrics

        def _children(name: str, doc: str):
            fam = reg.gauge(name, doc, labels=("query", "partition"))
            return [fam.labels(query=self.name, partition=str(p))
                    for p in range(P)]

        self._g_depth = _children(
            "mmlspark_tpu_streaming_partition_queue_depth",
            "tasks waiting per partition worker")
        self._g_lag = _children(
            "mmlspark_tpu_streaming_partition_lag_seconds",
            "submit-to-completion wall time of a partition's last slice")
        self._g_wm = _children(
            "mmlspark_tpu_streaming_partition_watermark_seconds",
            "per-partition event-time watermark")
        self._g_spill = _children(
            "mmlspark_tpu_streaming_state_spill_bytes",
            "state-backend bytes spilled to parquet, per partition")
        # opt-in per-partition telemetry history: one timeline sample per
        # committed batch (event-driven, no background thread — the
        # commit IS the cadence), recording lag/depth/watermark per
        # partition. This is the observed-history half of the ROADMAP's
        # dynamic-rebalancing item: the rebalancer needs to know how
        # skewed each partition HAS BEEN, not just how skewed it is now.
        self._timeline = None
        if timeline_dir is not None:
            from ..observability.timeline import TimelineRecorder

            self._timeline = TimelineRecorder(timeline_dir, reg)

    # -- recovery ---------------------------------------------------------- #

    def _recover_state(self, last: int) -> None:
        for p in range(self.num_partitions):
            doc = self._log.read_partition_state(p, last)
            if doc is None:
                doc = json.loads(json.dumps(self._fresh_doc))
            self._committed_docs[p] = doc
            self._committed_ser[p] = json.dumps(doc, sort_keys=True)
            if self._chains is not None:
                _load_ops_doc(self._chain_ops_list[p], doc)
        # fleet workers pick the state up lazily: their first `apply`
        # answers need_state and the driver pushes the committed doc

    # -- workers ----------------------------------------------------------- #

    def _ensure_workers(self) -> None:
        if self._started_workers:
            return
        self._started_workers = True
        if self._worker_mode == "thread":
            self._workers_list = [
                ThreadPartitionWorker(
                    p, self._chains[p], self._chain_ops_list[p],
                    query_name=self.name, tracer=self.tracer,
                    depth_gauge=self._g_depth[p])
                for p in range(self.num_partitions)]
            return
        from concurrent.futures import ThreadPoolExecutor

        from ..io_http.clients import TargetPool

        self._pool = TargetPool()
        if self._fleet is None:
            from ..io_http.serving import ServingFleet

            fr_dir = (os.path.join(self._log.dir, "flight")
                      if self._log is not None else None)
            kw = dict(self._fleet_kw)
            kw.setdefault("flight_recorder_dir", fr_dir)
            self._fleet = ServingFleet(
                PartitionWorkerFactory(self._blob, self.name),
                n_hosts=self._num_workers, **kw)
        self._fleet.watch(self._on_membership)
        if self._own_fleet:
            self._fleet.start()
        for url in list(self._fleet.urls):
            self._pool.admit(url)
        self._send_pool = ThreadPoolExecutor(
            max_workers=min(32, max(2, self.num_partitions)),
            thread_name_prefix=f"shuffle-{self.name}")

    def _on_membership(self, event: str, url: str) -> None:
        if self._pool is None:
            return
        if event == "added":
            self._pool.admit(url)
        elif event == "removed":
            self._pool.eject(url, "fleet-removed")

    def _heal(self) -> None:
        """Respawn any fleet worker that died uncleanly; membership
        callbacks re-admit the replacement into the routing pool."""
        if self._fleet is None:
            return
        try:
            dead = self._fleet.dead_slots()
        except Exception:  # noqa: BLE001 — fleet mid-stop
            return
        for slot in dead:
            try:
                self._fleet.respawn(slot)
            except Exception:  # noqa: BLE001 — retried next attempt
                pass

    def _send(self, body: dict, p: int):
        from ..io_http.schema import HTTPRequestData

        return self._pool.send(
            HTTPRequestData.from_json("/", body),
            timeout=self._worker_request_timeout_s,
            strategy="hash", key=f"{self.name}/p{p}")

    def _push_state(self, p: int, upto_bid: int) -> None:
        resp = self._send({"op": "load_state", "partition": p,
                           "batch_id": upto_bid,
                           "state": self._committed_docs[p]}, p)
        if resp.status_code != 200:
            raise RuntimeError(
                f"partition {p}: state push failed "
                f"({resp.status_code} {resp.reason})")

    def _fleet_apply_one(self, p: int, bid: int, part: Table,
                         hints: dict) -> dict:
        if self.binary_wire:
            from ..io_http.schema import HTTPRequestData
            from ..io_http.wire import WIRE_CONTENT_TYPE, encode_message

            meta = {"op": "apply", "partition": p, "batch_id": bid,
                    "hints": hints}
            req = HTTPRequestData(
                "POST", "/", {"Content-Type": WIRE_CONTENT_TYPE},
                encode_message(meta, {c: part[c] for c in part.columns},
                               n_rows=part.num_rows))
            send = lambda: self._pool.send(  # noqa: E731
                req, timeout=self._worker_request_timeout_s,
                strategy="hash", key=f"{self.name}/p{p}")
        else:
            body = {"op": "apply", "partition": p, "batch_id": bid,
                    "rows": _encode_rows(part), "hints": hints}
            send = lambda: self._send(body, p)  # noqa: E731
        last_err: "Exception | None" = None
        for attempt in range(8):
            resp = send()
            if resp.status_code in (0, 503):
                # connection-level death or no live worker: heal the
                # fleet and retry — the respawned worker answers
                # need_state and the committed state re-flows
                last_err = RuntimeError(
                    f"partition {p}: no worker reachable "
                    f"({resp.status_code} {resp.reason})")
                self._heal()
                time.sleep(min(0.1 * (attempt + 1), 1.0))
                continue
            doc = self._decode_apply_reply(resp)
            if resp.status_code != 200:
                raise RuntimeError(
                    f"partition {p} worker error: "
                    f"{doc.get('error') or resp.reason}")
            if doc.get("need_state"):
                self._push_state(p, bid - 1)
                continue
            return doc
        raise last_err or RuntimeError(
            f"partition {p}: apply did not converge")

    @staticmethod
    def _decode_apply_reply(resp) -> dict:
        """Worker apply replies arrive framed (binary wire, rows as raw
        column blocks) or as JSON columnar; either way normalize to the
        reply doc with the decoded Table stashed under ``_table``."""
        from ..io_http.wire import (content_type_of, decode_message,
                                    is_wire_content_type)

        if is_wire_content_type(content_type_of(resp.headers)):
            meta, cols = decode_message(resp.entity)
            doc = dict(meta)
            doc.pop("json_columns", None)
            doc["_table"] = Table(dict(cols))
            return doc
        return resp.json() or {}

    # -- hooks over the base micro-batch loop ------------------------------ #

    def _compute_hints(self, batch: Table) -> dict:
        hints = {}
        if batch.num_rows:
            for c in self._time_cols:
                if c in batch.columns:
                    hints[c] = float(np.max(
                        np.asarray(batch[c], dtype=np.float64)))
        return hints

    def _run_partitions(self, bid: int, parts: "list[Table]",
                        hints: dict) -> "list[Table | None]":
        P = self.num_partitions
        outs: "list[Table | None]" = [None] * P
        # stateful chains hear about EVERY batch (complete-mode emission,
        # watermark finalization on empty slices); stateless chains skip
        # empty slices, keeping partition 0 as the schema carrier
        wanted = [p for p in range(P)
                  if self._stateful or parts[p].num_rows or p == 0]
        if self._worker_mode == "thread":
            tasks = {p: self._workers_list[p].submit(bid, parts[p], hints)
                     for p in wanted}
            err: "BaseException | None" = None
            for task in tasks.values():        # full barrier BEFORE any
                task.event.wait()              # raise: rollback needs
            for p, task in sorted(tasks.items()):   # idle workers
                if task.error is not None:
                    err = err or task.error
                    continue
                outs[p] = task.out
                ops = self._chain_ops_list[p]
                if self._stateful:
                    self._pending[p] = {
                        "ops": [op.state_doc() for op in ops]}
                self._pinfo[p] = {
                    "rows_in": parts[p].num_rows,
                    "rows_out": task.out.num_rows,
                    "lag_s": task.lag_s,
                    "queue_depth": self._workers_list[p].queue_depth,
                    "watermark": _ops_watermark(ops),
                    "spilled_bytes": _ops_spilled(ops),
                }
            if err is not None:
                raise err
            return outs
        futs = {p: self._send_pool.submit(
            self._fleet_apply_one, p, bid, parts[p], hints)
            for p in wanted}
        err = None
        docs: dict[int, dict] = {}
        for p, f in sorted(futs.items()):
            try:
                docs[p] = f.result()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                err = err or e
        if err is not None:
            raise err
        for p, doc in sorted(docs.items()):
            outs[p] = (doc.pop("_table") if "_table" in doc
                       else _decode_rows(doc["rows"]))
            if self._stateful:
                self._pending[p] = doc["state"]
            self._pinfo[p] = {
                "rows_in": parts[p].num_rows,
                "rows_out": outs[p].num_rows,
                "lag_s": doc.get("seconds"),
                "queue_depth": 0,
                "watermark": doc.get("watermark"),
                "spilled_bytes": doc.get("spilled_bytes", 0),
            }
        return outs

    def _apply_batch(self, bid: int, batch: Table) -> Table:
        self._ensure_workers()
        t0 = time.perf_counter()
        if self._pre is not None:
            batch = self._pre.transform(batch)
        hints = self._compute_hints(batch)
        tag = None
        if not self._stateful:
            tag = find_unused_column_name("_shuffle_row", batch)
            batch = batch.with_column(
                tag, np.arange(batch.num_rows, dtype=np.int64))
        parts = split_by_partition(batch, self.key_col,
                                   self.num_partitions)
        t1 = time.perf_counter()
        outs = self._run_partitions(bid, parts, hints)
        t2 = time.perf_counter()
        present = [o for o in outs if o is not None]
        merged = present[0]
        for o in present[1:]:
            merged = merged.concat(o)
        if self._stateful:
            missing = [c for c in self._sort_cols
                       if c not in merged.columns]
            if missing:
                raise ValueError(
                    f"merge sort columns {missing} not in partition "
                    f"output {merged.columns} — the chain's final stage "
                    "must keep its stateful operator's output columns")
            merged = _stable_sort(merged, self._sort_cols)
        else:
            merged = _stable_sort(merged, [tag])
            merged = merged.select(
                *[c for c in merged.columns if c != tag])
        t3 = time.perf_counter()
        self.shuffle_seconds += (t1 - t0) + (t3 - t2)
        self.partition_seconds += t2 - t1
        return merged

    def _snapshot_state(self):
        return list(self._committed_docs)

    def _restore_state(self, saved) -> None:
        self._pending.clear()
        self._pending_commit.clear()
        last = self._next_id - 1
        for p in range(self.num_partitions):
            doc = saved[p]
            if self._chains is not None:
                _load_ops_doc(self._chain_ops_list[p], doc)
            elif self._started_workers and self._stateful:
                try:
                    self._push_state(p, last)
                except Exception:  # noqa: BLE001 — worker answers
                    pass           # need_state on the retry instead

    def _write_state(self, bid: int) -> None:
        self._pending_commit = {}
        written = 0
        for p, doc in sorted(self._pending.items()):
            ser = json.dumps(doc, sort_keys=True)
            if ser != self._committed_ser[p]:
                if self._log is not None:
                    self._log.write_partition_state(p, bid, doc)
                self._last_state_bid[p] = bid
                written += 1
            self._pending_commit[p] = (doc, ser)
        self._pending.clear()
        self._states_written = written

    def _post_commit(self, bid: int) -> None:
        for p, (doc, ser) in self._pending_commit.items():
            self._committed_docs[p] = doc
            self._committed_ser[p] = ser
        self._pending_commit = {}
        if self._log is not None:
            self._log.prune_state(keep_from=bid)
            self._write_status(bid)
        for p in range(self.num_partitions):
            info = self._pinfo.get(p) or {}
            if info.get("lag_s") is not None:
                self._g_lag[p].set(float(info["lag_s"]))
            if info.get("watermark") is not None:
                self._g_wm[p].set(float(info["watermark"]))
            self._g_spill[p].set(float(info.get("spilled_bytes") or 0))
            self._g_depth[p].set(float(info.get("queue_depth") or 0))
        if self._timeline is not None:
            try:
                self._timeline.sample()
            except Exception:  # noqa: BLE001 — history must not fail commits
                pass

    def _commit(self, bid: int, end, rows: int,
                duration_s: float = 0.0) -> None:
        super()._commit(bid, end, rows, duration_s)
        self.last_progress.update({
            "num_partitions": self.num_partitions,
            "workers": self._worker_mode,
            "partition_states_written": self._states_written,
            "shuffle_seconds_total": self.shuffle_seconds,
            "partition_seconds_total": self.partition_seconds,
        })

    def _write_status(self, bid: int) -> None:
        """One-shot observability snapshot beside the WAL —
        `tools/diagnose.py --streaming <checkpoint_dir>` renders it."""
        doc = {
            "query": self.name,
            "mode": self._worker_mode,
            "key_col": self.key_col,
            "num_partitions": self.num_partitions,
            "batch_id": bid,
            "time": time.time(),
            "partitions": {
                str(p): dict(self._pinfo.get(p) or {},
                             last_state_bid=self._last_state_bid.get(p))
                for p in range(self.num_partitions)},
        }
        path = os.path.join(self._log.dir, "status.json")
        tmp = path + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(doc, fh, sort_keys=True)
            os.replace(tmp, path)
        except OSError:
            pass

    # -- lifecycle --------------------------------------------------------- #

    def stop(self) -> None:
        super().stop()
        if self._workers_stopped:
            return
        self._workers_stopped = True
        if self._workers_list:
            for w in self._workers_list:
                w.stop()
        if self._send_pool is not None:
            self._send_pool.shutdown(wait=False)
        if self._fleet is not None and self._own_fleet:
            try:
                self._fleet.stop()
            except Exception:  # noqa: BLE001 — already down
                pass
