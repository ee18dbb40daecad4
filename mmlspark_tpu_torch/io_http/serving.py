"""Serving: deploy a pipeline as a web service.

Reference: Spark Serving (SURVEY.md §3.4) — batch mode `HTTPSource`/`HTTPSink`
(HTTPSource.scala:46-225), distributed mode's per-JVM `JVMSharedServer` with
request queues drained per micro-batch (DistributedHTTPSource.scala:89-343),
and continuous mode's per-partition servers replying through an in-process
routing table keyed by request id (HTTPSourceV2.scala:336-474, ~1 ms).

TPU redesign: one process = one host = one `ServingServer`. Requests land in
an in-memory queue; a batcher thread greedily drains everything queued (up
to `max_batch_size`), runs the scoring callable ONCE on the whole batch (the
jitted model step is persistent — compiled on the first batch, padded to a
fixed shape after that), and completes each request's event — the
continuous-mode direct-reply path without a streaming engine in the middle.
Batching is backpressure-driven: requests arriving mid-score join the next
batch. `max_latency_ms` (default 0) is an opt-in collection window that
trades exactly that much p50 for bigger batches.
Multi-host serving = one ServingServer per host behind any TCP balancer
(the reference's per-executor servers + load balancer, SURVEY.md §3.4).

A copy of mmlspark_tpu/io_http/serving.py, whose fused segments
(core/fusion.py) replay CUDA graphs on the card; `serve_model` takes
`device` ("cuda" by default) for them. The fleet half (`ServiceInfo`,
`FleetRendezvous`, `ServingFleet`) spawns each replica as a process of its
own (the `spawn` context: a forked child of a process that touched CUDA
cannot use the card), which builds its handler, and so its model and its
CUDA context, itself. `serve_model` delegates a fitted `SARModel` to
recommendation/resident.py's `serve_recommender`. Every scoring path
(resident, native, host) records a phase ledger into the process-default
profiler (`observability/profiler.py`) when it is armed; `info()` carries
its attribution under `profiler`.
"""

from __future__ import annotations

import collections
import itertools
import json
import multiprocessing
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable

import numpy as np

from ..core.dataplane import AsyncReadback, ShapeBucketer, cache_stats
from ..core.schema import Table
from ..observability.sanitizer import make_lock, make_rlock
from .schema import (HTTPRequestData, HTTPResponseData, RequestDecoder,
                     make_reply, parse_request)
from .wire import (WIRE_CONTENT_TYPE, accepts_wire, encode_reply,
                   is_wire_content_type)

__all__ = ["ServingServer", "ServingFleet", "MicroBatchQuery", "serve_model",
           "ServiceInfo", "FleetRendezvous"]

# unique `server=` label per ServingServer in this process: the registry is
# shared, the per-server counts must stay exact (tests assert them)
_SERVER_SEQ = itertools.count()


def _prof_ledger(kind: str, segment: str, span: Any = None, **meta: Any):
    """The process profiler's phase ledger for one scored batch — the
    shared no-op when disarmed (one attribute check on the hot path).
    Import is deferred so serving never pays observability's package
    init unless a batch is actually scored."""
    from ..observability.profiler import get_profiler

    return get_profiler().ledger(kind, segment, span=span, **meta)


def _negotiate_reply(resp: "HTTPResponseData",
                     request: "HTTPRequestData") -> "HTTPResponseData":
    """Honor a binary-Accept-ing client on routes that replied JSON (the
    handler fallback path): a 200 single-value ``{col: v}`` JSON reply is
    re-framed as the binary wire reply. Hot-path routes frame binary
    replies directly (`replies_for`'s binary_mask), so this is a no-op
    for them; error statuses and non-scalar bodies pass through as JSON
    — the negotiation rule is 'binary clients must also accept JSON',
    never the reverse."""
    if (resp.status_code != 200 or not resp.entity
            or not accepts_wire(request.headers)):
        return resp
    ct = resp.headers.get("Content-Type", "")
    if is_wire_content_type(ct) or not ct.startswith("application/json"):
        return resp
    try:
        body = json.loads(resp.entity)
        (col, v), = body.items()
        if v is None or isinstance(v, (bool, str, dict)):
            return resp
        return HTTPResponseData(
            status_code=200, reason="OK",
            headers={"Content-Type": WIRE_CONTENT_TYPE},
            entity=encode_reply(col, v))
    except Exception:  # noqa: BLE001 — negotiation never breaks a reply
        return resp


def _handler_error_response(e: Exception) -> "HTTPResponseData":
    """Uniform 500 payload for a failed scoring batch (continuous and
    micro-batch paths share the error contract)."""
    return HTTPResponseData(
        500, "handler error",
        headers={"Content-Type": "application/json"},
        entity=json.dumps({"error": str(e)}).encode(),
    )


@dataclass
class _Exchange:
    request: HTTPRequestData
    event: threading.Event = field(default_factory=threading.Event)
    response: HTTPResponseData | None = None
    enqueued_at: float = 0.0
    # absolute perf_counter deadline (request_deadline_s); None = no deadline
    deadline: float | None = None
    # the serving.request span (handler thread) — the batcher parents its
    # serving.score span on it so one trace covers park -> score -> reply
    span: Any = None
    # stamped by the batcher before scoring: which hot-path route and
    # bucket rung served this request (+ the readback window depth at
    # resident dispatch) — the handler thread attaches them to the
    # latency exemplar and the flight-recorder request record
    route: str | None = None
    bucket: int | None = None
    readback_lag: int | None = None


class SingleSegmentHandler(BaseHTTPRequestHandler):
    """Base for every HTTP handler in this package: buffered writes +
    TCP_NODELAY so each response leaves as ONE TCP segment.

    The stdlib defaults (wbufsize=0, Nagle on) write headers and body as
    separate small sends; on a keep-alive connection the second send
    stalls behind the peer's delayed ACK — ~40 ms added to every round
    trip, invisible to server-side latency counters (enqueue -> reply
    written) and devastating to the ~1 ms serving claim. Subclass this
    instead of BaseHTTPRequestHandler so no future endpoint reintroduces
    the stall."""

    wbufsize = -1
    disable_nagle_algorithm = True


class _DeepBacklogServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a serving-grade accept backlog.

    socketserver's default listen backlog is 5: a burst of concurrent
    clients connecting at once (exactly the load continuous batching is
    built to coalesce) overflows it and the overflow gets TCP RSTs
    before the server ever sees the requests. The batcher's admission
    control (max_pending -> 503 + Retry-After) is the intended overload
    answer — it can only run on connections that got accepted."""

    request_queue_size = 128


class _HotPath:
    """serve_model's device-resident fast lane.

    Holds the long-lived scoring session the batcher can route through
    instead of the per-request handler: a `core.fusion.ResidentExecutor`
    with the fused segment's params (and GBDT SoAs) pinned on device once
    at startup, a `RequestDecoder` that turns a request batch into ONE
    preallocated feature matrix, and — when the model exposes one — the
    native C++ tree-walk scorer, the small-batch champion. `route_for`
    picks the route per bucket rung from the crossover measured during
    warmup; a rung warmup never measured stays on the handler path —
    the fast routes are only ever taken where they were verified and
    their executables pre-compiled (no warmup_request = no fast lane).

    Every route must be byte-identical to the handler path. Warmup
    enforces that literally: each rung's resident (and native) reply
    BYTES are compared against the handler's replies for the same batch,
    and the first divergence disables the fast lane — correctness
    degrades to the handler path, never to different answers."""

    # timing repetitions per rung when measuring the crossover
    WARM_REPS = 3

    # the route label this hot path's resident lane reports under —
    # subclasses serving other workloads (recommendation.resident's
    # SARHotPath) override it so serving_path_total separates workloads
    resident_label = "resident"

    def __init__(self, executor, decoder: RequestDecoder, feature_col: str,
                 output_col: str, native_fn=None, readback_lag: int = 1):
        self.executor = executor
        self.decoder = decoder
        self.feature_col = feature_col
        self.output_col = output_col
        self.native_fn = native_fn
        self.readback_lag = max(int(readback_lag), 0)
        # bucket rung -> resident_label | "native", learned by warm_rung
        self.crossover: dict[int, str] = {}
        self.timings_ms: dict[int, dict[str, float]] = {}
        self.disabled: "str | None" = None
        # test hook: pin every batch to one route (resident_label/
        # "native"/"host") regardless of the crossover
        self.force_path: "str | None" = None
        self.path_requests = {self.resident_label: 0, "native": 0, "host": 0}
        self.resident_batches = 0
        # guards the routing tables and counters above: warm_rung runs on
        # the warmup thread while scorer threads call route_for/note
        self._lock = make_rlock("_HotPath._lock")

    def _disable(self, reason: str) -> None:
        with self._lock:
            self.disabled = reason

    def route_for(self, bucket: int) -> str:
        with self._lock:
            if self.disabled is not None:
                return "host"
            if self.force_path is not None:
                return self.force_path
            # only rungs warmup measured (and byte-verified) route fast:
            # an unknown rung on the resident path would pay a LIVE
            # compile and score through a route whose replies were never
            # checked
            return self.crossover.get(bucket, "host")

    def replies_for(self, vals: np.ndarray,
                    binary_mask: "list[bool] | None" = None
                    ) -> "list[HTTPResponseData]":
        """Score column -> replies, byte-for-byte what the handler path's
        `make_reply` produces (tolist() -> Python float -> json.dumps).
        `binary_mask[i]` True swaps row i's reply for the binary wire
        frame (the request Accept-ed it) — raw f64 bytes, no json.dumps
        on the hot path."""
        col = self.output_col
        vlist = np.asarray(vals).tolist()
        if binary_mask is None:
            binary_mask = [False] * len(vlist)
        return [
            HTTPResponseData(
                status_code=200, reason="OK",
                headers={"Content-Type": WIRE_CONTENT_TYPE},
                entity=encode_reply(col, v),
            ) if binary else HTTPResponseData(
                status_code=200, reason="OK",
                headers={"Content-Type": "application/json"},
                entity=json.dumps({col: v}).encode(),
            )
            for v, binary in zip(vlist, binary_mask)]

    def native_values(self, feats: np.ndarray) -> np.ndarray:
        return np.asarray(self.native_fn(feats), np.float64)

    def value_check(self, feats: np.ndarray) -> str:
        """Per-batch resident precondition — the VALUE-dependent subset of
        `executor.check_ready`.  Schema validation (dense ndarray, column
        contract) ran exactly once at warmup (`warm_rung`'s full
        check_ready); live batches pay only each kernel's vectorized
        `ready_values` hook — for GBDT, nothing at all on float32 payloads.
        '' routes resident; a reason string declines the batch (the native
        walk is exact for any float64 payload, so nothing is lost)."""
        try:
            return self.executor.check_ready_values(
                {self.feature_col: feats})
        except Exception as e:  # noqa: BLE001 — decline, never crash the loop
            return f"value check failed: {e}"

    def fetch_values(self, outs, n_valid: int, ledger=None):
        """Block on one in-flight batch's device results and return
        whatever `replies_for` consumes — subclasses with a different
        reply schema override both as a pair. An armed `ledger` splits
        the wait into compute (device) and d2h (host copy) phases."""
        return self.executor.fetch(outs, n_valid, ledger=ledger)[
            self.output_col]

    def resident_values(self, feats: np.ndarray, n_valid: int):
        outs = self.executor.dispatch({self.feature_col: feats})
        return self.fetch_values(outs, n_valid)

    def warm_rung(self, handler, request: HTTPRequestData, rung: int,
                  expect_entities: list) -> None:
        """Compile, verify, and time one ladder rung. The handler's
        replies for the same batch are the oracle: the resident and
        native routes must reproduce their entity bytes exactly. The
        faster measured route wins the rung in `crossover`."""
        if self.disabled is not None:
            return
        feats = self.decoder.decode([request] * rung)
        if feats is None:
            self._disable("warmup request outside the fast-path schema")
            return
        expect = list(expect_entities)
        reason = self.executor.check_ready(Table({self.feature_col: feats}))
        if reason:
            # commonly: the warmup payload's floats are not f32-
            # representable, so the resident route would decline the batch
            # (live routing guards this per batch too). Warm and time the
            # ladder on the nearest representable request instead, with
            # the handler re-scored on it as the byte oracle.
            vals = feats[0].astype(np.float32).astype(np.float64)
            req32 = HTTPRequestData.from_json(
                request.url or "/",
                dict(zip(self.decoder.cols, vals.tolist())))
            feats = self.decoder.decode([req32] * rung)
            reason = (self.executor.check_ready(
                Table({self.feature_col: feats}))
                if feats is not None else "warmup schema")
            if feats is None or reason:
                self._disable(f"resident precondition: {reason}")
                return
            expect = [r.entity
                      for r in handler(Table({"request": [req32] * rung}))
                      ["reply"]]
        try:
            vals = self.resident_values(feats, rung)  # first call compiles
        except Exception as e:  # noqa: BLE001 — degrade, don't break serving
            self._disable(f"resident dispatch failed: {e}")
            return
        if [r.entity for r in self.replies_for(vals)] != expect:
            self._disable(f"resident replies diverge at rung {rung}")
            return
        t = {self.resident_label: self._time(
            lambda: self.resident_values(feats, rung))}
        if self.native_fn is not None:
            try:
                nvals = self.native_values(feats)
            except Exception:  # noqa: BLE001 — native scorer unusable
                with self._lock:
                    self.native_fn = None
            else:
                if [r.entity for r in self.replies_for(nvals)] != expect:
                    # wrong answers never route; resident is already proven
                    with self._lock:
                        self.native_fn = None
                else:
                    t["native"] = self._time(
                        lambda: self.native_values(feats))
        with self._lock:
            self.timings_ms[rung] = {k: v * 1e3 for k, v in t.items()}
            self.crossover[rung] = min(t, key=t.get)

    @staticmethod
    def _time(fn) -> float:
        best = float("inf")
        for _ in range(_HotPath.WARM_REPS):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best

    def note(self, path: str, n: int) -> None:
        with self._lock:
            self.path_requests[path] = self.path_requests.get(path, 0) + n

    def note_resident_batch(self) -> None:
        with self._lock:
            self.resident_batches += 1

    def snapshot(self) -> dict:
        """The info() `hot_path` block: routing table, measured per-rung
        timings, and round-trip accounting — the ROADMAP's ≤1-host-round-
        trip-per-request bar is `round_trips_per_resident_request` (each
        resident BATCH costs exactly one upload+readback pair, shared by
        every request coalesced into it)."""
        ex_stats: dict = {}
        try:
            ex_stats = self.executor.stats()
        except Exception:  # noqa: BLE001 — stats are strictly optional
            pass
        with self._lock:
            res_req = self.path_requests.get(self.resident_label, 0)
            return {
                "enabled": self.disabled is None,
                "disabled_reason": self.disabled,
                "resident_label": self.resident_label,
                "crossover": {str(b): p
                              for b, p in sorted(self.crossover.items())},
                "timings_ms": {str(b): {k: round(v, 4)
                                        for k, v in t.items()}
                               for b, t in sorted(self.timings_ms.items())},
                "readback_lag": self.readback_lag,
                "donate_buffers": bool(ex_stats.get("donate_buffers", False)),
                "dispatch_overlap_fraction": round(float(
                    ex_stats.get("dispatch_overlap_fraction", 0.0)), 4),
                "paths": dict(self.path_requests),
                "resident_batches": self.resident_batches,
                "round_trips": self.executor.round_trips,
                "round_trips_per_resident_request": (
                    self.resident_batches / res_req if res_req else 0.0),
                "decoder": {"hits": self.decoder.hits,
                            "fallbacks": self.decoder.fallbacks,
                            "binary_hits": getattr(
                                self.decoder, "binary_hits", 0)},
            }


class ServingServer:
    """HTTP frontend + batched scoring loop.

    `handler(Table) -> Table` receives a table with a "request" column of
    HTTPRequestData and must return a table with a "reply" column of
    HTTPResponseData (use parse_request/make_reply, the reference's
    ServingImplicits pattern)."""

    def __init__(
        self,
        handler: Callable[[Table], Table] | None = None,
        host: str = "127.0.0.1",
        port: int = 0,
        max_batch_size: int = 64,
        max_latency_ms: float = 0.0,
        reply_timeout_s: float = 30.0,
        api_path: str = "/",
        mode: str = "continuous",
        checkpoint_dir: str | None = None,
        max_pending: int = 0,
        request_deadline_s: float | None = None,
        drain_timeout_s: float = 5.0,
        bucket_batches: bool = False,
        bucket_multiple_of: int = 1,
        metrics: Any = None,
        warmup_request: "HTTPRequestData | None" = None,
        tracer: Any = None,
        hot_path: "_HotPath | None" = None,
        exemplars: bool = True,
        flight_recorder_dir: "str | None" = None,
        recorder: Any = None,
    ):
        if mode not in ("continuous", "batch"):
            raise ValueError(f"mode must be 'continuous' or 'batch', got {mode!r}")
        if mode == "continuous" and handler is None:
            raise ValueError("continuous mode needs a handler(Table) -> Table")
        if checkpoint_dir is not None and mode != "batch":
            raise ValueError(
                "checkpoint_dir journals the micro-batch source; it "
                "requires mode='batch' (the reference's checkpointLocation "
                "applies to the streaming query, "
                "docs/mmlspark-serving.md:50-52)"
            )
        self.handler = handler
        self.host, self.port = host, port
        # run once by stop(), after the loops stop (a mesh lead's stop word)
        self._stop_hooks: list = []
        self.max_batch_size = max_batch_size
        self.max_latency_ms = max_latency_ms
        self.reply_timeout_s = reply_timeout_s
        # load shedding: an overloaded server must answer 503 + Retry-After
        # immediately instead of queueing without bound (and timing every
        # caller out at once later). max_pending=0 keeps the historical
        # unbounded-queue behavior.
        self.max_pending = max_pending
        # per-request deadline: past it the request answers 504 WITHOUT
        # being scored — an expired exchange must not occupy a batch slot
        self.request_deadline_s = request_deadline_s
        self.drain_timeout_s = drain_timeout_s
        # Pad each scored batch up to a power-of-two bucket (repeating the
        # last request; padded replies are sliced off before completion).
        # A greedy batcher hands the handler every row count from 1 to
        # max_batch_size — one fresh XLA compile per NEW count, i.e. p99
        # recompile spikes deep into a deployment. The ladder bounds the
        # handler's input sizes to a small closed set, so the jitted model
        # is fully warm after one pass over the ladder. OPT-IN: padding
        # re-presents the last request to the handler, which is only safe
        # for pure scoring handlers (serve_model enables it) — a handler
        # with side effects per row (e.g. forwarding upstream) would see
        # duplicates.
        # Under a mesh the resident executor row-shards each dispatch over
        # the data axis, so every ladder rung must divide by its size —
        # serve_model passes bucket_multiple_of from the fused model's mesh
        # (mirroring _FusedSegment.run's mini-batch ladder).
        m = max(1, int(bucket_multiple_of))
        bmax = -(-max_batch_size // m) * m
        # skew-aware ladder (`shards=m`): each rung splits into m equal
        # per-shard slices, not just an m-divisible total
        self.bucketer = (ShapeBucketer(bmax, shards=m)
                         if bucket_batches and max_batch_size > 1 else None)
        self.api_path = api_path
        # "continuous": batcher thread drains the queue and replies directly
        # (HTTPSourceV2.scala:336-474). "batch": the micro-batch engine is the
        # CALLER — get_batch() drains pending requests as a Table, reply()
        # completes them (HTTPSource.getBatch/HTTPSink, HTTPSource.scala:46-225).
        self.mode = mode
        self._queue: queue.Queue[_Exchange] = queue.Queue()
        self._pending: dict[str, _Exchange] = {}   # batch mode: id -> exchange
        self._id_counter = itertools.count()
        self._server: ThreadingHTTPServer | None = None
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        # durable accept/reply journal (reference checkpointLocation,
        # DistributedHTTPSource.scala:308-343): accepted-but-unanswered
        # requests survive a restart and are replayed by the next query
        self.journal = None
        if checkpoint_dir is not None:
            from .journal import ServingJournal

            self.journal = ServingJournal(checkpoint_dir)
            # never reuse a journaled id after restart
            self._id_counter = itertools.count(self.journal.max_id() + 1)
            # recovery: re-park the replay set; no live socket waits on
            # these exchanges — their replies land in the journal only
            for ex_id, req in self.journal.unanswered().items():
                self._pending[ex_id] = _Exchange(req)
        # serving counters (reference requestsSeen/Accepted/Answered,
        # DistributedHTTPSource.scala:98-107), registry-backed so one
        # GET /metrics scrape covers every server in the process; each
        # server owns uniquely-labeled children and the requests_*
        # properties read them back, keeping per-server accounting exact.
        # Imports are deferred: observability's package init pulls in
        # core.pipeline, and resilience must stay import-order free.
        from ..core.dataplane import ensure_cache_metrics
        from ..observability.metrics import get_registry
        from ..resilience.breaker import ensure_metrics as _breaker_metrics

        self.metrics = metrics if metrics is not None else get_registry()
        self.server_label = f"srv{next(_SERVER_SEQ)}"

        def _own(name: str, doc: str):
            return self.metrics.counter(name, doc, labels=("server",)) \
                .labels(server=self.server_label)

        self._c_seen = _own("mmlspark_tpu_serving_requests_seen_total",
                            "requests received, any outcome")
        self._c_accepted = _own("mmlspark_tpu_serving_requests_accepted_total",
                                "requests admitted past load shedding")
        self._c_answered = _own("mmlspark_tpu_serving_requests_answered_total",
                                "requests answered with a scored reply")
        self._c_shed = _own("mmlspark_tpu_serving_requests_shed_total",
                            "requests refused 503 (overload / draining)")
        self._c_expired = _own("mmlspark_tpu_serving_requests_expired_total",
                               "requests answered 504 past their deadline")
        self._c_failed = _own("mmlspark_tpu_serving_requests_failed_total",
                              "requests answered 500 from a failed "
                              "scoring batch")
        self._g_queue = self.metrics.gauge(
            "mmlspark_tpu_serving_queue_depth",
            "requests parked awaiting scoring",
            labels=("server",)).labels(server=self.server_label)
        # exemplars link each latency bucket to the exact trace that last
        # filled it (OpenMetrics suffix on the _bucket lines) — the fleet
        # aggregator merges them so a fleet p99 resolves to one trace_id
        self.exemplars = bool(exemplars)
        self._h_latency = self.metrics.histogram(
            "mmlspark_tpu_serving_latency_seconds",
            "service latency, enqueue to reply written",
            labels=("server",),
            exemplars=self.exemplars).labels(server=self.server_label)
        # the black box: None stays a one-attribute-check no-op on the hot
        # path; a flight_recorder_dir arms a per-server recorder whose
        # triggered dumps `tools/diagnose.py --postmortem` reassembles
        if recorder is None and flight_recorder_dir:
            from ..observability.recorder import FlightRecorder

            recorder = FlightRecorder(dump_dir=flight_recorder_dir,
                                      process=f"serving-{self.server_label}")
        self.recorder = recorder
        self._c_bucket = self.metrics.counter(
            "mmlspark_tpu_serving_bucket_batches_total",
            "scored batches per bucket-ladder rung",
            labels=("server", "bucket"))
        # hot-path accounting (serve_model's resident fast lane): which
        # route scored each request, how many host<->device round-trips
        # were spent, and how many dispatched batches await readback
        self.hot_path = hot_path
        self._c_path = self.metrics.counter(
            "mmlspark_tpu_serving_path_total",
            "requests scored per hot-path route (resident/native/host)",
            labels=("server", "path"))
        # wire-protocol mix: which framing each accepted request arrived
        # in (json vs the zero-copy binary protocol, io_http/wire.py)
        self._c_proto = self.metrics.counter(
            "mmlspark_tpu_serving_protocol_requests_total",
            "requests received per wire protocol (json/binary)",
            labels=("server", "proto"))
        self._proto_counts = {"json": 0, "binary": 0}
        self._c_round_trips = _own(
            "mmlspark_tpu_serving_host_round_trips_total",
            "host<->device round-trips spent scoring (one per resident "
            "batch; the native route adds none)")
        self._g_readback = self.metrics.gauge(
            "mmlspark_tpu_serving_readback_inflight_depth",
            "resident batches dispatched, reply fetch still pending",
            labels=("server",)).labels(server=self.server_label)
        # declare the process-wide executable-cache and breaker families on
        # this registry so a scrape shows them even before they move
        ensure_cache_metrics(self.metrics)
        _breaker_metrics(self.metrics)
        self._draining = False
        self._counter_lock = make_lock("ServingServer._counter_lock")
        # rolling service latencies (seconds, enqueue -> reply written)
        self._latencies: collections.deque[float] = collections.deque(maxlen=8192)
        # distributed tracing: None resolves the process-default tracer
        # PER REQUEST so tests can swap it after the server started
        self._tracer = tracer
        # readiness (the /readyz contract): with a warmup request the
        # server reports ready only after warmup() has scored every
        # bucket-ladder rung — the executable cache holds every shape the
        # batcher can produce, so steady state is zero-recompile. Extra
        # liveness probes (e.g. the reverse tunnel) hook in via
        # health_probes and surface under /healthz.
        self.warmup_request = warmup_request
        self._warm_rungs: set[int] = set()
        self._warmed = threading.Event()
        self.health_probes: dict[str, Callable[[], Any]] = {}

    # read-only views over the registry children — the historical int
    # attributes, same exact per-server values
    @property
    def requests_seen(self) -> int:
        return int(self._c_seen.value)

    @property
    def requests_accepted(self) -> int:
        return int(self._c_accepted.value)

    @property
    def requests_answered(self) -> int:
        return int(self._c_answered.value)

    @property
    def requests_shed(self) -> int:
        return int(self._c_shed.value)

    @property
    def requests_expired(self) -> int:
        return int(self._c_expired.value)

    @property
    def requests_failed(self) -> int:
        return int(self._c_failed.value)

    def protocol_counts(self) -> dict:
        """Accepted requests per wire protocol (the info() `protocols`
        block diagnose --serving prints as the protocol mix)."""
        with self._counter_lock:
            return dict(self._proto_counts)

    # -- health / readiness --------------------------------------------- #

    def tracer(self):
        if self._tracer is not None:
            return self._tracer
        from ..observability.tracing import get_tracer

        return get_tracer()

    @property
    def ready(self) -> bool:
        """Liveness is /healthz; THIS is /readyz: started, not draining,
        and (when a warmup request is configured) every bucket-ladder rung
        scored once so the executable cache is fully populated."""
        if self._server is None or self._draining:
            return False
        if self.warmup_request is None:
            return True
        if self.bucketer is not None:
            with self._counter_lock:
                return set(self.bucketer.ladder) <= self._warm_rungs
        return self._warmed.is_set()

    def warmup(self, request: "HTTPRequestData | None" = None) -> int:
        """Score `request` once per bucket-ladder rung (one batch without
        a ladder), populating the executable cache so live traffic never
        pays a compile. Runs in a background thread at start() when
        `warmup_request` is set; callable directly for explicit warmup
        (e.g. before a rolling cutover). Returns rungs warmed."""
        req = request if request is not None else self.warmup_request
        if req is None:
            raise ValueError("no warmup request configured or given")
        if self.handler is None:
            raise RuntimeError("warmup scores through the continuous-mode "
                               "handler; batch mode warms via its query")
        rungs = (list(self.bucketer.ladder) if self.bucketer is not None
                 else [1])
        for rung in rungs:
            out = self.handler(Table({"request": [req] * rung}))
            if len(out["reply"]) != rung:
                raise ValueError(
                    f"warmup handler returned {len(out['reply'])} replies "
                    f"for a batch of {rung}")
            if self.hot_path is not None:
                # compile the resident executable for this rung, verify
                # its reply bytes against the handler's, and measure the
                # native-vs-resident crossover that routes live traffic
                self.hot_path.warm_rung(
                    self.handler, req, rung,
                    [r.entity for r in out["reply"]])
            with self._counter_lock:
                self._warm_rungs.add(rung)
        self._warmed.set()
        return len(rungs)

    def _warmup_async(self) -> None:
        try:
            self.warmup()
        except Exception:  # noqa: BLE001 — a failed warmup keeps /readyz 503
            pass

    def health(self) -> dict:
        """The /healthz payload: process-alive facts + extra probe
        results (a failing probe reports its error, never raises)."""
        probes = {}
        for name, fn in list(self.health_probes.items()):
            try:
                probes[name] = fn()
            except Exception as e:  # noqa: BLE001 — probe failure is data
                probes[name] = {"error": str(e)}
        with self._counter_lock:
            warm = sorted(self._warm_rungs)
        return {"status": "ok", "draining": self._draining,
                "ready": self.ready, "pending": self._load(),
                "warm_rungs": warm,
                "probes": probes}

    # ------------------------------------------------------------------ #

    def start(self) -> "ServingServer":
        outer = self

        class Handler(SingleSegmentHandler):
            # HTTP/1.1 keep-alive: one connection (and one server thread)
            # serves a client's whole request stream instead of paying TCP
            # setup + thread spawn per request — the tail-latency source on
            # the continuous path. Requires exact Content-Length on every
            # response (sent below).
            protocol_version = "HTTP/1.1"
            # idle keep-alive connections time out so stop() quiesces:
            # handle_one_request treats a socket timeout as end-of-stream
            # and the per-connection thread exits. This short window applies
            # only BETWEEN requests — do_POST widens it while a request body
            # is in flight, so a slow sender isn't dropped mid-upload.
            timeout = 5.0
            body_timeout = 60.0

            def do_POST(self):  # noqa: N802 — http.server API
                # the idle timeout covered the wait for the request line;
                # reading the body gets the slow-sender grace window, and
                # the finally below restores the idle window for keep-alive
                self.connection.settimeout(self.body_timeout)
                try:
                    path, _, query = self.path.partition("?")
                    if path == "/flightrecorder/dump":
                        self._dump_recorder(query)
                        return
                    self._handle_post()
                finally:
                    self.connection.settimeout(self.timeout)

            def _dump_recorder(self, query: str) -> None:
                # the fleet-wide dump broadcast (ServingFleet.dump_all):
                # a driver-side trigger makes EVERY replica flush its
                # black box while the evidence is still in the ring
                import urllib.parse

                length = int(self.headers.get("Content-Length", 0))
                if length:
                    self.rfile.read(length)
                trigger = urllib.parse.parse_qs(query).get(
                    "trigger", ["remote"])[0]
                rec = outer.recorder
                path = (rec.trigger_dump(trigger, force=True)
                        if rec is not None else None)
                self._reply_json(200, {"dumped": path is not None,
                                       "path": path})

            def _handle_post(self):
                # bind this request into the caller's trace: a client-
                # injected W3C traceparent becomes the parent of the
                # serving.request span, so the merged fleet trace shows
                # client -> gateway -> replica as one tree
                tracer = outer.tracer()
                remote = tracer.extract(self.headers.get("traceparent"))
                with tracer.start_span("serving.request", parent=remote,
                                       path=self.path,
                                       server=outer.server_label) as span:
                    self._serve_post(span)

            def _serve_post(self, span):
                outer._c_seen.inc()
                if self.headers.get("Transfer-Encoding"):
                    # chunked bodies aren't framed by Content-Length; reading
                    # them wrong would desync the keep-alive stream — refuse
                    # and drop the connection (411 Length Required)
                    self.send_response(411)
                    self.send_header("Content-Length", "0")
                    self.send_header("Connection", "close")
                    self.end_headers()
                    self.close_connection = True
                    return
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length) if length else b""
                # admission control BEFORE parking: draining servers and
                # full queues shed with 503 + Retry-After (the bounded-
                # queue contract) instead of queueing without bound and
                # timing everyone out later. The body was already read so
                # the keep-alive stream stays framed.
                if outer._draining or (
                        outer.max_pending and
                        outer._load() >= outer.max_pending):
                    outer._c_shed.inc()
                    if outer.recorder is not None:
                        outer.recorder.note_shed()
                    span.set(status=503)
                    self.send_response(503)
                    self.send_header("Retry-After", "1")
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                outer._c_accepted.inc()
                proto = ("binary" if is_wire_content_type(
                    self.headers.get("Content-Type")) else "json")
                outer._c_proto.labels(server=outer.server_label,
                                      proto=proto).inc()
                with outer._counter_lock:
                    outer._proto_counts[proto] += 1
                now = time.perf_counter()
                ex = _Exchange(HTTPRequestData(
                    method="POST", url=self.path,
                    headers=dict(self.headers), entity=body,
                ), enqueued_at=now,
                    deadline=(now + outer.request_deadline_s
                              if outer.request_deadline_s is not None
                              else None),
                    span=span)
                ex_id = None
                if outer.mode == "batch":
                    ex_id = str(next(outer._id_counter))
                    # journal BEFORE parking: a journaled reply always has
                    # its accept record on disk first
                    if outer.journal is not None:
                        outer.journal.record_accept(ex_id, ex.request)
                    with outer._counter_lock:
                        outer._pending[ex_id] = ex
                else:
                    outer._queue.put(ex)
                    outer._g_queue.set(outer._load())
                wait_s = outer.reply_timeout_s
                if outer.request_deadline_s is not None:
                    wait_s = min(wait_s, outer.request_deadline_s)
                if not ex.event.wait(wait_s):
                    if ex_id is not None and outer.journal is None:
                        # dead client: stop re-serving it via get_batch().
                        # With a journal the request is DATA in the stream
                        # (accepted = must be processed): it stays parked,
                        # its reply lands in the journal even though this
                        # connection gets a 504.
                        with outer._counter_lock:
                            outer._pending.pop(ex_id, None)
                    outer._c_expired.inc()
                    if outer.recorder is not None:
                        outer.recorder.note_expired()
                    span.set(status=504)
                    self.send_response(504)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                resp = ex.response or HTTPResponseData(500, "no response")
                resp = _negotiate_reply(resp, ex.request)
                span.set(status=resp.status_code or 500)
                self.send_response(resp.status_code or 500)
                entity = resp.entity or b""
                for k, v in resp.headers.items():
                    # forwarded upstream responses can carry stale framing /
                    # hop-by-hop headers (clients.py de-chunks entities but
                    # keeps the original header dict); only the ACTUAL
                    # entity length keeps the keep-alive stream framed
                    if k.lower() not in ("content-length", "transfer-encoding",
                                         "connection", "keep-alive"):
                        self.send_header(k, v)
                self.send_header("Content-Length", str(len(entity)))
                self.end_headers()
                if entity:
                    self.wfile.write(entity)
                elapsed = time.perf_counter() - ex.enqueued_at
                outer._c_answered.inc()
                outer._h_latency.observe(elapsed,
                                         exemplar=outer._exemplar_for(ex, span))
                rec = outer.recorder
                if rec is not None:
                    rec.record_request(
                        trace_id=format(getattr(span, "trace_id", 0), "032x"),
                        route=ex.route or "", bucket=ex.bucket,
                        queue_depth=outer._load(), latency_s=elapsed,
                        status=resp.status_code or 500,
                        readback_lag=ex.readback_lag)
                    rec.maybe_tick(outer.metrics)
                with outer._counter_lock:
                    outer._latencies.append(elapsed)

            def _reply_json(self, status: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 — health/info + /metrics
                # Prometheus scrape surface; every other path keeps the
                # info JSON (FleetRendezvous polls GET / per replica)
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    body = outer.metrics.render_prometheus().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if path == "/healthz":
                    # liveness: answering at all IS the signal — 200 even
                    # while draining (restarting a draining server would
                    # drop the very requests the drain protects)
                    self._reply_json(200, outer.health())
                    return
                if path == "/readyz":
                    # readiness: load balancers route only to 200
                    ready = outer.ready
                    with outer._counter_lock:
                        warm = sorted(outer._warm_rungs)
                    self._reply_json(200 if ready else 503, {
                        "ready": ready, "draining": outer._draining,
                        "warm_rungs": warm,
                        "ladder": (list(outer.bucketer.ladder)
                                   if outer.bucketer is not None else None),
                    })
                    return
                # process-wide executable-cache counters: steady-state
                # recompiles staying flat is the bucket ladder working
                exe = cache_stats()
                info = json.dumps({
                    "name": "mmlspark_tpu.serving",
                    "host": outer.host, "port": outer.port,
                    "mode": outer.mode,
                    "seen": outer.requests_seen,
                    "answered": outer.requests_answered,
                    "shed": outer.requests_shed,
                    "expired": outer.requests_expired,
                    "failed": outer.requests_failed,
                    "ready": outer.ready,
                    "executable_cache_hits": exe["hits"],
                    "executable_cache_misses": exe["misses"],
                    "executable_cache_recompiles": exe["recompiles"],
                    # wall-clock seconds spent inside builders, process-
                    # wide + the slowest (family, shape) entries of the
                    # hot path's own cache — where startup time went
                    "compile_seconds_total": round(
                        exe.get("compile_seconds", 0.0), 6),
                    "compile_ledger": (
                        outer.hot_path.executor.segment
                        ._exec_cache.compile_ledger(top=8)
                        if outer.hot_path is not None else None),
                    "bucket_ladder": (list(outer.bucketer.ladder)
                                      if outer.bucketer is not None
                                      else [outer.max_batch_size]),
                    "latency": outer.latency_stats(),
                    "protocols": outer.protocol_counts(),
                    "hot_path": (outer.hot_path.snapshot()
                                 if outer.hot_path is not None else None),
                    "profiler": outer._profiler_info(),
                }).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(info)))
                self.end_headers()
                self.wfile.write(info)

            def log_message(self, *a):  # silence per-request stderr noise
                pass

        self._server = _DeepBacklogServer((self.host, self.port), Handler)
        self.port = self._server.server_address[1]
        st = threading.Thread(target=self._server.serve_forever, daemon=True)
        st.start()
        self._threads = [st]
        if self.mode == "continuous":
            bt = threading.Thread(target=self._batch_loop, daemon=True)
            bt.start()
            self._threads.append(bt)
            if self.warmup_request is not None:
                wt = threading.Thread(target=self._warmup_async, daemon=True)
                wt.start()
                self._threads.append(wt)
        return self

    def _load(self) -> int:
        """Requests parked and not yet answered — the shed/drain signal."""
        if self.mode == "batch":
            with self._counter_lock:
                return len(self._pending)
        return self._queue.qsize()

    def stop(self, drain: "bool | None" = None) -> None:
        """Graceful by default on the continuous path: new requests shed
        with 503 while the batcher finishes what was already admitted
        (up to drain_timeout_s), THEN the loops stop — in-flight clients
        get answers instead of resets. drain=False skips the wait."""
        self._draining = True
        if drain is None:
            drain = self.mode == "continuous"
        if drain and self.mode == "continuous" and self._server is not None:
            deadline = time.monotonic() + self.drain_timeout_s
            while self._load() > 0 and time.monotonic() < deadline:
                time.sleep(0.005)
        self._stop.set()
        if self._server:
            self._server.shutdown()
            self._server.server_close()
        while self._stop_hooks:
            self._stop_hooks.pop(0)()
        if self.journal is not None:
            self.journal.close()
        if self.recorder is not None:
            try:
                self.recorder.trigger_dump("drain", force=True)
            except Exception:
                pass

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}{self.api_path}"

    def _exemplar_for(self, ex: "_Exchange", span) -> "dict | None":
        """The OpenMetrics exemplar for one answered request: trace_id is
        the join key (postmortem + fleet merge resolve it to the exact
        trace), route/bucket/readback_lag say WHICH lane served it."""
        if not self.exemplars:
            return None
        trace_id = getattr(span, "trace_id", 0)
        if not trace_id and ex.route is None:
            return None
        labels: dict[str, str] = {}
        if trace_id:
            labels["trace_id"] = format(trace_id, "032x")
        if ex.route:
            labels["route"] = ex.route
        if ex.bucket is not None:
            labels["bucket"] = str(ex.bucket)
        if ex.readback_lag is not None:
            labels["readback_lag"] = str(ex.readback_lag)
        return labels or None

    def latency_stats(self) -> dict[str, float]:
        """p50/p99 service latency (ms) over the rolling window — the measured
        version of the reference's ~1 ms continuous-mode claim
        (docs/mmlspark-serving.md:10-11)."""
        with self._counter_lock:
            lat = list(self._latencies)
        if not lat:
            return {"n": 0, "p50_ms": float("nan"), "p99_ms": float("nan")}
        arr = np.asarray(lat) * 1e3
        return {
            "n": len(arr),
            "p50_ms": float(np.percentile(arr, 50)),
            "p99_ms": float(np.percentile(arr, 99)),
        }

    def _profiler_info(self) -> dict:
        """The info() `profiler` block: the process profiler's phase
        attribution. Fail-soft so a broken profiler can never break
        GET /."""
        try:
            from ..observability.profiler import get_profiler

            return get_profiler().snapshot()
        except Exception:  # noqa: BLE001 — info must always answer
            return {"enabled": False, "ledgers": 0, "attribution": []}

    def reset_latency_stats(self) -> None:
        """Clear the rolling latency window (e.g. after warm-up requests)."""
        with self._counter_lock:
            self._latencies.clear()

    # -- batch ("micro-batch source") mode ------------------------------- #

    def get_batch(self, max_rows: int | None = None) -> Table:
        """Drain pending requests into a Table with `id` + `request` columns
        (reference `HTTPSource.getBatch`, HTTPSource.scala:46-225). The
        caller scores the table and completes the requests with `reply`."""
        if self.mode != "batch":
            raise RuntimeError("get_batch() is only available in batch mode")
        with self._counter_lock:
            # journaled requests are stream DATA (accepted = must be
            # processed) and never expire; without a journal an expired
            # exchange answers 504 and leaves the replay set
            if self.request_deadline_s is not None and self.journal is None:
                now = time.perf_counter()
                for ex_id in [i for i, ex in self._pending.items()
                              if ex.deadline is not None
                              and now > ex.deadline]:
                    ex = self._pending.pop(ex_id)
                    ex.response = HTTPResponseData(
                        504, "deadline exceeded before scoring")
                    ex.event.set()
                    self._c_expired.inc()
            ids = list(self._pending)
            if max_rows is not None:
                ids = ids[:max_rows]
            requests = [self._pending[i].request for i in ids]
        return Table({"id": ids, "request": requests})

    def reply(self, ids: list[str], responses: list[HTTPResponseData],
              record: bool = True) -> None:
        """Complete batch-mode requests by id (reference `HTTPSink` keyed by
        (name, partitionId, requestId), HTTPSourceV2.scala:421-476).

        record=False answers live clients WITHOUT journaling the reply as
        the request's final answer — the transient-failure path: a 500 for
        a failed batch must leave the request in the durable replay set
        (the reference's failed micro-batch reruns after restart)."""
        if self.mode != "batch":
            raise RuntimeError("reply() is only available in batch mode")
        if len(ids) != len(responses):
            raise ValueError(
                f"{len(responses)} responses for {len(ids)} request ids — "
                "repliers must answer every drained request"
            )
        for ex_id, resp in zip(ids, responses):
            ex_id = str(ex_id)
            if self.journal is not None:
                if self.journal.replied(ex_id):
                    # already answered durably (e.g. a batch raced a
                    # restart's replay): exactly-once drops the duplicate
                    with self._counter_lock:
                        self._pending.pop(ex_id, None)
                    continue
                if record:
                    self.journal.record_reply(ex_id, resp)
            with self._counter_lock:
                ex = self._pending.pop(ex_id, None)
            if ex is not None:
                ex.response = resp
                ex.event.set()

    def reply_table(self, table: Table) -> None:
        """reply() over a Table holding `id` + `reply` columns (the shape
        `make_reply` produces when the `id` column is carried through)."""
        self.reply(list(table["id"]), list(table["reply"]))

    # ------------------------------------------------------------------ #

    def _batch_loop(self) -> None:
        hp = self.hot_path
        # lag-1 overlapped readback: a resident batch's reply fetch is
        # deferred until the NEXT batch has been dispatched (or the queue
        # goes idle), so reply serialization of batch N runs while the
        # device computes batch N+1 — dispatch never blocks on readback
        readback = (AsyncReadback(self._complete_resident,
                                  lag=hp.readback_lag)
                    if hp is not None else None)
        while not self._stop.is_set():
            if (readback is not None and readback.pending
                    and self._queue.empty()):
                # nothing queued: force pending replies out NOW instead of
                # holding them for a next batch that may never come — the
                # overlap window is only ever other requests' compute
                readback.drain()
                self._g_readback.set(0)
                continue
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            # Everything already queued joins the batch at zero latency
            # cost; batching happens naturally through backpressure —
            # requests arriving while the handler scores batch N drain
            # into batch N+1. max_latency_ms (default 0) is an OPT-IN
            # collection window for device-efficiency tuning: it adds its
            # full length to p50 at low concurrency (measured 1.00 ->
            # 0.59 ms server p50 when the old 0.2 ms window was removed).
            deadline = time.monotonic() + self.max_latency_ms / 1e3
            while len(batch) < self.max_batch_size:
                try:
                    # timeout=0 == non-blocking get, so past the deadline
                    # (always, when the window is 0) this drains whatever
                    # is queued and stops at the first Empty
                    batch.append(self._queue.get(
                        timeout=max(deadline - time.monotonic(), 0)))
                except queue.Empty:
                    break
            # expired exchanges answer 504 HERE and never occupy a batch
            # slot — scoring them would waste device time on a reply the
            # client already gave up on (its wait is capped by the same
            # deadline)
            now = time.perf_counter()
            expired = [ex for ex in batch
                       if ex.deadline is not None and now > ex.deadline]
            if expired:
                self._c_expired.inc(len(expired))
                if self.recorder is not None:
                    for _ in expired:
                        self.recorder.note_expired()
                for ex in expired:
                    ex.response = HTTPResponseData(
                        504, "deadline exceeded before scoring")
                    ex.event.set()
                batch = [ex for ex in batch
                         if ex.deadline is None or now <= ex.deadline]
                if not batch:
                    continue
            self._g_queue.set(self._load())
            # stamped BEFORE scoring (and re-stamped on each fallback) so
            # the handler thread — which may complete the exchange the
            # moment scoring sets its event — always reads the final
            # route/bucket into the latency exemplar
            target = (self.bucketer.bucket_for(len(batch))
                      if self.bucketer is not None else len(batch))
            route = "host"
            if hp is not None:
                route = hp.route_for(target)
                self._stamp_route(batch, route, target)
                if route == hp.resident_label and not self._score_resident(
                        batch, target, readback):
                    # batch outside the cached schema or the device
                    # precondition — the native walk is exact for ANY
                    # float64 payload, so it catches what resident can't
                    route = "native" if hp.native_fn is not None else "host"
                    self._stamp_route(batch, route, target)
                if route == "native" and not self._score_native(batch):
                    route = "host"
                    self._stamp_route(batch, route, target)
            else:
                self._stamp_route(batch, route, target)
            if route == "host":
                self._score_batch(batch)
            if hp is not None:
                hp.note(route, len(batch))
                self._c_path.labels(server=self.server_label,
                                    path=route).inc(len(batch))
        if readback is not None:
            readback.drain()

    @staticmethod
    def _stamp_route(batch: "list[_Exchange]", route: str,
                     bucket: int) -> None:
        for ex in batch:
            ex.route, ex.bucket = route, bucket

    def _score_resident(self, batch: "list[_Exchange]", target: int,
                        readback: AsyncReadback) -> bool:
        """Decode + upload + launch one batch on the resident executor;
        replies complete through the readback window (see _batch_loop).
        False = the batch fell outside the cached schema and the caller
        must re-route it to the handler path."""
        hp = self.hot_path
        t_score = time.perf_counter()
        feats = hp.decoder.decode([ex.request for ex in batch], target)
        if feats is None:
            return False
        if hp.value_check(feats):
            # non-empty reason (e.g. floats not f32-representable): this
            # batch cannot run resident byte-identically.  Schema checks
            # were hoisted to warmup — only value-dependent hooks run here
            return False
        self._c_bucket.labels(server=self.server_label,
                              bucket=str(target)).inc()
        # the ledger opens only after the batch is committed to this
        # route (a declined batch would leave an uncommitted ledger);
        # the decode above IS the prepare phase, timed retroactively
        ledger = _prof_ledger(
            "request", hp.resident_label,
            span=batch[0].span if len(batch) == 1 else None,
            server=self.server_label, bucket=target)
        if ledger.armed:
            ledger.add("queue", max(t_score - batch[0].enqueued_at, 0.0))
            ledger.add("prepare", time.perf_counter() - t_score)
            ledger.note_pad(len(batch), target)
        try:
            outs = hp.executor.dispatch({hp.feature_col: feats},
                                        ledger=ledger)
        except Exception as e:  # noqa: BLE001 — batch failure -> 500s
            self._c_failed.inc(len(batch))
            for ex in batch:
                ex.response = _handler_error_response(e)
                ex.event.set()
            return True
        hp.note_resident_batch()
        self._c_round_trips.inc()
        readback.push((outs, batch, ledger, time.perf_counter()))
        depth = readback.pending
        for ex in batch:
            ex.readback_lag = depth
        self._g_readback.set(depth)
        with self._counter_lock:
            self._warm_rungs.add(target)
        return True

    def _complete_resident(self, item) -> None:
        """AsyncReadback's fetch callback: block on one in-flight batch's
        device results and write every exchange's reply. The dispatch ->
        drain gap is the lag-N readback hold — attributed to `queue`
        alongside the input wait, so the attribution table shows the
        latency the overlap window costs each request."""
        outs, batch, ledger, t_dispatched = item
        hp = self.hot_path
        if ledger.armed:
            ledger.add("queue",
                       max(time.perf_counter() - t_dispatched, 0.0))
        try:
            vals = hp.fetch_values(outs, len(batch), ledger=ledger)
            # reply materialization is host readback work too — without
            # it the phase sum can't explain the measured RTT
            with ledger.phase("d2h"):
                replies = hp.replies_for(
                    vals, binary_mask=[accepts_wire(ex.request.headers)
                                       for ex in batch])
        except Exception as e:  # noqa: BLE001 — batch failure -> 500s
            self._c_failed.inc(len(batch))
            replies = [_handler_error_response(e)] * len(batch)
        for ex, resp in zip(batch, replies):
            ex.response = resp
            ex.event.set()
        if ledger.armed:
            # server-side RTT for the batch's oldest request: enqueue ->
            # replies written (the 15% phase-coverage bar in diagnose)
            ledger.done(
                rtt_s=time.perf_counter() - batch[0].enqueued_at)

    def _score_native(self, batch: "list[_Exchange]") -> bool:
        """Score synchronously on the native C++ tree walk — zero
        host<->device round-trips, no padding (nothing compiles, so
        ragged sizes cost nothing); the small-batch side of the
        crossover. False = re-route to the handler path."""
        hp = self.hot_path
        t_score = time.perf_counter()
        feats = hp.decoder.decode([ex.request for ex in batch])
        if feats is None:
            return False
        ledger = _prof_ledger("request", "native",
                              server=self.server_label)
        if ledger.armed:
            ledger.add("queue", max(t_score - batch[0].enqueued_at, 0.0))
            ledger.add("prepare", time.perf_counter() - t_score)
        try:
            with ledger.phase("compute"):
                replies = hp.replies_for(
                    hp.native_values(feats),
                    binary_mask=[accepts_wire(ex.request.headers)
                                 for ex in batch])
        except Exception as e:  # noqa: BLE001 — batch failure -> 500s
            self._c_failed.inc(len(batch))
            replies = [_handler_error_response(e)] * len(batch)
        for ex, resp in zip(batch, replies):
            ex.response = resp
            ex.event.set()
        if ledger.armed:
            ledger.done(
                rtt_s=time.perf_counter() - batch[0].enqueued_at)
        return True

    def _score_batch(self, batch: "list[_Exchange]") -> None:
        """The handler path: pad to the bucket rung, score through
        `self.handler`, reply — serve_model's pre-hot-path behavior and
        the fallback every other route degrades to."""
        # a single-exchange batch scores INSIDE that request's span,
        # so a proxying handler's outbound http_send propagates the
        # same trace downstream (client -> gateway -> replica); multi-
        # request batches fan in, so serving.score stands alone
        tracer = self.tracer()
        parent = batch[0].span if len(batch) == 1 else None
        if parent is not None and not getattr(parent, "span_id", 0):
            parent = None
        t_score = time.perf_counter()
        with tracer.start_span("serving.score", parent=parent,
                               batch_rows=len(batch)) as sspan:
            ledger = _prof_ledger("request", "host", span=sspan,
                                  server=self.server_label)
            if ledger.armed:
                ledger.add("queue",
                           max(t_score - batch[0].enqueued_at, 0.0))
            target = None
            try:
                requests = [ex.request for ex in batch]
                if self.bucketer is not None:
                    target = self.bucketer.bucket_for(len(requests))
                    self._c_bucket.labels(
                        server=self.server_label,
                        bucket=str(target)).inc()
                    with ledger.phase("pad"):
                        requests = requests + \
                            [requests[-1]] * (target - len(requests))
                    ledger.note_pad(len(batch), target)
                table = Table({"request": requests})
                # the handler path scores host-side (or through its own
                # fused transform): the whole call is its compute phase
                with ledger.phase("compute"):
                    out = self.handler(table)
                replies = out["reply"]
                if len(replies) != len(requests):
                    raise ValueError(
                        f"handler returned {len(replies)} replies for a "
                        f"batch of {len(requests)} requests — handlers "
                        "must preserve row count and order"
                    )
                replies = list(replies)[:len(batch)]
                if target is not None:
                    # this rung's executable is compiled now — the
                    # readiness signal warmup() drives deliberately
                    with self._counter_lock:
                        self._warm_rungs.add(target)
            except Exception as e:  # noqa: BLE001 — batch failure -> 500s
                self._c_failed.inc(len(batch))
                sspan.set(error=str(e))
                replies = [_handler_error_response(e)] * len(batch)
        for ex, resp in zip(batch, replies):
            ex.response = resp
            ex.event.set()
        if ledger.armed:
            ledger.done(rtt_s=time.perf_counter() - batch[0].enqueued_at)


class MicroBatchQuery:
    """Streaming micro-batch engine for a batch-mode ServingServer — the
    role of Spark's streaming query over `readStream.server()` (the
    reference's HTTPSource getOffset/getBatch/commit tick loop,
    HTTPSource.scala:46-225; query lifecycle = start/stop/awaitTermination).

    Each tick drains pending requests (`get_batch`), runs `handler`
    (Table{id, request} -> Table{id, reply}), and completes the exchanges
    (`reply_table`). Handler errors 500 the affected batch instead of
    killing the query; `exception` records the last one.
    """

    def __init__(self, server: "ServingServer",
                 handler: Callable[[Table], Table],
                 trigger_interval_s: float = 0.05,
                 max_rows_per_batch: int | None = None,
                 compact_every_batches: int = 64):
        if server.mode != "batch":
            raise ValueError("MicroBatchQuery drives a mode='batch' server")
        self.server = server
        self.handler = handler
        self.trigger_interval_s = trigger_interval_s
        self.max_rows_per_batch = max_rows_per_batch
        # journal commit-trimming cadence (reference commit(),
        # DistributedHTTPSource.scala:308-343); 0 disables
        self.compact_every_batches = compact_every_batches
        self.batches_processed = 0
        self.rows_processed = 0
        self.exception: Exception | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "MicroBatchQuery":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            batch = self.server.get_batch(self.max_rows_per_batch)
            if len(batch) == 0:
                self._stop.wait(self.trigger_interval_s)
                continue
            ids = list(batch["id"])
            try:
                out = self.handler(batch)
                out_ids = [str(i) for i in out["id"]]
                if sorted(out_ids) != sorted(str(i) for i in ids):
                    # a partial/mismatched answer would leave requests
                    # parked and re-served every tick (same contract as the
                    # continuous loop's replies-per-batch guard)
                    raise ValueError(
                        f"handler answered {len(out_ids)} of {len(ids)} "
                        "drained requests — it must reply to every id"
                    )
                self.server.reply(out_ids, list(out["reply"]))
            except Exception as e:  # noqa: BLE001 — batch fails, query lives
                self.exception = e
                self.server._c_failed.inc(len(ids))
                # record=False: live clients get the 500, but the journal
                # keeps these requests UNANSWERED so a restart replays them
                # (transient failures must not commit as final answers)
                self.server.reply(
                    ids, [_handler_error_response(e)] * len(ids), record=False
                )
                if self.server.journal is not None:
                    # re-park the failed batch so THIS query retries it on a
                    # later tick (the clients already got their 500s; the
                    # retried replies land in the journal only) — without
                    # this, accepted-but-failed requests would wait for a
                    # full process restart even though the query recovered
                    reqs = list(batch["request"])
                    with self.server._counter_lock:
                        for ex_id, req in zip(ids, reqs):
                            ex_id = str(ex_id)
                            if not self.server.journal.replied(ex_id):
                                self.server._pending.setdefault(
                                    ex_id, _Exchange(req)
                                )
                    # breathe between retries of a failing handler instead
                    # of spinning the tick loop hot
                    self._stop.wait(self.trigger_interval_s)
            self.batches_processed += 1
            self.rows_processed += len(ids)
            if (self.server.journal is not None
                    and self.compact_every_batches
                    and self.batches_processed % self.compact_every_batches == 0):
                self.server.journal.compact()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def await_termination(self, timeout_s: float | None = None) -> bool:
        """Block until stop() (or timeout). Mirrors the reference query's
        awaitTermination; returns True if the query terminated."""
        if self._thread is None:
            return True
        self._thread.join(timeout_s)
        return not self._thread.is_alive()


def _build_hot_path(model, decoder: RequestDecoder,
                    output_col: str) -> "_HotPath | None":
    """serve_model's resident fast lane over `model`, or None when the
    model cannot host one (multi-segment plan, host-only stages, feature
    column mismatch) — the handler path then serves everything,
    unchanged."""
    try:
        rex = model.resident_executor()
    except Exception:  # noqa: BLE001 — the fast lane is strictly optional
        return None
    if isinstance(rex, str):
        return None
    if rex.upload_cols != ("features",) or output_col not in rex.download_cols:
        return None
    # the native tree walk can substitute for the WHOLE segment only when
    # the segment is exactly one stage exposing a host scorer
    native_fn = None
    stages = list(model.get("stages") or [])
    if len(stages) == 1:
        get_fn = getattr(stages[0], "native_score_fn", None)
        fn = get_fn() if callable(get_fn) else None
        if callable(fn):
            native_fn = fn
    # the hot path inherits the model's dispatch-pipeline window when one
    # is set (pipeline_depth generalizes readback_lag: same lag-K fetch,
    # framed as the bounded in-flight dispatch count)
    lag = model.get("pipeline_depth")
    if lag is None:
        lag = model.get("readback_lag")
    return _HotPath(rex, decoder, "features", output_col,
                    native_fn=native_fn, readback_lag=lag)


def serve_model(
    model,
    input_cols: "list[str] | None" = None,
    output_col: str = "prediction",
    host: str = "127.0.0.1",
    port: int = 0,
    fuse_pipeline: bool = True,
    mesh=None,
    hot_path: bool = True,
    device: str = "cuda",
    **server_kw,
) -> "ServingServer | dict":
    """Deploy a fitted Transformer: JSON body {col: value, ...} in,
    {output_col: value} out (the `SparkServing - Deploying a Classifier`
    notebook flow).

    PipelineModel handlers score through the whole-pipeline fusion path
    (core/fusion.py) automatically: adjacent device-capable stages run as
    one composition per request batch. `fuse_pipeline=False` keeps the
    stage-by-stage path. With `mesh` (a parallel.mesh mesh of several
    ranks, one process a rank) every rank of the mesh calls serve_model:
    shard 0 runs the server and returns it, and each request batch scores
    data-parallel, every rank its block of the rows (every bucket rung a
    multiple of the data axis); every other rank follows shard 0's fused
    runs and returns only when shard 0's server stops, with the counts of
    what it did (`FusedPipelineModel._follow`).

    `hot_path=True` (default) additionally pins a fully-fused model's
    params on device ONCE and routes live batches between the resident
    executor and the native tree walk per the bucket crossover measured
    at warmup — byte-identical replies with no per-request re-staging.
    It silently stays on the handler path whenever the model cannot host
    a resident session.

    `device` is the torch device the fused segments run on ("cuda": CUDA
    graphs over static buffers, one per ladder rung; "cpu": the same
    composition eagerly); a model that is already a `FusedPipelineModel`
    keeps its own `device` Param.

    A fitted `SARModel` delegates to `recommendation.resident
    .serve_recommender` — same warmup/byte-identity/readback contract,
    top-k reply schema (`input_cols`/`output_col` are implied by the
    model and ignored)."""
    from ..core.fusion import FusedPipelineModel
    from ..core.pipeline import PipelineModel
    from ..recommendation.sar import SARModel

    if isinstance(model, SARModel):
        from ..recommendation.resident import serve_recommender

        return serve_recommender(model, host=host, port=port, mesh=mesh,
                                 hot_path=hot_path, device=device, **server_kw)

    if input_cols is None:
        raise TypeError("serve_model requires input_cols for this model")

    if (fuse_pipeline and isinstance(model, PipelineModel)
            and not isinstance(model, FusedPipelineModel)):
        from ..core.fusion import fuse

        model = fuse(model, mesh=mesh, device=device)
    elif mesh is not None and isinstance(model, FusedPipelineModel):
        model.set_mesh(mesh)

    hp_model = None
    if hot_path and fuse_pipeline:
        hp_model = model
        if (not isinstance(model, PipelineModel)
                and hasattr(model, "device_kernel")):
            # a bare device-capable transformer (e.g. a fitted GBDT model)
            # hosts a resident session through a single-stage fused wrap;
            # the handler keeps scoring through the original model —
            # warmup verifies the two produce the same reply bytes
            from ..core.fusion import fuse

            try:
                hp_model = fuse(PipelineModel([model]), mesh=mesh, device=device)
            except Exception:  # noqa: BLE001 — fast lane is optional
                hp_model = None
    from ..core.fusion import _on_mesh

    led = _on_mesh(model, hp_model)
    if led is not None and led._effective_mesh().shard_index != 0:
        return led._follow()

    # one decoder serves the handler fast path AND the hot-path routes,
    # so the cached schema and its hit/fallback counts stay unified
    decoder = RequestDecoder(input_cols)
    hp = None
    if led is not None:
        # before the hot path: its resident executor leads through it
        led._open_lead()
    if isinstance(hp_model, FusedPipelineModel):
        hp = _build_hot_path(hp_model, decoder, output_col)

    def handler(table: Table) -> Table:
        reqs = list(table["request"])
        # the fast assembly is safe exactly when a resident session could
        # be built: that proves the model consumes the single "features"
        # column (a model reading per-field columns needs parse_request)
        feats = decoder.decode(reqs) if hp is not None else None
        if feats is not None:
            # fast assembly: one preallocated matrix straight from the
            # request bytes — parse_request's per-request dtype
            # re-inference and the per-column stack re-copy are both gone
            scored = model.transform(
                Table({"request": reqs, "features": feats}))
            return make_reply(scored, output_col)
        t = parse_request(table)
        missing = [c for c in input_cols if c not in t]
        if missing:
            raise ValueError(f"request missing fields {missing}")
        if "features" not in t and all(
            isinstance(t[c], np.ndarray) for c in input_cols
        ):
            feats = np.stack([np.asarray(t[c], np.float64) for c in input_cols], 1)
            t = t.with_column("features", feats)
        scored = model.transform(t)
        return make_reply(scored, output_col)

    # scoring is pure per-row, so batch-size bucketing is safe here and
    # keeps the jitted model's compiled-shape set closed
    server_kw.setdefault("bucket_batches", True)
    if hp is not None:
        # sharded resident dispatch needs every ladder rung divisible by
        # the mesh data axis; single-device this is 1 (no-op)
        server_kw.setdefault("bucket_multiple_of", hp.executor.data_axis_size)
    return _start_leading(led, lambda: ServingServer(handler, host=host, port=port,
                                                     hot_path=hp, **server_kw))


def _start_leading(led, make_server) -> "ServingServer":
    """Build and start a server; with `led` (a fused model on shard 0 of
    a mesh of several ranks, its lead open) the followers stop when the
    server does, or at once when the server fails to start."""
    if led is None:
        return make_server().start()
    try:
        srv = make_server()
        srv._stop_hooks.append(led._close_lead)
        return srv.start()
    except BaseException:
        led._close_lead()
        raise


@dataclass
class ServiceInfo:
    """One serving replica's coordinates — the reference's
    `ServiceInfo{name, host, port, partitionId, localIp, publicIp}`
    collected by the driver rendezvous service (HTTPSourceV2.scala:118-165).

    `public_host`/`public_port` are the NAT-traversing coordinates when a
    reverse tunnel is attached (io_http.forwarding — the reference's
    PortForwarding path); clients outside the boundary route there, the
    rendezvous keeps polling the direct host:port."""

    name: str
    host: str
    port: int
    partition_id: int
    pid: int
    local_ip: str | None = None
    public_host: str | None = None
    public_port: int | None = None

    def to_dict(self) -> dict:
        return {"name": self.name, "host": self.host, "port": self.port,
                "partition_id": self.partition_id, "pid": self.pid,
                "local_ip": self.local_ip, "public_host": self.public_host,
                "public_port": self.public_port}

    @staticmethod
    def from_dict(d: dict) -> "ServiceInfo":
        pub_port = d.get("public_port")
        return ServiceInfo(name=d["name"], host=d["host"], port=int(d["port"]),
                           partition_id=int(d["partition_id"]),
                           pid=int(d.get("pid", 0)),
                           local_ip=d.get("local_ip"),
                           public_host=d.get("public_host"),
                           public_port=(int(pub_port)
                                        if pub_port is not None else None))


# the serving counter families the rendezvous reads out of scrapes
_SEEN = "mmlspark_tpu_serving_requests_seen_total"
_ANSWERED = "mmlspark_tpu_serving_requests_answered_total"
_LATENCY = "mmlspark_tpu_serving_latency_seconds"


class FleetRendezvous:
    """Driver-side rendezvous + fleet-state aggregator.

    Reference: continuous mode runs an HTTP service ON THE DRIVER that
    collects each partition reader's ServiceInfo and exposes the routing
    table (HTTPSourceV2.scala:118-165). Here:

      POST /register      — a replica announces its ServiceInfo at startup
      POST /metrics/push  — a draining replica flushes its final counters
      GET  /services      — the raw registry
      GET  /info          — LIVE aggregate: scrapes every replica's
                            /metrics through the MetricsAggregator and
                            reads counters/latency out of it (replicas
                            that fail to answer are reported unreachable,
                            not dropped silently)
      GET  /metrics       — the fleet-wide exposition: per-replica samples
                            under a `replica` label + merged samples under
                            replica="fleet" (+ SLO series when an engine
                            is attached via attach_slo)
      GET  /healthz       — fleet health: per-replica alive/ready

    `info()` and `/metrics` read the SAME aggregator state, so the JSON
    totals and the exposition's fleet-merged counters cannot disagree.
    """

    def __init__(self, name: str = "fleet", host: str = "127.0.0.1",
                 port: int = 0, clock: Any = None,
                 stale_after_s: float = 10.0):
        from ..observability.fleet import MetricsAggregator

        self.name = name
        self.host, self.port = host, port
        self._services: dict[int, ServiceInfo] = {}
        self._lock = make_lock("FleetRendezvous._lock")
        self._server: ThreadingHTTPServer | None = None
        self.aggregator = MetricsAggregator(
            urls=self._metric_urls, clock=clock,
            stale_after_s=stale_after_s)
        self.slo_engine = None

    def _metric_urls(self) -> dict[str, str]:
        return {str(s.partition_id): f"http://{s.host}:{s.port}/metrics"
                for s in self.services()}

    def attach_slo(self, engine) -> None:
        """Serve an SLOEngine's series from `/metrics` (it is evaluated on
        every scrape). Point the engine's `source` at `self.aggregator` so
        SLO math reads the same merged series the exposition shows."""
        self.slo_engine = engine

    # -- aggregate ------------------------------------------------------ #

    def services(self) -> list[ServiceInfo]:
        with self._lock:
            return [self._services[k] for k in sorted(self._services)]

    def register(self, info: ServiceInfo) -> None:
        with self._lock:
            self._services[info.partition_id] = info

    def _replica_latency(self, rid: str) -> dict:
        """p50/p99 (ms) estimated from the replica's scraped latency
        histogram — shaped like ServingServer.latency_stats()."""
        from ..observability.slo import SeriesReader

        reader = SeriesReader(self.aggregator.replica_snapshot(rid))
        h = reader.histogram(_LATENCY)
        n = int(h["count"])
        if n == 0:
            return {"n": 0, "p50_ms": float("nan"), "p99_ms": float("nan")}
        return {"n": n,
                "p50_ms": reader.histogram_quantile(_LATENCY, 0.5) * 1e3,
                "p99_ms": reader.histogram_quantile(_LATENCY, 0.99) * 1e3}

    def info(self) -> dict:
        """Scrape every replica's /metrics and merge fleet state. Totals
        come from the aggregator's retained counter families, so a
        gracefully-stopped replica's final flush stays counted."""
        ok = self.aggregator.scrape()
        replicas = []
        for svc in self.services():
            rid = str(svc.partition_id)
            entry: dict[str, Any] = svc.to_dict()
            if ok.get(rid):
                entry.update(
                    seen=int(self.aggregator.total(_SEEN, replica=rid)),
                    answered=int(self.aggregator.total(_ANSWERED,
                                                       replica=rid)),
                    latency=self._replica_latency(rid),
                    reachable=True)
            else:
                entry.update(reachable=False)
            replicas.append(entry)
        totals = {"seen": int(self.aggregator.total(_SEEN)),
                  "answered": int(self.aggregator.total(_ANSWERED))}
        return {"name": self.name, "replicas": replicas, "totals": totals,
                "n_replicas": len(replicas)}

    def fleet_health(self) -> dict:
        """Per-replica liveness/readiness polled from /healthz + /readyz."""
        import http.client

        replicas = {}
        for svc in self.services():
            rid = str(svc.partition_id)
            entry = {"alive": False, "ready": False}
            for path, key in (("/healthz", "alive"), ("/readyz", "ready")):
                conn = None
                try:
                    conn = http.client.HTTPConnection(svc.host, svc.port,
                                                      timeout=2)
                    conn.request("GET", path)
                    r = conn.getresponse()
                    r.read()
                    entry[key] = r.status == 200
                except (OSError, http.client.HTTPException):
                    pass
                finally:
                    if conn is not None:
                        conn.close()
            replicas[rid] = entry
        n_ready = sum(e["ready"] for e in replicas.values())
        return {"replicas": replicas, "n_replicas": len(replicas),
                "alive": sum(e["alive"] for e in replicas.values()),
                "ready": n_ready,
                "all_ready": bool(replicas) and n_ready == len(replicas)}

    def render_metrics(self) -> str:
        """The fleet exposition (+ SLO series when an engine is attached)."""
        self.aggregator.scrape()
        text = self.aggregator.render()
        if self.slo_engine is not None:
            try:
                self.slo_engine.evaluate()
                text += self.slo_engine.render()
            except Exception:  # noqa: BLE001 — SLO math must not kill scrape
                pass
        return text

    # -- HTTP surface --------------------------------------------------- #

    def start(self) -> "FleetRendezvous":
        outer = self

        class Handler(SingleSegmentHandler):
            def _reply(self, status: int, payload: bytes) -> None:
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_POST(self):  # noqa: N802 — http.server API
                path, _, query = self.path.partition("?")
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                if path == "/register":
                    try:
                        info = ServiceInfo.from_dict(json.loads(body))
                    except (ValueError, KeyError):
                        self._reply(400, b'{"error": "bad ServiceInfo"}')
                        return
                    outer.register(info)
                    self._reply(200, b'{"registered": true}')
                    return
                if path == "/metrics/push":
                    # a draining replica's final flush: its counters stay
                    # in the fleet totals after the process exits
                    import urllib.parse

                    params = urllib.parse.parse_qs(query)
                    rid = params.get("replica", ["?"])[0]
                    try:
                        outer.aggregator.push(rid, body.decode("utf-8"),
                                              final=True)
                    except Exception:  # noqa: BLE001 — bad push, not a crash
                        self._reply(400, b'{"error": "bad exposition"}')
                        return
                    self._reply(200, b'{"pushed": true}')
                    return
                self._reply(404, b"{}")

            def do_GET(self):  # noqa: N802
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    payload = outer.render_metrics().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                    return
                if path == "/services":
                    body = json.dumps(
                        [s.to_dict() for s in outer.services()]
                    ).encode()
                elif self.path == "/info":
                    body = json.dumps(outer.info()).encode()
                elif path == "/healthz":
                    health = outer.fleet_health()
                    payload = json.dumps(health).encode()
                    self._reply(200 if health["all_ready"] else 503, payload)
                    return
                else:
                    self._reply(404, b"{}")
                    return
                self._reply(200, body)

            def log_message(self, *a):
                pass

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._server.server_address[1]
        threading.Thread(target=self._server.serve_forever, daemon=True).start()
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None


def _register_with_rendezvous(rendezvous_url: str, info: ServiceInfo) -> None:
    import http.client
    import urllib.parse

    u = urllib.parse.urlparse(rendezvous_url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=10)
    conn.request("POST", "/register", body=json.dumps(info.to_dict()).encode(),
                 headers={"Content-Type": "application/json"})
    r = conn.getresponse()
    r.read()
    conn.close()
    if r.status != 200:
        raise IOError(f"rendezvous register failed: {r.status}")


def _push_final_metrics(rendezvous_url: str, partition_id: int,
                        text: str) -> None:
    import http.client
    import urllib.parse

    u = urllib.parse.urlparse(rendezvous_url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=10)
    conn.request("POST", f"/metrics/push?replica={partition_id}",
                 body=text.encode(), headers={"Content-Type": "text/plain"})
    r = conn.getresponse()
    r.read()
    conn.close()
    if r.status != 200:
        raise IOError(f"metrics push failed: {r.status}")


def _fleet_worker(handler_factory, conn, server_kw, partition_id=0,
                  rendezvous_url=None, forwarding=None,
                  trace_dir=None, flight_recorder_dir=None) -> None:
    """Child-process entry: build the handler locally (models must not cross
    the process boundary — the reference re-creates per-JVM servers the same
    way, DistributedHTTPSource.scala:244-291), optionally open a reverse
    tunnel to the public gateway (the HTTPSourceV2 `forwarding.*` path,
    HTTPSourceV2.scala:363-372), announce ServiceInfo to the driver
    rendezvous, and serve until terminated."""
    import os
    import signal

    from .forwarding import establish_forward, get_local_ip

    rec = None
    if flight_recorder_dir:
        from ..observability.recorder import (FlightRecorder,
                                              set_default_recorder)

        rec = FlightRecorder(dump_dir=flight_recorder_dir,
                             process=f"replica-{partition_id}")
        # the process default, so gateway/autoscaler/supervisor code
        # running in this replica records into the same ring
        set_default_recorder(rec)
        server_kw = dict(server_kw, recorder=rec)
    srv = ServingServer(handler_factory(), **server_kw).start()
    # SIGTERM (ServingFleet.stop) begins the GRACEFUL sequence below:
    # shed new work, drain what was already admitted (srv.stop's default
    # continuous-mode drain), flush final counters to the rendezvous, and
    # export the replica's trace — so stopping the fleet loses neither
    # in-flight requests nor their telemetry. The fleet's hard kill()
    # stays as the timeout fallback for a worker stuck draining.
    shutdown = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: shutdown.set())
    fwd = None
    if forwarding is not None:
        fwd = establish_forward(srv.port, forwarding, local_host=srv.host)
        # a dead tunnel must surface in /healthz, not blackhole traffic
        srv.health_probes["forwarding"] = fwd.status
    if rendezvous_url:
        _register_with_rendezvous(rendezvous_url, ServiceInfo(
            name="mmlspark_tpu.serving", host=srv.host, port=srv.port,
            partition_id=partition_id, pid=os.getpid(),
            local_ip=get_local_ip(),
            public_host=fwd.remote_host if fwd else None,
            public_port=fwd.remote_port if fwd else None,
        ))
    conn.send((srv.host, srv.port))
    try:
        shutdown.wait()
        if rec is not None:
            rec.record_transition("replica", "sigterm",
                                  partition_id=partition_id)
        srv.stop()  # graceful: drains in-flight requests first (and the
        # recorder, when armed, dumps with trigger "drain")
        if rendezvous_url:
            try:
                _push_final_metrics(rendezvous_url, partition_id,
                                    srv.metrics.render_prometheus())
            except Exception:  # noqa: BLE001 — rendezvous may be gone
                pass
        if trace_dir:
            try:
                from ..observability.tracing import get_tracer

                get_tracer().export_jsonl(os.path.join(
                    trace_dir, f"replica-{partition_id}.jsonl"))
            except Exception:  # noqa: BLE001 — tracing is best-effort
                pass
    finally:
        if fwd is not None:
            fwd.close()


class ServingFleet:
    """Distributed serving: one ServingServer PROCESS per "host".

    Reference: DistributedHTTPSource's per-executor-JVM `JVMSharedServer`
    (DistributedHTTPSource.scala:89-343) — here each host is a real OS
    process with its own handler instance (clients spread requests across
    `urls`, the role of the reference's load balancer).

    `handler_factory` must be a picklable zero-arg callable returning the
    `handler(Table) -> Table` for that host.

    A `FleetRendezvous` runs on the driver: every replica registers its
    ServiceInfo at startup (HTTPSourceV2.scala:118-165), and `info()` /
    the rendezvous `GET /info` endpoint aggregates live per-replica
    counters into fleet totals.

    Membership is dynamic: `kill()` prunes the dead replica from `urls`,
    `respawn(index)` refills a slot through the same startup handshake,
    `scale_to(n)` grows/shrinks the fleet (shrink = graceful drain), and
    `rolling_swap(new_handler_factory)` replaces every replica's handler
    with zero downtime. `watch(callback)` observes membership changes —
    io_http.gateway.ServingGateway attaches itself this way so its
    routing table tracks the live set."""

    def __init__(self, handler_factory: Callable[[], Callable[[Table], Table]],
                 n_hosts: int = 2, start_timeout_s: float = 60.0,
                 rendezvous: bool = True, forwarding=None,
                 trace_dir: "str | None" = None,
                 flight_recorder_dir: "str | None" = None,
                 timeline_dir: "str | None" = None,
                 timeline_interval_s: float = 5.0,
                 timeline_keep: int = 8,
                 stop_timeout_s: float = 15.0, clock: Any = None,
                 stale_after_s: float = 10.0, **server_kw):
        self.handler_factory = handler_factory
        self.n_hosts = n_hosts
        self.start_timeout_s = start_timeout_s
        self.server_kw = server_kw
        # io_http.forwarding.ForwardingOptions: every replica opens its own
        # reverse tunnel to the gateway and registers the public coords
        # (HTTPSourceV2's forwarding.enabled path)
        self.forwarding = forwarding
        # when set, each gracefully-stopped replica exports its spans to
        # trace_dir/replica-N.jsonl (merge with Tracer.merge_jsonl)
        self.trace_dir = trace_dir
        # when set, every replica arms a FlightRecorder dumping into this
        # directory (tools/diagnose.py --postmortem merges the dumps)
        self.flight_recorder_dir = flight_recorder_dir
        # when set, a TimelineRecorder runs on the DRIVER beside the
        # rendezvous aggregator, persisting the merged fleet scrape as
        # segment files (tools/diagnose.py --history replays them);
        # requires rendezvous=True — there is no fleet view without it
        self.timeline_dir = timeline_dir
        self.timeline_interval_s = float(timeline_interval_s)
        self.timeline_keep = int(timeline_keep)
        if timeline_dir is not None and not rendezvous:
            raise ValueError("timeline_dir needs rendezvous=True "
                             "(the recorder samples the aggregator)")
        self.timeline: "Any | None" = None
        # how long stop() waits for the graceful drain-and-flush before
        # falling back to a hard kill
        self.stop_timeout_s = stop_timeout_s
        # slot-indexed bookkeeping: _procs[slot] may hold a dead process
        # (killed / retired); _url_of maps LIVE slots to their URLs and
        # `urls` is rebuilt from it, so a crashed replica never lingers
        # in the routing view
        self._procs: list[multiprocessing.Process] = []
        self._url_of: dict[int, str] = {}
        self.urls: list[str] = []
        # fresh partition id per spawned process, NEVER reused: the
        # aggregator retains a dead replica's counters for monotone fleet
        # totals, so a respawn restarting the same id at zero would walk
        # the totals backwards
        self._next_part = 0
        # slots drained ON PURPOSE (retire/scale-down) — dead_slots()
        # excludes them so self-healing never resurrects a scale-down
        self._retired: set[int] = set()
        self._watchers: list[Callable[[str, str], None]] = []
        self._fleet_lock = make_rlock("ServingFleet._fleet_lock")
        # the injectable clock drives the startup wait loop and the
        # rendezvous aggregator's staleness logic — chaos tests pass a
        # FakeClock so dead-replica detection needs zero real waiting
        if clock is None:
            from ..resilience.policy import SYSTEM_CLOCK

            clock = SYSTEM_CLOCK
        self.clock = clock
        self.rendezvous: FleetRendezvous | None = (
            FleetRendezvous(name="mmlspark_tpu.fleet", clock=clock,
                            stale_after_s=stale_after_s)
            if rendezvous else None
        )

    # -- membership bookkeeping ----------------------------------------- #

    @staticmethod
    def _record_transition(action: str, **detail) -> None:
        """Driver-side fleet transitions land in the driver's black box
        (the process-default recorder, armed once anything configures a
        flight_recorder_dir on it)."""
        try:
            from ..observability.recorder import get_recorder

            get_recorder().record_transition("fleet", action, **detail)
        except Exception:  # noqa: BLE001 — telemetry stays optional
            pass

    def watch(self, callback: Callable[[str, str], None]) -> None:
        """Register `callback(event, url)` for membership changes; event
        is "added" (replica live and warm) or "removed" (about to drain
        or already dead). The gateway admits/ejects through this."""
        self._watchers.append(callback)

    def _notify(self, event: str, url: str) -> None:
        for cb in list(self._watchers):
            try:
                cb(event, url)
            except Exception:  # noqa: BLE001 — watchers must not kill ops
                pass

    def _set_url(self, slot: int, url: str) -> None:
        with self._fleet_lock:
            self._url_of[slot] = url
            self.urls = [self._url_of[s] for s in sorted(self._url_of)]
        self._notify("added", url)

    def _drop_url(self, slot: int) -> None:
        with self._fleet_lock:
            url = self._url_of.pop(slot, None)
            self.urls = [self._url_of[s] for s in sorted(self._url_of)]
        if url is not None:
            self._notify("removed", url)

    def live_slots(self) -> list[int]:
        with self._fleet_lock:
            return sorted(self._url_of)

    def dead_slots(self) -> list[int]:
        """Slots whose process died WITHOUT being retired on purpose —
        the self-healing respawn set (FleetAutoscaler polls this)."""
        with self._fleet_lock:
            return [i for i, p in enumerate(self._procs)
                    if i not in self._retired and not p.is_alive()]

    @property
    def n_live(self) -> int:
        return len(self._url_of)

    # -- spawning ------------------------------------------------------- #

    def _launch(self, partition_id: int):
        """Start one worker process; returns (process, parent_conn) for
        the startup handshake."""
        ctx = multiprocessing.get_context("spawn")
        parent, child = ctx.Pipe()
        p = ctx.Process(
            target=_fleet_worker,
            args=(self.handler_factory, child, self.server_kw, partition_id,
                  self.rendezvous.url if self.rendezvous else None,
                  self.forwarding, self.trace_dir,
                  self.flight_recorder_dir),
            daemon=True,
        )
        p.start()
        return p, parent

    def _await_url(self, slot: int, p, parent) -> str:
        """The startup handshake wait: fail FAST on a dead child (e.g.
        establish_forward raised on bad credentials/exhausted ports) —
        waiting out the full timeout would mask the real error with a
        generic one. The deadline runs on the injectable clock."""
        deadline = self.clock.monotonic() + self.start_timeout_s
        while not parent.poll(0.5):
            if not p.is_alive():
                raise RuntimeError(
                    f"serving host {slot} died during startup (exitcode "
                    f"{p.exitcode}) — see the child's "
                    "stderr; with forwarding enabled this is usually "
                    "the reverse tunnel failing to establish"
                )
            if self.clock.monotonic() > deadline:
                raise TimeoutError("serving host failed to start")
        host, port = parent.recv()
        return f"http://{host}:{port}/"

    def _wait_ready(self, url: str, timeout_s: "float | None" = None,
                    proc=None) -> None:
        """Poll the replica's /readyz until 200 — with a warmup request
        configured, readiness means the fused executable is warm over the
        FULL bucket ladder, so admitting the replica cannot cost a live
        request a compile. Real-time deadline: this waits on a real
        subprocess, not on simulated time."""
        import http.client
        import urllib.parse

        u = urllib.parse.urlsplit(url)
        deadline = time.monotonic() + (timeout_s if timeout_s is not None
                                       else self.start_timeout_s)
        while True:
            try:
                conn = http.client.HTTPConnection(u.hostname, u.port,
                                                  timeout=2)
                try:
                    conn.request("GET", "/readyz")
                    if conn.getresponse().status == 200:
                        return
                finally:
                    conn.close()
            except (OSError, http.client.HTTPException):
                pass
            if proc is not None and not proc.is_alive():
                raise RuntimeError(
                    f"replica {url} died while warming up (exitcode "
                    f"{proc.exitcode})")
            if time.monotonic() > deadline:
                raise TimeoutError(f"replica {url} never became ready")
            time.sleep(0.02)

    def _spawn(self, slot: int) -> str:
        """Fill `slot` with a fresh worker: handshake, wait until warm
        (/readyz), then publish it to `urls`/watchers — a spawned replica
        is never routable before it is ready."""
        part = self._next_part
        self._next_part += 1
        p, parent = self._launch(part)
        with self._fleet_lock:
            while len(self._procs) <= slot:
                self._procs.append(p)
            self._procs[slot] = p
        url = self._await_url(slot, p, parent)
        self._wait_ready(url, proc=p)
        self._set_url(slot, url)
        return url

    def start(self) -> "ServingFleet":
        if self.rendezvous is not None:
            self.rendezvous.start()
        if self.timeline_dir is not None and self.timeline is None:
            from ..observability.recorder import get_recorder
            from ..observability.timeline import TimelineRecorder

            self.timeline = TimelineRecorder(
                self.timeline_dir, self.rendezvous.aggregator,
                clock=self.clock, interval_s=self.timeline_interval_s,
                keep=self.timeline_keep, recorder=get_recorder())
            self.timeline.start()
        # spawn all workers in parallel, then run each handshake
        started = []
        for slot in range(self.n_hosts):
            part = self._next_part
            self._next_part += 1
            p, parent = self._launch(part)
            with self._fleet_lock:
                self._procs.append(p)
            started.append((slot, p, parent))
        try:
            for slot, p, parent in started:
                url = self._await_url(slot, p, parent)
                self._wait_ready(url, proc=p)
                self._set_url(slot, url)
        except Exception:
            self.stop()
            raise
        return self

    def info(self) -> dict:
        """Aggregated fleet state (requires rendezvous=True)."""
        if self.rendezvous is None:
            raise ValueError("fleet started with rendezvous=False")
        return self.rendezvous.info()

    def kill(self, index: int) -> None:
        """Hard-kill one replica — the chaos path: no drain, no final
        flush, its ServiceInfo left registered (the rendezvous reports it
        unreachable/down, which is exactly what the fleet view must show
        for a crashed process). The dead replica's URL is pruned from
        `urls` so routing layers stop offering it."""
        p = self._procs[index]
        if p.is_alive():
            p.kill()
        p.join(timeout=10)
        self._drop_url(index)
        self._record_transition("kill", slot=index)

    def dump_all(self, trigger: str = "fleet") -> int:
        """Broadcast a flight-recorder dump to every LIVE replica (POST
        /flightrecorder/dump) — the fleet-wide snapshot a driver-side
        trigger (SLO burn, chaos kill about to land) fans out so each
        process writes its ring BEFORE anything dies. Fail-soft per
        replica; returns how many acknowledged."""
        import http.client
        import urllib.parse

        dumped = 0
        with self._fleet_lock:
            urls = list(self.urls)
        for url in urls:
            u = urllib.parse.urlsplit(url)
            try:
                conn = http.client.HTTPConnection(u.hostname, u.port,
                                                  timeout=5)
                try:
                    conn.request(
                        "POST", f"/flightrecorder/dump?trigger={trigger}",
                        body=b"")
                    if conn.getresponse().status == 200:
                        dumped += 1
                finally:
                    conn.close()
            except (OSError, http.client.HTTPException):
                pass
        return dumped

    def respawn(self, index: int) -> str:
        """Self-healing: refill a dead slot through the same startup
        handshake `start()` uses. The new process gets a FRESH partition
        id (the crashed one's counters stay retained in the fleet totals)
        and is published only after /readyz. Returns the new URL."""
        p = self._procs[index]
        if p.is_alive():
            raise RuntimeError(
                f"slot {index} is still alive — kill() or retire() it "
                "before respawning")
        self._drop_url(index)  # no-op when kill() already pruned it
        with self._fleet_lock:
            self._retired.discard(index)
        url = self._spawn(index)
        self._record_transition("respawn", slot=index, url=url)
        return url

    def retire(self, index: int) -> None:
        """Gracefully drain one replica out of the fleet: unpublish its
        URL first (routing layers stop sending new work), then SIGTERM —
        the worker sheds, drains in-flight requests, flushes its final
        counters, and exits. Hard kill only past stop_timeout_s."""
        with self._fleet_lock:
            self._retired.add(index)
        self._drop_url(index)
        self._record_transition("retire", slot=index)
        p = self._procs[index]
        if p.is_alive():
            p.terminate()
            p.join(timeout=self.stop_timeout_s)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)

    def scale_to(self, n: int) -> list[str]:
        """Grow or shrink the live replica set to `n`. Growth spawns into
        fresh slots and publishes each replica once warm; shrink retires
        the highest live slots via graceful drain. Returns `urls`."""
        if n < 0:
            raise ValueError(f"cannot scale to {n} replicas")
        with self._fleet_lock:
            live = sorted(self._url_of)
        while len(live) < n:
            slot = len(self._procs)
            self._spawn(slot)
            live.append(slot)
        for slot in reversed(live[n:]):
            self.retire(slot)
        return list(self.urls)

    def rolling_swap(self, new_handler_factory) -> int:
        """Zero-downtime model swap: for each live replica, start a NEW
        replica with `new_handler_factory`, warm it over the full bucket
        ladder (the warmup/readyz gate in _spawn), publish it, and only
        then drain and retire one old replica — the live set never drops
        below its pre-swap size and every routable replica is warm, so
        clients see no downtime and no compile stalls. Returns the number
        of replicas swapped."""
        self.handler_factory = new_handler_factory
        old_slots = self.live_slots()
        self._record_transition("swap_begin", n=len(old_slots))
        for slot in old_slots:
            self._spawn(len(self._procs))
            self.retire(slot)
        self._record_transition("swap_done", n=len(old_slots))
        return len(old_slots)

    def stop(self) -> None:
        """Graceful first: SIGTERM puts every worker through its drain-
        and-flush sequence (in-flight requests answered, final counters
        pushed to the rendezvous, traces exported); workers that miss
        `stop_timeout_s` get the historical hard kill. The rendezvous
        stops LAST so the final flushes have somewhere to land."""
        if self.timeline is not None:
            try:
                self.timeline.sample()       # the shutdown-edge sample
            except Exception:  # noqa: BLE001 — telemetry stays optional
                pass
            self.timeline.stop()
            self.timeline = None
        with self._fleet_lock:
            procs = list(self._procs)
        for p in procs:
            if p.is_alive():
                p.terminate()
        deadline = time.monotonic() + self.stop_timeout_s
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 0.1))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        with self._fleet_lock:
            self._procs = []
            self._url_of = {}
            self._retired = set()
            self.urls = []
        if self.rendezvous is not None:
            self.rendezvous.stop()
