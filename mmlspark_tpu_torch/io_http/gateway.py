"""ServingGateway: the routing brain in front of a ServingFleet.

Reference: Spark Serving's distributed mode puts a LOAD BALANCER in front
of the per-executor servers (SURVEY.md §3.4, HTTPSourceV2's routing table
keyed by ServiceInfo) — the reference leaves the balancer to the cloud;
here it is a first-class, chaos-tested component:

  * routes each POST to a live replica — least-loaded by in-flight count
    by default, or consistent-hash on a routing-key header so stateful
    handlers keep session affinity
  * spreads through io_http.clients.TargetPool (per-replica circuit
    breakers + manual eject/admit), so the gateway and direct
    `HTTPClient(urls=...)` callers share ONE tested failover primitive
  * a replica crash costs a RETRY, not an error: a connection failure
    (status 0 — no HTTP answer was produced, so resending is safe)
    hedges once against a different replica and ejects the dead one
  * `probe_all()` ejects replicas whose /readyz fails (or whose breaker
    is open) and re-admits them after probe success; wire it to a clock
    loop with `start_probing()` or call it directly from tests
  * tracks `ServingFleet` membership live via `attach_fleet` (scale-ups,
    respawns and rolling swaps admit/eject atomically at the pool)
  * optional `checkpoint_dir` journals every accept/reply at the gateway
    (io_http.journal exactly-once semantics), so a mid-soak crash can
    neither lose nor double-answer a journaled request

Everything waits through the injectable clock; chaos tests drive the
whole ejection/re-admission cycle on a FakeClock with zero real sleeps.

A copy of mmlspark_tpu/io_http/gateway.py.
"""

from __future__ import annotations

import itertools
import json
import multiprocessing
import os
import socket
import threading
import time
from http.server import ThreadingHTTPServer
from typing import Any, Callable

from ..observability.sanitizer import make_lock
from ..resilience.policy import RetryPolicy, SYSTEM_CLOCK
from .clients import TargetPool
from .schema import HTTPRequestData, HTTPResponseData
from .serving import SingleSegmentHandler

__all__ = ["ServingGateway", "GatewayTier"]

_GW_SEQ = itertools.count()

# hop-by-hop headers never forwarded either direction (RFC 9110 §7.6.1)
_HOP_HEADERS = frozenset((
    "connection", "keep-alive", "proxy-authenticate", "proxy-authorization",
    "te", "trailer", "transfer-encoding", "upgrade", "host",
    "content-length",
))


class ServingGateway:
    """HTTP front that routes to the live replicas of a serving fleet.

    `urls` seeds the routing pool; `attach_fleet(fleet)` keeps it in sync
    with a live `ServingFleet`. `routing_key_header` (default
    `x-routing-key`) switches a request to consistent-hash routing.
    """

    def __init__(
        self,
        urls=(),
        host: str = "127.0.0.1",
        port: int = 0,
        strategy: str = "least_loaded",
        routing_key_header: str = "x-routing-key",
        timeout_s: float = 30.0,
        hedge: bool = True,
        checkpoint_dir: "str | None" = None,
        clock: Any = None,
        metrics: Any = None,
        policy: "RetryPolicy | None" = None,
        pool: "TargetPool | None" = None,
        probe_timeout_s: float = 2.0,
        exemplars: bool = True,
        flight_recorder_dir: "str | None" = None,
        recorder: Any = None,
        timeline_dir: "str | None" = None,
        timeline_interval_s: float = 5.0,
        reuse_port: bool = False,
        worker_label: "str | None" = None,
        **breaker_kw,
    ):
        if strategy not in ("least_loaded", "round_robin", "hash"):
            raise ValueError(f"unknown routing strategy {strategy!r}")
        self.host, self.port = host, port
        # gateway-tier membership: reuse_port binds the listener with
        # SO_REUSEPORT so N worker processes share ONE port (the kernel
        # balances accepted connections across them); worker_label tags
        # this process's requests in the per-worker counter
        self.reuse_port = bool(reuse_port)
        self.worker_label = worker_label
        self.strategy = strategy
        self.routing_key_header = routing_key_header.lower()
        self.timeout_s = timeout_s
        # hedge=False turns off the connection-failure retry for callers
        # whose requests are NOT idempotent (side-effecting handlers)
        self.hedge = hedge
        self.clock = clock if clock is not None else SYSTEM_CLOCK
        self.probe_timeout_s = probe_timeout_s
        self.pool = pool if pool is not None else TargetPool(
            urls, clock=self.clock, **breaker_kw)
        if pool is not None:
            for u in urls:
                self.pool.add(u)
        # forwarding does NOT retry in-place (no backoff sleeps on the
        # gateway thread): retryable failures surface immediately and the
        # hedge/breaker layer decides what happens next
        self.policy = policy if policy is not None else RetryPolicy(
            max_retries=0, clock=self.clock)
        # exactly-once accept/reply journal at the gateway boundary
        self.journal = None
        self._id_counter = itertools.count()
        if checkpoint_dir is not None:
            from .journal import ServingJournal

            self.journal = ServingJournal(checkpoint_dir)
            self._id_counter = itertools.count(self.journal.max_id() + 1)
        self._server: ThreadingHTTPServer | None = None
        self._probe_thread: "threading.Thread | None" = None
        self._stop = threading.Event()
        self._fleet = None
        self.autoscaler = None
        self.exemplars = bool(exemplars)
        self._init_metrics(metrics)
        # black-box flight recorder: admit/eject transitions and routed
        # requests land in the ring; `flight_recorder_dir` arms triggered
        # dumps (SLO burn via the driver, drain on stop())
        if recorder is None and flight_recorder_dir:
            from ..observability.recorder import FlightRecorder

            recorder = FlightRecorder(dump_dir=flight_recorder_dir,
                                      process=f"gateway-{self.server_label}")
        self.recorder = recorder
        # opt-in metrics history: the gateway samples its OWN registry
        # (routing counters, inflight, latency) into segment files so
        # `diagnose.py --history` can replay a routing incident
        self.timeline = None
        if timeline_dir is not None:
            from ..observability.timeline import TimelineRecorder

            self.timeline = TimelineRecorder(
                timeline_dir, self.metrics, clock=self.clock,
                interval_s=timeline_interval_s, recorder=recorder)

    # -- metrics -------------------------------------------------------- #

    def _init_metrics(self, metrics) -> None:
        from ..observability.metrics import get_registry

        self.metrics = metrics if metrics is not None else get_registry()
        self.server_label = f"gw{next(_GW_SEQ)}"
        lbl = {"server": self.server_label}
        self._c_requests = self.metrics.counter(
            "mmlspark_tpu_gateway_requests_total",
            "requests routed through the gateway, by outcome",
            labels=("server", "outcome"))
        self._c_hedges = self.metrics.counter(
            "mmlspark_tpu_gateway_hedged_retries_total",
            "connection-failed requests retried on another replica",
            labels=("server",)).labels(**lbl)
        self._c_ejections = self.metrics.counter(
            "mmlspark_tpu_gateway_ejections_total",
            "replicas taken out of rotation, by reason",
            labels=("server", "reason"))
        self._c_admissions = self.metrics.counter(
            "mmlspark_tpu_gateway_admissions_total",
            "replicas (re)admitted into rotation",
            labels=("server",)).labels(**lbl)
        # which routing strategy placed each request — "hash" counts the
        # sticky (x-routing-key) traffic, e.g. SAR consistent-hash-by-user,
        # separately from the default strategy's
        self._c_routed = self.metrics.counter(
            "mmlspark_tpu_gateway_routed_total",
            "requests placed on a replica, by routing strategy",
            labels=("server", "strategy"))
        self._g_live = self.metrics.gauge(
            "mmlspark_tpu_gateway_replicas_live_count",
            "replicas currently in rotation",
            labels=("server",)).labels(**lbl)
        self._g_live_ratio = self.metrics.gauge(
            "mmlspark_tpu_gateway_live_replicas_ratio",
            "live replicas / known replicas (1.0 = fully healthy)",
            labels=("server",)).labels(**lbl)
        self._g_inflight = self.metrics.gauge(
            "mmlspark_tpu_gateway_inflight_depth",
            "requests currently forwarded and awaiting a replica reply",
            labels=("server",)).labels(**lbl)
        self._h_latency = self.metrics.histogram(
            "mmlspark_tpu_gateway_latency_seconds",
            "gateway latency, request read to reply written",
            labels=("server",), exemplars=self.exemplars).labels(**lbl)
        # tier accounting: each worker process counts its own requests
        # under its worker label, so a scrape across the tier shows the
        # kernel's SO_REUSEPORT balance directly
        self._c_worker = None
        if self.worker_label is not None:
            self._c_worker = self.metrics.counter(
                "mmlspark_tpu_gateway_worker_requests_total",
                "requests handled per gateway-tier worker process",
                labels=("worker",)).labels(worker=self.worker_label)
        self._update_pool_gauges()

    def _update_pool_gauges(self) -> None:
        states = self.pool.states()
        live = sum(1 for s in states.values() if s["live"])
        self._g_live.set(live)
        self._g_live_ratio.set(live / len(states) if states else 0.0)
        self._g_inflight.set(
            sum(s["inflight"] for s in states.values()))

    def _recorder(self):
        """The gateway's flight recorder, or the process default (armed
        but dumping nowhere until someone configures a dump_dir)."""
        if self.recorder is not None:
            return self.recorder
        from ..observability.recorder import get_recorder

        return get_recorder()

    # -- membership ----------------------------------------------------- #

    def admit(self, url: str) -> None:
        """Put `url` into rotation (atomic at the pool: the next pick
        already sees it). Counted even when already admitted — rolling
        swap uses the admission stream as its audit trail."""
        self.pool.admit(url)
        self._c_admissions.inc()
        self._recorder().record_transition("gateway", "admit", url=url)
        self._update_pool_gauges()

    def eject(self, url: str, reason: str = "manual") -> None:
        if self.pool.eject(url, reason):
            self._c_ejections.labels(
                server=self.server_label, reason=reason).inc()
            self._recorder().record_transition("gateway", "eject", url=url,
                                               reason=reason)
        self._update_pool_gauges()

    def remove(self, url: str) -> None:
        """Forget `url` entirely (a retired/dead replica, not a sick one)."""
        self.pool.remove(url)
        self._update_pool_gauges()

    def attach_fleet(self, fleet) -> "ServingGateway":
        """Track a ServingFleet's membership: current `urls` seed the
        pool, later scale/respawn/swap events admit/remove live."""
        self._fleet = fleet
        for u in fleet.urls:
            self.admit(u)

        def _on_change(event: str, url: str) -> None:
            if event == "added":
                self.admit(url)
            elif event == "removed":
                self.remove(url)

        fleet.watch(_on_change)
        return self

    def attach_autoscaler(self, autoscaler) -> "ServingGateway":
        """Expose an autoscaler's state under GET /autoscaler (the
        diagnose snapshot reads it alongside /routes)."""
        self.autoscaler = autoscaler
        return self

    # -- probing -------------------------------------------------------- #

    def _probe(self, url: str) -> bool:
        """One replica's /readyz — True = ready. Connection failures and
        non-200s both count as not ready."""
        import http.client
        import urllib.parse

        u = urllib.parse.urlsplit(url)
        conn = None
        try:
            conn = http.client.HTTPConnection(
                u.hostname, u.port, timeout=self.probe_timeout_s)
            conn.request("GET", "/readyz")
            r = conn.getresponse()
            r.read()
            return r.status == 200
        except (OSError, http.client.HTTPException):
            return False
        finally:
            if conn is not None:
                conn.close()

    def probe_all(self) -> dict[str, bool]:
        """Probe every known replica: eject the not-ready (and the
        breaker-open), re-admit ejected replicas whose probe succeeds.
        Returns {url: ready}. Chaos tests call this directly; production
        wires it to a clock loop via start_probing()."""
        results: dict[str, bool] = {}
        for url, st in self.pool.states().items():
            ready = self._probe(url)
            results[url] = ready
            if not ready and not st["ejected"]:
                # a breaker-open replica is already out of rotation; the
                # explicit ejection keeps /routes' audit trail honest
                # about WHY it is out
                reason = "breaker" if st["breaker"] == "open" else "readyz"
                self.eject(url, reason=reason)
            elif ready and st["ejected"]:
                self.admit(url)
        self._update_pool_gauges()
        return results

    def start_probing(self, interval_s: float = 1.0) -> None:
        """Background probe loop on the injectable clock."""
        def _loop():
            while not self._stop.is_set():
                try:
                    self.probe_all()
                except Exception:  # noqa: BLE001 — probing must not die
                    pass
                self.clock.sleep(interval_s)

        self._probe_thread = threading.Thread(target=_loop, daemon=True)
        self._probe_thread.start()

    # -- forwarding ----------------------------------------------------- #

    def forward(self, req: HTTPRequestData,
                key: "str | None" = None) -> HTTPResponseData:
        """Route one request: pick a live replica (hash when `key` is
        given), forward, hedge once on connection failure. A request no
        live replica could take answers 503; both attempts dying on
        connection errors answers 502."""
        strategy = "hash" if key is not None else self.strategy
        self._c_routed.labels(server=self.server_label,
                              strategy=strategy).inc()

        def _on_failover(url: str, _resp) -> None:
            self._c_hedges.inc()
            self.eject(url, reason="connect")

        resp = self.pool.send(
            req, timeout=self.timeout_s, policy=self.policy,
            strategy=strategy, key=key, retry_connect=self.hedge,
            on_failover=_on_failover)
        if resp.status_code == 0:
            # every attempt died at the connection level: the client gets
            # a real HTTP answer (502), never a dropped socket
            resp = HTTPResponseData(
                502, f"no replica reachable: {resp.reason}",
                headers={"Retry-After": "1"}, entity=None)
        return resp

    # -- HTTP surface --------------------------------------------------- #

    def routes(self) -> dict:
        """The routing table: per-replica pool state + strategy — what
        GET /routes serves and tools/diagnose.py prints."""
        states = self.pool.states()
        return {
            "strategy": self.strategy,
            "routing_key_header": self.routing_key_header,
            "hedge": self.hedge,
            "n_targets": len(states),
            "n_live": sum(1 for s in states.values() if s["live"]),
            "strategy_requests": {
                vals[1]: int(c.value)
                for vals, c in self._c_routed.children()
                if vals[0] == self.server_label},
            "targets": states,
        }

    def start(self) -> "ServingGateway":
        outer = self

        class Handler(SingleSegmentHandler):
            protocol_version = "HTTP/1.1"
            timeout = 5.0
            body_timeout = 60.0

            def do_POST(self):  # noqa: N802 — http.server API
                self.connection.settimeout(self.body_timeout)
                try:
                    self._handle_post()
                finally:
                    self.connection.settimeout(self.timeout)

            def _handle_post(self):
                if self.headers.get("Transfer-Encoding"):
                    self.send_response(411)
                    self.send_header("Content-Length", "0")
                    self.send_header("Connection", "close")
                    self.end_headers()
                    self.close_connection = True
                    return
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length) if length else b""
                t0 = time.perf_counter()
                headers = {k: v for k, v in self.headers.items()
                           if k.lower() not in _HOP_HEADERS}
                key = self.headers.get(outer.routing_key_header)
                req = HTTPRequestData("POST", self.path, headers, body)
                ex_id = None
                if outer.journal is not None:
                    ex_id = str(next(outer._id_counter))
                    outer.journal.record_accept(ex_id, req)
                # parent the forward on the caller's trace so the merged
                # fleet trace reads client -> gateway -> replica
                from ..observability.tracing import get_tracer

                tracer = get_tracer()
                remote = tracer.extract(self.headers.get("traceparent"))
                with tracer.start_span("gateway.request", parent=remote,
                                       path=self.path,
                                       server=outer.server_label) as span:
                    resp = outer.forward(req, key=key)
                if outer.journal is not None:
                    outer.journal.record_reply(ex_id, resp)
                status = resp.status_code or 500
                outcome = ("ok" if 200 <= status < 400 else
                           "unrouted" if status in (502, 503) else "error")
                outer._c_requests.labels(server=outer.server_label,
                                         outcome=outcome).inc()
                if outer._c_worker is not None:
                    outer._c_worker.inc()
                self.send_response(status)
                entity = resp.entity or b""
                for k, v in (resp.headers or {}).items():
                    if k.lower() not in _HOP_HEADERS:
                        self.send_header(k, v)
                self.send_header("Content-Length", str(len(entity)))
                self.end_headers()
                if entity:
                    self.wfile.write(entity)
                elapsed = time.perf_counter() - t0
                trace_id = getattr(span, "trace_id", 0)
                tid = format(trace_id, "032x") if trace_id else ""
                ex = ({"trace_id": tid, "route": "gateway"}
                      if outer.exemplars and tid else None)
                outer._h_latency.observe(elapsed, exemplar=ex)
                rec = outer._recorder()
                rec.record_request(trace_id=tid, route="gateway",
                                   queue_depth=outer.routes()["n_live"],
                                   latency_s=elapsed, status=status,
                                   outcome=outcome)
                rec.maybe_tick(outer.metrics)
                outer._update_pool_gauges()

            def _reply_json(self, status: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    payload = outer.metrics.render_prometheus().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                    return
                if path == "/routes":
                    self._reply_json(200, outer.routes())
                    return
                if path == "/autoscaler":
                    if outer.autoscaler is None:
                        self._reply_json(404, {"error": "no autoscaler"})
                    else:
                        self._reply_json(200, outer.autoscaler.state())
                    return
                if path == "/healthz":
                    self._reply_json(200, {
                        "status": "ok", "routes": outer.routes()["n_live"]})
                    return
                if path == "/readyz":
                    n_live = outer.routes()["n_live"]
                    self._reply_json(200 if n_live else 503,
                                     {"ready": n_live > 0,
                                      "n_live": n_live})
                    return
                self._reply_json(404, {"error": "unknown path"})

            def log_message(self, *a):
                pass

        server_cls = _ReusePortServer if self.reuse_port \
            else ThreadingHTTPServer
        self._server = server_cls((self.host, self.port), Handler)
        self.port = self._server.server_address[1]
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()
        if self.timeline is not None:
            self.timeline.start()
        return self

    def worker_stats(self) -> dict:
        """This process's tier-worker snapshot (GatewayTier aggregates
        one per worker into the /workers table)."""
        states = self.pool.states()
        return {
            "worker": self.worker_label,
            "pid": os.getpid(),
            "port": self.port,
            "requests": (int(self._c_worker.value)
                         if self._c_worker is not None else 0),
            "outcomes": {vals[1]: int(c.value)
                         for vals, c in self._c_requests.children()
                         if vals[0] == self.server_label},
            "n_live": sum(1 for s in states.values() if s["live"]),
        }

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/"

    def stop(self) -> None:
        self._stop.set()
        if self.timeline is not None:
            try:
                self.timeline.sample()       # the shutdown-edge sample
            except Exception:  # noqa: BLE001 — telemetry stays optional
                pass
            self.timeline.stop()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self.journal is not None:
            self.journal.close()
        if self.recorder is not None:
            try:
                self.recorder.trigger_dump("drain", force=True)
            except Exception:
                pass


class _ReusePortServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that joins an SO_REUSEPORT listener group:
    every gateway-tier worker binds the SAME (host, port) and the kernel
    load-balances accepted connections across the listening sockets —
    no user-space distributor process on the data path."""

    def server_bind(self):
        if not hasattr(socket, "SO_REUSEPORT"):  # pragma: no cover
            raise OSError("SO_REUSEPORT is not available on this platform")
        self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        super().server_bind()


def _gateway_tier_worker(conn, index: int, host: str, port: int,
                         urls, checkpoint_dir, gateway_kw) -> None:
    """Tier-worker process entry: one full ServingGateway bound into the
    shared-port listener group, driven by the parent over a pipe
    (membership broadcasts, stats polls, graceful stop)."""
    import signal

    gw = ServingGateway(
        urls=urls, host=host, port=port, reuse_port=True,
        worker_label=f"w{index}", checkpoint_dir=checkpoint_dir,
        **gateway_kw).start()
    # a SIGTERM'd (or SIGKILL'd) worker exits without ceremony: the
    # journal shard is append-only with torn-tail recovery, so the
    # respawned worker replays exactly-once state from disk
    signal.signal(signal.SIGTERM, lambda *_: os._exit(0))
    conn.send(("ready", gw.port, os.getpid()))
    try:
        while True:
            try:
                cmd = conn.recv()
            except (EOFError, OSError):
                break
            op = cmd[0]
            if op == "stop":
                break
            if op == "admit":
                gw.admit(cmd[1])
            elif op == "remove":
                gw.remove(cmd[1])
            elif op == "stats":
                conn.send(gw.worker_stats())
    finally:
        gw.stop()
        conn.close()


class GatewayTier:
    """N gateway worker PROCESSES sharing one port via SO_REUSEPORT —
    the multi-process front tier a single-process gateway caps out on.

    * the parent reserves the shared port with a bound-but-never-
      listening SO_REUSEPORT placeholder socket (held for the tier's
      lifetime, so the port cannot be stolen between worker restarts);
      only LISTENING sockets join the kernel's balance group, so the
      placeholder never receives a connection
    * each worker is a full `ServingGateway` (same TargetPool breakers,
      hedging, consistent-hash stickiness — the blake2b ring is
      deterministic, so every worker maps a routing key to the SAME
      replica with no cross-process coordination)
    * fleet membership propagates through the watch protocol: the parent
      subscribes once via `attach_fleet` and broadcasts admit/remove to
      every worker pipe
    * the accept/reply journal shards per worker
      (`checkpoint_dir/worker-N`): any single worker's death loses
      nothing — its shard replays on respawn, and no two workers ever
      contend on one journal file
    * `kill_worker`/`respawn_worker` are the chaos hooks the bench's
      kill-window drill drives; a killed worker's in-flight connections
      reset, which clients absorb with a status-0-safe resend
    * a small control server (`control_url`, parent process) serves
      GET /workers for `diagnose.py --gateway` — the shared data port
      deliberately serves ONLY gateway traffic
    """

    def __init__(self, urls=(), n_workers: int = 2,
                 host: str = "127.0.0.1", port: int = 0,
                 checkpoint_dir: "str | None" = None,
                 start_timeout_s: float = 30.0,
                 **gateway_kw):
        if n_workers < 1:
            raise ValueError("a gateway tier needs at least one worker")
        self.host = host
        self.port = port
        self.n_workers = int(n_workers)
        self.checkpoint_dir = checkpoint_dir
        self.start_timeout_s = start_timeout_s
        # everything here crosses the spawn boundary — keep it picklable
        # (no live metrics registries / recorders; workers build their own)
        self.gateway_kw = dict(gateway_kw)
        self._members: "list[str]" = list(urls)
        self._ctx = multiprocessing.get_context("spawn")
        self._procs: "list[Any]" = [None] * self.n_workers
        self._pipes: "list[Any]" = [None] * self.n_workers
        self._pids: "list[int | None]" = [None] * self.n_workers
        # one lock per worker pipe: stats polls and membership broadcasts
        # interleave from different threads but each pipe is half-duplex
        self._pipe_locks = [make_lock(f"GatewayTier.pipe{i}")
                            for i in range(self.n_workers)]
        self._reserve: "socket.socket | None" = None
        self._control: "ThreadingHTTPServer | None" = None
        self._fleet = None

    # -- lifecycle ------------------------------------------------------ #

    def _shard_dir(self, index: int) -> "str | None":
        if self.checkpoint_dir is None:
            return None
        return os.path.join(self.checkpoint_dir, f"worker-{index}")

    def _spawn(self, index: int) -> None:
        parent_conn, child_conn = self._ctx.Pipe()
        proc = self._ctx.Process(
            target=_gateway_tier_worker,
            args=(child_conn, index, self.host, self.port,
                  list(self._members), self._shard_dir(index),
                  self.gateway_kw),
            daemon=True)
        proc.start()
        child_conn.close()
        if not parent_conn.poll(self.start_timeout_s):
            proc.kill()
            raise TimeoutError(f"gateway worker {index} failed to start")
        msg = parent_conn.recv()
        if msg[0] != "ready" or msg[1] != self.port:
            proc.kill()
            raise RuntimeError(f"gateway worker {index} bad handshake: {msg}")
        self._procs[index] = proc
        self._pipes[index] = parent_conn
        self._pids[index] = msg[2]

    def start(self) -> "GatewayTier":
        if not hasattr(socket, "SO_REUSEPORT"):  # pragma: no cover
            raise OSError("GatewayTier requires SO_REUSEPORT")
        # reserve the shared port BEFORE any worker exists: bound with
        # SO_REUSEPORT (so workers can join) but never listen()ed (so the
        # kernel never routes a connection here)
        self._reserve = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._reserve.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._reserve.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        self._reserve.bind((self.host, self.port))
        self.port = self._reserve.getsockname()[1]
        for i in range(self.n_workers):
            self._spawn(i)
        self._start_control()
        return self

    # -- membership ----------------------------------------------------- #

    def _command(self, index: int, cmd: tuple, reply: bool = False):
        pipe = self._pipes[index]
        proc = self._procs[index]
        if pipe is None or proc is None or not proc.is_alive():
            return None
        with self._pipe_locks[index]:
            try:
                pipe.send(cmd)
                if reply:
                    if not pipe.poll(self.start_timeout_s):
                        return None
                    return pipe.recv()
            except (BrokenPipeError, EOFError, OSError):
                return None
        return None

    def _broadcast(self, cmd: tuple) -> None:
        for i in range(self.n_workers):
            self._command(i, cmd)

    def admit(self, url: str) -> None:
        if url not in self._members:
            self._members.append(url)
        self._broadcast(("admit", url))

    def remove(self, url: str) -> None:
        if url in self._members:
            self._members.remove(url)
        self._broadcast(("remove", url))

    def attach_fleet(self, fleet) -> "GatewayTier":
        """Track a ServingFleet: seed every worker with the current
        membership, then forward watch events to all worker pipes."""
        self._fleet = fleet
        for u in fleet.urls:
            self.admit(u)

        def _on_change(event: str, url: str) -> None:
            if event == "added":
                self.admit(url)
            elif event == "removed":
                self.remove(url)

        fleet.watch(_on_change)
        return self

    # -- chaos hooks ---------------------------------------------------- #

    def kill_worker(self, index: int) -> None:
        """SIGKILL one worker — the kill-window drill. The shared port
        keeps serving through the surviving listeners immediately."""
        proc = self._procs[index]
        if proc is not None and proc.is_alive():
            proc.kill()
            proc.join(timeout=5)

    def respawn_worker(self, index: int) -> None:
        """Refill a dead worker slot: same index, same journal shard —
        the new process replays the shard's exactly-once state."""
        proc = self._procs[index]
        if proc is not None and proc.is_alive():
            raise RuntimeError(f"worker {index} is still alive")
        pipe = self._pipes[index]
        if pipe is not None:
            pipe.close()
        self._spawn(index)

    # -- observability -------------------------------------------------- #

    def workers(self) -> "list[dict]":
        """One row per worker slot: alive + the worker's own counters
        (None stats for a dead worker — the row still shows the death)."""
        rows = []
        for i in range(self.n_workers):
            proc = self._procs[i]
            alive = bool(proc is not None and proc.is_alive())
            stats = self._command(i, ("stats",), reply=True) if alive \
                else None
            rows.append({
                "index": i, "alive": alive, "pid": self._pids[i],
                "journal_shard": self._shard_dir(i),
                "stats": stats,
            })
        return rows

    def _start_control(self) -> None:
        outer = self

        class Control(SingleSegmentHandler):
            protocol_version = "HTTP/1.1"

            def _reply_json(self, status: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                path = self.path.split("?", 1)[0]
                if path == "/workers":
                    self._reply_json(200, {
                        "tier": True, "host": outer.host,
                        "port": outer.port,
                        "n_workers": outer.n_workers,
                        "members": list(outer._members),
                        "workers": outer.workers(),
                    })
                    return
                if path == "/healthz":
                    alive = sum(1 for p in outer._procs
                                if p is not None and p.is_alive())
                    self._reply_json(200 if alive else 503, {
                        "status": "ok" if alive else "dead",
                        "alive": alive, "n_workers": outer.n_workers})
                    return
                self._reply_json(404, {"error": "unknown path"})

            def log_message(self, *a):
                pass

        self._control = ThreadingHTTPServer((self.host, 0), Control)
        threading.Thread(target=self._control.serve_forever,
                         daemon=True).start()

    @property
    def url(self) -> str:
        """The shared data port every client targets."""
        return f"http://{self.host}:{self.port}/"

    @property
    def control_url(self) -> str:
        """The parent's control endpoint (GET /workers) for diagnose."""
        assert self._control is not None, "tier not started"
        return f"http://{self.host}:{self._control.server_address[1]}/"

    def stop(self) -> None:
        for i in range(self.n_workers):
            self._command(i, ("stop",))
        for proc in self._procs:
            if proc is not None:
                proc.join(timeout=5)
                if proc.is_alive():
                    proc.kill()
                    proc.join(timeout=5)
        for pipe in self._pipes:
            if pipe is not None:
                try:
                    pipe.close()
                except OSError:
                    pass
        if self._control is not None:
            self._control.shutdown()
            self._control.server_close()
            self._control = None
        if self._reserve is not None:
            self._reserve.close()
            self._reserve = None
