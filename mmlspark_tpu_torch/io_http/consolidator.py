"""PartitionConsolidator — funnel work through limited lanes.

Reference: `PartitionConsolidator` (src/io/http/src/main/scala/
PartitionConsolidator.scala:103+): funnels rows from all partitions to ONE
worker per host so rate-limited services see a bounded connection count.
Two scopes here:

  * `PartitionConsolidator` (in-process): run a column function through a
    fixed-size worker pool with a global rate limit — the same
    bounded-concurrency semantics without Spark's partition machinery.
  * `ConsolidatorService` (fleet-wide): the SAME funnel as an HTTP
    micro-service on the driver. Every serving replica (a separate OS
    process — ServingFleet) proxies its upstream calls through it, so a
    rate-limited upstream sees ONE bounded client no matter how many
    replica processes the fleet runs — the cross-process completion of the
    reference's one-worker-per-host design.

A copy of mmlspark_tpu/io_http/consolidator.py.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import ThreadingHTTPServer
from typing import Any, Callable

from ..observability.sanitizer import make_lock
from ..core.params import HasInputCol, HasOutputCol, Param
from ..core.pipeline import Transformer
from .serving import SingleSegmentHandler
from ..core.schema import Table
from ..core.serialize import register_stage
from ..utils.async_utils import buffered_map

__all__ = ["PartitionConsolidator", "ConsolidatorService"]


class _RateLimiter:
    def __init__(self, per_second: float | None):
        self.interval = 1.0 / per_second if per_second else 0.0
        self._lock = make_lock("_RateLimiter._lock")
        self._next = 0.0

    def acquire(self) -> None:
        if not self.interval:
            return
        with self._lock:
            now = time.monotonic()
            wait = self._next - now
            self._next = max(self._next, now) + self.interval
        if wait > 0:
            time.sleep(wait)


@register_stage
class PartitionConsolidator(HasInputCol, HasOutputCol, Transformer):
    """Apply `fn` over a column through `num_lanes` workers at most
    `requests_per_second` calls/s (reference: one-consolidated-worker-per-
    host for rate-limited services)."""

    input_col = Param("input", "input column", ptype=str)
    output_col = Param("output", "output column", ptype=str)
    num_lanes = Param(1, "concurrent lanes (reference: 1 per host)", ptype=int)
    requests_per_second = Param(None, "global rate limit", ptype=float)

    fn: Callable[[Any], Any] | None = None

    def _transform(self, table: Table) -> Table:
        if self.fn is None:
            raise ValueError("PartitionConsolidator needs fn")
        limiter = _RateLimiter(self.get("requests_per_second"))

        def call(v):
            limiter.acquire()
            return self.fn(v)

        col = table[self.get("input_col")]
        vals = col.tolist() if hasattr(col, "tolist") else list(col)
        out = list(buffered_map(call, vals, max(self.get("num_lanes"), 1)))
        return table.with_column(self.get("output_col"), out)


class ConsolidatorService:
    """Fleet-wide rate-limit funnel as an HTTP micro-service.

    POST / with a raw body: the request passes the global rate limiter and
    the `num_lanes` concurrency gate, then `fn(body bytes) -> bytes` (the
    upstream call) runs; the result streams back. GET / reports stats
    {served, in_flight, max_in_flight}. Replica processes hit this URL
    instead of the rate-limited upstream directly, so the limit holds
    across the WHOLE fleet, not per process."""

    def __init__(self, fn: Callable[[bytes], bytes],
                 num_lanes: int = 1,
                 requests_per_second: float | None = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.fn = fn
        self.host, self.port = host, port
        self._limiter = _RateLimiter(requests_per_second)
        self._lanes = threading.Semaphore(max(num_lanes, 1))
        self._lock = make_lock("ConsolidatorService._lock")
        self.served = 0
        self.in_flight = 0
        self.max_in_flight = 0
        self._server: ThreadingHTTPServer | None = None

    def start(self) -> "ConsolidatorService":
        outer = self

        class Handler(SingleSegmentHandler):
            def do_POST(self):  # noqa: N802 — http.server API
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length) if length else b""
                with outer._lanes:
                    with outer._lock:
                        outer.in_flight += 1
                        outer.max_in_flight = max(outer.max_in_flight,
                                                  outer.in_flight)
                    try:
                        outer._limiter.acquire()
                        try:
                            out = outer.fn(body)
                            status = 200
                        except Exception as e:  # noqa: BLE001 — per-request
                            out = json.dumps({"error": str(e)}).encode()
                            status = 502
                    finally:
                        with outer._lock:
                            outer.in_flight -= 1
                            outer.served += 1
                self.send_response(status)
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

            def do_GET(self):  # noqa: N802
                with outer._lock:
                    body = json.dumps({
                        "served": outer.served,
                        "in_flight": outer.in_flight,
                        "max_in_flight": outer.max_in_flight,
                    }).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._server.server_address[1]
        threading.Thread(target=self._server.serve_forever, daemon=True).start()
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/"

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
