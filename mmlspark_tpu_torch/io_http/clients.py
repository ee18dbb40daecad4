"""HTTP clients: retry/backoff + concurrency.

Reference: src/io/http/src/main/scala/HTTPClients.scala:19-151 — retry with
exponential backoff and 429 Retry-After handling (:64-105),
`SingleThreadedHTTPClient` and `AsyncHTTPClient` (sliding window of Futures,
Clients.scala:102-116 + AsyncUtils.bufferedAwait). Here: pooled keep-alive
http.client connections on threads (`_ConnectionPool`); the async window is
utils.async_utils.buffered_map.

Retry semantics are delegated to resilience.policy.RetryPolicy (one
implementation for the whole package); the legacy `retries`/`backoff_ms`
arguments build an equivalent fixed-ladder policy. An optional
resilience.CircuitBreaker short-circuits a dead endpoint to a synthetic
503 instead of burning the backoff budget per request.

`TargetPool` is the one request-spreading primitive for multi-replica
targets (the reference's load balancer in front of per-executor servers):
a mutable set of base URLs with a per-URL breaker, manual eject/admit on
top of breaker state, in-flight accounting, and three pick strategies —
round-robin, least-loaded, and consistent hash on a caller key.
`HTTPClient(urls=[...])` and io_http.gateway.ServingGateway both route
through it, so replica failover has exactly one tested implementation.

A copy of mmlspark_tpu/io_http/clients.py, but for one rule:
`TargetPool.send` also resends, once, a 503 from a target that left the
pool while the request was out, where the JAX package returns it. A
rolling swap under load otherwise answers a client 503 whenever a request
reaches a retiring replica after its drain began (the fleet removes the
replica from the pool, then signals it; it sheds the late request unrun).
"""

from __future__ import annotations

import hashlib
import http.client
import itertools
import threading
import urllib.parse
from typing import Iterable, Sequence

from ..observability.sanitizer import make_lock
from ..observability.tracing import current_traceparent
from ..resilience.breaker import BreakerRegistry, CircuitBreaker
from ..resilience.policy import (RetryPolicy, is_retryable_exception,
                                 is_retryable_status)
from ..utils.async_utils import buffered_map
from .schema import HTTPRequestData, HTTPResponseData

__all__ = ["http_send", "HTTPClient", "TargetPool"]


def _legacy_policy(retries: int, backoff_ms: Sequence[float]) -> RetryPolicy:
    """The pre-resilience contract: `retries` total attempts walking the
    `backoff_ms` ladder (HTTPClients.scala's hard-coded schedule)."""
    return RetryPolicy(max_retries=max(retries, 1) - 1,
                       backoffs_ms=list(backoff_ms))


def _breaker_open_response(breaker: CircuitBreaker) -> HTTPResponseData:
    """Synthetic local 503 while the circuit is open — same shape as a
    server-side overload answer, so error_col/fallback paths need no
    special case."""
    return HTTPResponseData(
        503, f"circuit open: {breaker.name or 'endpoint'}",
        headers={"Retry-After": f"{breaker.retry_after_s():.3f}"},
        entity=None,
    )


class _ConnectionPool:
    """Process-wide keep-alive socket pool keyed by (scheme, host, port).

    Every `http_send` borrows a connection here instead of opening a
    fresh TCP socket per request — the three-way handshake was the
    single biggest fixed cost on the sub-millisecond serving path. Idle
    connections per endpoint are capped (`max_per_host`); a release over
    the cap closes the socket instead of pooling it, so a burst against
    many replicas cannot accumulate unbounded open sockets.

    A borrowed connection is exclusively owned until released, so no
    locking is needed around the exchange itself — only the idle lists
    are guarded."""

    def __init__(self, max_per_host: int = 8):
        self.max_per_host = max_per_host
        self._idle: "dict[tuple, list[http.client.HTTPConnection]]" = {}
        self._lock = make_lock("_ConnectionPool._lock")
        self.creates = 0
        self.reuses = 0
        self.stale_retries = 0

    @staticmethod
    def _new(scheme: str, host: str, port: int,
             timeout: float) -> http.client.HTTPConnection:
        cls = (http.client.HTTPSConnection if scheme == "https"
               else http.client.HTTPConnection)
        return cls(host, port, timeout=timeout)

    def acquire(self, scheme: str, host: str, port: int, timeout: float
                ) -> "tuple[http.client.HTTPConnection, bool]":
        """(connection, reused) — reused=True means the socket has served
        a previous exchange and may have been closed server-side since."""
        key = (scheme, host, port)
        with self._lock:
            idle = self._idle.get(key)
            while idle:
                conn = idle.pop()
                if conn.sock is not None:
                    try:
                        # a locally closed fd is detectable for free —
                        # skip it; only remotely half-closed sockets ever
                        # reach the stale-retry path in _send_once
                        conn.sock.settimeout(timeout)
                    except OSError:
                        conn.close()
                        continue
                    self.reuses += 1
                    return conn, True
                conn.close()
            self.creates += 1
        return self._new(scheme, host, port, timeout), False

    def release(self, scheme: str, host: str, port: int,
                conn: http.client.HTTPConnection) -> None:
        if conn.sock is None:
            return
        with self._lock:
            idle = self._idle.setdefault((scheme, host, port), [])
            if len(idle) < self.max_per_host:
                idle.append(conn)
                return
        conn.close()

    def close_all(self) -> None:
        with self._lock:
            conns = [c for idle in self._idle.values() for c in idle]
            self._idle.clear()
        for c in conns:
            c.close()

    def stats(self) -> dict:
        with self._lock:
            idle = sum(len(v) for v in self._idle.values())
        return {"idle": idle, "creates": self.creates,
                "reuses": self.reuses, "stale_retries": self.stale_retries,
                "max_per_host": self.max_per_host}


_POOL = _ConnectionPool()


def connection_pool_stats() -> dict:
    """Live keep-alive pool counters (idle sockets, creates vs reuses,
    stale-socket retries) — surfaced by diagnose --serving."""
    return _POOL.stats()


def configure_connection_pool(max_per_host: int) -> None:
    """Resize the per-endpoint idle-socket cap (existing idle sockets
    above the new cap drain as they are next released)."""
    _POOL.max_per_host = int(max_per_host)


def _header(headers: dict, name: str) -> "str | None":
    low = name.lower()
    for k, v in headers.items():
        if k.lower() == low:
            return v
    return None


def _send_once(method: str, url: str, body: "bytes | None",
               headers: dict, timeout: float) -> HTTPResponseData:
    """One HTTP exchange over a pooled keep-alive connection. Returns a
    response for ANY status the server answers with — status policy
    (retryable vs not) stays in http_send.

    Stale-socket retry-once: a connection-level failure on a REUSED
    socket before the status line arrives means the server closed an
    idle keep-alive connection — a normal race, not an endpoint failure
    — so the exchange transparently replays ONCE on a brand-new socket.
    Fresh-socket failures (and anything after the status line) propagate
    to the caller's retry/breaker logic unchanged."""
    parts = urllib.parse.urlsplit(url)
    scheme = parts.scheme or "http"
    host = parts.hostname or ""
    port = parts.port or (443 if scheme == "https" else 80)
    path = parts.path or "/"
    if parts.query:
        path = f"{path}?{parts.query}"
    conn, reused = _POOL.acquire(scheme, host, port, timeout)
    for attempt in (0, 1):
        try:
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
        except Exception:
            conn.close()
            if reused and attempt == 0:
                _POOL.stale_retries += 1
                conn, reused = _POOL._new(scheme, host, port, timeout), False
                continue
            raise
        try:
            # the body must be fully drained before the socket can carry
            # the next exchange; a mid-body failure is a REAL failure
            # (the server answered, then died) — no transparent replay
            entity = resp.read()
        except Exception:
            conn.close()
            raise
        if resp.will_close:
            conn.close()
        else:
            _POOL.release(scheme, host, port, conn)
        return HTTPResponseData(
            status_code=resp.status,
            reason=resp.reason or "",
            headers=dict(resp.getheaders()),
            entity=entity,
        )
    raise RuntimeError("unreachable")  # pragma: no cover


def http_send(
    req: HTTPRequestData,
    timeout: float = 60.0,
    retries: int = 3,
    backoff_ms: Sequence[int] = (100, 500, 1000),
    policy: "RetryPolicy | None" = None,
    breaker: "CircuitBreaker | None" = None,
) -> HTTPResponseData:
    """One request with the reference's retry semantics
    (HTTPClients.scala:64-105): retry on 429/5xx/connection errors, honor
    Retry-After (capped by the policy — an adversarial `Retry-After: 1e9`
    must not hang the pipeline thread), back off between attempts.

    Transport: pooled keep-alive connections (`_ConnectionPool`), so
    repeated sends to the same endpoint skip the TCP handshake. Breaker
    and retry accounting are UNCHANGED from the one-socket-per-request
    era: a stale reused socket replays once transparently inside
    `_send_once` without touching the breaker, while genuine connection
    failures still record_failure and surface as status 0."""
    if policy is None:
        policy = _legacy_policy(retries, backoff_ms)
    if breaker is not None and not breaker.allow():
        return _breaker_open_response(breaker)
    # W3C trace propagation: when a span is active, stamp (or REPLACE —
    # per-hop parent-id semantics) the traceparent header so the server
    # side binds its request span into this trace. No active span leaves
    # the caller's own headers untouched.
    headers = dict(req.headers or {})
    traceparent = current_traceparent()
    if traceparent is not None:
        headers = {k: v for k, v in headers.items()
                   if k.lower() != "traceparent"}
        headers["traceparent"] = traceparent
    sess = policy.session()
    last_exc: Exception | None = None
    while True:
        try:
            resp = _send_once(req.method, req.url, req.entity, headers,
                              timeout)
        except Exception as e:  # noqa: BLE001 — connection-level retry
            last_exc = e
            if breaker is not None:
                breaker.record_failure()
            if is_retryable_exception(e) and sess.should_retry():
                sess.backoff()
                continue
            return HTTPResponseData(
                status_code=0, reason=str(last_exc), entity=None)
        if resp.status_code >= 400 and is_retryable_status(resp.status_code):
            if breaker is not None:
                breaker.record_failure()
            if sess.should_retry():
                retry_after = _header(resp.headers, "Retry-After")
                try:
                    retry_after_s = (float(retry_after)
                                     if retry_after is not None else None)
                except ValueError:
                    retry_after_s = None
                sess.backoff(retry_after_s=retry_after_s)
                continue
            return resp
        if breaker is not None:
            # any answered status — including a non-retryable 4xx — means
            # the endpoint is healthy
            breaker.record_success()
        return resp


class _Target:
    """Per-URL pool state: in-flight count + manual health gate."""

    __slots__ = ("url", "inflight", "ejected", "eject_reason")

    def __init__(self, url: str):
        self.url = url
        self.inflight = 0
        self.ejected = False
        self.eject_reason = ""


def _stable_hash(s: str) -> int:
    """Process-independent 64-bit hash (builtin hash() is salted per
    process — a consistent-hash ring must agree across restarts)."""
    return int.from_bytes(
        hashlib.blake2b(s.encode(), digest_size=8).digest(), "big")


class _Lease:
    """Context manager pairing pick with in-flight accounting."""

    __slots__ = ("_pool", "url")

    def __init__(self, pool: "TargetPool", url: str):
        self._pool = pool
        self.url = url

    def __enter__(self) -> str:
        return self.url

    def __exit__(self, *exc) -> None:
        self._pool._release(self.url)


class TargetPool:
    """The one request-spreading primitive over a mutable set of replica
    base URLs (the reference's load balancer in front of per-executor
    servers, SURVEY.md §3.4). Thread-safe.

    Health is layered: each URL gets a per-endpoint CircuitBreaker (from
    `breakers`, a resilience.BreakerRegistry), and an independent manual
    eject/admit gate for probe-driven control (the gateway ejects on a
    failed /readyz and re-admits after probe success). A target is *live*
    when it is admitted AND its breaker is not open — half-open targets
    stay live so breaker probe traffic can heal them.

    Pick strategies:
      round_robin   next live target after a rotating cursor
      least_loaded  live target with the fewest in-flight leases
      hash          consistent hash of `key` over a virtual-node ring,
                    with a sticky binding remembered per key — a key
                    keeps its target until that target leaves the live
                    set (stateful/session-affine handlers). The ring
                    alone is NOT enough for stickiness: admitting a new
                    replica moves ~1/N of the ring, so a bare rehash
                    would silently re-home established streams onto a
                    replica that may not even speak their schema.
    """

    VNODES = 32  # virtual nodes per target on the hash ring
    STICKY_MAX = 65536  # remembered key bindings before oldest-first drop

    def __init__(self, urls: Sequence[str] = (),
                 breakers: "BreakerRegistry | None" = None,
                 clock=None, **breaker_kw):
        if breakers is None:
            from ..resilience.policy import SYSTEM_CLOCK

            breakers = BreakerRegistry(
                clock=clock if clock is not None else SYSTEM_CLOCK,
                **breaker_kw)
        self.breakers = breakers
        self._lock = make_lock("TargetPool._lock")
        self._targets: dict[str, _Target] = {}
        self._sticky: dict[str, str] = {}   # routing key -> bound url
        self._rr = itertools.count()
        for u in urls:
            self.add(u)

    # -- membership ----------------------------------------------------- #

    def add(self, url: str) -> None:
        with self._lock:
            if url not in self._targets:
                self._targets[url] = _Target(url)

    def remove(self, url: str) -> None:
        with self._lock:
            self._targets.pop(url, None)

    @property
    def urls(self) -> list[str]:
        with self._lock:
            return list(self._targets)

    # -- health gating -------------------------------------------------- #

    def eject(self, url: str, reason: str = "") -> bool:
        """Take a member out of rotation without forgetting it (breaker
        open / failed readiness probe). Returns True if state changed."""
        with self._lock:
            t = self._targets.get(url)
            if t is None or t.ejected:
                return False
            t.ejected = True
            t.eject_reason = reason
            return True

    def admit(self, url: str) -> bool:
        """Return an ejected member to rotation (adds it first if it is
        not yet a member — the rolling-swap admission path)."""
        with self._lock:
            t = self._targets.get(url)
            if t is None:
                t = self._targets[url] = _Target(url)
                return True
            changed = t.ejected
            t.ejected = False
            t.eject_reason = ""
            return changed

    def breaker_for(self, url: str) -> CircuitBreaker:
        return self.breakers.breaker_for(url)

    def _is_live(self, t: _Target) -> bool:
        return not t.ejected and \
            self.breakers.breaker_for(t.url).state != "open"

    def live(self) -> list[str]:
        with self._lock:
            targets = list(self._targets.values())
        return [t.url for t in targets if self._is_live(t)]

    # -- picking + accounting ------------------------------------------- #

    def pick(self, strategy: str = "round_robin", key: "str | None" = None,
             exclude: Sequence[str] = ()) -> "str | None":
        """One live target URL (None when the live set minus `exclude` is
        empty). `hash` strategy requires `key`."""
        with self._lock:
            targets = list(self._targets.values())
        live = [t for t in targets
                if t.url not in exclude and self._is_live(t)]
        if not live:
            return None
        if strategy == "hash" and key is not None:
            # sticky first: an established key stays home as long as its
            # replica is live, no matter how membership churns around it
            live_urls = {t.url for t in live}
            with self._lock:
                bound = self._sticky.get(key)
            if bound in live_urls:
                return bound
            ring = sorted(
                (_stable_hash(f"{t.url}#{v}"), t.url)
                for t in live for v in range(self.VNODES))
            point = _stable_hash(key)
            url = next((u for h, u in ring if h >= point), ring[0][1])
            with self._lock:
                self._sticky[key] = url
                while len(self._sticky) > self.STICKY_MAX:
                    self._sticky.pop(next(iter(self._sticky)))
            return url
        if strategy == "least_loaded":
            return min(live, key=lambda t: t.inflight).url
        # round_robin (and the hash strategy with no key)
        return live[next(self._rr) % len(live)].url

    def lease(self, url: str) -> _Lease:
        """In-flight accounting around one forwarded request — the
        least_loaded signal. Use as a context manager."""
        with self._lock:
            t = self._targets.get(url)
            if t is not None:
                t.inflight += 1
        return _Lease(self, url)

    def _release(self, url: str) -> None:
        with self._lock:
            t = self._targets.get(url)
            if t is not None and t.inflight > 0:
                t.inflight -= 1

    def inflight(self, url: str) -> int:
        with self._lock:
            t = self._targets.get(url)
            return t.inflight if t is not None else 0

    def states(self) -> dict[str, dict]:
        """The routing table: per-URL live/ejected/in-flight/breaker
        state (tools/diagnose.py prints this)."""
        with self._lock:
            targets = list(self._targets.values())
        return {t.url: {
            "live": self._is_live(t),
            "ejected": t.ejected,
            "eject_reason": t.eject_reason,
            "inflight": t.inflight,
            "breaker": self.breakers.breaker_for(t.url).state,
        } for t in targets}

    # -- sending -------------------------------------------------------- #

    @staticmethod
    def _rebase(req: HTTPRequestData, base: str) -> HTTPRequestData:
        """Point `req` at `base`, keeping its path+query: requests carry
        a path (or a full URL whose path is reused) and the pool decides
        the host."""
        path = req.url or "/"
        split = urllib.parse.urlsplit(path)
        if split.netloc:
            path = urllib.parse.urlunsplit(
                ("", "", split.path or "/", split.query, ""))
        return HTTPRequestData(
            method=req.method, url=urllib.parse.urljoin(base, path),
            headers=req.headers, entity=req.entity)

    def send(self, req: HTTPRequestData, timeout: float = 60.0,
             policy: "RetryPolicy | None" = None,
             strategy: str = "round_robin", key: "str | None" = None,
             retry_connect: bool = True,
             on_failover=None, target: "str | None" = None) -> HTTPResponseData:
        """Route one request to a picked live target. On a CONNECTION
        failure (status 0 — no HTTP answer, so resending is safe even
        mid-POST) the request is retried once against a different live
        target: a crashed replica costs a retry, not an error. So is a
        503 from a target that left the pool while the request was out:
        a retiring replica is removed before it is told to drain, and it
        sheds what reaches it after that with a 503 before doing any
        work, so the resend cannot run the request twice.
        `on_failover(url, resp)` observes the failed first attempt.

        `target` pins the request to one specific member instead of
        picking: lease accounting and the per-URL breaker still apply,
        but there is no failover — a claim/heartbeat protocol addressed
        to worker X must fail, not silently reach worker Y. The target
        must be a pool member (a directed send is still a routing
        decision, so membership is the authority); an unknown or
        ejected target answers 503 without a network attempt."""
        if target is not None:
            with self._lock:
                t = self._targets.get(target)
            if t is None or not self._is_live(t):
                return HTTPResponseData(
                    503, "target not live", entity=None,
                    headers={"Retry-After": "1"})
            with self.lease(target):
                return http_send(self._rebase(req, target), timeout=timeout,
                                 policy=policy,
                                 breaker=self.breaker_for(target))
        tried: list[str] = []
        resp = HTTPResponseData(503, "no live targets", entity=None,
                                headers={"Retry-After": "1"})
        for _ in range(2 if retry_connect else 1):
            url = self.pick(strategy=strategy, key=key, exclude=tried)
            if url is None and tried:
                # failover found no OTHER live target: retry the failed
                # one rather than erroring a request a recovering replica
                # could still serve
                url = self.pick(strategy=strategy, key=key)
            if url is None:
                return resp
            with self.lease(url):
                resp = http_send(self._rebase(req, url), timeout=timeout,
                                 policy=policy,
                                 breaker=self.breaker_for(url))
            if resp.status_code == 503 and retry_connect and not tried:
                with self._lock:
                    retired = url not in self._targets
                if retired:
                    tried.append(url)
                    continue
            if resp.status_code != 0:
                return resp
            tried.append(url)
            if on_failover is not None:
                on_failover(url, resp)
        return resp


class HTTPClient:
    """Batched sender. concurrency>1 = the reference's AsyncHTTPClient
    sliding window; 1 = SingleThreadedHTTPClient.

    `urls=[...]` turns on round-robin spreading over a replica set via a
    TargetPool (per-URL breakers, connection-failure failover to another
    replica) — the client-side version of the gateway's routing, for
    callers that talk to `ServingFleet.urls` directly. Each request's
    own `url` contributes only its path."""

    def __init__(self, concurrency: int = 1, timeout: float = 60.0,
                 retries: int = 3, policy: "RetryPolicy | None" = None,
                 breaker: "CircuitBreaker | None" = None,
                 urls: "Sequence[str] | None" = None,
                 pool: "TargetPool | None" = None):
        self.concurrency = concurrency
        self.timeout = timeout
        self.retries = retries
        self.policy = policy
        self.breaker = breaker
        if pool is None and urls:
            pool = TargetPool(urls)
        self.pool = pool

    def send_all(self, reqs: Iterable[HTTPRequestData]) -> list[HTTPResponseData]:
        if self.pool is not None:
            fn = lambda r: self.pool.send(  # noqa: E731
                r, timeout=self.timeout, policy=self.policy)
        else:
            fn = lambda r: http_send(  # noqa: E731
                r, timeout=self.timeout, retries=self.retries,
                policy=self.policy, breaker=self.breaker)
        if self.concurrency <= 1:
            return [fn(r) for r in reqs]
        return list(buffered_map(fn, list(reqs), self.concurrency))
