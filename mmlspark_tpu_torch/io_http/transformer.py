"""HTTPTransformer + SimpleHTTPTransformer + parsers.

Reference: `HTTPTransformer` (src/io/http/src/main/scala/HTTPTransformer.
scala:78-128: request column -> response column with per-partition async
client), `SimpleHTTPTransformer` (SimpleHTTPTransformer.scala:61+: input
parser → HTTP → output parser mini-pipeline with optional error column),
parsers (Parsers.scala:21-227: JSONInput/CustomInput/JSONOutput/StringOutput/
CustomOutput).

A copy of mmlspark_tpu/io_http/transformer.py.
"""

from __future__ import annotations

import json
from typing import Any, Callable

import numpy as np

from ..core.params import HasInputCol, HasOutputCol, Param
from ..core.pipeline import Transformer
from ..core.schema import Table
from ..core.serialize import register_stage
from ..utils.async_utils import buffered_map
from .clients import HTTPClient, TargetPool
from .schema import HTTPRequestData, HTTPResponseData

__all__ = [
    "HTTPTransformer",
    "DistributedHTTPTransformer",
    "SimpleHTTPTransformer",
    "JSONInputParser",
    "JSONOutputParser",
    "StringOutputParser",
    "CustomInputParser",
    "CustomOutputParser",
]


@register_stage
class HTTPTransformer(HasInputCol, HasOutputCol, Transformer):
    """Request column -> response column (HTTPTransformer.scala:78-128)."""

    input_col = Param("request", "HTTPRequestData column", ptype=str)
    output_col = Param("response", "HTTPResponseData column", ptype=str)
    concurrency = Param(1, "in-flight requests per call", ptype=int)
    timeout = Param(60.0, "per-request timeout (s)", ptype=float)
    retries = Param(3, "retry attempts (429/5xx/conn)", ptype=int)

    handler: Callable | None = None  # test hook: req -> HTTPResponseData
    # optional resilience overrides (runtime wiring, not serialized):
    # a RetryPolicy replaces the retries ladder, a CircuitBreaker guards
    # the endpoint (open circuit -> synthetic 503 responses)
    retry_policy = None
    breaker = None

    def _transform(self, table: Table) -> Table:
        reqs = table[self.get("input_col")]
        if self.handler is not None:
            resps = [self.handler(r) for r in reqs]
        else:
            client = HTTPClient(
                concurrency=self.get("concurrency"),
                timeout=self.get("timeout"),
                retries=self.get("retries"),
                policy=self.retry_policy,
                breaker=self.breaker,
            )
            resps = client.send_all(list(reqs))
        return table.with_column(self.get("output_col"), resps)


@register_stage
class DistributedHTTPTransformer(HasInputCol, HasOutputCol, Transformer):
    """Request column -> response column spread over a REPLICA SET — the
    client-side load-balancer role of the reference's distributed serving
    mode (per-executor servers behind a balancer, SURVEY.md §3.4).

    Routing goes through io_http.clients.TargetPool — the same primitive
    ServingGateway uses — so every row gets per-replica circuit breakers
    and one automatic failover to a different replica on a connection
    failure. `routing_key_col` switches to consistent-hash routing on
    that column's values (session affinity for stateful handlers)."""

    input_col = Param("request", "HTTPRequestData column", ptype=str)
    output_col = Param("response", "HTTPResponseData column", ptype=str)
    urls = Param(None, "replica base URLs to spread over",
                 ptype=(list, tuple), required=True)
    strategy = Param("round_robin",
                     "'round_robin' or 'least_loaded' replica pick",
                     ptype=str)
    routing_key_col = Param(None, "column whose values consistent-hash "
                            "each row to a replica", ptype=str)
    concurrency = Param(1, "in-flight requests per call", ptype=int)
    timeout = Param(60.0, "per-request timeout (s)", ptype=float)

    handler: Callable | None = None  # test hook: req -> HTTPResponseData
    retry_policy = None              # runtime wiring, not serialized
    _pool: "TargetPool | None" = None

    @property
    def pool(self) -> TargetPool:
        """Pool (and its breakers) persists across transform calls, so
        replica health learned in one batch guards the next."""
        if self._pool is None:
            self._pool = TargetPool(list(self.get("urls")))
        return self._pool

    def _transform(self, table: Table) -> Table:
        reqs = list(table[self.get("input_col")])
        if self.handler is not None:
            resps = [self.handler(r) for r in reqs]
            return table.with_column(self.get("output_col"), resps)
        key_col = self.get("routing_key_col")
        keys = ([str(k) for k in table[key_col]] if key_col
                else [None] * len(reqs))
        pool = self.pool

        def send(pair):
            req, key = pair
            return pool.send(
                req, timeout=self.get("timeout"), policy=self.retry_policy,
                strategy=("hash" if key is not None
                          else self.get("strategy")), key=key)

        pairs = list(zip(reqs, keys))
        if self.get("concurrency") <= 1:
            resps = [send(p) for p in pairs]
        else:
            resps = list(buffered_map(send, pairs, self.get("concurrency")))
        return table.with_column(self.get("output_col"), resps)


@register_stage
class JSONInputParser(HasInputCol, HasOutputCol, Transformer):
    """Column value -> JSON POST request (Parsers.scala:60-89)."""

    input_col = Param("input", "column with JSON-able payloads", ptype=str)
    output_col = Param("request", "HTTPRequestData output column", ptype=str)
    url = Param(None, "target URL", ptype=str, required=True)
    method = Param("POST", "HTTP method", ptype=str)
    headers = Param({}, "extra headers")

    def _transform(self, table: Table) -> Table:
        col = table[self.get("input_col")]
        vals = col.tolist() if isinstance(col, np.ndarray) else col
        reqs = [
            HTTPRequestData.from_json(
                self.get("url"), v, self.get("method"), dict(self.get("headers"))
            )
            for v in vals
        ]
        return table.with_column(self.get("output_col"), reqs)


@register_stage
class CustomInputParser(HasInputCol, HasOutputCol, Transformer):
    """udf column -> request (Parsers.scala:91-108)."""

    input_col = Param("input", "input column", ptype=str)
    output_col = Param("request", "request output column", ptype=str)

    udf: Callable[[Any], HTTPRequestData] | None = None

    def _transform(self, table: Table) -> Table:
        if self.udf is None:
            raise ValueError("CustomInputParser needs a udf")
        col = table[self.get("input_col")]
        vals = col.tolist() if isinstance(col, np.ndarray) else col
        return table.with_column(self.get("output_col"), [self.udf(v) for v in vals])


@register_stage
class JSONOutputParser(HasInputCol, HasOutputCol, Transformer):
    """Response -> parsed JSON body (Parsers.scala:110-162)."""

    input_col = Param("response", "HTTPResponseData column", ptype=str)
    output_col = Param("output", "parsed output column", ptype=str)
    field_path = Param(None, "dotted path into the JSON body", ptype=str)

    def _transform(self, table: Table) -> Table:
        out = []
        for r in table[self.get("input_col")]:
            body = r.json() if isinstance(r, HTTPResponseData) and r.ok else None
            if body is not None and self.get("field_path"):
                for part in self.get("field_path").split("."):
                    if body is None:
                        break
                    body = body.get(part) if isinstance(body, dict) else None
            out.append(body)
        return table.with_column(self.get("output_col"), out)


@register_stage
class StringOutputParser(HasInputCol, HasOutputCol, Transformer):
    """Response -> body text (Parsers.scala:164-180)."""

    input_col = Param("response", "HTTPResponseData column", ptype=str)
    output_col = Param("output", "text output column", ptype=str)

    def _transform(self, table: Table) -> Table:
        out = [
            r.text() if isinstance(r, HTTPResponseData) else str(r)
            for r in table[self.get("input_col")]
        ]
        return table.with_column(self.get("output_col"), out)


@register_stage
class CustomOutputParser(HasInputCol, HasOutputCol, Transformer):
    """udf response -> value (Parsers.scala:182-199)."""

    input_col = Param("response", "HTTPResponseData column", ptype=str)
    output_col = Param("output", "output column", ptype=str)

    udf: Callable[[HTTPResponseData], Any] | None = None

    def _transform(self, table: Table) -> Table:
        if self.udf is None:
            raise ValueError("CustomOutputParser needs a udf")
        return table.with_column(
            self.get("output_col"),
            [self.udf(r) for r in table[self.get("input_col")]],
        )


@register_stage
class SimpleHTTPTransformer(HasInputCol, HasOutputCol, Transformer):
    """input parser → HTTP → output parser, with optional error column
    (SimpleHTTPTransformer.scala:61+, error col :18-26)."""

    input_col = Param("input", "payload column", ptype=str)
    output_col = Param("output", "parsed output column", ptype=str)
    url = Param(None, "target URL (JSON input parser)", ptype=str)
    concurrency = Param(1, "in-flight requests", ptype=int)
    timeout = Param(60.0, "request timeout (s)", ptype=float)
    retries = Param(3, "retry attempts (429/5xx/conn)", ptype=int)
    error_col = Param(None, "error-info column (None = raise on HTTP error)", ptype=str)
    flatten_output_field = Param(None, "dotted path into response JSON", ptype=str)

    input_parser: Transformer | None = None
    output_parser: Transformer | None = None
    handler: Callable | None = None  # test hook passed to HTTPTransformer
    retry_policy = None              # forwarded to HTTPTransformer
    breaker = None

    def _transform(self, table: Table) -> Table:
        inp = self.input_parser or JSONInputParser(
            input_col=self.get("input_col"), output_col="__http_request",
            url=self.get("url"),
        )
        if self.input_parser is not None:
            inp = inp.copy({"input_col": self.get("input_col"),
                            "output_col": "__http_request"})
        http = HTTPTransformer(
            input_col="__http_request", output_col="__http_response",
            concurrency=self.get("concurrency"), timeout=self.get("timeout"),
            retries=self.get("retries"),
        )
        http.handler = self.handler
        http.retry_policy = self.retry_policy
        http.breaker = self.breaker
        outp = self.output_parser or JSONOutputParser(
            input_col="__http_response", output_col=self.get("output_col"),
            field_path=self.get("flatten_output_field"),
        )
        if self.output_parser is not None:
            outp = outp.copy({"input_col": "__http_response",
                              "output_col": self.get("output_col")})

        t = outp.transform(http.transform(inp.transform(table)))
        resps = t["__http_response"]
        err_col = self.get("error_col")
        if err_col:
            errors = [
                None if (isinstance(r, HTTPResponseData) and r.ok)
                else {"status_code": getattr(r, "status_code", 0),
                      "reason": getattr(r, "reason", "")}
                for r in resps
            ]
            t = t.with_column(err_col, errors)
        else:
            bad = [r for r in resps if not (isinstance(r, HTTPResponseData) and r.ok)]
            if bad:
                raise IOError(
                    f"{len(bad)} HTTP failures (first: {bad[0].status_code} "
                    f"{bad[0].reason}); set error_col to capture instead"
                )
        return t.drop("__http_request", "__http_response")
