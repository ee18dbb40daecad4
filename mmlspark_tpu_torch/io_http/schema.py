"""HTTP request/response records on Tables.

A copy of mmlspark_tpu/io_http/schema.py.

Reference: `HTTPSchema` (src/io/http/src/main/scala/HTTPSchema.scala:35-188)
defines full request/response StructTypes via SparkBindings; `parse_request`
/`make_reply` from ServingImplicits.scala:58-88. Here requests/responses are
plain dataclasses stored in object columns — the Table equivalent of the
reference's struct columns.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from ..core.schema import Table

__all__ = ["HTTPRequestData", "HTTPResponseData", "parse_request",
           "make_reply", "RequestDecoder"]


@dataclass
class HTTPRequestData:
    """Reference: HTTPSchema request StructType (HTTPSchema.scala:121-160)."""

    method: str = "POST"
    url: str = ""
    headers: dict[str, str] = field(default_factory=dict)
    entity: bytes | None = None

    def json(self) -> Any:
        return json.loads(self.entity.decode()) if self.entity else None

    @staticmethod
    def from_json(url: str, payload: Any, method: str = "POST",
                  headers: dict[str, str] | None = None) -> "HTTPRequestData":
        h = {"Content-Type": "application/json", **(headers or {})}
        return HTTPRequestData(
            method=method, url=url, headers=h,
            entity=json.dumps(payload).encode(),
        )


@dataclass
class HTTPResponseData:
    """Reference: HTTPSchema response StructType (HTTPSchema.scala:60-119)."""

    status_code: int = 0
    reason: str = ""
    headers: dict[str, str] = field(default_factory=dict)
    entity: bytes | None = None

    @property
    def ok(self) -> bool:
        return 200 <= self.status_code < 300

    def json(self) -> Any:
        return json.loads(self.entity.decode()) if self.entity else None

    def text(self) -> str:
        return self.entity.decode() if self.entity else ""


def parse_request(table: Table, request_col: str = "request",
                  output_col: str | None = None, flatten_json: bool = True) -> Table:
    """Serving-side: request column -> parsed body column
    (ServingImplicits.parseRequest, ServingImplicits.scala:58-70)."""
    reqs = table[request_col]
    bodies = [r.json() if isinstance(r, HTTPRequestData) else r for r in reqs]
    if flatten_json and bodies and all(isinstance(b, dict) for b in bodies):
        keys: list[str] = []
        for b in bodies:
            for k in b:
                if k not in keys:
                    keys.append(k)
        new_cols: dict[str, Any] = {}
        for k in keys:
            vals = [b.get(k) for b in bodies]
            if all(isinstance(v, (int, float, bool, type(None))) for v in vals):
                new_cols[k] = np.asarray(
                    [np.nan if v is None else v for v in vals], np.float64)
            elif all(isinstance(v, list) for v in vals):
                try:
                    new_cols[k] = np.asarray(vals, np.float64)
                except (ValueError, TypeError):
                    new_cols[k] = vals
            else:
                new_cols[k] = vals
        # one functional update: a per-key with_column chain re-copies the
        # table once per JSON field on every request
        return table.with_columns(new_cols)
    col = output_col or "body"
    return table.with_column(col, bodies)


class RequestDecoder:
    """Schema-cached fast-path decoder: request batch -> one preallocated
    feature matrix, no Table in between.

    `parse_request` re-infers every column's dtype on EVERY request (an
    isinstance scan per value per field) and materializes one object list
    plus one ndarray per field before the handler stacks them again into a
    feature matrix — two full copies of the batch per request.  A serving
    server scores the SAME schema for its whole life, so this decoder
    locks the schema once — the input column list at construction, float64
    scalars confirmed by the first successfully decoded request — and from
    then on decodes each JSON body straight into its row of a preallocated
    `(target, n_cols)` float64 array (padding rows repeat the last real
    row, the batcher's bucket-ladder convention).

    Anything outside the locked schema — a missing field, a non-scalar
    value, a non-JSON body — returns None instead of guessing: the caller
    falls back to the full `parse_request` handler path, which either
    scores the request the slow way or raises the same errors it always
    did.  `null` decodes to NaN, booleans to 0/1, exactly as
    `parse_request`'s float64 conversion would.

    Binary-wire requests (Content-Type `application/x-mmlspark-rows`,
    io_http/wire.py) skip JSON entirely: the frame's `features` block is
    `np.frombuffer`-decoded straight into the same preallocated matrix.
    JSON and binary requests mix freely within one batch."""

    def __init__(self, input_cols: "list[str] | tuple[str, ...]"):
        self.cols = tuple(input_cols)
        self.schema_locked = False
        self.hits = 0
        self.fallbacks = 0
        self.binary_hits = 0

    def decode(self, requests: list, n_target: "int | None" = None
               ) -> "np.ndarray | None":
        """(n_target, n_cols) float64 features, or None when any request
        falls outside the cached schema."""
        from .wire import (content_type_of, decode_features_request,
                           is_wire_content_type)

        n = len(requests)
        if n == 0:
            return None
        target = n if n_target is None else int(n_target)
        out = np.empty((target, len(self.cols)), np.float64)
        cols = self.cols
        binary = 0
        try:
            for i, r in enumerate(requests):
                entity = r.entity if isinstance(r, HTTPRequestData) else None
                if entity and is_wire_content_type(
                        content_type_of(r.headers)):
                    # zero-copy lane: raw f64 bytes -> this row, no parse
                    out[i] = decode_features_request(entity, len(cols))[0]
                    binary += 1
                    continue
                body = json.loads(entity) if entity else None
                row = out[i]
                for j, c in enumerate(cols):
                    v = body[c]
                    if v is None:
                        row[j] = np.nan
                    elif isinstance(v, (int, float)):  # bool is an int
                        row[j] = v
                    else:
                        raise TypeError(f"non-scalar field {c!r}")
        except (TypeError, KeyError, ValueError, AttributeError):
            self.fallbacks += 1
            return None
        self.binary_hits += binary
        if target > n:
            out[n:] = out[n - 1]
        self.schema_locked = True
        self.hits += 1
        return out


def make_reply(table: Table, value_col: str, reply_col: str = "reply") -> Table:
    """Serving-side: column -> JSON reply column
    (ServingImplicits.makeReply, ServingImplicits.scala:73-88)."""
    vals = table[value_col]
    replies = []
    for v in (vals.tolist() if isinstance(vals, np.ndarray) else vals):
        replies.append(HTTPResponseData(
            status_code=200, reason="OK",
            headers={"Content-Type": "application/json"},
            entity=json.dumps({value_col: v}).encode(),
        ))
    return table.with_column(reply_col, replies)
