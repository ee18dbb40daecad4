"""PowerBIWriter — push Table rows to a PowerBI streaming dataset URL.

Reference: src/io/powerbi/src/main/scala/PowerBIWriter.scala:25-112 — batch
`write` (:98) and streaming `stream` (:94) both POST JSON row arrays through
an HTTPTransformer.

A copy of mmlspark_tpu/io_http/powerbi.py."""

from __future__ import annotations

import json
from typing import Any, Iterable

import numpy as np

from ..core.schema import Table
from .clients import HTTPClient
from .schema import HTTPRequestData

__all__ = ["PowerBIWriter"]


class PowerBIWriter:
    @staticmethod
    def write(table: Table, url: str, batch_size: int = 100,
              concurrency: int = 1, client: HTTPClient | None = None) -> int:
        """POST rows as JSON arrays in batches; returns request count.
        (PowerBIWriter.write, PowerBIWriter.scala:98-107)."""
        rows = []
        for row in table.rows():
            clean = {}
            for k, v in row.items():
                if isinstance(v, np.generic):
                    v = v.item()
                elif isinstance(v, np.ndarray):
                    v = v.tolist()
                elif isinstance(v, bytes):
                    continue
                clean[k] = v
            rows.append(clean)
        reqs = [
            HTTPRequestData.from_json(url, rows[i : i + batch_size])
            for i in range(0, len(rows), batch_size)
        ]
        client = client or HTTPClient(concurrency=concurrency)
        resps = client.send_all(reqs)
        bad = [r for r in resps if not r.ok]
        if bad:
            raise IOError(
                f"PowerBI write: {len(bad)}/{len(resps)} batches failed "
                f"(first: {bad[0].status_code} {bad[0].reason})"
            )
        return len(reqs)

    @staticmethod
    def stream(tables: Iterable[Table], url: str, **kw) -> int:
        """Streaming variant: one write per incoming micro-batch table
        (PowerBIWriter.stream, PowerBIWriter.scala:94)."""
        n = 0
        for t in tables:
            n += PowerBIWriter.write(t, url, **kw)
        return n
