"""AzureSearch-style indexed sink.

Reference: src/io/http/src/main/scala/cognitive/AzureSearch.scala:23-249
(`AzureSearchWriter`: checks/creates the index, then streams document
batches through `AddDocuments`) and `AzureSearchAPI.scala:19-211` (index
CRUD + per-item error checking).

The wire format follows the Azure Search REST API (api-key header,
api-version query param, `{"value": [{"@search.action": ..., ...doc}]}`
upload bodies), so the stage points at a live service or a local fake
equally.

A copy of mmlspark_tpu/io_http/search.py.
"""

from __future__ import annotations

from typing import Any, Callable

from ..core.params import Param
from ..core.pipeline import Transformer
from ..core.schema import Table, as_scalar
from ..core.serialize import register_stage
from .schema import HTTPRequestData, HTTPResponseData

__all__ = ["AzureSearchWriter"]

API_VERSION = "2017-11-11"  # the version the reference pins (AzureSearch.scala)


@register_stage
class AzureSearchWriter(Transformer):
    """Write table rows as documents into a search index (sink stage: the
    output table is the input, unchanged).

    `index_definition` is the service's index-schema JSON (name + fields);
    if the index does not exist it is created first
    (AzureSearchAPI.scala:60-120 createIndexIfNotExists).
    """

    service_url = Param(None, "search service base url", ptype=str, required=True)
    index_definition = Param(None, "index schema dict: {name, fields:[...]}",
                             ptype=dict, required=True)
    api_key = Param(None, "admin api key (api-key header)", ptype=str)
    action = Param("upload", "upload | merge | mergeOrUpload | delete", ptype=str)
    action_col = Param(None, "column overriding the action per row", ptype=str)
    batch_size = Param(100, "documents per upload batch", ptype=int)
    columns = Param(None, "columns to index (default: all non-action columns)",
                    ptype=(list, tuple))

    handler: Callable | None = None  # test hook: request -> HTTPResponseData

    def _headers(self) -> dict[str, str]:
        h = {"Content-Type": "application/json"}
        if self.get("api_key"):
            h["api-key"] = self.get("api_key")
        return h

    def _send(self, req: HTTPRequestData) -> HTTPResponseData:
        if self.handler is not None:
            return self.handler(req)
        from .clients import http_send

        return http_send(req)

    def _index_name(self) -> str:
        name = (self.get("index_definition") or {}).get("name")
        if not name:
            raise ValueError("index_definition must carry a 'name'")
        return name

    def _ensure_index(self) -> None:
        base = self.get("service_url").rstrip("/")
        name = self._index_name()
        probe = HTTPRequestData(
            method="GET",
            url=f"{base}/indexes/{name}?api-version={API_VERSION}",
            headers=self._headers(),
        )
        resp = self._send(probe)
        if isinstance(resp, HTTPResponseData) and resp.ok:
            return
        if getattr(resp, "status_code", 0) != 404:
            raise IOError(f"index probe failed: {getattr(resp, 'status_code', 0)}")
        create = HTTPRequestData.from_json(
            f"{base}/indexes?api-version={API_VERSION}",
            self.get("index_definition"),
            headers=self._headers(),
        )
        resp = self._send(create)
        if not (isinstance(resp, HTTPResponseData) and resp.ok):
            raise IOError(
                f"index creation failed: {getattr(resp, 'status_code', 0)} "
                f"{getattr(resp, 'reason', '')}"
            )

    def _transform(self, table: Table) -> Table:
        self._ensure_index()
        base = self.get("service_url").rstrip("/")
        name = self._index_name()
        url = f"{base}/indexes/{name}/docs/index?api-version={API_VERSION}"
        cols = list(self.get("columns") or table.columns)
        action_col = self.get("action_col")
        if action_col and action_col in cols:
            cols.remove(action_col)
        n = table.num_rows
        bs = max(int(self.get("batch_size")), 1)
        for start in range(0, n, bs):
            stop = min(start + bs, n)
            docs = []
            for i in range(start, stop):
                doc: dict[str, Any] = {
                    "@search.action": (
                        as_scalar(table[action_col][i]) if action_col
                        else self.get("action")
                    )
                }
                for c in cols:
                    doc[c] = as_scalar(table[c][i])
                docs.append(doc)
            resp = self._send(HTTPRequestData.from_json(
                url, {"value": docs}, headers=self._headers()
            ))
            if not (isinstance(resp, HTTPResponseData) and resp.ok):
                raise IOError(
                    f"document upload failed: {getattr(resp, 'status_code', 0)}"
                )
            # per-item status check (AzureSearchAPI.scala:150-211)
            items = (resp.json() or {}).get("value", [])
            bad = [it for it in items if not it.get("status", True)]
            if bad:
                raise IOError(f"{len(bad)} documents rejected: {bad[:3]}")
        return table
