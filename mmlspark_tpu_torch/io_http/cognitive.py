"""Cognitive-Services-style typed REST transformers.

Reference: src/io/http/src/main/scala/cognitive/ — `CognitiveServicesBase`
(CognitiveServiceBase.scala:247-305: builds Lambda → SimpleHTTPTransformer →
DropColumns pipeline), `ServiceParam`/`HasServiceParams` (:25-148, the
scalar-or-column params — mirrored by core.params.ServiceParam), and the
typed stages: TextAnalytics (TextAnalytics.scala:31-258), ComputerVision
(ComputerVision.scala:157-460), Face (Face.scala:19-347).

The request/response wire formats follow the reference's Azure API bodies so
a reference user's integration code ports directly; `url` points anywhere
(tests use a local fake service — live cloud endpoints are simply a
different url + subscription_key).

A copy of mmlspark_tpu/io_http/cognitive.py.
"""

from __future__ import annotations

import json
from typing import Any, Callable

from ..core.params import HasOutputCol, Param, ServiceParam
from ..core.pipeline import Transformer
from ..core.schema import Table
from ..core.serialize import register_stage
from ..resilience.policy import SYSTEM_CLOCK
from .clients import HTTPClient
from .schema import HTTPRequestData, HTTPResponseData

__all__ = [
    "CognitiveServiceBase",
    "TextSentiment",
    "LanguageDetector",
    "EntityDetector",
    "KeyPhraseExtractor",
    "NER",
    "OCR",
    "RecognizeText",
    "GenerateThumbnails",
    "TagImage",
    "DescribeImage",
    "AnalyzeImage",
    "DetectFace",
    "FindSimilarFace",
    "GroupFaces",
    "IdentifyFaces",
    "VerifyFaces",
    "BingImageSearch",
]


class CognitiveServiceBase(HasOutputCol, Transformer):
    """Shared plumbing: build one request per row from ServiceParams, send
    with retry/concurrency, parse JSON (CognitiveServiceBase.scala:247-305)."""

    url = Param(None, "service endpoint URL", ptype=str, required=True)
    subscription_key = Param(None, "api key (header)", ptype=str)
    output_col = Param("response", "parsed output column", ptype=str)
    error_col = Param(None, "error column (None = raise)", ptype=str)
    concurrency = Param(1, "in-flight requests", ptype=int)
    timeout = Param(60.0, "request timeout (s)", ptype=float)
    retries = Param(3, "retry attempts (429/5xx/conn)", ptype=int)

    handler: Callable | None = None  # test hook: request -> HTTPResponseData
    # optional resilience wiring (runtime attrs, not serialized): an open
    # breaker answers synthetic 503s locally, which flow into error_col
    # (or the raise path) like any other service failure
    retry_policy = None
    breaker = None
    clock = SYSTEM_CLOCK                 # paces async-poll waits; injectable

    # subclasses build the per-row request body
    def _row_body(self, row_vals: dict[str, Any], i: int) -> Any:
        raise NotImplementedError

    def _headers(self) -> dict[str, str]:
        h = {"Content-Type": "application/json"}
        if self.get("subscription_key"):
            h["Ocp-Apim-Subscription-Key"] = self.get("subscription_key")
        return h

    def _service_values(self, table: Table) -> dict[str, list[Any]]:
        vals = {}
        for name, p in self._params.items():
            if isinstance(p, ServiceParam):
                v = p.resolve(self, table)
                if v is not None:
                    vals[name] = v
        return vals

    def _row_request(self, row_vals: dict[str, Any], i: int) -> HTTPRequestData:
        """Default: POST the JSON body; GET-style stages override."""
        return HTTPRequestData.from_json(
            self.get("url"), self._row_body(row_vals, i), headers=self._headers()
        )

    def _guarded_handler(self, req: HTTPRequestData) -> HTTPResponseData:
        """The handler hook routed through the breaker, mirroring what
        http_send does for real traffic: open circuit answers a local 503
        (which flows to error_col), outcomes feed the rolling window."""
        from ..resilience.policy import is_retryable_status
        from .clients import _breaker_open_response

        if self.breaker is None:
            return self.handler(req)
        if not self.breaker.allow():
            return _breaker_open_response(self.breaker)
        try:
            r = self.handler(req)
        except Exception:
            self.breaker.record_failure()
            raise
        if isinstance(r, HTTPResponseData) and \
                is_retryable_status(r.status_code):
            self.breaker.record_failure()
        else:
            self.breaker.record_success()
        return r

    def _send_one(self, req: HTTPRequestData) -> HTTPResponseData:
        if self.handler is not None:
            return self._guarded_handler(req)
        from .clients import http_send

        return http_send(req, timeout=self.get("timeout"),
                         retries=self.get("retries"),
                         policy=self.retry_policy, breaker=self.breaker)

    def _exchange(self, reqs: list[HTTPRequestData]) -> list[HTTPResponseData]:
        if self.handler is not None:
            return [self._guarded_handler(r) for r in reqs]
        client = HTTPClient(concurrency=self.get("concurrency"),
                            timeout=self.get("timeout"),
                            retries=self.get("retries"),
                            policy=self.retry_policy, breaker=self.breaker)
        return client.send_all(reqs)

    def _transform(self, table: Table) -> Table:
        n = table.num_rows
        sv = self._service_values(table)
        reqs = []
        for i in range(n):
            row_vals = {k: v[i] for k, v in sv.items()}
            reqs.append(self._row_request(row_vals, i))
        resps = self._exchange(reqs)
        parsed, errors = [], []
        for r in resps:
            if isinstance(r, HTTPResponseData) and r.ok:
                parsed.append(self._parse(r))
                errors.append(None)
            else:
                parsed.append(None)
                errors.append({"status_code": getattr(r, "status_code", 0),
                               "reason": getattr(r, "reason", "")})
        if self.get("error_col"):
            table = table.with_column(self.get("error_col"), errors)
        elif any(e is not None for e in errors):
            first = next(e for e in errors if e is not None)
            raise IOError(f"cognitive service error: {first}")
        return table.with_column(self.get("output_col"), parsed)

    def _parse(self, resp: HTTPResponseData) -> Any:
        return resp.json()


class _TextAnalyticsBase(CognitiveServiceBase):
    """documents[] body shape (TextAnalytics.scala:31-120)."""

    text = ServiceParam(None, "text to analyze (scalar or column)")
    language = ServiceParam("en", "language hint")

    def _row_body(self, row_vals, i):
        return {"documents": [{
            "id": str(i),
            "language": row_vals.get("language", "en"),
            "text": row_vals.get("text", ""),
        }]}

    def _parse(self, resp):
        docs = (resp.json() or {}).get("documents", [])
        return docs[0] if docs else None


@register_stage
class TextSentiment(_TextAnalyticsBase):
    """Reference: TextSentiment (TextAnalytics.scala:214-258). Output: the
    document's sentiment payload (score field)."""


@register_stage
class LanguageDetector(_TextAnalyticsBase):
    """Reference: LanguageDetector (TextAnalytics.scala:122-160)."""

    def _row_body(self, row_vals, i):
        return {"documents": [{"id": str(i), "text": row_vals.get("text", "")}]}


@register_stage
class EntityDetector(_TextAnalyticsBase):
    """Reference: EntityDetector (TextAnalytics.scala:162-190)."""


@register_stage
class KeyPhraseExtractor(_TextAnalyticsBase):
    """Reference: KeyPhraseExtractor (TextAnalytics.scala:192-212)."""


class _VisionBase(CognitiveServiceBase):
    """image url-or-bytes body (ComputerVision.scala:157-220)."""

    image_url = ServiceParam(None, "image URL (scalar or column)")
    image_bytes = ServiceParam(None, "raw image bytes (column)")

    def _row_body(self, row_vals, i):
        if row_vals.get("image_url"):
            return {"url": row_vals["image_url"]}
        data = row_vals.get("image_bytes")
        if data is None:
            raise ValueError("need image_url or image_bytes")
        import base64

        return {"data": base64.b64encode(bytes(data)).decode()}


@register_stage
class OCR(_VisionBase):
    """Reference: OCR (ComputerVision.scala:157-190)."""

    detect_orientation = Param(True, "detect text orientation", ptype=bool)


@register_stage
class AnalyzeImage(_VisionBase):
    """Reference: AnalyzeImage (ComputerVision.scala:300-360)."""

    visual_features = Param(["Categories"], "feature list")

    def _row_body(self, row_vals, i):
        body = _VisionBase._row_body(self, row_vals, i)
        body["visualFeatures"] = list(self.get("visual_features"))
        return body


@register_stage
class DetectFace(_VisionBase):
    """Reference: DetectFace (Face.scala:19-80)."""

    return_face_landmarks = Param(False, "include landmarks", ptype=bool)
    return_face_attributes = Param([], "attribute list")

    def _row_body(self, row_vals, i):
        body = _VisionBase._row_body(self, row_vals, i)
        body["returnFaceLandmarks"] = bool(self.get("return_face_landmarks"))
        if self.get("return_face_attributes"):
            body["returnFaceAttributes"] = ",".join(self.get("return_face_attributes"))
        return body


@register_stage
class NER(_TextAnalyticsBase):
    """Named-entity recognition (reference: NER, TextAnalytics.scala:31-120).
    Output: the document payload with its `entities` list."""


class _AsyncPollBase(_VisionBase):
    """Async-poll pattern (reference RecognizeText's `FixedPollingHandler`,
    ComputerVision.scala:192-278): the initial POST answers 202 with an
    `Operation-Location` header; the result is GET-polled from there until
    status leaves "Running"/"NotStarted"."""

    # seconds-scale budget like the reference's polling handler — real async
    # recognition takes several seconds (~5 min total here before giving up)
    poll_interval_s = Param(1.0, "delay between result polls (s)", ptype=float)
    max_polls = Param(300, "poll attempts before giving up", ptype=int)

    def _poll_operation(self, resp: HTTPResponseData) -> HTTPResponseData:
        if not (isinstance(resp, HTTPResponseData) and resp.status_code == 202):
            return resp
        loc = resp.headers.get("Operation-Location") or resp.headers.get(
            "operation-location"
        )
        if not loc:
            return HTTPResponseData(502, "202 without Operation-Location")
        poll_req = HTTPRequestData(method="GET", url=loc, headers=self._headers())
        for _ in range(int(self.get("max_polls"))):
            r = self._send_one(poll_req)
            if not (isinstance(r, HTTPResponseData) and r.ok):
                return r
            status = (r.json() or {}).get("status", "")
            if status == "Failed":
                # terminal failure is an ERROR, not a parsed success — route
                # through the error_col/raise path with the payload attached
                return HTTPResponseData(502, "async operation Failed",
                                        dict(r.headers), r.entity)
            if status not in ("Running", "NotStarted", ""):
                return r
            self.clock.sleep(self.get("poll_interval_s"))
        return HTTPResponseData(504, "poll limit reached")

    def _exchange(self, reqs):
        from ..utils.async_utils import buffered_map

        initial = CognitiveServiceBase._exchange(self, reqs)
        # rows poll concurrently through the same window width as the
        # initial requests — sequential polling would sum every row's wait
        return list(buffered_map(self._poll_operation, initial,
                                 max(int(self.get("concurrency")), 1)))


@register_stage
class RecognizeText(_AsyncPollBase):
    """Async text recognition (ComputerVision.scala:192-278). Output: the
    final operation payload (`recognitionResult` with lines/words)."""

    mode = Param("Printed", "Printed | Handwritten", ptype=str)

    def _row_request(self, row_vals, i):
        url = f"{self.get('url')}?mode={self.get('mode')}"
        return HTTPRequestData.from_json(
            url, self._row_body(row_vals, i), headers=self._headers()
        )


@register_stage
class GenerateThumbnails(_VisionBase):
    """Thumbnail generation (ComputerVision.scala:222-260). Output: the raw
    thumbnail image bytes."""

    width = Param(64, "thumbnail width (px)", ptype=int)
    height = Param(64, "thumbnail height (px)", ptype=int)
    smart_cropping = Param(True, "center on the region of interest", ptype=bool)

    def _row_request(self, row_vals, i):
        url = (f"{self.get('url')}?width={self.get('width')}"
               f"&height={self.get('height')}"
               f"&smartCropping={str(self.get('smart_cropping')).lower()}")
        return HTTPRequestData.from_json(
            url, self._row_body(row_vals, i), headers=self._headers()
        )

    def _parse(self, resp):
        return resp.entity  # image bytes, not JSON


@register_stage
class RecognizeDomainSpecificContent(_VisionBase):
    """Domain-model analysis — celebrities/landmarks (reference: DSIR,
    RecognizeDomainSpecificContent, ComputerVision.scala:362-378). The
    domain model is a URL path segment; output: the `result` payload."""

    model = Param("celebrities", "domain model (celebrities | landmarks)",
                  ptype=str)

    def _row_request(self, row_vals, i):
        url = f"{self.get('url').rstrip('/')}/models/{self.get('model')}/analyze"
        return HTTPRequestData.from_json(
            url, self._row_body(row_vals, i), headers=self._headers()
        )

    def _parse(self, resp):
        return (resp.json() or {}).get("result")


@register_stage
class TagImage(_VisionBase):
    """Image tagging (ComputerVision.scala:380-420). Output: `tags` list."""

    def _parse(self, resp):
        return (resp.json() or {}).get("tags")


@register_stage
class DescribeImage(_VisionBase):
    """Image description (ComputerVision.scala:422-460). Output: the
    `description` payload (captions + tags)."""

    max_candidates = Param(1, "caption candidates to return", ptype=int)

    def _row_request(self, row_vals, i):
        url = f"{self.get('url')}?maxCandidates={self.get('max_candidates')}"
        return HTTPRequestData.from_json(
            url, self._row_body(row_vals, i), headers=self._headers()
        )

    def _parse(self, resp):
        return (resp.json() or {}).get("description")


# ---------------------------------------------------------------------------
# Face suite (reference: Face.scala:19-347)


@register_stage
class FindSimilarFace(CognitiveServiceBase):
    """Find faces similar to a query face (Face.scala:120-180)."""

    face_id = ServiceParam(None, "query face id (scalar or column)")
    face_ids = ServiceParam(None, "candidate face id list (scalar or column)")
    max_candidates = Param(20, "max matches returned", ptype=int)
    mode = Param("matchPerson", "matchPerson | matchFace", ptype=str)

    def _row_body(self, row_vals, i):
        return {
            "faceId": row_vals.get("face_id"),
            "faceIds": list(row_vals.get("face_ids") or []),
            "maxNumOfCandidatesReturned": self.get("max_candidates"),
            "mode": self.get("mode"),
        }


@register_stage
class GroupFaces(CognitiveServiceBase):
    """Partition faces into similarity groups (Face.scala:182-220)."""

    face_ids = ServiceParam(None, "face id list (scalar or column)")

    def _row_body(self, row_vals, i):
        return {"faceIds": list(row_vals.get("face_ids") or [])}


@register_stage
class IdentifyFaces(CognitiveServiceBase):
    """Identify faces against a person group (Face.scala:222-280)."""

    person_group_id = ServiceParam(None, "person group id (scalar or column)")
    face_ids = ServiceParam(None, "face id list (scalar or column)")
    max_candidates = Param(1, "candidates per face", ptype=int)
    confidence_threshold = Param(None, "identification confidence floor", ptype=float)

    def _row_body(self, row_vals, i):
        body = {
            "personGroupId": row_vals.get("person_group_id"),
            "faceIds": list(row_vals.get("face_ids") or []),
            "maxNumOfCandidatesReturned": self.get("max_candidates"),
        }
        if self.get("confidence_threshold") is not None:
            body["confidenceThreshold"] = self.get("confidence_threshold")
        return body


@register_stage
class VerifyFaces(CognitiveServiceBase):
    """Verify two faces belong to one person (Face.scala:282-347)."""

    face_id1 = ServiceParam(None, "first face id (scalar or column)")
    face_id2 = ServiceParam(None, "second face id (scalar or column)")

    def _row_body(self, row_vals, i):
        return {"faceId1": row_vals.get("face_id1"),
                "faceId2": row_vals.get("face_id2")}


@register_stage
class BingImageSearch(CognitiveServiceBase):
    """Bing image search (reference: ImageSearch.scala:23-296). Output: the
    `value` list of image results (contentUrl etc.)."""

    query = ServiceParam(None, "search query (scalar or column)")
    count = Param(10, "results per query", ptype=int)
    offset = Param(0, "result offset (paging)", ptype=int)
    market = Param(None, "market code, e.g. en-US", ptype=str)

    def _row_request(self, row_vals, i):
        from urllib.parse import urlencode

        params = {"q": row_vals.get("query", ""), "count": self.get("count"),
                  "offset": self.get("offset")}
        if self.get("market"):
            params["mkt"] = self.get("market")
        return HTTPRequestData(
            method="GET",
            url=f"{self.get('url')}?{urlencode(params)}",
            headers=self._headers(),
        )

    def _parse(self, resp):
        return (resp.json() or {}).get("value")

    @staticmethod
    def download_from_urls(urls, concurrency: int = 4, timeout: float = 30.0):
        """Fetch image bytes for result URLs (reference
        BingImageSearch.downloadFromUrls, ImageSearch.scala:240-296); failed
        fetches yield None."""
        client = HTTPClient(concurrency=concurrency, timeout=timeout)
        reqs = [HTTPRequestData(method="GET", url=u, headers={}) for u in urls]
        resps = client.send_all(reqs)
        return [r.entity if isinstance(r, HTTPResponseData) and r.ok else None
                for r in resps]
