"""The port's HTTP client side (mmlspark_tpu_torch/io_http/clients.py,
transformer.py, consolidator.py, powerbi.py, cognitive.py and search.py)
held to the JAX package's: tests/test_io_http.py's TestClients,
TestTransformers, TestConsolidator, TestPowerBI and TestCognitive, and
every case of tests/test_cognitive_socket.py, through the port against the
same local fake services; the request every stage sends (method, path,
headers, body bytes) equal to the JAX package's for the same inputs; and
stages saved by either package loaded by the other.
"""

import base64
import json
import re
import socket
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu_torch.core.schema import Table  # noqa: E402
from mmlspark_tpu_torch.io_http import (  # noqa: E402
    NER,
    OCR,
    AnalyzeImage,
    AzureSearchWriter,
    BingImageSearch,
    CustomOutputParser,
    DescribeImage,
    DetectFace,
    EntityDetector,
    FindSimilarFace,
    GenerateThumbnails,
    GroupFaces,
    HTTPRequestData,
    HTTPResponseData,
    HTTPTransformer,
    IdentifyFaces,
    JSONInputParser,
    JSONOutputParser,
    KeyPhraseExtractor,
    LanguageDetector,
    PartitionConsolidator,
    PowerBIWriter,
    RecognizeText,
    SimpleHTTPTransformer,
    TagImage,
    TextSentiment,
    VerifyFaces,
    http_send,
)



@pytest.fixture()
def echo_server():
    """Local JSON echo service; /flaky returns 429 twice then succeeds."""
    calls = {"flaky": 0, "posts": [], "conns": []}

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"   # keep-alive: the client pools us

        def do_POST(self):
            if self.connection not in calls["conns"]:
                calls["conns"].append(self.connection)
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n)
            calls["posts"].append(body)
            if self.path == "/flaky":
                calls["flaky"] += 1
                if calls["flaky"] <= 2:
                    self.send_response(429)
                    self.send_header("Retry-After", "0.01")
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
            payload = json.loads(body or b"{}")
            out = json.dumps({"echo": payload}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", calls
    srv.shutdown()
    srv.server_close()


class TestClients:
    def test_send_and_retry_429(self, echo_server):
        url, calls = echo_server
        req = HTTPRequestData.from_json(url + "/flaky", {"a": 1})
        resp = http_send(req, retries=5)
        assert resp.ok and resp.json()["echo"] == {"a": 1}
        assert calls["flaky"] == 3  # two 429s then success

    def test_connection_error_returns_status_zero(self):
        req = HTTPRequestData.from_json("http://127.0.0.1:1/none", {})
        resp = http_send(req, retries=2, backoff_ms=(1,))
        assert resp.status_code == 0 and not resp.ok

    def test_pool_reuses_keep_alive_sockets(self, echo_server):
        from mmlspark_tpu_torch.io_http.clients import connection_pool_stats

        url, _ = echo_server
        before = connection_pool_stats()
        for i in range(5):
            assert http_send(
                HTTPRequestData.from_json(url + "/ka", {"i": i})).ok
        after = connection_pool_stats()
        # first send may create; the rest must ride the pooled socket
        assert after["reuses"] - before["reuses"] >= 4

    def test_stale_pooled_socket_replays_once_transparently(
            self, echo_server):
        """A keep-alive socket the server closed while idle must cost a
        transparent replay, not a status-0 (no breaker failure)."""
        import urllib.parse

        from mmlspark_tpu_torch.io_http.clients import (_POOL,
                                                  connection_pool_stats)
        from mmlspark_tpu_torch.resilience import CircuitBreaker

        url, calls = echo_server
        assert http_send(HTTPRequestData.from_json(url + "/s", {})).ok
        p = urllib.parse.urlsplit(url)
        with _POOL._lock:
            idle = list(_POOL._idle.get(("http", p.hostname, p.port), []))
        assert idle, "expected a pooled idle socket"
        # sever SERVER-side: the pooled client socket stays open locally
        # but is half-closed remotely — the genuinely-stale case.
        # shutdown() forces the FIN out; close() alone defers while the
        # handler's makefile() refs are live
        for c in calls["conns"]:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            c.close()
        calls["conns"].clear()
        before = connection_pool_stats()
        breaker = CircuitBreaker(name="stale-test")
        resp = http_send(HTTPRequestData.from_json(url + "/s", {"x": 2}),
                         breaker=breaker)
        assert resp.ok and resp.json()["echo"] == {"x": 2}
        after = connection_pool_stats()
        assert after["stale_retries"] >= before["stale_retries"] + 1
        assert breaker.state == "closed" and breaker.failure_rate() == 0.0

    def test_status_zero_failover_over_reused_socket(self):
        """The satellite regression: replica A serves keep-alive traffic
        (its socket sits in the pool), then dies HARD. The pooled stale
        socket must surface status 0 — TargetPool failover and breaker
        accounting fire exactly as in the socket-per-request era."""
        from http.server import ThreadingHTTPServer

        from mmlspark_tpu_torch.io_http.clients import TargetPool
        from mmlspark_tpu_torch.resilience import RetryPolicy

        conns = {}   # server port -> live handler connections

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"   # keep-alive, so A's socket
            # sits in the pool when A dies

            def do_POST(self):
                conns.setdefault(
                    self.server.server_address[1], []).append(
                        self.connection)
                n = int(self.headers.get("Content-Length", 0))
                self.rfile.read(n)
                body = b'{"ok": true}'
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        servers = [ThreadingHTTPServer(("127.0.0.1", 0), Handler)
                   for _ in range(2)]
        for s in servers:
            threading.Thread(target=s.serve_forever, daemon=True).start()
        url_a, url_b = (f"http://127.0.0.1:{s.server_address[1]}"
                        for s in servers)
        pool = TargetPool([url_a, url_b])
        try:
            # prime a keep-alive socket to BOTH replicas
            for u in (url_a, url_b):
                assert pool.send(HTTPRequestData.from_json(u, {}),
                                 target=u).ok
            servers[0].shutdown()
            servers[0].server_close()     # A now refuses reconnects too
            # kill A's established keep-alive conns: shutdown() only stops
            # the listener, handler threads would keep serving the pooled
            # socket and A would answer from beyond the grave
            for c in conns.get(servers[0].server_address[1], []):
                try:
                    c.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                c.close()
            failovers = []
            resps = [pool.send(
                HTTPRequestData.from_json("/", {"i": i}), timeout=2.0,
                policy=RetryPolicy(max_retries=0, backoffs_ms=[1]),
                on_failover=lambda u, r: failovers.append(
                    (u, r.status_code)))
                for i in range(4)]
            assert all(r.status_code == 200 for r in resps)
            # the dead replica answered status 0 (never a phantom reply
            # off the stale socket) and the pool failed over
            assert failovers
            assert all(u == url_a and s == 0 for u, s in failovers)
            # breaker accounting unchanged: A recorded real failures
            assert pool.breaker_for(url_a).failure_rate() > 0.0
            assert pool.breaker_for(url_b).state == "closed"
            # lease accounting drained on both the failed and the
            # successful attempt
            assert pool.inflight(url_a) == 0 and pool.inflight(url_b) == 0
        finally:
            for s in servers:
                try:
                    s.shutdown()
                    s.server_close()
                except OSError:
                    pass


class TestTransformers:
    def test_http_transformer_roundtrip(self, echo_server):
        url, _ = echo_server
        t = Table({"payload": [{"v": 1}, {"v": 2}]})
        pipe_in = JSONInputParser(input_col="payload", url=url)
        http = HTTPTransformer(concurrency=2)
        out_p = JSONOutputParser(field_path="echo.v", output_col="v")
        out = out_p.transform(http.transform(pipe_in.transform(t)))
        assert list(out["v"]) == [1, 2]

    def test_simple_http_transformer(self, echo_server):
        url, _ = echo_server
        t = Table({"input": [{"q": "hi"}, {"q": "yo"}]})
        s = SimpleHTTPTransformer(url=url, flatten_output_field="echo.q",
                                  output_col="answer", concurrency=2)
        out = s.transform(t)
        assert out["answer"] == ["hi", "yo"]

    def test_simple_http_error_col(self):
        t = Table({"input": [{"a": 1}]})
        s = SimpleHTTPTransformer(url="http://127.0.0.1:1/x", error_col="err",
                                  output_col="out")
        out = s.transform(t)
        assert out["out"] == [None]
        assert out["err"][0]["status_code"] == 0

    def test_custom_output_parser(self, echo_server):
        url, _ = echo_server
        t = Table({"payload": [{"n": 5}]})
        chained = HTTPTransformer().transform(
            JSONInputParser(input_col="payload", url=url).transform(t)
        )
        p = CustomOutputParser()
        p.udf = lambda r: r.status_code
        assert p.transform(chained)["output"] == [200]



class TestConsolidator:
    def test_rate_limit_and_order(self):
        c = PartitionConsolidator(num_lanes=4, requests_per_second=200.0)
        c.fn = lambda v: v * 10
        t0 = time.monotonic()
        out = c.transform(Table({"input": np.arange(20.0)}))
        elapsed = time.monotonic() - t0
        assert list(out["output"]) == [v * 10 for v in np.arange(20.0)]
        assert elapsed >= 19 / 200.0  # rate limiter actually throttled


class TestPowerBI:
    def test_write_batches(self, echo_server):
        url, calls = echo_server
        t = Table({"a": np.arange(5.0), "b": list("vwxyz")})
        n = PowerBIWriter.write(t, url, batch_size=2)
        assert n == 3
        sent = [json.loads(p) for p in calls["posts"][-3:]]
        assert sum(len(b) for b in sent) == 5


class TestCognitive:
    def _fake(self, payload):
        return HTTPResponseData(
            200, "OK", {"Content-Type": "application/json"},
            json.dumps(payload).encode(),
        )

    def test_text_sentiment_scalar_and_column(self):
        stage = TextSentiment(url="http://fake/text/analytics", output_col="sentiment")
        stage.set_col(text="text_col")
        sent_bodies = []

        def handler(req):
            body = req.json()
            sent_bodies.append(body)
            doc = body["documents"][0]
            return self._fake({"documents": [{"id": doc["id"], "score": 0.9}]})

        stage.handler = handler
        t = Table({"text_col": ["good day", "bad day"]})
        out = stage.transform(t)
        assert [d["score"] for d in out["sentiment"]] == [0.9, 0.9]
        assert sent_bodies[0]["documents"][0]["text"] == "good day"

    def test_language_detector_error_col(self):
        stage = LanguageDetector(url="http://fake/lang", error_col="err")
        stage.set(text="hello")
        stage.handler = lambda req: HTTPResponseData(401, "denied")
        out = stage.transform(Table({"dummy": [1.0]}))
        assert out["response"] == [None]
        assert out["err"][0]["status_code"] == 401

    def test_analyze_image_body(self):
        stage = AnalyzeImage(url="http://fake/vision",
                             visual_features=["Tags", "Categories"])
        stage.set_col(image_url="url_col")
        bodies = []
        stage.handler = lambda req: (bodies.append(req.json()),
                                     self._fake({"tags": []}))[1]
        stage.transform(Table({"url_col": ["http://img/1.png"]}))
        assert bodies[0]["url"] == "http://img/1.png"
        assert bodies[0]["visualFeatures"] == ["Tags", "Categories"]

    def test_detect_face_bytes(self):
        stage = DetectFace(url="http://fake/face", return_face_landmarks=True)
        stage.set_col(image_bytes="img")
        bodies = []
        stage.handler = lambda req: (bodies.append(req.json()),
                                     self._fake([{"faceId": "x"}]))[1]
        stage.transform(Table({"img": [b"\x89PNG..."]}))
        assert bodies[0]["returnFaceLandmarks"] is True
        assert "data" in bodies[0]



THUMB_BYTES = b"\x89PNG-fake-thumbnail-bytes"


@pytest.fixture(scope="module")
def cog_server():
    """One fake cognitive service covering every route, with call recording."""
    state = {"ops": {}, "calls": [], "indexes": set(), "docs": [], "raw": []}

    class Handler(BaseHTTPRequestHandler):
        def _read(self):
            n = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(n) if n else b""
            # what went over the wire, for the cross-package comparison
            state["raw"].append((self.command, self.path,
                                 sorted(self.headers.items()), raw))
            try:
                return json.loads(raw) if raw else {}
            except ValueError:
                return {}

        def _json(self, payload, status=200, headers=None):
            body = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            body = self._read()
            state["calls"].append(
                {"path": self.path, "key": self.headers.get("Ocp-Apim-Subscription-Key"),
                 "api_key": self.headers.get("api-key"), "body": body}
            )
            path = self.path
            if path.startswith("/text/"):
                doc = body["documents"][0]
                payload = {"id": doc["id"]}
                if path.endswith("sentiment"):
                    payload["score"] = 0.75
                elif path.endswith("language"):
                    payload["detectedLanguages"] = [{"name": "English", "score": 1.0}]
                elif path.endswith("entities"):
                    payload["entities"] = [{"name": "Seattle"}]
                elif path.endswith("keyphrases"):
                    payload["keyPhrases"] = ["fox", "dog"]
                elif path.endswith("ner"):
                    payload["entities"] = [
                        {"text": doc["text"].split()[0], "category": "Thing"}
                    ]
                return self._json({"documents": [payload]})
            if path.startswith("/vision/ocr"):
                return self._json({"language": "en",
                                   "regions": [{"lines": [{"words": [{"text": "HI"}]}]}]})
            if path.startswith("/vision/recognizeText"):
                op_id = str(len(state["ops"]))
                state["ops"][op_id] = 0
                host, port = self.server.server_address
                loc = f"http://{host}:{port}/vision/operations/{op_id}"
                mode = re.search(r"mode=(\w+)", path)
                state["calls"][-1]["mode"] = mode.group(1) if mode else None
                self.send_response(202)
                self.send_header("Operation-Location", loc)
                self.end_headers()
                return None
            if path.startswith("/vision/thumbnail"):
                state["calls"][-1]["query"] = path.split("?", 1)[-1]
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.end_headers()
                self.wfile.write(THUMB_BYTES)
                return None
            if path.startswith("/vision/tag"):
                return self._json({"tags": [{"name": "outdoor", "confidence": 0.9}]})
            if path.startswith("/vision/describe"):
                return self._json({"description": {
                    "captions": [{"text": "a fake image", "confidence": 0.8}],
                    "tags": ["fake"],
                }})
            if path.startswith("/vision/analyze"):
                return self._json({"categories": [{"name": "abstract_"}]})
            m = re.match(r"/vision/models/(\w+)/analyze", path)
            if m:
                state["calls"][-1]["model"] = m.group(1)
                return self._json({"result": {
                    m.group(1): [{"name": "Fake Celebrity", "confidence": 0.95}]
                }})
            if path.startswith("/face/detect"):
                return self._json([{"faceId": "f-1"}])
            if path.startswith("/face/findsimilars"):
                return self._json([{"faceId": body["faceIds"][0], "confidence": 0.9}])
            if path.startswith("/face/group"):
                return self._json({"groups": [body["faceIds"][:2]],
                                   "messyGroup": body["faceIds"][2:]})
            if path.startswith("/face/identify"):
                return self._json([
                    {"faceId": fid,
                     "candidates": [{"personId": "p-1", "confidence": 0.8}]}
                    for fid in body["faceIds"]
                ])
            if path.startswith("/face/verify"):
                same = body["faceId1"] == body["faceId2"]
                return self._json({"isIdentical": same,
                                   "confidence": 1.0 if same else 0.1})
            if path.startswith("/search/indexes") and path.split("?")[0].endswith("/docs/index"):
                docs = body["value"]
                state["docs"].extend(docs)
                return self._json({"value": [
                    {"key": str(i), "status": True, "statusCode": 201}
                    for i in range(len(docs))
                ]})
            if path.split("?")[0].endswith("/search/indexes"):
                state["indexes"].add(body["name"])
                return self._json({"name": body["name"]}, status=201)
            self._json({"error": "unknown route " + path}, status=404)

        def do_GET(self):
            state["raw"].append((self.command, self.path,
                                 sorted(self.headers.items()), b""))
            state["calls"].append({"path": self.path, "method": "GET",
                                   "key": self.headers.get("Ocp-Apim-Subscription-Key")})
            path = self.path
            m = re.match(r"/vision/operations/(\d+)", path)
            if m:
                op_id = m.group(1)
                state["ops"][op_id] += 1
                if state["ops"][op_id] < 3:   # two "Running" polls first
                    return self._json({"status": "Running"})
                return self._json({"status": "Succeeded", "recognitionResult": {
                    "lines": [{"text": "HELLO TPU"}]
                }})
            if path.startswith("/bing/images/search"):
                q = re.search(r"q=([^&]*)", path).group(1)
                return self._json({"value": [
                    {"name": f"result for {q}", "contentUrl": f"http://x/{q}.png"}
                ]})
            m = re.match(r"/search/indexes/([\w-]+)\?", path)
            if m:
                if m.group(1) in state["indexes"]:
                    return self._json({"name": m.group(1)})
                return self._json({"error": "not found"}, status=404)
            self._json({"error": "unknown GET " + path}, status=404)

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", state
    srv.shutdown()
    srv.server_close()


class TestTextStagesOverSocket:
    def test_sentiment_key_header(self, cog_server):
        url, state = cog_server
        stage = TextSentiment(url=url + "/text/sentiment",
                              subscription_key="sekrit", output_col="out")
        stage.set_col(text="t")
        out = stage.transform(Table({"t": ["nice", "bad"]}))
        assert [d["score"] for d in out["out"]] == [0.75, 0.75]
        sent = [c for c in state["calls"] if c["path"] == "/text/sentiment"]
        assert all(c["key"] == "sekrit" for c in sent[-2:])

    def test_language_entities_keyphrases_ner(self, cog_server):
        url, _ = cog_server
        t = Table({"t": ["Seattle is rainy"]})
        lang = LanguageDetector(url=url + "/text/language", output_col="o")
        lang.set_col(text="t")
        assert lang.transform(t)["o"][0]["detectedLanguages"][0]["name"] == "English"
        ent = EntityDetector(url=url + "/text/entities", output_col="o")
        ent.set_col(text="t")
        assert ent.transform(t)["o"][0]["entities"][0]["name"] == "Seattle"
        kp = KeyPhraseExtractor(url=url + "/text/keyphrases", output_col="o")
        kp.set_col(text="t")
        assert kp.transform(t)["o"][0]["keyPhrases"] == ["fox", "dog"]
        ner = NER(url=url + "/text/ner", output_col="o")
        ner.set_col(text="t")
        assert ner.transform(t)["o"][0]["entities"][0]["text"] == "Seattle"


class TestVisionStagesOverSocket:
    def test_ocr(self, cog_server):
        url, _ = cog_server
        stage = OCR(url=url + "/vision/ocr", output_col="o")
        stage.set(image_url="http://x/a.png")
        out = stage.transform(Table({"dummy": [1.0]}))
        assert out["o"][0]["regions"][0]["lines"][0]["words"][0]["text"] == "HI"

    def test_recognize_text_async_poll(self, cog_server):
        """202 + Operation-Location -> polls until Succeeded (two Running
        responses first), mode rides the query string."""
        url, state = cog_server
        stage = RecognizeText(url=url + "/vision/recognizeText", output_col="o",
                              mode="Handwritten", poll_interval_s=0.01)
        stage.set(image_url="http://x/a.png")
        out = stage.transform(Table({"dummy": [1.0]}))
        res = out["o"][0]
        assert res["recognitionResult"]["lines"][0]["text"] == "HELLO TPU"
        post = [c for c in state["calls"] if c["path"].startswith("/vision/recognizeText")]
        assert post[-1]["mode"] == "Handwritten"
        polls = [c for c in state["calls"] if c["path"].startswith("/vision/operations")]
        assert len(polls) >= 3   # 2 Running + 1 Succeeded

    def test_thumbnail_bytes_and_query(self, cog_server):
        url, state = cog_server
        stage = GenerateThumbnails(url=url + "/vision/thumbnail", output_col="o",
                                   width=32, height=24, smart_cropping=True)
        stage.set(image_url="http://x/a.png")
        out = stage.transform(Table({"dummy": [1.0]}))
        assert out["o"][0] == THUMB_BYTES
        call = [c for c in state["calls"] if c["path"].startswith("/vision/thumbnail")][-1]
        assert "width=32" in call["query"] and "height=24" in call["query"]
        assert "smartCropping=true" in call["query"]

    def test_tag_describe_with_image_bytes(self, cog_server):
        url, state = cog_server
        raw = b"fake-image-bytes"
        t = Table({"img": [raw]})
        tag = TagImage(url=url + "/vision/tag", output_col="o")
        tag.set_col(image_bytes="img")
        assert tag.transform(t)["o"][0][0]["name"] == "outdoor"
        sent = [c for c in state["calls"] if c["path"].startswith("/vision/tag")][-1]
        assert base64.b64decode(sent["body"]["data"]) == raw
        desc = DescribeImage(url=url + "/vision/describe", output_col="o",
                             max_candidates=3)
        desc.set_col(image_bytes="img")
        assert desc.transform(t)["o"][0]["captions"][0]["text"] == "a fake image"

    def test_analyze(self, cog_server):
        url, _ = cog_server
        stage = AnalyzeImage(url=url + "/vision/analyze", output_col="o")
        stage.set(image_url="http://x/a.png")
        out = stage.transform(Table({"dummy": [1.0]}))
        assert out["o"][0]["categories"][0]["name"] == "abstract_"

    def test_domain_specific_content(self, cog_server):
        from mmlspark_tpu_torch.io_http import RecognizeDomainSpecificContent

        url, state = cog_server
        stage = RecognizeDomainSpecificContent(
            url=url + "/vision", model="celebrities", output_col="o"
        )
        stage.set(image_url="http://x/a.png")
        out = stage.transform(Table({"dummy": [1.0]}))
        assert out["o"][0]["celebrities"][0]["name"] == "Fake Celebrity"
        sent = [c for c in state["calls"] if c.get("model")][-1]
        assert sent["model"] == "celebrities"


class TestFaceSuiteOverSocket:
    def test_detect_find_group_identify_verify(self, cog_server):
        url, _ = cog_server
        one = Table({"dummy": [1.0]})

        det = DetectFace(url=url + "/face/detect", output_col="o")
        det.set(image_url="http://x/a.png")
        assert det.transform(one)["o"][0][0]["faceId"] == "f-1"

        fs = FindSimilarFace(url=url + "/face/findsimilars", output_col="o")
        fs.set(face_id="q-1", face_ids=["c-1", "c-2"])
        assert fs.transform(one)["o"][0][0]["faceId"] == "c-1"

        gr = GroupFaces(url=url + "/face/group", output_col="o")
        gr.set(face_ids=["a", "b", "c"])
        res = gr.transform(one)["o"][0]
        assert res["groups"] == [["a", "b"]] and res["messyGroup"] == ["c"]

        ident = IdentifyFaces(url=url + "/face/identify", output_col="o")
        ident.set(person_group_id="pg", face_ids=["a", "b"])
        res = ident.transform(one)["o"][0]
        assert [r["faceId"] for r in res] == ["a", "b"]

        ver = VerifyFaces(url=url + "/face/verify", output_col="o")
        ver.set_col(face_id1="f1", face_id2="f2")
        t = Table({"f1": ["x", "x"], "f2": ["x", "y"]})
        res = ver.transform(t)["o"]
        assert res[0]["isIdentical"] is True and res[1]["isIdentical"] is False


class TestBingImageSearchOverSocket:
    def test_search_get_with_params(self, cog_server):
        url, _ = cog_server
        stage = BingImageSearch(url=url + "/bing/images/search", output_col="o",
                                count=5)
        stage.set_col(query="q")
        out = stage.transform(Table({"q": ["cats", "dogs"]}))
        assert out["o"][0][0]["name"] == "result for cats"
        assert out["o"][1][0]["contentUrl"] == "http://x/dogs.png"

    def test_download_from_urls(self, cog_server):
        url, _ = cog_server
        # any GET route returns JSON bytes; a dead port yields None
        blobs = BingImageSearch.download_from_urls(
            [url + "/bing/images/search?q=z", "http://127.0.0.1:1/x"]
        )
        assert blobs[0] is not None and blobs[1] is None


class TestAzureSearchOverSocket:
    def test_create_index_and_upload_batches(self, cog_server):
        url, state = cog_server
        writer = AzureSearchWriter(
            service_url=url + "/search",
            index_definition={"name": "test-idx", "fields": [
                {"name": "id", "type": "Edm.String", "key": True},
                {"name": "text", "type": "Edm.String"},
            ]},
            api_key="admin-key",
            batch_size=2,
        )
        t = Table({"id": ["1", "2", "3"], "text": ["a", "b", "c"]})
        out = writer.transform(t)
        assert out is t or out.equals(t)
        assert "test-idx" in state["indexes"]
        assert len(state["docs"]) == 3
        assert state["docs"][0]["@search.action"] == "upload"
        assert {d["text"] for d in state["docs"]} == {"a", "b", "c"}
        uploads = [c for c in state["calls"]
                   if c["path"].endswith("docs/index?api-version=2017-11-11")]
        assert len(uploads) == 2      # batch_size=2 -> batches of 2 + 1
        assert all(c["api_key"] == "admin-key" for c in uploads)

    def test_existing_index_not_recreated(self, cog_server):
        url, state = cog_server

        def create_posts():
            return len([c for c in state["calls"]
                        if c["path"].split("?")[0].endswith("/search/indexes")
                        and "method" not in c])

        writer = AzureSearchWriter(
            service_url=url + "/search",
            index_definition={"name": "idempotent-idx", "fields": []},
        )
        writer.transform(Table({"id": ["1"]}))     # creates the index
        between = create_posts()
        writer.transform(Table({"id": ["2"]}))     # probe hits, no re-create
        assert create_posts() == between


# --------------------------------------------------------------------- #
# the port against the JAX package                                      #
# --------------------------------------------------------------------- #


def _packages():
    import mmlspark_tpu.core.schema as ref_schema
    import mmlspark_tpu.io_http as ref_io

    import mmlspark_tpu_torch.core.schema as port_schema
    import mmlspark_tpu_torch.io_http as port_io

    return (("port", port_io, port_schema.Table), ("reference", ref_io, ref_schema.Table))


def _stage(io, name, url, params=None, cols=None, values=None):
    stage = getattr(io, name)(url=url, **(params or {}))
    if cols:
        stage.set_col(**cols)
    if values:
        stage.set(**values)
    return stage


# (stage, path, constructor params, set_col, set, table columns)
_STAGE_CASES = [
    ("TextSentiment", "/text/sentiment", {"subscription_key": "k1", "output_col": "o"},
     {"text": "t"}, {"language": "fr"}, {"t": ["nice", "bad day"]}),
    ("LanguageDetector", "/text/language", {"output_col": "o"}, {"text": "t"}, None,
     {"t": ["hola"]}),
    ("EntityDetector", "/text/entities", {"output_col": "o"}, {"text": "t"}, None,
     {"t": ["Seattle is rainy"]}),
    ("KeyPhraseExtractor", "/text/keyphrases", {"output_col": "o"}, {"text": "t"}, None,
     {"t": ["quick fox"]}),
    ("NER", "/text/ner", {"output_col": "o"}, {"text": "t"}, None, {"t": ["Ada wrote"]}),
    ("OCR", "/vision/ocr", {"output_col": "o", "detect_orientation": True}, None,
     {"image_url": "http://x/a.png"}, {"dummy": [1.0]}),
    ("RecognizeText", "/vision/recognizeText",
     {"output_col": "o", "mode": "Printed", "poll_interval_s": 0.01}, None,
     {"image_url": "http://x/a.png"}, {"dummy": [1.0]}),
    ("GenerateThumbnails", "/vision/thumbnail",
     {"output_col": "o", "width": 48, "height": 16, "smart_cropping": False}, None,
     {"image_url": "http://x/b.png"}, {"dummy": [1.0]}),
    ("TagImage", "/vision/tag", {"output_col": "o"}, {"image_bytes": "img"}, None,
     {"img": [b"\x00\x01raw-bytes\xff"]}),
    ("DescribeImage", "/vision/describe", {"output_col": "o", "max_candidates": 2},
     {"image_bytes": "img"}, None, {"img": [b"abc"]}),
    ("AnalyzeImage", "/vision/analyze",
     {"output_col": "o", "visual_features": ["Tags", "Faces"]}, {"image_url": "u"}, None,
     {"u": ["http://img/1.png", "http://img/2.png"]}),
    ("RecognizeDomainSpecificContent", "/vision", {"output_col": "o", "model": "landmarks"},
     None, {"image_url": "http://x/c.png"}, {"dummy": [1.0]}),
    ("DetectFace", "/face/detect",
     {"output_col": "o", "return_face_landmarks": True}, {"image_bytes": "img"}, None,
     {"img": [b"\x89PNG..."]}),
    ("FindSimilarFace", "/face/findsimilars", {"output_col": "o"}, None,
     {"face_id": "q-1", "face_ids": ["c-1", "c-2"]}, {"dummy": [1.0]}),
    ("GroupFaces", "/face/group", {"output_col": "o"}, None, {"face_ids": ["a", "b", "c"]},
     {"dummy": [1.0]}),
    ("IdentifyFaces", "/face/identify", {"output_col": "o"}, None,
     {"person_group_id": "pg", "face_ids": ["a", "b"]}, {"dummy": [1.0]}),
    ("VerifyFaces", "/face/verify", {"output_col": "o"}, {"face_id1": "f1", "face_id2": "f2"},
     None, {"f1": ["x", "x"], "f2": ["x", "y"]}),
    ("BingImageSearch", "/bing/images/search", {"output_col": "o", "count": 3, "offset": 2},
     {"query": "q"}, None, {"q": ["cats", "red dogs"]}),
]


def _wire(state, start):
    """The requests the fake service received since `start`, with the
    async-poll operation ids (counted across both packages' runs) masked."""
    return [(m, re.sub(r"/operations/\d+", "/operations/N", path), headers, body)
            for m, path, headers, body in state["raw"][start:]]


class TestRequestsAcrossPackages:
    @pytest.mark.parametrize("case", _STAGE_CASES, ids=[c[0] for c in _STAGE_CASES])
    def test_stage_sends_the_same_request(self, cog_server, case):
        name, path, params, cols, values, columns = case
        url, state = cog_server
        sent, outs = [], []
        for _tag, io, table_cls in _packages():
            start = len(state["raw"])
            stage = _stage(io, name, url + path, params, cols, values)
            outs.append(stage.transform(table_cls(dict(columns)))["o"])
            sent.append(_wire(state, start))
        assert sent[0] and sent[0] == sent[1]
        assert outs[0] == outs[1]

    def test_search_writer_sends_the_same_requests(self, cog_server):
        url, state = cog_server
        sent = []
        for tag, io, table_cls in _packages():
            start = len(state["raw"])
            writer = io.AzureSearchWriter(
                service_url=url + "/search",
                index_definition={"name": f"cross-{tag[:3]}", "fields": [
                    {"name": "id", "type": "Edm.String", "key": True}]},
                api_key="admin", batch_size=2)
            writer.transform(table_cls({"id": ["1", "2", "3"], "n": np.arange(3.0)}))
            # index names of one length, so Content-Length agrees too
            sent.append([(m, p.replace(f"cross-{tag[:3]}", "cross"), h,
                          b.replace(f"cross-{tag[:3]}".encode(), b"cross"))
                         for m, p, h, b in _wire(state, start)])
        assert sent[0] and sent[0] == sent[1]

    def test_simple_transformer_and_powerbi_send_the_same_requests(self, echo_server):
        url, calls = echo_server
        sent, outs = [], []
        for _tag, io, table_cls in _packages():
            start = len(calls["posts"])
            t = table_cls({"input": [{"q": "hi", "n": 1.5}, {"q": "yo", "n": [1, 2]}]})
            out = io.SimpleHTTPTransformer(url=url + "/s", flatten_output_field="echo.q",
                                           output_col="answer").transform(t)
            n = io.PowerBIWriter.write(table_cls({"a": np.arange(5.0), "b": list("vwxyz")}),
                                       url + "/pbi", batch_size=2)
            outs.append((out["answer"], n))
            sent.append(calls["posts"][start:])
        assert outs[0] == outs[1]
        assert sent[0] and sent[0] == sent[1]


class TestStagesLoadAcrossPackages:
    @pytest.mark.parametrize("which", ["SimpleHTTPTransformer", "PartitionConsolidator",
                                       "TextSentiment"])
    def test_saved_stage_loads_in_the_other(self, tmp_path, which):
        from mmlspark_tpu.core import serialize as ref_serialize
        import mmlspark_tpu.io_http as ref_io

        from mmlspark_tpu_torch.core import serialize
        import mmlspark_tpu_torch.io_http as port_io

        kw = {"SimpleHTTPTransformer": dict(url="http://127.0.0.1:9/x", output_col="a",
                                            flatten_output_field="echo.q", concurrency=3,
                                            error_col="err", timeout=7.5),
              "PartitionConsolidator": dict(input_col="v", output_col="w", num_lanes=3,
                                            requests_per_second=12.5),
              "TextSentiment": dict(url="http://127.0.0.1:9/text", subscription_key="k",
                                    output_col="s", retries=5)}[which]
        port_stage = getattr(port_io, which)(**kw)
        ref_stage = getattr(ref_io, which)(**kw)
        if which == "TextSentiment":
            port_stage.set_col(text="t")
            ref_stage.set_col(text="t")
        serialize.save_stage(port_stage, str(tmp_path / "port"))
        as_ref = ref_serialize.load_stage(str(tmp_path / "port"))
        assert type(as_ref).__module__.startswith("mmlspark_tpu.io_http")
        assert as_ref.params_to_dict() == ref_stage.params_to_dict()
        ref_serialize.save_stage(ref_stage, str(tmp_path / "ref"))
        as_port = serialize.load_stage(str(tmp_path / "ref"))
        assert type(as_port).__module__.startswith("mmlspark_tpu_torch.io_http")
        assert as_port.params_to_dict() == port_stage.params_to_dict()

    def test_loaded_consolidator_runs_the_same(self, tmp_path):
        from mmlspark_tpu.core import serialize as ref_serialize
        from mmlspark_tpu.core.schema import Table as RefTable
        from mmlspark_tpu.io_http import PartitionConsolidator as RefConsolidator

        from mmlspark_tpu_torch.core import serialize

        ref_serialize.save_stage(RefConsolidator(num_lanes=2), str(tmp_path / "ref"))
        as_port = serialize.load_stage(str(tmp_path / "ref"))
        serialize.save_stage(PartitionConsolidator(num_lanes=2), str(tmp_path / "port"))
        as_ref = ref_serialize.load_stage(str(tmp_path / "port"))
        as_port.fn = as_ref.fn = lambda v: v * 3 + 1
        vals = np.arange(9.0)
        assert list(as_port.transform(Table({"input": vals}))["output"]) == \
            list(as_ref.transform(RefTable({"input": vals}))["output"])
