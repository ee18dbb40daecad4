"""The port's serve_model hot path (mmlspark_tpu_torch/io_http/serving.py's
_HotPath over core/fusion.py's ResidentExecutor) held to
tests/test_serving_hot_path.py's contract on the CPU: the handler, native
and resident routes give the same reply bytes at every ladder size, a
concurrent soak holds zero recompiles and at most one round trip a
resident request, and the binary wire scores to binary replies.
TestGatewaySwap waits for the gateway (ROADMAP Queue 1 item 11b); the
replies' agreement with the JAX package's server over the same trees is
tests/test_torch_serving.py's."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu_torch.core.dataplane import cache_stats, reset_cache_stats  # noqa: E402
from mmlspark_tpu_torch.core.schema import Table  # noqa: E402
from mmlspark_tpu_torch.gbdt.estimators import GBDTRegressor  # noqa: E402
from mmlspark_tpu_torch.io_http.serving import serve_model  # noqa: E402

COLS = ["x0", "x1", "x2", "x3"]


def _train_model(seed: int = 7):
    """A deterministically-trained GBDT on f32-representable features —
    two calls with the same seed produce byte-identical boosters (the
    rolling-swap test depends on it)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(256, 4)).astype(np.float32).astype(np.float64)
    y = X @ np.asarray([1.0, -2.0, 0.5, 3.0]) + rng.normal(
        scale=0.1, size=256)
    return GBDTRegressor(num_iterations=5, num_leaves=7, device="cpu").fit(
        Table({"features": X, "label": y}))


def _payload(i: int) -> dict:
    # float32-exact values: the resident route's check_ready precondition
    # (device binning requires f32-representable features) must pass
    return {c: float(np.float32(0.25 * i + 0.125 * j))
            for j, c in enumerate(COLS)}


def _requests(n: int):
    from mmlspark_tpu_torch.io_http.schema import HTTPRequestData

    return [HTTPRequestData.from_json("/", _payload(i)) for i in range(n)]


def _warm_request():
    from mmlspark_tpu_torch.io_http.schema import HTTPRequestData

    return HTTPRequestData.from_json("/", _payload(3))


def _post_raw(url: str, payload: dict, timeout=30) -> bytes:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def _get(url: str, timeout=10) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _wait_ready(srv, timeout_s: float = 120.0):
    import time

    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if srv.ready:
            return
        time.sleep(0.02)
    raise TimeoutError(
        f"server never became ready; hot_path="
        f"{srv.hot_path.snapshot() if srv.hot_path else None}")


@pytest.fixture(scope="module")
def hot_server():
    """One warmed serve_model server shared by the identity tests —
    max_batch_size=256 so the ladder covers every served batch size."""
    srv = serve_model(_train_model(), COLS, max_batch_size=256,
                      warmup_request=_warm_request(), device="cpu")
    _wait_ready(srv)
    yield srv
    srv.stop()


class TestThreeRouteByteIdentity:
    @pytest.mark.parametrize("n", [1, 5, 32, 200, 256])
    def test_routes_agree_at_every_ladder_size(self, hot_server, n):
        """Host handler vs native tree walk vs device-resident executor,
        at bench.py's serving batch sizes (1/32/256) plus ragged tails (5 -> pad
        8, 200 -> pad 256): identical reply ENTITY BYTES, request for
        request."""
        srv = hot_server
        hp = srv.hot_path
        assert hp is not None and hp.disabled is None, hp and hp.snapshot()
        assert hp.native_fn is not None
        reqs = _requests(n)
        target = srv.bucketer.bucket_for(n)

        # host route: the handler path exactly as _score_batch drives it
        # (pad by repeating the last request, slice the replies)
        padded = reqs + [reqs[-1]] * (target - n)
        host = [r.entity
                for r in srv.handler(Table({"request": padded}))["reply"]][:n]

        feats = hp.decoder.decode(reqs, target)
        assert feats is not None
        assert not hp.executor.check_ready(Table({hp.feature_col: feats}))
        resident = [r.entity
                    for r in hp.replies_for(hp.resident_values(feats, n))]
        native = [r.entity
                  for r in hp.replies_for(hp.native_values(feats[:n]))]

        assert host == resident, f"resident diverges from host at n={n}"
        assert host == native, f"native diverges from host at n={n}"

    def test_routes_agree_over_http(self, hot_server):
        """The same identity observed by a real client: force each route
        in turn and compare raw response bodies."""
        srv = hot_server
        bodies = {}
        for path in ("host", "native", "resident"):
            srv.hot_path.force_path = path
            try:
                bodies[path] = [_post_raw(srv.url, _payload(i))
                                for i in range(7)]
            finally:
                srv.hot_path.force_path = None
        assert bodies["host"] == bodies["native"] == bodies["resident"]
        snap = srv.hot_path.snapshot()
        assert snap["paths"]["resident"] >= 7
        assert snap["paths"]["native"] >= 7

    def test_warmup_learned_the_full_ladder(self, hot_server):
        """/readyz flips only after the resident executable is compiled
        and the native/resident crossover measured on EVERY rung."""
        srv = hot_server
        snap = srv.hot_path.snapshot()
        assert snap["enabled"], snap
        ladder = [str(b) for b in srv.bucketer.ladder]
        assert sorted(snap["crossover"], key=int) == ladder
        for rung, t in snap["timings_ms"].items():
            assert "resident" in t and t["resident"] > 0, (rung, t)
        info = _get(srv.url)
        assert info["hot_path"]["enabled"]
        assert info["hot_path"]["crossover"] == snap["crossover"]

    def test_non_schema_request_falls_back_byte_identically(self, hot_server):
        """A request outside the cached schema (an extra field is fine;
        a MISSING field is not) must not 500 — the decoder declines and
        the handler path answers it, resident forced or not."""
        srv = hot_server
        ok = dict(_payload(2), extra="ignored")
        srv.hot_path.force_path = "resident"
        try:
            assert _post_raw(srv.url, ok) == _post_raw(srv.url, _payload(2))
            # a non-f32-representable float: resident's device precondition
            # declines the batch, the native walk answers it exactly
            odd = dict(_payload(2), x0=0.1)
            body = json.loads(_post_raw(srv.url, odd))
            assert set(body) == {"prediction"}
        finally:
            srv.hot_path.force_path = None


class TestSteadyStateSoak:
    def test_concurrent_soak_no_recompiles_one_round_trip(self):
        """High-concurrency soak on a warm server: 8 clients x 30
        requests. Steady state must hold the serving contract's perf facts — ZERO
        executable recompiles, path counters that only grow, and <= 1
        host round trip per resident-scored request."""
        srv = serve_model(_train_model(), COLS, max_batch_size=32,
                          warmup_request=_warm_request(), device="cpu")
        try:
            _wait_ready(srv)
            hp = srv.hot_path
            assert hp is not None and hp.disabled is None
            # route everything resident so the soak exercises dispatch/
            # readback under load (the CPU crossover would pick native)
            hp.force_path = "resident"
            reset_cache_stats()
            mid = {"snap": None}
            results, errors = [], []

            def client(k: int):
                try:
                    for i in range(30):
                        body = json.loads(_post_raw(srv.url, _payload(i)))
                        results.append((i, body["prediction"]))
                        if k == 0 and i == 15:
                            mid["snap"] = hp.snapshot()
                except Exception as e:  # noqa: BLE001 — collected below
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not errors, errors[:3]
            assert len(results) == 240
            # same payload -> same prediction regardless of which batch
            # composition scored it
            by_i = {}
            for i, v in results:
                by_i.setdefault(i, set()).add(v)
            assert all(len(vs) == 1 for vs in by_i.values())

            exe = cache_stats()
            assert exe["recompiles"] == 0, exe
            snap = hp.snapshot()
            assert snap["paths"]["resident"] == 240, snap
            # monotone counters: the mid-soak snapshot never exceeds the end
            assert mid["snap"] is not None
            for path, n in mid["snap"]["paths"].items():
                assert n <= snap["paths"][path]
            assert mid["snap"]["resident_batches"] <= snap["resident_batches"]
            # continuous batching coalesces, so batches <= requests and
            # each batch spends exactly one upload+readback round trip
            assert 0 < snap["round_trips_per_resident_request"] <= 1.0, snap
            assert snap["resident_batches"] <= 240
        finally:
            srv.stop()


class TestBinaryWireServing:
    """Content-negotiated binary protocol on the scoring routes: a framed
    request scores to a framed reply, JSON clients keep byte-identical
    replies, and a malformed frame degrades to an HTTP error without
    dropping the connection."""

    def _post_binary(self, srv, row, timeout=30):
        from mmlspark_tpu_torch.io_http import wire

        req = urllib.request.Request(
            srv.url, data=wire.encode_features_request(row),
            headers={"Content-Type": wire.WIRE_CONTENT_TYPE,
                     "Accept": wire.WIRE_CONTENT_TYPE})
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.headers.get("Content-Type"), r.read()

    def test_binary_request_scores_to_binary_reply(self, hot_server):
        from mmlspark_tpu_torch.io_http import wire

        srv = hot_server
        row = np.asarray([_payload(5)[c] for c in COLS])
        ct, entity = self._post_binary(srv, row)
        assert wire.is_wire_content_type(ct)
        col, vals = wire.decode_reply(entity)
        assert col == "prediction" and vals.shape[0] == 1
        # the framed value is BIT-identical to what the JSON path says
        json_val = json.loads(_post_raw(srv.url, _payload(5)))["prediction"]
        assert float(np.asarray(vals).ravel()[0]) == json_val

    def test_json_replies_byte_identical_around_binary_traffic(
            self, hot_server):
        srv = hot_server
        before = [_post_raw(srv.url, _payload(i)) for i in range(5)]
        for i in range(5):
            row = np.asarray([_payload(i)[c] for c in COLS])
            self._post_binary(srv, row)
        after = [_post_raw(srv.url, _payload(i)) for i in range(5)]
        assert before == after  # JSON clients never see the upgrade

    def test_protocol_mix_counted(self, hot_server):
        srv = hot_server
        base = dict(srv.protocol_counts())
        hits0 = srv.hot_path.decoder.binary_hits
        row = np.asarray([_payload(2)[c] for c in COLS])
        for _ in range(3):
            self._post_binary(srv, row)
        _post_raw(srv.url, _payload(2))
        counts = srv.protocol_counts()
        assert counts["binary"] >= base.get("binary", 0) + 3
        assert counts["json"] >= base.get("json", 0) + 1
        assert srv.hot_path.decoder.binary_hits >= hits0 + 3

    def test_bad_frame_is_an_http_error_not_a_dropped_socket(
            self, hot_server):
        from mmlspark_tpu_torch.io_http import wire

        srv = hot_server
        req = urllib.request.Request(
            srv.url, data=b"MSWRgarbage-not-a-frame",
            headers={"Content-Type": wire.WIRE_CONTENT_TYPE})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        assert ei.value.code >= 400
        # the server (and schema cache) survive: a JSON request right
        # after scores normally
        out = json.loads(_post_raw(srv.url, _payload(4)))
        assert "prediction" in out

