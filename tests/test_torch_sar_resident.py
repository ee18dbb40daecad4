"""The port's device-resident SAR serving (recommendation/resident.py)
on the CPU, held against the JAX package's host path.

tests/test_sar_resident.py's cases: `serve_model(sar_model)` delegates to
`serve_recommender`; at every ladder rung and ragged tail the handler
path, the resident route and the staged `SARTopKScorer.transform` give
the same reply bytes, which are `SARModel.recommend_for_all_users`'s
answer for that user; that answer is the JAX package's host path
(`SARModel.recommend_for_all_users`: ids equal, ratings within 1e-6 of
the row's largest). The JAX package's own resident route is not the
oracle: its byte-identity test fails (ROADMAP.md, Queue 3). Every server
is stopped in `finally`; every client call has a timeout.
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu.core.schema import Table as JaxTable  # noqa: E402
from mmlspark_tpu.recommendation import SAR as JaxSAR  # noqa: E402
from mmlspark_tpu_torch.core.dataplane import cache_stats, reset_cache_stats  # noqa: E402
from mmlspark_tpu_torch.core.fusion import fuse  # noqa: E402
from mmlspark_tpu_torch.core.pipeline import PipelineModel  # noqa: E402
from mmlspark_tpu_torch.core.schema import Table  # noqa: E402
from mmlspark_tpu_torch.io_http.schema import HTTPRequestData  # noqa: E402
from mmlspark_tpu_torch.io_http.serving import serve_model  # noqa: E402
from mmlspark_tpu_torch.recommendation import SAR, SARTopKScorer, serve_recommender  # noqa: E402
from mmlspark_tpu_torch.recommendation.resident import SARHotPath  # noqa: E402

K = 10
N_USERS = 30


def _interactions(n_users=N_USERS, n_items=20, per_user=6, seed=11) -> dict:
    rng = np.random.default_rng(seed)
    rows = [(float(u), float(i), 1.0)
            for u in range(n_users)
            for i in rng.choice(n_items, size=per_user, replace=False)]
    arr = np.asarray(rows, np.float64)
    return {"user": arr[:, 0], "item": arr[:, 1], "rating": arr[:, 2]}


def _post_raw(url: str, payload: dict, timeout=30) -> bytes:
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def _get(url: str, timeout=10) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _wait_ready(srv, timeout_s: float = 120.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if srv.ready:
            return
        time.sleep(0.02)
    raise TimeoutError(f"server never became ready; hot_path="
                       f"{srv.hot_path.snapshot() if srv.hot_path else None}")


def _bodies(recs) -> "list[bytes]":
    ids = np.asarray(recs["recommendations"]).tolist()
    ratings = np.asarray(recs["ratings"]).tolist()
    return [json.dumps({"recommendations": i, "ratings": r}).encode()
            for i, r in zip(ids, ratings)]


def _assert_matches_jax_host(bodies: "list[bytes]", users, jax_recs):
    """Each reply's ids are the JAX host path's for that user, its
    ratings within 1e-6 of the row's largest."""
    ji = np.asarray(jax_recs["recommendations"])
    jr = np.asarray(jax_recs["ratings"])
    for body, u in zip(bodies, users):
        got = json.loads(body)
        scale = max(np.abs(jr[u]).max(), 1.0)
        assert got["recommendations"] == ji[u].tolist(), u
        assert np.all(np.abs(np.asarray(got["ratings"]) - jr[u]) <= 1e-6 * scale), u


@pytest.fixture(scope="module")
def sar_server():
    cols = _interactions()
    model = SAR(support_threshold=1, device="cpu").fit(Table(dict(cols)))
    jax_model = JaxSAR(support_threshold=1).fit(JaxTable(dict(cols)))
    srv = serve_model(model, max_batch_size=256, device="cpu")
    try:
        _wait_ready(srv)
        yield model, jax_model.recommend_for_all_users(k=K), srv
    finally:
        srv.stop()


_SIZES = [1, 2, 3, 4, 5, 8, 13, 16, 31, 32, 64, 100, 128, 200, 255, 256]


class TestResidentByteIdentity:
    def test_serve_model_delegates_to_sar_hot_path(self, sar_server):
        _, _, srv = sar_server
        assert isinstance(srv.hot_path, SARHotPath)
        snap = srv.hot_path.snapshot()
        assert snap["enabled"] and snap["resident_label"] == "sar_resident"

    @pytest.mark.parametrize("n", _SIZES)
    def test_resident_equals_handler_and_the_host_paths_at_every_rung(self, sar_server, n):
        model, jax_recs, srv = sar_server
        hp = srv.hot_path
        assert hp is not None and hp.disabled is None, hp and hp.snapshot()
        reqs = [HTTPRequestData.from_json("/", {"user": i % N_USERS}) for i in range(n)]
        target = srv.bucketer.bucket_for(n)
        padded = reqs + [reqs[-1]] * (target - n)
        host = [r.entity for r in srv.handler(Table({"request": padded}))["reply"]][:n]
        feats = hp.decoder.decode(reqs, target)
        assert feats is not None
        resident = [r.entity for r in hp.replies_for(hp.resident_values(feats, n))]
        assert host == resident, f"resident diverges from the handler at n={n}"
        oracle = _bodies(model.recommend_for_all_users(k=K))
        users = [i % N_USERS for i in range(n)]
        assert host == [oracle[u] for u in users]
        _assert_matches_jax_host(host, users, jax_recs)

    def test_routes_agree_over_http(self, sar_server):
        _, jax_recs, srv = sar_server
        bodies = {}
        for path in ("host", "sar_resident"):
            srv.hot_path.force_path = path
            try:
                bodies[path] = [_post_raw(srv.url, {"user": i}) for i in range(7)]
            finally:
                srv.hot_path.force_path = None
        assert bodies["host"] == bodies["sar_resident"]
        _assert_matches_jax_host(bodies["host"], range(7), jax_recs)
        assert srv.hot_path.snapshot()["paths"]["sar_resident"] >= 7

    def test_warmup_learned_the_full_ladder(self, sar_server):
        _, _, srv = sar_server
        snap = srv.hot_path.snapshot()
        assert snap["enabled"], snap
        assert sorted(snap["crossover"], key=int) == [str(b) for b in srv.bucketer.ladder]
        for rung, t in snap["timings_ms"].items():
            assert "sar_resident" in t and t["sar_resident"] > 0, (rung, t)
        info = _get(srv.url)
        assert info["hot_path"]["enabled"]
        assert info["hot_path"]["resident_label"] == "sar_resident"

    def test_out_of_range_users_answer_invalid_rows(self, sar_server):
        _, _, srv = sar_server
        for payload in ({"user": 999}, {"user": 2.5}, {"user": -1}):
            got = {}
            for path in ("host", "sar_resident"):
                srv.hot_path.force_path = path
                try:
                    got[path] = json.loads(_post_raw(srv.url, payload))
                finally:
                    srv.hot_path.force_path = None
            assert got["host"] == got["sar_resident"]
            assert got["host"]["recommendations"] == [-1] * K
            assert got["host"]["ratings"] == [0.0] * K


class TestFusedAndStaged:
    def test_fused_equals_staged_equals_the_host_paths(self):
        cols = _interactions(n_users=70, n_items=25, per_user=5, seed=3)
        model = SAR(support_threshold=1, device="cpu").fit(Table(dict(cols)))
        jax_recs = JaxSAR(support_threshold=1).fit(JaxTable(dict(cols))).recommend_for_all_users(
            k=K)
        scorer = SARTopKScorer.from_model(model, k=K)
        users = np.asarray([3, 0, 69, 12, 12, 5, 70, -2], np.float64)
        table = Table({"features": users.reshape(-1, 1)})
        staged = scorer.transform(table)
        fused = fuse(PipelineModel([scorer]), device="cpu", mini_batch_size=4).transform(table)
        for c in ("recommendations", "ratings"):
            np.testing.assert_array_equal(np.asarray(fused[c]), np.asarray(staged[c]))
            assert np.asarray(fused[c]).dtype == np.asarray(staged[c]).dtype
        recs = model.recommend_for_all_users(k=K)
        valid = (users >= 0) & (users < 70)
        for c in ("recommendations", "ratings"):
            np.testing.assert_array_equal(np.asarray(staged[c])[valid],
                                          np.asarray(recs[c])[users[valid].astype(int)])
        assert (np.asarray(staged["recommendations"])[~valid] == -1).all()
        _assert_matches_jax_host(_bodies(recs), range(70), jax_recs)


class TestFewerThanKUnseen:
    def test_remove_seen_pads_with_invalid_slots(self):
        rows = [(0.0, float(i), 1.0) for i in range(4)]
        rows += [(float(u), float(i), 1.0) for u in (1, 2, 3) for i in (u, u + 1, 4)]
        arr = np.asarray(rows, np.float64)
        cols = {"user": arr[:, 0], "item": arr[:, 1], "rating": arr[:, 2]}
        model = SAR(support_threshold=1, device="cpu").fit(Table(dict(cols)))
        jax_recs = JaxSAR(support_threshold=1).fit(JaxTable(dict(cols))).recommend_for_all_users(
            k=5)
        srv = serve_recommender(model, k=5, max_batch_size=8, device="cpu")
        try:
            _wait_ready(srv)
            assert srv.hot_path is not None and srv.hot_path.disabled is None
            bodies = {}
            for path in ("host", "sar_resident"):
                srv.hot_path.force_path = path
                try:
                    bodies[path] = [_post_raw(srv.url, {"user": u}) for u in range(4)]
                finally:
                    srv.hot_path.force_path = None
            assert bodies["host"] == bodies["sar_resident"]
            assert bodies["host"] == _bodies(model.recommend_for_all_users(k=5))[:4]
            _assert_matches_jax_host(bodies["host"], range(4), jax_recs)
            user0 = json.loads(bodies["host"][0])
            assert user0["recommendations"] == [4, -1, -1, -1, -1]
            assert user0["ratings"][1:] == [0.0] * 4
        finally:
            srv.stop()


class TestSteadyStateSoak:
    def test_concurrent_soak_zero_recompiles(self):
        model = SAR(support_threshold=1, device="cpu").fit(Table(_interactions()))
        srv = serve_recommender(model, max_batch_size=32, device="cpu")
        try:
            _wait_ready(srv)
            hp = srv.hot_path
            assert hp is not None and hp.disabled is None
            hp.force_path = "sar_resident"
            reset_cache_stats()
            results, errors = [], []

            def client():
                try:
                    for i in range(30):
                        body = json.loads(_post_raw(srv.url, {"user": i % N_USERS}))
                        results.append((i % N_USERS, json.dumps(body)))
                except Exception as e:  # noqa: BLE001 — collected below
                    errors.append(e)

            threads = [threading.Thread(target=client) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not errors, errors[:3]
            assert len(results) == 240
            by_u: dict = {}
            for u, v in results:
                by_u.setdefault(u, set()).add(v)
            assert all(len(vs) == 1 for vs in by_u.values())
            assert cache_stats()["recompiles"] == 0
            snap = hp.snapshot()
            assert snap["paths"]["sar_resident"] == 240, snap
            assert 0 < snap["round_trips_per_resident_request"] <= 1.0, snap
        finally:
            srv.stop()
