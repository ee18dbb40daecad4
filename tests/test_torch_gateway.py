"""The port's self-healing serving fleet (mmlspark_tpu_torch/io_http/
clients.py, gateway.py, autoscale.py and serving.py's ServingFleet) held to
the JAX package's: tests/test_gateway.py's TestTargetPool,
TestHTTPClientUrls, TestServingGateway, TestFleetAutoscaler,
TestFleetSelfHealing, TestChaosSoak and (slow) TestGatewayTier through the
port on the CPU; TargetPool's hash strategy placing the same keys on the
same targets in both packages; and the autoscaler making the same decisions
for the same signal sequence on a fake clock.

The JAX package is imported inside the tests only: fleet replicas and
gateway workers are spawned processes that import this module to find
their factories, and they must not load JAX. Every fleet, gateway and
server stops in a `finally`; every client call has a timeout.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu_torch.core.schema import Table
from mmlspark_tpu_torch.io_http.autoscale import FleetAutoscaler
from mmlspark_tpu_torch.io_http.clients import HTTPClient, TargetPool
from mmlspark_tpu_torch.io_http.gateway import ServingGateway
from mmlspark_tpu_torch.io_http.journal import ServingJournal
from mmlspark_tpu_torch.io_http.schema import (HTTPRequestData, make_reply,
                                         parse_request)
from mmlspark_tpu_torch.io_http.serving import ServingFleet
from mmlspark_tpu_torch.resilience.policy import FakeClock

_SEEN = "mmlspark_tpu_serving_requests_seen_total"
_WARM_REQ = HTTPRequestData.from_json("/", {"x": 0.0})


# --------------------------------------------------------------------- #
# helpers                                                               #
# --------------------------------------------------------------------- #


class _EchoServer:
    """Tiny in-process replica stand-in: POST answers 200 with this
    server's tag + the request body, GET /readyz follows `self.ready`."""

    def __init__(self, tag: str):
        self.tag = tag
        self.ready = True
        self.hits = 0
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def do_POST(self):  # noqa: N802
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length) if length else b""
                outer.hits += 1
                payload = json.dumps({
                    "tag": outer.tag,
                    "path": self.path,
                    "echo": body.decode() if body else "",
                }).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):  # noqa: N802
                status = 200 if outer.ready else 503
                self.send_response(status)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")

            def log_message(self, *a):
                pass

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self._server.server_address[1]
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}/"

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


def _dead_url() -> str:
    """A URL nothing listens on (bound briefly, then closed)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"http://127.0.0.1:{port}/"


def _post(url: str, payload: dict, headers=None):
    return HTTPRequestData.from_json(url, payload, headers=dict(headers or {}))


def _send(url: str, payload: dict, headers=None, retries=1):
    from mmlspark_tpu_torch.io_http.clients import http_send

    return http_send(_post(url, payload, headers), retries=retries)


def _get_json(url: str, timeout=10) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


# module-level factories: fleet workers use the spawn context, so the
# factory must be importable from this file

def _double_factory():
    def handler(table: Table) -> Table:
        t = parse_request(table)
        return make_reply(
            t.with_column("y", np.asarray(t["x"], dtype=float) * 2), "y")
    return handler


def _double_v2_factory():
    """Byte-identical successor handler for rolling swap: same math
    written differently (x + x), so the swap is observable only through
    fleet bookkeeping, never through response bytes."""
    def handler(table: Table) -> Table:
        t = parse_request(table)
        x = np.asarray(t["x"], dtype=float)
        return make_reply(t.with_column("y", x + x), "y")
    return handler


def _soak_factory():
    """Chaos replica: ~10% of LIVE calls raise (seeded), warmup (x == 0)
    exempt so readiness always completes."""
    from mmlspark_tpu_torch.resilience.chaos import ChaosTransformer

    chaos = ChaosTransformer(exception_prob=0.10, seed=1234)

    def handler(table: Table) -> Table:
        t = parse_request(table)
        x = np.asarray(t["x"], dtype=float)
        if float(x[0]) != 0.0:
            chaos.transform(t)
        return make_reply(t.with_column("y", x * 2), "y")
    return handler


# --------------------------------------------------------------------- #
# TargetPool                                                            #
# --------------------------------------------------------------------- #


class TestTargetPool:
    def test_round_robin_cycles_live_targets(self):
        pool = TargetPool(["http://a/", "http://b/", "http://c/"])
        picks = [pool.pick("round_robin") for _ in range(6)]
        assert picks == ["http://a/", "http://b/", "http://c/"] * 2

    def test_least_loaded_prefers_idle(self):
        pool = TargetPool(["http://a/", "http://b/"])
        with pool.lease("http://a/"):
            assert all(pool.pick("least_loaded") == "http://b/"
                       for _ in range(3))
        assert pool.inflight("http://a/") == 0

    def test_hash_is_sticky_and_consistent(self):
        pool = TargetPool(["http://a/", "http://b/", "http://c/"])
        homes = {k: pool.pick("hash", key=k) for k in "abcdefgh"}
        # sticky: the same key always lands on the same target
        for k, home in homes.items():
            assert pool.pick("hash", key=k) == home
        # consistent: removing ONE target only moves that target's keys
        victim = homes["a"]
        pool.remove(victim)
        for k, home in homes.items():
            if home != victim:
                assert pool.pick("hash", key=k) == home

    def test_hash_keys_do_not_move_when_a_target_is_admitted(self):
        """Admitting a NEW target reshapes the ring (~1/N of hash space
        moves) but must not re-home established keys: the sticky binding
        holds as long as the old home stays live. A key whose home then
        dies rehashes over the grown live set."""
        pool = TargetPool(["http://a/", "http://b/"])
        homes = {k: pool.pick("hash", key=k) for k in "abcdefgh"}
        pool.admit("http://c/")
        for k, home in homes.items():
            assert pool.pick("hash", key=k) == home
        pool.remove("http://a/")
        for k, home in homes.items():
            got = pool.pick("hash", key=k)
            if home == "http://a/":
                assert got in ("http://b/", "http://c/")
            else:
                assert got == home

    def test_eject_admit_gate(self):
        pool = TargetPool(["http://a/", "http://b/"])
        assert pool.eject("http://a/", reason="readyz")
        assert not pool.eject("http://a/")  # already out: no change
        assert pool.live() == ["http://b/"]
        assert all(pool.pick("round_robin") == "http://b/" for _ in range(3))
        st = pool.states()["http://a/"]
        assert st["ejected"] and st["eject_reason"] == "readyz"
        assert not st["live"]
        assert pool.admit("http://a/")
        assert set(pool.live()) == {"http://a/", "http://b/"}
        # admitting an unknown url adds it — the rolling-swap path
        assert pool.admit("http://new/")
        assert "http://new/" in pool.urls

    def test_breaker_open_leaves_rotation(self):
        pool = TargetPool(["http://a/", "http://b/"], min_calls=1)
        pool.breaker_for("http://a/").record_failure()
        assert pool.breaker_for("http://a/").state == "open"
        assert pool.live() == ["http://b/"]
        assert not pool.states()["http://a/"]["live"]

    def test_send_fails_over_on_connection_failure(self):
        srv = _EchoServer("live")
        pool = TargetPool([_dead_url(), srv.url])
        seen = []
        try:
            # round-robin pick 0 is the dead url: the connection failure
            # (status 0) must hedge to the live one, not surface
            resp = pool.send(_post("/", {"q": 1}),
                             on_failover=lambda url, r: seen.append(
                                 (url, r.status_code)))
            assert resp.status_code == 200
            assert json.loads(resp.entity)["tag"] == "live"
            assert len(seen) == 1 and seen[0][1] == 0
        finally:
            srv.stop()

    def test_send_no_live_targets_answers_503(self):
        pool = TargetPool(["http://a/"])
        pool.eject("http://a/")
        resp = pool.send(_post("/", {"q": 1}))
        assert resp.status_code == 503
        assert resp.headers["Retry-After"]

    def test_send_rebases_request_path(self):
        srv = _EchoServer("t")
        pool = TargetPool([srv.url])
        try:
            resp = pool.send(_post("http://ignored-host/api/x?v=1", {}))
            assert json.loads(resp.entity)["path"] == "/api/x?v=1"
        finally:
            srv.stop()


class TestHTTPClientUrls:
    def test_urls_mode_spreads_round_robin(self):
        a, b = _EchoServer("a"), _EchoServer("b")
        try:
            client = HTTPClient(urls=[a.url, b.url])
            resps = client.send_all([_post("/", {"i": i}) for i in range(4)])
            assert [r.status_code for r in resps] == [200] * 4
            assert a.hits == 2 and b.hits == 2
        finally:
            a.stop()
            b.stop()

    def test_urls_mode_survives_one_dead_replica(self):
        srv = _EchoServer("live")
        try:
            client = HTTPClient(urls=[_dead_url(), srv.url])
            resps = client.send_all([_post("/", {"i": i}) for i in range(4)])
            assert [r.status_code for r in resps] == [200] * 4
        finally:
            srv.stop()


# --------------------------------------------------------------------- #
# ServingGateway                                                        #
# --------------------------------------------------------------------- #


class TestServingGateway:
    def test_routes_and_spreads(self):
        a, b = _EchoServer("a"), _EchoServer("b")
        gw = ServingGateway(urls=[a.url, b.url],
                            strategy="round_robin").start()
        try:
            statuses = [_send(gw.url, {"i": i}).status_code
                        for i in range(4)]
            assert statuses == [200] * 4
            assert a.hits == 2 and b.hits == 2
            routes = json.loads(urllib.request.urlopen(
                gw.url + "routes", timeout=10).read())
            assert routes["strategy"] == "round_robin"
            assert routes["n_live"] == 2 and routes["n_targets"] == 2
        finally:
            gw.stop()
            a.stop()
            b.stop()

    def test_routing_key_header_is_sticky(self):
        a, b = _EchoServer("a"), _EchoServer("b")
        gw = ServingGateway(urls=[a.url, b.url]).start()
        try:
            tags = {json.loads(_send(
                gw.url, {"i": i}, {"x-routing-key": "user-7"}).entity)["tag"]
                for i in range(6)}
            assert len(tags) == 1  # one key -> one replica, every time
        finally:
            gw.stop()
            a.stop()
            b.stop()

    def test_hedge_covers_a_dead_replica_and_ejects_it(self):
        srv = _EchoServer("live")
        dead = _dead_url()
        gw = ServingGateway(urls=[dead, srv.url],
                            strategy="round_robin").start()
        try:
            for i in range(4):
                assert _send(gw.url, {"i": i}).status_code == 200
            st = gw.routes()["targets"][dead]
            assert st["ejected"] and st["eject_reason"] == "connect"
        finally:
            gw.stop()
            srv.stop()

    def test_no_replica_reachable_answers_502_not_a_dropped_socket(self):
        gw = ServingGateway(urls=[_dead_url()]).start()
        try:
            resp = _send(gw.url, {"i": 1})
            assert resp.status_code == 502
            assert resp.headers["Retry-After"]
        finally:
            gw.stop()

    def test_probe_ejects_unready_and_readmits(self):
        a, b = _EchoServer("a"), _EchoServer("b")
        gw = ServingGateway(urls=[a.url, b.url]).start()
        try:
            b.ready = False
            assert gw.probe_all() == {a.url: True, b.url: False}
            st = gw.routes()["targets"][b.url]
            assert st["ejected"] and st["eject_reason"] == "readyz"
            # every request now lands on a
            for i in range(3):
                assert json.loads(
                    _send(gw.url, {"i": i}).entity)["tag"] == "a"
            b.ready = True
            assert gw.probe_all() == {a.url: True, b.url: True}
            assert gw.routes()["n_live"] == 2
        finally:
            gw.stop()
            a.stop()
            b.stop()

    def test_http_surface(self):
        a = _EchoServer("a")
        gw = ServingGateway(urls=[a.url]).start()
        try:
            health = json.loads(urllib.request.urlopen(
                gw.url + "healthz", timeout=10).read())
            assert health["status"] == "ok" and health["routes"] == 1
            ready = json.loads(urllib.request.urlopen(
                gw.url + "readyz", timeout=10).read())
            assert ready["ready"] and ready["n_live"] == 1
            _send(gw.url, {"i": 1})
            text = urllib.request.urlopen(
                gw.url + "metrics", timeout=10).read().decode()
            assert "mmlspark_tpu_gateway_requests_total" in text
            assert "mmlspark_tpu_gateway_replicas_live_count" in text
            # no autoscaler attached -> 404
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(gw.url + "autoscaler", timeout=10)
            assert exc.value.code == 404
        finally:
            gw.stop()
            a.stop()

    def test_readyz_503_when_nothing_live(self):
        gw = ServingGateway().start()
        try:
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(gw.url + "readyz", timeout=10)
            assert exc.value.code == 503
        finally:
            gw.stop()

    def test_journal_exactly_once(self, tmp_path):
        a = _EchoServer("a")
        ckpt = str(tmp_path / "journal")
        gw = ServingGateway(urls=[a.url], checkpoint_dir=ckpt).start()
        try:
            for i in range(5):
                assert _send(gw.url, {"i": i}).status_code == 200
            assert gw.journal.unanswered() == {}
            assert all(gw.journal.replied(str(i)) for i in range(5))
        finally:
            gw.stop()
            a.stop()
        # reload from disk: 5 accepts, 5 replies, nothing lost or doubled
        j = ServingJournal(ckpt)
        try:
            assert j.max_id() == 4
            assert j.unanswered() == {}
            # record_reply on an answered id reports the duplicate
            from mmlspark_tpu_torch.io_http.schema import HTTPResponseData

            assert not j.record_reply("3", HTTPResponseData(200, "dup"))
        finally:
            j.close()


# --------------------------------------------------------------------- #
# FleetAutoscaler control law (FakeClock, stub fleet — zero processes)  #
# --------------------------------------------------------------------- #


class _StubFleet:
    def __init__(self, n: int = 1):
        self.n = n
        self.dead: list[int] = []
        self.respawned: list[int] = []
        self.scaled: list[int] = []

    @property
    def n_live(self) -> int:
        return self.n

    def dead_slots(self):
        return list(self.dead)

    def respawn(self, slot):
        self.dead.remove(slot)
        self.respawned.append(slot)
        self.n += 1
        return f"http://respawned-{slot}/"

    def scale_to(self, n):
        self.scaled.append(n)
        self.n = n
        return []


def _calm_sig():
    return {"queue_depth": 0.0, "p99_latency_s": 0.0,
            "shed_rate": 0.0, "burn_rate": 0.0}


class TestFleetAutoscaler:
    def _scaler(self, fleet, sig, **kw):
        fake = kw.pop("clock", FakeClock())
        kw.setdefault("hysteresis_ticks", 2)
        kw.setdefault("cooldown_s", 30.0)
        return FleetAutoscaler(fleet, lambda: dict(sig), clock=fake,
                               **kw), fake

    @pytest.mark.parametrize("key,value", [
        ("queue_depth", 9.0), ("p99_latency_s", 0.6),
        ("shed_rate", 0.06), ("burn_rate", 11.0)])
    def test_each_pressure_signal_scales_up(self, key, value):
        fleet = _StubFleet(1)
        sig = _calm_sig()
        sig[key] = value
        scaler, _ = self._scaler(fleet, sig)
        assert scaler.tick() == "up"
        assert fleet.n_live == 2

    def test_cooldown_blocks_consecutive_scaling(self):
        fleet = _StubFleet(1)
        sig = _calm_sig()
        sig["queue_depth"] = 20.0
        scaler, fake = self._scaler(fleet, sig)
        assert scaler.tick() == "up"
        assert scaler.tick() == "none"      # inside cooldown
        assert scaler.in_cooldown()
        fake.advance(31.0)
        assert scaler.tick() == "up"
        assert fleet.n_live == 3

    def test_max_replicas_caps_scale_up(self):
        fleet = _StubFleet(2)
        sig = _calm_sig()
        sig["queue_depth"] = 20.0
        scaler, fake = self._scaler(fleet, sig, max_replicas=2)
        fake.advance(60.0)
        assert scaler.tick() == "none"
        assert fleet.n_live == 2

    def test_scale_down_needs_consecutive_calm_ticks(self):
        fleet = _StubFleet(3)
        sig = _calm_sig()
        scaler, fake = self._scaler(fleet, sig, hysteresis_ticks=3)
        fake.advance(60.0)
        assert scaler.tick() == "none"
        assert scaler.tick() == "none"
        assert scaler.tick() == "down"      # 3rd consecutive calm tick
        assert fleet.n_live == 2

    def test_hysteresis_band_resets_calm_count(self):
        fleet = _StubFleet(3)
        sig = _calm_sig()
        scaler, fake = self._scaler(fleet, sig, hysteresis_ticks=2)
        fake.advance(60.0)
        assert scaler.tick() == "none"          # calm x1
        sig["queue_depth"] = 6.0                # in the band: not calm,
        assert scaler.tick() == "none"          # not pressure — resets
        sig["queue_depth"] = 0.0
        assert scaler.tick() == "none"          # calm x1 again
        assert scaler.tick() == "down"
        assert fleet.n_live == 2

    def test_min_replicas_floors_scale_down(self):
        fleet = _StubFleet(1)
        scaler, fake = self._scaler(fleet, _calm_sig())
        fake.advance(60.0)
        for _ in range(5):
            assert scaler.tick() == "none"
        assert fleet.n_live == 1

    def test_oscillating_signals_do_not_flap(self):
        """Signals bouncing between pressure and calm every tick must
        never trigger a scale-down, and cooldown rate-limits the ups."""
        fleet = _StubFleet(1)
        sig = _calm_sig()
        scaler, fake = self._scaler(fleet, sig, hysteresis_ticks=3)
        actions = []
        for i in range(12):
            sig["queue_depth"] = 20.0 if i % 2 == 0 else 0.0
            actions.append(scaler.tick())
            fake.advance(5.0)
        assert "down" not in actions
        # 12 ticks x 5s with a 30s cooldown allows at most 2 ups
        assert actions.count("up") <= 2

    def test_heal_respawns_outside_cooldown(self):
        fleet = _StubFleet(3)
        sig = _calm_sig()
        sig["queue_depth"] = 20.0
        scaler, _ = self._scaler(fleet, sig)
        assert scaler.tick() == "up"            # starts the cooldown
        fleet.n -= 1
        fleet.dead.append(1)
        assert scaler.tick() == "respawn"       # healing ignores cooldown
        assert fleet.respawned == [1]

    def test_signals_from_slo_engine_like_object(self):
        class _Engine:
            evaluated = 0

            def evaluate(self):
                self.evaluated += 1

            def signals(self):
                return _calm_sig()

        engine = _Engine()
        scaler = FleetAutoscaler(_StubFleet(1), engine, clock=FakeClock())
        assert scaler.read_signals() == _calm_sig()
        assert engine.evaluated == 1

    def test_state_snapshot(self):
        fleet = _StubFleet(2)
        sig = _calm_sig()
        sig["queue_depth"] = 20.0
        scaler, _ = self._scaler(fleet, sig)
        scaler.tick()
        st = scaler.state()
        assert st["n_live"] == 3 and st["last_action"] == "up"
        assert st["pressure"] == ["queue_depth"]
        assert st["cooldown_remaining_s"] > 0
        assert st["events"][-1]["action"] == "up"
        json.dumps(st)  # must be GET /autoscaler serializable

    def test_bounds_validated(self):
        with pytest.raises(ValueError):
            FleetAutoscaler(_StubFleet(), _calm_sig,
                            min_replicas=3, max_replicas=2)


# --------------------------------------------------------------------- #
# fleet surgery: kill / respawn / scale / swap (real processes)         #
# --------------------------------------------------------------------- #


class TestFleetSelfHealing:
    def test_kill_prunes_urls_and_respawn_restores(self):
        fleet = ServingFleet(_double_factory, n_hosts=2,
                             max_batch_size=1).start()
        try:
            assert len(fleet.urls) == 2 and fleet.n_live == 2
            fleet.kill(0)
            assert len(fleet.urls) == 1 and fleet.n_live == 1
            assert fleet.dead_slots() == [0]
            url = fleet.respawn(0)
            assert fleet.dead_slots() == []
            assert len(fleet.urls) == 2 and url in fleet.urls
            resp = _send(url, {"x": 4.0})
            assert resp.status_code == 200
            assert json.loads(resp.entity)["y"] == 8.0
            with pytest.raises(RuntimeError):
                fleet.respawn(0)  # alive slot: refuse
        finally:
            fleet.stop()

    def test_watch_sees_scale_events_and_retire_is_not_dead(self):
        fleet = ServingFleet(_double_factory, n_hosts=1,
                             max_batch_size=1).start()
        events = []
        fleet.watch(lambda ev, url: events.append((ev, url)))
        try:
            fleet.scale_to(3)
            assert fleet.n_live == 3
            assert [e for e, _ in events] == ["added", "added"]
            fleet.scale_to(1)
            assert fleet.n_live == 1
            assert [e for e, _ in events].count("removed") == 2
            # graceful scale-down is retirement, not death: self-healing
            # must not resurrect it
            assert fleet.dead_slots() == []
        finally:
            fleet.stop()

    def test_rolling_swap_is_byte_identical(self):
        fleet = ServingFleet(_double_factory, n_hosts=1,
                             max_batch_size=1).start()
        try:
            before = _send(fleet.urls[0], {"x": 3.0})
            old_url = fleet.urls[0]
            assert fleet.rolling_swap(_double_v2_factory) == 1
            assert fleet.urls[0] != old_url
            after = _send(fleet.urls[0], {"x": 3.0})
            assert before.status_code == after.status_code == 200
            assert before.entity == after.entity
        finally:
            fleet.stop()

    def test_autoscaler_heals_a_real_crash(self):
        fleet = ServingFleet(_double_factory, n_hosts=1,
                             max_batch_size=1).start()
        try:
            scaler = FleetAutoscaler(fleet, _calm_sig, clock=FakeClock())
            fleet.kill(0)
            assert fleet.n_live == 0
            assert scaler.tick() == "respawn"
            assert fleet.n_live == 1
            assert _send(fleet.urls[0], {"x": 1.0}).status_code == 200
        finally:
            fleet.stop()


# --------------------------------------------------------------------- #
# the chaos soak acceptance test                                        #
# --------------------------------------------------------------------- #


class TestChaosSoak:
    def test_soak_scale_kill_heal_swap(self, tmp_path):
        fake = FakeClock()
        ckpt = str(tmp_path / "journal")
        # control plane (gateway retry pacing, autoscaler cooldown/
        # hysteresis) runs on FakeClock; the fleet keeps the real clock —
        # replica startup is real wall time
        fleet = ServingFleet(_soak_factory, n_hosts=1,
                             max_batch_size=1,
                             warmup_request=_WARM_REQ).start()
        # round_robin so every replica — including the corpse — keeps
        # getting picked (least_loaded breaks 0-inflight ties by order,
        # which would let a sequential soak dodge the dead target)
        gw = ServingGateway(checkpoint_dir=ckpt, clock=fake,
                            strategy="round_robin")
        gw.attach_fleet(fleet)
        gw.start()
        sig = _calm_sig()
        scaler = FleetAutoscaler(
            fleet, lambda: dict(sig), min_replicas=1, max_replicas=4,
            hysteresis_ticks=2, cooldown_s=30.0, clock=fake)
        gw.attach_autoscaler(scaler)

        statuses: list[int] = []
        latencies: list[float] = []
        n_posted = 0

        def post(x: float) -> "tuple[int, bytes]":
            # retries=0: one post = exactly one gateway accept, so the
            # journal-density check at the bottom can count them
            nonlocal n_posted
            n_posted += 1
            t0 = time.perf_counter()
            resp = _send(gw.url, {"x": x}, retries=0)
            latencies.append(time.perf_counter() - t0)
            statuses.append(resp.status_code)
            return resp.status_code, resp.entity or b""

        try:
            rv = fleet.rendezvous
            # one known-good body for byte-identity checks (x=3 -> y=6);
            # chaos is probabilistic, so sample via the gateway until a
            # 200 lands
            body_3 = None
            while body_3 is None:
                st, body = post(3.0)
                if st == 200:
                    body_3 = body

            # -- phase 1: pressure scales 1 -> 4, cooldown-paced
            for _ in range(10):
                post(3.0)
            sig["queue_depth"] = 20.0
            ups = []
            for _ in range(3):
                fake.advance(31.0)
                ups.append(scaler.tick())
            assert ups == ["up", "up", "up"]
            assert fleet.n_live == 4 and len(fleet.urls) == 4
            assert gw.routes()["n_live"] == 4
            fake.advance(31.0)
            assert scaler.tick() == "none"  # at max: pressure can't overshoot
            for _ in range(10):
                post(3.0)

            # -- monotone fleet counters: snapshot before the crash
            rv.aggregator.scrape()
            seen_before_kill = rv.aggregator.total(_SEEN)
            assert seen_before_kill > 0

            # -- phase 2: HARD KILL one replica, fleet not told — the
            #    gateway keeps routing at the corpse until the hedge
            #    ejects it; the crash must never reach a client
            fleet._procs[2].kill()
            fleet._procs[2].join(timeout=10)
            for _ in range(30):
                post(3.0)
            # the dead replica is out of the gateway's rotation
            assert gw.routes()["n_live"] == 3

            rv.aggregator.scrape()
            seen_after_kill = rv.aggregator.total(_SEEN)
            assert seen_after_kill >= seen_before_kill

            # -- phase 3: self-heal (outside any scaling decision);
            #    mid-band signals so no scale action competes
            sig["queue_depth"] = 6.0
            assert fleet.dead_slots() == [2]
            assert scaler.tick() == "respawn"
            assert fleet.n_live == 4
            assert fleet.dead_slots() == []
            assert gw.routes()["n_live"] == 4
            for _ in range(10):
                post(3.0)
            rv.aggregator.scrape()
            assert rv.aggregator.total(_SEEN) >= seen_after_kill

            # -- phase 4: rolling swap under live load, byte-identical
            stop_load = threading.Event()
            swap_bodies: list[tuple[int, bytes]] = []

            def _load():
                while not stop_load.is_set():
                    swap_bodies.append(post(3.0))

            loader = threading.Thread(target=_load, daemon=True)
            loader.start()
            try:
                assert fleet.rolling_swap(_double_v2_factory) == 4
            finally:
                stop_load.set()
                loader.join(timeout=30)
            assert fleet.n_live == 4
            assert swap_bodies, "no load went through during the swap"
            for st, body in swap_bodies:
                assert st in (200, 500)  # 500 = injected chaos, pre-swap
                if st == 200:
                    assert body == body_3
            # post-swap handlers are chaos-free: all 200, same bytes
            for _ in range(10):
                st, body = post(3.0)
                assert st == 200 and body == body_3

            # -- phase 5: calm scales 4 -> 1 without flapping
            sig["queue_depth"] = 0.0
            downs = []
            for _ in range(12):
                fake.advance(31.0)
                downs.append(scaler.tick())
                if fleet.n_live == 1:
                    break
            assert fleet.n_live == 1
            assert "up" not in downs
            assert downs.count("down") == 3
            assert gw.routes()["n_live"] == 1

            # -- acceptance: chaos faults surface as handler 500s, the
            #    crash surfaces as NOTHING — no connection-level status
            #    (0), no 502/503, ever
            assert set(statuses) <= {200, 500}
            assert statuses.count(200) > statuses.count(500)
            # p99 holds through kill + swap (generous real-time bound:
            # the assertion is "no request hung", not a latency claim)
            assert float(np.percentile(latencies, 99)) < 5.0

            # -- journal: every request accepted AND answered exactly once
            assert gw.journal.unanswered() == {}
        finally:
            gw.stop()
            fleet.stop()

        j = ServingJournal(ckpt)
        try:
            # ids are a dense 0..n-1 sequence: nothing lost, nothing
            # duplicated, and every accept has its reply
            assert j.max_id() == n_posted - 1
            assert j.unanswered() == {}
        finally:
            j.close()


# --------------------------------------------------------------------- #
# GatewayTier                                                           #
# --------------------------------------------------------------------- #


@pytest.mark.slow
class TestGatewayTier:
    def test_tier_lifecycle_kill_window_and_respawn(self, tmp_path):
        """One pass over the whole tier contract (single test to pay the
        worker-spawn cost once): N processes answer on ONE shared port,
        workers() and the control endpoint expose per-worker rows, a
        SIGKILL'd worker costs zero failed sends (the surviving listeners
        keep the port), and respawn refills the slot onto the same
        journal shard."""
        from mmlspark_tpu_torch.io_http.gateway import GatewayTier

        a, b = _EchoServer("a"), _EchoServer("b")
        tier = None
        try:
            tier = GatewayTier(
                urls=[a.url, b.url], n_workers=2,
                checkpoint_dir=str(tmp_path)).start()

            # the kernel balances CONNECTIONS across listeners, so fresh
            # connections (retries=1 client default creates per-send when
            # none pooled) exercise the shared port
            for i in range(8):
                r = _send(tier.url, {"x": float(i)})
                assert r.status_code == 200, r
                assert r.json()["tag"] in ("a", "b")

            rows = tier.workers()
            assert [row["index"] for row in rows] == [0, 1]
            assert all(row["alive"] for row in rows)
            pids = {row["pid"] for row in rows}
            assert len(pids) == 2  # two real processes
            assert all(str(tmp_path) in row["journal_shard"]
                       for row in rows)
            served = sum(row["stats"]["requests"] for row in rows
                         if row["stats"])
            assert served >= 8

            # control endpoint: what diagnose.py --gateway renders
            doc = _get_json(tier.control_url + "workers")
            assert doc["tier"] is True and doc["n_workers"] == 2
            assert doc["port"] == tier.port
            assert set(doc["members"]) == {a.url, b.url}
            assert len(doc["workers"]) == 2

            # kill window: SIGKILL worker 1; every send keeps succeeding
            tier.kill_worker(1)
            for i in range(8):
                r = _send(tier.url, {"x": float(i)}, retries=3)
                assert r.status_code == 200, \
                    f"send failed during kill window: {r.status_code}"
            rows = tier.workers()
            assert rows[0]["alive"] and not rows[1]["alive"]
            assert rows[1]["stats"] is None  # death visible, row stays

            tier.respawn_worker(1)
            rows = tier.workers()
            assert all(row["alive"] for row in rows)
            assert rows[1]["pid"] not in pids  # a NEW process, same slot
            r = _send(tier.url, {"x": 1.0})
            assert r.status_code == 200
        finally:
            if tier is not None:
                tier.stop()
            a.stop()
            b.stop()

    def test_tier_membership_broadcast(self, tmp_path):
        """admit/remove reach every worker: after removing replica A,
        no reply carries A's tag regardless of which worker answered."""
        from mmlspark_tpu_torch.io_http.gateway import GatewayTier

        a, b = _EchoServer("a"), _EchoServer("b")
        tier = None
        try:
            tier = GatewayTier(urls=[a.url], n_workers=2).start()
            tier.admit(b.url)
            tier.remove(a.url)
            tags = set()
            for i in range(8):
                r = _send(tier.url, {"x": float(i)}, retries=3)
                assert r.status_code == 200
                tags.add(r.json()["tag"])
            assert tags == {"b"}
        finally:
            if tier is not None:
                tier.stop()
            a.stop()
            b.stop()


# --------------------------------------------------------------------- #
# the port against the JAX package                                      #
# --------------------------------------------------------------------- #


class TestRoutingAcrossPackages:
    def test_stable_hash_is_the_same_function(self):
        from mmlspark_tpu.io_http.clients import _stable_hash as ref_hash

        from mmlspark_tpu_torch.io_http.clients import _stable_hash

        keys = ["", "a", "user-7", "http://127.0.0.1:8000/#3", "ключ", "x" * 300]
        keys += [f"k{i}" for i in range(200)]
        assert [_stable_hash(k) for k in keys] == [ref_hash(k) for k in keys]

    def test_hash_places_the_same_keys_on_the_same_targets(self):
        from mmlspark_tpu.io_http.clients import TargetPool as RefPool

        urls = [f"http://10.0.0.{i}:80{i}/" for i in range(5)]
        keys = [f"user-{i}" for i in range(300)]
        placements = []
        for cls in (TargetPool, RefPool):
            pool = cls(urls[:3])
            trail = [[pool.pick("hash", key=k) for k in keys]]
            pool.admit(urls[3])
            trail.append([pool.pick("hash", key=k) for k in keys])
            pool.remove(urls[0])
            trail.append([pool.pick("hash", key=k) for k in keys])
            pool.eject(urls[1], reason="readyz")
            pool.admit(urls[4])
            trail.append([pool.pick("hash", key=k) for k in keys])
            pool.admit(urls[1])
            trail.append([pool.pick("hash", key=k) for k in keys])
            trail.append([pool.pick("round_robin") for _ in range(12)])
            placements.append(trail)
        assert placements[0] == placements[1]


class TestAutoscalerAcrossPackages:
    def test_same_decisions_for_the_same_signals(self):
        from mmlspark_tpu.io_http.autoscale import FleetAutoscaler as RefScaler
        from mmlspark_tpu.resilience.policy import FakeClock as RefClock

        rng = np.random.default_rng(19)
        seq = []
        for i in range(90):
            if 30 <= i < 60:                # a calm stretch: the scale-downs
                seq.append(dict(_calm_sig(), dt=31.0, crash=False))
                continue
            seq.append({"queue_depth": float(rng.choice([0.0, 3.0, 6.0, 20.0])),
                        "p99_latency_s": float(rng.choice([0.0, 0.2, 0.6])),
                        "shed_rate": float(rng.choice([0.0, 0.0, 0.06])),
                        "burn_rate": float(rng.choice([0.0, 0.0, 11.0])),
                        "dt": float(rng.choice([1.0, 5.0, 31.0])),
                        "crash": bool(rng.random() < 0.05)})
        trails = []
        for cls, clock_cls in ((FleetAutoscaler, FakeClock), (RefScaler, RefClock)):
            fleet = _StubFleet(2)
            sig = _calm_sig()
            clock = clock_cls()
            scaler = cls(fleet, lambda: dict(sig), clock=clock, min_replicas=1,
                         max_replicas=5, hysteresis_ticks=3, cooldown_s=30.0)
            trail = []
            for step in seq:
                sig.update({k: v for k, v in step.items() if k not in ("dt", "crash")})
                if step["crash"] and fleet.n > 1:
                    fleet.n -= 1
                    fleet.dead.append(len(fleet.respawned) + 100)
                trail.append((scaler.tick(), fleet.n_live))
                clock.advance(step["dt"])
            st = scaler.state()
            trail.append({k: st[k] for k in ("n_live", "last_action", "pressure")})
            trail.append(st["events"])
            trails.append(trail)
        assert trails[0] == trails[1]
        assert {a for a, _n in trails[0][:-2]} >= {"up", "down", "respawn", "none"}


def _ref_double_factory():
    """The JAX package's twin of `_double_factory` (its replica imports only
    the JAX package's schema helpers)."""
    from mmlspark_tpu.io_http.schema import make_reply as ref_make_reply
    from mmlspark_tpu.io_http.schema import parse_request as ref_parse_request

    def handler(table):
        t = ref_parse_request(table)
        return ref_make_reply(
            t.with_column("y", np.asarray(t["x"], dtype=float) * 2), "y")
    return handler


def _kill_window(fleet, gateway_url: str) -> "tuple[int, list]":
    """bench.py's kill window (bench.py:1938-1941): 100 keep-alive posts
    through the gateway, replica 1 SIGKILLed without the fleet or the
    gateway told, 200 more. Returns the client-visible errors and the
    reply bodies."""
    import http.client
    import urllib.parse

    p = urllib.parse.urlsplit(gateway_url)
    statuses, bodies = [], []

    def posts(n: int, offset: int) -> None:
        conn = http.client.HTTPConnection(p.hostname, p.port, timeout=30)
        try:
            for i in range(offset, offset + n):
                try:
                    conn.request("POST", "/", body=json.dumps({"x": float(i)}).encode(),
                                 headers={"Content-Type": "application/json"})
                    r = conn.getresponse()
                    bodies.append(r.read())
                    statuses.append(r.status)
                except OSError:
                    statuses.append(0)
                    conn.close()
                    conn = http.client.HTTPConnection(p.hostname, p.port, timeout=30)
        finally:
            conn.close()

    posts(100, 0)
    fleet._procs[1].kill()
    fleet._procs[1].join(timeout=10)
    posts(200, 100)
    return sum(s != 200 for s in statuses), bodies


class TestKillWindowAcrossPackages:
    def test_the_port_loses_no_more_requests_than_the_reference(self):
        from mmlspark_tpu.io_http.gateway import ServingGateway as RefGateway
        from mmlspark_tpu.io_http.serving import ServingFleet as RefFleet

        results = {}
        for name, fleet_cls, gw_cls, factory in (
                ("port", ServingFleet, ServingGateway, _double_factory),
                ("reference", RefFleet, RefGateway, _ref_double_factory)):
            fleet = fleet_cls(factory, n_hosts=2, max_batch_size=1).start()
            gw = None
            try:
                gw = gw_cls().attach_fleet(fleet).start()
                results[name] = _kill_window(fleet, gw.url)
            finally:
                if gw is not None:
                    gw.stop()
                fleet.stop()
        assert results["reference"][0] == 0, results["reference"][0]
        assert results["port"][0] == 0, results["port"][0]
        assert results["port"][1] == results["reference"][1]
        assert len(results["port"][1]) == 300
