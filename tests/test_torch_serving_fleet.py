"""The port's distributed serving (mmlspark_tpu_torch/io_http/serving.py's
ServiceInfo, FleetRendezvous and ServingFleet, consolidator.py's
ConsolidatorService and forwarding.py) held to the JAX package's:
tests/test_serving.py's TestServingFleet, TestFleetRendezvous,
TestFleetConsolidator and TestPortForwarding and
tests/test_serving_hot_path.py's TestGatewaySwap through the port on the
CPU; a port fleet and a JAX-package fleet serving a GBDT regressor with the
same trees (fitted by the JAX package, its model string loaded by the port)
giving the same reply bytes to the same requests; and a ServiceInfo
crossing between the packages.

The JAX package is imported inside the tests and inside its own fleet's
factory only: port replicas are spawned processes that import this module
to find their handler factory, and they must not load JAX. Every fleet,
gateway and server stops in a `finally`; every client call has a timeout.
"""

import functools
import json
import threading
import time
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu_torch.core.schema import Table  # noqa: E402
from mmlspark_tpu_torch.io_http import (  # noqa: E402
    HTTPRequestData,
    ServingFleet,
    make_reply,
    parse_request,
    serve_model,
)


def _post(url: str, payload: dict, timeout=10) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(url: str, timeout=10) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _echo_handler(table: Table) -> Table:
    t = parse_request(table)
    return make_reply(t.with_column("doubled", np.asarray(t["x"]) * 2), "doubled")


# module-level so ServingFleet's spawn context can pickle it
def _fleet_factory():
    return _echo_handler



class TestServingFleet:
    def test_two_host_fleet(self):
        """Two real server processes (per-'host' JVMSharedServer analogue):
        requests round-robined across hosts all answer, and each host's info
        endpoint reports its own counters."""
        fleet = ServingFleet(_fleet_factory, n_hosts=2).start()
        try:
            assert len(fleet.urls) == 2
            assert fleet.urls[0] != fleet.urls[1]
            for i in range(10):
                out = _post(fleet.urls[i % 2], {"x": float(i)})
                assert out == {"doubled": 2.0 * i}
            infos = [_get(u) for u in fleet.urls]
        finally:
            fleet.stop()
        assert [i["answered"] for i in infos] == [5, 5]


def _consolidator_factory(consolidator_url):
    """Fleet handler that proxies every request through the fleet-wide
    ConsolidatorService instead of hitting the 'upstream' directly."""
    import http.client
    import urllib.parse

    u = urllib.parse.urlparse(consolidator_url)

    def handler(table):
        t = parse_request(table)
        outs = []
        for x in np.asarray(t["x"], np.float64):
            conn = http.client.HTTPConnection(u.hostname, u.port, timeout=30)
            conn.request("POST", "/", body=json.dumps({"x": float(x)}).encode())
            r = conn.getresponse()
            outs.append(float(json.loads(r.read())["y"]))
            conn.close()
        return make_reply(t.with_column("y", np.asarray(outs)), "y")

    return handler


class TestFleetRendezvous:
    def test_info_aggregates_live_replica_counters(self):
        """The driver rendezvous collects each replica's ServiceInfo at
        startup and GET /info merges live per-replica counters into fleet
        totals (reference HTTPSourceV2.scala:118-165)."""
        fleet = ServingFleet(_fleet_factory, n_hosts=2).start()
        try:
            for i in range(10):
                _post(fleet.urls[i % 2], {"x": float(i)})
            agg = fleet.info()
            # the same aggregate must be reachable over plain HTTP
            http_agg = _get(fleet.rendezvous.url + "/info")
            services = _get(fleet.rendezvous.url + "/services")
        finally:
            fleet.stop()
        assert agg["n_replicas"] == 2
        assert agg["totals"]["answered"] == 10
        assert sorted(r["partition_id"] for r in agg["replicas"]) == [0, 1]
        assert all(r["reachable"] for r in agg["replicas"])
        assert [r["answered"] for r in sorted(
            agg["replicas"], key=lambda r: r["partition_id"])] == [5, 5]
        assert http_agg["totals"]["answered"] == 10
        assert len(services) == 2

    def test_unreachable_replica_reported(self):
        from mmlspark_tpu_torch.io_http.serving import FleetRendezvous, ServiceInfo

        rv = FleetRendezvous().start()
        try:
            rv.register(ServiceInfo(name="dead", host="127.0.0.1",
                                    port=1, partition_id=0, pid=0))
            agg = rv.info()
        finally:
            rv.stop()
        assert agg["replicas"][0]["reachable"] is False
        assert agg["totals"]["answered"] == 0


class TestFleetConsolidator:
    def test_rate_limited_upstream_sees_one_bounded_client(self):
        """Two replica PROCESSES route upstream calls through one
        ConsolidatorService: the upstream observes at most num_lanes=1
        concurrent call across the whole fleet (the cross-process
        PartitionConsolidator guarantee, PartitionConsolidator.scala:103+)."""
        import functools

        from mmlspark_tpu_torch.io_http.consolidator import ConsolidatorService

        seen = {"max_concurrent": 0, "current": 0}
        lock = threading.Lock()

        def upstream(body: bytes) -> bytes:
            with lock:
                seen["current"] += 1
                seen["max_concurrent"] = max(seen["max_concurrent"],
                                             seen["current"])
            time.sleep(0.02)
            x = json.loads(body)["x"]
            with lock:
                seen["current"] -= 1
            return json.dumps({"y": x * 10}).encode()

        svc = ConsolidatorService(upstream, num_lanes=1).start()
        fleet = ServingFleet(
            functools.partial(_consolidator_factory, svc.url),
            n_hosts=2, rendezvous=False,
        ).start()
        results, errors = [], []

        def client(i):
            try:
                results.append(
                    (_post(fleet.urls[i % 2], {"x": float(i)}), float(i) * 10)
                )
            except Exception as e:  # noqa: BLE001
                errors.append(repr(e))

        try:
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(6)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            fleet.stop()
            svc.stop()
        assert not errors, errors
        assert len(results) == 6
        assert all(out == {"y": want} for out, want in results)
        assert svc.served == 6
        assert seen["max_concurrent"] == 1, (
            "rate-limited upstream saw concurrent fleet calls"
        )
        assert svc.max_in_flight <= 1



class TestPortForwarding:
    """The NAT/tunnel path (reference PortForwarding.scala:16-66 +
    HTTPSourceV2.scala:363-372): reverse-forward command contract, the
    listen-port scan loop, and ServiceInfo's public coordinates — all
    driven through an injected launcher (zero-egress environment)."""

    def _opts(self, **kw):
        from mmlspark_tpu_torch.io_http.forwarding import ForwardingOptions

        base = dict(username="svc", ssh_host="gw.example.com")
        base.update(kw)
        return ForwardingOptions(**base)

    def test_ssh_command_contract(self):
        from mmlspark_tpu_torch.io_http.forwarding import build_ssh_command

        cmd = build_ssh_command(
            self._opts(ssh_port=2222, key_file="/k/id_ed25519"),
            remote_port=8900, local_host="127.0.0.1", local_port=8898)
        assert cmd[0] == "ssh" and "-N" in cmd
        # listen-port-busy must exit (the scan signal), not warn-and-stay
        assert "ExitOnForwardFailure=yes" in cmd
        assert cmd[cmd.index("-p") + 1] == "2222"
        assert cmd[cmd.index("-i") + 1] == "/k/id_ed25519"
        assert cmd[cmd.index("-R") + 1] == "*:8900:127.0.0.1:8898"
        assert cmd[-1] == "svc@gw.example.com"

    def test_bind_address_prefixes_listen_spec(self):
        from mmlspark_tpu_torch.io_http.forwarding import build_ssh_command

        cmd = build_ssh_command(
            self._opts(bind_address="0.0.0.0"), 9000, "10.0.0.5", 8898)
        assert cmd[cmd.index("-R") + 1] == "0.0.0.0:9000:10.0.0.5:8898"
        # the default "*" (all interfaces) must be EXPLICIT in the -R
        # spec: a prefix-less spec binds the gateway's loopback only,
        # which would advertise unreachable public coordinates
        cmd = build_ssh_command(self._opts(), 9000, "10.0.0.5", 8898)
        assert cmd[cmd.index("-R") + 1] == "*:9000:10.0.0.5:8898"
        # "" opts into loopback-only deliberately
        cmd = build_ssh_command(
            self._opts(bind_address=""), 9000, "10.0.0.5", 8898)
        assert cmd[cmd.index("-R") + 1] == "9000:10.0.0.5:8898"

    class _FakeProc:
        def __init__(self, dies: bool):
            self._dies = dies
            self.terminated = False

        def poll(self):
            return 255 if self._dies else None

        def terminate(self):
            self.terminated = True

        def wait(self, timeout=None):
            return 0

    def test_port_scan_skips_busy_listen_ports(self):
        """First two candidate ports exit immediately (busy), the third
        survives the settle window — the reference's remotePortStart +
        attempt loop (PortForwarding.scala:46-62)."""
        from mmlspark_tpu_torch.io_http.forwarding import establish_forward

        attempts = []

        def launcher(cmd):
            attempts.append(cmd[cmd.index("-R") + 1])
            return self._FakeProc(dies=len(attempts) <= 2)

        fwd = establish_forward(
            8898, self._opts(remote_port_start=9000), launcher=launcher,
            settle_s=0.15)
        assert fwd.remote_port == 9002 and fwd.public_address == (
            "gw.example.com", 9002)
        assert [a.split(":")[1] for a in attempts] == ["9000", "9001", "9002"]
        assert fwd.alive()
        fwd.close()
        assert fwd._proc.terminated

    def test_exhausted_scan_raises(self):
        from mmlspark_tpu_torch.io_http.forwarding import establish_forward

        with pytest.raises(RuntimeError, match="could not establish"):
            establish_forward(
                8898, self._opts(max_retries=2),
                launcher=lambda cmd: self._FakeProc(dies=True),
                settle_s=0.05)

    def test_remote_port_start_defaults_to_local_port(self):
        from mmlspark_tpu_torch.io_http.forwarding import establish_forward

        seen = []

        def launcher(cmd):
            seen.append(cmd[cmd.index("-R") + 1])
            return self._FakeProc(dies=False)

        establish_forward(8123, self._opts(), launcher=launcher,
                          settle_s=0.05)
        assert seen == ["*:8123:127.0.0.1:8123"]

    def test_service_info_carries_public_coords(self):
        from mmlspark_tpu_torch.io_http.serving import ServiceInfo

        info = ServiceInfo(name="s", host="127.0.0.1", port=8898,
                           partition_id=3, pid=42, local_ip="10.0.0.7",
                           public_host="gw.example.com", public_port=9002)
        again = ServiceInfo.from_dict(info.to_dict())
        assert again == info
        # registrations from replicas without forwarding stay loadable
        legacy = ServiceInfo.from_dict(
            {"name": "s", "host": "h", "port": 1, "partition_id": 0})
        assert legacy.public_host is None and legacy.public_port is None

    def test_get_local_ip_returns_address(self):
        import ipaddress

        from mmlspark_tpu_torch.io_http.forwarding import get_local_ip

        ipaddress.ip_address(get_local_ip())  # parses or raises

    def test_fleet_registers_public_coords_end_to_end(self, tmp_path):
        """ServingFleet(forwarding=...) through the REAL worker path: each
        spawned replica launches the (stubbed) ssh client, survives the
        settle window, and registers public_host/public_port in the
        rendezvous — the full HTTPSourceV2 forwarding.enabled flow with
        only the ssh binary replaced by a sleeper stub."""
        import stat

        from mmlspark_tpu_torch.io_http.forwarding import ForwardingOptions
        from mmlspark_tpu_torch.io_http.serving import ServingFleet

        # single-process stub (like real ssh): a sh wrapper would orphan
        # its sleep child on SIGTERM and pollute the host with strays
        stub = tmp_path / "fake_ssh"
        stub.write_text(
            "#!/usr/bin/env python3\nimport time\ntime.sleep(300)\n")
        stub.chmod(stub.stat().st_mode | stat.S_IEXEC)

        fleet = ServingFleet(
            _fleet_factory, n_hosts=2,
            forwarding=ForwardingOptions(
                username="svc", ssh_host="gw.example.com",
                remote_port_start=9500, ssh_command=str(stub),
                connect_timeout_s=0.2, settle_margin_s=0.3),
        ).start()
        try:
            services = fleet.rendezvous.services()
            assert len(services) == 2
            for svc in services:
                assert svc.public_host == "gw.example.com"
                assert svc.public_port == 9500   # port scan start, per replica
                assert svc.local_ip
            # the data path still answers on the direct coordinates
            out = _post(fleet.urls[0], {"x": 2.0})
            assert out == {"doubled": 4.0}
        finally:
            fleet.stop()
        # stop() must tear the tunnels down WITH the workers (SIGTERM
        # unwinds through the worker's finally): a stranded ssh would hold
        # the remote listen port and advertise a dead server
        import subprocess
        import time as _time

        deadline = _time.monotonic() + 10
        while _time.monotonic() < deadline:
            alive = subprocess.run(
                ["pgrep", "-f", str(stub)], capture_output=True).stdout
            if not alive.strip():
                break
            _time.sleep(0.2)
        assert not alive.strip(), f"orphaned tunnel stubs: {alive}"


# --------------------------------------------------------------------- #
# tests/test_serving_hot_path.py's TestGatewaySwap                      #
# --------------------------------------------------------------------- #

COLS = ["x0", "x1", "x2", "x3"]


def _train_model(seed: int = 7):
    """A deterministically-trained GBDT on f32-representable features —
    two calls with the same seed produce byte-identical boosters (the
    rolling-swap test depends on it)."""
    from mmlspark_tpu_torch.gbdt.estimators import GBDTRegressor

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


def _warm_request():
    return HTTPRequestData.from_json("/", _payload(3))


def _post_raw(url: str, payload: dict, timeout=30) -> bytes:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def _wait_ready(srv, timeout_s: float = 120.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if srv.ready:
            return
        time.sleep(0.02)
    raise TimeoutError(
        f"server never became ready; hot_path="
        f"{srv.hot_path.snapshot() if srv.hot_path else None}")


class TestGatewaySwap:
    def test_swap_through_gateway_is_byte_identical(self):
        """Zero-downtime swap behind the gateway: replica A (hot path on
        its measured routing) answers, replica B (same deterministic
        model, forced resident) is admitted and A removed — client bytes
        through the gateway never change. This is the gateway-level
        rolling_swap contract with the device-resident route live."""
        from mmlspark_tpu_torch.io_http.gateway import ServingGateway

        a = serve_model(_train_model(), COLS, max_batch_size=8,
                        warmup_request=_warm_request(), device="cpu")
        b = serve_model(_train_model(), COLS, max_batch_size=8,
                        warmup_request=_warm_request(), device="cpu")
        gw = None
        try:
            _wait_ready(a)
            _wait_ready(b)
            b.hot_path.force_path = "resident"
            gw = ServingGateway(urls=[a.url]).start()
            before = [_post_raw(gw.url, _payload(i)) for i in range(5)]
            # the rolling-swap sequence: publish the warm successor, then
            # retire the old replica — the pool never goes empty
            gw.admit(b.url)
            gw.remove(a.url)
            a.stop()
            after = [_post_raw(gw.url, _payload(i)) for i in range(5)]
            assert before == after
            assert b.hot_path.snapshot()["paths"]["resident"] >= 5
        finally:
            if gw is not None:
                gw.stop()
            for srv in (a, b):
                try:
                    srv.stop()
                except Exception:  # noqa: BLE001 — already stopped
                    pass


# --------------------------------------------------------------------- #
# the port against the JAX package                                      #
# --------------------------------------------------------------------- #


def _port_gbdt_factory(model_path: str):
    """A port replica's handler: the regressor loaded from the model file
    the parent wrote, fused on the CPU, scored a batch at a time."""
    from mmlspark_tpu_torch.core.fusion import fuse
    from mmlspark_tpu_torch.core.pipeline import pipeline_model
    from mmlspark_tpu_torch.gbdt.estimators import GBDTRegressionModel

    model = fuse(pipeline_model(GBDTRegressionModel.load_native_model(model_path, device="cpu")),
                 device="cpu")

    def handler(table):
        return make_reply(model.transform(parse_request(table)), "prediction")

    return handler


def _ref_gbdt_factory(model_path: str):
    """The JAX package's replica handler over the same model file."""
    from mmlspark_tpu.core.fusion import fuse
    from mmlspark_tpu.core.pipeline import pipeline_model
    from mmlspark_tpu.gbdt.estimators import GBDTRegressionModel
    from mmlspark_tpu.io_http.schema import make_reply as ref_make_reply
    from mmlspark_tpu.io_http.schema import parse_request as ref_parse_request

    model = fuse(pipeline_model(GBDTRegressionModel.load_native_model(model_path)))

    def handler(table):
        return ref_make_reply(model.transform(ref_parse_request(table)), "prediction")

    return handler


class TestSameTreesFleetsAcrossPackages:
    def test_fleets_give_the_same_reply_bytes(self, tmp_path):
        from mmlspark_tpu.core.schema import Table as RefTable
        from mmlspark_tpu.gbdt.estimators import GBDTRegressor as RefRegressor
        from mmlspark_tpu.io_http.schema import HTTPRequestData as RefRequest
        from mmlspark_tpu.io_http.serving import ServingFleet as RefFleet

        rng = np.random.default_rng(19)
        x = rng.normal(size=(300, 4)).astype(np.float32).astype(np.float64)
        y = x @ np.asarray([1.0, -2.0, 0.5, 3.0]) + rng.normal(scale=0.1, size=300)
        ref = RefRegressor(num_iterations=6, num_leaves=7).fit(
            RefTable({"features": x, "label": y}))
        path = str(tmp_path / "model.txt")
        with open(path, "w") as fh:
            fh.write(ref.booster.to_text())
        rows = [{"features": [float(v) for v in x[i]]} for i in range(16)]
        replies = {}
        for name, fleet_cls, factory, req_cls in (
                ("port", ServingFleet, _port_gbdt_factory, HTTPRequestData),
                ("ref", RefFleet, _ref_gbdt_factory, RefRequest)):
            fleet = fleet_cls(functools.partial(factory, path), n_hosts=2, max_batch_size=1,
                              warmup_request=req_cls.from_json("/", rows[0])).start()
            try:
                replies[name] = [_post_raw(fleet.urls[i % 2], row, timeout=60)
                                 for i, row in enumerate(rows)]
                replies[name + " totals"] = fleet.info()["totals"]
            finally:
                fleet.stop()
        assert replies["port"] == replies["ref"]
        assert len(set(replies["port"])) > 1
        assert replies["port totals"] == replies["ref totals"] == {"seen": 16, "answered": 16}


class TestServiceInfoAcrossPackages:
    _INFOS = [dict(name="mmlspark_tpu.serving", host="127.0.0.1", port=8898,
                   partition_id=3, pid=42, local_ip="10.0.0.7",
                   public_host="gw.example.com", public_port=9002),
              dict(name="s", host="h", port=1, partition_id=0, pid=0)]

    @pytest.mark.parametrize("fields", _INFOS, ids=["forwarded", "direct"])
    def test_to_dict_from_dict_both_ways(self, fields):
        from mmlspark_tpu.io_http.serving import ServiceInfo as RefInfo

        from mmlspark_tpu_torch.io_http.serving import ServiceInfo

        mine, ref = ServiceInfo(**fields), RefInfo(**fields)
        assert mine.to_dict() == ref.to_dict()
        assert RefInfo.from_dict(mine.to_dict()) == ref
        assert ServiceInfo.from_dict(ref.to_dict()) == mine
        assert json.dumps(mine.to_dict()) == json.dumps(ref.to_dict())

    def test_port_replica_registers_with_a_reference_rendezvous(self):
        from mmlspark_tpu.io_http.serving import FleetRendezvous as RefRendezvous

        from mmlspark_tpu_torch.io_http.serving import (ServiceInfo,
                                                        _register_with_rendezvous)

        rv = RefRendezvous().start()
        try:
            _register_with_rendezvous(rv.url, ServiceInfo(**self._INFOS[0]))
            (svc,) = rv.services()
        finally:
            rv.stop()
        assert svc.to_dict() == ServiceInfo(**self._INFOS[0]).to_dict()
