"""A request that reaches a retiring replica after its drain began is
resent, not lost (port io_http/clients.py's `TargetPool.send`).

`ServingFleet.retire` removes a replica from the routing pool and then
signals it to drain; a request already on its way is shed with a 503
before it runs. The port's pool resends such a 503 once to another live
target; a 503 from a target still in the pool (overload) is returned as
it is, as the JAX package's pool returns both. Real ServingServers on the
CPU; every server stopped in `finally`.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu.io_http.clients import TargetPool as JaxPool  # noqa: E402
from mmlspark_tpu.io_http.schema import HTTPRequestData as JaxRequest  # noqa: E402
from mmlspark_tpu.resilience.policy import RetryPolicy as JaxRetryPolicy  # noqa: E402
from mmlspark_tpu_torch.core.schema import Table  # noqa: E402
from mmlspark_tpu_torch.io_http.clients import TargetPool  # noqa: E402
from mmlspark_tpu_torch.io_http.gateway import ServingGateway  # noqa: E402
from mmlspark_tpu_torch.io_http.schema import HTTPRequestData, HTTPResponseData  # noqa: E402
from mmlspark_tpu_torch.io_http.serving import ServingServer  # noqa: E402
from mmlspark_tpu_torch.resilience.policy import RetryPolicy  # noqa: E402


def _answer(name: str):
    def handler(table: Table) -> Table:
        return Table({"reply": [HTTPResponseData(200, "OK", entity=json.dumps(
            {"served_by": name}).encode()) for _ in table["request"]]})
    return handler


@pytest.fixture()
def servers():
    made = [ServingServer(_answer(n)).start() for n in ("old", "new")]
    try:
        yield made
    finally:
        for srv in made:
            srv.stop(drain=False)


# one attempt a target: the pool's resend is what is under test, not
# http_send's own retry of a 503 on the same URL
_NO_RETRY = {"port": RetryPolicy(max_retries=0), "jax": JaxRetryPolicy(max_retries=0)}


def _retiring(pool, old) -> None:
    """What ServingFleet.retire does, in its order: out of the pool first,
    then the drain (new requests shed with 503)."""
    pool.remove(old.url)
    old._draining = True


class TestRetiringTarget:
    @pytest.mark.parametrize("package", ["port", "jax"])
    def test_a_request_shed_by_a_retired_target_is_resent(self, servers, package):
        """The pool picks `old`, which is retired while the request is out:
        the port resends it to `new`, the JAX package returns the 503."""
        old, new = servers
        pool_cls, request_cls = ((TargetPool, HTTPRequestData) if package == "port"
                                 else (JaxPool, JaxRequest))
        pool = pool_cls([old.url, new.url])
        real = pool.pick
        picks = iter([old.url])

        def pick(strategy="round_robin", key=None, exclude=()):
            url = next(picks, None)
            if url is not None:
                _retiring(pool, old)
                return url
            return real(strategy=strategy, key=key, exclude=exclude)

        pool.pick = pick
        resp = pool.send(request_cls.from_json("/", {"x": 1}), policy=_NO_RETRY[package])
        assert old.requests_shed >= 1
        if package == "port":
            assert resp.status_code == 200
            assert json.loads(resp.entity)["served_by"] == "new"
        else:
            assert resp.status_code == 503

    def test_an_overloaded_member_still_answers_503(self, servers):
        old, new = servers
        old._draining = True            # sheds, but was never removed
        pool = TargetPool([old.url, new.url])
        pool.pick = lambda strategy="round_robin", key=None, exclude=(): old.url
        resp = pool.send(HTTPRequestData.from_json("/", {"x": 1}), policy=_NO_RETRY["port"])
        assert resp.status_code == 503
        assert old.requests_shed == 1 and new.requests_seen == 0

    def test_the_gateway_serves_through_a_retirement(self, servers):
        old, new = servers
        gw = ServingGateway(strategy="round_robin").start()
        try:
            gw.admit(old.url)
            gw.admit(new.url)
            racing = gw.pool
            real = racing.pick
            picks = iter([old.url])

            def pick(strategy="round_robin", key=None, exclude=()):
                url = next(picks, None)
                if url is not None:
                    gw.remove(url)
                    old._draining = True
                    return url
                return real(strategy=strategy, key=key, exclude=exclude)

            racing.pick = pick
            statuses = [gw.forward(HTTPRequestData.from_json("/", {"x": i})).status_code
                        for i in range(4)]
            assert statuses == [200] * 4
            assert old.requests_shed >= 1
            assert np.all([u != old.url for u in gw.pool.urls])
        finally:
            gw.stop()
