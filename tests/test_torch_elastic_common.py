"""Shared harness of the port's elastic-fleet tests: an in-process fleet
speaking the real worker protocol (`_LocalFleet` of
tests/test_elastic_fleet.py, over the port's handler, Table and request
types), the post function over it, the reference tests' fits and data."""

import json

import numpy as np

from mmlspark_tpu_torch.core.schema import Table
from mmlspark_tpu_torch.io_http.schema import HTTPRequestData
from mmlspark_tpu_torch.resilience.elastic_fleet import (ElasticDNNFit, ElasticGBDTFit,
                                                         ElasticWorkerFactory)


class LocalFleet:
    """Handler-per-URL stand-in for ServingFleet: the full driver
    protocol (configure/grad/hist/split/...) with zero processes."""

    def __init__(self, checkpoint_dir, factory=ElasticWorkerFactory):
        self.checkpoint_dir = checkpoint_dir
        self.factory = factory
        self.handlers = {}
        self._n = 0

    def add(self):
        url = f"http://local/{self._n:03d}"
        self._n += 1
        self.handlers[url] = self.factory(self.checkpoint_dir, guard=False)()
        return url

    def remove_first(self):
        del self.handlers[sorted(self.handlers)[0]]

    urls = property(lambda self: list(self.handlers))
    n_live = property(lambda self: len(self.handlers))

    def watch(self, cb):
        pass

    def dump_all(self, trigger=""):
        return 0

    def stop(self):
        pass


def post_fn(fleet, request_type=HTTPRequestData, table_type=Table):
    def post(url, body):
        handler = fleet.handlers.get(url)
        if handler is None:
            raise RuntimeError("dead member")
        out = handler(table_type({"request": [request_type.from_json("/", body)]}))
        rep = out["reply"][0]
        doc = json.loads(bytes(rep.entity).decode("utf-8"))
        if rep.status_code != 200:
            raise RuntimeError(doc.get("error", "handler error"))
        return doc
    return post


def raw_post(handler, body, table_type=Table, request_type=HTTPRequestData):
    """(status_code, doc) — for protocol tests that want the 500s too."""
    out = handler(table_type({"request": [request_type.from_json("/", body)]}))
    rep = out["reply"][0]
    return rep.status_code, json.loads(bytes(rep.entity).decode("utf-8"))


GBDT_KW = dict(objective="regression", num_leaves=7, max_bin=15, min_data_in_leaf=1, seed=0)
DNN_KW = dict(architecture="mlp", model_config={"features": [8]}, loss="softmax_ce",
              learning_rate=0.05, batch_size=8, seed=0)


def gbdt_fit(d, x, y, n_workers, *, num_virtual=8, iters=5, hook=None, metrics=None,
             checkpoint_every_n=0, barrier_hook=None, **kw):
    fleet = LocalFleet(d)
    fit = ElasticGBDTFit(d, num_iterations=iters, n_workers=n_workers,
                         num_virtual=num_virtual, fleet=fleet, post=post_fn(fleet),
                         step_hook=hook, barrier_hook=barrier_hook, metrics=metrics,
                         checkpoint_every_n=checkpoint_every_n, device="cpu",
                         **{**GBDT_KW, **kw})
    for _ in range(n_workers):
        fleet.add()
    booster = fit.fit(x, y)
    return fit, booster


def dnn_fit(d, x, y, n_workers, *, num_virtual=8, epochs=2, hook=None, **kw):
    fleet = LocalFleet(d)
    fit = ElasticDNNFit(d, epochs=epochs, n_workers=n_workers, num_virtual=num_virtual,
                        fleet=fleet, post=post_fn(fleet), step_hook=hook,
                        **{"device": "cpu", **DNN_KW, **kw})
    for _ in range(n_workers):
        fleet.add()
    bundle = fit.fit(x, y)
    return fit, bundle


def reg_data(n=96, f=4, seed=11):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    y = x[:, 0] * 2.0 - x[:, 1] + 0.05 * rng.normal(size=n)
    return x, y


def cls_data(n=48, f=4, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = (x[:, 0] + x[:, 1] > 0).astype(np.int64)
    return x, y


def kill_add_hook(kill_at, add_at):
    """The reference tests' chaos: drop the first member at the
    `kill_at`-th step boundary, add one at the `add_at`-th."""
    calls = {"n": 0}

    def hook(fit):
        calls["n"] += 1
        if calls["n"] == kill_at:
            fit.fleet.remove_first()
        elif calls["n"] == add_at:
            fit.fleet.add()
    return hook
