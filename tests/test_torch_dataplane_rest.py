"""The rest of the port's async data plane (mmlspark_tpu_torch/core/
dataplane.py) against the JAX package's (mmlspark_tpu/core/dataplane.py):
tests/test_dataplane.py's Lookahead cases and the process-wide
executable-cache counters, run through both packages, and the telemetry
hooks, whose series must carry the same names and values in both."""

from __future__ import annotations

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu.core import dataplane as ref_dp  # noqa: E402
from mmlspark_tpu.observability import metrics as ref_metrics  # noqa: E402
from mmlspark_tpu_torch.core import dataplane as port_dp  # noqa: E402
from mmlspark_tpu_torch.observability import metrics as port_metrics  # noqa: E402

PACKAGES = {"port": (port_dp, port_metrics), "ref": (ref_dp, ref_metrics)}


@pytest.fixture(params=sorted(PACKAGES))
def dp(request):
    return PACKAGES[request.param][0]


class TestLookahead:
    def test_matching_key_is_a_hit(self, dp):
        la = dp.Lookahead()
        la.submit("k1", lambda: 42)
        hit, val = la.take("k1")
        assert hit and val == 42 and la.hits == 1

    def test_mismatched_key_discards_the_result(self, dp):
        la = dp.Lookahead()
        la.submit("k1", lambda: 42)
        hit, val = la.take("other")
        assert not hit and val is None and la.misses == 1
        # slot consumed either way
        assert not la.take("k1")[0]

    def test_failed_read_is_a_miss_not_a_raise(self, dp):
        la = dp.Lookahead()
        la.submit("k", lambda: (_ for _ in ()).throw(IOError("flaky")))
        hit, val = la.take("k")
        assert not hit and val is None

    def test_resubmit_discards_previous_slot(self, dp):
        la = dp.Lookahead()
        la.submit("k1", lambda: 1)
        la.submit("k2", lambda: 2)
        hit, val = la.take("k2")
        assert hit and val == 2

    def test_discard_joins_the_thread(self, dp):
        la = dp.Lookahead()
        la.submit("k", lambda: time.sleep(0.01) or 5)
        la.discard()
        assert not la.pending and not la.take("k")[0]


def _cache_workload(dp) -> dict:
    """The same builds on two caches of one package: process-wide counters
    after them, from zero."""
    dp.reset_cache_stats()
    c1, c2 = dp.ExecutableCache(), dp.ExecutableCache()
    c1.get_or_build("f", (1,), lambda: 1)
    c2.get_or_build("f", (1,), lambda: 2)
    c2.get_or_build("f", (1,), lambda: 3)
    c2.get_or_build("f", (2,), lambda: 4)
    c1.get_or_build("g", (8,), lambda: 5)
    stats = dp.cache_stats()
    assert stats.pop("compile_seconds") >= 0.0
    ledger = c2.compile_ledger()
    assert [e["shape"] for e in ledger] in (["(1,)", "(2,)"], ["(2,)", "(1,)"])
    assert all(e["seconds"] >= 0.0 for e in ledger)
    return stats


class TestCacheMetrics:
    def test_global_stats_aggregate_across_caches(self, dp):
        dp.reset_cache_stats()
        c1, c2 = dp.ExecutableCache(), dp.ExecutableCache()
        c1.get_or_build("f", (1,), lambda: 1)
        c2.get_or_build("f", (1,), lambda: 2)
        c2.get_or_build("f", (1,), lambda: 3)
        g = dp.cache_stats()
        assert g["misses"] == 2 and g["hits"] == 1

    def test_reset_zeroes_every_counter(self, dp):
        dp.ExecutableCache().get_or_build("f", (1,), lambda: 1)
        dp.reset_cache_stats()
        assert dp.cache_stats() == {"hits": 0, "misses": 0, "recompiles": 0,
                                    "compile_seconds": 0}

    def test_both_packages_count_alike(self):
        assert _cache_workload(port_dp) == _cache_workload(ref_dp) == {
            "hits": 1, "misses": 4, "recompiles": 1}

    def test_family_key_adds_the_mesh_only_when_given(self, dp):
        assert dp.ExecutableCache.family_key("base") == "base"
        assert dp.ExecutableCache.family_key("base", (("data", 4),), ("x",)) == \
            ref_dp.ExecutableCache.family_key("base", (("data", 4),), ("x",))

    def test_cache_series_render_alike(self):
        """ensure_cache_metrics on a fresh registry of each package, after
        the same builds: the same series names, kinds and values."""
        texts = {}
        for name, (dp, metrics) in PACKAGES.items():
            reg = metrics.MetricsRegistry()
            _cache_workload(dp)
            dp.ensure_cache_metrics(reg)
            dp.ensure_cache_metrics(reg)              # idempotent
            lines = [ln for ln in reg.render_prometheus().splitlines()
                     if "executable_cache" in ln]
            texts[name] = lines
        assert texts["port"] == texts["ref"]
        assert "mmlspark_tpu_executable_cache_misses_total 4" in texts["port"]
        assert "mmlspark_tpu_executable_cache_recompiles_total 1" in texts["port"]


class TestTelemetryHooks:
    """The registry hooks the port's earlier copy left out: the prefetch
    queue-depth and overlap gauges and the per-rung pad-waste gauge, on the
    process registry under the JAX package's names."""

    def _gauge(self, metrics, series, **labels):
        return metrics.get_registry().gauge(series, labels=tuple(labels)).labels(**labels)

    def test_prefetch_gauges(self):
        got = {}
        for name, (dp, metrics) in PACKAGES.items():
            items = list(dp.Prefetcher(range(6), lambda i: i * i, depth=2,
                                       name="hooks-test"))
            assert items == [i * i for i in range(6)]
            got[name] = self._gauge(metrics, "mmlspark_tpu_dataplane_prefetch_queue_depth",
                                    name="hooks-test").value
            overlap = self._gauge(metrics, "mmlspark_tpu_dataplane_overlap_ratio",
                                  name="hooks-test").value
            assert 0.0 <= overlap <= 1.0
        assert got["port"] == got["ref"] == 0

    def test_pad_waste_gauge(self):
        got = {}
        for name, (dp, metrics) in PACKAGES.items():
            b = dp.ShapeBucketer(16)
            b.pad(np.zeros((3, 2)))                      # 3 real rows in rung 4
            b.note_pad(5, 8)
            got[name] = (b.pad_waste(),
                         self._gauge(metrics, "mmlspark_tpu_dataplane_pad_waste_ratio",
                                     rung="4").value,
                         self._gauge(metrics, "mmlspark_tpu_dataplane_pad_waste_ratio",
                                     rung="8").value)
        assert got["port"] == got["ref"]
        assert got["port"][1] == pytest.approx(0.25)
        assert got["port"][2] == pytest.approx(3 / 8)
