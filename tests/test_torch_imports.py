"""The port stands alone: importing every module of mmlspark_tpu_torch pulls
in neither jax, flax nor msgpack, nor any module of the JAX package
(mmlspark_tpu)."""

import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import mmlspark_tpu_torch
names = ["mmlspark_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(mmlspark_tpu_torch.__path__, "mmlspark_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "flax", "msgpack", "mmlspark_tpu"))
print(json.dumps({"modules": names, "leaked": leaked}))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for module in ("mmlspark_tpu_torch.gbdt.hist_kernel", "mmlspark_tpu_torch.gbdt.booster",
                   "mmlspark_tpu_torch.core.kernels", "mmlspark_tpu_torch.native",
                   "mmlspark_tpu_torch.automl.metrics", "mmlspark_tpu_torch.nn.attention",
                   "mmlspark_tpu_torch.nn.models", "mmlspark_tpu_torch.nn.runner",
                   "mmlspark_tpu_torch.nn.carry", "mmlspark_tpu_torch.nn.flax_blob",
                   "mmlspark_tpu_torch.nn.layers", "mmlspark_tpu_torch.nn.trainer",
                   "mmlspark_tpu_torch.nn.optim", "mmlspark_tpu_torch.core.dataplane",
                   "mmlspark_tpu_torch.observability.sanitizer",
                   "mmlspark_tpu_torch.observability.metrics",
                   "mmlspark_tpu_torch.observability.tracing",
                   "mmlspark_tpu_torch.observability.recorder",
                   "mmlspark_tpu_torch.utils.storage", "mmlspark_tpu_torch.resilience.policy",
                   "mmlspark_tpu_torch.resilience.elastic", "mmlspark_tpu_torch.parallel",
                   "mmlspark_tpu_torch.parallel.mesh", "mmlspark_tpu_torch.parallel.collectives",
                   "mmlspark_tpu_torch.parallel.launch", "mmlspark_tpu_torch.image",
                   "mmlspark_tpu_torch.image.ops", "mmlspark_tpu_torch.image.transformer",
                   "mmlspark_tpu_torch.image.unroll", "mmlspark_tpu_torch.image.augmenter",
                   "mmlspark_tpu_torch.image.io", "mmlspark_tpu_torch.nn.import_weights",
                   "mmlspark_tpu_torch.nn.zoo", "mmlspark_tpu_torch.nn.featurizer",
                   "mmlspark_tpu_torch.core.table_io", "mmlspark_tpu_torch.ops",
                   "mmlspark_tpu_torch.ops.stages", "mmlspark_tpu_torch.ops.indexer",
                   "mmlspark_tpu_torch.ops.missing", "mmlspark_tpu_torch.ops.conversion",
                   "mmlspark_tpu_torch.ops.summarize", "mmlspark_tpu_torch.ops.sample",
                   "mmlspark_tpu_torch.ops.ensemble", "mmlspark_tpu_torch.ops.adapter",
                   "mmlspark_tpu_torch.ops.featurize", "mmlspark_tpu_torch.ops.minibatch",
                   "mmlspark_tpu_torch.automl.train", "mmlspark_tpu_torch.text",
                   "mmlspark_tpu_torch.text.featurizer", "mmlspark_tpu_torch.text.page_splitter",
                   "mmlspark_tpu_torch.text.multi_ngram", "mmlspark_tpu_torch.utils.datagen",
                   "mmlspark_tpu_torch.core.fusion", "mmlspark_tpu_torch.resilience.breaker",
                   "mmlspark_tpu_torch.io_http", "mmlspark_tpu_torch.io_http.wire",
                   "mmlspark_tpu_torch.io_http.schema", "mmlspark_tpu_torch.io_http.journal",
                   "mmlspark_tpu_torch.io_http.serving", "mmlspark_tpu_torch.utils.async_utils",
                   "mmlspark_tpu_torch.observability.fleet",
                   "mmlspark_tpu_torch.observability.slo",
                   "mmlspark_tpu_torch.observability.timeline",
                   "mmlspark_tpu_torch.resilience.chaos", "mmlspark_tpu_torch.io_http.clients",
                   "mmlspark_tpu_torch.io_http.forwarding", "mmlspark_tpu_torch.io_http.gateway",
                   "mmlspark_tpu_torch.io_http.autoscale",
                   "mmlspark_tpu_torch.io_http.consolidator",
                   "mmlspark_tpu_torch.io_http.transformer",
                   "mmlspark_tpu_torch.io_http.cognitive", "mmlspark_tpu_torch.io_http.search",
                   "mmlspark_tpu_torch.io_http.powerbi",
                   "mmlspark_tpu_torch.utils.profiling",
                   "mmlspark_tpu_torch.observability.profiler",
                   "mmlspark_tpu_torch.observability.stage", "mmlspark_tpu_torch.plot",
                   "mmlspark_tpu_torch.streaming", "mmlspark_tpu_torch.streaming.checkpoint",
                   "mmlspark_tpu_torch.streaming.sources", "mmlspark_tpu_torch.streaming.sinks",
                   "mmlspark_tpu_torch.streaming.state", "mmlspark_tpu_torch.streaming.query",
                   "mmlspark_tpu_torch.streaming.shuffle", "mmlspark_tpu_torch.streaming.joins",
                   "mmlspark_tpu_torch.streaming.partition",
                   "mmlspark_tpu_torch.parallel.dp",
                   "mmlspark_tpu_torch.resilience.elastic_fleet",
                   "mmlspark_tpu_torch.parallel.ring_attention",
                   "mmlspark_tpu_torch.parallel.tensor_parallel",
                   "mmlspark_tpu_torch.parallel.pipeline_parallel",
                   "mmlspark_tpu_torch.parallel.moe"):
        assert module in out["modules"]
    assert out["leaked"] == [], f"the port pulled in: {out['leaked']}"
