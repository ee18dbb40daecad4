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
                   "mmlspark_tpu_torch.nn.layers", "mmlspark_tpu_torch.core.dataplane"):
        assert module in out["modules"]
    assert out["leaked"] == [], f"the port pulled in: {out['leaked']}"
