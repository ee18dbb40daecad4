"""The port's importers against the JAX package's, end to end: the same
checkpoint file imports to the same bundle config and, leaf for leaf, the
same float32 variables, bit for bit. One `.npz` (tests/test_import_weights.py's
tiny encoder) and one `.safetensors` (a two-stage basic-block ResNet in
torchvision's naming, through the generic "resnet" architecture; the JAX
package's init of ResNet-50 takes ~20 s on the CPU, of ResNet-20 ~12 s).
"""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from mmlspark_tpu.nn import import_weights as jiw  # noqa: E402
from mmlspark_tpu_torch.nn import import_weights as iw  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "reference_import_weights_tests", os.path.join(HERE, "test_import_weights.py"))
REF = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(REF)


def basic_resnet_state_dict(stages=(8, 16), seed: int = 3) -> "dict[str, np.ndarray]":
    """A torchvision-named state dict of a basic-block ResNet with one block
    a stage at `stages` filters (a 1x1 downsample where a stage widens), a
    3x3 stem and 10 outputs."""
    rng = np.random.default_rng(seed)
    sd: dict[str, np.ndarray] = {}

    def bn(prefix, width):
        sd[f"{prefix}.weight"] = (1 + 0.1 * rng.standard_normal(width)).astype(np.float32)
        sd[f"{prefix}.bias"] = (0.1 * rng.standard_normal(width)).astype(np.float32)
        sd[f"{prefix}.running_mean"] = (0.1 * rng.standard_normal(width)).astype(np.float32)
        sd[f"{prefix}.running_var"] = (0.5 + np.abs(rng.standard_normal(width))).astype(
            np.float32)
        sd[f"{prefix}.num_batches_tracked"] = np.asarray(7, np.int64)

    def conv(name, shape):
        sd[name] = (rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))).astype(np.float32)

    inplanes = stages[0]
    conv("conv1.weight", (inplanes, 3, 3, 3))
    bn("bn1", inplanes)
    for li, planes in enumerate(stages, start=1):
        p = f"layer{li}.0"
        conv(f"{p}.conv1.weight", (planes, inplanes, 3, 3))
        bn(f"{p}.bn1", planes)
        conv(f"{p}.conv2.weight", (planes, planes, 3, 3))
        bn(f"{p}.bn2", planes)
        if planes != inplanes:
            conv(f"{p}.downsample.0.weight", (planes, inplanes, 1, 1))
            bn(f"{p}.downsample.1", planes)
        inplanes = planes
    sd["fc.weight"] = (0.1 * rng.standard_normal((10, inplanes))).astype(np.float32)
    sd["fc.bias"] = (0.1 * rng.standard_normal(10)).astype(np.float32)
    return sd


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


def _assert_same_bundle(port, ref):
    assert port.architecture == ref.architecture
    assert port.config == ref.config
    assert tuple(port.input_shape) == tuple(ref.input_shape)
    assert port.preprocess == ref.preprocess and port.class_labels == ref.class_labels
    got = _leaves(port.variables)
    want = _leaves(jax.tree.map(np.asarray, ref.variables))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype == np.float32, k
        np.testing.assert_array_equal(got[k], w, err_msg=str(k))


def test_encoder_npz_imports_to_the_reference_variables(tmp_path):
    path = str(tmp_path / "encoder.npz")
    np.savez(path, **REF.synthetic_transformer_state_dict())
    kw = dict(num_heads=REF.T_HEADS, class_labels=["a", "b", "c"])
    _assert_same_bundle(iw.import_torch_transformer(path, **kw),
                        jiw.import_torch_transformer(path, **kw))


def test_resnet_safetensors_imports_to_the_reference_variables(tmp_path):
    from safetensors.numpy import save_file

    path = str(tmp_path / "resnet.safetensors")
    save_file(basic_resnet_state_dict(), path)
    kw = dict(architecture="resnet", input_shape=(8, 8, 3), stage_sizes=(1, 1),
              num_filters=8)
    port = iw.import_external_weights(path, **kw)
    _assert_same_bundle(port, jiw.import_external_weights(path, **kw))
    assert port.config["num_outputs"] == 10
