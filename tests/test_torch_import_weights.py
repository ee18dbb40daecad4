"""The port's weight importers (mmlspark_tpu_torch/nn/import_weights.py)
on tests/test_import_weights.py's seeded checkpoints.

The reference's mapping and error cases run on the port; the port's
mappers equal the JAX package's leaf for leaf, bit for bit; the imported
ResNet-50 and encoder reproduce the committed activations
(tests/fixtures/imported_{resnet50,transformer}_logits.json, the JAX
package's) on the CPU at the reference's gate, rtol 2e-3 and atol 2e-4.
The two importers are held against each other end to end in
tests/test_torch_import_weights_parity.py.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu.nn import import_weights as jiw  # noqa: E402
from mmlspark_tpu_torch.core import Table  # noqa: E402
from mmlspark_tpu_torch.nn import DeepModelTransformer, import_weights as iw  # noqa: E402
from mmlspark_tpu_torch.nn.carry import module_variables  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


def _load_reference_tests():
    """tests/test_import_weights.py's manifests and seeded state dicts (it
    imports only json, os, numpy and pytest at module level)."""
    spec = importlib.util.spec_from_file_location(
        "reference_import_weights_tests", os.path.join(HERE, "test_import_weights.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load_reference_tests()
T_HEADS, T_VOCAB, T_OUT = REF.T_HEADS, REF.T_VOCAB, REF.T_OUT


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


def _assert_trees_equal(got, want):
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=str(k))


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    path = os.path.join(tmp_path_factory.mktemp("weights"), "resnet50.npz")
    np.savez(path, **REF.synthetic_state_dict())
    return iw.import_torch_resnet(path, input_shape=(64, 64, 3))


@pytest.fixture(scope="module")
def tbundle(tmp_path_factory):
    path = os.path.join(tmp_path_factory.mktemp("tweights"), "encoder.npz")
    np.savez(path, **REF.synthetic_transformer_state_dict())
    return iw.import_torch_transformer(path, num_heads=T_HEADS)


class TestMapping:
    def test_all_leaves_mapped_and_shapes_fit(self, bundle):
        assert bundle.config["num_outputs"] == 1000
        p = bundle.variables["params"]
        assert p["stem_conv"]["kernel"].shape == (7, 7, 3, 64)
        assert p["stage0_block0"]["proj_conv"]["kernel"].shape == (1, 1, 64, 256)
        assert p["head"]["kernel"].shape == (2048, 1000)
        bs = bundle.variables["batch_stats"]
        assert bs["stage3_block2"]["bn3"]["var"].shape == (2048,)
        assert all(v.dtype == np.float32 for v in _leaves(bundle.variables).values())

    def test_conv_transpose_is_oihw_to_hwio(self):
        sd = REF.synthetic_state_dict()
        v = iw.torch_resnet_to_flax(sd)
        w = sd["layer2.0.conv2.weight"]
        k = v["params"]["stage1_block0"]["conv2"]["kernel"]
        assert k.shape == (3, 3, 128, 128)
        np.testing.assert_array_equal(k[1, 2, 5, 7], w[7, 5, 1, 2])

    def test_fc_transposed(self):
        sd = REF.synthetic_state_dict()
        v = iw.torch_resnet_to_flax(sd)
        np.testing.assert_array_equal(v["params"]["head"]["kernel"], sd["fc.weight"].T)

    def test_unknown_key_raises(self):
        with pytest.raises(ValueError, match="unrecognized"):
            iw.torch_resnet_to_flax({"classifier.weight": np.zeros((10, 10))})

    def test_missing_block_raises(self, tmp_path):
        sd = REF.synthetic_state_dict()
        sd.pop("layer3.4.conv2.weight")
        path = os.path.join(tmp_path, "broken.npz")
        np.savez(path, **sd)
        with pytest.raises(ValueError, match="missing"):
            iw.import_torch_resnet(path, input_shape=(64, 64, 3))

    def test_untransposed_conv_raises(self, tmp_path):
        sd = REF.synthetic_state_dict()
        sd["conv1.weight"] = np.transpose(sd["conv1.weight"], (2, 3, 1, 0))
        path = os.path.join(tmp_path, "hwio.npz")
        np.savez(path, **sd)
        with pytest.raises(ValueError, match="shape mismatch"):
            iw.import_torch_resnet(path, input_shape=(64, 64, 3))

    def test_unexpected_leaf_raises(self, tmp_path):
        sd = REF.synthetic_state_dict()
        sd["layer4.3.conv1.weight"] = np.zeros((512, 2048, 1, 1), np.float32)
        path = os.path.join(tmp_path, "extra.npz")
        np.savez(path, **sd)
        with pytest.raises(ValueError, match="imported weights do not fit resnet50: unexpected"):
            iw.import_torch_resnet(path, input_shape=(64, 64, 3))


@pytest.mark.parametrize("family", ["resnet50", "transformer"])
def test_mappers_equal_the_jax_package_bit_for_bit(family):
    if family == "resnet50":
        sd = REF.synthetic_state_dict()
        got, want = iw.torch_resnet_to_flax(sd), jiw.torch_resnet_to_flax(sd)
    else:
        sd = REF.synthetic_transformer_state_dict()
        got = iw.torch_transformer_to_flax(sd, num_heads=T_HEADS)
        want = jiw.torch_transformer_to_flax(sd, num_heads=T_HEADS)
    _assert_trees_equal(got, want)


class TestActivations:
    def test_forward_matches_committed_fixture(self, bundle):
        rng = np.random.default_rng(42)
        x = rng.integers(0, 256, size=(2, 64, 64, 3)).astype(np.float32)
        stage = DeepModelTransformer(input_col="x", device="cpu", mini_batch_size=2,
                                     fetch_dict={"l": "logits"}).set_model(bundle)
        logits = np.asarray(stage.transform(Table({"x": x}))["l"])
        assert logits.shape == (2, 1000) and np.isfinite(logits).all()
        with open(os.path.join(HERE, "fixtures", "imported_resnet50_logits.json")) as fh:
            want = np.asarray(json.load(fh)["logits_2x8"])
        np.testing.assert_allclose(logits[:, :8], want, rtol=2e-3, atol=2e-4)

    def test_module_is_built_from_the_imported_weights(self, bundle):
        """The module serves the imported tree, not init's random draws."""
        _assert_trees_equal(module_variables(bundle.module), bundle.variables)


class TestTransformerImport:
    def test_dims_inferred_from_checkpoint(self, tbundle):
        cfg = tbundle.config
        assert (cfg["vocab_size"], cfg["d_model"], cfg["num_layers"], cfg["d_ff"],
                cfg["max_len"], cfg["num_outputs"], cfg["num_heads"]) == \
            (T_VOCAB, REF.T_DMODEL, REF.T_LAYERS, REF.T_DFF, REF.T_MAXLEN, T_OUT, T_HEADS)

    def test_num_heads_defaults_to_four(self, tmp_path):
        path = os.path.join(tmp_path, "enc.npz")
        np.savez(path, **REF.synthetic_transformer_state_dict())
        assert iw.import_torch_transformer(path).config["num_heads"] == 4

    def test_qkv_reshape_layout(self):
        sd = REF.synthetic_transformer_state_dict()
        v = iw.torch_transformer_to_flax(sd, num_heads=T_HEADS)
        w = sd["encoder.layer.0.attention.self.query.weight"]
        k = v["params"]["attn_0"]["query"]["kernel"]
        dh = REF.T_DMODEL // T_HEADS
        assert k.shape == (REF.T_DMODEL, T_HEADS, dh)
        np.testing.assert_array_equal(k[3, 2, 1], w[2 * dh + 1, 3])
        out_k = v["params"]["attn_0"]["out"]["kernel"]
        assert out_k.shape == (T_HEADS, dh, REF.T_DMODEL)
        wo = sd["encoder.layer.0.attention.output.dense.weight"]
        np.testing.assert_array_equal(out_k[2, 1, 5], wo[5, 2 * dh + 1])

    def test_unknown_key_raises(self):
        sd = REF.synthetic_transformer_state_dict()
        sd["pooler.dense.weight"] = np.zeros((4, 4), np.float32)
        with pytest.raises(ValueError, match="unrecognized"):
            iw.torch_transformer_to_flax(sd, num_heads=T_HEADS)

    def test_missing_layer_raises(self, tmp_path):
        sd = REF.synthetic_transformer_state_dict()
        sd.pop("encoder.layer.1.mlp.ln.weight")
        path = os.path.join(tmp_path, "broken.npz")
        np.savez(path, **sd)
        with pytest.raises(ValueError, match="missing"):
            iw.import_torch_transformer(path, num_heads=T_HEADS)

    def test_bad_head_count_raises(self, tmp_path):
        path = os.path.join(tmp_path, "enc.npz")
        np.savez(path, **REF.synthetic_transformer_state_dict())
        with pytest.raises(ValueError, match="num_heads"):
            iw.import_torch_transformer(path, num_heads=5)

    def test_not_an_encoder_raises(self, tmp_path):
        path = os.path.join(tmp_path, "other.npz")
        np.savez(path, **{"fc.weight": np.zeros((2, 2), np.float32)})
        with pytest.raises(ValueError, match="neither"):
            iw.import_torch_transformer(path)

    @pytest.mark.parametrize("impl", ["dense", "flash"])
    def test_forward_matches_committed_fixture(self, tbundle, impl):
        """attention_impl="flash" runs K2's plain version on the CPU."""
        from mmlspark_tpu_torch.nn import ModelBundle

        b = ModelBundle(architecture=tbundle.architecture,
                        config={**tbundle.config, "attention_impl": impl},
                        variables=tbundle.variables, input_shape=tbundle.input_shape)
        tokens = np.arange(2 * 12).reshape(2, 12) % T_VOCAB
        with torch.no_grad():
            logits = b.module(torch.from_numpy(tokens.astype(np.int32))).numpy()
        assert logits.shape == (2, T_OUT) and np.isfinite(logits).all()
        with open(os.path.join(HERE, "fixtures", "imported_transformer_logits.json")) as fh:
            want = np.asarray(json.load(fh)["logits_2x3"])
        np.testing.assert_allclose(logits, want, rtol=2e-3, atol=2e-4)


def test_load_state_dict_npz_and_safetensors_agree(tmp_path):
    from safetensors.numpy import save_file

    sd = REF.synthetic_transformer_state_dict()
    np.savez(tmp_path / "enc.npz", **sd)
    save_file(sd, str(tmp_path / "enc.safetensors"))
    a = iw.load_state_dict(str(tmp_path / "enc.npz"))
    b = iw.load_state_dict(str(tmp_path / "enc.safetensors"))
    assert sorted(a) == sorted(b) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(a[k], sd[k])
        np.testing.assert_array_equal(b[k], sd[k])
    with pytest.raises(ValueError, match="unsupported weight format"):
        iw.load_state_dict(str(tmp_path / "enc.pt"))


def test_unregistered_architecture_raises():
    with pytest.raises(ValueError, match="no weight importer registered"):
        iw.import_external_weights("x.npz", architecture="mlp")
    assert sorted(iw.IMPORTERS) == sorted(jiw.IMPORTERS)
