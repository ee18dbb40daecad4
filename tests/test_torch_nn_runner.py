"""DeepModelTransformer, ModelBundle files and the flax blob, held against
the JAX package.

The same bundle serves through the JAX stage and the port's stage (on
device="cpu", where attention_impl="flash" runs the plain version of K2)
at atol 5e-5, rtol 1e-4 (tests/test_attention.py:159). Bundle files and
saved stages cross between the packages in both directions; the blob
codec is held against flax.serialization byte for byte.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import flax.serialization as flax_ser  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmlspark_tpu.core.schema import Table as JaxTable  # noqa: E402
from mmlspark_tpu.core.serialize import save_stage as jax_save_stage  # noqa: E402
from mmlspark_tpu.nn.models import ModelBundle as JaxBundle  # noqa: E402
from mmlspark_tpu.nn.runner import DeepModelTransformer as JaxRunner  # noqa: E402
from mmlspark_tpu.utils.datagen import digits_to_images, load_label_csv  # noqa: E402
from mmlspark_tpu_torch.core import Table  # noqa: E402
from mmlspark_tpu_torch.core.serialize import load_stage, save_stage  # noqa: E402
from mmlspark_tpu_torch.nn import DeepModelTransformer, ModelBundle  # noqa: E402
from mmlspark_tpu_torch.nn import flax_blob  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO_RESNET = os.path.join(REPO, "model_zoo", "resnet20_digits.model")
ATOL, RTOL = 5e-5, 1e-4
KW = dict(num_layers=2, d_model=32, num_heads=4, d_ff=64, vocab_size=300,
          num_outputs=3, max_len=16, attention_impl="flash")
FETCH = {"l": "logits", "p": "probability", "f": "pooled_features", "a": "attn_0"}


@pytest.fixture(scope="module")
def bundles():
    jb = JaxBundle.init("transformer", (10,), seed=0, **KW)
    port = ModelBundle(architecture="transformer", config=dict(KW),
                       variables=jax.tree.map(np.asarray, jb.variables),
                       input_shape=(10,))
    return jb, port


def _tokens(n, seed=0):
    return np.random.default_rng(seed).integers(0, 300, size=(n, 10))


def _port_runner(bundle, **kw):
    return DeepModelTransformer(input_col="x", device="cpu", **kw).set_model(bundle)


@pytest.mark.parametrize("bs", [8, 64])
def test_runner_matches_jax_stage(bundles, bs):
    jb, port = bundles
    x = _tokens(37)                          # ragged against both batch sizes
    ref = JaxRunner(input_col="x", fetch_dict=FETCH, mini_batch_size=bs) \
        .set_model(jb).transform(JaxTable({"x": x}))
    got = _port_runner(port, fetch_dict=FETCH, mini_batch_size=bs).transform(Table({"x": x}))
    for col in FETCH:
        assert np.asarray(got[col]).dtype == np.float32
        np.testing.assert_allclose(np.asarray(got[col]), np.asarray(ref[col]),
                                   atol=ATOL, rtol=RTOL, err_msg=col)
    np.testing.assert_allclose(np.asarray(got["p"]).sum(-1), 1.0, rtol=1e-6)


def test_fused_pipelined_and_every_prefetch_depth_agree(bundles):
    _, port = bundles
    x = _tokens(45, seed=1)
    outs = {}
    for fused in (True, False):
        for depth in (0, 2):
            t = _port_runner(port, fetch_dict=FETCH, mini_batch_size=16,
                             fused_dispatch=fused, prefetch_depth=depth,
                             shape_buckets=False)
            outs[(fused, depth)] = t.transform(Table({"x": x}))
    base = outs[(True, 0)]
    for key, got in outs.items():
        for col in FETCH:
            assert np.array_equal(np.asarray(got[col]), np.asarray(base[col])), (key, col)
    # bucketed tails (45 = 16 + 16 + 13 -> a 16-row bucket) keep every row
    t = _port_runner(port, fetch_dict={"l": "logits"}, mini_batch_size=16,
                     fused_dispatch=False, prefetch_depth=2)
    got = t.transform(Table({"x": x}))
    np.testing.assert_allclose(np.asarray(got["l"]), np.asarray(base["l"]), atol=1e-6)
    assert t.last_pipeline_stats["items"] == 3
    assert t.last_pipeline_stats["bucket_ladder"] == [1, 2, 4, 8, 16]


def test_fused_budget_sends_large_tables_down_the_pipelined_path(bundles):
    _, port = bundles
    x = _tokens(20, seed=2)
    t = _port_runner(port, fetch_dict={"l": "logits"}, mini_batch_size=8,
                     fused_dispatch_budget_mb=0)
    got = t.transform(Table({"x": x}))
    assert t.last_pipeline_stats is not None and t.last_pipeline_stats["items"] == 3
    ref = _port_runner(port, fetch_dict={"l": "logits"}, mini_batch_size=8).transform(
        Table({"x": x}))
    assert np.array_equal(np.asarray(got["l"]), np.asarray(ref["l"]))


def test_bf16_token_rounding_mirrors_jax(bundles):
    # DeepModelTransformer(bfloat16=True) rounds the token ids to bf16
    # before the embedding: 257 -> 256 (in the table), 299 -> 300 (past
    # the 300-row table: jnp.take's fill gives NaN rows, and so does the port)
    jb, port = bundles
    x = np.array([[257] * 10, [299] * 10, list(range(10))])
    ref = JaxRunner(input_col="x", fetch_dict={"l": "logits"}, bfloat16=True) \
        .set_model(jb).transform(JaxTable({"x": x}))
    got = _port_runner(port, fetch_dict={"l": "logits"}, bfloat16=True).transform(
        Table({"x": x}))
    ref_l, got_l = np.asarray(ref["l"]), np.asarray(got["l"])
    assert np.array_equal(np.isnan(got_l), np.isnan(ref_l))
    assert np.isnan(got_l[1]).all() and np.isfinite(got_l[[0, 2]]).all()
    # bf16 weights and activations: the reference's bf16 gate (test_attention.py:117)
    np.testing.assert_allclose(got_l[[0, 2]], ref_l[[0, 2]], atol=3e-2, rtol=3e-2)


def test_bundle_files_cross_both_ways(bundles, tmp_path):
    jb, _ = bundles
    x = _tokens(5, seed=3)
    jax_path, port_path = str(tmp_path / "jax.model"), str(tmp_path / "port.model")
    jb.save(jax_path)
    loaded = ModelBundle.load(jax_path)
    assert loaded.config == jb.config and loaded.input_shape == jb.input_shape
    ref = np.asarray(jb.module.apply(jb.variables, jnp.asarray(x)))
    with torch.no_grad():
        got = loaded.module(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    # the port writes the same bytes back, and the JAX package reads them
    loaded.save(port_path)
    with open(jax_path, "rb") as a, open(port_path, "rb") as b:
        assert a.read() == b.read()
    port_init = ModelBundle.init("transformer", (10,), seed=7, **KW)
    port_init.save(port_path)
    back = JaxBundle.load(port_path)
    with torch.no_grad():
        want = port_init.module(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(np.asarray(back.module.apply(back.variables, jnp.asarray(x))),
                               want, atol=ATOL, rtol=RTOL)


def test_jax_saved_stage_loads_and_serves(bundles, tmp_path):
    jb, port = bundles
    x = _tokens(12, seed=4)
    jax_stage = JaxRunner(input_col="x", fetch_dict={"l": "logits"}, mini_batch_size=4) \
        .set_model(jb)
    jax_save_stage(jax_stage, str(tmp_path / "jax_stage"))
    stage = load_stage(str(tmp_path / "jax_stage"))
    assert isinstance(stage, DeepModelTransformer)
    assert stage.get("mini_batch_size") == 4 and stage.get("device") == "cuda"
    got = stage.set(device="cpu").transform(Table({"x": x}))
    ref = jax_stage.transform(JaxTable({"x": x}))
    np.testing.assert_allclose(np.asarray(got["l"]), np.asarray(ref["l"]), atol=ATOL, rtol=RTOL)
    # and the port's own round trip gives the same bits
    save_stage(stage, str(tmp_path / "port_stage"))
    again = load_stage(str(tmp_path / "port_stage")).transform(Table({"x": x}))
    assert again is not None and np.array_equal(np.asarray(again["l"]), np.asarray(got["l"]))


def test_zoo_resnet20_digits_gives_jax_logits():
    x, _ = load_label_csv(os.path.join(REPO, "tests", "benchmarks", "data", "digits.csv"))
    img = digits_to_images(x[:40])
    jb = JaxBundle.load(ZOO_RESNET)
    fetch = {"l": "logits", "f": "pooled_features", "b": "stage1_block0.proj_bn"}
    ref = JaxRunner(input_col="img", fetch_dict=fetch, mini_batch_size=16) \
        .set_model(jb).transform(JaxTable({"img": img}))
    port = ModelBundle.load(ZOO_RESNET)
    got = DeepModelTransformer(input_col="img", fetch_dict=fetch, mini_batch_size=16,
                               device="cpu").set_model(port).transform(Table({"img": img}))
    for col in fetch:
        np.testing.assert_allclose(np.asarray(got[col]), np.asarray(ref[col]),
                                   atol=ATOL, rtol=RTOL, err_msg=col)


def test_stage_refusals(bundles):
    _, port = bundles
    # use_mesh serves over get_mesh()'s data axis: one shard outside
    # torch.distributed, the transform without a mesh (several ranks:
    # tests/test_torch_parallel_p4.py). The fused tensor-parallel forward
    # (mesh_fn) takes only an f32 MLP on a model axis of several ranks:
    # None without a mesh, off a model axis, and for this transformer
    on_mesh = _port_runner(port, use_mesh=True).transform(Table({"x": _tokens(2)}))
    plain = _port_runner(port).transform(Table({"x": _tokens(2)}))
    for col in plain.columns:
        np.testing.assert_array_equal(np.asarray(on_mesh[col]), np.asarray(plain[col]))
    from mmlspark_tpu_torch.parallel.mesh import Mesh

    grid = Mesh((0, 1, 2, 3), axis_names=("data", "model"), axis_sizes=(2, 2))
    mesh_fn = _port_runner(port, use_mesh=True).device_kernel().mesh_fn
    assert mesh_fn(None) is None and mesh_fn(Mesh((0, 1))) is None and mesh_fn(grid) is None
    # an MLP on that model axis gets the column-parallel body (outside a
    # process group the axis through this rank is the rank alone, so its
    # block is every column), marked to run eagerly, equal to the forward
    mlp = ModelBundle.init("mlp", (6,), seed=0, num_outputs=4, features=(8, 4))
    stage = DeepModelTransformer(input_col="x", device="cpu",
                                 fetch_dict={"l": "logits", "p": "probability"}).set_model(mlp)
    kernel = stage.device_kernel()
    assert kernel.mesh_fn(Mesh((0, 1))) is None
    body, params = kernel.mesh_fn(grid)
    assert body.collectives and [w.shape for w, _ in params["layers"]] == [(6, 8), (8, 4), (4, 4)]
    x = torch.as_tensor(np.random.default_rng(1).normal(size=(5, 6)).astype(np.float32))
    with torch.no_grad():                   # as a fused segment runs them
        want = kernel.fn(kernel.params, {"x": x})
        got = body(params, {"x": x})
    for col in ("l", "p"):
        np.testing.assert_allclose(got[col].numpy(), want[col].numpy(), atol=2e-4, rtol=2e-4)
    bf16 = DeepModelTransformer(input_col="x", device="cpu", bfloat16=True).set_model(mlp)
    assert bf16.device_kernel().mesh_fn(grid) is None
    with pytest.raises(ValueError, match="no model"):
        DeepModelTransformer(input_col="x", device="cpu").transform(Table({"x": _tokens(2)}))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            DeepModelTransformer(input_col="x").set_model(port).transform(
                Table({"x": _tokens(2)}))


def test_flax_blob_matches_flax_serialization(monkeypatch):
    rng = np.random.default_rng(5)
    tree = {"params": {"dense_0": {"kernel": rng.normal(size=(300, 70)).astype(np.float32),
                                   "bias": np.zeros(70, np.float32)},
                       "pos": rng.integers(-5, 5, size=(4, 3)).astype(np.int64)},
            "meta": {"step": np.int32(7), "scale": np.float32(0.5), "flag": True,
                     "lr": 1e-3, "n": 70000, "neg": -200, "name": "x" * 40,
                     "none": None, "empty": np.zeros((0, 3), np.uint8)},
            "list": [np.ones(2), np.ones(3, np.uint8)]}
    blob = flax_ser.to_bytes(tree)
    assert flax_blob.to_bytes(tree) == blob
    back = flax_blob.from_bytes(blob)
    ref = flax_ser.msgpack_restore(blob)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    assert all(jax.tree.leaves(jax.tree.map(
        lambda a, b: np.array_equal(np.asarray(a), np.asarray(b)) and
        np.asarray(a).dtype == np.asarray(b).dtype, back, ref)))
    # flax's chunked form of arrays over MAX_CHUNK_SIZE bytes, both ways
    monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", 256)
    monkeypatch.setattr(flax_blob, "MAX_CHUNK_SIZE", 256)
    big = {"w": rng.normal(size=(30, 10)).astype(np.float32), "b": np.ones(3, np.float32)}
    assert flax_blob.to_bytes(big) == flax_ser.to_bytes(big)
    assert np.array_equal(flax_blob.from_bytes(flax_ser.to_bytes(big))["w"], big["w"])
    assert np.array_equal(flax_ser.msgpack_restore(flax_blob.to_bytes(big))["w"], big["w"])
    # bfloat16 leaves read into torch.bfloat16 and write back the same bytes
    bf = {"x": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3)}
    blob = flax_ser.to_bytes(bf)
    got = flax_blob.from_bytes(blob)["x"]
    assert got.dtype == torch.bfloat16 and got.float().tolist() == [[0, 1, 2], [3, 4, 5]]
    assert flax_blob.to_bytes({"x": got}) == blob
    with pytest.raises(ValueError, match="truncated"):
        flax_blob.from_bytes(blob[:-3])
