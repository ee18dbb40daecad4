"""The port's image stages (mmlspark_tpu_torch/image/) on the CPU:
tests/test_image.py's cases (reference suites ImageTransformerSuite,
UnrollImageSuite, BinaryFileReaderSuite, ImageSetAugmenterSuite) run on the
port, and op chains held against the JAX package's `ImageTransformer` on
uniform NHWC batches and on ragged lists of images, at the ops'
tolerances (tests/test_torch_image_ops.py: 5e-3 on 0-255 where a resize
runs, 1e-4 otherwise). A stage the JAX package saved loads and runs in
the port.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu.core.schema import Table as JaxTable  # noqa: E402
from mmlspark_tpu.image import ImageTransformer as JaxImageTransformer  # noqa: E402
from mmlspark_tpu_torch.core import Table  # noqa: E402
from mmlspark_tpu_torch.core.schema import IMAGE_SPEC  # noqa: E402
from mmlspark_tpu_torch.image import (  # noqa: E402
    ImageSetAugmenter,
    ImageTransformer,
    ResizeImageTransformer,
    UnrollBinaryImage,
    UnrollImage,
    read_binary_files,
    read_images,
    write_binary_files,
)
from mmlspark_tpu_torch.image.io import decode_image, encode_image  # noqa: E402

CPU = dict(device="cpu")


def image_batch(n=4, h=16, w=16, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(n, h, w, 3)).astype(np.uint8)


class TestImageTransformer:
    def test_resize(self):
        out = ImageTransformer(**CPU).resize(8, 8).transform(Table({"image": image_batch()}))
        assert np.asarray(out["image_out"]).shape == (4, 8, 8, 3)
        assert out.meta("image_out")[IMAGE_SPEC] == {"height": 8, "width": 8, "channels": 3}

    def test_chain_resize_gray_blur(self):
        t = ImageTransformer(**CPU).resize(8, 8).gray().blur(3, 3)
        arr = np.asarray(t.transform(Table({"image": image_batch()}))["image_out"])
        assert arr.shape == (4, 8, 8, 1) and arr.dtype == np.float32

    def test_crop(self):
        x = image_batch(h=16, w=16)
        t = ImageTransformer(**CPU).crop(x=2, y=4, height=8, width=6)
        arr = np.asarray(t.transform(Table({"image": x}))["image_out"])
        assert arr.shape == (4, 8, 6, 3)
        np.testing.assert_allclose(arr[0], x[0, 4:12, 2:8, :].astype(np.float32))

    def test_flip_matches_numpy(self):
        x = image_batch()
        out = ImageTransformer(**CPU).flip(1).transform(Table({"image": x}))
        np.testing.assert_allclose(np.asarray(out["image_out"]),
                                   x[:, :, ::-1, :].astype(np.float32))

    def test_threshold(self):
        out = ImageTransformer(**CPU).threshold(127.0, 255.0).transform(
            Table({"image": image_batch()}))
        assert set(np.unique(np.asarray(out["image_out"]))) <= {0.0, 255.0}

    def test_ragged_list_input(self):
        imgs = [image_batch(1, 12, 12)[0], image_batch(1, 20, 8, seed=1)[0]]
        out = ImageTransformer(**CPU).resize(8, 8).transform(
            Table({"image": imgs, "idx": np.arange(2)}))
        assert np.asarray(out["image_out"]).shape == (2, 8, 8, 3)

    def test_gaussian_preserves_mean(self):
        x = np.full((2, 8, 8, 3), 100.0, np.float32)
        out = ImageTransformer(**CPU).gaussian_kernel(3, 1.0).transform(Table({"image": x}))
        np.testing.assert_allclose(np.asarray(out["image_out"])[:, 2:-2, 2:-2], 100.0,
                                   rtol=1e-4)

    def test_resize_transformer_stage(self):
        out = ResizeImageTransformer(height=4, width=4, **CPU).transform(
            Table({"image": image_batch()}))
        assert np.asarray(out["image_out"]).shape == (4, 4, 4, 3)

    def test_save_load(self, tmp_path):
        from mmlspark_tpu_torch.core.pipeline import PipelineStage

        t = ImageTransformer(**CPU).resize(8, 8).flip(1)
        p = str(tmp_path / "it")
        t.save(p)
        t2 = PipelineStage.load(p)
        x = image_batch()
        np.testing.assert_array_equal(
            np.asarray(t.transform(Table({"image": x}))["image_out"]),
            np.asarray(t2.transform(Table({"image": x}))["image_out"]))

    def test_cuda_without_a_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="cuda"):
            ImageTransformer().resize(8, 8).transform(Table({"image": image_batch()}))


# op chains against the JAX package's ImageTransformer: (name, builder, atol)
CHAINS = [
    ("smoke_chain", lambda t: t.resize(14, 14).crop(1, 1, 12, 12).flip(1)
     .gray(keep_channels=True).blur(3, 3).gaussian_kernel(5, 1.0), 5e-3),
    ("resize_cubic_flip_both", lambda t: t.resize(10, 13, "cubic").flip(-1), 5e-3),
    ("crop_past_edge_gray", lambda t: t.crop(9, 9, 8, 8).gray(), 1e-4),
    ("blur_4x4_gaussian_4", lambda t: t.blur(4, 4).gaussian_kernel(4, 0.8), 1e-4),
    ("upsample_lanczos", lambda t: t.resize(21, 19, "lanczos3"), 5e-3),
    ("tozero_inv", lambda t: t.threshold(90.0, 255.0, "tozero_inv"), 0.0),
]


@pytest.mark.parametrize("name,build,atol", CHAINS, ids=[c[0] for c in CHAINS])
def test_chain_matches_jax_on_a_uniform_batch(name, build, atol):
    x = image_batch(3, 16, 16, seed=5)
    want = build(JaxImageTransformer()).transform(JaxTable({"image": x}))
    got = build(ImageTransformer(**CPU)).transform(Table({"image": x}))
    w, g = np.asarray(want["image_out"]), np.asarray(got["image_out"])
    assert g.shape == w.shape and g.dtype == w.dtype == np.float32
    np.testing.assert_allclose(g, w, rtol=0, atol=atol)
    assert got.meta("image_out")[IMAGE_SPEC] == want.meta("image_out")[IMAGE_SPEC]


@pytest.mark.parametrize("same_out", [True, False], ids=["stacked", "ragged_out"])
def test_chain_matches_jax_on_a_ragged_list(same_out):
    imgs = [image_batch(1, 12, 12, seed=1)[0], image_batch(1, 20, 9, seed=2)[0],
            image_batch(1, 12, 12, seed=3)[0]]

    def build(t):
        t = t.flip(0).blur(3, 3)
        return t.resize(8, 8) if same_out else t

    want = build(JaxImageTransformer()).transform(JaxTable({"image": imgs}))["image_out"]
    got = build(ImageTransformer(**CPU)).transform(Table({"image": imgs}))["image_out"]
    if same_out:
        assert isinstance(got, np.ndarray) and got.shape == (3, 8, 8, 3)
    else:
        assert isinstance(got, list) and [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=5e-3)


def test_stage_saved_by_the_jax_package_loads_and_runs(tmp_path):
    from mmlspark_tpu.core.serialize import save_stage as jax_save_stage
    from mmlspark_tpu_torch.core.serialize import load_stage

    jt = JaxImageTransformer().resize(8, 8).gray().threshold(100.0, 255.0, "trunc")
    jax_save_stage(jt, str(tmp_path / "jax"))
    t = load_stage(str(tmp_path / "jax"))
    assert isinstance(t, ImageTransformer) and t.get("stages") == jt.get("stages")
    assert t.get("device") == "cuda"           # the port's default
    x = image_batch(2, 12, 12, seed=9)
    got = t.set(device="cpu").transform(Table({"image": x}))["image_out"]
    want = jt.transform(JaxTable({"image": x}))["image_out"]
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=5e-3)


class TestUnroll:
    def test_unroll_chw_order(self):
        x = image_batch(n=2, h=3, w=4)
        arr = np.asarray(UnrollImage().transform(Table({"image": x}))["features"])
        assert arr.shape == (2, 3 * 4 * 3) and arr.dtype == np.float64
        np.testing.assert_allclose(arr[0, : 3 * 4], x[0, :, :, 0].reshape(-1))

    def test_unroll_binary(self):
        x = image_batch(n=2, h=6, w=6)
        blobs = [encode_image(x[i]) for i in range(2)]
        out = UnrollBinaryImage().transform(Table({"bytes": blobs}))
        assert np.asarray(out["features"]).shape == (2, 6 * 6 * 3)


class TestAugmenter:
    def test_flip_doubles_rows(self):
        x = image_batch(n=3)
        out = ImageSetAugmenter().transform(Table({"image": x, "label": np.arange(3.0)}))
        assert len(out) == 6
        np.testing.assert_array_equal(np.asarray(out["label"]), [0.0, 1.0, 2.0, 0.0, 1.0, 2.0])
        np.testing.assert_array_equal(np.asarray(out["image"])[3:], x[:, :, ::-1, :])


class TestIO:
    def test_roundtrip_encode_decode(self):
        x = image_batch(n=1)[0]
        assert np.array_equal(decode_image(encode_image(x)), x)

    def test_read_images_dir(self, tmp_path):
        for i in range(3):
            (tmp_path / f"img{i}.png").write_bytes(encode_image(image_batch(1, seed=i)[0]))
        (tmp_path / "not_an_image.txt").write_text("hi")
        tbl = read_images(str(tmp_path))
        assert len(tbl) == 3
        assert all(im.shape == (16, 16, 3) for im in tbl["image"])

    def test_read_images_resize_stacks(self, tmp_path):
        (tmp_path / "a.png").write_bytes(encode_image(image_batch(1, 10, 12)[0]))
        (tmp_path / "b.png").write_bytes(encode_image(image_batch(1, 20, 8)[0]))
        tbl = read_images(str(tmp_path), resize=(16, 16))
        assert np.asarray(tbl["image"]).shape == (2, 16, 16, 3)

    def test_read_images_drops_invalid(self, tmp_path):
        (tmp_path / "a.png").write_bytes(encode_image(image_batch(1)[0]))
        (tmp_path / "b.png").write_bytes(b"corrupt")
        assert len(read_images(str(tmp_path))) == 1

    def test_read_binary_files(self, tmp_path):
        sub = tmp_path / "sub"
        sub.mkdir()
        (tmp_path / "x.bin").write_bytes(b"abc")
        (sub / "y.bin").write_bytes(b"defgh")
        assert len(read_binary_files(str(tmp_path), glob="*.bin")) == 1
        rec = read_binary_files(str(tmp_path), glob="*.bin", recursive=True)
        assert len(rec) == 2
        assert sorted(rec["length"].tolist()) == [3, 5]

    def test_write_binary_files_roundtrip(self, tmp_path):
        src = tmp_path / "src"
        src.mkdir()
        (src / "x.bin").write_bytes(b"abc")
        (src / "y.bin").write_bytes(b"defgh")
        tbl = read_binary_files(str(src), glob="*.bin")
        written = write_binary_files(tbl, str(tmp_path / "out"))
        assert sorted(os.path.basename(w) for w in written) == ["x.bin", "y.bin"]
        again = read_binary_files(str(tmp_path / "out"), glob="*.bin")
        assert sorted(bytes(b) for b in again["bytes"]) == [b"abc", b"defgh"]
        (src / "sub").mkdir()
        (src / "sub" / "x.bin").write_bytes(b"nested")
        rec = read_binary_files(str(src), glob="*.bin", recursive=True)
        write_binary_files(rec, str(tmp_path / "out_rec"), base_dir=str(src))
        assert (tmp_path / "out_rec" / "sub" / "x.bin").read_bytes() == b"nested"
        with pytest.raises(ValueError, match="collision"):
            write_binary_files(rec, str(tmp_path / "out_collide"))
        assert not (tmp_path / "out_collide").exists()
        with pytest.raises(ValueError, match="escapes"):
            write_binary_files(Table({"path": ["../evil"], "bytes": [b"x"]}),
                               str(tmp_path / "out3"))
