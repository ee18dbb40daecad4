"""The port's model zoo (mmlspark_tpu_torch/nn/zoo.py): tests/test_nn.py's
TestZoo cases, the http fetch of tests/test_utils_aux.py:155,
`import_external` for both imported families, the committed model_zoo/
(hashes, resnet20_digits, and tests/test_zoo_content.py:73-88's wdbc and
diabetes gates) served by the port on the CPU, and repositories that one
package writes and the other reads.
"""

import hashlib
import http.server
import importlib.util
import json
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu.nn.models import ModelBundle as JaxBundle  # noqa: E402
from mmlspark_tpu.nn.zoo import ModelDownloader as JaxDownloader  # noqa: E402
from mmlspark_tpu.nn.zoo import ModelSchema as JaxSchema  # noqa: E402
from mmlspark_tpu.utils.datagen import (  # noqa: E402
    digits_to_images, holdout_split, load_label_csv)
from mmlspark_tpu_torch.automl.metrics import auc  # noqa: E402
from mmlspark_tpu_torch.core import Table  # noqa: E402
from mmlspark_tpu_torch.nn import (  # noqa: E402
    DeepModelTransformer, ModelBundle, ModelDownloader, ModelSchema, retry_with_timeout)
from mmlspark_tpu_torch.nn.zoo import _sha256  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ZOO = os.path.join(HERE, os.pardir, "model_zoo")
EXPECTED = {"gbdt_wdbc", "gbdt_diabetes", "gbdt_adult_census_synthetic", "resnet20_digits"}

_spec = importlib.util.spec_from_file_location(
    "reference_import_weights_tests", os.path.join(HERE, "test_import_weights.py"))
REF = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(REF)


def _csv(name):
    return load_label_csv(os.path.join(HERE, "benchmarks", "data", f"{name}.csv"))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


def _assert_same_variables(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert sorted(la) == sorted(lb)
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg=str(k))


class TestZoo:
    def test_publish_download_load(self, tmp_path):
        repo = ModelDownloader(str(tmp_path / "repo"))
        b = ModelBundle.init("mlp", (4,), num_outputs=2)
        schema = repo.publish(b, "tiny-mlp")
        assert schema.sha256 and schema.uri.startswith("file://")
        assert repo.get_model("tiny-mlp").architecture == "mlp"
        b2 = repo.load_bundle("tiny-mlp")
        assert b2.architecture == "mlp"
        _assert_same_variables(b2.variables, b.variables)
        # a second repo downloads it from the first
        other = ModelDownloader(str(tmp_path / "other"))
        local = other.download_model(schema)
        assert _sha256(local) == schema.sha256
        assert other.download_model(schema) == local          # already there

    def test_hash_mismatch_rejected(self, tmp_path):
        src = str(tmp_path / "src.model")
        ModelBundle.init("mlp", (4,), num_outputs=2).save(src)
        repo = ModelDownloader(str(tmp_path / "repo"))
        with pytest.raises(IOError):
            repo.download_model(ModelSchema(name="bad", uri=src, sha256="0" * 64))
        assert not os.path.exists(repo.local_path("bad"))
        assert [f for f in os.listdir(repo.local_repo) if f.endswith(".tmp")] == []

    def test_retry_with_timeout(self):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise ValueError("boom")
            return "ok"

        assert retry_with_timeout(flaky, retries=5) == "ok"
        assert len(calls) == 3

    def test_retry_with_timeout_bounds_a_hung_attempt(self):
        with pytest.raises(TimeoutError):
            retry_with_timeout(lambda: time.sleep(5), timeout_s=0.05, retries=1)

    def test_unknown_model_raises(self, tmp_path):
        with pytest.raises(KeyError):
            ModelDownloader(str(tmp_path)).get_model("nope")

    def test_sweep_orphan_tmps(self, tmp_path):
        repo = ModelDownloader(str(tmp_path))
        for name in (".x.abc.tmp", ".y.safetensors", "keep.model", ".nfs123"):
            (tmp_path / name).write_bytes(b"x")
            os.utime(tmp_path / name, (0, 0))
        assert repo.sweep_orphan_tmps(min_age_s=10.0) == 2
        assert sorted(os.listdir(tmp_path)) == [".nfs123", "keep.model"]


def test_download_model_over_http(tmp_path):
    """tests/test_utils_aux.py:155 on the port: an http:// uri with sha256
    verification, from a server on the loopback interface."""
    src = tmp_path / "serve" / "tiny.model"
    src.parent.mkdir()
    ModelBundle.init("mlp", (4,), num_outputs=2).save(str(src))
    sha = hashlib.sha256(src.read_bytes()).hexdigest()
    handler = lambda *a, **kw: http.server.SimpleHTTPRequestHandler(  # noqa: E731
        *a, directory=str(src.parent), **kw)
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/tiny.model"
        repo = ModelDownloader(str(tmp_path / "repo"))
        local = repo.download_model(ModelSchema(name="tiny-http", uri=url, sha256=sha))
        assert ModelBundle.load(local).architecture == "mlp"
        with pytest.raises(IOError):
            repo.download_model(ModelSchema(name="bad-http", uri=url, sha256="0" * 64))
    finally:
        srv.shutdown()
        srv.server_close()


class TestImportExternal:
    def test_resnet50_safetensors_roundtrip(self, tmp_path):
        from safetensors.numpy import save_file

        src = os.path.join(tmp_path, "src", "resnet50.safetensors")
        os.makedirs(os.path.dirname(src))
        save_file(REF.synthetic_state_dict(), src)
        dl = ModelDownloader(os.path.join(tmp_path, "repo"))
        schema = ModelSchema(name="resnet50_pretrained", uri=src, architecture="resnet50",
                             input_shape=(64, 64, 3), num_outputs=1000)
        dest = dl.import_external(schema)
        assert os.path.exists(dest)
        loaded = dl.load_bundle("resnet50_pretrained")
        assert loaded.architecture == "resnet50"
        assert loaded.variables["params"]["head"]["kernel"].shape == (2048, 1000)
        # idempotent: a second call is a hit on the converted bundle
        mtime = os.path.getmtime(dest)
        assert dl.import_external(schema) == dest and os.path.getmtime(dest) == mtime
        # no work file left behind
        assert sorted(os.listdir(dl.local_repo)) == ["index.json", "resnet50_pretrained.model"]
        # the bundle serves the committed activations
        rng = np.random.default_rng(42)
        x = rng.integers(0, 256, size=(2, 64, 64, 3)).astype(np.float32)
        stage = DeepModelTransformer(input_col="x", device="cpu", mini_batch_size=2,
                                     fetch_dict={"l": "logits"}).set_model(loaded)
        logits = np.asarray(stage.transform(Table({"x": x}))["l"])
        with open(os.path.join(HERE, "fixtures", "imported_resnet50_logits.json")) as fh:
            want = np.asarray(json.load(fh)["logits_2x8"])
        np.testing.assert_allclose(logits[:, :8], want, rtol=2e-3, atol=2e-4)

    def test_transformer_npz_dispatches(self, tmp_path):
        src = os.path.join(tmp_path, "src", "encoder.npz")
        os.makedirs(os.path.dirname(src))
        np.savez(src, **REF.synthetic_transformer_state_dict())
        dl = ModelDownloader(os.path.join(tmp_path, "repo"))
        schema = ModelSchema(name="tiny_encoder", uri="file://" + src,
                             architecture="transformer", num_outputs=REF.T_OUT,
                             extra={"config": {"num_heads": REF.T_HEADS}})
        assert os.path.exists(dl.import_external(schema))
        loaded = dl.load_bundle("tiny_encoder")
        assert loaded.architecture == "transformer"
        assert loaded.config["num_heads"] == REF.T_HEADS

    def test_hashed_import_mirrors_the_reference(self, tmp_path):
        """An import given the artifact's sha256, run through both packages:
        the port's outcome must be the reference's. Today the index keeps
        the artifact's hash (mmlspark_tpu/nn/zoo.py:304 registers the
        schema as given) and load_bundle checks it against the converted
        bundle (:249-267), so both refuse to load what they installed
        (ROADMAP Queue 3). The test holds the port to the reference's
        outcome, not to that fault: a repair made in both keeps it passing,
        a repair made in one alone fails it."""
        src = os.path.join(tmp_path, "encoder.npz")
        np.savez(src, **REF.synthetic_transformer_state_dict())
        sha = _sha256(src)

        def outcome(downloader_cls, schema_cls, bundle_cls, repo):
            dl = downloader_cls(os.path.join(tmp_path, repo))
            dest = dl.import_external(schema_cls(name="enc", uri=src, sha256=sha,
                                                 architecture="transformer"))
            assert os.path.exists(dest)
            assert bundle_cls.load(dest).architecture == "transformer"
            try:
                loaded = dl.load_bundle("enc")
            except IOError as err:
                return dl.get_model("enc").sha256, type(err).__name__, \
                    "hash mismatch" in str(err)
            return dl.get_model("enc").sha256, loaded.architecture, None

        port = outcome(ModelDownloader, ModelSchema, ModelBundle, "port")
        reference = outcome(JaxDownloader, JaxSchema, JaxBundle, "reference")
        assert port == reference

    def test_import_checks_the_artifact_hash_first(self, tmp_path):
        src = os.path.join(tmp_path, "encoder.npz")
        np.savez(src, **REF.synthetic_transformer_state_dict())
        dl = ModelDownloader(os.path.join(tmp_path, "repo"))
        with pytest.raises(IOError, match="hash mismatch"):
            dl.import_external(ModelSchema(name="enc", uri=src, sha256="0" * 64,
                                           architecture="transformer"))
        assert dl.models() == [] and not os.path.exists(dl.local_path("enc"))


class TestCommittedZoo:
    @pytest.fixture(scope="class")
    def zoo(self):
        return ModelDownloader(ZOO)

    def test_expected_models_stocked_and_hashes_verify(self, zoo):
        names = {s.name for s in zoo.models()}
        assert EXPECTED <= names, f"missing: {EXPECTED - names}"
        for s in zoo.models():
            assert "://" not in s.uri and not os.path.isabs(s.uri), s.uri
            assert s.sha256 and _sha256(zoo.local_path(s.name)) == s.sha256, s.name

    def test_resnet20_digits_holdout_accuracy(self, zoo):
        s = zoo.get_model("resnet20_digits")
        assert (s.architecture, tuple(s.input_shape), s.num_outputs) == \
            ("resnet20_cifar", (8, 8, 3), 10)
        bundle = zoo.load_bundle("resnet20_digits")
        x, y = _csv("digits")
        _, te = holdout_split(len(y))
        stage = DeepModelTransformer(input_col="image", mini_batch_size=256, device="cpu",
                                     fetch_dict={"probs": "probability"}).set_model(bundle)
        probs = np.asarray(stage.transform(Table({"image": digits_to_images(x)[te]}))["probs"])
        assert float((probs.argmax(axis=1) == y[te]).mean()) > 0.9

    def test_wdbc_booster_predicts(self, zoo):
        b = zoo.load_booster("gbdt_wdbc", device="cpu")
        x, y = _csv("breast_cancer_wdbc")
        _, te = holdout_split(len(y))
        assert auc(y[te], np.asarray(b.predict(x[te]))) > 0.97

    def test_diabetes_booster_predicts(self, zoo):
        b = zoo.load_booster("gbdt_diabetes", device="cpu")
        x, y = _csv("diabetes")
        _, te = holdout_split(len(y))
        rmse = float(np.sqrt(np.mean((np.asarray(b.predict(x[te])) - y[te]) ** 2)))
        assert rmse < 62.0, rmse

    def test_load_booster_rejects_nn_bundles(self, zoo):
        with pytest.raises(ValueError, match="gbdt"):
            zoo.load_booster("resnet20_digits", device="cpu")

    def test_tampered_artifact_is_refused(self, tmp_path):
        import shutil

        repo = tmp_path / "zoo"
        shutil.copytree(ZOO, repo)
        path = repo / "resnet20_digits.model"
        data = bytearray(path.read_bytes())
        data[-1] ^= 0xFF
        path.write_bytes(bytes(data))
        with pytest.raises(IOError, match="hash mismatch"):
            ModelDownloader(str(repo)).load_bundle("resnet20_digits")


class TestAcrossPackages:
    def test_port_reads_a_repo_the_jax_package_wrote(self, tmp_path):
        jb = JaxBundle.init("mlp", (4,), num_outputs=3)
        JaxDownloader(str(tmp_path)).publish(jb, "jax-mlp", class_labels=["a", "b", "c"])
        port = ModelDownloader(str(tmp_path))
        assert [s.name for s in port.models()] == ["jax-mlp"]
        assert port.get_model("jax-mlp").class_labels == ["a", "b", "c"]
        b = port.load_bundle("jax-mlp")
        import jax

        _assert_same_variables(b.variables, jax.tree.map(np.asarray, jb.variables))

    def test_jax_package_reads_a_repo_the_port_wrote(self, tmp_path):
        import jax

        b = ModelBundle.init("mlp", (4,), num_outputs=2, seed=5)
        port = ModelDownloader(str(tmp_path))
        port.publish(b, "port-mlp", relative_uri=True)
        ref = JaxDownloader(str(tmp_path))
        assert ref.get_model("port-mlp").uri == "port-mlp.model"
        jb = ref.load_bundle("port-mlp")
        _assert_same_variables(jax.tree.map(np.asarray, jb.variables), b.variables)

    def test_boosters_cross_both_ways(self, tmp_path):
        from mmlspark_tpu_torch.gbdt.booster import Booster

        zoo = ModelDownloader(ZOO)
        b = zoo.load_booster("gbdt_wdbc", device="cpu")
        port = ModelDownloader(str(tmp_path))
        port.publish_booster(b, "wdbc_copy", extra={"from": "port"})
        jb = JaxDownloader(str(tmp_path)).load_booster("wdbc_copy")
        x, _ = _csv("breast_cancer_wdbc")
        np.testing.assert_allclose(np.asarray(jb.predict(x[:64])), b.predict(x[:64]),
                                   rtol=1e-6, atol=1e-7)
        again = port.load_booster("wdbc_copy", device="cpu")
        assert isinstance(again, Booster)
        np.testing.assert_array_equal(again.predict(x[:64]), b.predict(x[:64]))
