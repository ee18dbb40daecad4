"""The port's text stages (mmlspark_tpu_torch.text) against the JAX package's,
on the CPU: Tokenizer, StopWordsRemover, NGram, HashingTF (md5 buckets),
CountVectorizer, IDF, TextFeaturizer's composed pipeline, PageSplitter and
MultiNGram give equal outputs, vectors bit for bit, and load across the
packages; tests/test_text.py's downstream classification through both
packages' GBDT gives equal trees and predictions within rtol 1e-5, atol
1e-6 (tests/test_gbdt.py:900's tolerance)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import mmlspark_tpu.text as ref_text  # noqa: E402
import mmlspark_tpu_torch.text as text  # noqa: E402
from mmlspark_tpu.core import kernels as ref_kernels  # noqa: E402
from mmlspark_tpu.gbdt import GBDTClassifier as RefClassifier  # noqa: E402
from mmlspark_tpu.text.featurizer import STOP_WORDS_BY_LANGUAGE as REF_STOP_WORDS  # noqa: E402
from mmlspark_tpu_torch.gbdt import GBDTClassifier  # noqa: E402
from mmlspark_tpu_torch.text.featurizer import STOP_WORDS_BY_LANGUAGE  # noqa: E402
from test_torch_tabular_common import (  # noqa: E402
    assert_loads_across,
    assert_same_table,
    assert_same_value,
    both_tables,
    fitted,
)

DOCS = {"text": [
    "The quick brown fox jumps over the lazy dog",
    "the quick brown cat sleeps",
    "dogs and cats are animals",
    "An UPPER case line, with punctuation! And numbers 42 and 7.",
    "",
    "ünïcode wörds and émoji 🙂 too",
], "label": np.asarray([0.0, 1.0, 1.0, 0.0, 1.0, 0.0])}


def run_both(make, cols, tmp_path=None):
    pt, rt = both_tables(cols)
    port, ref = fitted(make(text), pt), fitted(make(ref_text), rt)
    out_port, out_ref = port.transform(pt), ref.transform(rt)
    assert_same_table(out_port, out_ref)
    if tmp_path is not None:
        assert_loads_across(port, ref, tmp_path, pt, rt)
    return out_port


def tokens():
    return {"tokens": ref_text.Tokenizer().transform(both_tables(DOCS)[1])["tokens"]}


@pytest.mark.parametrize("kw", [{}, {"lowercase": False}, {"pattern": r"\s+"},
                                {"min_token_length": 3}], ids=["default", "case", "spaces", "min3"])
def test_tokenizer(tmp_path, kw):
    run_both(lambda m: m.Tokenizer(**kw), DOCS, tmp_path)


@pytest.mark.parametrize("kw", [{}, {"stop_words": []}, {"stop_words": ["Quick", "dog"]},
                                {"stop_words": ["Quick", "dog"], "case_sensitive": True}],
                         ids=["english", "none", "list", "case_sensitive"])
def test_stop_words_remover(tmp_path, kw):
    run_both(lambda m: m.StopWordsRemover(input_col="tokens", **kw), tokens(), tmp_path)
    assert STOP_WORDS_BY_LANGUAGE == REF_STOP_WORDS


@pytest.mark.parametrize("n", [1, 2, 3, 12])
def test_ngram(tmp_path, n):
    run_both(lambda m: m.NGram(input_col="tokens", n=n), tokens(), tmp_path)


@pytest.mark.parametrize("kw", [{"num_features": 32}, {"num_features": 4096},
                                {"num_features": 7, "binary": True}],
                         ids=["32", "4096", "binary7"])
def test_hashing_tf_md5_buckets(tmp_path, kw):
    run_both(lambda m: m.HashingTF(**kw), tokens(), tmp_path)
    run_both(lambda m: m.HashingTF(**kw), {"tokens": [["a", "b", "a"], ["c"], []]})


@pytest.mark.parametrize("kw", [{}, {"min_df": 2.0}, {"min_df": 0.5}, {"vocab_size": 3}],
                         ids=["default", "min_df2", "min_df_half", "vocab3"])
def test_count_vectorizer(tmp_path, kw):
    run_both(lambda m: m.CountVectorizer(**kw), tokens(), tmp_path)
    pt, rt = both_tables(tokens())
    assert text.CountVectorizer(**kw).fit(pt).vocabulary == \
        ref_text.CountVectorizer(**kw).fit(rt).vocabulary


@pytest.mark.parametrize("kw", [{}, {"min_doc_freq": 2}], ids=["default", "min_doc_freq2"])
def test_idf(tmp_path, kw):
    tf = {"tf": ref_text.HashingTF(num_features=16).transform(both_tables(tokens())[1])["tf"]}
    run_both(lambda m: m.IDF(**kw), tf, tmp_path)
    run_both(lambda m: m.IDF(**kw), {"tf": np.asarray([[1.0, 1.0], [1.0, 0.0], [1.0, 0.0]])})


@pytest.mark.parametrize("kw", [
    {"num_features": 256},
    {"num_features": 64, "use_idf": False, "binarize_inputs": True},
    {"num_features": 128, "use_stop_words_remover": True, "use_n_gram": True, "n_gram_length": 2},
    {"num_features": 64, "use_stop_words_remover": True, "stop_words": ["fox"],
     "case_sensitive_stop_words": True, "to_lowercase": False},
    {"num_features": 32, "use_tokenizer": False, "input_col": "tokens"},
    {"num_features": 64, "min_doc_freq": 2, "tokenizer_pattern": r"[^a-z]+"},
], ids=["default", "binary_tf", "stop_ngram", "own_stop_words", "no_tokenizer", "min_doc_freq"])
def test_text_featurizer_pipeline(tmp_path, kw):
    cols = dict(DOCS, tokens=tokens()["tokens"])
    out = run_both(lambda m: m.TextFeaturizer(**kw), cols, tmp_path)
    assert "__tokens" not in out.columns and out["features"].shape[1] == kw["num_features"]


def test_text_featurizer_refuses_an_unknown_language_alike():
    for m, t in zip((text, ref_text), both_tables(DOCS)):
        with pytest.raises(ValueError, match="stop-word list"):
            m.TextFeaturizer(use_stop_words_remover=True,
                             default_stop_word_language="klingon").fit(t)


@pytest.mark.parametrize("kw", [{"max_page_length": 300, "min_page_length": 100},
                                {}, {"max_page_length": 100, "min_page_length": 10,
                                     "explode": True},
                                {"max_page_length": 7, "min_page_length": 50}],
                         ids=["pages", "short", "explode", "min_above_max"])
def test_page_splitter(tmp_path, kw):
    long = " ".join(["word"] * 500)
    run_both(lambda m: m.PageSplitter(**kw),
             {"text": [long, "short", "", " ".join(["w"] * 200) + "   tail"],
              "id": np.asarray([1.0, 2.0, 3.0, 4.0])}, tmp_path)


@pytest.mark.parametrize("lengths", [[1, 2, 3], [2], [1, 4]])
def test_multi_ngram(tmp_path, lengths):
    run_both(lambda m: m.MultiNGram(lengths=lengths), tokens(), tmp_path)
    run_both(lambda m: m.MultiNGram(lengths=lengths), {"tokens": [["a", "b", "c"]]})


def test_text_exports_match_the_reference():
    assert sorted(text.__all__) == sorted(ref_text.__all__)


def test_classification_downstream_through_both_gbdts():
    """tests/test_text.py:77's flow: TextFeaturizer then GBDTClassifier."""
    big = {"text": [f"repeat{'ed' * (i % 2)} token{i % 2}" for i in range(100)],
           "label": np.asarray([float(i % 2) for i in range(100)])}
    pt, rt = both_tables(big)
    feat_p = text.TextFeaturizer(num_features=64).fit(pt).transform(pt)
    feat_r = ref_text.TextFeaturizer(num_features=64).fit(rt).transform(rt)
    assert_same_value(feat_p["features"], feat_r["features"])
    port = GBDTClassifier(num_iterations=5, num_leaves=4, device="cpu").fit(feat_p)
    prior = ref_kernels.kernel_mode()
    try:
        ref_kernels.set_kernel_mode("xla")
        ref = RefClassifier(num_iterations=5, num_leaves=4).fit(feat_r)
        want = ref.transform(feat_r)
    finally:
        ref_kernels.set_kernel_mode(prior)
    for name in ("feature", "threshold_bin", "left", "right", "is_categorical"):
        np.testing.assert_array_equal(getattr(port.booster, name), getattr(ref.booster, name))
    got = port.transform(feat_p)
    np.testing.assert_allclose(got["probability"], want["probability"], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got["prediction"], want["prediction"])
    assert (got["prediction"] == big["label"]).mean() > 0.9
