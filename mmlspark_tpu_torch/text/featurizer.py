"""Text featurization stages + the TextFeaturizer pipeline builder.

Reference: `TextFeaturizer` (src/text-featurizer/src/main/scala/
TextFeaturizer.scala:179-384) composes Spark ML's Tokenizer,
StopWordsRemover, NGram, HashingTF/CountVectorizer and IDF into one
estimator. Those five building blocks are implemented here directly (the
reference gets them from Spark ML; this framework has no Spark to lean on).

Device notes: tokenization/hashing are host-side string work (same as the
JVM reference); the TF/IDF math lands in dense (n, num_features) float
arrays ready for device learners.

A copy of mmlspark_tpu/text/featurizer.py (host numpy code).
"""

from __future__ import annotations

import hashlib
import re
from typing import Any

import numpy as np

from ..core.params import HasInputCol, HasOutputCol, Param
from ..core.pipeline import Estimator, Model, Pipeline, PipelineModel, Transformer
from ..core.schema import Table, host_array
from ..core.serialize import register_stage

__all__ = [
    "Tokenizer",
    "StopWordsRemover",
    "NGram",
    "HashingTF",
    "CountVectorizer",
    "CountVectorizerModel",
    "IDF",
    "IDFModel",
    "TextFeaturizer",
    "ENGLISH_STOP_WORDS",
]

# the usual Spark ML english list, abbreviated to the high-frequency core
ENGLISH_STOP_WORDS = [
    "a", "an", "and", "are", "as", "at", "be", "but", "by", "for", "if",
    "in", "into", "is", "it", "no", "not", "of", "on", "or", "such", "that",
    "the", "their", "then", "there", "these", "they", "this", "to", "was",
    "will", "with", "i", "you", "he", "she", "we", "his", "her", "its",
]

STOP_WORDS_BY_LANGUAGE = {"english": ENGLISH_STOP_WORDS}


@register_stage
class Tokenizer(HasInputCol, HasOutputCol, Transformer):
    """Regex tokenizer (Spark ML Tokenizer semantics: lowercase + split)."""

    input_col = Param("text", "string column", ptype=str)
    output_col = Param("tokens", "token list column", ptype=str)
    pattern = Param(r"\W+", "split pattern", ptype=str)
    lowercase = Param(True, "lowercase first", ptype=bool)
    min_token_length = Param(1, "drop shorter tokens", ptype=int)

    def _transform(self, table: Table) -> Table:
        rx = re.compile(self.get("pattern"))
        out = []
        for s in table[self.get("input_col")]:
            s = str(s)
            if self.get("lowercase"):
                s = s.lower()
            out.append([t for t in rx.split(s) if len(t) >= self.get("min_token_length")])
        return table.with_column(self.get("output_col"), out)


@register_stage
class StopWordsRemover(HasInputCol, HasOutputCol, Transformer):
    input_col = Param("tokens", "token list column", ptype=str)
    output_col = Param("filtered", "filtered token column", ptype=str)
    stop_words = Param(None, "stop word list (default english)")
    case_sensitive = Param(False, "case sensitive match", ptype=bool)

    def _transform(self, table: Table) -> Table:
        words = self.get("stop_words")
        if words is None:  # [] means "remove nothing", not "use defaults"
            words = ENGLISH_STOP_WORDS
        if not self.get("case_sensitive"):
            stop = {w.lower() for w in words}
            key = lambda t: t.lower()  # noqa: E731
        else:
            stop = set(words)
            key = lambda t: t  # noqa: E731
        out = [[t for t in toks if key(t) not in stop]
               for toks in table[self.get("input_col")]]
        return table.with_column(self.get("output_col"), out)


@register_stage
class NGram(HasInputCol, HasOutputCol, Transformer):
    input_col = Param("tokens", "token list column", ptype=str)
    output_col = Param("ngrams", "ngram list column", ptype=str)
    n = Param(2, "ngram length", ptype=int)

    def _transform(self, table: Table) -> Table:
        n = self.get("n")
        out = [
            [" ".join(toks[i : i + n]) for i in range(len(toks) - n + 1)]
            for toks in table[self.get("input_col")]
        ]
        return table.with_column(self.get("output_col"), out)


def _hash_token(token: str, buckets: int) -> int:
    h = int.from_bytes(hashlib.md5(token.encode()).digest()[:8], "little")
    return h % buckets


@register_stage
class HashingTF(HasInputCol, HasOutputCol, Transformer):
    """Default buckets: 2^12 (the reference's tree-learner default,
    Featurize.scala:13-19) — NOT the reference text default of 2^18,
    because Table columns are dense: 2^18 float64 costs 2 MB/doc. Raise
    num_features explicitly for large vocabularies."""

    input_col = Param("tokens", "token list column", ptype=str)
    output_col = Param("tf", "term-frequency vector column", ptype=str)
    num_features = Param(1 << 12, "hash buckets", ptype=int)
    binary = Param(False, "presence instead of counts", ptype=bool)

    def _transform(self, table: Table) -> Table:
        nf = self.get("num_features")
        col = table[self.get("input_col")]
        out = np.zeros((len(col), nf), np.float64)
        for r, toks in enumerate(col):
            for t in toks:
                out[r, _hash_token(t, nf)] += 1.0
        if self.get("binary"):
            out = (out > 0).astype(np.float64)
        return table.with_column(self.get("output_col"), out)


@register_stage
class CountVectorizer(HasInputCol, HasOutputCol, Estimator):
    input_col = Param("tokens", "token list column", ptype=str)
    output_col = Param("tf", "term-frequency vector column", ptype=str)
    vocab_size = Param(1 << 18, "max vocabulary size", ptype=int)
    min_df = Param(1.0, "min documents per term (count if >=1, fraction if <1)", ptype=float)

    def _fit(self, table: Table) -> "CountVectorizerModel":
        col = table[self.get("input_col")]
        df_counts: dict[str, int] = {}
        for toks in col:
            for t in set(toks):
                df_counts[t] = df_counts.get(t, 0) + 1
        min_df = self.get("min_df")
        threshold = min_df if min_df >= 1 else min_df * len(col)
        terms = [(c, t) for t, c in df_counts.items() if c >= threshold]
        terms.sort(key=lambda x: (-x[0], x[1]))
        vocab = [t for _, t in terms[: self.get("vocab_size")]]
        m = CountVectorizerModel(
            input_col=self.get("input_col"), output_col=self.get("output_col"),
        )
        m.vocabulary = vocab
        return m


@register_stage
class CountVectorizerModel(HasInputCol, HasOutputCol, Model):
    input_col = Param("tokens", "token list column", ptype=str)
    output_col = Param("tf", "term-frequency vector column", ptype=str)

    vocabulary: list[str] = []

    def _transform(self, table: Table) -> Table:
        index = {t: i for i, t in enumerate(self.vocabulary)}
        col = table[self.get("input_col")]
        out = np.zeros((len(col), len(self.vocabulary)), np.float64)
        for r, toks in enumerate(col):
            for t in toks:
                i = index.get(t)
                if i is not None:
                    out[r, i] += 1.0
        return table.with_column(self.get("output_col"), out)

    def _save_state(self) -> dict[str, Any]:
        return {"vocabulary": list(self.vocabulary)}

    def _load_state(self, state: dict[str, Any]) -> None:
        self.vocabulary = state["vocabulary"]


@register_stage
class IDF(HasInputCol, HasOutputCol, Estimator):
    input_col = Param("tf", "term-frequency vectors", ptype=str)
    output_col = Param("tfidf", "tf-idf vectors", ptype=str)
    min_doc_freq = Param(0, "zero out terms in fewer docs", ptype=int)

    def _fit(self, table: Table) -> "IDFModel":
        tf = host_array(table[self.get("input_col")], np.float64)
        n = tf.shape[0]
        df = (tf > 0).sum(axis=0)
        idf = np.log((n + 1.0) / (df + 1.0))
        if self.get("min_doc_freq") > 0:
            idf = np.where(df >= self.get("min_doc_freq"), idf, 0.0)
        m = IDFModel(input_col=self.get("input_col"), output_col=self.get("output_col"))
        m.idf = idf
        return m


@register_stage
class IDFModel(HasInputCol, HasOutputCol, Model):
    input_col = Param("tf", "term-frequency vectors", ptype=str)
    output_col = Param("tfidf", "tf-idf vectors", ptype=str)

    idf: np.ndarray | None = None

    def _transform(self, table: Table) -> Table:
        tf = host_array(table[self.get("input_col")], np.float64)
        return table.with_column(self.get("output_col"), tf * self.idf)

    def _save_state(self) -> dict[str, Any]:
        return {"idf": self.idf}

    def _load_state(self, state: dict[str, Any]) -> None:
        self.idf = np.asarray(state["idf"], np.float64)


@register_stage
class TextFeaturizer(HasInputCol, HasOutputCol, Estimator):
    """Composed text pipeline (TextFeaturizer.scala:179-384)."""

    input_col = Param("text", "string column", ptype=str)
    output_col = Param("features", "feature vector column", ptype=str)
    use_tokenizer = Param(True, "tokenize", ptype=bool)
    tokenizer_pattern = Param(r"\W+", "token split pattern", ptype=str)
    to_lowercase = Param(True, "lowercase", ptype=bool)
    use_stop_words_remover = Param(False, "remove stop words", ptype=bool)
    case_sensitive_stop_words = Param(False, "stop word case", ptype=bool)
    default_stop_word_language = Param("english", "stop word language", ptype=str)
    stop_words = Param(None, "explicit stop word list (overrides language)")
    use_n_gram = Param(False, "append ngrams", ptype=bool)
    n_gram_length = Param(2, "ngram n", ptype=int)
    binarize_inputs = Param(False, "binary TF", ptype=bool)
    use_idf = Param(True, "apply IDF", ptype=bool)
    num_features = Param(1 << 12, "hash buckets (see HashingTF note)", ptype=int)
    min_doc_freq = Param(1, "IDF min doc frequency", ptype=int)

    def _fit(self, table: Table) -> "PipelineModel":
        stages: list = []
        col = self.get("input_col")
        if self.get("use_tokenizer"):
            stages.append(Tokenizer(
                input_col=col, output_col="__tokens",
                pattern=self.get("tokenizer_pattern"),
                lowercase=self.get("to_lowercase"),
            ))
            col = "__tokens"
        if self.get("use_stop_words_remover"):
            words = self.get("stop_words")
            if words is None:
                lang = self.get("default_stop_word_language")
                if lang not in STOP_WORDS_BY_LANGUAGE:
                    raise ValueError(
                        f"no stop-word list for language {lang!r}; shipped: "
                        f"{sorted(STOP_WORDS_BY_LANGUAGE)} — pass stop_words "
                        "explicitly for other languages"
                    )
                words = STOP_WORDS_BY_LANGUAGE[lang]
            stages.append(StopWordsRemover(
                input_col=col, output_col="__filtered",
                stop_words=list(words),
                case_sensitive=self.get("case_sensitive_stop_words"),
            ))
            col = "__filtered"
        if self.get("use_n_gram"):
            stages.append(NGram(
                input_col=col, output_col="__ngrams",
                n=self.get("n_gram_length"),
            ))
            col = "__ngrams"
        tf_col = "__tf" if self.get("use_idf") else self.get("output_col")
        stages.append(HashingTF(
            input_col=col, output_col=tf_col,
            num_features=self.get("num_features"),
            binary=self.get("binarize_inputs"),
        ))
        if self.get("use_idf"):
            stages.append(IDF(
                input_col=tf_col, output_col=self.get("output_col"),
                min_doc_freq=self.get("min_doc_freq"),
            ))
        fitted = Pipeline(stages).fit(table)
        # drop the intermediate columns on transform
        from ..ops.stages import DropColumns

        temps = [c for c in ("__tokens", "__filtered", "__ngrams", "__tf")]
        fitted.stages.append(DropColumns(cols=temps, ignore_missing=True))
        return fitted
