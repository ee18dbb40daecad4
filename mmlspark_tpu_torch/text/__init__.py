"""Text featurization subsystem.

Reference module replaced: src/text-featurizer/ — `TextFeaturizer`
(TextFeaturizer.scala:179-384: tokenize → stopwords → ngrams →
hashingTF/countVectorizer → IDF composed pipeline), `PageSplitter`
(PageSplitter.scala:19+), `MultiNGram` (MultiNGram.scala:23+).
(`TextPreprocessor` — trie find/replace — lives in ops.stages.)

A copy of mmlspark_tpu/text/__init__.py (host code).
"""

from .featurizer import (
    Tokenizer,
    StopWordsRemover,
    NGram,
    HashingTF,
    CountVectorizer,
    CountVectorizerModel,
    IDF,
    IDFModel,
    TextFeaturizer,
)
from .page_splitter import PageSplitter
from .multi_ngram import MultiNGram

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
    "PageSplitter",
    "MultiNGram",
]
