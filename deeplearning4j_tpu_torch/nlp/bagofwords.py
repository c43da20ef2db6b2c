"""Bag-of-words / TF-IDF vectorizers.

Reference: bagofwords/vectorizer/{BagOfWordsVectorizer,TfidfVectorizer}.java —
fit a vocabulary over documents, then transform text to sparse count /
tf-idf row vectors (dense numpy here; rows feed DataSet pipelines).

Counterpart of ``deeplearning4j_tpu/nlp/bagofwords.py``: host code, the same
in the port (the port keeps its own copy; it imports nothing of the JAX
package).
"""
from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np

from .tokenization import DefaultTokenizerFactory, TokenizerFactory
from .vocab import VocabCache, VocabConstructor


class BaseTextVectorizer:
    def __init__(self, tokenizer_factory: Optional[TokenizerFactory] = None,
                 min_word_frequency: int = 1, stop_words: Iterable[str] = ()):
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.min_word_frequency = min_word_frequency
        self.stop_words = frozenset(stop_words)
        self.vocab: Optional[VocabCache] = None
        self.doc_freq: Optional[np.ndarray] = None
        self.n_docs = 0

    def _tokens(self, text: str) -> List[str]:
        toks = self.tokenizer_factory.create(text).get_tokens()
        return [t for t in toks if t and t not in self.stop_words]

    def fit(self, documents: Iterable[str]) -> "BaseTextVectorizer":
        docs = [self._tokens(d) for d in documents]
        self.n_docs = len(docs)
        self.vocab = VocabConstructor(
            min_word_frequency=self.min_word_frequency,
            build_huffman_tree=False).build_joint_vocabulary(docs)
        df = np.zeros(self.vocab.num_words(), np.float64)
        for toks in docs:
            for i in {self.vocab.index_of(t) for t in toks}:
                if i >= 0:
                    df[i] += 1
        self.doc_freq = df
        return self

    def transform(self, document: str) -> np.ndarray:
        raise NotImplementedError

    def fit_transform(self, documents: Iterable[str]) -> np.ndarray:
        docs = list(documents)
        self.fit(docs)
        return np.stack([self.transform(d) for d in docs])


class BagOfWordsVectorizer(BaseTextVectorizer):
    def transform(self, document: str) -> np.ndarray:
        row = np.zeros(self.vocab.num_words(), np.float32)
        for t in self._tokens(document):
            i = self.vocab.index_of(t)
            if i >= 0:
                row[i] += 1.0
        return row


class TfidfVectorizer(BaseTextVectorizer):
    """tf * log(N / df) weighting (reference TfidfVectorizer.java)."""

    def transform(self, document: str) -> np.ndarray:
        counts = np.zeros(self.vocab.num_words(), np.float32)
        toks = self._tokens(document)
        for t in toks:
            i = self.vocab.index_of(t)
            if i >= 0:
                counts[i] += 1.0
        tf = counts / max(len(toks), 1)
        idf = np.log(np.maximum(self.n_docs, 1)
                     / np.maximum(self.doc_freq, 1.0)).astype(np.float32)
        return tf * idf
