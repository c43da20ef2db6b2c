"""Word2Vec facade over SequenceVectors (reference models/word2vec/Word2Vec.java:32).

Counterpart of ``deeplearning4j_tpu/nlp/word2vec.py``. Builder-style
configuration mirroring the reference's Word2Vec.Builder; the port's
builder adds ``device`` (None means CUDA), as its constructors take it.
"""
from __future__ import annotations

from typing import Iterable, List, Optional

from .iterators import SentenceIterator
from .sequencevectors import SequenceVectors
from .tokenization import DefaultTokenizerFactory, TokenizerFactory


class Word2Vec(SequenceVectors):
    def __init__(self, **kwargs):
        kwargs.setdefault("vector_length", 100)
        super().__init__(**kwargs)
        self.tokenizer_factory: TokenizerFactory = DefaultTokenizerFactory()
        self.sentence_iterator: Optional[SentenceIterator] = None

    # ------------------------------------------------------------------ builder
    class Builder:
        def __init__(self):
            self._kw = {}
            self._tokenizer = None
            self._iterator = None

        def layer_size(self, n: int):
            self._kw["vector_length"] = n
            return self

        def window_size(self, n: int):
            self._kw["window"] = n
            return self

        def min_word_frequency(self, n: int):
            self._kw["min_word_frequency"] = n
            return self

        def learning_rate(self, lr: float):
            self._kw["learning_rate"] = lr
            return self

        def min_learning_rate(self, lr: float):
            self._kw["min_learning_rate"] = lr
            return self

        def negative_sample(self, k: int):
            self._kw["negative"] = k
            if k > 0:
                self._kw.setdefault("use_hierarchic_softmax", False)
            return self

        def use_hierarchic_softmax(self, flag: bool):
            self._kw["use_hierarchic_softmax"] = flag
            return self

        def sampling(self, t: float):
            self._kw["sampling"] = t
            return self

        def epochs(self, n: int):
            self._kw["epochs"] = n
            return self

        def iterations(self, n: int):
            self._kw["iterations"] = n
            return self

        def batch_size(self, n: int):
            self._kw["batch_size"] = n
            return self

        def seed(self, s: int):
            self._kw["seed"] = s
            return self

        def elements_learning_algorithm(self, name: str):
            self._kw["elements_learning_algorithm"] = (
                "cbow" if "cbow" in name.lower() else "skipgram")
            return self

        def window(self, n: int):
            return self.window_size(n)

        def device(self, device):
            """Where the tables live and the step runs (None: CUDA)."""
            self._kw["device"] = device
            return self

        def tokenizer_factory(self, tf: TokenizerFactory):
            self._tokenizer = tf
            return self

        def iterate(self, it):
            self._iterator = it
            return self

        def build(self) -> "Word2Vec":
            w2v = Word2Vec(**self._kw)
            if self._tokenizer is not None:
                w2v.tokenizer_factory = self._tokenizer
            if self._iterator is not None:
                w2v.sentence_iterator = self._iterator
            return w2v

    @staticmethod
    def builder() -> "Word2Vec.Builder":
        return Word2Vec.Builder()

    # ------------------------------------------------------------------ fit
    def _tokenized(self) -> List[List[str]]:
        if self.sentence_iterator is None:
            raise ValueError("No sentence iterator set — use builder().iterate(...)")
        if hasattr(self.sentence_iterator, "reset"):
            self.sentence_iterator.reset()
        return [self.tokenizer_factory.create(s).get_tokens()
                for s in self.sentence_iterator]

    def fit(self, sequences: Optional[Iterable] = None, labels=None) -> None:
        if sequences is None:
            sequences = self._tokenized()
        super().fit(sequences, labels)
