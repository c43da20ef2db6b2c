"""ParagraphVectors (doc2vec) over SequenceVectors.

Reference: models/paragraphvectors/ParagraphVectors.java (1137 LoC) — labels are
vocab entries sharing the lookup table; PV-DBOW/PV-DM training;
inferVector trains a fresh doc vector against frozen syn0/syn1.

Counterpart of ``deeplearning4j_tpu/nlp/paragraph_vectors.py``: DBOW/DM
train through the engine on the model's device; :meth:`infer_vector` is a
plain tensor loop there (the JAX package's jitted ``infer_step``). The
builder adds ``device`` (None means CUDA).
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from .iterators import LabelAwareIterator, LabelsSource
from .sequencevectors import SequenceVectors
from .tokenization import DefaultTokenizerFactory


class ParagraphVectors(SequenceVectors):
    def __init__(self, *, dm: bool = False, **kwargs):
        kwargs.setdefault("train_sequences", True)
        kwargs.setdefault("sequence_learning_algorithm", "dm" if dm else "dbow")
        super().__init__(**kwargs)
        self.tokenizer_factory = DefaultTokenizerFactory()
        self.labels_source = LabelsSource()
        self._docs: Optional[List] = None

    # ------------------------------------------------------------------ builder
    class Builder:
        def __init__(self):
            self._kw = {}
            self._tokenizer = None
            self._iterator: Optional[LabelAwareIterator] = None

        def layer_size(self, n: int):
            self._kw["vector_length"] = n
            return self

        def window_size(self, n: int):
            self._kw["window"] = n
            return self

        def learning_rate(self, lr: float):
            self._kw["learning_rate"] = lr
            return self

        def min_learning_rate(self, lr: float):
            self._kw["min_learning_rate"] = lr
            return self

        def epochs(self, n: int):
            self._kw["epochs"] = n
            return self

        def min_word_frequency(self, n: int):
            self._kw["min_word_frequency"] = n
            return self

        def negative_sample(self, k: int):
            self._kw["negative"] = k
            if k > 0:
                self._kw.setdefault("use_hierarchic_softmax", False)
            return self

        def seed(self, s: int):
            self._kw["seed"] = s
            return self

        def train_words_vectors(self, flag: bool):
            self._kw["train_elements"] = flag
            return self

        def sequence_learning_algorithm(self, name: str):
            self._kw["sequence_learning_algorithm"] = (
                "dm" if "dm" in name.lower() else "dbow")
            return self

        def tokenizer_factory(self, tf):
            self._tokenizer = tf
            return self

        def device(self, device):
            """Where the tables live and the step runs (None: CUDA)."""
            self._kw["device"] = device
            return self

        def iterate(self, it: LabelAwareIterator):
            self._iterator = it
            return self

        def build(self) -> "ParagraphVectors":
            pv = ParagraphVectors(**self._kw)
            if self._tokenizer is not None:
                pv.tokenizer_factory = self._tokenizer
            if self._iterator is not None:
                pv.set_iterator(self._iterator)
            return pv

    @staticmethod
    def builder() -> "ParagraphVectors.Builder":
        return ParagraphVectors.Builder()

    # ------------------------------------------------------------------ data
    def set_iterator(self, iterator: LabelAwareIterator) -> None:
        self._docs = list(iterator)

    def fit(self, sequences: Optional[Iterable] = None, labels=None) -> None:
        if sequences is None:
            if self._docs is None:
                raise ValueError("No document iterator set — builder().iterate(...)")
            sequences = [self.tokenizer_factory.create(d.content).get_tokens()
                         for d in self._docs]
            labels = [d.labels for d in self._docs]
        super().fit(sequences, labels)

    # ------------------------------------------------------------------ inference
    def infer_vector(self, text: str, steps: int = 10,
                     learning_rate: float = 0.025) -> np.ndarray:
        """Train a fresh doc vector with frozen word weights (reference
        inferVector — label-aware inference)."""
        cache = self.vocab
        lt = self.lookup
        tokens = self.tokenizer_factory.create(text).get_tokens()
        idxs = [cache.index_of(t) for t in tokens]
        idxs = [i for i in idxs if i >= 0]
        rng = np.random.default_rng(self.seed)
        vec0 = (rng.random(self.vector_length, ).astype(np.float32)
                - 0.5) / self.vector_length
        if not idxs:
            return vec0

        max_code = max((len(cache.word_at(i).code) for i in idxs), default=1) or 1
        pts = np.zeros((len(idxs), max_code), np.int64)
        codes = np.zeros((len(idxs), max_code), np.float32)
        mask = np.zeros((len(idxs), max_code), np.float32)
        for r, i in enumerate(idxs):
            vw = cache.word_at(i)
            L = min(len(vw.code), max_code)
            pts[r, :L] = vw.points[:L]
            codes[r, :L] = vw.code[:L]
            mask[r, :L] = 1.0
        syn1 = lt.syn1 if lt.syn1 is not None else lt.syn1neg
        dev = syn1.device
        codes_t, mask_t = (torch.from_numpy(a).to(dev) for a in (codes, mask))
        vec = torch.from_numpy(vec0).to(dev)
        with torch.no_grad():
            p_vecs = syn1[torch.from_numpy(pts).to(dev)]     # (N, L, D)
            for s in range(steps):
                lr = np.float32(max(learning_rate * (1 - s / steps), 1e-4))
                f = torch.sigmoid(torch.einsum("d,nld->nl", vec, p_vecs))
                g = (1.0 - codes_t - f) * float(lr) * mask_t
                vec = vec + torch.einsum("nl,nld->d", g, p_vecs)
        return vec.cpu().numpy()
