"""Embedding lookup table.

Counterpart of ``deeplearning4j_tpu/nlp/lookup.py`` (reference
models/embeddings/inmemory/InMemoryLookupTable.java:55): syn0 (input
vectors), syn1 (hierarchical-softmax inner nodes), syn1neg
(negative-sampling output vectors), plus the unigram^0.75 sampling table.
The tables are float32 tensors on the model's device (``device=None``
means CUDA); their initial values come from numpy's ``default_rng(seed)``
as in the JAX package, so syn0 starts bitwise equal. The cumulative
sampling table is float32, as in JAX.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..common import resolve_device
from .vocab import VocabCache


class InMemoryLookupTable:
    def __init__(self, cache: VocabCache, vector_length: int, seed: int = 42,
                 use_hs: bool = True, negative: int = 0, *, device=None):
        self.cache = cache
        self.vector_length = vector_length
        self.seed = seed
        self.use_hs = use_hs
        self.negative = negative
        self.device = resolve_device(device)
        self.syn0: Optional[torch.Tensor] = None
        self.syn1: Optional[torch.Tensor] = None
        self.syn1neg: Optional[torch.Tensor] = None
        self.cum_table: Optional[torch.Tensor] = None

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def reset_weights(self) -> None:
        """Uniform(-0.5,0.5)/dim init, zero outputs (reference resetWeights)."""
        n = self.cache.num_words()
        d = self.vector_length
        rng = np.random.default_rng(self.seed)
        self.syn0 = self._tensor((rng.random((n, d), np.float32) - 0.5) / d)
        if self.use_hs:
            self.syn1 = torch.zeros((max(n - 1, 1), d), dtype=torch.float32,
                                    device=self.device)
        if self.negative > 0:
            self.syn1neg = torch.zeros((n, d), dtype=torch.float32,
                                       device=self.device)
            counts = np.array([vw.count for vw in self.cache.vocab_words()],
                              np.float64)
            probs = counts ** 0.75
            probs /= probs.sum()
            self.cum_table = self._tensor(np.cumsum(probs).astype(np.float32))

    # ------------------------------------------------------------------ vectors API
    def vector(self, word: str) -> Optional[np.ndarray]:
        idx = self.cache.index_of(word)
        if idx < 0 or self.syn0 is None:
            return None
        return self.syn0[idx].cpu().numpy()

    def set_vector(self, word: str, vec) -> None:
        idx = self.cache.index_of(word)
        if idx < 0:
            raise KeyError(word)
        self.syn0[idx] = torch.as_tensor(np.asarray(vec, np.float32),
                                         device=self.device)
