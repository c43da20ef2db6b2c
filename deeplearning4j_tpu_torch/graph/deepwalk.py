"""DeepWalk vertex embeddings.

Reference: graph/models/deepwalk/DeepWalk.java:31 — fit(IGraph, walkLength):93
generates random-walk sequences and trains skip-gram with hierarchical softmax
(InMemoryGraphLookupTable + GraphHuffman). Here the walks feed the shared
SequenceVectors engine (vertex indices as tokens), reusing its skip-gram/HS
step — the reference's dedicated graph lookup table collapses into the common
one.

Counterpart of ``deeplearning4j_tpu/graph/deepwalk.py``: the walks are the
JAX package's (numpy RNG), the training runs on the model's device
(``device=None`` means CUDA).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..nlp.sequencevectors import SequenceVectors
from .graph import IGraph
from .walkers import RandomWalkIterator, WeightedRandomWalkIterator


class DeepWalk:
    def __init__(self, vector_size: int = 100, window_size: int = 5,
                 learning_rate: float = 0.025, epochs: int = 1,
                 batch_size: int = 512, seed: int = 123,
                 weighted_walks: bool = False, *, device=None):
        self.vector_size = vector_size
        self.window_size = window_size
        self.learning_rate = learning_rate
        self.epochs = epochs
        self.batch_size = batch_size
        self.seed = seed
        self.weighted_walks = weighted_walks
        self.device = device
        self.model: Optional[SequenceVectors] = None

    class Builder:
        def __init__(self):
            self._kw = {}

        def vector_size(self, n: int):
            self._kw["vector_size"] = n
            return self

        def window_size(self, n: int):
            self._kw["window_size"] = n
            return self

        def learning_rate(self, lr: float):
            self._kw["learning_rate"] = lr
            return self

        def epochs(self, n: int):
            self._kw["epochs"] = n
            return self

        def seed(self, s: int):
            self._kw["seed"] = s
            return self

        def weighted(self, flag: bool):
            self._kw["weighted_walks"] = flag
            return self

        def device(self, device):
            """Where the vectors train (None: CUDA)."""
            self._kw["device"] = device
            return self

        def build(self) -> "DeepWalk":
            return DeepWalk(**self._kw)

    @staticmethod
    def builder() -> "DeepWalk.Builder":
        return DeepWalk.Builder()

    # ------------------------------------------------------------------ training
    def fit(self, graph: IGraph, walk_length: int = 40,
            walks_per_vertex: int = 1) -> None:
        walker_cls = (WeightedRandomWalkIterator if self.weighted_walks
                      else RandomWalkIterator)
        sequences: List[List[str]] = []
        for rep in range(walks_per_vertex):
            walker = walker_cls(graph, walk_length, seed=self.seed + rep)
            sequences.extend([str(v) for v in walk] for walk in walker)
        self.model = SequenceVectors(
            vector_length=self.vector_size, window=self.window_size,
            learning_rate=self.learning_rate, epochs=self.epochs,
            use_hierarchic_softmax=True, negative=0,
            min_word_frequency=1, batch_size=self.batch_size, seed=self.seed,
            device=self.device)
        self.model.fit(sequences)

    # ------------------------------------------------------------------ access
    def get_vertex_vector(self, vertex_idx: int) -> np.ndarray:
        vec = self.model.get_word_vector(str(vertex_idx))
        if vec is None:
            raise KeyError(f"vertex {vertex_idx} not in model")
        return vec

    def similarity(self, v1: int, v2: int) -> float:
        return self.model.similarity(str(v1), str(v2))

    def vertices_nearest(self, vertex_idx: int, top_n: int = 10) -> List[int]:
        return [int(w) for w in self.model.words_nearest(str(vertex_idx), top_n)]
