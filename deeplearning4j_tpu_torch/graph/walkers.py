"""Random-walk sequence generators.

Reference: deeplearning4j-graph iterator/RandomWalkIterator.java +
WeightedRandomWalkIterator.java, with NoEdgeHandling SELF_LOOP_ON_DISCONNECTED /
EXCEPTION_ON_DISCONNECTED semantics.

Counterpart of ``deeplearning4j_tpu/graph/walkers.py``: host code, the same
in the port (the port keeps its own copy; it imports nothing of the JAX
package).
"""
from __future__ import annotations

from typing import Iterator, List

import numpy as np

from .graph import IGraph

SELF_LOOP_ON_DISCONNECTED = "self_loop"
EXCEPTION_ON_DISCONNECTED = "exception"


class RandomWalkIterator:
    """Uniform random walks of fixed length, one starting at each vertex
    (shuffled start order, as the reference's GraphWalkIteratorProvider does)."""

    def __init__(self, graph: IGraph, walk_length: int, seed: int = 123,
                 no_edge_handling: str = SELF_LOOP_ON_DISCONNECTED):
        self.graph = graph
        self.walk_length = walk_length
        self.seed = seed
        self.no_edge_handling = no_edge_handling
        self._rng = np.random.default_rng(seed)

    def _next_vertex(self, current: int) -> int:
        neighbors = self.graph.get_connected_vertex_indices(current)
        if not neighbors:
            if self.no_edge_handling == EXCEPTION_ON_DISCONNECTED:
                raise ValueError(f"Vertex {current} has no edges")
            return current  # self loop
        return int(neighbors[self._rng.integers(0, len(neighbors))])

    def walk_from(self, start: int) -> List[int]:
        walk = [start]
        current = start
        for _ in range(self.walk_length):
            current = self._next_vertex(current)
            walk.append(current)
        return walk

    def __iter__(self) -> Iterator[List[int]]:
        order = self._rng.permutation(self.graph.num_vertices())
        for start in order:
            yield self.walk_from(int(start))

    def reset(self) -> None:
        self._rng = np.random.default_rng(self.seed)


class WeightedRandomWalkIterator(RandomWalkIterator):
    """Transition probability proportional to edge weight
    (reference WeightedRandomWalkIterator.java)."""

    def _next_vertex(self, current: int) -> int:
        edges = self.graph.get_edges_out(current)
        if not edges:
            if self.no_edge_handling == EXCEPTION_ON_DISCONNECTED:
                raise ValueError(f"Vertex {current} has no edges")
            return current
        weights = np.array([e.weight for e in edges], np.float64)
        probs = weights / weights.sum()
        return int(edges[self._rng.choice(len(edges), p=probs)].to_idx)
