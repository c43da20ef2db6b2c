"""KD-tree for exact nearest-neighbor search.

Reference: deeplearning4j-core clustering/kdtree/KDTree.java (insert/nn/knn over
HyperRect). Host-side structure (tree search is pointer-chasing, not device work);
median-split construction.

Counterpart of ``deeplearning4j_tpu/clustering/kdtree.py``: the same host
numpy code, so it builds the same tree and answers the same queries.
"""
from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np


class _Node:
    __slots__ = ("idx", "dim", "left", "right")

    def __init__(self, idx: int, dim: int):
        self.idx = idx
        self.dim = dim
        self.left: Optional["_Node"] = None
        self.right: Optional["_Node"] = None


class KDTree:
    def __init__(self, points):
        self.points = np.asarray(points, np.float64)
        n, self.d = self.points.shape
        self.root = self._build(list(range(n)), 0)

    def _build(self, idxs: List[int], depth: int) -> Optional[_Node]:
        if not idxs:
            return None
        dim = depth % self.d
        idxs.sort(key=lambda i: self.points[i, dim])
        mid = len(idxs) // 2
        node = _Node(idxs[mid], dim)
        node.left = self._build(idxs[:mid], depth + 1)
        node.right = self._build(idxs[mid + 1:], depth + 1)
        return node

    def nn(self, query) -> Tuple[int, float]:
        """Nearest neighbor: (index, distance)."""
        idx, dist = self.knn(query, 1)[0]
        return idx, dist

    def knn(self, query, k: int) -> List[Tuple[int, float]]:
        q = np.asarray(query, np.float64)
        heap: List[Tuple[float, int]] = []  # max-heap via negated distance

        def visit(node: Optional[_Node]):
            if node is None:
                return
            p = self.points[node.idx]
            dist = float(np.linalg.norm(p - q))
            if len(heap) < k:
                heapq.heappush(heap, (-dist, node.idx))
            elif dist < -heap[0][0]:
                heapq.heapreplace(heap, (-dist, node.idx))
            diff = q[node.dim] - p[node.dim]
            near, far = (node.left, node.right) if diff < 0 else (node.right, node.left)
            visit(near)
            if len(heap) < k or abs(diff) < -heap[0][0]:
                visit(far)

        visit(self.root)
        return sorted(((i, -nd) for nd, i in heap), key=lambda t: t[1])

    def size(self) -> int:
        return self.points.shape[0]
