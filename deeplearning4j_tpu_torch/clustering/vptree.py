"""Vantage-point tree for metric nearest-neighbor search.

Reference: deeplearning4j-core clustering/vptree/VPTree.java (used by
BarnesHutTsne for input-space neighbor finding). Median-distance splits,
priority-queue kNN search with tau pruning.

Counterpart of ``deeplearning4j_tpu/clustering/vptree.py``: the same host
numpy code, so it builds the same tree and answers the same queries.
"""
from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np


class _VPNode:
    __slots__ = ("idx", "threshold", "inside", "outside")

    def __init__(self, idx: int):
        self.idx = idx
        self.threshold = 0.0
        self.inside: Optional["_VPNode"] = None
        self.outside: Optional["_VPNode"] = None


class VPTree:
    def __init__(self, points, distance: str = "euclidean", seed: int = 0):
        self.points = np.asarray(points, np.float64)
        self.distance = distance
        self._rng = np.random.default_rng(seed)
        self.root = self._build(list(range(self.points.shape[0])))

    def _dist(self, a: int, q) -> float:
        p = self.points[a]
        if self.distance == "cosine":
            num = float(p @ q)
            den = float(np.linalg.norm(p) * np.linalg.norm(q))
            return 1.0 - num / max(den, 1e-12)
        return float(np.linalg.norm(p - q))

    def _build(self, idxs: List[int]) -> Optional[_VPNode]:
        if not idxs:
            return None
        vp = idxs[self._rng.integers(0, len(idxs))]
        idxs = [i for i in idxs if i != vp]
        node = _VPNode(vp)
        if idxs:
            dists = [self._dist(i, self.points[vp]) for i in idxs]
            node.threshold = float(np.median(dists))
            inside = [i for i, dv in zip(idxs, dists) if dv < node.threshold]
            outside = [i for i, dv in zip(idxs, dists) if dv >= node.threshold]
            node.inside = self._build(inside)
            node.outside = self._build(outside)
        return node

    def knn(self, query, k: int) -> List[Tuple[int, float]]:
        q = np.asarray(query, np.float64)
        heap: List[Tuple[float, int]] = []  # max-heap (negated)
        tau = [float("inf")]

        def visit(node: Optional[_VPNode]):
            if node is None:
                return
            d = self._dist(node.idx, q)
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.idx))
                if len(heap) == k:
                    tau[0] = -heap[0][0]
            elif d < tau[0]:
                heapq.heapreplace(heap, (-d, node.idx))
                tau[0] = -heap[0][0]
            if d < node.threshold:
                visit(node.inside)
                if d + tau[0] >= node.threshold:
                    visit(node.outside)
            else:
                visit(node.outside)
                if d - tau[0] <= node.threshold:
                    visit(node.inside)

        visit(self.root)
        return sorted(((i, -nd) for nd, i in heap), key=lambda t: t[1])
