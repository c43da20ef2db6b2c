"""Quad/SP-trees for Barnes-Hut approximation.

Reference: deeplearning4j-core clustering/quadtree/QuadTree.java (2-D) and
clustering/sptree/SpTree.java (n-D generalization with center-of-mass per cell,
used by BarnesHutTsne's repulsive-force approximation).

Counterpart of ``deeplearning4j_tpu/clustering/quadtree.py``: the same host
numpy code, so it builds the same tree and answers the same queries.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


class SPTree:
    """n-dimensional space-partitioning tree storing center-of-mass per cell."""

    def __init__(self, data: np.ndarray, center: Optional[np.ndarray] = None,
                 width: Optional[np.ndarray] = None, indices: Optional[List[int]] = None,
                 leaf_capacity: int = 1, _depth: int = 0):
        self.data = data
        d = data.shape[1]
        if center is None:
            lo, hi = data.min(0), data.max(0)
            center = (lo + hi) / 2
            width = np.maximum((hi - lo) / 2 + 1e-5, 1e-5)
            indices = list(range(data.shape[0]))
        self.center = center
        self.width = width
        self.cum_size = len(indices)
        self.children: List[Optional[SPTree]] = []
        self.point_indices: List[int] = []
        if self.cum_size > 0:
            pts = data[indices]
            self.center_of_mass = pts.mean(0)
        else:
            self.center_of_mass = np.zeros(d)
        # subdivision: stop at capacity, identical points, or excessive depth
        if (self.cum_size <= leaf_capacity or _depth > 48
                or np.allclose(data[indices].std(0), 0)):
            self.point_indices = list(indices)
            return
        n_child = 2 ** d
        buckets: List[List[int]] = [[] for _ in range(n_child)]
        for i in indices:
            code = 0
            for dim in range(d):
                if data[i, dim] > center[dim]:
                    code |= 1 << dim
            buckets[code].append(i)
        for code in range(n_child):
            if not buckets[code]:
                self.children.append(None)
                continue
            offset = np.array([(1 if code >> dim & 1 else -1)
                               for dim in range(d)], np.float64)
            self.children.append(SPTree(
                data, center + offset * self.width / 2, self.width / 2,
                buckets[code], leaf_capacity, _depth + 1))

    def is_leaf(self) -> bool:
        return not self.children

    def compute_non_edge_forces(self, point_index: int, theta: float,
                                neg_f: np.ndarray) -> float:
        """Barnes-Hut negative-force accumulation for one point; returns the
        contribution to Z (sum of q_ij numerators). reference
        SpTree.computeNonEdgeForces."""
        if self.cum_size == 0:
            return 0.0
        if self.is_leaf() and self.point_indices == [point_index]:
            return 0.0
        diff = self.data[point_index] - self.center_of_mass
        dist2 = float(diff @ diff)
        max_width = float(self.width.max())
        if self.is_leaf() or max_width / np.sqrt(max(dist2, 1e-12)) < theta:
            # treat cell as single point at center of mass
            size = self.cum_size
            if (self.is_leaf() and point_index in self.point_indices):
                size -= 1
            if size <= 0:
                return 0.0
            q = 1.0 / (1.0 + dist2)
            mult = size * q
            neg_f += mult * q * diff
            return mult
        z = 0.0
        for child in self.children:
            if child is not None:
                z += child.compute_non_edge_forces(point_index, theta, neg_f)
        return z


class QuadTree(SPTree):
    """2-D specialization (reference clustering/quadtree/QuadTree.java)."""

    def __init__(self, data: np.ndarray, **kwargs):
        data = np.asarray(data, np.float64)
        if data.shape[1] != 2:
            raise ValueError("QuadTree requires 2-D data; use SPTree for n-D")
        super().__init__(data, **kwargs)
