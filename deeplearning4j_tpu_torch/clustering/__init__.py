"""Clustering and nearest-neighbor structures.

Counterpart of ``deeplearning4j_tpu/clustering``: k-means on the device
(``device=None`` means CUDA), and the host trees (KD, vantage-point and
space-partitioning) as the same numpy code as the JAX package's.
"""
from .kdtree import KDTree
from .kmeans import ClusterSet, KMeansClustering
from .quadtree import QuadTree, SPTree
from .vptree import VPTree

__all__ = ["KMeansClustering", "ClusterSet", "KDTree", "VPTree", "QuadTree",
           "SPTree"]
