"""KMeans clustering.

Reference: deeplearning4j-core clustering/kmeans/KMeansClustering.java (+
clustering/algorithm/BaseClusteringAlgorithm: max iterations /
distance-variation convergence).

Counterpart of ``deeplearning4j_tpu/clustering/kmeans.py``. k-means++
seeding runs on the host with the JAX package's ``rng`` draws, keeping a
running minimum of the distances to the centers chosen so far (one new
center's distances a pick instead of all of them), so its picks are the
JAX package's bit for bit. Lloyd's iterations run on ``device`` (``None``
means CUDA) in plain PyTorch, in the JAX program's forms: euclidean and
manhattan distances as broadcast differences ``(rows, k, d)``, a block
of rows at a time (so argmins agree at near-ties), cosine as a product of normalized rows, the centroid
update as a one-hot product. Every sum accumulates in float64 and rounds
to float32, so its value does not hang on the order a device sums in: the
card and the CPU give the same distances, argmins and centers (the JAX
package's float32 sums differ from them by an ulp or so). The convergence
test (``moved > tol``) reads one float from the device an iteration, where
the JAX package keeps its ``lax.while_loop`` on the device; the iteration
count is the same.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..common import resolve_device

DISTANCES = ("euclidean", "cosine", "manhattan")
#: float32 elements of one block of the ``(rows, k, d)`` difference
_CPU_BLOCK, _CUDA_BLOCK = 1 << 21, 1 << 28


class ClusterSet(NamedTuple):
    centers: torch.Tensor       # (k, d), on the fit's device
    assignments: torch.Tensor   # (n,) int64
    iterations: int
    inertia: torch.Tensor       # () float32


def _sum(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t.sum(dim)`` accumulated in float64, rounded to float32."""
    return t.sum(dim, dtype=torch.float64).float()


def _norm(t: torch.Tensor) -> torch.Tensor:
    """Row norms ``(n, 1)`` from a float64 sum of squares."""
    return (t.double() ** 2).sum(1, keepdim=True).sqrt().float()


def _plus_plus_init(x: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    """k-means++ seeding: each pick draws a point with probability
    proportional to its squared distance to the nearest chosen center."""
    n = x.shape[0]
    centers = [x[rng.integers(0, n)]]
    d2 = None
    for _ in range(1, k):
        new = ((x - centers[-1]) ** 2).sum(-1)
        d2 = new if d2 is None else np.minimum(d2, new)
        probs = d2 / max(d2.sum(), 1e-12)
        centers.append(x[rng.choice(n, p=probs)])
    return np.stack(centers)


class KMeansClustering:
    def __init__(self, k: int, max_iterations: int = 100, tol: float = 1e-4,
                 seed: int = 0, distance: str = "euclidean", device=None):
        if distance not in DISTANCES:
            raise ValueError(f"Unknown distance: {distance}")
        self.k = k
        self.max_iterations = max_iterations
        self.tol = tol
        self.seed = seed
        self.distance = distance
        self.device = device

    @staticmethod
    def setup(k: int, max_iterations: int = 100, distance: str = "euclidean",
              seed: int = 0, device=None) -> "KMeansClustering":
        """reference KMeansClustering.setup(clusterCount, maxIterations, distanceFunction)"""
        return KMeansClustering(k, max_iterations, distance=distance, seed=seed,
                                device=device)

    def _distances(self, x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
        if self.distance in ("euclidean", "manhattan"):
            # a block of rows at a time: the CPU streams the difference
            # through its caches, the card takes up to 1 GiB at once
            n, k = x.shape[0], centers.shape[0]
            cap = _CPU_BLOCK if x.device.type == "cpu" else _CUDA_BLOCK
            rows = max(1, cap // max(1, k * x.shape[1]))
            out = torch.empty((n, k), dtype=x.dtype, device=x.device)
            for i in range(0, n, rows):
                diff = x[i:i + rows, None, :] - centers[None]
                out[i:i + rows] = _sum(diff ** 2 if self.distance ==
                                       "euclidean" else diff.abs(), -1)
            return out
        xn = x / _norm(x).clamp_min(1e-12)
        cn = centers / _norm(centers).clamp_min(1e-12)
        return 1.0 - (xn.double() @ cn.double().T).float()

    @torch.no_grad()
    def apply_to(self, points) -> ClusterSet:
        """Cluster ``points`` (``(n, d)``); the set's tensors stay on the
        device."""
        dev = resolve_device(self.device)
        x_np = np.asarray(points, np.float32)
        init = _plus_plus_init(x_np, self.k, np.random.default_rng(self.seed))
        x = torch.from_numpy(x_np).to(dev)
        centers = torch.from_numpy(init).to(dev)
        tol = np.float32(self.tol)

        def assign(c):
            return torch.argmin(self._distances(x, c), dim=1)

        it, moved = 0, np.float32(np.inf)
        while it < self.max_iterations and moved > tol:
            onehot = torch.nn.functional.one_hot(assign(centers),
                                                 self.k).to(x.dtype)
            sums = (onehot.double().T @ x.double()).float()
            counts = onehot.sum(0)[:, None]
            new = torch.where(counts > 0, sums / counts.clamp_min(1), 0.0)
            # the loop's one host read: the largest move of a center
            moved = np.float32((new - centers).abs().max().item())
            centers = new
            it += 1
        d = self._distances(x, centers)
        return ClusterSet(centers, torch.argmin(d, dim=1), it,
                          _sum(d.min(dim=1).values, 0))

    @torch.no_grad()
    def predict(self, cluster_set: ClusterSet, points) -> np.ndarray:
        """Nearest center of each point (numpy), on the set's device."""
        c = cluster_set.centers
        x = torch.from_numpy(np.asarray(points, np.float32)).to(c.device)
        return torch.argmin(self._distances(x, c), dim=1).cpu().numpy()
