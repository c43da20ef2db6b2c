"""t-SNE embedding.

Reference: deeplearning4j-core plot/Tsne.java (exact) + plot/BarnesHutTsne.java:64
(theta-approximated, VPTree input neighbors + SpTree repulsive forces).

Counterpart of ``deeplearning4j_tpu/plot/tsne.py``. The exact variant runs
on ``device`` (``None`` means CUDA) in plain PyTorch:

- the input distances in float64, in the JAX package's difference form
  ``((x_i - x_j) ** 2).sum()``, a block of rows at a time (the whole
  ``(n, n, D)`` difference is 80 GB at n 10,000, D 100); never the
  expansion ``|x|^2 + |y|^2 - 2 x.y``, which cancels;
- the perplexity search for every row at once in float64, each row's
  bisection in lockstep with the others under a per-row done mask, with the
  JAX loop's rules (doubling, halving, midpoints, ``tol``, 50 tries); the
  self term is dropped by zeroing its ``p`` (its distance is exactly 0);
- the gradient loop in float32, as the JAX package runs it with x64 off:
  its step is :func:`tsne_step`, the JAX step's operations in its order,
  with the diagonal of the kernel zeroed in place (the JAX step multiplies
  by ``1 - eye``, bitwise the same).

The Barnes-Hut variant keeps the reference's host-side tree approximation
(numpy, float64, the same code as the JAX package's); below 64 points or at
``theta <= 0`` it runs the exact :class:`Tsne` on ``device``.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..clustering.quadtree import SPTree
from ..clustering.vptree import VPTree
from ..common import resolve_device

#: float64 elements of one block of the ``(rows, n, D)`` difference
_BLOCK_ELEMENTS = 1 << 27


def pairwise_sq_distances(x: torch.Tensor) -> torch.Tensor:
    """``((x[:, None] - x[None]) ** 2).sum(-1)`` for ``x`` ``(n, D)``, a
    block of rows at a time (at most 1 GiB of float64 difference)."""
    n, dim = x.shape
    out = torch.empty((n, n), dtype=x.dtype, device=x.device)
    rows = max(1, _BLOCK_ELEMENTS // max(1, n * dim))
    for i in range(0, n, rows):
        out[i:i + rows] = ((x[i:i + rows, None] - x[None]) ** 2).sum(-1)
    return out


def _binary_search_p(d2: torch.Tensor, perplexity: float, tol: float = 1e-5,
                     max_tries: int = 50) -> torch.Tensor:
    """Per-point precision search so each conditional distribution hits the
    target perplexity (reference Tsne.hBeta loop): every row bisects at
    once; a row whose entropy is within ``tol`` keeps its precision."""
    n = d2.shape[0]
    f64 = dict(dtype=torch.float64, device=d2.device)
    beta = torch.ones(n, **f64)
    beta_min = torch.full((n,), -math.inf, **f64)
    beta_max = torch.full((n,), math.inf, **f64)
    done = torch.zeros(n, dtype=torch.bool, device=d2.device)
    log_u = math.log(perplexity)

    def probs(b):
        p = torch.exp(-d2 * b[:, None])
        return p.fill_diagonal_(0.0)

    for _ in range(max_tries):
        p = probs(beta)
        s = p.sum(1).clamp_min(1e-12)
        h = torch.log(s) + beta * (d2 * p).sum(1) / s
        diff = h - log_u
        done = done | (diff.abs() < tol)
        if bool(done.all()):
            break
        up = ~done & (diff > 0)
        down = ~done & ~(diff > 0)
        raised = torch.where(beta_max == math.inf, beta * 2,
                             (beta + beta_max) / 2)
        lowered = torch.where(beta_min == -math.inf, beta / 2,
                              (beta + beta_min) / 2)
        beta_min = torch.where(up, beta, beta_min)
        beta_max = torch.where(down, beta, beta_max)
        beta = torch.where(up, raised, torch.where(down, lowered, beta))
    p = probs(beta)
    return p / p.sum(1, keepdim=True).clamp_min(1e-12)


def joint_probabilities(x, perplexity: float, device=None) -> torch.Tensor:
    """t-SNE's symmetric input affinities ``P`` (float64, on ``device``)
    for the rows of ``x``; ``perplexity`` is capped at ``(n - 1) / 3``."""
    dev = resolve_device(device)
    xt = torch.as_tensor(np.asarray(x, np.float64)).to(dev)
    n = xt.shape[0]
    P = _binary_search_p(pairwise_sq_distances(xt),
                         min(perplexity, (n - 1) / 3))
    P = (P + P.T) / (2 * n)
    return P.clamp_min(1e-12)


def tsne_step(y, vel, gains, P_eff, mom: float, lr: float):
    """One exact t-SNE gradient step with gains and momentum; returns the
    centred ``y``, ``vel`` and ``gains``."""
    d = y[:, None] - y[None]                       # (n, n, c)
    num = 1.0 / (1.0 + (d ** 2).sum(-1))
    num.fill_diagonal_(0.0)
    Q = (num / num.sum().clamp_min(1e-12)).clamp_min(1e-12)
    PQ = (P_eff - Q) * num                         # (n, n)
    g = 4.0 * torch.einsum("ij,ijc->ic", PQ, d)
    same_sign = (g > 0) == (vel > 0)
    gains = torch.where(same_sign, gains * 0.8, gains + 0.2).clamp_min(0.01)
    vel = mom * vel - lr * gains * g
    y = y + vel
    return y - y.mean(0), vel, gains


def kl_divergence(P: torch.Tensor, y) -> float:
    """KL(P || Q) of an embedding ``y`` under affinities ``P`` (float64,
    over the pairs i != j)."""
    y = torch.as_tensor(y).to(device=P.device, dtype=torch.float64)
    num = 1.0 / (1.0 + pairwise_sq_distances(y))
    num.fill_diagonal_(0.0)
    Q = num / num.sum()
    Q.fill_diagonal_(1.0)
    P = P.to(torch.float64)
    terms = P * torch.log(P / Q)
    return float(terms.fill_diagonal_(0.0).sum())


class Tsne:
    """Exact t-SNE (reference plot/Tsne.java) with the gradient loop on
    ``device``. After a fit, ``P`` holds the joint affinities (float64, on
    the device)."""

    def __init__(self, n_components: int = 2, perplexity: float = 30.0,
                 learning_rate: float = 200.0, max_iter: int = 500,
                 momentum: float = 0.5, final_momentum: float = 0.8,
                 switch_momentum_iteration: int = 250,
                 stop_lying_iteration: int = 100, exaggeration: float = 12.0,
                 seed: int = 42, device=None):
        self.n_components = n_components
        self.perplexity = perplexity
        self.learning_rate = learning_rate
        self.max_iter = max_iter
        self.momentum = momentum
        self.final_momentum = final_momentum
        self.switch_momentum_iteration = switch_momentum_iteration
        self.stop_lying_iteration = stop_lying_iteration
        self.exaggeration = exaggeration
        self.seed = seed
        self.device = device
        self.P: Optional[torch.Tensor] = None

    @torch.no_grad()
    def fit_transform(self, x, callback=None) -> np.ndarray:
        """Embed the rows of ``x``; returns float32 numpy. ``callback``,
        when given, is called as ``callback(iteration, y)`` after each step
        (``iteration`` counts from 1; ``y`` is the device tensor)."""
        dev = resolve_device(self.device)
        x = np.asarray(x, np.float64)
        n = x.shape[0]
        self.P = joint_probabilities(x, self.perplexity, dev)
        P = self.P.to(torch.float32)
        P_lie = P * self.exaggeration
        rng = np.random.default_rng(self.seed)
        y = torch.from_numpy(
            rng.normal(0, 1e-4, (n, self.n_components))).to(
                device=dev, dtype=torch.float32)
        vel = torch.zeros_like(y)
        gains = torch.ones_like(y)
        for it in range(self.max_iter):
            mom = (self.momentum if it < self.switch_momentum_iteration
                   else self.final_momentum)
            P_eff = P_lie if it < self.stop_lying_iteration else P
            y, vel, gains = tsne_step(y, vel, gains, P_eff, mom,
                                      self.learning_rate)
            if callback is not None:
                callback(it + 1, y)
        return y.cpu().numpy()


class BarnesHutTsne:
    """theta-approximated t-SNE (reference plot/BarnesHutTsne.java:64).

    Builder mirrors the reference: setMaxIter, theta, perplexity,
    numDimension, etc. The approximation runs on the host; ``device`` is
    where the exact route (below 64 points, or ``theta <= 0``) runs.
    """

    def __init__(self, n_components: int = 2, theta: float = 0.5,
                 perplexity: float = 30.0, learning_rate: float = 200.0,
                 max_iter: int = 300, seed: int = 42, device=None):
        self.n_components = n_components
        self.theta = theta
        self.perplexity = perplexity
        self.learning_rate = learning_rate
        self.max_iter = max_iter
        self.seed = seed
        self.device = device
        self.embedding: Optional[np.ndarray] = None

    class Builder:
        def __init__(self):
            self._kw = {}

        def theta(self, t: float):
            self._kw["theta"] = t
            return self

        def perplexity(self, p: float):
            self._kw["perplexity"] = p
            return self

        def set_max_iter(self, n: int):
            self._kw["max_iter"] = n
            return self

        def num_dimension(self, d: int):
            self._kw["n_components"] = d
            return self

        def learning_rate(self, lr: float):
            self._kw["learning_rate"] = lr
            return self

        def seed(self, s: int):
            self._kw["seed"] = s
            return self

        def device(self, device):
            self._kw["device"] = device
            return self

        def build(self) -> "BarnesHutTsne":
            return BarnesHutTsne(**self._kw)

    @staticmethod
    def builder() -> "BarnesHutTsne.Builder":
        return BarnesHutTsne.Builder()

    def fit(self, x) -> np.ndarray:
        x = np.asarray(x, np.float64)
        n = x.shape[0]
        if self.theta <= 0 or n < 64:
            self.embedding = Tsne(
                n_components=self.n_components, perplexity=self.perplexity,
                learning_rate=self.learning_rate, max_iter=self.max_iter,
                seed=self.seed, device=self.device).fit_transform(x)
            return self.embedding

        # sparse input similarities from 3*perplexity nearest neighbors (VPTree)
        k = min(n - 1, int(3 * self.perplexity))
        tree = VPTree(x)
        rows, cols, d2 = [], [], []
        for i in range(n):
            nbrs = tree.knn(x[i], k + 1)
            for j, dist in nbrs:
                if j != i:
                    rows.append(i)
                    cols.append(j)
                    d2.append(dist * dist)
        rows = np.array(rows)
        cols = np.array(cols)
        d2 = np.array(d2)
        # per-row beta search on the sparse neighborhoods
        P = np.zeros(len(rows))
        log_u = np.log(min(self.perplexity, k))
        for i in range(n):
            sel = rows == i
            row = d2[sel]
            beta, bmin, bmax = 1.0, -np.inf, np.inf
            for _ in range(50):
                p = np.exp(-row * beta)
                s = max(p.sum(), 1e-12)
                h = np.log(s) + beta * (row * p).sum() / s
                diff = h - log_u
                if abs(diff) < 1e-5:
                    break
                if diff > 0:
                    bmin, beta = beta, (beta * 2 if bmax == np.inf else (beta + bmax) / 2)
                else:
                    bmax, beta = beta, (beta / 2 if bmin == -np.inf else (beta + bmin) / 2)
            p = np.exp(-row * beta)
            P[sel] = p / max(p.sum(), 1e-12)
        # symmetrize sparse P
        sym: dict = {}
        for r, c, v in zip(rows, cols, P):
            sym[(r, c)] = sym.get((r, c), 0.0) + v / (2 * n)
            sym[(c, r)] = sym.get((c, r), 0.0) + v / (2 * n)
        e_rows = np.array([rc[0] for rc in sym])
        e_cols = np.array([rc[1] for rc in sym])
        e_vals = np.array(list(sym.values()))

        rng = np.random.default_rng(self.seed)
        y = rng.normal(0, 1e-4, (n, self.n_components))
        vel = np.zeros_like(y)
        gains = np.ones_like(y)
        for it in range(self.max_iter):
            exag = 12.0 if it < min(100, self.max_iter // 3) else 1.0
            # attractive forces over the sparse edges
            d = y[e_rows] - y[e_cols]
            q_num = 1.0 / (1.0 + (d ** 2).sum(-1))
            w = (exag * e_vals * q_num)[:, None] * d
            pos_f = np.zeros_like(y)
            np.add.at(pos_f, e_rows, w)
            # repulsive forces via SPTree
            stree = SPTree(y)
            neg_f = np.zeros_like(y)
            z = 0.0
            for i in range(n):
                z += stree.compute_non_edge_forces(i, self.theta, neg_f[i])
            grad = pos_f - neg_f / max(z, 1e-12)
            same_sign = (grad > 0) == (vel > 0)
            gains = np.clip(np.where(same_sign, gains * 0.8, gains + 0.2), 0.01, None)
            mom = 0.5 if it < self.max_iter // 2 else 0.8
            vel = mom * vel - self.learning_rate * gains * grad
            y = y + vel
            y -= y.mean(0)
        self.embedding = y
        return y
