"""The port's clustering and t-SNE held against the JAX package on the CPU,
on ``tests/test_clustering_tsne.py``'s data.

- the host trees (KD, vantage-point, space-partitioning) are the same numpy
  code: the same neighbours and distances, forces and Z within 1e-12;
- k-means++ seeding keeps a running minimum where the JAX package
  recomputes every center's distances: its picks are the same, bitwise;
- k-means: the same iteration count and assignments, centers within 1e-5,
  inertia within 1e-5 relative (the JAX package's centroid product is
  XLA's dot, the port's ``torch.matmul``);
- exact t-SNE: ``P`` within 1e-9 relative, coordinates after 1-3
  iterations within 1e-5 (t-SNE is chaotic: float32 sums in another order
  part the two runs by about 1e-3 after 10 iterations, so nothing later is
  compared), and the JAX contracts (separation after 250 iterations);
- Barnes-Hut: the host loop bitwise at 120 points (tolerance 0: both are
  the same float64 numpy code), its exact route below 64 points on the
  port's :class:`Tsne` (within 1e-5 of JAX's after 2 iterations; on these
  45 points the third already parts the runs by 1.05e-5).
"""
import numpy as np
import pytest
import torch

from _torch_port import cpu_default, run_on_port
from deeplearning4j_tpu.clustering import (
    KDTree as JaxKDTree, KMeansClustering as JaxKMeans, SPTree as JaxSPTree,
    VPTree as JaxVPTree,
)
from deeplearning4j_tpu.clustering.kmeans import (
    _plus_plus_init as jax_plus_plus,
)
from deeplearning4j_tpu.plot import BarnesHutTsne as JaxBarnesHut
from deeplearning4j_tpu.plot import Tsne as JaxTsne
from deeplearning4j_tpu.plot import tsne as jax_tsne
from deeplearning4j_tpu_torch.clustering import (
    KDTree, KMeansClustering, QuadTree, SPTree, VPTree, kmeans,
)
from deeplearning4j_tpu_torch.clustering.kmeans import _plus_plus_init
from deeplearning4j_tpu_torch.plot import BarnesHutTsne, Tsne, tsne
from test_clustering_tsne import _blobs


def _jax_P(x, perplexity):
    """The JAX ``Tsne.fit_transform``'s affinities, by its own helper."""
    n = x.shape[0]
    d2 = ((x[:, None] - x[None]) ** 2).sum(-1)
    P = jax_tsne._binary_search_betas(d2, min(perplexity, (n - 1) / 3))
    return np.maximum((P + P.T) / (2 * n), 1e-12)


# ------------------------------------------------------------- host trees
@pytest.mark.parametrize("tree", ["kdtree", "vptree"])
def test_knn_trees_match_jax(tree):
    seed, n, d, k = (7, 200, 5, 4) if tree == "kdtree" else (8, 150, 4, 5)
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, d))
    ours, ref = ((KDTree(pts), JaxKDTree(pts)) if tree == "kdtree"
                 else (VPTree(pts), JaxVPTree(pts)))
    for _ in range(10):
        q = rng.normal(size=d)
        assert ours.knn(q, k) == ref.knn(q, k)
    if tree == "vptree":
        cos = VPTree(pts, distance="cosine", seed=3)
        assert cos.knn(pts[0], 6) == JaxVPTree(pts, distance="cosine",
                                               seed=3).knn(pts[0], 6)


@pytest.mark.parametrize("theta", [0.0, 0.5])
def test_sptree_forces_match_jax(theta):
    y = np.random.default_rng(9).normal(size=(40, 2))
    got, want = np.zeros_like(y), np.zeros_like(y)
    ours, ref = QuadTree(y), JaxSPTree(y)
    z = sum(ours.compute_non_edge_forces(i, theta, got[i]) for i in range(40))
    zj = sum(ref.compute_non_edge_forces(i, theta, want[i])
             for i in range(40))
    assert abs(z - zj) <= 1e-12 * abs(zj)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert isinstance(ours, SPTree)
    with pytest.raises(ValueError):
        QuadTree(np.zeros((3, 3)))


# ---------------------------------------------------------------- k-means
@pytest.mark.parametrize("n_per,k,d,seed", [(20, 3, 3, 1), (50, 3, 3, 4),
                                            (100, 12, 100, 7)])
def test_plus_plus_init_bitwise(n_per, k, d, seed):
    if d == 3:
        x = _blobs(n_per)[0].astype(np.float32)
    else:
        x = np.random.default_rng(seed).normal(size=(n_per * 3, d)).astype(
            np.float32)
    got = _plus_plus_init(x, k, np.random.default_rng(seed))
    want = jax_plus_plus(x, k, np.random.default_rng(seed))
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("distance", ["euclidean", "manhattan"])
def test_kmeans_distances_by_blocks_of_rows(distance, monkeypatch):
    """The CPU's blocks of rows give the whole difference's distances."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(50, 6)).astype(np.float32))
    c = x[:4] + 0.5
    km = KMeansClustering(4, distance=distance, device="cpu")
    monkeypatch.setattr(kmeans, "_CPU_BLOCK", 7 * 4 * 6)
    diff = x[:, None, :] - c[None]
    want = (diff ** 2 if distance == "euclidean" else diff.abs()).sum(
        -1, dtype=torch.float64).float()
    assert torch.equal(km._distances(x, c), want)


@pytest.mark.parametrize("distance", ["euclidean", "manhattan", "cosine"])
def test_kmeans_matches_jax(distance):
    for n_per, seed in ((20, 1), (50, 4)):
        pts = _blobs(n_per)[0]
        ref = JaxKMeans.setup(3, 30, distance=distance,
                              seed=seed).apply_to(pts)
        km = KMeansClustering.setup(3, 30, distance=distance, seed=seed,
                                    device="cpu")
        cs = km.apply_to(pts)
        assert cs.iterations == int(ref.iterations)
        assert cs.centers.device.type == "cpu"
        np.testing.assert_array_equal(cs.assignments.numpy(),
                                      np.asarray(ref.assignments))
        np.testing.assert_allclose(cs.centers.numpy(),
                                   np.asarray(ref.centers), rtol=0, atol=1e-5)
        assert abs(float(cs.inertia) - float(ref.inertia)) \
            <= 1e-5 * abs(float(ref.inertia))
        pred = km.predict(cs, pts[::7])
        assert isinstance(pred, np.ndarray)
        np.testing.assert_array_equal(
            pred, JaxKMeans.setup(3, 30, distance=distance,
                                  seed=seed).predict(ref, pts[::7]))


# ------------------------------------------------------------------ t-SNE
def test_tsne_affinities_match_jax(monkeypatch):
    x = _blobs(30, seed=3)[0]
    want = _jax_P(x, 10)
    got = tsne.joint_probabilities(x, 10, device="cpu")
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=0)
    # a perplexity above (n - 1) / 3 is capped as in JAX
    np.testing.assert_allclose(
        tsne.joint_probabilities(x[:30], 50, device="cpu").numpy(),
        _jax_P(x[:30], 50), rtol=1e-9, atol=0)
    # the distances a block of rows at a time equal the whole difference
    monkeypatch.setattr(tsne, "_BLOCK_ELEMENTS", 7 * 90 * 3)
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(
        tsne.pairwise_sq_distances(xt).numpy(),
        ((xt[:, None] - xt[None]) ** 2).sum(-1).numpy())


@pytest.mark.parametrize("iters", [1, 2, 3])
def test_tsne_first_iterations_match_jax(iters):
    pts = _blobs(30, seed=3)[0]
    want = JaxTsne(perplexity=10, max_iter=iters, seed=5).fit_transform(pts)
    got = Tsne(perplexity=10, max_iter=iters, seed=5,
               device="cpu").fit_transform(pts)
    assert got.dtype == np.float32 and got.shape == (90, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_tsne_kl_divergence():
    pts, labels = _blobs(30, seed=3)
    ts = Tsne(perplexity=10, max_iter=250, seed=5, device="cpu")
    emb = ts.fit_transform(pts)
    P = ts.P.numpy()
    d2 = ((emb[:, None].astype(np.float64) - emb[None]) ** 2).sum(-1)
    num = 1.0 / (1.0 + d2)
    np.fill_diagonal(num, 0.0)
    Q = num / num.sum()
    off = ~np.eye(len(P), dtype=bool)
    want = float((P[off] * np.log(P[off] / Q[off])).sum())
    assert tsne.kl_divergence(ts.P, emb) == pytest.approx(want, rel=1e-12)
    early = Tsne(perplexity=10, max_iter=100, seed=5,
                 device="cpu").fit_transform(pts)
    assert 0 < want < tsne.kl_divergence(ts.P, early)
    # the callback sees each step's y: at 100 the 100-iteration fit's
    seen = {}
    ts.fit_transform(pts, callback=lambda it, y: seen.setdefault(
        it, y.clone()) if it in (1, 100) else None)
    assert sorted(seen) == [1, 100]
    np.testing.assert_array_equal(seen[100].numpy(), early)


def test_barnes_hut_matches_jax():
    pts = _blobs(40, seed=6)[0]
    want = (JaxBarnesHut.builder().theta(0.5).perplexity(10)
            .set_max_iter(50).seed(2).build().fit(pts))
    bh = (BarnesHutTsne.builder().theta(0.5).perplexity(10).set_max_iter(50)
          .seed(2).device("cpu").build())
    got = bh.fit(pts)
    assert got.shape == (120, 2) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    assert bh.embedding is got


def test_barnes_hut_exact_route_below_64_points():
    pts = _blobs(15, seed=6)[0]           # 45 points: the exact route
    want = JaxBarnesHut(perplexity=10, max_iter=2, seed=2).fit(pts)
    got = BarnesHutTsne(perplexity=10, max_iter=2, seed=2,
                        device="cpu").fit(pts)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        got, Tsne(perplexity=10, max_iter=2, seed=2,
                  device="cpu").fit_transform(pts))
    # theta <= 0 takes it at any size
    big = _blobs(25, seed=6)[0]
    np.testing.assert_array_equal(
        BarnesHutTsne(theta=0.0, perplexity=10, max_iter=2, seed=2,
                      device="cpu").fit(big),
        Tsne(perplexity=10, max_iter=2, seed=2,
             device="cpu").fit_transform(big))


CONTRACTS = ["test_kmeans_recovers_blobs", "test_kmeans_distances",
             "test_kdtree_matches_bruteforce", "test_vptree_matches_bruteforce",
             "test_sptree_forces_match_exact", "test_tsne_separates_clusters",
             "test_barnes_hut_tsne_separates_clusters"]


@pytest.mark.parametrize("name", CONTRACTS)
def test_jax_contract_holds_on_port(name, monkeypatch):
    cpu_default(monkeypatch, kmeans, tsne)
    run_on_port("test_clustering_tsne", name, monkeypatch,
                ["deeplearning4j_tpu.clustering", "deeplearning4j_tpu.plot"])


def test_default_device_raises_without_cuda(monkeypatch):
    """``device=None`` means CUDA: with none, every device entry point
    raises, and nothing runs on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = _blobs(15)[0]
    for call in (lambda: KMeansClustering(3).apply_to(pts),
                 lambda: KMeansClustering.setup(3).apply_to(pts),
                 lambda: Tsne(max_iter=1).fit_transform(pts),
                 lambda: tsne.joint_probabilities(pts, 10),
                 lambda: BarnesHutTsne(max_iter=1).fit(pts)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
