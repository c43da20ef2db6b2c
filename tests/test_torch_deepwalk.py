"""The port's graph embeddings (``deeplearning4j_tpu_torch/graph``) held
against the JAX package's on the CPU: the random walks exactly equal
(numpy RNG), DeepWalk on two cliques within 1e-4 relative (norm) on the
vertex vectors from the same seed, and the JAX contract
``tests/test_graph_embeddings.py`` on the port: its own assertions, the
port's objects in place of the JAX ones."""
import numpy as np
import pytest

import _torch_port  # noqa: F401  (private JAX executable cache)
from _torch_port import cpu_default, run_on_port

from deeplearning4j_tpu.graph import (DeepWalk as JDeepWalk, Graph as JGraph,
                                      RandomWalkIterator as JWalks,
                                      WeightedRandomWalkIterator as JWeighted)
from deeplearning4j_tpu_torch.graph import (
    DeepWalk, Graph, RandomWalkIterator, WeightedRandomWalkIterator)
from deeplearning4j_tpu_torch.nlp import lookup, sequencevectors

#: DeepWalk against JAX's, ||port - jax|| / ||jax|| of the vertex vectors
FIT_TOL = 1e-4


def _cliques(cls, k=6):
    g = cls(2 * k)
    for a in range(k):
        for b in range(a + 1, k):
            g.add_edge(a, b, weight=1.0 + a + b)
            g.add_edge(k + a, k + b, weight=1.0)
    g.add_edge(0, k)
    return g


@pytest.mark.parametrize("weighted", [False, True])
def test_walks_equal_jax(weighted):
    mine_cls, their_cls = ((WeightedRandomWalkIterator, JWeighted) if weighted
                           else (RandomWalkIterator, JWalks))
    mine = mine_cls(_cliques(Graph), 12, seed=4)
    theirs = their_cls(_cliques(JGraph), 12, seed=4)
    for _ in range(2):
        assert list(mine) == list(theirs)
    mine.reset()
    theirs.reset()
    assert list(mine) == list(theirs)


def test_deepwalk_matches_jax():
    kw = dict(vector_size=12, window_size=3, learning_rate=0.05, epochs=2,
              seed=11)
    theirs = JDeepWalk(**kw)
    theirs.fit(_cliques(JGraph), walk_length=10, walks_per_vertex=2)
    mine = DeepWalk(device="cpu", **kw)
    mine.fit(_cliques(Graph), walk_length=10, walks_per_vertex=2)
    assert mine.model.vocab.words() == theirs.model.vocab.words()
    got = mine.model.lookup.syn0.numpy().astype(np.float64)
    want = np.asarray(theirs.model.lookup.syn0, np.float64)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= FIT_TOL
    assert mine.vertices_nearest(1, 4) == theirs.vertices_nearest(1, 4)


CONTRACTS = ["test_graph_structure", "test_edge_list_loader",
             "test_adjacency_list_loader", "test_random_walks_stay_on_edges",
             "test_disconnected_vertex_handling",
             "test_weighted_walks_follow_weights",
             "test_deepwalk_embeds_cliques"]


@pytest.mark.parametrize("name", CONTRACTS)
def test_jax_contract_holds_on_port(name, monkeypatch, tmp_path):
    cpu_default(monkeypatch, sequencevectors, lookup)
    kw = {"tmp_path": tmp_path} if "loader" in name else {}
    run_on_port("test_graph_embeddings", name, monkeypatch,
                ["deeplearning4j_tpu.graph", "deeplearning4j_tpu.nlp"], **kw)
