"""Graph embeddings: the graph, random walks and DeepWalk (counterpart of
``deeplearning4j_tpu/graph``)."""
from .deepwalk import DeepWalk
from .graph import Edge, Graph, Vertex
from .walkers import RandomWalkIterator, WeightedRandomWalkIterator

__all__ = ["Graph", "Vertex", "Edge", "RandomWalkIterator",
           "WeightedRandomWalkIterator", "DeepWalk"]
