"""Graph structure for vertex-embedding models.

Reference: deeplearning4j-graph — graph/api/{Vertex,Edge,IGraph}.java and the
adjacency-list graph/impl/Graph.java; loaders in data/impl/ (edge-list and
adjacency-list file formats).

Counterpart of ``deeplearning4j_tpu/graph/graph.py``: host code, the same in
the port (the port keeps its own copy; it imports nothing of the JAX
package).
"""
from __future__ import annotations

import dataclasses
from typing import Generic, List, Optional, TypeVar

V = TypeVar("V")

@dataclasses.dataclass
class Vertex(Generic[V]):
    idx: int
    value: Optional[V] = None


@dataclasses.dataclass
class Edge:
    from_idx: int
    to_idx: int
    weight: float = 1.0
    directed: bool = False


class IGraph:
    def num_vertices(self) -> int:
        raise NotImplementedError

    def get_vertex(self, idx: int) -> Vertex:
        raise NotImplementedError

    def get_connected_vertex_indices(self, idx: int) -> List[int]:
        raise NotImplementedError

    def get_edges_out(self, idx: int) -> List[Edge]:
        raise NotImplementedError

    def get_vertex_degree(self, idx: int) -> int:
        return len(self.get_connected_vertex_indices(idx))


class Graph(IGraph):
    """Adjacency-list graph (reference graph/impl/Graph.java)."""

    def __init__(self, num_vertices: int, allow_multiple_edges: bool = True):
        self._vertices = [Vertex(i) for i in range(num_vertices)]
        self._adj: List[List[Edge]] = [[] for _ in range(num_vertices)]
        self.allow_multiple_edges = allow_multiple_edges

    def num_vertices(self) -> int:
        return len(self._vertices)

    def get_vertex(self, idx: int) -> Vertex:
        return self._vertices[idx]

    def set_vertex_value(self, idx: int, value) -> None:
        self._vertices[idx].value = value

    def add_edge(self, from_idx: int, to_idx: int, weight: float = 1.0,
                 directed: bool = False) -> None:
        e = Edge(from_idx, to_idx, weight, directed)
        if not self.allow_multiple_edges and any(
                x.to_idx == to_idx for x in self._adj[from_idx]):
            return
        self._adj[from_idx].append(e)
        if not directed:
            self._adj[to_idx].append(Edge(to_idx, from_idx, weight, directed))

    def get_edges_out(self, idx: int) -> List[Edge]:
        return list(self._adj[idx])

    def get_connected_vertex_indices(self, idx: int) -> List[int]:
        return [e.to_idx for e in self._adj[idx]]

    # ------------------------------------------------------------------ loaders
    @staticmethod
    def load_edge_list(path: str, num_vertices: int, directed: bool = False,
                       delimiter: Optional[str] = None,
                       weighted: bool = False) -> "Graph":
        """Edge-list file: 'from to [weight]' per line
        (reference data/impl/EdgeLineProcessor / GraphLoader.loadUndirectedGraphEdgeListFile)."""
        g = Graph(num_vertices)
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split(delimiter)
                w = float(parts[2]) if weighted and len(parts) > 2 else 1.0
                g.add_edge(int(parts[0]), int(parts[1]), w, directed)
        return g

    @staticmethod
    def load_adjacency_list(path: str, delimiter: Optional[str] = None) -> "Graph":
        """Adjacency-list file: 'vertex n1 n2 n3...' per line (directed edges)."""
        rows = []
        max_v = -1
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                idxs = [int(x) for x in line.split(delimiter)]
                rows.append(idxs)
                max_v = max(max_v, *idxs)
        g = Graph(max_v + 1)
        for row in rows:
            for to in row[1:]:
                g.add_edge(row[0], to, 1.0, directed=True)
        return g
