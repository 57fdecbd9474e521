"""Graph structure (counterpart: ``deeplearning4j_tpu/graph/graph.py``, copied;
ref: deeplearning4j-graph org.deeplearning4j.graph.graph.
Graph + api.Vertex/Edge — a simple indexed adjacency structure feeding random
walks; vertices are integer ids with optional labels)."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class Graph:
    def __init__(self, num_vertices: int, directed: bool = False,
                 labels: Optional[Sequence[str]] = None):
        self.n = num_vertices
        self.directed = directed
        self.labels = list(labels) if labels else [str(i) for i in range(num_vertices)]
        self._adj: List[List[int]] = [[] for _ in range(num_vertices)]
        self._w: List[List[float]] = [[] for _ in range(num_vertices)]

    # ------------------------------------------------------------- building
    def addEdge(self, a: int, b: int, weight: float = 1.0):
        self._adj[a].append(b)
        self._w[a].append(weight)
        if not self.directed:
            self._adj[b].append(a)
            self._w[b].append(weight)

    @staticmethod
    def fromEdgeList(edges: Sequence[Tuple[int, int]], num_vertices=None,
                     directed=False) -> "Graph":
        n = num_vertices or (max(max(a, b) for a, b in edges) + 1)
        g = Graph(n, directed=directed)
        for a, b in edges:
            g.addEdge(a, b)
        return g

    # -------------------------------------------------------------- queries
    def numVertices(self) -> int:
        return self.n

    def getDegree(self, v: int) -> int:
        return len(self._adj[v])

    def getConnectedVertices(self, v: int) -> List[int]:
        return list(self._adj[v])

    def neighbors_arrays(self):
        """Padded neighbor matrix + degree vector for vectorized walking:
        (N, max_deg) int32 with self-loops padding isolated rows."""
        max_deg = max(1, max(len(a) for a in self._adj))
        nbr = np.zeros((self.n, max_deg), np.int32)
        deg = np.zeros(self.n, np.int32)
        for v, a in enumerate(self._adj):
            deg[v] = len(a)
            if a:
                nbr[v, :len(a)] = a
            else:
                nbr[v, :] = v  # isolated: walk stays in place
        return nbr, np.maximum(deg, 1)
