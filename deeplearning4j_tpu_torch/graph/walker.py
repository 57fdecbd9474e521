"""Random-walk generation (counterpart: ``deeplearning4j_tpu/graph/
walker.py``, copied; ref: deeplearning4j-graph
org.deeplearning4j.graph.iterator.RandomWalkIterator).

The reference walks one vertex at a time through Java iterators; here ALL
walks advance together as one vectorized numpy step per depth level
(gather neighbor rows, sample a column) — the batch shape the batched
skip-gram trainer wants anyway.
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from deeplearning4j_tpu_torch.graph.graph import Graph


def generate_walks(graph: Graph, walk_length: int, walks_per_vertex: int = 1,
                   seed: int = 0, starts: Optional[np.ndarray] = None) -> np.ndarray:
    """(num_walks, walk_length) int32 vertex-id matrix; every vertex starts
    ``walks_per_vertex`` walks (ref: DeepWalk.fit iterates a
    RandomWalkIterator per vertex)."""
    rng = np.random.default_rng(seed)
    nbr, deg = graph.neighbors_arrays()
    if starts is None:
        starts = np.repeat(np.arange(graph.n, dtype=np.int32), walks_per_vertex)
        rng.shuffle(starts)
    walks = np.empty((len(starts), walk_length), np.int32)
    walks[:, 0] = starts
    cur = starts
    for t in range(1, walk_length):
        # uniform neighbor choice: col ~ U[0, deg(v))
        col = (rng.random(len(cur)) * deg[cur]).astype(np.int64)
        cur = nbr[cur, col]
        walks[:, t] = cur
    return walks


class RandomWalkIterator:
    """Iterator facade over generate_walks (ref: RandomWalkIterator —
    kept for API parity; prefer generate_walks for bulk use)."""

    def __init__(self, graph: Graph, walk_length: int, seed: int = 0):
        self.graph = graph
        self.walk_length = walk_length
        self.seed = seed
        self._walks = None
        self._i = 0

    def __iter__(self) -> Iterator[np.ndarray]:
        self._walks = generate_walks(self.graph, self.walk_length, 1, self.seed)
        self._i = 0
        return self

    def __next__(self) -> np.ndarray:
        if self._walks is None or self._i >= len(self._walks):
            raise StopIteration
        w = self._walks[self._i]
        self._i += 1
        return w
