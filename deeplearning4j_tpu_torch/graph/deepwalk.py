"""DeepWalk vertex embeddings (counterpart: ``deeplearning4j_tpu/graph/
deepwalk.py``; ref: deeplearning4j-graph
org.deeplearning4j.graph.models.deepwalk.DeepWalk + GraphVectorsImpl).

The reference trains hierarchical-softmax skip-gram over walks via its own
GraphHuffman tree, one pair at a time. Here, as in the JAX package, walks
are a (num_walks, L) int32 matrix and training reuses the word2vec
module's batched negative-sampling skip-gram step (``text/word2vec.py``
``_sg_step``) on the model's device; vertex ids are the vocabulary
directly. The host draws what the reference draws, in its order: the
window shrinks of all walks in one call, the pairs built with numpy in
the reference's order (``word2vec.window_pairs``), the shuffle and the
negatives as ``word2vec`` takes them (``shuffle_rows``, ``UnigramDraws``).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import default_device
from deeplearning4j_tpu_torch.graph.graph import Graph
from deeplearning4j_tpu_torch.graph.walker import generate_walks
from deeplearning4j_tpu_torch.text.word2vec import (
    StepRunner, UnigramDraws, _sg_step, shuffle_rows, uniform_table, window_pairs)

_WALK_CHUNK = 4096  # walks turned into pairs at a time (host memory)


class GraphVectors:
    """Learned vertex embeddings (ref: org.deeplearning4j.graph.models.
    GraphVectors: getVertexVector / verticesNearest / similarity)."""

    def __init__(self, vectors: np.ndarray, graph: Graph):
        self.vectors = vectors
        self.graph = graph

    def numVertices(self) -> int:
        return len(self.vectors)

    def getVertexVector(self, v: int) -> np.ndarray:
        return self.vectors[v]

    def similarity(self, a: int, b: int) -> float:
        va, vb = self.vectors[a], self.vectors[b]
        den = np.linalg.norm(va) * np.linalg.norm(vb)
        return float(va @ vb / max(den, 1e-12))

    def verticesNearest(self, v: int, top: int = 5) -> List[int]:
        sims = np.array([self.similarity(v, u) for u in range(len(self.vectors))])
        sims[v] = -np.inf
        return list(np.argsort(-sims)[:top])


def walk_pairs(walks: np.ndarray, window: int, rng) -> np.ndarray:
    """The (center, context) pairs of every walk, int32, in the
    reference's order, with one window shrink a position drawn from
    ``rng`` walk by walk."""
    shrink = rng.integers(1, window + 1, size=walks.size).reshape(walks.shape)
    out = [window_pairs(walks[k:k + _WALK_CHUNK], shrink[k:k + _WALK_CHUNK])
           for k in range(0, len(walks), _WALK_CHUNK)]
    return np.concatenate(out).astype(np.int32) if out else np.zeros((0, 2), np.int32)


class DeepWalk:
    """(ref: DeepWalk.Builder: windowSize/vectorSize/walkLength/learningRate),
    on ``device`` (default ``"cuda"``; without CUDA it raises unless
    ``device="cpu"``)."""

    def __init__(self, vectorSize: int = 64, windowSize: int = 5,
                 walkLength: int = 40, walksPerVertex: int = 10,
                 learningRate: float = 0.025, minLearningRate: float = 1e-4,
                 negativeSample: int = 5, epochs: int = 1,
                 batchSize: int = 512, seed: int = 42, device=None):
        self.device = default_device(device)
        self.vectorSize = vectorSize
        self.windowSize = windowSize
        self.walkLength = walkLength
        self.walksPerVertex = walksPerVertex
        self.learningRate = learningRate
        self.minLearningRate = minLearningRate
        self.negative = max(int(negativeSample), 1)
        self.epochs = epochs
        self.batchSize = batchSize
        self.seed = seed
        self.vectors: Optional[np.ndarray] = None

    def fit(self, graph: Graph) -> GraphVectors:
        rng = np.random.default_rng(self.seed)
        V, D = graph.numVertices(), self.vectorSize
        syn0 = uniform_table(rng, V, D, self.device)
        syn1 = torch.zeros((V, D), dtype=torch.float32, device=self.device)

        # unigram table from vertex degree^0.75 (the degree distribution is
        # the walk-visit distribution's stationary proxy)
        deg = np.array([max(graph.getDegree(v), 1) for v in range(V)], np.float64)
        p = deg ** 0.75
        p /= p.sum()
        negatives = UnigramDraws(p)

        b_eff = min(self.batchSize, max(64, 4 * V))
        run = StepRunner(_sg_step, (syn0, syn1),
                         lambda t: (t[:, 0], t[:, 1], t[:, 2:]), self.device)
        for ep in range(self.epochs):
            walks = generate_walks(graph, self.walkLength, self.walksPerVertex,
                                   seed=self.seed + ep)
            pairs = walk_pairs(walks, self.windowSize, rng)
            pairs = shuffle_rows(rng, pairs)
            nb = max(1, -(-len(pairs) // b_eff))
            for bi, k in enumerate(range(0, len(pairs), b_eff)):
                frac = (ep + bi / nb) / max(self.epochs, 1)
                lr = max(self.minLearningRate, self.learningRate * (1 - frac))
                batch = pairs[k:k + b_eff]
                neg = negatives(rng, (len(batch), self.negative))
                run(np.concatenate([batch, neg], axis=1), lr)
        self.vectors = syn0.cpu().numpy()
        return GraphVectors(self.vectors, graph)
