"""The port's graph embeddings (``deeplearning4j_tpu_torch/graph``) held
against the JAX package's on the CPU, on ``tests/test_graph_embeddings.py``'s
graphs.

- ``Graph`` and the walker are copies: the same adjacency, padded
  neighbour arrays and walks, exactly.
- The pairs of a fit's walks equal the reference's pair loop's, and leave
  the generator where it leaves it.
- ``DeepWalk`` vectors within ``FIT_TOL`` of the reference's largest
  |value|, with the same nearest vertices: every batch is the
  reference's, so only float rounding separates the tables (a few ulps a
  step over the fit's steps).
- ``DeepWalk``'s ``device`` default raises without CUDA.
"""
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.graph as R
import deeplearning4j_tpu_torch.graph as P
import deeplearning4j_tpu_torch.graph.deepwalk as PD
import test_graph_embeddings as RT
from torch_threads import one_torch_thread  # noqa: F401

FIT_TOL = 1e-5


def two_communities(m, n_per=8, inter_edges=1, seed=0):
    """``test_graph_embeddings.two_communities`` through package ``m``'s
    ``Graph``: the same edges in the same order."""
    rng = np.random.default_rng(seed)
    g = m.Graph(2 * n_per)
    for base in (0, n_per):
        for i in range(n_per):
            for j in range(i + 1, n_per):
                if rng.random() < 0.8:
                    g.addEdge(base + i, base + j)
    for _ in range(inter_edges):
        g.addEdge(0, n_per)
    return g


def _isolated(m):
    g = m.Graph(3)
    g.addEdge(0, 1)
    return g


GRAPHS = {
    "two_communities": lambda m: two_communities(m, n_per=8),
    "small_communities": lambda m: two_communities(m, n_per=4),
    "cycle": lambda m: m.Graph.fromEdgeList([(0, 1), (1, 2), (2, 3), (3, 0)]),
    "isolated": _isolated,
}


def test_structure_equal():
    for make in (lambda m: m.Graph.fromEdgeList([(0, 1), (1, 2), (2, 0), (2, 3)]),
                 lambda m: m.Graph(3, directed=True)):
        r, p = make(R), make(P)
        if r.directed:
            r.addEdge(0, 1)
            p.addEdge(0, 1)
        assert p.numVertices() == r.numVertices()
        for v in range(r.numVertices()):
            assert p.getDegree(v) == r.getDegree(v)
            assert p.getConnectedVertices(v) == r.getConnectedVertices(v)
    for name, make in GRAPHS.items():
        ref, port = make(R), make(P)
        assert port.labels == ref.labels
        for a, b in zip(port.neighbors_arrays(), ref.neighbors_arrays()):
            assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_walks_equal(name):
    ref, port = GRAPHS[name](R), GRAPHS[name](P)
    for L, per, seed in ((10, 3, 1), (5, 2, 0), (20, 8, 3)):
        want = R.generate_walks(ref, L, walks_per_vertex=per, seed=seed)
        got = P.generate_walks(port, L, walks_per_vertex=per, seed=seed)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    starts = np.array([0, 2, 2, 1], np.int32)
    assert np.array_equal(P.generate_walks(port, 6, seed=4, starts=starts),
                          R.generate_walks(ref, 6, seed=4, starts=starts))
    got = list(P.RandomWalkIterator(port, walk_length=4, seed=0))
    want = list(R.RandomWalkIterator(ref, walk_length=4, seed=0))
    assert len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))


def _reference_walk_pairs(walks, window, rng):
    """``DeepWalk.fit``'s pair loop, the oracle."""
    pairs = []
    for walk in walks:
        for i, c in enumerate(walk):
            b = rng.integers(1, window + 1)
            lo, hi = max(0, i - b), min(len(walk), i + b + 1)
            for j in range(lo, hi):
                if j != i:
                    pairs.append((c, walk[j]))
    return np.asarray(pairs, dtype=np.int32)


@pytest.mark.parametrize("window,chunk", [(4, 4096), (10, 7)])
def test_walk_pairs_equal_the_reference_loop(monkeypatch, window, chunk):
    monkeypatch.setattr(PD, "_WALK_CHUNK", chunk)
    walks = R.generate_walks(RT.two_communities(), 12, walks_per_vertex=3, seed=2)
    for a, b in zip(two_communities(R).neighbors_arrays(),
                    RT.two_communities().neighbors_arrays()):
        assert np.array_equal(a, b)                 # the reference test's graph
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    want = _reference_walk_pairs(walks, window, r1)
    got = PD.walk_pairs(walks, window, r2)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert r1.random() == r2.random()


DW_CASES = {
    "communities": ("two_communities", dict(vectorSize=16, windowSize=4, walkLength=20,
                                            walksPerVertex=8, epochs=3, seed=3)),
    "vector_api": ("small_communities", dict(vectorSize=8, walkLength=10,
                                             walksPerVertex=4, epochs=1)),
    "isolated": ("isolated", dict(vectorSize=8, walkLength=6, walksPerVertex=2,
                                  epochs=2, batchSize=16, seed=1)),
}


@pytest.mark.parametrize("case", sorted(DW_CASES))
def test_deepwalk_fit(case):
    name, kw = DW_CASES[case]
    ref = R.DeepWalk(**kw).fit(GRAPHS[name](R))
    port = P.DeepWalk(device="cpu", **kw).fit(GRAPHS[name](P))
    assert port.numVertices() == ref.numVertices()
    err = np.abs(port.vectors.astype(np.float64) - ref.vectors).max()
    assert err <= FIT_TOL * np.abs(ref.vectors).max(), err
    for v in range(min(4, ref.numVertices())):
        assert port.similarity(v, 0) == pytest.approx(ref.similarity(v, 0), abs=1e-4)
    if case == "communities":
        assert port.verticesNearest(3, top=4) == ref.verticesNearest(3, top=4)
    assert np.array_equal(port.getVertexVector(1), port.vectors[1])


def test_device_default_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.DeepWalk()
