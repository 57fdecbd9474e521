"""Recipes of ``chip_smoke.py``'s ``embeddings and rl`` phase, built from a
seed with numpy and the port's API (no ``jax``):

- ``text8_like``: a corpus with text8's vocabulary after word2vec.c's
  min-count 5 (71,290 types, every one at least 5 times), Zipf(1)
  frequencies above that floor, in word2vec.c's 1000-word sentences, with
  planted topic groups (16 groups of 8 words from rank 100 on, ~700
  occurrences a word in 1M tokens): the words of a group occur only
  together, in phrases of the whole group in a random order;
- ``text8_cut``: the same vocabulary once each, shuffled, plus a few
  phrases of each group: the full vocabulary in ~72k tokens;
- ``blogcatalog_like``: an undirected graph of BlogCatalog's size
  (10,312 vertices, 333,983 edges) with power-law degrees (Chung-Lu
  sampling, weights i^-1/2: degree exponent 3, the largest degree a few
  thousand, as BlogCatalog's 3,992);
- the rl4j-examples CartPole networks and the MNIST surrogate's dense
  network for the arbiter search.
"""
from __future__ import annotations

import numpy as np

TEXT8_VOCAB = 71_290      # text8's word types after word2vec.c's min-count 5
MIN_COUNT = 5             # word2vec.c's default min-count
SENTENCE = 1000           # word2vec.c's MAX_SENTENCE_LENGTH
BLOGCATALOG = (10_312, 333_983)


def synthetic_words(n: int, rng) -> list:
    """``n`` distinct lowercase words, lengths 2-16 around text8's mean."""
    out, seen = [], set()
    while len(out) < n:
        m = 2 * (n - len(out)) + 16
        lens = np.clip(np.round(rng.normal(7.5, 2.5, m)), 2, 16).astype(int)
        letters = rng.integers(0, 26, (m, 16))
        for L, row in zip(lens, letters):
            w = "".join(chr(97 + c) for c in row[:L])
            if w not in seen:
                seen.add(w)
                out.append(w)
                if len(out) == n:
                    break
    return out


def _zipf_counts(vocab: int, n_tokens: int) -> np.ndarray:
    """max(MIN_COUNT, round(C / rank)) with C set so the counts sum to
    about ``n_tokens``."""
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    lo, hi = 1.0, float(n_tokens)
    for _ in range(60):
        c = (lo + hi) / 2
        total = np.maximum(MIN_COUNT, np.round(c / ranks)).sum()
        lo, hi = (c, hi) if total < n_tokens else (lo, c)
    return np.maximum(MIN_COUNT, np.round(lo / ranks)).astype(np.int64)


def _sentences(words, tokens) -> list:
    return [" ".join(words[t] for t in tokens[i:i + SENTENCE])
            for i in range(0, len(tokens), SENTENCE)]


def _interleave(background, phrases, rng) -> np.ndarray:
    """The phrases inserted whole at random places of the background."""
    at = np.sort(rng.integers(0, len(background) + 1, len(phrases)))
    parts, prev = [], 0
    for a, ph in zip(at, phrases):
        parts += [background[prev:a], ph]
        prev = a
    parts.append(background[prev:])
    return np.concatenate(parts)


def topic_groups(n_topics: int = 16, size: int = 8, rank: int = 100) -> np.ndarray:
    """(n_topics, size) word ids (ranks from 0) of the planted groups."""
    return np.arange(rank, rank + n_topics * size).reshape(n_topics, size)


def text8_like(n_tokens: int = 1_000_000, vocab: int = TEXT8_VOCAB, seed: int = 0,
               topics: np.ndarray = None):
    """(sentences, words, topic word lists): see the module docstring."""
    rng = np.random.default_rng(seed)
    words = synthetic_words(vocab, rng)
    counts = _zipf_counts(vocab, n_tokens)
    topics = topic_groups() if topics is None else topics
    in_topic = np.zeros(vocab, bool)
    in_topic[topics.ravel()] = True
    background = np.repeat(np.nonzero(~in_topic)[0], counts[~in_topic])
    rng.shuffle(background)
    # each group as often as its first (most frequent) word
    phrases = [rng.permutation(g) for g in topics for _ in range(counts[g[0]])]
    order = rng.permutation(len(phrases))
    tokens = _interleave(background, [phrases[i] for i in order], rng)
    return _sentences(words, tokens), words, [[words[i] for i in g] for g in topics]


def text8_cut(words, n_phrases: int = 4, seed: int = 1, topics: np.ndarray = None):
    """Every word of ``words`` once, shuffled, plus ``n_phrases`` phrases of
    each planted group: the full vocabulary (at min count 1) in few tokens."""
    rng = np.random.default_rng(seed)
    topics = topic_groups() if topics is None else topics
    background = rng.permutation(len(words))
    phrases = [rng.permutation(g) for g in topics for _ in range(n_phrases)]
    return _sentences(words, _interleave(background, phrases, rng))


def blogcatalog_like(n: int = BLOGCATALOG[0], edges: int = BLOGCATALOG[1],
                     seed: int = 0):
    """(vertex count, unique undirected edges (E, 2) in first-drawn order)."""
    rng = np.random.default_rng(seed)
    w = np.arange(1, n + 1, dtype=np.float64) ** -0.5
    cdf = np.cumsum(w / w.sum())
    keys, have = np.zeros(0, np.int64), 0
    while have < edges:
        a = np.searchsorted(cdf, rng.random(2 * edges), side="right")
        b = np.searchsorted(cdf, rng.random(2 * edges), side="right")
        a, b = np.minimum(a, n - 1), np.minimum(b, n - 1)
        ok = a != b
        cand = np.minimum(a, b)[ok] * n + np.maximum(a, b)[ok]
        allk = np.concatenate([keys, cand])
        _, first = np.unique(allk, return_index=True)
        keys = allk[np.sort(first)]
        have = len(keys)
    keys = keys[:edges]
    return n, np.stack([keys // n, keys % n], axis=1)


def documents(words, topics, n_docs: int = 64, length: int = 200, seed: int = 2):
    """(text, label) documents, each mostly one planted group's words with
    background words mixed in; labelled by group."""
    rng = np.random.default_rng(seed)
    out = []
    for d in range(n_docs):
        k = d % len(topics)
        own = rng.choice(len(topics[k]), length)
        noise = rng.integers(0, len(words), length)
        use_own = rng.random(length) < 0.7
        toks = [topics[k][o] if u else words[z] for o, z, u in zip(own, noise, use_own)]
        out.append((" ".join(toks), f"topic{k}_{d}"))
    return out


# --------------------------------------------------------- the networks


def dense_stack(n_in: int, n_out: int, hidden: int, layers: int, out_act: str,
                loss: str, updater, seed: int, l2: float = 0.0):
    """``layers`` RELU dense layers of ``hidden`` then the output layer
    (rl4j's DQNFactoryStdDense / ActorCriticFactorySeparateStdDense)."""
    from deeplearning4j_tpu_torch.nn import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer

    b = NeuralNetConfiguration.Builder().seed(seed).updater(updater)
    if l2:
        b = b.l2(l2)
    lst = b.list()
    for _ in range(layers):
        lst = lst.layer(DenseLayer(nOut=hidden, activation="RELU"))
    return (lst.layer(OutputLayer(nOut=n_out, activation=out_act, lossFunction=loss))
            .setInputType(InputType.feedForward(n_in)).build())


def cartpole_dqn_conf(seed: int = 123, l2: float = 1e-3):
    """rl4j-examples' CARTPOLE_NET: 3 dense layers of 16, Adam 5e-4, l2 1e-3."""
    from deeplearning4j_tpu_torch.train import Adam

    return dense_stack(4, 2, 16, 3, "IDENTITY", "MSE", Adam(5e-4), seed, l2)


def cartpole_a2c_confs(seed: int = 123):
    """The actor-critic's separate policy and value nets (rl4j-examples'
    A3C CartPole: 3 dense layers of 16, Adam 5e-4, l2 1e-3)."""
    from deeplearning4j_tpu_torch.train import Adam

    pi = dense_stack(4, 2, 16, 3, "SOFTMAX", "MCXENT", Adam(5e-4), seed, 1e-3)
    v = dense_stack(4, 1, 16, 3, "IDENTITY", "MSE", Adam(5e-4), seed + 1, 1e-3)
    return pi, v


def mnist_mlp_conf(lr: float, hidden: int, seed: int = 1):
    """The arbiter search's candidate: one dense layer on 784 inputs."""
    from deeplearning4j_tpu_torch.train import Adam

    return dense_stack(784, 10, hidden, 1, "SOFTMAX", "MCXENT", Adam(lr), seed)
