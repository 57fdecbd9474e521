"""Word2Vec (counterpart: ``deeplearning4j_tpu/text/word2vec.py``; ref:
deeplearning4j-nlp org.deeplearning4j.models.word2vec.Word2Vec +
SequenceVectors training loop + libnd4j skipgram/cbow fused ops).

Training is batched negative-sampling SGD, as in the reference: all
(center, context) pairs of a batch update the tables at once through
per-row bounded scatter adds (``_mean_scatter``). A step is a handful of
gathers, elementwise ops and two scatters on the model's device
(``device``: ``"cuda"`` unless the caller passes ``"cpu"``); the
reference's step is an XLA fusion of the same gathers and scatters, with
no hand-written kernel, so the port's is plain PyTorch.

Determinism: every scatter-add (``scatter_add_rows``) sums a row's
duplicate contributions in a fixed order. On the CPU it is ``index_add_``,
which adds them one index after another, as XLA's CPU scatter does
(``index_put_(accumulate=True)`` there adds with atomics across threads).
On CUDA it is ``index_put_(accumulate=True)``, which sorts the indices
(a stable radix sort) and adds each row's contributions in that order,
without atomics (``index_add_`` there adds with atomics in whatever order
they land). So two fits from one seed give bit-equal tables on the card.
The tables update in place; each gather of a step is taken before the
scatters that follow it.

The host stream is the reference's: numpy ``default_rng(seed)`` draws the
initial table, the subsampling masks, the window shrinks, the shuffle and
the negatives in the reference's order, so every batch equals the
reference's and only float rounding separates the tables. Three host
costs of the reference's loop are taken the same draws a faster way (the
CPU tests hold each against the reference's call): the window shrinks of
a sentence are drawn in one call (numpy's bounded integers draw the same
stream one at a time or as an array) and the pairs built with numpy in
the reference's order (``window_pairs``); the shuffle permutes an index
vector, which numpy shuffles in C with the draws its row-by-row shuffle
of the pairs makes (``shuffle_rows``); the negatives are ``rng.choice``'s
own inverse-CDF search over a CDF built once (``UnigramDraws``), not
rebuilt and re-validated every batch.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import default_device
from deeplearning4j_tpu_torch.text.sentence_iterator import SentenceIterator
from deeplearning4j_tpu_torch.text.tokenization import DefaultTokenizerFactory
from deeplearning4j_tpu_torch.text.vocab import VocabCache
from deeplearning4j_tpu_torch.train.updaters import rtrue_div

_ACCUM_CAP = 8.0


def scatter_add_rows(table, idx, vals):
    """``table[idx] += vals`` in place, duplicate rows summed in a fixed
    order on either device (see the module docstring). On CUDA the
    indices' range is not checked: ``index_put_``'s check reads their max
    and min back to the host, two waits for the card a call; every caller
    here scatters ids it drew in range."""
    if table.is_cuda:
        return torch._index_put_impl_(table, (idx,), vals, accumulate=True,
                                      unsafe=True)
    return table.index_add_(0, idx, vals)


def _mean_scatter(table, idx_flat, grads_flat, lr, weights=None):
    """SGD step with BOUNDED per-row gradient accumulation, in place.

    A row's contributions are summed, each pre-scaled by
    ``min(1, _ACCUM_CAP / max(count, 1))`` of its row, ``count`` the
    row's contributions in the batch (``weights`` marks which are real:
    masked negative draws must not damp the row's scale). The count
    buffer and the gathered scales are taken before the table moves. See
    the reference's docstring for why neither a plain sum nor a full mean.
    """
    n = idx_flat.shape[0]
    w = (torch.ones((n, 1), dtype=table.dtype, device=table.device)
         if weights is None else weights[:, None].to(table.dtype))
    cnt = torch.zeros((table.shape[0], 1), dtype=table.dtype,
                      device=table.device)
    scatter_add_rows(cnt, idx_flat, w)
    # the reference scales the whole count buffer, then gathers; gathered
    # first, the same elementwise ops touch a batch's rows only
    scale = torch.clamp(rtrue_div(_ACCUM_CAP, torch.clamp(cnt[idx_flat], min=1.0)),
                        max=1.0)
    return scatter_add_rows(table, idx_flat, -lr * grads_flat * scale)


def _neg_terms(h, u_pos, u_neg, neg, pos):
    """The negative-sampling terms shared by the three steps: (g_pos,
    s_neg masked, grad_h, valid). A sampled negative that IS the positive
    would cancel the positive update — the reference skips those draws,
    and ``valid`` also weights their counts."""
    s_pos = torch.sigmoid(torch.sum(h * u_pos, dim=-1))               # (B,)
    s_neg = torch.sigmoid(torch.sum(h[:, None, :] * u_neg, dim=-1))   # (B, K)
    valid = (neg != pos[:, None]).to(s_neg.dtype)
    s_neg = s_neg * valid
    g_pos = (s_pos - 1.0)[:, None]
    grad_h = g_pos * u_pos + torch.sum(s_neg[:, :, None] * u_neg, dim=1)
    return g_pos, s_neg, grad_h, valid


def _syn1_scatter(syn1, pos, neg, g_pos, s_neg, h, valid, lr):
    D = h.shape[-1]
    return _mean_scatter(
        syn1, torch.cat([pos, neg.reshape(-1)]),
        torch.cat([g_pos * h, (s_neg[:, :, None] * h[:, None, :]).reshape(-1, D)]),
        lr, weights=torch.cat([torch.ones_like(pos, dtype=valid.dtype),
                               valid.reshape(-1)]))


def _sg_step(syn0, syn1, center, ctx, neg, lr):
    """One batched skip-gram negative-sampling step, in place.
    center/ctx: (B,) int64; neg: (B, K) int64. Returns (syn0, syn1)."""
    v = syn0[center]                      # (B, D)
    u_pos = syn1[ctx]                     # (B, D)
    u_neg = syn1[neg]                     # (B, K, D)
    g_pos, s_neg, grad_v, valid = _neg_terms(v, u_pos, u_neg, neg, ctx)
    _mean_scatter(syn0, center, grad_v, lr)
    _syn1_scatter(syn1, ctx, neg, g_pos, s_neg, v, valid, lr)
    return syn0, syn1


def _mean_context(table, rows, mask):
    """The masked mean of each row's gathered vectors: (h, denom)."""
    vs = table[rows] * mask[:, :, None]
    denom = torch.clamp(mask.sum(-1, keepdim=True), min=1.0)
    return vs.sum(1) / denom, denom


def _cbow_step(syn0, syn1, ctx_win, ctx_mask, target, neg, lr):
    """CBOW, in place: the mean of window context vectors predicts the
    target. ctx_win: (B, W) int64 (padded), ctx_mask: (B, W) float."""
    h, denom = _mean_context(syn0, ctx_win, ctx_mask)
    u_pos = syn1[target]
    u_neg = syn1[neg]
    g_pos, s_neg, grad_h, valid = _neg_terms(h, u_pos, u_neg, neg, target)
    _syn1_scatter(syn1, target, neg, g_pos, s_neg, h, valid, lr)
    D = h.shape[-1]
    grad_ctx = (grad_h / denom)[:, None, :] * ctx_mask[:, :, None]
    _mean_scatter(syn0, ctx_win.reshape(-1), grad_ctx.reshape(-1, D), lr,
                  weights=ctx_mask.reshape(-1))
    return syn0, syn1


def window_pairs(ids: np.ndarray, shrink: np.ndarray) -> np.ndarray:
    """(center, context) id pairs of equal-length sentences ``ids`` (S, n)
    given each position's window ``shrink`` (S, n), in the reference's
    order: sentence by sentence, position i by position, the positions j
    of [i - b, i + b] inside the sentence ascending, j != i."""
    S, n = ids.shape
    if S == 0 or n == 0:
        return np.zeros((0, 2), ids.dtype)
    w = int(shrink.max())
    off = np.concatenate([np.arange(-w, 0), np.arange(1, w + 1)])
    j = np.arange(n)[:, None] + off[None, :]                       # (n, 2w)
    inside = (j >= 0) & (j < n)
    keep = inside[None] & (np.abs(off)[None, None, :] <= shrink[:, :, None])
    jj = np.broadcast_to(np.where(inside, j, 0)[None], keep.shape)[keep]
    ss = np.broadcast_to(np.arange(S)[:, None, None], keep.shape)[keep]
    ii = np.broadcast_to(np.arange(n)[None, :, None], keep.shape)[keep]
    return np.stack([ids[ss, ii], ids[ss, jj]], axis=1)


def sentence_pairs(sentences, keep, window: int, rng) -> np.ndarray:
    """One epoch's (center, context) pairs, int32, drawing from ``rng``
    what the reference's loop draws: per sentence the subsampling mask
    (when ``keep`` is given), then one window shrink per kept token."""
    out = []
    for ids in sentences:
        if keep is not None:
            ids = ids[rng.random(len(ids)) < keep[ids]]
        shrink = rng.integers(1, window + 1, size=len(ids))
        out.append(window_pairs(ids[None], shrink[None]))
    if not out:
        return np.zeros((0, 2), np.int32)
    return np.concatenate(out).astype(np.int32)


def shuffle_rows(rng, a: np.ndarray) -> np.ndarray:
    """``rng.shuffle(a)`` along the first axis, returned: the same draws
    and the same permutation, applied through an index vector."""
    perm = np.arange(len(a))
    rng.shuffle(perm)
    return a[perm]


class UnigramDraws:
    """``rng.choice(len(p), size=shape, p=p)``: numpy's own search of
    uniform draws in the normalized CDF of ``p`` (as float64), with the
    CDF built once."""

    def __init__(self, p):
        self.cdf = np.asarray(p, np.float64).cumsum()
        self.cdf /= self.cdf[-1]

    def __call__(self, rng, shape) -> np.ndarray:
        return self.cdf.searchsorted(rng.random(shape), side="right").astype(np.int32)


def uniform_table(rng, rows: int, D: int, device) -> torch.Tensor:
    """The reference's U(-0.5, 0.5) / D table, drawn on the host."""
    return torch.from_numpy((rng.random((rows, D), np.float32) - 0.5) / D).to(device)


def _to_device(arr: np.ndarray, device, dtype=np.int64) -> torch.Tensor:
    """A host batch to the device in one copy (int64 indices unless
    ``dtype`` says otherwise). To a card the copy leaves from pinned
    memory without blocking, so the host runs ahead of the card (a copy
    from pageable memory waits for the card's queue to drain)."""
    t = torch.from_numpy(np.ascontiguousarray(arr, dtype=dtype))
    if torch.device(device).type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


class StepRunner:
    """A fit's steps: ``step(*head, *args(batch), lr)`` for each host batch,
    ``args`` mapping the batch on the device to the step's arguments.

    On the CPU each step runs eagerly. On CUDA a step is a few dozen small
    launches, so the host's launch loop, not the card, paces a fit: the
    first batch runs eagerly, the next batch of its size is captured in a
    CUDA graph (over a static batch buffer and a 0-d learning rate) and
    replayed, and so is every later batch of that size: the host copies
    the batch into the buffer, fills the rate and launches the graph. A
    batch of another size (an epoch's last) runs eagerly. The graph runs
    the eager step's kernels in their order on the same tables, so a fit
    is the eager fit bit for bit (``-lr * g`` takes lr as float32 either
    way)."""

    def __init__(self, step, head, args, device, dtype=np.int64):
        self.step, self.head, self.args = step, tuple(head), args
        self.device, self.dtype = torch.device(device), dtype
        self._first = None          # the first batch's shape
        self._graph = None

    def __call__(self, batch: np.ndarray, lr: float):
        host = torch.from_numpy(np.ascontiguousarray(batch, dtype=self.dtype))
        if self.device.type != "cuda":
            self.step(*self.head, *self.args(host), lr)
            return
        host = host.pin_memory()
        if self._graph is None and self._first is not None \
                and tuple(host.shape) == self._first:
            self._capture()
        if self._graph is not None and tuple(host.shape) == self._first:
            self._buf.copy_(host, non_blocking=True)
            self._lr.fill_(lr)
            self._graph.replay()
            return
        if self._first is None:
            self._first = tuple(host.shape)
        self.step(*self.head, *self.args(host.to(self.device, non_blocking=True)),
                  lr)

    def _capture(self):
        self._buf = torch.zeros(self._first, dtype=torch.from_numpy(
            np.zeros(0, self.dtype)).dtype, device=self.device)
        self._lr = torch.zeros((), dtype=torch.float32, device=self.device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.step(*self.head, *self.args(self._buf), self._lr)
        self._graph = graph


class WordVectorsModel:
    """Shared lookup surface (ref: WordVectors / InMemoryLookupTable).
    Lookups run on the host over the fitted numpy table, as the
    reference's do."""

    def __init__(self, device=None):
        self.device = default_device(device)
        self.vocab = VocabCache()
        self.syn0: Optional[np.ndarray] = None
        self.layerSize = 0

    # ---- lookups (ref: WordVectors interface)
    def hasWord(self, word: str) -> bool:
        return self.vocab.containsWord(word)

    def getWordVector(self, word: str) -> Optional[np.ndarray]:
        i = self.vocab.indexOf(word)
        return None if i < 0 else np.asarray(self.syn0[i])

    def getWordVectorMatrix(self, word: str):
        return self.getWordVector(word)

    def similarity(self, a: str, b: str) -> float:
        va, vb = self.getWordVector(a), self.getWordVector(b)
        if va is None or vb is None:
            return float("nan")
        return float(np.dot(va, vb) /
                     (np.linalg.norm(va) * np.linalg.norm(vb) + 1e-12))

    def wordsNearest(self, word_or_vec, topN: int = 10) -> List[str]:
        if isinstance(word_or_vec, str):
            v = self.getWordVector(word_or_vec)
            exclude = {word_or_vec}
        else:
            v = np.asarray(word_or_vec)
            exclude = set()
        if v is None:
            return []
        m = np.asarray(self.syn0)
        sims = m @ v / (np.linalg.norm(m, axis=1) * np.linalg.norm(v) + 1e-12)
        order = np.argsort(-sims)
        out = []
        for i in order:
            w = self.vocab.wordAtIndex(int(i))
            if w not in exclude:
                out.append(w)
            if len(out) >= topN:
                break
        return out


class Word2Vec(WordVectorsModel):
    """(ref: org.deeplearning4j.models.word2vec.Word2Vec + .Builder), on
    ``device`` (default ``"cuda"``; without CUDA it raises unless
    ``device="cpu"``)."""

    def __init__(self, minWordFrequency=1, iterations=1, epochs=1, layerSize=100,
                 seed=42, windowSize=5, learningRate=0.025, minLearningRate=1e-4,
                 negativeSample=5, sampling=0.0, batchSize=512,
                 elementsLearningAlgorithm="SkipGram",
                 iterate: Optional[SentenceIterator] = None,
                 tokenizerFactory=None, device=None):
        super().__init__(device)
        self.minWordFrequency = minWordFrequency
        self.iterations = iterations
        self.epochs = epochs
        self.layerSize = layerSize
        self.seed = seed
        self.windowSize = windowSize
        self.learningRate = learningRate
        self.minLearningRate = minLearningRate
        self.negative = max(int(negativeSample), 1)
        self.sampling = sampling
        self.batchSize = batchSize
        self.algorithm = elementsLearningAlgorithm
        self.iterator = iterate
        self.tokenizer = tokenizerFactory or DefaultTokenizerFactory()

    class Builder:
        def __init__(self):
            self._kw = {}

        def __getattr__(self, name):
            def setter(value):
                self._kw[name] = value
                return self
            return setter

        def build(self) -> "Word2Vec":
            return Word2Vec(**self._kw)

    # ------------------------------------------------------------------ fit
    def _build_vocab(self):
        """The vocab pass (ref: VocabConstructor)."""
        for s in self.iterator:
            for t in self.tokenizer.create(s).getTokens():
                self.vocab.addToken(t)
        self.vocab.finalize_vocab(self.minWordFrequency)

    def _sentences_as_ids(self) -> List[np.ndarray]:
        out = []
        for s in self.iterator:
            toks = self.tokenizer.create(s).getTokens()
            ids = [self.vocab.indexOf(t) for t in toks]
            ids = [i for i in ids if i >= 0]
            if len(ids) > 1:
                out.append(np.asarray(ids, dtype=np.int32))
        return out

    def _init_table(self, rng, rows: int) -> torch.Tensor:
        return uniform_table(rng, rows, self.layerSize, self.device)

    def fit(self):
        self._build_vocab()
        V, D = self.vocab.numWords(), self.layerSize
        rng = np.random.default_rng(self.seed)
        syn0 = self._init_table(rng, V)
        syn1 = torch.zeros((V, D), dtype=torch.float32, device=self.device)
        negatives = UnigramDraws(self.vocab.unigram_table())
        keep = self.vocab.subsample_keep_prob(self.sampling) if self.sampling > 0 else None

        sentences = self._sentences_as_ids()
        # cap the batch so each row averages only a few contributions (see
        # the reference): real vocabs keep full batches
        b_eff = min(self.batchSize, max(64, 4 * V))
        if self.algorithm == "CBOW":
            run = StepRunner(_cbow_step, (syn0, syn1), lambda t: (
                t[:, 1:2], torch.ones((len(t), 1), dtype=torch.float32, device=t.device),
                t[:, 0], t[:, 2:]), self.device)
        else:
            run = StepRunner(_sg_step, (syn0, syn1),
                             lambda t: (t[:, 0], t[:, 1], t[:, 2:]), self.device)
        for ep in range(self.epochs):
            pairs = sentence_pairs(sentences, keep, self.windowSize, rng)
            if not len(pairs):
                continue
            pairs = shuffle_rows(rng, pairs)
            nb = max(1, -(-len(pairs) // b_eff) * self.iterations)
            bi = 0
            for _ in range(self.iterations):
                for k in range(0, len(pairs), b_eff):
                    # linear per-batch decay (ref: alpha decays per word seen)
                    frac = (ep + bi / nb) / max(self.epochs, 1)
                    lr = max(self.minLearningRate, self.learningRate * (1 - frac))
                    bi += 1
                    batch = pairs[k:k + b_eff]
                    neg = negatives(rng, (len(batch), self.negative))
                    # one copy to the device: [center, context, negatives...]
                    run(np.concatenate([batch, neg], axis=1), lr)
        self.syn0 = syn0.cpu().numpy()
        self._syn1 = syn1.cpu().numpy()
        return self
