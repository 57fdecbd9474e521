"""FastText subword embeddings (counterpart: ``deeplearning4j_tpu/text/
fasttext.py``; ref: deeplearning4j-nlp
org.deeplearning4j.models.fasttext.FastText — the reference wraps the C++
fasttext binary via JNI; this is a reimplementation of the
skipgram-with-subwords model on the same batched negative-sampling trainer
as word2vec.py).

Model (Bojanowski et al. 2017): each word's input representation is the mean
of its word vector and the vectors of its char n-grams (3..6 by default),
hashed into a fixed bucket table. OOV words — the point of fastText — get a
vector from their n-grams alone. The ``(V + bucket, D)`` input table and
the per-word subword rows live on the model's device; a step gathers a
batch's rows there.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.text.word2vec import (
    StepRunner, UnigramDraws, Word2Vec, _mean_context, _mean_scatter, _neg_terms,
    _syn1_scatter, _to_device, sentence_pairs, shuffle_rows)

BOW, EOW = "<", ">"


def _ngrams(word: str, minn: int, maxn: int) -> List[str]:
    w = BOW + word + EOW
    out = []
    for n in range(minn, maxn + 1):
        for i in range(0, len(w) - n + 1):
            g = w[i:i + n]
            if g != w:  # the full token is the word vector itself
                out.append(g)
    return out


_FNV_OFFSET, _FNV_PRIME = 2166136261, 16777619


def _hash(gram: str, bucket: int) -> int:
    """FNV-1a 32-bit (with intended wraparound), the hash fastText uses for
    n-gram bucketing."""
    h = _FNV_OFFSET
    for b in gram.encode("utf-8"):
        h = ((h ^ b) * _FNV_PRIME) & 0xFFFFFFFF
    return h % bucket


def _hash_many(grams: List[str], bucket: int) -> np.ndarray:
    """``_hash`` of every gram at once (int64): the same FNV-1a over each
    gram's UTF-8 bytes, one byte position at a time in uint32 arithmetic
    (which wraps as the reference's mask does)."""
    enc = [g.encode("utf-8") for g in grams]
    lens = np.fromiter((len(e) for e in enc), np.int64, len(enc))
    h = np.full(len(enc), _FNV_OFFSET, np.uint32)
    if not len(enc):
        return h.astype(np.int64)
    flat = np.frombuffer(b"".join(enc), np.uint8)
    start = np.concatenate([[0], np.cumsum(lens)[:-1]])
    for p in range(int(lens.max())):
        live = np.nonzero(lens > p)[0]
        h[live] = (h[live] ^ flat[start[live] + p]) * np.uint32(_FNV_PRIME)
    return h.astype(np.int64) % bucket


def _ft_sg_step(syn0, syn1, sub_ids, sub_mask, ctx, neg, lr):
    """One batched subword skip-gram/negative-sampling step, in place.
    Structurally ``_cbow_step`` with the window mean replaced by the
    subword mean: per-pair gradients scattered sparsely through
    ``_mean_scatter``'s bounded accumulation, not dense autograd over the
    whole (V+bucket, D) table.

    syn0: (V + bucket, D) input table (words then n-gram buckets).
    sub_ids/sub_mask: (B, M) constituent rows of each center word.
    ctx: (B,) positive context ids into syn1; neg: (B, K) negatives.
    """
    h, denom = _mean_context(syn0, sub_ids, sub_mask)
    u_pos = syn1[ctx]
    u_neg = syn1[neg]
    g_pos, s_neg, grad_h, valid = _neg_terms(h, u_pos, u_neg, neg, ctx)
    _syn1_scatter(syn1, ctx, neg, g_pos, s_neg, h, valid, lr)
    D = h.shape[-1]
    grad_sub = (grad_h / denom)[:, None, :] * sub_mask[:, :, None]
    _mean_scatter(syn0, sub_ids.reshape(-1), grad_sub.reshape(-1, D), lr,
                  weights=sub_mask.reshape(-1))
    return syn0, syn1


class FastText(Word2Vec):
    """(ref: org.deeplearning4j.models.fasttext.FastText + .Builder), on
    ``device`` (default ``"cuda"``; without CUDA it raises unless
    ``device="cpu"``)."""

    def __init__(self, minn=3, maxn=6, bucket=20000, **kw):
        super().__init__(**kw)
        self.minn = minn
        self.maxn = maxn
        self.bucket = bucket
        self._sub_ids: Optional[np.ndarray] = None   # (V, M) padded
        self._sub_mask: Optional[np.ndarray] = None

    class Builder(Word2Vec.Builder):
        def build(self) -> "FastText":
            return FastText(**self._kw)

    # ------------------------------------------------------------------ fit
    def _build_subwords(self):
        """(V, M) rows of each word: its own, then V + the hash of each of
        its n-grams; padded with 0 under a 0 mask."""
        V = self.vocab.numWords()
        grams = [_ngrams(self.vocab.wordAtIndex(i), self.minn, self.maxn)
                 for i in range(V)]
        n = np.fromiter((len(g) for g in grams), np.int64, V)
        hashed = V + _hash_many([g for gs in grams for g in gs], self.bucket)
        M = int(n.max()) + 1 if V else 1
        sub = np.zeros((V, M), np.int32)
        mask = np.zeros((V, M), np.float32)
        sub[:, 0] = np.arange(V)
        cols = np.arange(1, M)[None, :] <= n[:, None]
        sub[:, 1:][cols] = hashed
        mask[:, 0] = 1.0
        mask[:, 1:][cols] = 1.0
        self._sub_ids, self._sub_mask = sub, mask

    def fit(self):
        self._build_vocab()
        self._build_subwords()
        V, D = self.vocab.numWords(), self.layerSize
        rng = np.random.default_rng(self.seed)
        syn0 = self._init_table(rng, V + self.bucket)
        syn1 = torch.zeros((V, D), dtype=torch.float32, device=self.device)
        negatives = UnigramDraws(self.vocab.unigram_table())
        keep = (self.vocab.subsample_keep_prob(self.sampling)
                if self.sampling > 0 else None)
        sentences = self._sentences_as_ids()
        # a padded slot (mask 0) points at the word's own row on the
        # device, not row 0: it adds a zero either way, but row 0 taking
        # every padded slot of a batch would serialize the card's
        # scatter on that one row
        sub_ids = _to_device(np.where(self._sub_mask > 0, self._sub_ids,
                                      np.arange(V)[:, None]), self.device)
        sub_mask = _to_device(self._sub_mask, self.device, dtype=np.float32)
        n_ep = max(self.epochs * self.iterations, 1)
        run = StepRunner(_ft_sg_step, (syn0, syn1), lambda t: (
            sub_ids[t[:, 0]], sub_mask[t[:, 0]], t[:, 1], t[:, 2:]), self.device)
        trained_any = False
        for ep in range(n_ep):
            # fresh pairs per epoch: subsampling + random window shrink are
            # stochastic, exactly as Word2Vec.fit regenerates them
            pairs = sentence_pairs(sentences, keep, self.windowSize, rng)
            if not len(pairs):
                continue  # subsampling can empty a tiny corpus this epoch
            trained_any = True
            pairs = shuffle_rows(rng, pairs)
            lr = max(self.learningRate * (1 - ep / n_ep), self.minLearningRate)
            for k in range(0, len(pairs), self.batchSize):
                b = pairs[k:k + self.batchSize]
                neg = negatives(rng, (len(b), self.negative))
                run(np.concatenate([b, neg], axis=1), lr)
        if not trained_any:
            raise ValueError("no training pairs in any epoch — corpus too small")
        full = syn0.cpu().numpy()
        self._bucket_table = full  # (V + bucket, D)
        # materialized per-word vectors (word row + ngram mean), the public
        # API — chunked over vocab rows so the transient (chunk, M, D) stays
        # small (a one-shot (V, M, D) gather can be GBs on realistic vocabs)
        nsub = np.maximum(self._sub_mask.sum(axis=1, keepdims=True), 1.0)
        out = np.empty((V, D), np.float32)
        for lo in range(0, V, 1024):
            hi = min(lo + 1024, V)
            out[lo:hi] = (full[self._sub_ids[lo:hi]] *
                          self._sub_mask[lo:hi, :, None]).sum(axis=1) / nsub[lo:hi]
        self.syn0 = out
        self._syn1 = np.zeros_like(self.syn0)
        return self

    # ---------------------------------------------------------------- query
    def getWordVector(self, word: str) -> Optional[np.ndarray]:
        v = super().getWordVector(word)
        if v is not None:
            return v
        return self.getOOVVector(word)

    def getOOVVector(self, word: str) -> Optional[np.ndarray]:
        """Subword composition for out-of-vocabulary words
        (ref: FastText.getWordVector on OOV — the defining capability)."""
        if self._bucket_table is None:
            return None
        V = self.vocab.numWords()
        ids = [V + _hash(g, self.bucket)
               for g in _ngrams(word, self.minn, self.maxn)]
        if not ids:
            return None
        return self._bucket_table[ids].mean(axis=0)

    _bucket_table: Optional[np.ndarray] = None
