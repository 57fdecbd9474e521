"""GloVe (counterpart: ``deeplearning4j_tpu/text/glove.py``; ref:
deeplearning4j-nlp org.deeplearning4j.models.glove.Glove — co-occurrence
counting + weighted least-squares factorization with AdaGrad).

The co-occurrence pass is host Python, copied. The AdaGrad step runs on
the model's device in place, with the reference's order: the four
accumulators are scatter-summed over a batch's duplicate rows first, and
each table's update then reads its accumulator back (updated) at every
occurrence. Scatters are ``word2vec.scatter_add_rows``: a fixed order on
either device."""
from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.text.tokenization import DefaultTokenizerFactory
from deeplearning4j_tpu_torch.text.word2vec import (
    StepRunner, WordVectorsModel, scatter_add_rows, shuffle_rows, uniform_table)
from deeplearning4j_tpu_torch.train.updaters import true_div


def _glove_step(w, wt, b, bt, hw, hwt, hb, hbt, ci, cj, cx, xmax, alpha, lr):
    """Batched AdaGrad GloVe update on co-occurrence triples (i, j, X_ij),
    in place; returns the tables, the accumulators and the batch's loss."""
    wi, wj = w[ci], wt[cj]
    diff = torch.sum(wi * wj, dim=-1) + b[ci] + bt[cj] - torch.log(cx)
    # on CUDA a tensor divided by a Python number is a reciprocal multiply
    f = torch.clamp(true_div(cx, xmax) ** alpha, max=1.0)
    fd = f * diff                                     # (B,)
    gw = fd[:, None] * wj
    gwt = fd[:, None] * wi
    gb = fd
    # AdaGrad accumulators first; the updates read them back
    scatter_add_rows(hw, ci, gw * gw)
    scatter_add_rows(hwt, cj, gwt * gwt)
    scatter_add_rows(hb, ci, gb * gb)
    scatter_add_rows(hbt, cj, gb * gb)
    scatter_add_rows(w, ci, -lr * gw / torch.sqrt(hw[ci] + 1e-8))
    scatter_add_rows(wt, cj, -lr * gwt / torch.sqrt(hwt[cj] + 1e-8))
    scatter_add_rows(b, ci, -lr * gb / torch.sqrt(hb[ci] + 1e-8))
    scatter_add_rows(bt, cj, -lr * gb / torch.sqrt(hbt[cj] + 1e-8))
    loss = 0.5 * torch.sum(f * diff * diff)
    return w, wt, b, bt, hw, hwt, hb, hbt, loss


class Glove(WordVectorsModel):
    """(ref: Glove.Builder), on ``device`` (default ``"cuda"``; without
    CUDA it raises unless ``device="cpu"``)."""

    def __init__(self, minWordFrequency=1, iterations=15, layerSize=50, seed=42,
                 windowSize=5, learningRate=0.05, xMax=100.0, alpha=0.75,
                 batchSize=1024, iterate=None, tokenizerFactory=None, device=None):
        super().__init__(device)
        self.minWordFrequency = minWordFrequency
        self.iterations = iterations
        self.layerSize = layerSize
        self.seed = seed
        self.windowSize = windowSize
        self.learningRate = learningRate
        self.xMax = xMax
        self.alpha = alpha
        self.batchSize = batchSize
        self.iterator = iterate
        self.tokenizer = tokenizerFactory or DefaultTokenizerFactory()

    def fit(self):
        for s in self.iterator:
            for t in self.tokenizer.create(s).getTokens():
                self.vocab.addToken(t)
        self.vocab.finalize_vocab(self.minWordFrequency)
        V, D = self.vocab.numWords(), self.layerSize

        # co-occurrence accumulation with 1/distance weighting (ref:
        # CoOccurrences)
        cooc: dict = {}
        for s in self.iterator:
            ids = [self.vocab.indexOf(t)
                   for t in self.tokenizer.create(s).getTokens()]
            ids = [i for i in ids if i >= 0]
            for i, ci in enumerate(ids):
                for off in range(1, self.windowSize + 1):
                    j = i + off
                    if j >= len(ids):
                        break
                    key = (ci, ids[j])
                    cooc[key] = cooc.get(key, 0.0) + 1.0 / off
                    key2 = (ids[j], ci)
                    cooc[key2] = cooc.get(key2, 0.0) + 1.0 / off
        if not cooc:
            raise ValueError("empty co-occurrence matrix")
        triples = np.asarray([(i, j, x) for (i, j), x in cooc.items()],
                             dtype=np.float64)

        dev = self.device
        rng = np.random.default_rng(self.seed)
        w = uniform_table(rng, V, D, dev)
        wt = uniform_table(rng, V, D, dev)
        b, bt, hb, hbt = (torch.zeros((V,), dtype=torch.float32, device=dev)
                          for _ in range(4))
        hw, hwt = (torch.zeros((V, D), dtype=torch.float32, device=dev)
                   for _ in range(2))

        # one copy to the device a batch; the ids are exact in float64
        run = StepRunner(_glove_step, (w, wt, b, bt, hw, hwt, hb, hbt), lambda t: (
            t[:, 0].long(), t[:, 1].long(), t[:, 2].float(), self.xMax, self.alpha),
            dev, dtype=np.float64)
        for _ in range(self.iterations):
            triples = shuffle_rows(rng, triples)
            for k in range(0, len(triples), self.batchSize):
                run(triples[k:k + self.batchSize], self.learningRate)
        self.syn0 = w.cpu().numpy() + wt.cpu().numpy()  # standard GloVe: sum both
        return self
