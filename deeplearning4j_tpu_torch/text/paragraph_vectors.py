"""ParagraphVectors / doc2vec (counterpart: ``deeplearning4j_tpu/text/
paragraph_vectors.py``; ref: deeplearning4j-nlp
org.deeplearning4j.models.paragraphvectors.ParagraphVectors — PV-DBOW:
the document vector predicts its words, trained alongside Word2Vec
tables). ``fit`` runs the skip-gram step of ``word2vec.py`` on the
document table, on the model's device; ``inferVector`` runs on the host
over the fitted numpy tables, as the reference's does."""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.text.sentence_iterator import CollectionSentenceIterator
from deeplearning4j_tpu_torch.text.word2vec import (
    StepRunner, UnigramDraws, Word2Vec, _sg_step, shuffle_rows)


class LabelledDocument:
    def __init__(self, content: str, label: str):
        self.content = content
        self.label = label


class ParagraphVectors(Word2Vec):
    """(ref: ParagraphVectors.Builder). Labels (documents) get their own
    vector table; PV-DBOW training: doc vector predicts each word in the doc
    via the shared negative-sampling objective."""

    def __init__(self, labelledDocuments: Optional[Sequence[LabelledDocument]] = None,
                 **kw):
        super().__init__(**kw)
        self.documents = list(labelledDocuments or [])
        self.doc_labels: List[str] = []
        self.doc_vectors: Optional[np.ndarray] = None

    def fit(self):
        if self.iterator is None:
            self.iterator = CollectionSentenceIterator(
                [d.content for d in self.documents])
        super().fit()  # trains word tables + builds vocab
        self.doc_labels = [d.label for d in self.documents]
        rng = np.random.default_rng(self.seed + 1)
        docvecs = self._init_table(rng, len(self.documents))
        syn1 = torch.from_numpy(self._syn1).to(self.device)
        negatives = UnigramDraws(self.vocab.unigram_table())
        # PV-DBOW: (doc, word) pairs
        pairs = []
        for di, d in enumerate(self.documents):
            for t in self.tokenizer.create(d.content).getTokens():
                wi = self.vocab.indexOf(t)
                if wi >= 0:
                    pairs.append((di, wi))
        pairs = np.asarray(pairs, dtype=np.int32)
        # small batches give the bounded-accumulation scatter step (see
        # word2vec._mean_scatter) finer-grained, fresher updates per doc row
        b_eff = min(self.batchSize, max(32, 2 * len(self.documents)))
        n_ep = max(self.epochs, 5)
        run = StepRunner(_sg_step, (docvecs, syn1),
                         lambda t: (t[:, 0], t[:, 1], t[:, 2:]), self.device)
        for ep in range(n_ep):
            pairs = shuffle_rows(rng, pairs)
            lr = self.learningRate * (1 - ep / n_ep)
            for k in range(0, len(pairs), b_eff):
                b = pairs[k:k + b_eff]
                neg = negatives(rng, (len(b), self.negative))
                run(np.concatenate([b, neg], axis=1), lr)
        self.doc_vectors = docvecs.cpu().numpy()
        self._syn1 = syn1.cpu().numpy()
        return self

    # ---- doc-level API (ref: ParagraphVectors)
    def getVectorForLabel(self, label: str) -> Optional[np.ndarray]:
        if label in self.doc_labels:
            return self.doc_vectors[self.doc_labels.index(label)]
        return None

    def inferVector(self, text: str, steps: int = 20, lr: float = 0.05) -> np.ndarray:
        """Infer a vector for unseen text by gradient steps on a fresh doc
        vector with frozen tables (ref: inferVector)."""
        rng = np.random.default_rng(0)
        ids = [self.vocab.indexOf(t)
               for t in self.tokenizer.create(text).getTokens()]
        ids = np.asarray([i for i in ids if i >= 0], dtype=np.int32)
        v = (rng.random(self.layerSize).astype(np.float32) - 0.5) / self.layerSize
        if len(ids) == 0:
            return v
        syn1 = self._syn1
        table = self.vocab.unigram_table()
        for _ in range(steps):
            u = syn1[ids]
            s = 1.0 / (1.0 + np.exp(-(u @ v)))
            grad = ((s - 1.0)[:, None] * u).sum(0)
            neg = rng.choice(len(table), size=(len(ids), self.negative), p=table)
            un = syn1[neg]
            sn = 1.0 / (1.0 + np.exp(-np.einsum("d,bkd->bk", v, un)))
            grad = grad + np.einsum("bk,bkd->d", sn, un)
            v = v - lr * grad / max(len(ids), 1)
        return v

    def similarityToLabel(self, text: str, label: str) -> float:
        v = self.inferVector(text)
        d = self.getVectorForLabel(label)
        return float(v @ d / (np.linalg.norm(v) * np.linalg.norm(d) + 1e-12))
