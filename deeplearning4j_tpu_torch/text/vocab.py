"""Vocabulary cache (counterpart: ``deeplearning4j_tpu/text/vocab.py``, copied;
ref: deeplearning4j-nlp org.deeplearning4j.models.word2vec.
wordstore.VocabCache / AbstractCache — word counts, frequency filtering, index
assignment, subsampling/negative-sampling tables)."""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class VocabWord:
    """(ref: org.deeplearning4j.models.word2vec.VocabWord)."""

    def __init__(self, word: str, count: int = 1, index: int = -1):
        self.word = word
        self.count = count
        self.index = index

    def getWord(self):
        return self.word

    def getElementFrequency(self):
        return self.count

    def getIndex(self):
        return self.index

    def __repr__(self):
        return f"VocabWord({self.word!r}, n={self.count}, i={self.index})"


class VocabCache:
    """(ref: AbstractCache) — built by counting tokens, then trimmed by
    minWordFrequency and indexed by descending frequency."""

    def __init__(self):
        self._words: Dict[str, VocabWord] = {}
        self._by_index: List[VocabWord] = []

    # ---- building
    def addToken(self, word: str):
        if word in self._words:
            self._words[word].count += 1
        else:
            self._words[word] = VocabWord(word)

    def finalize_vocab(self, minWordFrequency: int = 1):
        kept = [w for w in self._words.values() if w.count >= minWordFrequency]
        kept.sort(key=lambda w: (-w.count, w.word))
        self._by_index = kept
        self._words = {w.word: w for w in kept}
        for i, w in enumerate(kept):
            w.index = i
        return self

    # ---- queries
    def numWords(self) -> int:
        return len(self._by_index)

    def containsWord(self, word: str) -> bool:
        return word in self._words

    def wordFor(self, word: str) -> Optional[VocabWord]:
        return self._words.get(word)

    def indexOf(self, word: str) -> int:
        w = self._words.get(word)
        return w.index if w else -1

    def wordAtIndex(self, index: int) -> str:
        return self._by_index[index].word

    def words(self) -> List[str]:
        return [w.word for w in self._by_index]

    def totalWordOccurrences(self) -> int:
        return sum(w.count for w in self._by_index)

    # ---- sampling tables
    def unigram_table(self, power: float = 0.75) -> np.ndarray:
        """Negative-sampling distribution p(w) ~ count^0.75 (word2vec standard;
        ref: the hardcoded 0.75 in libnd4j skipgram + AbstractCache tables)."""
        c = np.array([w.count for w in self._by_index], dtype=np.float64) ** power
        return (c / c.sum()).astype(np.float32)

    def subsample_keep_prob(self, t: float = 1e-3) -> np.ndarray:
        """word2vec frequent-word subsampling keep probability."""
        total = max(self.totalWordOccurrences(), 1)
        f = np.array([w.count / total for w in self._by_index], dtype=np.float64)
        keep = np.minimum(1.0, np.sqrt(t / np.maximum(f, 1e-12)) + t / np.maximum(f, 1e-12))
        return keep.astype(np.float32)
