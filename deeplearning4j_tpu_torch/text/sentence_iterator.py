"""Sentence iterators (counterpart: ``deeplearning4j_tpu/text/sentence_iterator.py``, copied;
ref: org.deeplearning4j.text.sentenceiterator.*)."""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence


class SentenceIterator:
    def nextSentence(self) -> str:
        raise NotImplementedError

    def hasNext(self) -> bool:
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError

    def __iter__(self) -> Iterator[str]:
        self.reset()
        while self.hasNext():
            yield self.nextSentence()


class CollectionSentenceIterator(SentenceIterator):
    def __init__(self, sentences: Sequence[str]):
        self._s = list(sentences)
        self._pos = 0

    def nextSentence(self) -> str:
        s = self._s[self._pos]
        self._pos += 1
        return s

    def hasNext(self) -> bool:
        return self._pos < len(self._s)

    def reset(self):
        self._pos = 0


class BasicLineIterator(SentenceIterator):
    """One sentence per line of a file (ref: BasicLineIterator)."""

    def __init__(self, path: str):
        with open(path, "r") as f:
            self._lines = [l.strip() for l in f if l.strip()]
        self._pos = 0

    def nextSentence(self) -> str:
        s = self._lines[self._pos]
        self._pos += 1
        return s

    def hasNext(self) -> bool:
        return self._pos < len(self._lines)

    def reset(self):
        self._pos = 0


LineSentenceIterator = BasicLineIterator
