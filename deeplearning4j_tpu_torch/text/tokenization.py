"""Tokenizers (counterpart: ``deeplearning4j_tpu/text/tokenization.py``, copied;
ref: deeplearning4j-nlp org.deeplearning4j.text.tokenization —
TokenizerFactory SPI + TokenPreProcess)."""
from __future__ import annotations

import re
from typing import List, Optional


class TokenPreProcess:
    def preProcess(self, token: str) -> str:
        raise NotImplementedError


class LowCasePreProcessor(TokenPreProcess):
    def preProcess(self, token: str) -> str:
        return token.lower()


class CommonPreprocessor(TokenPreProcess):
    """Lowercase + strip punctuation/digits (ref: CommonPreprocessor)."""

    _PUNCT = re.compile(r"[\d\.:,\"'\(\)\[\]|/?!;]+")

    def preProcess(self, token: str) -> str:
        return self._PUNCT.sub("", token).lower()


class Tokenizer:
    def __init__(self, tokens: List[str]):
        self._tokens = tokens
        self._pos = 0

    def hasMoreTokens(self) -> bool:
        return self._pos < len(self._tokens)

    def nextToken(self) -> str:
        t = self._tokens[self._pos]
        self._pos += 1
        return t

    def countTokens(self) -> int:
        return len(self._tokens)

    def getTokens(self) -> List[str]:
        return list(self._tokens)


class DefaultTokenizerFactory:
    """Whitespace tokenizer + optional preprocessor (ref: DefaultTokenizerFactory)."""

    def __init__(self):
        self._pre: Optional[TokenPreProcess] = None

    def setTokenPreProcessor(self, pre: TokenPreProcess):
        self._pre = pre

    def create(self, text: str) -> Tokenizer:
        toks = text.split()
        if self._pre is not None:
            toks = [self._pre.preProcess(t) for t in toks]
        return Tokenizer([t for t in toks if t])


class NGramTokenizerFactory(DefaultTokenizerFactory):
    """Emit n-grams of the base tokens (ref: NGramTokenizerFactory)."""

    def __init__(self, minN: int = 1, maxN: int = 2):
        super().__init__()
        self.minN = minN
        self.maxN = maxN

    def create(self, text: str) -> Tokenizer:
        base = super().create(text).getTokens()
        out: List[str] = []
        for n in range(self.minN, self.maxN + 1):
            for i in range(len(base) - n + 1):
                out.append(" ".join(base[i:i + n]))
        return Tokenizer(out)
