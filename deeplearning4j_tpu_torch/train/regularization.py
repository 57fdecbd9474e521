"""Regularization (counterpart: ``deeplearning4j_tpu/train/
regularization.py``; ref: org.nd4j.linalg.learning.regularization.* — L1,
L2, WeightDecay applied to gradients per-layer).

Added to the training loss: loss += sum over weight params of the
per-layer penalty. The reference excludes biases by default (param key 'b');
same here — only keys listed in each layer's ``regularizable()`` participate.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class Regularization:
    def penalty(self, w):
        raise NotImplementedError

    def to_dict(self):
        d = {"@type": type(self).__name__}
        d.update(self.__dict__)
        return d


@dataclass
class L1(Regularization):
    l1: float = 0.0

    def penalty(self, w):
        return self.l1 * torch.sum(torch.abs(w))


@dataclass
class L2(Regularization):
    l2: float = 0.0

    def penalty(self, w):
        return self.l2 * torch.sum(w * w)


@dataclass
class WeightDecay(Regularization):
    """Decoupled weight decay (applied as grad += coeff * w in the reference;
    under autograd the 0.5*coeff*||w||^2 penalty is the exact equivalent)."""
    coeff: float = 0.0

    def penalty(self, w):
        return 0.5 * self.coeff * torch.sum(w * w)


_ALL = {c.__name__: c for c in [L1, L2, WeightDecay]}


def from_dict(d: dict) -> Regularization:
    d = dict(d)
    cls = _ALL[d.pop("@type")]
    return cls(**d)
