"""Candidate generators (counterpart: ``deeplearning4j_tpu/arbiter/generator.py``, copied;
ref: org.deeplearning4j.arbiter.optimize.generator —
RandomSearchGenerator, GridSearchCandidateGenerator with Sequential and
RandomOrder modes)."""
from __future__ import annotations

import itertools
from typing import Dict, Iterator, Optional

import numpy as np

from deeplearning4j_tpu_torch.arbiter.space import ParameterSpace


class RandomSearchGenerator:
    """i.i.d. samples from every space (ref: RandomSearchGenerator)."""

    def __init__(self, spaces: Dict[str, ParameterSpace], seed: int = 0):
        self.spaces = spaces
        self.rng = np.random.RandomState(seed)

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield {k: s.sample(self.rng) for k, s in self.spaces.items()}


class GridSearchCandidateGenerator:
    """Cartesian product over discretized spaces (ref:
    GridSearchCandidateGenerator; ``discretization_count`` mirrors the
    reference's discretizationCount for continuous dims)."""

    def __init__(self, spaces: Dict[str, ParameterSpace],
                 discretization_count: int = 3, order: str = "Sequential",
                 seed: int = 0):
        self.spaces = spaces
        self.count = discretization_count
        self.order = order
        self.seed = seed

    def total(self) -> int:
        n = 1
        for s in self.spaces.values():
            n *= len(s.grid_values(self.count))
        return n

    def __iter__(self) -> Iterator[dict]:
        keys = list(self.spaces)
        grids = [self.spaces[k].grid_values(self.count) for k in keys]
        combos = list(itertools.product(*grids))
        if self.order == "RandomOrder":
            np.random.RandomState(self.seed).shuffle(combos)
        for combo in combos:
            yield dict(zip(keys, combo))
