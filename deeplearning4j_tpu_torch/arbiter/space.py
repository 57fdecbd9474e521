"""Parameter spaces (counterpart: ``deeplearning4j_tpu/arbiter/space.py``, copied;
ref: org.deeplearning4j.arbiter.optimize.parameter —
ContinuousParameterSpace, DiscreteParameterSpace, IntegerParameterSpace,
FixedValue; log-uniform matches the reference's
ContinuousParameterSpace(min, max) + logUniform flag)."""
from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np


class ParameterSpace:
    def sample(self, rng: np.random.RandomState) -> Any:
        raise NotImplementedError

    def grid_values(self, points: int) -> List[Any]:
        """Discretization for grid search (ref: GridSearchCandidateGenerator
        discretizes continuous spaces into ``discretizationCount`` points)."""
        raise NotImplementedError


class ContinuousParameterSpace(ParameterSpace):
    def __init__(self, min_value: float, max_value: float, log_uniform: bool = False):
        assert max_value > min_value
        if log_uniform:
            assert min_value > 0, "log-uniform needs positive bounds"
        self.lo, self.hi, self.log = min_value, max_value, log_uniform

    def sample(self, rng):
        if self.log:
            return float(np.exp(rng.uniform(np.log(self.lo), np.log(self.hi))))
        return float(rng.uniform(self.lo, self.hi))

    def grid_values(self, points):
        if self.log:
            return [float(v) for v in np.exp(np.linspace(np.log(self.lo),
                                                         np.log(self.hi), points))]
        return [float(v) for v in np.linspace(self.lo, self.hi, points)]


class IntegerParameterSpace(ParameterSpace):
    def __init__(self, min_value: int, max_value: int):
        self.lo, self.hi = min_value, max_value

    def sample(self, rng):
        return int(rng.randint(self.lo, self.hi + 1))

    def grid_values(self, points):
        vals = np.unique(np.linspace(self.lo, self.hi, points).round().astype(int))
        return [int(v) for v in vals]


class DiscreteParameterSpace(ParameterSpace):
    def __init__(self, values: Sequence):
        self.values = list(values)

    def sample(self, rng):
        return self.values[rng.randint(len(self.values))]

    def grid_values(self, points):
        return list(self.values)


class BooleanSpace(DiscreteParameterSpace):
    def __init__(self):
        super().__init__([False, True])


class FixedValue(ParameterSpace):
    def __init__(self, value):
        self.value = value

    def sample(self, rng):
        return self.value

    def grid_values(self, points):
        return [self.value]
