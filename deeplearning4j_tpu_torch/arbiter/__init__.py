"""Hyperparameter optimization (counterpart: ``deeplearning4j_tpu/arbiter``,
copied; ref: arbiter — arbiter-core's ParameterSpace/CandidateGenerator/
OptimizationConfiguration/LocalOptimizationRunner).

A candidate is a plain dict of sampled hyperparameters handed to a user
model-builder, which builds its model on the device it chooses (a port
network takes ``device``); the runner executes candidates one after
another, each training on the whole card.
"""
from deeplearning4j_tpu_torch.arbiter.space import (
    BooleanSpace,
    ContinuousParameterSpace,
    DiscreteParameterSpace,
    FixedValue,
    IntegerParameterSpace,
    ParameterSpace,
)
from deeplearning4j_tpu_torch.arbiter.generator import (
    GridSearchCandidateGenerator,
    RandomSearchGenerator,
)
from deeplearning4j_tpu_torch.arbiter.runner import (
    Candidate,
    CandidateResult,
    MaxCandidatesCondition,
    MaxTimeCondition,
    OptimizationConfiguration,
    OptimizationRunner,
    ScoreImprovementCondition,
)

__all__ = [
    "ParameterSpace", "ContinuousParameterSpace", "DiscreteParameterSpace",
    "IntegerParameterSpace", "BooleanSpace", "FixedValue",
    "RandomSearchGenerator", "GridSearchCandidateGenerator",
    "Candidate", "CandidateResult", "OptimizationConfiguration",
    "OptimizationRunner", "MaxCandidatesCondition", "MaxTimeCondition",
    "ScoreImprovementCondition",
]
