"""Early stopping (counterpart: ``deeplearning4j_tpu/earlystopping``; ref:
org.deeplearning4j.earlystopping.*)."""
from deeplearning4j_tpu_torch.earlystopping.trainer import (
    EarlyStoppingConfiguration, EarlyStoppingResult, EarlyStoppingTrainer,
    EarlyStoppingParallelTrainer,
    InMemoryModelSaver, LocalFileModelSaver,
    MaxEpochsTerminationCondition, MaxScoreIterationTerminationCondition,
    MaxTimeIterationTerminationCondition, ScoreImprovementEpochTerminationCondition,
    DataSetLossCalculator)

__all__ = [
    "EarlyStoppingConfiguration", "EarlyStoppingResult", "EarlyStoppingTrainer",
    "EarlyStoppingParallelTrainer",
    "InMemoryModelSaver", "LocalFileModelSaver",
    "MaxEpochsTerminationCondition", "MaxScoreIterationTerminationCondition",
    "MaxTimeIterationTerminationCondition", "ScoreImprovementEpochTerminationCondition",
    "DataSetLossCalculator",
]
