"""Training listeners + optimization callbacks (counterpart:
``deeplearning4j_tpu/optimize``; ref:
org.deeplearning4j.optimize.api.TrainingListener and
org.deeplearning4j.optimize.listeners.*)."""
from deeplearning4j_tpu_torch.optimize.listeners import (
    TrainingListener, ScoreIterationListener, PerformanceListener,
    CollectScoresListener, TimeIterationListener, EvaluativeListener,
    CheckpointListener)

__all__ = [
    "TrainingListener", "ScoreIterationListener", "PerformanceListener",
    "CollectScoresListener", "TimeIterationListener", "EvaluativeListener",
    "CheckpointListener",
]
