"""Declarative autodiff graph engine (counterpart:
``deeplearning4j_tpu/autodiff``; ref: org.nd4j.autodiff.samediff)."""
from deeplearning4j_tpu_torch.autodiff.samediff import (  # noqa: F401
    SameDiff, SDVariable, SameDiffOp, TrainingConfig, VariableType,
)
