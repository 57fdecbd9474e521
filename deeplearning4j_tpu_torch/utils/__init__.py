"""Utilities (counterpart: ``deeplearning4j_tpu/utils``; ref:
org.deeplearning4j.util + nd4j-common)."""
from deeplearning4j_tpu_torch.utils import gradientcheck  # noqa: F401
