"""Configuration DSL (counterpart: ``deeplearning4j_tpu/nn/conf``; ref:
org.deeplearning4j.nn.conf)."""
from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration, NeuralNetConfiguration  # noqa: F401
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType  # noqa: F401
