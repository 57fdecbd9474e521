"""NN framework (counterpart: ``deeplearning4j_tpu/nn``; ref:
deeplearning4j/deeplearning4j-nn): the configuration DSL, the layers,
``MultiLayerNetwork`` and ``ComputationGraph`` (transfer learning in
``nn.transferlearning``)."""
from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration, NeuralNetConfiguration  # noqa: F401
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType  # noqa: F401
from deeplearning4j_tpu_torch.nn.conf import layers  # noqa: F401
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork  # noqa: F401
from deeplearning4j_tpu_torch.nn.conf.graph import (  # noqa: F401
    ComputationGraphConfiguration, GraphBuilder, GraphVertex, MergeVertex,
    ElementWiseVertex, SubsetVertex, StackVertex, UnstackVertex, ScaleVertex,
    ShiftVertex, L2NormalizeVertex, ReshapeVertex)
from deeplearning4j_tpu_torch.nn.computation_graph import ComputationGraph  # noqa: F401
