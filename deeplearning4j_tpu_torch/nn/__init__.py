"""NN framework (counterpart: ``deeplearning4j_tpu/nn``; ref:
deeplearning4j/deeplearning4j-nn): the configuration DSL, the layers and
``MultiLayerNetwork``. ``ComputationGraph`` and transfer learning are not
yet ported."""
from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration, NeuralNetConfiguration  # noqa: F401
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType  # noqa: F401
from deeplearning4j_tpu_torch.nn.conf import layers  # noqa: F401
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork  # noqa: F401
