"""TF frozen-graph import (counterpart:
``deeplearning4j_tpu/modelimport/tensorflow``; ref:
nd4j/samediff-import-tensorflow — TensorflowFrameworkImporter /
TFGraphMapper)."""
from deeplearning4j_tpu_torch.modelimport.tensorflow.importer import TensorflowFrameworkImporter

__all__ = ["TensorflowFrameworkImporter"]
