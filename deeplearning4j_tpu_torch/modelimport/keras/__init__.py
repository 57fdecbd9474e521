"""Keras h5 import (counterpart: ``deeplearning4j_tpu/modelimport/keras``;
ref: deeplearning4j-modelimport —
org.deeplearning4j.nn.modelimport.keras.KerasModelImport)."""
from deeplearning4j_tpu_torch.modelimport.keras.importer import KerasModelImport

__all__ = ["KerasModelImport"]
