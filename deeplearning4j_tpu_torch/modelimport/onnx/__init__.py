"""ONNX import (counterpart: ``deeplearning4j_tpu/modelimport/onnx``; ref:
nd4j/samediff-import-onnx — OnnxFrameworkImporter).

Neither the pip ``onnx`` package nor ``google.protobuf`` is needed: the
wire format is read and written by ``wire`` (the messages of the
reference's ``onnx_minimal.proto``, a subset of the public ONNX IR schema
with matching field numbers, so real .onnx files parse byte-compatibly).
"""
from deeplearning4j_tpu_torch.modelimport.onnx.importer import (
    OnnxFrameworkImporter,
    numpy_to_tensor,
    tensor_to_numpy,
)
from deeplearning4j_tpu_torch.modelimport.onnx import wire as onnx_pb

__all__ = ["OnnxFrameworkImporter", "onnx_pb", "numpy_to_tensor",
           "tensor_to_numpy"]
