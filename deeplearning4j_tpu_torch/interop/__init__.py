"""Runtime interop with other frameworks (counterpart:
``deeplearning4j_tpu/interop``; ref: nd4j/nd4j-tensorflow's GraphRunner and
nd4j/nd4j-onnxruntime's OnnxRuntimeRunner — escape hatches that execute
foreign model formats with array I/O, for graphs the import pipeline
cannot (yet) translate).

``onnxruntime`` is not a dependency; OnnxRunner keeps the reference
runner's API (run/exec over name->array maps) but executes through the
in-tree importer (``modelimport.onnx``) as a SameDiff graph on the card.
"""
from deeplearning4j_tpu_torch.interop.tf_runner import GraphRunner
from deeplearning4j_tpu_torch.interop.onnx_runner import OnnxRunner

__all__ = ["GraphRunner", "OnnxRunner"]
