"""OnnxRuntimeRunner-equivalent (counterpart:
``deeplearning4j_tpu/interop/onnx_runner.py``; ref:
nd4j/nd4j-onnxruntime org.nd4j.onnxruntime.runner.OnnxRuntimeRunner —
`exec(Map<String,INDArray>)` over an ORT session).

Instead of wrapping ORT this runner executes the model through the
in-tree ONNX importer onto SameDiff, on ``device`` (default ``"cuda"``) —
the reference runner's API shape. Graphs with ops outside the importer's
registry raise at construction with the unmapped op name, mirroring the
reference's behavior when ORT lacks an op."""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class OnnxRunner:
    """run(inputs: {name: array}) -> {output_name: np.ndarray}."""

    def __init__(self, model_or_path, device=None):
        from deeplearning4j_tpu_torch.modelimport.onnx.importer import (
            OnnxFrameworkImporter, _load_model)
        self._model = _load_model(model_or_path)
        self._sd = OnnxFrameworkImporter.runImport(self._model, device=device)
        g = self._model.graph
        self.input_names: List[str] = [
            i.name for i in g.input
            if i.name not in {init.name for init in g.initializer}]
        self.output_names: List[str] = [o.name for o in g.output]

    def run(self, inputs: Dict[str, np.ndarray],
            outputs: Optional[List[str]] = None) -> Dict[str, np.ndarray]:
        outs = outputs or self.output_names
        res = self._sd.output({k: np.asarray(v) for k, v in inputs.items()},
                              outs)
        return {k: np.asarray(v.toNumpy()) for k, v in res.items()}

    exec = run  # reference method name
