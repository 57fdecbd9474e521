"""GraphRunner — execute frozen TF GraphDefs via TensorFlow itself
(counterpart: ``deeplearning4j_tpu/interop/tf_runner.py``; ref:
nd4j/nd4j-tensorflow org.nd4j.tensorflow.conversion.graphrunner.GraphRunner,
which runs graph segments through the TF C API with INDArray I/O).

An ESCAPE HATCH for graphs (or subgraphs) the native import pipeline
(``modelimport.tensorflow.TensorflowFrameworkImporter``) cannot
translate. Preferred path: import → SameDiff on the card. This runner
executes on the host CPU through TF — correct but slow; use it for parity
checking and for exotic-op fallback, not for training. It runs wherever
TensorFlow is installed, and on no card.

TensorFlow is imported lazily so the package has no hard TF dependency.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np


def _tf():
    try:
        import tensorflow as tf
        return tf
    except ImportError as e:
        raise ImportError(
            "GraphRunner needs tensorflow; install it or use "
            "modelimport.tensorflow.TensorflowFrameworkImporter") from e


class GraphRunner:
    """Run a frozen GraphDef with numpy feeds/fetches.

    >>> runner = GraphRunner("frozen.pb", inputNames=["x"], outputNames=["y"])
    >>> out = runner.run({"x": np.ones((1, 4), np.float32)})
    >>> out["y"]

    Mirrors the reference's API surface: construct from a file path or
    serialized proto bytes, name the inputs/outputs (auto-detected when
    omitted: inputs = Placeholder nodes, outputs = nodes consumed by no
    other node), then ``run`` feeds host arrays through a TF session.
    """

    def __init__(self, graph: Union[str, bytes],
                 inputNames: Optional[Sequence[str]] = None,
                 outputNames: Optional[Sequence[str]] = None):
        tf = _tf()
        if isinstance(graph, str):
            with open(graph, "rb") as f:
                data = f.read()
        else:
            data = graph
        self.graph_def = tf.compat.v1.GraphDef.FromString(data)

        nodes = {n.name: n for n in self.graph_def.node}
        consumed = {inp.split(":")[0].lstrip("^")
                    for n in self.graph_def.node for inp in n.input}
        self.inputNames: List[str] = list(inputNames) if inputNames else [
            n.name for n in self.graph_def.node if n.op == "Placeholder"]
        self.outputNames: List[str] = list(outputNames) if outputNames else [
            n.name for n in self.graph_def.node
            if n.name not in consumed and n.op not in ("Const", "Placeholder",
                                                       "NoOp", "Assert")]
        for name in self.inputNames + self.outputNames:
            if name.split(":")[0] not in nodes:
                raise ValueError(f"node '{name}' not in graph")

        self._graph = tf.Graph()
        with self._graph.as_default():
            tf.import_graph_def(self.graph_def, name="")
        self._session = tf.compat.v1.Session(graph=self._graph)

    @staticmethod
    def _tensor_name(name: str) -> str:
        return name if ":" in name else name + ":0"

    def run(self, inputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Feed host arrays, fetch all outputNames. Unknown feed names raise."""
        for k in inputs:
            if k not in self.inputNames:
                raise ValueError(
                    f"unexpected input '{k}' (declared: {self.inputNames})")
        feeds = {self._tensor_name(k): np.asarray(v) for k, v in inputs.items()}
        fetches = [self._tensor_name(n) for n in self.outputNames]
        vals = self._session.run(fetches, feed_dict=feeds)
        return {name: np.asarray(v)
                for name, v in zip(self.outputNames, vals)}

    def close(self):
        self._session.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
