"""ComputationGraph configuration: graph vertices + GraphBuilder DSL
(counterpart: ``deeplearning4j_tpu/nn/conf/graph.py``; ref:
org.deeplearning4j.nn.conf.ComputationGraphConfiguration.GraphBuilder and
org.deeplearning4j.nn.conf.graph.* vertex classes).

A graph node is either a Layer (via addLayer) or a GraphVertex (via
addVertex). Vertices are combinators on torch tensors; ``AttentionVertex``
alone has parameters. InputTypes propagate through the DAG for nIn
auto-fill as the sequential builder does. ``to_json`` gives the
reference's string, so a graph configuration saved by either package loads
in the other. The two attention vertices compute the reference's einsum
and softmax (the reference routes neither to a kernel).
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import Layer
from deeplearning4j_tpu_torch.train import regularization as _reg
from deeplearning4j_tpu_torch.train import updaters as _upd


class GraphVertex:
    """Combinator node (ref: o.d.nn.conf.graph.GraphVertex)."""

    def apply(self, inputs: List, *, training=False, rng=None):
        raise NotImplementedError

    def output_type(self, input_types: List[InputType]) -> InputType:
        return input_types[0]

    def regularizable(self):
        """Param keys subject to l1/l2 — vertices default to none."""
        return ()

    def to_dict(self) -> dict:
        out = {"@type": type(self).__name__}
        out.update({k: (list(v) if isinstance(v, tuple) else v)
                    for k, v in self.__dict__.items()})
        return out

    @staticmethod
    def from_dict(d: dict) -> "GraphVertex":
        d = dict(d)
        cls = VERTEX_TYPES[d.pop("@type")]
        return cls(**d)


@dataclass
class MergeVertex(GraphVertex):
    """Concatenate along the feature axis (ref: MergeVertex — dim 1 for
    FF/CNN-channels, last dim for NWC recurrent)."""

    def apply(self, inputs, *, training=False, rng=None):
        x = inputs[0]
        axis = 1 if x.dim() in (2, 4) else -1
        return torch.cat(inputs, dim=axis)

    def output_type(self, input_types):
        t0 = input_types[0]
        if t0 is None:
            return None
        if t0.kind == "cnn":
            return InputType.convolutional(t0.height, t0.width,
                                           sum(t.channels for t in input_types))
        if t0.kind == "rnn":
            return InputType.recurrent(sum(t.size for t in input_types),
                                       t0.timeSeriesLength)
        return InputType.feedForward(sum(t.size for t in input_types))


@dataclass
class ElementWiseVertex(GraphVertex):
    """(ref: ElementWiseVertex) op in Add|Subtract|Product|Average|Max."""
    op: str = "Add"

    def apply(self, inputs, *, training=False, rng=None):
        op = self.op.lower()
        if op == "add":
            out = inputs[0]
            for x in inputs[1:]:
                out = out + x
            return out
        if op == "subtract":
            return inputs[0] - inputs[1]
        if op == "product":
            out = inputs[0]
            for x in inputs[1:]:
                out = out * x
            return out
        if op == "average":
            return sum(inputs) / len(inputs)
        if op == "max":
            out = inputs[0]
            for x in inputs[1:]:
                out = torch.maximum(out, x)
            return out
        raise ValueError(f"unknown ElementWiseVertex op {self.op}")


@dataclass
class SubsetVertex(GraphVertex):
    """Feature-dim slice [from, to] inclusive (ref: SubsetVertex)."""
    fromIndex: int = 0
    toIndex: int = 0

    def apply(self, inputs, *, training=False, rng=None):
        x = inputs[0]
        sl = slice(self.fromIndex, self.toIndex + 1)
        return x[:, sl] if x.dim() in (2, 4) else x[..., sl]

    def output_type(self, input_types):
        t = input_types[0]
        if t is None:
            return None
        n = self.toIndex - self.fromIndex + 1
        if t.kind == "cnn":
            return InputType.convolutional(t.height, t.width, n)
        if t.kind == "rnn":
            return InputType.recurrent(n, t.timeSeriesLength)
        return InputType.feedForward(n)


@dataclass
class StackVertex(GraphVertex):
    """Stack along dim 0 (ref: StackVertex — minibatch concat)."""

    def apply(self, inputs, *, training=False, rng=None):
        return torch.cat(inputs, dim=0)


@dataclass
class UnstackVertex(GraphVertex):
    """Take slice ``fromIndex`` of ``stackSize`` along dim 0 (ref: UnstackVertex)."""
    fromIndex: int = 0
    stackSize: int = 1

    def apply(self, inputs, *, training=False, rng=None):
        x = inputs[0]
        step = x.shape[0] // self.stackSize
        return x[self.fromIndex * step:(self.fromIndex + 1) * step]


@dataclass
class ScaleVertex(GraphVertex):
    scaleFactor: float = 1.0

    def apply(self, inputs, *, training=False, rng=None):
        return inputs[0] * self.scaleFactor


@dataclass
class ShiftVertex(GraphVertex):
    shiftFactor: float = 0.0

    def apply(self, inputs, *, training=False, rng=None):
        return inputs[0] + self.shiftFactor


@dataclass
class L2NormalizeVertex(GraphVertex):
    eps: float = 1e-8

    def apply(self, inputs, *, training=False, rng=None):
        x = inputs[0]
        axes = tuple(range(1, x.dim()))
        n = torch.sqrt(torch.sum(x * x, dim=axes, keepdim=True))
        return x / (n + self.eps)


@dataclass
class ReshapeVertex(GraphVertex):
    newShape: Tuple[int, ...] = ()

    def apply(self, inputs, *, training=False, rng=None):
        shape = tuple(self.newShape)
        return inputs[0].reshape((inputs[0].shape[0],) + shape[1:]
                                 if shape and shape[0] == -1 else shape)

    def output_type(self, input_types):
        return None  # shape inference stops; downstream must set nIn explicitly


@dataclass
class DotProductAttentionVertex(GraphVertex):
    """Parameterless scaled dot-product attention over [queries, keys, values
    (, mask)] inputs, NWC sequences (ref: conf.graph.DotProductAttentionVertex)."""
    scale: Optional[float] = None

    def apply(self, inputs, *, training=False, rng=None):
        from deeplearning4j_tpu_torch.ops.nn_defs import dot_product_attention
        q, k, v = inputs[0], inputs[1], inputs[2]
        if self.scale is not None:
            q = q * (self.scale * torch.sqrt(torch.tensor(q.shape[-1], dtype=q.dtype,
                                                          device=q.device)))
        mask = None
        if len(inputs) > 3 and inputs[3] is not None:
            mask = inputs[3][:, None, :] > 0  # key mask -> (B, 1, Tk)
        return dot_product_attention(q, k, v, mask=mask)

    def output_type(self, input_types):
        q, v = input_types[0], input_types[2]
        return InputType.recurrent(v.size, q.timeSeriesLength)


@dataclass
class AttentionVertex(GraphVertex):
    """Multi-head attention with learned projections over [queries, keys,
    values] inputs (ref: conf.graph.AttentionVertex, SameDiff-backed)."""
    nInQueries: int = 0
    nInKeys: int = 0
    nInValues: int = 0
    nOut: int = 0
    nHeads: int = 1
    weightInit: Optional[str] = None

    has_params = True

    def init_params(self, key, dtype=torch.float32, device=None):
        from deeplearning4j_tpu_torch import default_device
        from deeplearning4j_tpu_torch.models import random as _prng
        from deeplearning4j_tpu_torch.nn.conf import weights as _winit
        dev = default_device(device)
        ks = _prng.split(key, 4)
        wi = self.weightInit or "XAVIER"
        O = self.nOut
        return {"Wq": _winit.init(wi, ks[0], (self.nInQueries, O), self.nInQueries, O,
                                  dtype, dev),
                "Wk": _winit.init(wi, ks[1], (self.nInKeys, O), self.nInKeys, O, dtype, dev),
                "Wv": _winit.init(wi, ks[2], (self.nInValues, O), self.nInValues, O,
                                  dtype, dev),
                "Wo": _winit.init(wi, ks[3], (O, O), O, O, dtype, dev)}

    def apply(self, inputs, *, params=None, training=False, rng=None):
        q = torch.matmul(inputs[0], params["Wq"])
        k = torch.matmul(inputs[1], params["Wk"])
        v = torch.matmul(inputs[2], params["Wv"])
        B, Tq, O = q.shape
        H = self.nHeads
        d = O // H

        def heads(t):
            return t.reshape(B, t.shape[1], H, d).transpose(1, 2)

        s = torch.einsum("bhqd,bhkd->bhqk", heads(q), heads(k)) / math.sqrt(d)
        a = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bhkd->bhqd", a, heads(v))
        o = o.transpose(1, 2).reshape(B, Tq, O)
        return torch.matmul(o, params["Wo"])

    def output_type(self, input_types):
        return InputType.recurrent(self.nOut, input_types[0].timeSeriesLength)


@dataclass
class PreprocessorVertex(GraphVertex):
    """Standalone input-format adapter (ref: conf.graph.PreprocessorVertex).
    ``preprocessor``: 'cnnToFF' | 'ffToRnn' | 'rnnToFF' | 'rnnToCnn' | 'cnnToRnn'
    (the reference's InputPreProcessor impls)."""
    preprocessor: str = "cnnToFF"
    channels: int = 0
    height: int = 0
    width: int = 0

    def apply(self, inputs, *, training=False, rng=None):
        x = inputs[0]
        p = self.preprocessor
        if p == "cnnToFF":
            return x.reshape(x.shape[0], -1)
        if p == "ffToRnn":
            return x[:, None, :]
        if p == "rnnToFF":
            return x.reshape(-1, x.shape[-1])
        if p == "rnnToCnn":
            B, T = x.shape[0], x.shape[1]
            return x.reshape(B * T, self.channels, self.height, self.width)
        if p == "cnnToRnn":
            return x.reshape(x.shape[0], 1, -1)
        raise ValueError(p)

    def output_type(self, input_types):
        t = input_types[0]
        if self.preprocessor == "cnnToFF":
            return InputType.feedForward(t.flat_size())
        if self.preprocessor == "ffToRnn":
            return InputType.recurrent(t.size, 1)
        if self.preprocessor == "rnnToFF":
            return InputType.feedForward(t.size)
        if self.preprocessor == "rnnToCnn":
            return InputType.convolutional(self.height, self.width, self.channels)
        if self.preprocessor == "cnnToRnn":
            return InputType.recurrent(t.flat_size(), 1)
        return t


VERTEX_TYPES = {c.__name__: c for c in (
    MergeVertex, ElementWiseVertex, SubsetVertex, StackVertex, UnstackVertex,
    ScaleVertex, ShiftVertex, L2NormalizeVertex, ReshapeVertex,
    DotProductAttentionVertex, AttentionVertex, PreprocessorVertex)}


@dataclass
class GraphNode:
    name: str
    op: object                      # Layer or GraphVertex
    inputs: List[str]


@dataclass
class ComputationGraphConfiguration:
    """(ref: o.d.nn.conf.ComputationGraphConfiguration)."""
    networkInputs: List[str] = field(default_factory=list)
    networkOutputs: List[str] = field(default_factory=list)
    nodes: List[GraphNode] = field(default_factory=list)
    seed: int = 0
    updater: _upd.Updater = field(default_factory=_upd.Sgd)
    inputTypes: List[Optional[InputType]] = field(default_factory=list)
    regularization: List[_reg.Regularization] = field(default_factory=list)
    gradientNormalization: Optional[str] = None
    gradientNormalizationThreshold: float = 1.0
    backpropType: str = "Standard"
    tbpttFwdLength: int = 20
    tbpttBackLength: int = 20
    dataType: str = "FLOAT"

    def to_json(self) -> str:
        return json.dumps({
            "networkInputs": self.networkInputs,
            "networkOutputs": self.networkOutputs,
            "nodes": [{"name": n.name,
                       "op": n.op.to_dict(),
                       "inputs": n.inputs,
                       "kind": "vertex" if isinstance(n.op, GraphVertex) else "layer"}
                      for n in self.nodes],
            "seed": self.seed,
            "updater": self.updater.to_dict(),
            "inputTypes": [t.to_dict() if t else None for t in self.inputTypes],
            "regularization": [r.to_dict() for r in self.regularization],
            "gradientNormalization": self.gradientNormalization,
            "gradientNormalizationThreshold": self.gradientNormalizationThreshold,
            "backpropType": self.backpropType,
            "tbpttFwdLength": self.tbpttFwdLength,
            "tbpttBackLength": self.tbpttBackLength,
            "dataType": self.dataType,
        }, indent=2)

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        d = json.loads(s)
        nodes = []
        for nd in d["nodes"]:
            op = GraphVertex.from_dict(nd["op"]) if nd["kind"] == "vertex" \
                else Layer.from_dict(nd["op"])
            nodes.append(GraphNode(nd["name"], op, list(nd["inputs"])))
        return ComputationGraphConfiguration(
            networkInputs=list(d["networkInputs"]),
            networkOutputs=list(d["networkOutputs"]),
            nodes=nodes,
            seed=d.get("seed", 0),
            updater=_upd.from_dict(d["updater"]),
            inputTypes=[InputType.from_dict(t) if t else None
                        for t in d.get("inputTypes", [])],
            regularization=[_reg.from_dict(r) for r in d.get("regularization", [])],
            gradientNormalization=d.get("gradientNormalization"),
            gradientNormalizationThreshold=d.get("gradientNormalizationThreshold", 1.0),
            backpropType=d.get("backpropType", "Standard"),
            tbpttFwdLength=d.get("tbpttFwdLength", 20),
            tbpttBackLength=d.get("tbpttBackLength", 20),
            dataType=d.get("dataType", "FLOAT"),
        )

    def topo_order(self) -> List[GraphNode]:
        """Kahn topological sort (ref: ComputationGraph.topologicalSortOrder)."""
        produced = set(self.networkInputs)
        remaining = list(self.nodes)
        order: List[GraphNode] = []
        while remaining:
            ready = [n for n in remaining if all(i in produced for i in n.inputs)]
            if not ready:
                missing = {i for n in remaining for i in n.inputs} - produced
                raise ValueError(f"graph has a cycle or unknown inputs: {sorted(missing)}")
            for n in ready:
                order.append(n)
                produced.add(n.name)
                remaining.remove(n)
        return order


class GraphBuilder:
    """(ref: ComputationGraphConfiguration.GraphBuilder, reached via
    NeuralNetConfiguration.Builder().graphBuilder())."""

    def __init__(self, parent=None):
        self._parent = parent
        self._inputs: List[str] = []
        self._outputs: List[str] = []
        self._nodes: List[GraphNode] = []
        self._input_types: List[Optional[InputType]] = []
        self._backprop_type = "Standard"
        self._tbptt_fwd = 20
        self._tbptt_back = 20

    def addInputs(self, *names: str):
        self._inputs.extend(names)
        return self

    def setInputTypes(self, *types: InputType):
        self._input_types = list(types)
        return self

    def addLayer(self, name: str, layer: Layer, *inputs: str):
        layer.name = name
        self._nodes.append(GraphNode(name, layer, list(inputs)))
        return self

    def addVertex(self, name: str, vertex: GraphVertex, *inputs: str):
        self._nodes.append(GraphNode(name, vertex, list(inputs)))
        return self

    def setOutputs(self, *names: str):
        self._outputs = list(names)
        return self

    def backpropType(self, bt: str):
        self._backprop_type = bt
        return self

    def tBPTTForwardLength(self, n: int):
        self._tbptt_fwd = n
        return self

    def tBPTTBackwardLength(self, n: int):
        self._tbptt_back = n
        return self

    def build(self) -> ComputationGraphConfiguration:
        p = self._parent
        conf = ComputationGraphConfiguration(
            networkInputs=list(self._inputs),
            networkOutputs=list(self._outputs),
            nodes=self._nodes,
            inputTypes=list(self._input_types),
            backpropType=self._backprop_type,
            tbpttFwdLength=self._tbptt_fwd,
            tbpttBackLength=self._tbptt_back,
        )
        if p is not None:
            conf.seed = p._seed
            conf.updater = p._updater
            conf.regularization = p._regularization
            conf.gradientNormalization = p._gradNorm
            conf.gradientNormalizationThreshold = p._gradNormThreshold
            conf.dataType = p._dataType
            globals_ = {"activation": p._activation, "weightInit": p._weightInit,
                        "biasInit": p._biasInit, "dropOut": p._dropOut}
            for n in conf.nodes:
                if isinstance(n.op, Layer):
                    n.op.inherit(globals_)
        # InputType propagation for nIn auto-fill across the DAG
        types: Dict[str, Optional[InputType]] = {}
        for i, name in enumerate(conf.networkInputs):
            t = self._input_types[i] if i < len(self._input_types) else None
            types[name] = t.as_cnn() if t else None
        for node in conf.topo_order():
            in_types = [types.get(i) for i in node.inputs]
            if isinstance(node.op, Layer):
                t = in_types[0]
                if t is not None:
                    node.op.set_n_in(t)
                    types[node.name] = node.op.output_type(t)
                else:
                    # fall back to the layer's own nOut so chains stay inferable
                    n_in = getattr(node.op, "nOut", 0)
                    types[node.name] = InputType.feedForward(n_in) if n_in else None
            else:
                types[node.name] = (node.op.output_type(in_types)
                                    if all(t is not None for t in in_types) else None)
        return conf
