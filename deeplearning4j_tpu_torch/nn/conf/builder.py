"""Network configuration DSL (counterpart: ``deeplearning4j_tpu/nn/conf/
builder.py``; ref: org.deeplearning4j.nn.conf.NeuralNetConfiguration.Builder
-> ListBuilder -> MultiLayerConfiguration).

Fluent builder with global defaults inherited by layers, InputType-driven
shape inference/nIn auto-fill, and JSON round-trip (the reference's Jackson
serde contract — round-trip equality is itself a tested invariant).
``to_json`` gives the reference's string for the same configuration, so a
configuration saved by either package loads in the other.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List, Optional

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import Layer
from deeplearning4j_tpu_torch.train import regularization as _reg
from deeplearning4j_tpu_torch.train import updaters as _upd


@dataclass
class MultiLayerConfiguration:
    layers: List[Layer] = field(default_factory=list)
    seed: int = 0
    updater: _upd.Updater = field(default_factory=_upd.Sgd)
    inputType: Optional[InputType] = None
    regularization: List[_reg.Regularization] = field(default_factory=list)
    gradientNormalization: Optional[str] = None  # ClipL2PerLayer|ClipElementWiseAbsoluteValue|ClipL2PerParamType
    gradientNormalizationThreshold: float = 1.0
    backpropType: str = "Standard"  # or "TruncatedBPTT"
    tbpttFwdLength: int = 20
    tbpttBackLength: int = 20
    dataType: str = "FLOAT"

    # ---- serde (ref: MultiLayerConfiguration.toJson/fromJson)
    def to_json(self) -> str:
        return json.dumps({
            "layers": [l.to_dict() for l in self.layers],
            "seed": self.seed,
            "updater": self.updater.to_dict(),
            "inputType": self.inputType.to_dict() if self.inputType else None,
            "regularization": [r.to_dict() for r in self.regularization],
            "gradientNormalization": self.gradientNormalization,
            "gradientNormalizationThreshold": self.gradientNormalizationThreshold,
            "backpropType": self.backpropType,
            "tbpttFwdLength": self.tbpttFwdLength,
            "tbpttBackLength": self.tbpttBackLength,
            "dataType": self.dataType,
        }, indent=2)

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        d = json.loads(s)
        return MultiLayerConfiguration(
            layers=[Layer.from_dict(ld) for ld in d["layers"]],
            seed=d.get("seed", 0),
            updater=_upd.from_dict(d["updater"]),
            inputType=InputType.from_dict(d["inputType"]) if d.get("inputType") else None,
            regularization=[_reg.from_dict(r) for r in d.get("regularization", [])],
            gradientNormalization=d.get("gradientNormalization"),
            gradientNormalizationThreshold=d.get("gradientNormalizationThreshold", 1.0),
            backpropType=d.get("backpropType", "Standard"),
            tbpttFwdLength=d.get("tbpttFwdLength", 20),
            tbpttBackLength=d.get("tbpttBackLength", 20),
            dataType=d.get("dataType", "FLOAT"),
        )

    def input_types(self) -> List[InputType]:
        """Per-layer input InputTypes, starting from self.inputType."""
        out = []
        it = self.inputType.as_cnn() if self.inputType else None
        for layer in self.layers:
            out.append(it)
            if it is not None:
                it = layer.output_type(it)
        return out


class NeuralNetConfiguration:
    """Entry point: ``NeuralNetConfiguration.Builder()`` (ref: same name)."""

    class Builder:
        def __init__(self):
            self._seed = 0
            self._updater = _upd.Sgd()
            self._activation = None
            self._weightInit = "XAVIER"
            self._biasInit = 0.0
            self._dropOut = None
            self._regularization: List[_reg.Regularization] = []
            self._gradNorm = None
            self._gradNormThreshold = 1.0
            self._dataType = "FLOAT"

        def seed(self, s: int):
            self._seed = int(s)
            return self

        def updater(self, u: _upd.Updater):
            self._updater = u
            return self

        def activation(self, a: str):
            self._activation = a
            return self

        def weightInit(self, w: str):
            self._weightInit = str(w)
            return self

        def biasInit(self, b: float):
            self._biasInit = b
            return self

        def dropOut(self, retain: float):
            self._dropOut = retain
            return self

        def l1(self, v: float):
            self._regularization.append(_reg.L1(v))
            return self

        def l2(self, v: float):
            self._regularization.append(_reg.L2(v))
            return self

        def weightDecay(self, v: float):
            self._regularization.append(_reg.WeightDecay(v))
            return self

        def gradientNormalization(self, g: str, threshold: float = 1.0):
            self._gradNorm = g
            self._gradNormThreshold = threshold
            return self

        def dataType(self, dt: str):
            self._dataType = dt
            return self

        def list(self) -> "NeuralNetConfiguration.ListBuilder":
            return NeuralNetConfiguration.ListBuilder(self)

        def graphBuilder(self):
            """DAG networks (ref: NeuralNetConfiguration.Builder.graphBuilder)."""
            from deeplearning4j_tpu_torch.nn.conf.graph import GraphBuilder
            return GraphBuilder(self)

    class ListBuilder:
        def __init__(self, parent: "NeuralNetConfiguration.Builder"):
            self._parent = parent
            self._layers: List[Layer] = []
            self._input_type: Optional[InputType] = None
            self._backprop_type = "Standard"
            self._tbptt_fwd = 20
            self._tbptt_back = 20

        def layer(self, *args) -> "NeuralNetConfiguration.ListBuilder":
            """.layer(l) or .layer(index, l) (reference supports both)."""
            l = args[-1]
            self._layers.append(l)
            return self

        def setInputType(self, it: InputType):
            self._input_type = it
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

        def build(self) -> MultiLayerConfiguration:
            p = self._parent
            globals_ = {
                "activation": p._activation,
                "weightInit": p._weightInit,
                "biasInit": p._biasInit,
                "dropOut": p._dropOut,
            }
            it = self._input_type.as_cnn() if self._input_type else None
            if it is None and self._layers:
                # no explicit InputType: synthesize from the first layer's nIn so
                # downstream nIn auto-fill still works (ref: dl4j requires explicit
                # nIn when no InputType is set; we propagate it instead)
                from deeplearning4j_tpu_torch.nn.conf.layers import (
                    BaseRecurrentLayer, Bidirectional, EmbeddingSequenceLayer,
                )
                first = self._layers[0]
                n_in = getattr(first, "nIn", 0)
                if isinstance(first, Bidirectional):
                    n_in = getattr(first.fwd, "nIn", 0)
                if n_in:
                    if isinstance(first, (BaseRecurrentLayer, EmbeddingSequenceLayer)) or (
                            isinstance(first, Bidirectional)):
                        it = InputType.recurrent(n_in)
                    else:
                        it = InputType.feedForward(n_in)
            for layer in self._layers:
                layer.inherit(globals_)
                if it is not None:
                    layer.set_n_in(it)
                    it = layer.output_type(it)
            return MultiLayerConfiguration(
                layers=self._layers,
                seed=p._seed,
                updater=p._updater,
                inputType=self._input_type,
                regularization=p._regularization,
                gradientNormalization=p._gradNorm,
                gradientNormalizationThreshold=p._gradNormThreshold,
                backpropType=self._backprop_type,
                tbpttFwdLength=self._tbptt_fwd,
                tbpttBackLength=self._tbptt_back,
                dataType=p._dataType,
            )
