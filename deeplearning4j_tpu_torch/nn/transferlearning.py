"""Transfer learning (counterpart: ``deeplearning4j_tpu/nn/transferlearning.py``;
ref: org.deeplearning4j.nn.transferlearning — TransferLearning.Builder
(surgery on a trained MultiLayerNetwork), FineTuneConfiguration,
TransferLearningHelper (frozen featurization)). A frozen layer is one whose
gradients and updates the training step zeroes (``frozen`` on the layer)."""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers import Layer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.train import updaters as _upd
from deeplearning4j_tpu_torch.train.updaters import tree_map


@dataclass
class FineTuneConfiguration:
    """Overrides applied to the copied net (ref: FineTuneConfiguration.Builder)."""
    updater: Optional[_upd.Updater] = None
    seed: Optional[int] = None

    class Builder:
        def __init__(self):
            self._updater = None
            self._seed = None

        def updater(self, u):
            self._updater = u
            return self

        def seed(self, s):
            self._seed = s
            return self

        def build(self):
            return FineTuneConfiguration(updater=self._updater, seed=self._seed)


class TransferLearning:
    """(ref: TransferLearning.Builder for MultiLayerNetwork)."""

    class Builder:
        def __init__(self, net: MultiLayerNetwork):
            self._net = net
            self._layers: List[Layer] = copy.deepcopy(net.conf.layers)
            # map new-layer-index -> source index for param transfer
            self._src_idx: List[Optional[int]] = list(range(len(self._layers)))
            self._reinit: set = set()
            self._ftc: Optional[FineTuneConfiguration] = None
            self._freeze_upto = -1

        def fineTuneConfiguration(self, ftc: FineTuneConfiguration):
            self._ftc = ftc
            return self

        def setFeatureExtractor(self, layer_idx: int):
            """Freeze layers [0, layer_idx] (ref: setFeatureExtractor)."""
            self._freeze_upto = layer_idx
            return self

        def removeOutputLayer(self):
            return self.removeLayersFromOutput(1)

        def removeLayersFromOutput(self, n: int):
            self._layers = self._layers[:-n]
            self._src_idx = self._src_idx[:-n]
            return self

        def addLayer(self, layer: Layer):
            # auto-fill nIn from the preceding layer's nOut when available
            if getattr(layer, "nIn", 0) in (0, None) and self._layers:
                prev_out = getattr(self._layers[-1], "nOut", 0)
                if prev_out and hasattr(layer, "nIn"):
                    layer.nIn = prev_out
            self._layers.append(layer)
            self._src_idx.append(None)
            return self

        def nOutReplace(self, layer_idx: int, n_out: int,
                        weight_init: Optional[str] = None):
            """Change a layer's nOut and re-init it (+ the next layer's nIn)
            (ref: nOutReplace)."""
            l = self._layers[layer_idx]
            l.nOut = n_out
            if weight_init is not None:
                l.weightInit = weight_init
            self._reinit.add(layer_idx)
            if layer_idx + 1 < len(self._layers):
                nxt = self._layers[layer_idx + 1]
                if hasattr(nxt, "nIn"):
                    nxt.nIn = n_out
                self._reinit.add(layer_idx + 1)
            return self

        def build(self) -> MultiLayerNetwork:
            old = self._net
            conf = MultiLayerConfiguration(
                layers=self._layers,
                seed=(self._ftc.seed if self._ftc and self._ftc.seed is not None
                      else old.conf.seed),
                updater=(self._ftc.updater if self._ftc and self._ftc.updater is not None
                         else old.conf.updater),
                inputType=old.conf.inputType,
                regularization=list(old.conf.regularization),
                gradientNormalization=old.conf.gradientNormalization,
                gradientNormalizationThreshold=old.conf.gradientNormalizationThreshold,
                backpropType=old.conf.backpropType,
                tbpttFwdLength=old.conf.tbpttFwdLength,
                tbpttBackLength=old.conf.tbpttBackLength,
                dataType=old.conf.dataType,
            )
            for i in range(min(self._freeze_upto + 1, len(self._layers))):
                self._layers[i].frozen = True
            net = MultiLayerNetwork(conf, device=old.device).init()
            # transfer trained params for retained, un-reinitialized layers
            for new_i, src_i in enumerate(self._src_idx):
                if src_i is not None and new_i not in self._reinit:
                    net._params[new_i] = tree_map(lambda a: a.detach().clone(),
                                                  old._params[src_i])
            net._opt_state = net._tx.init(net._params)
            return net


class TransferLearningHelper:
    """Featurization through the frozen body (ref: TransferLearningHelper)."""

    def __init__(self, net: MultiLayerNetwork, frozen_till: int):
        self.net = net
        self.frozen_till = frozen_till

    def featurize(self, x) -> np.ndarray:
        acts = self.net.feedForward(x)
        return acts[self.frozen_till + 1].toNumpy()
