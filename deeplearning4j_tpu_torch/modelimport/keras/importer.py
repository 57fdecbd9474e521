"""Keras h5 -> network import (counterpart:
``deeplearning4j_tpu/modelimport/keras/importer.py``; ref:
deeplearning4j-modelimport —
KerasModelImport.importKerasSequentialModelAndWeights /
importKerasModelAndWeights; per-layer mappers under
o.d.nn.modelimport.keras.layers.*; weights via Hdf5Archive).

Layout conversion is the core job, exactly as in the reference's KerasLayer
mappers: Keras is channels_last (NHWC, HWIO kernels); this framework is NCHW /
OIHW. Conv kernels are transposed; a Dense that directly follows a Flatten of
a conv feature map gets its input rows permuted from Keras' (H,W,C) flatten
order to our (C,H,W) order (ref: KerasModelUtils weight reshaping).

Supports the Keras-3 legacy ``.h5`` container (``model_config`` JSON attr +
``model_weights`` groups) for both Sequential and Functional models. The
network is built on ``device`` (default ``"cuda"``); ``h5py`` is imported
only inside the functions that read the file."""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.computation_graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.conf.graph import ElementWiseVertex, MergeVertex
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.train.updaters import Adam

_ACT = {
    "relu": "RELU", "softmax": "SOFTMAX", "sigmoid": "SIGMOID", "tanh": "TANH",
    "linear": "IDENTITY", "elu": "ELU", "selu": "SELU", "softplus": "SOFTPLUS",
    "softsign": "SOFTSIGN", "hard_sigmoid": "HARDSIGMOID", "swish": "SWISH",
    "gelu": "GELU", "leaky_relu": "LEAKYRELU", "exponential": "IDENTITY",
}


def _act(name: Optional[str]) -> str:
    return _ACT.get((name or "linear").lower(), "IDENTITY")


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


def _one(v):
    """Keras scalar-or-singleton-list -> scalar (1D layer configs)."""
    return v[0] if isinstance(v, (list, tuple)) else v


def _flat3(p):
    """Keras 3D padding/cropping spec -> flat (d0,d1,h0,h1,w0,w1)."""
    if isinstance(p, int):
        return (p,) * 6
    out = []
    for d in p:
        a, b = (d, d) if isinstance(d, int) else (d[0], d[1])
        out += [a, b]
    return tuple(out)


class _WeightStore:
    """Reads Keras-3 legacy h5 weight groups: model_weights/<layer>/**/<name>."""

    def __init__(self, h5file):
        self.f = h5file

    def layer_weights(self, layer_name: str) -> Dict[str, np.ndarray]:
        """Flat {basename: array} for the layer (unique within one layer)."""
        return {k.rsplit("/", 1)[-1]: v
                for k, v in self.layer_weight_paths(layer_name).items()}

    def layer_weight_paths(self, layer_name: str) -> Dict[str, np.ndarray]:
        """Full-path {path: array} — needed for wrappers (Bidirectional) whose
        sub-layers repeat dataset names."""
        mw = self.f["model_weights"]
        if layer_name not in mw:
            return {}
        out = {}

        def walk(group, prefix=""):
            import h5py
            for k in group:
                item = group[k]
                key = f"{prefix}{k}"
                if isinstance(item, h5py.Group):
                    walk(item, key + "/")
                else:
                    out[key.split(":")[0]] = np.asarray(item)

        walk(mw[layer_name])
        return out


class KerasModelImport:
    """(ref: org.deeplearning4j.nn.modelimport.keras.KerasModelImport)."""

    @staticmethod
    def importKerasSequentialModelAndWeights(path: str,
                                             enforceTrainingConfig: bool = False,
                                             device=None) -> MultiLayerNetwork:
        import h5py
        with h5py.File(path, "r") as f:
            cfg = json.loads(f.attrs["model_config"])
            if cfg["class_name"] != "Sequential":
                raise ValueError(
                    f"{path} holds a {cfg['class_name']} — use importKerasModelAndWeights")
            store = _WeightStore(f)
            return _import_sequential(cfg["config"], store, device)

    @staticmethod
    def importKerasModelAndWeights(path: str,
                                   enforceTrainingConfig: bool = False,
                                   device=None) -> ComputationGraph:
        import h5py
        with h5py.File(path, "r") as f:
            cfg = json.loads(f.attrs["model_config"])
            if cfg["class_name"] == "Sequential":
                raise ValueError(
                    f"{path} holds a Sequential — use importKerasSequentialModelAndWeights")
            store = _WeightStore(f)
            return _import_functional(cfg["config"], store, device)


# ---------------------------------------------------------------- mapping

def _input_type_from_shape(shape, consumer_cls: Optional[str] = None
                           ) -> Optional[InputType]:
    """Keras batch_shape (None, H, W, C) / (None, T, F) / (None, F) ->
    InputType. A 4-post-batch-dim input is ambiguous (NDHWC 3D conv vs a
    (T, H, W, C) image sequence); ``consumer_cls`` — the first layer that
    consumes this input — disambiguates."""
    dims = [d for d in shape[1:]]
    if len(dims) == 4 and consumer_cls == "ConvLSTM2D":
        t, h, w, c = dims
        return InputType.convolutionalSequence(h, w, c, t or -1)
    if len(dims) == 4:  # NDHWC -> 3D conv, channels-first internally
        d, h, w, c = dims
        return InputType.convolutional3D(d, h, w, c)
    if len(dims) == 3:
        h, w, c = dims
        return InputType.convolutional(h, w, c)
    if len(dims) == 2:
        return InputType.recurrent(dims[1], dims[0] or -1)
    if len(dims) == 1:
        return InputType.feedForward(dims[0])
    return None


def _map_layer(cls: str, c: dict) -> Tuple[Optional[L.Layer], bool]:
    """Keras layer config -> (Layer | None, consumes_weights). None = structural
    no-op at our level (Flatten/InputLayer)."""
    act = _act(c.get("activation"))
    same = (c.get("padding", "valid") == "same")
    mode = "Same" if same else "Truncate"
    if cls == "TimeDistributed":
        # ref: KerasTimeDistributed — unwrap; a Dense applied per timestep is
        # exactly our DenseLayer on (B, T, F) (the matmul broadcasts over T)
        inner = c["layer"]
        inner_cls = inner["class_name"]
        if inner_cls not in ("Dense", "Activation", "Dropout"):
            raise ValueError(
                f"TimeDistributed({inner_cls}) not supported by the importer")
        return _map_layer(inner_cls, inner["config"])
    if cls == "RepeatVector":
        return L.RepeatVector(repetitionFactor=c["n"]), False
    if cls == "ConvLSTM2D":
        if c.get("data_format", "channels_last") != "channels_last":
            raise ValueError("ConvLSTM2D: only channels_last exports supported")
        if c.get("padding", "valid") != "same":
            raise ValueError("ConvLSTM2D: only padding='same' supported "
                             "(the layer keeps H, W)")
        if c.get("activation", "tanh") != "tanh":
            raise ValueError("ConvLSTM2D: only activation='tanh' supported")
        if c.get("recurrent_activation", "sigmoid") != "sigmoid":
            raise ValueError("ConvLSTM2D: only recurrent_activation='sigmoid' supported")
        if _pair(c.get("strides", 1)) != (1, 1) or _pair(c.get("dilation_rate", 1)) != (1, 1):
            raise ValueError("ConvLSTM2D: strides/dilation_rate must be 1")
        return L.ConvLSTM2D(nOut=c["filters"], kernelSize=_pair(c["kernel_size"]),
                            returnSequences=c.get("return_sequences", False)), True
    if cls == "Dense":
        return L.DenseLayer(nOut=c["units"], activation=act,
                            hasBias=c.get("use_bias", True)), True
    if cls == "Conv2D":
        return L.ConvolutionLayer(nOut=c["filters"], kernelSize=_pair(c["kernel_size"]),
                                  stride=_pair(c.get("strides", 1)),
                                  dilation=_pair(c.get("dilation_rate", 1)),
                                  convolutionMode=mode, activation=act,
                                  hasBias=c.get("use_bias", True)), True
    if cls == "DepthwiseConv2D":
        return L.DepthwiseConvolution2D(depthMultiplier=c.get("depth_multiplier", 1),
                                        kernelSize=_pair(c["kernel_size"]),
                                        stride=_pair(c.get("strides", 1)),
                                        convolutionMode=mode, activation=act,
                                        hasBias=c.get("use_bias", True)), True
    if cls == "SeparableConv2D":
        return L.SeparableConvolution2D(nOut=c["filters"], kernelSize=_pair(c["kernel_size"]),
                                        stride=_pair(c.get("strides", 1)),
                                        convolutionMode=mode, activation=act,
                                        hasBias=c.get("use_bias", True)), True
    if cls == "Conv2DTranspose":
        return L.Deconvolution2D(nOut=c["filters"], kernelSize=_pair(c["kernel_size"]),
                                 stride=_pair(c.get("strides", 1)),
                                 convolutionMode=mode, activation=act,
                                 hasBias=c.get("use_bias", True)), True
    if cls in ("MaxPooling2D", "AveragePooling2D"):
        return L.SubsamplingLayer(
            poolingType="MAX" if cls.startswith("Max") else "AVG",
            kernelSize=_pair(c.get("pool_size", 2)),
            stride=_pair(c.get("strides") or c.get("pool_size", 2)),
            convolutionMode=mode), False
    if cls in ("GlobalAveragePooling2D", "GlobalMaxPooling2D",
               "GlobalAveragePooling1D", "GlobalMaxPooling1D"):
        return L.GlobalPoolingLayer(
            poolingType="AVG" if "Average" in cls else "MAX"), False
    if cls == "BatchNormalization":
        return L.BatchNormalization(eps=c.get("epsilon", 1e-3),
                                    decay=c.get("momentum", 0.99)), True
    if cls == "Dropout":
        return L.DropoutLayer(dropOut=1.0 - c["rate"]), False
    if cls == "GaussianDropout":
        from deeplearning4j_tpu_torch.nn.conf.dropout import GaussianDropout
        return L.DropoutLayer(dropOut=GaussianDropout(rate=c["rate"])), False
    if cls == "GaussianNoise":
        from deeplearning4j_tpu_torch.nn.conf.dropout import GaussianNoise
        return L.DropoutLayer(dropOut=GaussianNoise(stddev=c["stddev"])), False
    if cls == "AlphaDropout":
        from deeplearning4j_tpu_torch.nn.conf.dropout import AlphaDropout
        return L.DropoutLayer(dropOut=AlphaDropout(p=1.0 - c["rate"])), False
    if cls in ("SpatialDropout1D", "SpatialDropout2D", "SpatialDropout3D"):
        from deeplearning4j_tpu_torch.nn.conf.dropout import SpatialDropout
        return L.DropoutLayer(dropOut=SpatialDropout(p=1.0 - c["rate"])), False
    if cls == "ThresholdedReLU":
        return L.ActivationLayer(activation="THRESHOLDEDRELU",
                                 alpha=c.get("theta", 1.0)), False
    if cls == "Activation":
        return L.ActivationLayer(activation=act), False
    if cls == "ReLU":
        # Keras 3 folded ThresholdedReLU into ReLU(threshold=...); honor the
        # parameterization instead of silently dropping it
        thr = c.get("threshold", 0.0) or 0.0
        ns = c.get("negative_slope", 0.0) or 0.0
        mv = c.get("max_value")
        if thr and not ns and mv is None:
            return L.ActivationLayer(activation="THRESHOLDEDRELU", alpha=thr), False
        if ns and not thr and mv is None:
            return L.ActivationLayer(activation="LEAKYRELU", alpha=ns), False
        if mv == 6.0 and not thr and not ns:
            return L.ActivationLayer(activation="RELU6"), False
        if thr or ns or mv is not None:
            raise ValueError(
                f"ReLU(threshold={thr}, negative_slope={ns}, max_value={mv}) "
                "combination not supported by the importer")
        return L.ActivationLayer(activation="RELU"), False
    if cls == "LeakyReLU":
        # Keras default negative_slope is 0.3 (keras-2 key: "alpha")
        return L.ActivationLayer(activation="LEAKYRELU",
                                 alpha=c.get("negative_slope",
                                             c.get("alpha", 0.3))), False
    if cls == "Softmax":
        return L.ActivationLayer(activation="SOFTMAX"), False
    if cls == "ZeroPadding2D":
        p = c.get("padding", 1)
        if isinstance(p, (list, tuple)) and isinstance(p[0], (list, tuple)):
            pad = (p[0][0], p[0][1], p[1][0], p[1][1])
        else:
            p = _pair(p)
            pad = (p[0], p[0], p[1], p[1])
        return L.ZeroPaddingLayer(padding=pad), False
    if cls == "Cropping2D":
        p = c.get("cropping", 1)
        if isinstance(p, (list, tuple)) and isinstance(p[0], (list, tuple)):
            crop = (p[0][0], p[0][1], p[1][0], p[1][1])
        else:
            p = _pair(p)
            crop = (p[0], p[0], p[1], p[1])
        return L.Cropping2D(cropping=crop), False
    if cls == "UpSampling2D":
        return L.Upsampling2D(size=_pair(c.get("size", 2))), False
    if cls == "Conv1D":
        if c.get("padding") == "causal":
            raise ValueError("Conv1D(padding='causal') import is not supported")
        return L.Convolution1DLayer(
            nOut=c["filters"], kernelSize=_one(c["kernel_size"]),
            stride=_one(c.get("strides", 1)),
            dilation=_one(c.get("dilation_rate", 1)),
            convolutionMode=mode, activation=act,
            hasBias=c.get("use_bias", True)), True
    if cls == "Conv3D":
        dil = c.get("dilation_rate", (1, 1, 1))
        return L.Convolution3D(nOut=c["filters"],
                               kernelSize=tuple(c["kernel_size"]),
                               stride=tuple(c.get("strides", (1, 1, 1))),
                               dilation=tuple(dil) if isinstance(dil, (list, tuple))
                               else (dil,) * 3,
                               convolutionMode=mode, activation=act,
                               hasBias=c.get("use_bias", True)), True
    if cls in ("MaxPooling1D", "AveragePooling1D"):
        if same:
            raise ValueError(f"{cls}(padding='same') import is not supported")
        ps = _one(c.get("pool_size", 2))
        return L.Subsampling1DLayer(
            poolingType="MAX" if cls.startswith("Max") else "AVG",
            kernelSize=ps, stride=_one(c.get("strides") or ps)), False
    if cls in ("MaxPooling3D", "AveragePooling3D"):
        ps = c.get("pool_size", (2, 2, 2))
        return L.Subsampling3DLayer(
            poolingType="MAX" if cls.startswith("Max") else "AVG",
            kernelSize=tuple(ps), stride=tuple(c.get("strides") or ps),
            convolutionMode=mode), False
    if cls == "UpSampling1D":
        return L.Upsampling1D(size=c.get("size", 2)), False
    if cls == "UpSampling3D":
        return L.Upsampling3D(size=tuple(c.get("size", (2, 2, 2)))), False
    if cls == "ZeroPadding1D":
        p = _pair(c.get("padding", 1))
        return L.ZeroPadding1DLayer(padding=(p[0], p[1])), False
    if cls == "Cropping1D":
        p = _pair(c.get("cropping", 1))
        return L.Cropping1D(cropping=(p[0], p[1])), False
    if cls == "ZeroPadding3D":
        p = c.get("padding", 1)
        flat = _flat3(p)
        return L.ZeroPadding3DLayer(padding=flat), False
    if cls == "Cropping3D":
        flat = _flat3(c.get("cropping", 1))
        return L.Cropping3D(cropping=flat), False
    if cls == "ELU":
        return L.ActivationLayer(activation="ELU",
                                 alpha=c.get("alpha", 1.0)), False
    if cls == "PReLU":
        # shared_axes are keras channels-LAST per-example axes; ours are
        # channels-first. 2D conv: (H,W,C) 1,2,3 -> (C,H,W) 2,3,1.
        # 3D conv: (D,H,W,C) 1,2,3,4 -> (C,D,H,W) 2,3,4,1. The maps agree
        # on axes {1,2}; axis 3 is ambiguous without the input rank, so it
        # is only accepted when axis 4 disambiguates to the 3D case.
        axes = tuple(c.get("shared_axes") or ())
        if 4 in axes:
            amap = {1: 2, 2: 3, 3: 4, 4: 1}
        elif 3 in axes:
            raise ValueError(
                "PReLU(shared_axes containing 3) is ambiguous between 2D "
                "(channel axis) and 3D (width axis) inputs; re-export with "
                "explicit per-element alpha or include axis 4")
        else:
            amap = {1: 2, 2: 3}
        return L.PReLULayer(sharedAxes=tuple(amap[a] for a in axes)), True
    if cls == "Masking":
        import warnings
        warnings.warn(
            "Keras Masking imports as value-zeroing only: a downstream RNN "
            "still steps through masked positions (state at T-1, not at the "
            "last unmasked step). Pass explicit masks / use padded-value "
            "zeroing semantics, or slice sequences before import.")
        return L.MaskZeroLayer(maskValue=c.get("mask_value", 0.0)), False
    if cls == "Embedding":
        return L.EmbeddingSequenceLayer(nIn=c["input_dim"], nOut=c["output_dim"]), True
    if cls in ("LSTM", "GRU", "SimpleRNN"):
        if cls == "LSTM":
            cell = L.LSTM(nOut=c["units"], activation=_act(c.get("activation", "tanh")))
        elif cls == "GRU":
            if not c.get("reset_after", True):
                raise ValueError("GRU(reset_after=False) import is not supported")
            cell = L.GRU(nOut=c["units"])
        else:
            cell = L.SimpleRnn(nOut=c["units"],
                               activation=_act(c.get("activation", "tanh")))
        if not c.get("return_sequences", False):
            # Keras LSTM(units) returns the LAST step only (ref: KerasLSTM ->
            # LastTimeStep wrapper)
            return L.LastTimeStep(underlying=cell), True
        return cell, True
    if cls == "Bidirectional":
        inner_cls = c["layer"]["class_name"]
        inner, _ = _map_layer(inner_cls, c["layer"]["config"])
        if isinstance(inner, L.LastTimeStep):
            # Keras Bidirectional(return_sequences=False) concatenates the fwd
            # state at T-1 with the bwd state at 0 — no single-wrapper parity
            raise ValueError("Bidirectional(return_sequences=False) import is "
                             "not supported; re-export with return_sequences=True")
        return L.Bidirectional(fwd=inner, mode=c.get("merge_mode", "concat").upper()), True
    if cls == "Reshape":
        return L.ReshapeLayer(targetShape=tuple(c["target_shape"])), False
    if cls == "Permute":
        return L.PermuteLayer(permuteDims=tuple(c["dims"])), False
    if cls in ("Flatten", "InputLayer"):
        return None, False
    raise ValueError(f"Keras layer type {cls} is not supported by the importer "
                     f"(ref: KerasLayer registry)")


def _convert_weights(layer: L.Layer, kw: Dict[str, np.ndarray],
                     flatten_src: Optional[InputType],
                     paths: Optional[Dict[str, np.ndarray]] = None) -> dict:
    """Keras weight dict -> our param dict, with layout conversion."""
    def t_conv(k):  # HWIO -> OIHW
        return np.transpose(k, (3, 2, 0, 1))

    if isinstance(layer, L.LastTimeStep):  # params are the wrapped cell's
        return _convert_weights(layer.underlying, kw, flatten_src, paths)
    if isinstance(layer, L.Bidirectional):
        fwd = {k.rsplit("/", 1)[-1]: v for k, v in (paths or {}).items()
               if "backward" not in k}
        bwd = {k.rsplit("/", 1)[-1]: v for k, v in (paths or {}).items()
               if "backward" in k}
        return {"fwd": _convert_weights(layer.fwd, fwd, None),
                "bwd": _convert_weights(layer.fwd, bwd, None)}

    if isinstance(layer, L.ConvLSTM2D):
        p = {"W": np.transpose(kw["kernel"], (3, 2, 0, 1)),
             "RW": np.transpose(kw["recurrent_kernel"], (3, 2, 0, 1))}
        # apply() reads params['b'] unconditionally, so use_bias=False h5
        # files get an explicit zero bias (gate order i,f,c,o; 4*filters).
        p["b"] = kw.get("bias", np.zeros(kw["kernel"].shape[-1],
                                         dtype=kw["kernel"].dtype))
        return p
    if isinstance(layer, L.SeparableConvolution2D):
        p = {"dW": np.transpose(kw["depthwise_kernel"], (2, 3, 0, 1)),
             "pW": np.transpose(kw["pointwise_kernel"], (3, 2, 0, 1))}
        if "bias" in kw:
            p["b"] = kw["bias"]
        return p
    if isinstance(layer, L.DepthwiseConvolution2D):
        k = kw["kernel"]  # (kh, kw, C, mult) -> (C*mult, 1, kh, kw)
        kh, kwid, C, mult = k.shape
        p = {"W": k.transpose(2, 3, 0, 1).reshape(C * mult, 1, kh, kwid)}
        if "bias" in kw:
            p["b"] = kw["bias"]
        return p
    if isinstance(layer, L.Deconvolution2D):
        # keras Conv2DTranspose kernel: (kh, kw, out, in)
        p = {"W": np.transpose(kw["kernel"], (2, 3, 0, 1))}
        if "bias" in kw:
            p["b"] = kw["bias"]
        return p
    if isinstance(layer, L.Convolution1DLayer):
        p = {"W": np.transpose(kw["kernel"], (2, 1, 0))}  # (K,I,O) -> (O,I,K)
        if "bias" in kw:
            p["b"] = kw["bias"]
        return p
    if isinstance(layer, L.Convolution3D):
        # (kd,kh,kw,I,O) -> (O,I,kd,kh,kw)
        p = {"W": np.transpose(kw["kernel"], (4, 3, 0, 1, 2))}
        if "bias" in kw:
            p["b"] = kw["bias"]
        return p
    if isinstance(layer, L.ConvolutionLayer):
        p = {"W": t_conv(kw["kernel"])}
        if "bias" in kw:
            p["b"] = kw["bias"]
        return p
    if isinstance(layer, L.PReLULayer):
        a = kw["alpha"]
        if a.ndim == 3:    # keras (H,W,C) -> ours (C,H,W)
            a = np.transpose(a, (2, 0, 1))
        elif a.ndim == 4:  # keras (D,H,W,C) -> ours (C,D,H,W)
            a = np.transpose(a, (3, 0, 1, 2))
        return {"alpha": a}
    if isinstance(layer, L.BatchNormalization):
        return {"gamma": kw.get("gamma", np.ones_like(kw["moving_mean"])),
                "beta": kw.get("beta", np.zeros_like(kw["moving_mean"])),
                "_mean": kw["moving_mean"], "_var": kw["moving_variance"]}
    if isinstance(layer, L.GRU):
        W, U = kw["kernel"], kw["recurrent_kernel"]
        b = kw.get("bias")
        H = layer.nOut
        perm = _gru_perm(H)  # keras [z,r,h] -> ours [r,z,n]
        p = {"W": W[:, perm], "RW": U[:, perm]}
        if b is not None:
            b = np.asarray(b)
            if b.ndim == 2:  # reset_after: (2, 3H) = [input bias, recurrent bias]
                p["bi"], p["bh"] = b[0][perm], b[1][perm]
            else:
                p["bi"], p["bh"] = b[perm], np.zeros_like(b[perm])
        else:
            p["bi"] = np.zeros((3 * H,), W.dtype)
            p["bh"] = np.zeros((3 * H,), W.dtype)
        return p
    if isinstance(layer, L.LSTM):  # keras gate order [i,f,c,o] == ours [i,f,g,o]
        p = {"W": kw["kernel"], "RW": kw["recurrent_kernel"]}
        p["b"] = kw.get("bias", np.zeros((4 * layer.nOut,), kw["kernel"].dtype))
        return p
    if isinstance(layer, L.SimpleRnn):
        return {"W": kw["kernel"], "RW": kw["recurrent_kernel"],
                "b": kw.get("bias", np.zeros((layer.nOut,), kw["kernel"].dtype))}
    if isinstance(layer, (L.EmbeddingSequenceLayer, L.EmbeddingLayer)):
        return {"W": kw["embeddings"]}
    if isinstance(layer, (L.DenseLayer, L.BaseOutputLayer)):
        W = kw["kernel"]
        if flatten_src is not None and flatten_src.kind == "cnn":
            # permute rows: keras flatten order (H,W,C) -> ours (C,H,W)
            H, Wd, C = flatten_src.height, flatten_src.width, flatten_src.channels
            idx = np.arange(H * Wd * C).reshape(H, Wd, C).transpose(2, 0, 1).ravel()
            W = W[idx]
        elif flatten_src is not None and flatten_src.kind == "cnn3d":
            # keras flatten order (D,H,W,C) -> ours (C,D,H,W)
            D, H, Wd, C = (flatten_src.depth, flatten_src.height,
                           flatten_src.width, flatten_src.channels)
            idx = np.arange(D * H * Wd * C).reshape(D, H, Wd, C) \
                .transpose(3, 0, 1, 2).ravel()
            W = W[idx]
        p = {"W": W}
        if "bias" in kw:
            p["b"] = kw["bias"]
        return p
    raise ValueError(f"no weight mapper for {type(layer).__name__}")


def _gru_perm(H: int) -> np.ndarray:
    # columns [z | r | h] -> [r | z | n]
    return np.concatenate([np.arange(H, 2 * H), np.arange(0, H),
                           np.arange(2 * H, 3 * H)])


def _set_weights(net_params: dict, layer: L.Layer, state: dict, converted: dict,
                 device):
    def t(a):   # the h5's dtype, as the reference keeps it
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    mean = converted.pop("_mean", None)
    var = converted.pop("_var", None)
    for k, v in converted.items():
        net_params[k] = ({kk: t(vv) for kk, vv in v.items()}
                         if isinstance(v, dict) else t(v))
    if mean is not None:
        state["mean"] = t(mean)
        state["var"] = t(var)


def _import_sequential(cfg: dict, store: _WeightStore, device=None) -> MultiLayerNetwork:
    layers_cfg = cfg["layers"]
    built: List[Tuple[str, L.Layer, bool, Optional[InputType]]] = []
    input_type: Optional[InputType] = None
    cur_type: Optional[InputType] = None
    flatten_pending: Optional[InputType] = None

    b = NeuralNetConfiguration.Builder().updater(Adam(1e-3)).list()
    # a 4-post-batch-dim input is NDHWC (3D conv) UNLESS the first real layer
    # is ConvLSTM2D, where it is a (T, H, W, C) image sequence
    first_real = next((lc["class_name"] for lc in layers_cfg
                       if lc["class_name"] != "InputLayer"), None)
    for lc in layers_cfg:
        cls, c = lc["class_name"], lc["config"]
        if cls == "InputLayer":
            input_type = _input_type_from_shape(
                c.get("batch_shape") or c["batch_input_shape"],
                consumer_cls=first_real)
            cur_type = input_type
            continue
        layer, has_w = _map_layer(cls, c)
        if layer is None:  # Flatten: remember the conv shape for Dense row perm
            if cur_type is not None and cur_type.kind in ("cnn", "cnn3d"):
                flatten_pending = cur_type
                cur_type = InputType.feedForward(cur_type.flat_size())
            elif cur_type is not None and cur_type.kind in ("rnn", "cnnseq"):
                raise ValueError(
                    "Flatten over a sequence feature map is not "
                    "supported by the importer — use GlobalAveragePooling1D/"
                    "GlobalMaxPooling1D (imported as GlobalPoolingLayer) or "
                    "an RNN with return_sequences=False instead")
            continue
        layer.name = c.get("name", cls.lower())
        b = b.layer(layer)
        # the flatten row-permutation applies to the first WEIGHTED consumer;
        # weightless layers between Flatten and Dense (Dropout/Activation) are
        # elementwise and preserve feature order, so the marker passes through
        fl_for_layer = flatten_pending if has_w else None
        built.append((layer.name, layer, has_w, fl_for_layer))
        if has_w:
            flatten_pending = None
        if cur_type is not None:
            layer.set_n_in(cur_type)
            cur_type = layer.output_type(cur_type)
    if input_type is not None:
        b = b.setInputType(input_type)
    net = MultiLayerNetwork(b.build(), device=device).init()
    for i, (name, layer, has_w, fl_src) in enumerate(built):
        if not has_w:
            continue
        kw = store.layer_weights(name)
        if not kw:
            continue
        converted = _convert_weights(layer, kw, fl_src,
                                     paths=store.layer_weight_paths(name))
        net._params[i] = dict(net._params[i])
        _set_weights(net._params[i], layer, net._state[i], converted, net.device)
    net._opt_state = net._tx.init(net._params)
    return net


def _import_functional(cfg: dict, store: _WeightStore, device=None) -> ComputationGraph:
    layers_cfg = cfg["layers"]
    g = NeuralNetConfiguration.Builder().updater(Adam(1e-3)).graphBuilder()
    input_types: List[InputType] = []
    name_alias: Dict[str, str] = {}   # keras node name -> our graph node name
    weighted: List[Tuple[str, L.Layer, Optional[InputType]]] = []
    type_at: Dict[str, Optional[InputType]] = {}
    flatten_src: Dict[str, Optional[InputType]] = {}

    def inbound(lc) -> List[str]:
        names = []
        for node in lc.get("inbound_nodes", []):
            if isinstance(node, dict):  # keras 3 format
                for arg in node.get("args", []):
                    names.extend(_hist_names(arg))
            else:  # keras 2: [[name, idx, tensor_idx, {}], ...]
                for item in node:
                    names.append(item[0])
        return [name_alias.get(n, n) for n in names]

    def _hist_names(arg):
        out = []
        if isinstance(arg, dict) and arg.get("class_name") == "__keras_tensor__":
            out.append(arg["config"]["keras_history"][0])
        elif isinstance(arg, (list, tuple)):
            for a in arg:
                out.extend(_hist_names(a))
        return out

    for lc in layers_cfg:
        cls, c = lc["class_name"], lc["config"]
        name = c.get("name", cls.lower())
        ins = inbound(lc)
        if cls == "InputLayer":
            g.addInputs(name)
            consumer = next(
                (lc2["class_name"] for lc2 in layers_cfg
                 if lc2["class_name"] != "InputLayer"
                 and name in inbound(lc2)), None)
            t = _input_type_from_shape(
                c.get("batch_shape") or c["batch_input_shape"],
                consumer_cls=consumer)
            input_types.append(t)
            type_at[name] = t
            continue
        if cls == "Add":
            g.addVertex(name, ElementWiseVertex(op="Add"), *ins)
            type_at[name] = type_at.get(ins[0])
            continue
        if cls in ("Concatenate", "Merge"):
            g.addVertex(name, MergeVertex(), *ins)
            ts = [type_at.get(i) for i in ins]
            type_at[name] = MergeVertex().output_type(ts) if all(ts) else None
            continue
        if cls in ("Multiply", "Average", "Maximum", "Subtract"):
            op = {"Multiply": "Product", "Average": "Average",
                  "Maximum": "Max", "Subtract": "Subtract"}[cls]
            g.addVertex(name, ElementWiseVertex(op=op), *ins)
            type_at[name] = type_at.get(ins[0])
            continue
        layer, has_w = _map_layer(cls, c)
        if layer is None:  # Flatten
            src = ins[0]
            t = type_at.get(src)
            name_alias[name] = src
            if t is not None and t.kind in ("cnn", "cnn3d"):
                flatten_src[src] = t
                type_at[src] = t  # unchanged; Dense consumer handles perm
            elif t is not None and t.kind in ("rnn", "cnnseq"):
                raise ValueError(
                    "Flatten over a sequence feature map is not "
                    "supported by the importer — use GlobalAveragePooling1D/"
                    "GlobalMaxPooling1D (imported as GlobalPoolingLayer) or "
                    "a recurrent layer with return_sequences=False instead")
            continue
        layer.name = name
        src = ins[0] if ins else None
        g.addLayer(name, layer, *(ins if ins else []))
        t = type_at.get(src) if src else None
        fl = None
        if src in flatten_src:
            if has_w:  # first weighted consumer takes the row permutation
                fl = flatten_src[src]
                layer.set_n_in(InputType.feedForward(fl.flat_size()))
                type_at[name] = layer.output_type(
                    InputType.feedForward(fl.flat_size()))
            else:      # weightless elementwise layer: marker flows through
                flatten_src[name] = flatten_src[src]
                type_at[name] = InputType.feedForward(flatten_src[src].flat_size())
        elif t is not None:
            layer.set_n_in(t)
            type_at[name] = layer.output_type(t)
        else:
            type_at[name] = None
        if has_w:
            weighted.append((name, layer, fl))

    ol = cfg.get("output_layers", [])
    if ol and isinstance(ol[0], str):  # single output: ["name", idx, tensor_idx]
        ol = [ol]
    outputs = [name_alias.get(n[0], n[0]) for n in ol]
    g.setOutputs(*outputs)
    g.setInputTypes(*[t for t in input_types if t is not None])
    net = ComputationGraph(g.build(), device=device).init()
    for name, layer, fl in weighted:
        kw = store.layer_weights(name)
        if not kw:
            continue
        converted = _convert_weights(layer, kw, fl,
                                     paths=store.layer_weight_paths(name))
        net._params[name] = dict(net._params[name])
        _set_weights(net._params[name], layer, net._state[name], converted,
                     net.device)
    net._opt_state = net._tx.init(net._params)
    return net
