"""Layer configuration classes fused with their runtime (counterpart:
``deeplearning4j_tpu/nn/conf/layers.py``; ref: org.deeplearning4j.nn.conf.layers.* and the
org.deeplearning4j.nn.layers.* mirror tree).

Each config class carries its own runtime, as in the reference:

- ``init_params(key, dtype, device)`` — parameter dict (ref:
  nn.params.*ParamInitializer), drawn from an explicit threefry key so the
  same key gives the reference's weights;
- ``init_state(dtype, device)`` — non-trainable state (BN running stats;
  norm statistics are kept >= fp32 even when ``dtype`` is bf16);
- ``apply(params, x, ...)`` — forward on torch tensors; gradients come
  from autograd;
- ``output_type(input)`` — shape inference (ref: InputType.getOutputType);
- ``set_n_in(input)`` — nIn auto-fill (ref: overrideNinUponBuild).

Layers call the port's registry functions where the reference calls its
own (``ops.nn_defs.conv2d``, ``lstm_layer``, ``multi_head_attention``, ...),
so they compute what those were held to. ``SelfAttentionLayer`` reaches
the hand-written packed attention kernels (forward and backward) through
``multi_head_attention`` on CUDA tensors.

JSON round-trip via to_dict/from_dict (the reference's field names).
:data:`LAYER_TYPES` holds the reference's 57 layer types.

Layout conventions: CNN = NCHW + OIHW kernels (reference default); RNN
sequences = (batch, time, features) (NWC), with NCW (the reference's
[b, size, t]) accepted via ``rnnDataFormat``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.models import random as _prng
from deeplearning4j_tpu_torch.nn.conf import weights as _winit
from deeplearning4j_tpu_torch.nn import data_shard as _shard
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.ops import nn_defs as _nnops
from deeplearning4j_tpu_torch.train import activations as _act
from deeplearning4j_tpu_torch.train import losses as _losses


def _pair(v):
    if isinstance(v, (tuple, list)):
        return tuple(v)
    return (v, v)


def _conv_out(size, k, s, p, mode):
    if mode == "Same":
        return -(-size // s)  # ceil
    return (size + 2 * p - k) // s + 1


def _split(key, num=2):
    return _prng.split(key, num)


def _full(n, value, dtype, device):
    return torch.full((n,), value, dtype=dtype, device=device)


def _dev(device):
    from deeplearning4j_tpu_torch import default_device

    return default_device(device)


@dataclass
class Layer:
    """Base layer config. Fields with None inherit the builder's globals
    (ref: NeuralNetConfiguration.Builder global defaults)."""

    name: Optional[str] = None
    activation: Optional[str] = None
    weightInit: Optional[str] = None
    biasInit: Optional[float] = None
    dropOut: Optional[float] = None  # RETAIN probability (dl4j semantics)

    # ---- build-time plumbing
    def inherit(self, globals_: dict):
        for k, v in globals_.items():
            if hasattr(self, k) and getattr(self, k) is None:
                setattr(self, k, v)

    def set_n_in(self, input_type: InputType):
        pass

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    # ---- params
    def init_params(self, key, dtype=torch.float32, device=None) -> dict:
        return {}

    def init_state(self, dtype=torch.float32, device=None) -> dict:
        return {}

    def regularizable(self) -> Tuple[str, ...]:
        return ("W",)

    def n_params(self) -> int:
        from deeplearning4j_tpu_torch.ops.pallas_updaters import tree_leaves
        p = self.init_params(_prng.prng_key(0), device="cpu")
        return int(sum(v.numel() for v in tree_leaves(p)))

    # ---- runtime
    def apply(self, params, x, *, training=False, rng=None, state=None):
        raise NotImplementedError

    def _activate(self, z):
        return _act.get(self.activation or "IDENTITY")(z)

    # ---- serde
    def to_dict(self) -> dict:
        from deeplearning4j_tpu_torch.nn.conf.dropout import IDropout
        out = {"@type": type(self).__name__}
        for k, v in self.__dict__.items():
            if isinstance(v, Layer):
                out[k] = v.to_dict()
            elif isinstance(v, IDropout):
                out[k] = v.to_dict()
            elif isinstance(v, tuple):
                out[k] = list(v)
            else:
                out[k] = v
        return out

    @staticmethod
    def from_dict(d: dict) -> "Layer":
        d = dict(d)
        kind = d.pop("@type")
        cls = LAYER_TYPES.get(kind)
        if cls is None:
            raise ValueError(f"unknown layer type {kind!r}")
        frozen = d.pop("frozen", False)  # set dynamically by TransferLearning
        for k, v in list(d.items()):
            if isinstance(v, dict) and "@dropout" in v:
                from deeplearning4j_tpu_torch.nn.conf.dropout import IDropout
                d[k] = IDropout.from_dict(v)
            elif isinstance(v, dict) and "@type" in v:
                d[k] = Layer.from_dict(v)
            elif isinstance(v, list) and k in ("kernelSize", "stride", "padding", "dilation",
                                               "size", "cropping", "blocks", "poolingDimensions",
                                               "targetShape", "permuteDims"):
                d[k] = tuple(v)
        obj = cls(**d)
        if frozen:
            obj.frozen = True
        return obj


@dataclass
class FeedForwardLayer(Layer):
    nIn: int = 0
    nOut: int = 0

    def set_n_in(self, input_type: InputType):
        if not self.nIn:
            self.nIn = input_type.flat_size() if input_type.kind != "rnn" else input_type.size

    def output_type(self, input_type: InputType) -> InputType:
        if input_type.kind == "rnn":
            return InputType.recurrent(self.nOut, input_type.timeSeriesLength)
        return InputType.feedForward(self.nOut)


@dataclass
class DenseLayer(FeedForwardLayer):
    """(ref: conf.layers.DenseLayer / nn.layers.feedforward.dense.DenseLayer)"""
    hasBias: bool = True

    def init_params(self, key, dtype=torch.float32, device=None):
        dev = _dev(device)
        kW = _split(key)[0]
        p = {"W": _winit.init(self.weightInit or "XAVIER", kW, (self.nIn, self.nOut),
                              self.nIn, self.nOut, dtype, dev)}
        if self.hasBias:
            p["b"] = _full(self.nOut, self.biasInit or 0.0, dtype, dev)
        return p

    def apply(self, params, x, *, training=False, rng=None, state=None):
        z = torch.matmul(x, params["W"])
        if self.hasBias:
            z = z + params["b"]
        return self._activate(z), state


def _take_rows(table, x, squeeze_rank):
    idx = x.to(torch.int32)
    if idx.dim() == squeeze_rank and idx.shape[-1] == 1:
        idx = idx[..., 0]
    return _nnops.embedding_lookup(table, idx)


@dataclass
class EmbeddingLayer(FeedForwardLayer):
    """Index -> dense row (ref: conf.layers.EmbeddingLayer). Input: (B,) or
    (B,1) integer indices."""
    hasBias: bool = False

    def init_params(self, key, dtype=torch.float32, device=None):
        return {"W": _winit.init(self.weightInit or "XAVIER", key, (self.nIn, self.nOut),
                                 self.nIn, self.nOut, dtype, _dev(device))}

    def apply(self, params, x, *, training=False, rng=None, state=None):
        return self._activate(_take_rows(params["W"], x, 2)), state


@dataclass
class EmbeddingSequenceLayer(FeedForwardLayer):
    """Sequence of indices -> sequence of rows (ref: EmbeddingSequenceLayer).
    Input (B, T) ints -> (B, T, nOut)."""
    inputLength: int = -1

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.nOut, input_type.timeSeriesLength)

    def init_params(self, key, dtype=torch.float32, device=None):
        return {"W": _winit.init(self.weightInit or "XAVIER", key, (self.nIn, self.nOut),
                                 self.nIn, self.nOut, dtype, _dev(device))}

    def apply(self, params, x, *, training=False, rng=None, state=None):
        return self._activate(_take_rows(params["W"], x, 3)), state


# --------------------------------------------------------------------- CNN


def needs_flatten(layer, x_ndim: int) -> bool:
    """CNN->FF flatten-adapter predicate (ref: CnnToFeedForwardPreProcessor
    auto-insertion): spatial (4/5-dim) input into a dense-style layer is
    flattened unless the layer consumes spatial input itself."""
    return x_ndim in (4, 5) and isinstance(layer, FeedForwardLayer) \
        and not getattr(layer, "spatial_input", False) \
        and not isinstance(layer, (BaseRecurrentLayer, BatchNormalization))


@dataclass
class ConvolutionLayer(FeedForwardLayer):
    """2D conv, NCHW/OIHW (ref: conf.layers.ConvolutionLayer -> libnd4j
    conv2d; here the registry's conv2d with XLA's SAME padding)."""
    spatial_input = True
    kernelSize: Tuple[int, int] = (5, 5)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    dilation: Tuple[int, int] = (1, 1)
    convolutionMode: str = "Truncate"  # Truncate | Same (ref: ConvolutionMode)
    hasBias: bool = True

    def set_n_in(self, input_type: InputType):
        if not self.nIn:
            self.nIn = input_type.channels

    def output_type(self, input_type: InputType) -> InputType:
        k, s, p = _pair(self.kernelSize), _pair(self.stride), _pair(self.padding)
        h = _conv_out(input_type.height, k[0], s[0], p[0], self.convolutionMode)
        w = _conv_out(input_type.width, k[1], s[1], p[1], self.convolutionMode)
        return InputType.convolutional(h, w, self.nOut)

    def init_params(self, key, dtype=torch.float32, device=None):
        dev = _dev(device)
        k = _pair(self.kernelSize)
        fan_in = self.nIn * k[0] * k[1]
        fan_out = self.nOut * k[0] * k[1]
        p = {"W": _winit.init(self.weightInit or "XAVIER", key,
                              (self.nOut, self.nIn, k[0], k[1]), fan_in, fan_out, dtype,
                              dev)}
        if self.hasBias:
            p["b"] = _full(self.nOut, self.biasInit or 0.0, dtype, dev)
        return p

    def _padding_arg(self):
        if self.convolutionMode == "Same":
            return "SAME"
        p = _pair(self.padding)
        return [(p[0], p[0]), (p[1], p[1])]

    def apply(self, params, x, *, training=False, rng=None, state=None):
        z = _nnops.conv2d(x, params["W"], params.get("b"), strides=_pair(self.stride),
                          padding=self._padding_arg(), dilation=_pair(self.dilation))
        return self._activate(z), state


@dataclass
class Convolution1DLayer(FeedForwardLayer):
    """1D conv over (B, T, C) sequences (ref: Convolution1DLayer)."""
    kernelSize: int = 3
    stride: int = 1
    padding: int = 0
    dilation: int = 1
    convolutionMode: str = "Same"
    hasBias: bool = True

    def set_n_in(self, input_type: InputType):
        if not self.nIn:
            self.nIn = input_type.size

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.timeSeriesLength
        if t > 0:
            t = _conv_out(t, self.kernelSize, self.stride, self.padding, self.convolutionMode)
        return InputType.recurrent(self.nOut, t)

    def init_params(self, key, dtype=torch.float32, device=None):
        dev = _dev(device)
        fan_in = self.nIn * self.kernelSize
        p = {"W": _winit.init(self.weightInit or "XAVIER", key,
                              (self.nOut, self.nIn, self.kernelSize),
                              fan_in, self.nOut * self.kernelSize, dtype, dev)}
        if self.hasBias:
            p["b"] = _full(self.nOut, self.biasInit or 0.0, dtype, dev)
        return p

    def apply(self, params, x, *, training=False, rng=None, state=None):
        xc = x.transpose(1, 2)  # (B,T,C) -> (B,C,T)
        pad = "SAME" if self.convolutionMode == "Same" else [(self.padding, self.padding)]
        z = _nnops.conv1d(xc, params["W"], params.get("b"), stride=self.stride,
                          padding=pad, dilation=self.dilation)
        return self._activate(z.transpose(1, 2)), state


@dataclass
class Deconvolution2D(ConvolutionLayer):
    """Transposed conv (ref: conf.layers.Deconvolution2D): the reference's
    ``lax.conv_transpose`` with an IOHW kernel and transpose_kernel=False —
    the input dilated by the strides, padded (SAME: lax's transpose
    padding; Truncate: the padding pairs as they are), and correlated
    with the kernel unflipped."""

    def output_type(self, input_type: InputType) -> InputType:
        k, s, p = _pair(self.kernelSize), _pair(self.stride), _pair(self.padding)
        if self.convolutionMode == "Same":
            h, w = input_type.height * s[0], input_type.width * s[1]
        else:
            h = s[0] * (input_type.height - 1) + k[0] - 2 * p[0]
            w = s[1] * (input_type.width - 1) + k[1] - 2 * p[1]
        return InputType.convolutional(h, w, self.nOut)

    def init_params(self, key, dtype=torch.float32, device=None):
        dev = _dev(device)
        k = _pair(self.kernelSize)
        fan_in = self.nIn * k[0] * k[1]
        p = {"W": _winit.init(self.weightInit or "XAVIER", key,
                              (self.nIn, self.nOut, k[0], k[1]), fan_in,
                              self.nOut * k[0] * k[1], dtype, dev)}
        if self.hasBias:
            p["b"] = _full(self.nOut, self.biasInit or 0.0, dtype, dev)
        return p

    def apply(self, params, x, *, training=False, rng=None, state=None):
        W = params["W"]
        kh, kw = W.shape[2:]
        sh, sw = _pair(self.stride)
        pad = self._padding_arg()
        if isinstance(pad, str):
            pads = [_nnops._conv_transpose_pads(k, s, pad)
                    for k, s in ((kh, sh), (kw, sw))]
        else:
            pads = [tuple(p) for p in pad]
        n, c, h, w = x.shape
        dil = x.new_zeros((n, c, (h - 1) * sh + 1, (w - 1) * sw + 1))
        dil[:, :, ::sh, ::sw] = x
        z = F.conv2d(_nnops._pad_spatial_signed(dil, pads), W.transpose(0, 1))
        if self.hasBias:
            z = z + params["b"].reshape(1, -1, 1, 1)
        return self._activate(z), state


@dataclass
class DepthwiseConvolution2D(ConvolutionLayer):
    """(ref: conf.layers.DepthwiseConvolution2D); nOut = nIn * depthMultiplier."""
    depthMultiplier: int = 1

    def output_type(self, input_type: InputType) -> InputType:
        self.nOut = self.nIn * self.depthMultiplier
        return super().output_type(input_type)

    def init_params(self, key, dtype=torch.float32, device=None):
        dev = _dev(device)
        k = _pair(self.kernelSize)
        ch = self.nIn * self.depthMultiplier
        p = {"W": _winit.init(self.weightInit or "XAVIER", key, (ch, 1, k[0], k[1]),
                              k[0] * k[1], k[0] * k[1] * self.depthMultiplier, dtype,
                              dev)}
        if self.hasBias:
            p["b"] = _full(ch, self.biasInit or 0.0, dtype, dev)
        return p

    def apply(self, params, x, *, training=False, rng=None, state=None):
        z = _nnops.depthwise_conv2d(x, params["W"], params.get("b"), strides=_pair(self.stride),
                                    padding=self._padding_arg(), dilation=_pair(self.dilation))
        return self._activate(z), state


@dataclass
class SeparableConvolution2D(ConvolutionLayer):
    """(ref: conf.layers.SeparableConvolution2D)."""
    depthMultiplier: int = 1

    def init_params(self, key, dtype=torch.float32, device=None):
        dev = _dev(device)
        k1, k2 = _split(key)
        k = _pair(self.kernelSize)
        ch = self.nIn * self.depthMultiplier
        p = {
            "dW": _winit.init(self.weightInit or "XAVIER", k1, (ch, 1, k[0], k[1]),
                              k[0] * k[1], k[0] * k[1], dtype, dev),
            "pW": _winit.init(self.weightInit or "XAVIER", k2, (self.nOut, ch, 1, 1),
                              ch, self.nOut, dtype, dev),
        }
        if self.hasBias:
            p["b"] = _full(self.nOut, self.biasInit or 0.0, dtype, dev)
        return p

    def regularizable(self):
        return ("dW", "pW")

    def apply(self, params, x, *, training=False, rng=None, state=None):
        z = _nnops.separable_conv2d(x, params["dW"], params["pW"], params.get("b"),
                                    strides=_pair(self.stride), padding=self._padding_arg())
        return self._activate(z), state


@dataclass
class SubsamplingLayer(Layer):
    """Pooling (ref: conf.layers.SubsamplingLayer; PoolingType MAX/AVG/SUM/PNORM)."""
    poolingType: str = "MAX"
    kernelSize: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    padding: Tuple[int, int] = (0, 0)
    convolutionMode: str = "Truncate"
    pnorm: int = 2

    def output_type(self, input_type: InputType) -> InputType:
        k, s, p = _pair(self.kernelSize), _pair(self.stride), _pair(self.padding)
        h = _conv_out(input_type.height, k[0], s[0], p[0], self.convolutionMode)
        w = _conv_out(input_type.width, k[1], s[1], p[1], self.convolutionMode)
        return InputType.convolutional(h, w, input_type.channels)

    def apply(self, params, x, *, training=False, rng=None, state=None):
        if self.convolutionMode == "Same":
            pad = "SAME"
        else:
            p = _pair(self.padding)
            pad = [(p[0], p[0]), (p[1], p[1])]
        k, s = _pair(self.kernelSize), _pair(self.stride)
        if self.poolingType == "MAX":
            return _nnops._pool(x, "max", k, s, pad), state
        if self.poolingType == "AVG":
            return _nnops._pool(x, "avg", k, s, pad), state
        if self.poolingType == "SUM":
            return _nnops._pool(x, "sum", k, s, pad), state
        if self.poolingType == "PNORM":
            z = _nnops._pool(torch.abs(x) ** self.pnorm, "sum", k, s, pad)
            return z ** (1.0 / self.pnorm), state
        raise ValueError(self.poolingType)


@dataclass
class Subsampling1DLayer(Layer):
    """1D pooling over (B,T,C) (ref: Subsampling1DLayer)."""
    poolingType: str = "MAX"
    kernelSize: int = 2
    stride: int = 2
    padding: int = 0

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.timeSeriesLength
        if t > 0:
            t = (t + 2 * self.padding - self.kernelSize) // self.stride + 1
        return InputType.recurrent(input_type.size, t)

    def apply(self, params, x, *, training=False, rng=None, state=None):
        xc = x.transpose(1, 2)
        pad = [(self.padding, self.padding)]
        kind = "max" if self.poolingType == "MAX" else "avg"
        z = _nnops._pool(xc, kind, (self.kernelSize,), (self.stride,), pad, "NCW")
        return z.transpose(1, 2), state


@dataclass
class BatchNormalization(FeedForwardLayer):
    """(ref: conf.layers.BatchNormalization; dl4j 'decay' is the
    running-average momentum; eps 1e-5). Works on FF (B,F) and CNN NCHW
    (per-channel). Running stats live in layer state, updated in training
    (returned as the new state, never differentiated)."""
    decay: float = 0.9
    eps: float = 1e-5
    gamma_init: float = 1.0
    beta_init: float = 0.0
    lockGammaBeta: bool = False
    # channel placement for rank-3 (sequence) activations — BN is otherwise
    # layout-blind and cannot tell (B,T,C) from (B,C,T) at runtime
    rnnDataFormat: str = "NWC"

    def set_n_in(self, input_type: InputType):
        if not self.nIn:
            self.nIn = (input_type.channels
                        if input_type.kind in ("cnn", "cnn3d")
                        else input_type.flat_size())
        self.nOut = self.nIn

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def init_params(self, key, dtype=torch.float32, device=None):
        if self.lockGammaBeta:
            return {}
        dev = _dev(device)
        return {"gamma": _full(self.nIn, self.gamma_init, dtype, dev),
                "beta": _full(self.nIn, self.beta_init, dtype, dev)}

    def init_state(self, dtype=torch.float32, device=None):
        # norm statistics stay >= fp32 even for HALF networks (standard mixed-
        # precision practice): bf16 EMA would quantize away small corrections
        stat_dtype = torch.float32 if dtype == torch.bfloat16 else dtype
        dev = _dev(device)
        return {"mean": torch.zeros((self.nIn,), dtype=stat_dtype, device=dev),
                "var": torch.ones((self.nIn,), dtype=stat_dtype, device=dev)}

    def regularizable(self):
        return ()

    def apply(self, params, x, *, training=False, rng=None, state=None):
        # stats over every non-channel axis. (B,F); rank-3 sequences follow
        # rnnDataFormat (default NWC); NCHW/NCDHW channels-first.
        if x.dim() == 3 and self.rnnDataFormat != "NCW":
            axes = (0, 1)
            shape = [1, 1, -1]
        else:
            axes = (0,) if x.dim() == 2 else (0,) + tuple(range(2, x.dim()))
            shape = [1, -1] + [1] * (x.dim() - 2)
        if training:
            # the global batch's moments under a data-parallel step
            mean = _shard.all_mean(torch.mean(x, dim=axes))
            c = x - mean.reshape(shape)
            var = _shard.all_mean(torch.mean(c * c, dim=axes))
            new_state = {"mean": self.decay * state["mean"] + (1 - self.decay) * mean.detach(),
                         "var": self.decay * state["var"] + (1 - self.decay) * var.detach()}
        else:
            mean, var = state["mean"], state["var"]
            new_state = state
        y = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + self.eps)
        if params:
            y = y * params["gamma"].reshape(shape) + params["beta"].reshape(shape)
        return self._activate(y).to(x.dtype), new_state


@dataclass
class LocalResponseNormalization(Layer):
    """(ref: conf.layers.LocalResponseNormalization; dl4j defaults k=2,n=5,
    alpha=1e-4,beta=0.75)."""
    k: float = 2.0
    n: int = 5
    alpha: float = 1e-4
    beta: float = 0.75

    def apply(self, params, x, *, training=False, rng=None, state=None):
        return _nnops.local_response_normalization(
            x, depth_radius=self.n // 2, bias=self.k, alpha=self.alpha, beta=self.beta), state


@dataclass
class DropoutLayer(Layer):
    """Standalone dropout (ref: conf.layers.DropoutLayer). ``dropOut`` is the
    RETAIN probability, dl4j semantics; inverted-dropout scaling."""

    def __post_init__(self):
        if self.dropOut is None:
            self.dropOut = 0.5

    def apply(self, params, x, *, training=False, rng=None, state=None):
        if not training or rng is None:
            return x, state
        from deeplearning4j_tpu_torch.nn.conf.dropout import apply_dropout
        return apply_dropout(self.dropOut, rng, x), state


@dataclass
class ActivationLayer(Layer):
    """(ref: conf.layers.ActivationLayer). ``alpha`` parameterizes LEAKYRELU/ELU
    (ref: ActivationLReLU(alpha) etc. carry their own coefficients)."""
    alpha: Optional[float] = None

    def apply(self, params, x, *, training=False, rng=None, state=None):
        if self.alpha is not None and (self.activation or "").upper() == "LEAKYRELU":
            return torch.where(x >= 0, x, self.alpha * x), state
        if self.alpha is not None and (self.activation or "").upper() == "ELU":
            return _nnops._elu(x, self.alpha), state
        if (self.activation or "").upper() == "THRESHOLDEDRELU":
            theta = self.alpha if self.alpha is not None else 1.0
            return torch.where(x > theta, x, 0.0), state
        return self._activate(x), state


@dataclass
class Upsampling2D(Layer):
    size: Tuple[int, int] = (2, 2)

    def output_type(self, input_type: InputType) -> InputType:
        s = _pair(self.size)
        return InputType.convolutional(input_type.height * s[0], input_type.width * s[1],
                                       input_type.channels)

    def apply(self, params, x, *, training=False, rng=None, state=None):
        return _nnops.upsampling2d(x, _pair(self.size)), state


@dataclass
class ZeroPaddingLayer(Layer):
    padding: Tuple[int, int, int, int] = (0, 0, 0, 0)  # top,bottom,left,right

    def output_type(self, input_type: InputType) -> InputType:
        t, b, l, r = self.padding
        return InputType.convolutional(input_type.height + t + b, input_type.width + l + r,
                                       input_type.channels)

    def apply(self, params, x, *, training=False, rng=None, state=None):
        t, b, l, r = self.padding
        return F.pad(x, (l, r, t, b)), state


@dataclass
class Cropping2D(Layer):
    cropping: Tuple[int, int, int, int] = (0, 0, 0, 0)

    def output_type(self, input_type: InputType) -> InputType:
        t, b, l, r = self.cropping
        return InputType.convolutional(input_type.height - t - b, input_type.width - l - r,
                                       input_type.channels)

    def apply(self, params, x, *, training=False, rng=None, state=None):
        t, b, l, r = self.cropping
        return x[:, :, t:x.shape[2] - b, l:x.shape[3] - r], state


@dataclass
class GlobalPoolingLayer(Layer):
    """(ref: conf.layers.GlobalPoolingLayer) — pools RNN over time or CNN over
    space. Supports masked mean/max for variable-length sequences."""
    poolingType: str = "AVG"
    pnorm: int = 2
    collapseDimensions: bool = True

    def output_type(self, input_type: InputType) -> InputType:
        if input_type.kind == "rnn":
            return InputType.feedForward(input_type.size)
        if input_type.kind == "cnn":
            return InputType.feedForward(input_type.channels)
        return input_type

    def apply(self, params, x, *, training=False, rng=None, state=None, mask=None):
        if x.dim() == 3:  # (B,T,F) over time
            axes = (1,)
            if mask is not None:
                # in x's dtype: a float32 mask must not lift a bf16
                # network's activations to float32 (torch's matmuls take
                # one dtype; JAX's promote)
                m = mask[:, :, None].to(x.dtype)
                if self.poolingType == "AVG":
                    return torch.sum(x * m, dim=1) / torch.clamp_min(
                        torch.sum(m, dim=1), 1.0), state
                if self.poolingType == "MAX":
                    return torch.amax(torch.where(m > 0, x, -torch.inf), dim=1), state
        else:  # NCHW over spatial
            axes = tuple(range(2, x.dim()))
        if self.poolingType == "AVG":
            return torch.mean(x, dim=axes), state
        if self.poolingType == "MAX":
            return torch.amax(x, dim=axes), state
        if self.poolingType == "SUM":
            return torch.sum(x, dim=axes), state
        if self.poolingType == "PNORM":
            return torch.sum(torch.abs(x) ** self.pnorm, dim=axes) ** (1.0 / self.pnorm), state
        raise ValueError(self.poolingType)


# --------------------------------------------------------------------- RNN


@dataclass
class BaseRecurrentLayer(FeedForwardLayer):
    rnnDataFormat: str = "NWC"  # (B,T,F); "NCW" = reference layout [b,size,t]

    def set_n_in(self, input_type: InputType):
        if not self.nIn:
            self.nIn = input_type.size

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.nOut, input_type.timeSeriesLength)

    def _to_nwc(self, x):
        return x.transpose(1, 2) if self.rnnDataFormat == "NCW" else x

    def _from_nwc(self, x):
        return x.transpose(1, 2) if self.rnnDataFormat == "NCW" else x

    # -- streaming/tBPTT state surface (ref: BaseRecurrentLayer.stateMap /
    #    tBpttStateMap + rnnTimeStep/rnnActivateUsingStoredState)
    def init_rnn_state(self, batch: int, dtype=torch.float32, device=None) -> dict:
        return {"h": torch.zeros((batch, self.nOut), dtype=dtype, device=_dev(device))}

    def apply_rnn(self, params, x, rnn_state: dict, *, mask=None):
        """Run the recurrence from ``rnn_state``; returns (ys, final_state)."""
        raise NotImplementedError


def _lstm_params(layer, key, n_gates, dtype, device):
    dev = _dev(device)
    k1, k2 = _split(key)
    H = layer.nOut
    wi = layer.weightInit or "XAVIER"
    return dev, H, {
        "W": _winit.init(wi, k1, (layer.nIn, n_gates * H), layer.nIn, n_gates * H, dtype, dev),
        "RW": _winit.init(wi, k2, (H, n_gates * H), H, n_gates * H, dtype, dev),
    }


@dataclass
class LSTM(BaseRecurrentLayer):
    """(ref: conf.layers.LSTM -> fused libnd4j lstmLayer; here the
    registry's lstm_layer, a loop over time). Default activation tanh; gate
    activation sigmoid (fixed, as reference); gate order [i, f, g, o]."""
    forgetGateBiasInit: float = 1.0

    def init_params(self, key, dtype=torch.float32, device=None):
        dev, H, p = _lstm_params(self, key, 4, dtype, device)
        b = torch.zeros((4 * H,), dtype=dtype, device=dev)
        b[H:2 * H] = self.forgetGateBiasInit  # [i,f,g,o] gate order
        p["b"] = b
        return p

    def regularizable(self):
        return ("W", "RW")

    def init_rnn_state(self, batch: int, dtype=torch.float32, device=None) -> dict:
        H = self.nOut
        dev = _dev(device)
        return {"h": torch.zeros((batch, H), dtype=dtype, device=dev),
                "c": torch.zeros((batch, H), dtype=dtype, device=dev)}

    def apply_rnn(self, params, x, rnn_state, *, mask=None):
        x = self._to_nwc(x)
        ys, (hT, cT) = _nnops.lstm_layer(x, rnn_state["h"], rnn_state["c"],
                                         params["W"], params["RW"], params["b"], mask=mask)
        return self._from_nwc(ys), {"h": hT, "c": cT}

    def apply(self, params, x, *, training=False, rng=None, state=None, mask=None,
              initial_state=None):
        B = x.shape[0]
        rs = self.init_rnn_state(B, x.dtype, x.device) if initial_state is None else \
            {"h": initial_state[0], "c": initial_state[1]}
        ys, _ = self.apply_rnn(params, x, rs, mask=mask)
        return ys, state


@dataclass
class GravesLSTM(LSTM):
    """LSTM with peephole connections (ref: conf.layers.GravesLSTM): pI
    and pF read c, pO reads the new cell c2."""

    def init_params(self, key, dtype=torch.float32, device=None):
        p = super().init_params(key, dtype, device)
        H = self.nOut
        dev = p["W"].device
        for k in ("pI", "pF", "pO"):
            p[k] = torch.zeros((H,), dtype=dtype, device=dev)
        return p

    def apply_rnn(self, params, x, rnn_state, *, mask=None):
        x = self._to_nwc(x)
        h, c = rnn_state["h"], rnn_state["c"]
        W, RW, b = params["W"], params["RW"], params["b"]
        pI, pF, pO = params["pI"], params["pF"], params["pO"]
        xw = torch.matmul(x, W)  # every step's input projection at once
        ys = []
        for t in range(x.shape[1]):
            z = xw[:, t] + torch.matmul(h, RW) + b
            i, f, g, o = torch.chunk(z, 4, dim=-1)
            i = torch.sigmoid(i + pI * c)
            f = torch.sigmoid(f + pF * c)
            g = torch.tanh(g)
            c2 = f * c + i * g
            o = torch.sigmoid(o + pO * c2)
            h2 = o * torch.tanh(c2)
            if mask is not None:
                m = mask[:, t, None] > 0
                h2 = torch.where(m, h2, h)
                c2 = torch.where(m, c2, c)
            h, c = h2, c2
            ys.append(h)
        return self._from_nwc(torch.stack(ys, dim=1)), {"h": h, "c": c}


@dataclass
class SimpleRnn(BaseRecurrentLayer):
    """(ref: conf.layers.SimpleRnn). Like the reference, it takes a mask and
    does not apply it."""

    def init_params(self, key, dtype=torch.float32, device=None):
        dev, _, p = _lstm_params(self, key, 1, dtype, device)
        p["b"] = _full(self.nOut, self.biasInit or 0.0, dtype, dev)
        return p

    def regularizable(self):
        return ("W", "RW")

    def apply_rnn(self, params, x, rnn_state, *, mask=None):
        x = self._to_nwc(x)
        act = _act.get(self.activation or "TANH")
        ys, hT = _nnops.simple_rnn(x, rnn_state["h"], params["W"], params["RW"],
                                   params["b"], activation=act)
        return self._from_nwc(ys), {"h": hT}

    def apply(self, params, x, *, training=False, rng=None, state=None, mask=None,
              initial_state=None):
        rs = self.init_rnn_state(x.shape[0], x.dtype, x.device) if initial_state is None \
            else {"h": initial_state}
        ys, _ = self.apply_rnn(params, x, rs, mask=mask)
        return ys, state


@dataclass
class GRU(BaseRecurrentLayer):
    """(ref: libnd4j gru op; dl4j exposes via samediff). Like the reference,
    it takes a mask and does not apply it."""

    def init_params(self, key, dtype=torch.float32, device=None):
        dev, H, p = _lstm_params(self, key, 3, dtype, device)
        p["bi"] = torch.zeros((3 * H,), dtype=dtype, device=dev)
        p["bh"] = torch.zeros((3 * H,), dtype=dtype, device=dev)
        return p

    def regularizable(self):
        return ("W", "RW")

    def apply_rnn(self, params, x, rnn_state, *, mask=None):
        x = self._to_nwc(x)
        ys, hT = _nnops.gru_layer(x, rnn_state["h"], params["W"], params["RW"],
                                  params["bi"], params["bh"])
        return self._from_nwc(ys), {"h": hT}

    def apply(self, params, x, *, training=False, rng=None, state=None, mask=None,
              initial_state=None):
        rs = self.init_rnn_state(x.shape[0], x.dtype, x.device) if initial_state is None \
            else {"h": initial_state}
        ys, _ = self.apply_rnn(params, x, rs, mask=mask)
        return ys, state


@dataclass
class Bidirectional(Layer):
    """Wrapper running a recurrent layer in both directions (ref:
    conf.layers.recurrent.Bidirectional; Mode CONCAT/ADD/MUL/AVERAGE)."""
    fwd: Optional[Layer] = None
    mode: str = "CONCAT"

    def __post_init__(self):
        if self.fwd is not None and not isinstance(self.fwd, Layer):
            self.fwd = Layer.from_dict(self.fwd)

    def inherit(self, globals_: dict):
        super().inherit(globals_)
        self.fwd.inherit(globals_)

    def set_n_in(self, input_type: InputType):
        self.fwd.set_n_in(input_type)

    def output_type(self, input_type: InputType) -> InputType:
        out = self.fwd.output_type(input_type)
        if self.mode == "CONCAT":
            return InputType.recurrent(out.size * 2, out.timeSeriesLength)
        return out

    def init_params(self, key, dtype=torch.float32, device=None):
        k1, k2 = _split(key)
        return {"fwd": self.fwd.init_params(k1, dtype, device),
                "bwd": self.fwd.init_params(k2, dtype, device)}

    def regularizable(self):
        return ()

    def apply(self, params, x, *, training=False, rng=None, state=None, mask=None):
        yf, _ = self.fwd.apply(params["fwd"], x, training=training, rng=rng, state=None,
                               mask=mask)
        xr = torch.flip(x, dims=(1,))
        mr = torch.flip(mask, dims=(1,)) if mask is not None else None
        yb, _ = self.fwd.apply(params["bwd"], xr, training=training, rng=rng, state=None,
                               mask=mr)
        yb = torch.flip(yb, dims=(1,))
        if self.mode == "CONCAT":
            return torch.cat([yf, yb], dim=-1), state
        if self.mode == "ADD":
            return yf + yb, state
        if self.mode == "MUL":
            return yf * yb, state
        if self.mode == "AVERAGE":
            return 0.5 * (yf + yb), state
        raise ValueError(self.mode)


@dataclass
class ConvLSTM2D(Layer):
    """Convolutional LSTM over image sequences (ref: the reference ships
    this via its Keras importer, KerasConvLSTM2D; Shi et al. 2015). Input
    (B, T, C, H, W); gates are SAME-padded convolutions instead of matmuls,
    the time recurrence a loop over T. ``returnSequences=False`` emits the
    final hidden map (B, nOut, H, W); True emits (B, T, nOut, H, W). Gate
    order [i, f, g(c), o], matching LSTM/Keras."""
    nIn: int = 0
    nOut: int = 0
    kernelSize: Tuple[int, int] = (3, 3)
    returnSequences: bool = False
    forgetGateBiasInit: float = 1.0

    def set_n_in(self, input_type: InputType):
        if not self.nIn and input_type.kind == "cnnseq":
            self.nIn = input_type.channels

    def output_type(self, input_type: InputType) -> InputType:
        if self.returnSequences:
            return InputType.convolutionalSequence(
                input_type.height, input_type.width, self.nOut,
                input_type.timeSeriesLength)
        return InputType.convolutional(input_type.height, input_type.width,
                                       self.nOut)

    def init_params(self, key, dtype=torch.float32, device=None):
        dev = _dev(device)
        k1, k2 = _split(key)
        kh, kw = self.kernelSize
        C, H4 = self.nIn, 4 * self.nOut
        fan_in = C * kh * kw
        p = {
            "W": _winit.init(self.weightInit or "XAVIER", k1, (H4, C, kh, kw),
                             fan_in, H4, dtype, dev),
            "RW": _winit.init(self.weightInit or "XAVIER", k2,
                              (H4, self.nOut, kh, kw),
                              self.nOut * kh * kw, H4, dtype, dev),
        }
        b = torch.zeros((H4,), dtype=dtype, device=dev)
        b[self.nOut:2 * self.nOut] = self.forgetGateBiasInit
        p["b"] = b
        return p

    def regularizable(self):
        return ("W", "RW")

    def apply(self, params, x, *, training=False, rng=None, state=None):
        if x.dim() != 5:
            raise ValueError(
                f"ConvLSTM2D expects (B, T, C, H, W), got rank {x.dim()}")
        B, T, C, H, W = x.shape
        h = c = torch.zeros((B, self.nOut, H, W), dtype=x.dtype, device=x.device)
        bias = params["b"][None, :, None, None]
        ys = []
        for t in range(T):
            z = _nnops.conv2d(x[:, t], params["W"], None, (1, 1), "SAME") \
                + _nnops.conv2d(h, params["RW"], None, (1, 1), "SAME") + bias
            i, f, g, o = torch.chunk(z, 4, dim=1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            ys.append(h)
        if self.returnSequences:
            return torch.stack(ys, dim=1), state
        return h, state


@dataclass
class RepeatVector(Layer):
    """Repeats a (B, F) feature vector n times into a (B, n, F) sequence
    (ref: conf.layers.misc.RepeatVector — the reference stores NCW [B, F, n];
    this framework's recurrent stack is NWC, so the time axis is axis 1, the
    same tensor transposed)."""
    repetitionFactor: int = 1

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(input_type.size, self.repetitionFactor)

    def apply(self, params, x, *, training=False, rng=None, state=None):
        if x.dim() != 2:
            raise ValueError(
                f"RepeatVector expects (B, F) feed-forward input, got rank "
                f"{x.dim()} — the reference requires FF input too")
        return x[:, None, :].repeat(1, self.repetitionFactor, 1), state


@dataclass
class LastTimeStep(Layer):
    """Wrapper extracting the last (masked) timestep (ref:
    conf.layers.recurrent.LastTimeStep)."""
    underlying: Optional[Layer] = None

    def __post_init__(self):
        if self.underlying is not None and not isinstance(self.underlying, Layer):
            self.underlying = Layer.from_dict(self.underlying)

    def inherit(self, globals_: dict):
        super().inherit(globals_)
        if self.underlying:
            self.underlying.inherit(globals_)

    def set_n_in(self, input_type: InputType):
        if self.underlying:
            self.underlying.set_n_in(input_type)

    def output_type(self, input_type: InputType) -> InputType:
        out = self.underlying.output_type(input_type) if self.underlying else input_type
        return InputType.feedForward(out.size)

    def init_params(self, key, dtype=torch.float32, device=None):
        return self.underlying.init_params(key, dtype, device) if self.underlying else {}

    def apply(self, params, x, *, training=False, rng=None, state=None, mask=None):
        if self.underlying:
            x, state = self.underlying.apply(params, x, training=training, rng=rng,
                                             state=state, mask=mask)
        if mask is not None:
            idx = torch.clamp_min(torch.sum(mask, dim=1).to(torch.int64) - 1, 0)
            return x[torch.arange(x.shape[0], device=x.device), idx], state
        return x[:, -1], state


# ------------------------------------------------------------- output layers


@dataclass
class BaseOutputLayer(FeedForwardLayer):
    lossFunction: str = "MCXENT"
    hasBias: bool = True

    def __post_init__(self):
        if self.activation is None and self.lossFunction in ("MCXENT", "NEGATIVELOGLIKELIHOOD"):
            self.activation = "SOFTMAX"

    def init_params(self, key, dtype=torch.float32, device=None):
        dev = _dev(device)
        kW = _split(key)[0]
        p = {"W": _winit.init(self.weightInit or "XAVIER", kW, (self.nIn, self.nOut),
                              self.nIn, self.nOut, dtype, dev)}
        if self.hasBias:
            p["b"] = _full(self.nOut, self.biasInit or 0.0, dtype, dev)
        return p

    def apply(self, params, x, *, training=False, rng=None, state=None):
        z = torch.matmul(x, params["W"])
        if self.hasBias:
            z = z + params["b"]
        return self._activate(z), state

    def compute_loss(self, labels, output, mask=None):
        return _losses.get(self.lossFunction)(labels, output, mask)


@dataclass
class OutputLayer(BaseOutputLayer):
    """(ref: conf.layers.OutputLayer)."""


@dataclass
class RnnOutputLayer(BaseOutputLayer):
    """Per-timestep output (ref: conf.layers.RnnOutputLayer). Input (B,T,F)
    NWC or (B,F,T) NCW per ``rnnDataFormat`` (ref: RnnOutputLayer.dataFormat)."""
    rnnDataFormat: str = "NWC"

    def set_n_in(self, input_type: InputType):
        if not self.nIn:
            self.nIn = input_type.size

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.nOut, input_type.timeSeriesLength)

    def apply(self, params, x, *, training=False, rng=None, state=None):
        ncw = self.rnnDataFormat == "NCW"
        if ncw:
            x = x.transpose(1, 2)
        z = torch.matmul(x, params["W"])
        if self.hasBias:
            z = z + params["b"]
        out = self._activate(z)
        return (out.transpose(1, 2) if ncw else out), state

    def compute_loss(self, labels, output, mask=None):
        if self.rnnDataFormat == "NCW":  # loss math runs in NWC
            labels = labels.transpose(1, 2)
            output = output.transpose(1, 2)
        return _losses.get(self.lossFunction)(labels, output, mask)


@dataclass
class LossLayer(Layer):
    """Loss without params (ref: conf.layers.LossLayer)."""
    lossFunction: str = "MCXENT"

    def apply(self, params, x, *, training=False, rng=None, state=None):
        return self._activate(x), state

    def compute_loss(self, labels, output, mask=None):
        return _losses.get(self.lossFunction)(labels, output, mask)


# ------------------------------------------------------------- attention


@dataclass
class SelfAttentionLayer(BaseRecurrentLayer):
    """Dot-product self-attention over sequences (ref:
    conf.layers.SelfAttentionLayer, SameDiff-backed in the reference).
    projectInput=True uses learned Q/K/V/O projections.

    ``attentionKernel`` routes the unmasked case (the registry's
    ``multi_head_attention``): None = auto, the hand-written packed
    attention kernels (rows 1-2, forward and backward) for CUDA tensors
    and the einsum on the CPU; False pins the einsum per layer; True
    forces the kernel route (the kernels' plain versions on the CPU). A
    masked batch always takes the einsum. The kernel route exists only
    with projectInput=True: forcing True on the unprojected path raises
    at apply time."""
    nHeads: int = 1
    headSize: int = 0
    projectInput: bool = True
    attentionKernel: Optional[bool] = None

    def output_type(self, input_type: InputType) -> InputType:
        size = self.nOut if self.projectInput else input_type.size
        return InputType.recurrent(size, input_type.timeSeriesLength)

    def init_params(self, key, dtype=torch.float32, device=None):
        if not self.projectInput:
            return {}
        dev = _dev(device)
        D = self.nIn
        O = self.nOut
        ks = _split(key, 4)
        wi = self.weightInit or "XAVIER"
        return {"Wq": _winit.init(wi, ks[0], (D, O), D, O, dtype, dev),
                "Wk": _winit.init(wi, ks[1], (D, O), D, O, dtype, dev),
                "Wv": _winit.init(wi, ks[2], (D, O), D, O, dtype, dev),
                "Wo": _winit.init(wi, ks[3], (O, O), O, O, dtype, dev)}

    def regularizable(self):
        return ("Wq", "Wk", "Wv", "Wo")

    def apply(self, params, x, *, training=False, rng=None, state=None, mask=None):
        if self.projectInput:
            out = _nnops.multi_head_attention(x, x, params["Wq"], params["Wk"], params["Wv"],
                                              params["Wo"], self.nHeads, mask=mask,
                                              use_kernel=self.attentionKernel)
        else:
            # False is satisfied trivially (this IS the einsum path); only
            # forcing the kernel is unsatisfiable without projections
            if self.attentionKernel is True:
                raise ValueError(
                    "SelfAttentionLayer.attentionKernel=True requires "
                    "projectInput=True; the unprojected path has no "
                    "Pallas kernel route")
            m = mask[:, None, :] if mask is not None else None
            out = _nnops.dot_product_attention(x, x, x, mask=m)
        return out, state




# ------------------------------------------------- parametric activations etc.


@dataclass
class PReLULayer(Layer):
    """Learned leaky-ReLU slope (ref: conf.layers.PReLULayer). ``inputShape``
    is the per-example shape; ``sharedAxes`` broadcast alpha over those axes
    (1-based, as the reference counts within the example)."""
    inputShape: Tuple[int, ...] = ()
    sharedAxes: Tuple[int, ...] = ()

    def set_n_in(self, input_type: InputType):
        if not self.inputShape:
            self.inputShape = tuple(input_type.array_shape(1)[1:])

    def init_params(self, key, dtype=torch.float32, device=None):
        shape = tuple(1 if (i + 1) in tuple(self.sharedAxes) else s
                      for i, s in enumerate(self.inputShape))
        return {"alpha": torch.zeros(shape, dtype=dtype, device=_dev(device))}

    def regularizable(self):
        return ()

    def apply(self, params, x, *, training=False, rng=None, state=None):
        return torch.where(x >= 0, x, params["alpha"].to(x.dtype) * x), state


@dataclass
class ElementWiseMultiplicationLayer(FeedForwardLayer):
    """out = activation(x * w + b), elementwise learned scale (ref:
    conf.layers.misc.ElementWiseMultiplicationLayer)."""

    def __post_init__(self):
        if not self.nOut:
            self.nOut = self.nIn

    def init_params(self, key, dtype=torch.float32, device=None):
        dev = _dev(device)
        return {"W": torch.ones((self.nIn,), dtype=dtype, device=dev),
                "b": _full(self.nIn, self.biasInit or 0.0, dtype, dev)}

    def apply(self, params, x, *, training=False, rng=None, state=None):
        return self._activate(x * params["W"] + params["b"]), state


@dataclass
class MaskZeroLayer(Layer):
    """Zeroes timesteps equal to maskValue before the underlying layer (ref:
    conf.layers.util.MaskZeroLayer)."""
    underlying: Optional[Layer] = None
    maskValue: float = 0.0

    def __post_init__(self):
        if self.underlying is not None and not isinstance(self.underlying, Layer):
            self.underlying = Layer.from_dict(self.underlying)

    def inherit(self, globals_: dict):
        super().inherit(globals_)
        if self.underlying:
            self.underlying.inherit(globals_)

    def set_n_in(self, input_type: InputType):
        if self.underlying:
            self.underlying.set_n_in(input_type)

    def output_type(self, input_type: InputType) -> InputType:
        return self.underlying.output_type(input_type) if self.underlying else input_type

    def init_params(self, key, dtype=torch.float32, device=None):
        return self.underlying.init_params(key, dtype, device) if self.underlying else {}

    def apply(self, params, x, *, training=False, rng=None, state=None, mask=None):
        step_mask = torch.any(x != self.maskValue, dim=-1)  # (B,T)
        x = x * step_mask[..., None].to(x.dtype)
        if self.underlying:
            kwargs = {"mask": step_mask.to(torch.float32)} \
                if isinstance(self.underlying, BaseRecurrentLayer) else {}
            return self.underlying.apply(params, x, training=training, rng=rng,
                                         state=state, **kwargs)
        return x, state


def _keras_space_shape(t: InputType):
    """Post-batch dims of ``t`` in Keras channels-LAST coordinates."""
    k = t.kind
    if k == "ff":
        return (t.size,)
    if k == "rnn":
        return (t.timeSeriesLength, t.size)
    if k in ("cnn", "cnnflat"):
        return (t.height, t.width, t.channels)
    if k == "cnn3d":
        return (t.depth, t.height, t.width, t.channels)
    raise ValueError(f"Reshape/Permute do not support input kind {k!r}")


def _type_from_keras_shape(s) -> InputType:
    if len(s) == 1:
        return InputType.feedForward(s[0])
    if len(s) == 2:
        return InputType.recurrent(s[1], s[0])
    if len(s) == 3:
        return InputType.convolutional(s[0], s[1], s[2])
    if len(s) == 4:
        return InputType.convolutional3D(s[0], s[1], s[2], s[3])
    raise ValueError(f"Reshape/Permute target rank {len(s)} not supported")


def _to_keras_layout(x):
    if x.dim() == 4:    # NCHW -> NHWC
        return x.permute(0, 2, 3, 1)
    if x.dim() == 5:    # NCDHW -> NDHWC
        return x.permute(0, 2, 3, 4, 1)
    return x


def _from_keras_layout(y):
    if y.dim() == 4:
        return y.permute(0, 3, 1, 2)
    if y.dim() == 5:
        return y.permute(0, 4, 1, 2, 3)
    return y


@dataclass
class ReshapeLayer(Layer):
    """Keras-semantics reshape (ref: modelimport.keras.layers.core.KerasReshape
    -> ReshapePreprocessor). ``targetShape`` is the post-batch shape in Keras'
    channels-LAST coordinates (one -1 allowed); data is converted from/to this
    framework's channels-first layouts at the boundary, so a following conv
    layer sees NCHW and a following Dense sees Keras' flatten order."""
    targetShape: Tuple[int, ...] = ()

    def _resolve(self, src):
        tgt = tuple(int(v) for v in self.targetShape)
        if any(d <= 0 for d in src):
            raise ValueError(
                "ReshapeLayer needs fully-known input dims (variable-length "
                "sequence inputs are not reshapeable)")
        total = 1
        for d in src:
            total *= d
        if tgt.count(-1) > 1:
            raise ValueError(f"ReshapeLayer: at most one -1 in {tgt}")
        if -1 in tgt:
            known = 1
            for d in tgt:
                if d != -1:
                    known *= d
            if known == 0 or total % known:
                raise ValueError(f"ReshapeLayer: cannot infer -1 in {tgt} "
                                 f"from input of {total} elements")
            tgt = tuple(total // known if d == -1 else d for d in tgt)
        out = 1
        for d in tgt:
            out *= d
        if out != total:
            raise ValueError(f"ReshapeLayer: target {tgt} has {out} elements, "
                             f"input has {total}")
        return tgt

    def output_type(self, input_type: InputType) -> InputType:
        return _type_from_keras_shape(
            self._resolve(_keras_space_shape(input_type)))

    def apply(self, params, x, *, training=False, rng=None, state=None):
        x = _to_keras_layout(x)
        tgt = self._resolve(tuple(x.shape[1:]))
        return _from_keras_layout(x.reshape((x.shape[0],) + tgt)), state


@dataclass
class PermuteLayer(Layer):
    """Keras-semantics axis permutation (ref: KerasPermute ->
    PermutePreprocessor). ``permuteDims`` are 1-based post-batch axis indices
    in Keras channels-last coordinates, exactly as Keras ``Permute(dims)``."""
    permuteDims: Tuple[int, ...] = ()

    def output_type(self, input_type: InputType) -> InputType:
        src = _keras_space_shape(input_type)
        if any(d <= 0 for d in src):
            raise ValueError(
                "PermuteLayer needs fully-known input dims (variable-length "
                "sequence inputs are not permutable)")
        if sorted(self.permuteDims) != list(range(1, len(src) + 1)):
            raise ValueError(f"Permute dims {self.permuteDims} do not match "
                             f"input rank {len(src)}")
        return _type_from_keras_shape(
            tuple(src[d - 1] for d in self.permuteDims))

    def apply(self, params, x, *, training=False, rng=None, state=None):
        x = _to_keras_layout(x)
        y = x.permute((0,) + tuple(self.permuteDims))
        return _from_keras_layout(y), state


@dataclass
class SpaceToDepthLayer(Layer):
    """(ref: conf.layers.SpaceToDepthLayer), NCHW."""
    blockSize: int = 2

    def output_type(self, input_type: InputType) -> InputType:
        b = self.blockSize
        return InputType.convolutional(input_type.height // b, input_type.width // b,
                                       input_type.channels * b * b)

    def apply(self, params, x, *, training=False, rng=None, state=None):
        return _nnops.space_to_depth(x, self.blockSize), state


# --------------------------------------------------------------- 1D/3D resize


@dataclass
class Upsampling1D(Layer):
    """Repeat along time (ref: conf.layers.Upsampling1D). Input (B,T,C)."""
    size: int = 2

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.timeSeriesLength
        return InputType.recurrent(input_type.size, t * self.size if t > 0 else -1)

    def apply(self, params, x, *, training=False, rng=None, state=None):
        return torch.repeat_interleave(x, self.size, dim=1), state


@dataclass
class Upsampling3D(Layer):
    """(ref: conf.layers.Upsampling3D), NCDHW."""
    size: Tuple[int, int, int] = (2, 2, 2)

    def output_type(self, input_type: InputType) -> InputType:
        s = self.size
        return InputType.convolutional3D(input_type.depth * s[0], input_type.height * s[1],
                                         input_type.width * s[2], input_type.channels)

    def apply(self, params, x, *, training=False, rng=None, state=None):
        for axis, s in zip((2, 3, 4), self.size):
            x = torch.repeat_interleave(x, s, dim=axis)
        return x, state


@dataclass
class Cropping1D(Layer):
    """(ref: conf.layers.convolutional.Cropping1D). Input (B,T,C)."""
    cropping: Tuple[int, int] = (0, 0)

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.timeSeriesLength
        c = self.cropping
        return InputType.recurrent(input_type.size, t - c[0] - c[1] if t > 0 else -1)

    def apply(self, params, x, *, training=False, rng=None, state=None):
        a, b = self.cropping
        return x[:, a:x.shape[1] - b], state


@dataclass
class Cropping3D(Layer):
    """(ref: conf.layers.convolutional.Cropping3D), NCDHW."""
    cropping: Tuple[int, int, int, int, int, int] = (0, 0, 0, 0, 0, 0)

    def output_type(self, input_type: InputType) -> InputType:
        d0, d1, h0, h1, w0, w1 = self.cropping
        return InputType.convolutional3D(input_type.depth - d0 - d1,
                                         input_type.height - h0 - h1,
                                         input_type.width - w0 - w1, input_type.channels)

    def apply(self, params, x, *, training=False, rng=None, state=None):
        d0, d1, h0, h1, w0, w1 = self.cropping
        return x[:, :, d0:x.shape[2] - d1, h0:x.shape[3] - h1, w0:x.shape[4] - w1], state


@dataclass
class ZeroPadding1DLayer(Layer):
    """(ref: conf.layers.ZeroPadding1DLayer). Input (B,T,C)."""
    padding: Tuple[int, int] = (0, 0)

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.timeSeriesLength
        p = self.padding
        return InputType.recurrent(input_type.size, t + p[0] + p[1] if t > 0 else -1)

    def apply(self, params, x, *, training=False, rng=None, state=None):
        a, b = self.padding
        return F.pad(x, (0, 0, a, b)), state


@dataclass
class ZeroPadding3DLayer(Layer):
    """(ref: conf.layers.ZeroPadding3DLayer), NCDHW."""
    padding: Tuple[int, int, int, int, int, int] = (0, 0, 0, 0, 0, 0)

    def output_type(self, input_type: InputType) -> InputType:
        d0, d1, h0, h1, w0, w1 = self.padding
        return InputType.convolutional3D(input_type.depth + d0 + d1,
                                         input_type.height + h0 + h1,
                                         input_type.width + w0 + w1, input_type.channels)

    def apply(self, params, x, *, training=False, rng=None, state=None):
        d0, d1, h0, h1, w0, w1 = self.padding
        return F.pad(x, (w0, w1, h0, h1, d0, d1)), state


# ------------------------------------------------------------------- 3D conv


def _triple(v):
    if isinstance(v, (tuple, list)):
        return tuple(v)
    return (v, v, v)


@dataclass
class Convolution3D(FeedForwardLayer):
    """3D conv, NCDHW (ref: conf.layers.Convolution3D -> libnd4j conv3dnew;
    here the registry's conv3d with XLA's SAME padding)."""
    spatial_input = True
    kernelSize: Tuple[int, int, int] = (2, 2, 2)
    stride: Tuple[int, int, int] = (1, 1, 1)
    padding: Tuple[int, int, int] = (0, 0, 0)
    dilation: Tuple[int, int, int] = (1, 1, 1)
    convolutionMode: str = "Truncate"
    hasBias: bool = True

    def set_n_in(self, input_type: InputType):
        if not self.nIn:
            self.nIn = input_type.channels

    def output_type(self, input_type: InputType) -> InputType:
        k, s, p = _triple(self.kernelSize), _triple(self.stride), _triple(self.padding)
        d = _conv_out(input_type.depth, k[0], s[0], p[0], self.convolutionMode)
        h = _conv_out(input_type.height, k[1], s[1], p[1], self.convolutionMode)
        w = _conv_out(input_type.width, k[2], s[2], p[2], self.convolutionMode)
        return InputType.convolutional3D(d, h, w, self.nOut)

    def init_params(self, key, dtype=torch.float32, device=None):
        dev = _dev(device)
        k = _triple(self.kernelSize)
        fan_in = self.nIn * k[0] * k[1] * k[2]
        fan_out = self.nOut * k[0] * k[1] * k[2]
        p = {"W": _winit.init(self.weightInit or "XAVIER", key,
                              (self.nOut, self.nIn) + k, fan_in, fan_out, dtype, dev)}
        if self.hasBias:
            p["b"] = _full(self.nOut, self.biasInit or 0.0, dtype, dev)
        return p

    def apply(self, params, x, *, training=False, rng=None, state=None):
        if self.convolutionMode == "Same":
            pad = "SAME"
        else:
            p = _triple(self.padding)
            pad = [(p[0], p[0]), (p[1], p[1]), (p[2], p[2])]
        z = _nnops.conv3d(x, params["W"], params.get("b"), strides=_triple(self.stride),
                          padding=pad, dilation=_triple(self.dilation))
        return self._activate(z), state


@dataclass
class Subsampling3DLayer(Layer):
    """3D pooling, NCDHW (ref: conf.layers.Subsampling3DLayer)."""
    poolingType: str = "MAX"
    kernelSize: Tuple[int, int, int] = (2, 2, 2)
    stride: Tuple[int, int, int] = (2, 2, 2)
    convolutionMode: str = "Truncate"

    def output_type(self, input_type: InputType) -> InputType:
        k, s = _triple(self.kernelSize), _triple(self.stride)
        d = _conv_out(input_type.depth, k[0], s[0], 0, self.convolutionMode)
        h = _conv_out(input_type.height, k[1], s[1], 0, self.convolutionMode)
        w = _conv_out(input_type.width, k[2], s[2], 0, self.convolutionMode)
        return InputType.convolutional3D(d, h, w, input_type.channels)

    def apply(self, params, x, *, training=False, rng=None, state=None):
        pad = "SAME" if self.convolutionMode == "Same" else "VALID"
        if self.poolingType == "MAX":
            fn = _nnops.max_pool3d
        elif self.poolingType == "AVG":
            fn = _nnops.avg_pool3d
        else:
            raise ValueError(f"unsupported 3D poolingType: {self.poolingType}")
        return fn(x, _triple(self.kernelSize), _triple(self.stride), pad), state


# ------------------------------------------------------------ locally connected


@dataclass
class LocallyConnected1D(FeedForwardLayer):
    """Conv1D with UNSHARED weights per position (ref: conf.layers.
    LocallyConnected1D, SameDiff-backed). Input (B,T,C); requires a fixed
    sequence length."""
    kernelSize: int = 2
    stride: int = 1
    inputLength: int = 0
    hasBias: bool = True

    def set_n_in(self, input_type: InputType):
        if not self.nIn:
            self.nIn = input_type.size
        if not self.inputLength and input_type.timeSeriesLength > 0:
            self.inputLength = input_type.timeSeriesLength

    def _out_len(self):
        return (self.inputLength - self.kernelSize) // self.stride + 1

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.nOut, self._out_len())

    def init_params(self, key, dtype=torch.float32, device=None):
        dev = _dev(device)
        T = self._out_len()
        fan = self.kernelSize * self.nIn
        p = {"W": _winit.init(self.weightInit or "XAVIER", key,
                              (T, self.kernelSize * self.nIn, self.nOut),
                              fan, self.nOut, dtype, dev)}
        if self.hasBias:
            p["b"] = torch.full((T, self.nOut), self.biasInit or 0.0, dtype=dtype, device=dev)
        return p

    def apply(self, params, x, *, training=False, rng=None, state=None):
        # patches (B, T_out, C*k), features ordered (c, k) as XLA's patch
        # extraction orders them
        win = x.transpose(1, 2).unfold(2, self.kernelSize, self.stride)  # (B,C,T_out,k)
        patches = win.permute(0, 2, 1, 3).reshape(x.shape[0], win.shape[2], -1)
        z = torch.einsum("btk,tko->bto", patches, params["W"])
        if self.hasBias:
            z = z + params["b"][None]
        return self._activate(z), state


@dataclass
class LocallyConnected2D(FeedForwardLayer):
    """Conv2D with UNSHARED weights per output position (ref:
    conf.layers.LocallyConnected2D). NCHW; requires fixed inputSize."""
    spatial_input = True
    kernelSize: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (1, 1)
    inputSize: Tuple[int, int] = (0, 0)  # (H, W)
    hasBias: bool = True

    def set_n_in(self, input_type: InputType):
        if not self.nIn:
            self.nIn = input_type.channels
        if not self.inputSize[0]:
            self.inputSize = (input_type.height, input_type.width)

    def _out_hw(self):
        k, s = _pair(self.kernelSize), _pair(self.stride)
        return ((self.inputSize[0] - k[0]) // s[0] + 1,
                (self.inputSize[1] - k[1]) // s[1] + 1)

    def output_type(self, input_type: InputType) -> InputType:
        h, w = self._out_hw()
        return InputType.convolutional(h, w, self.nOut)

    def init_params(self, key, dtype=torch.float32, device=None):
        dev = _dev(device)
        h, w = self._out_hw()
        k = _pair(self.kernelSize)
        fan = k[0] * k[1] * self.nIn
        p = {"W": _winit.init(self.weightInit or "XAVIER", key,
                              (h * w, k[0] * k[1] * self.nIn, self.nOut),
                              fan, self.nOut, dtype, dev)}
        if self.hasBias:
            p["b"] = torch.full((h * w, self.nOut), self.biasInit or 0.0, dtype=dtype,
                                device=dev)
        return p

    def apply(self, params, x, *, training=False, rng=None, state=None):
        B = x.shape[0]
        h, w = self._out_hw()
        k, s = _pair(self.kernelSize), _pair(self.stride)
        patches = _nnops.im2col(x, k, s, "VALID")  # (B, C*kh*kw, h, w)
        patches = patches.reshape(B, patches.shape[1], h * w).transpose(1, 2)
        z = torch.einsum("bpk,pko->bpo", patches, params["W"])
        if self.hasBias:
            z = z + params["b"][None]
        z = z.transpose(1, 2).reshape(B, self.nOut, h, w)
        return self._activate(z), state


# --------------------------------------------------------------- autoencoders


@dataclass
class AutoEncoder(FeedForwardLayer):
    """Denoising autoencoder (ref: conf.layers.AutoEncoder — pretrain via
    corrupted-input reconstruction; supervised forward = encoder only)."""
    corruptionLevel: float = 0.3
    sparsity: float = 0.0
    lossFunction: str = "MSE"

    def init_params(self, key, dtype=torch.float32, device=None):
        dev = _dev(device)
        kW = _split(key)[0]
        return {"W": _winit.init(self.weightInit or "XAVIER", kW, (self.nIn, self.nOut),
                                 self.nIn, self.nOut, dtype, dev),
                "b": _full(self.nOut, self.biasInit or 0.0, dtype, dev),
                "vb": torch.zeros((self.nIn,), dtype=dtype, device=dev)}  # decoder bias

    def apply(self, params, x, *, training=False, rng=None, state=None):
        return self._activate(torch.matmul(x, params["W"]) + params["b"]), state

    def pretrain_loss(self, params, x, rng):
        """Reconstruction loss on corrupted input (ref: AutoEncoder.computeGradientAndScore)."""
        xc = x
        if self.corruptionLevel > 0 and rng is not None:
            keep = _rnd().bernoulli(rng, 1.0 - self.corruptionLevel, x.shape,
                                    device=x.device)
            xc = x * keep.to(x.dtype)
        h = self._activate(torch.matmul(xc, params["W"]) + params["b"])
        recon = torch.matmul(h, params["W"].T) + params["vb"]  # tied weights
        loss = torch.mean((recon - x) ** 2) if self.lossFunction == "MSE" else \
            _losses.get(self.lossFunction)(x, recon, None)
        if self.sparsity > 0:
            loss = loss + self.sparsity * torch.mean(torch.abs(h))
        return loss


def _rnd():
    """``ndarray/random.py`` (imported when first drawn from)."""
    from deeplearning4j_tpu_torch.ndarray import random

    return random


_LOG_2PI = math.log(2 * math.pi)


@dataclass
class VariationalAutoencoder(FeedForwardLayer):
    """VAE (ref: conf.layers.variational.VariationalAutoencoder + runtime
    nn.layers.variational.VariationalAutoencoder). Pretrain = ELBO with a
    Gaussian q(z|x) (reparameterization) and a Gaussian reconstruction
    distribution; supervised forward = mean of q(z|x) (ref: VAE forward uses
    the mean vector)."""
    encoderLayerSizes: Tuple[int, ...] = (100,)
    decoderLayerSizes: Tuple[int, ...] = (100,)
    pzxActivationFunction: str = "IDENTITY"
    numSamples: int = 1
    reconstructionDistribution: str = "GAUSSIAN"  # GAUSSIAN | BERNOULLI

    def init_params(self, key, dtype=torch.float32, device=None):
        dev = _dev(device)
        wi = self.weightInit or "XAVIER"
        sizes_e = (self.nIn,) + tuple(self.encoderLayerSizes)
        sizes_d = (self.nOut,) + tuple(self.decoderLayerSizes)
        ks = _split(key, len(sizes_e) + len(sizes_d) + 2)
        ki = iter(range(len(ks)))

        def dense(n_in, n_out, k):
            return {"W": _winit.init(wi, k, (n_in, n_out), n_in, n_out, dtype, dev),
                    "b": torch.zeros((n_out,), dtype=dtype, device=dev)}

        p = {"enc": [dense(sizes_e[i], sizes_e[i + 1], ks[next(ki)])
                     for i in range(len(sizes_e) - 1)]}
        eh = sizes_e[-1]
        p["zMean"] = dense(eh, self.nOut, ks[next(ki)])
        p["zLogStd"] = dense(eh, self.nOut, ks[next(ki)])
        p["dec"] = [dense(sizes_d[i], sizes_d[i + 1], ks[next(ki)])
                    for i in range(len(sizes_d) - 1)]
        out_mult = 2 if self.reconstructionDistribution == "GAUSSIAN" else 1
        p["xOut"] = dense(sizes_d[-1], self.nIn * out_mult, ks[-1])
        return p

    def regularizable(self):
        return ()

    def _encode(self, params, x):
        h = x
        for lay in params["enc"]:
            h = self._activate(torch.matmul(h, lay["W"]) + lay["b"])
        act = _act.get(self.pzxActivationFunction)
        mean = act(torch.matmul(h, params["zMean"]["W"]) + params["zMean"]["b"])
        log_std = torch.matmul(h, params["zLogStd"]["W"]) + params["zLogStd"]["b"]
        return mean, log_std

    def _decode(self, params, z):
        h = z
        for lay in params["dec"]:
            h = self._activate(torch.matmul(h, lay["W"]) + lay["b"])
        return torch.matmul(h, params["xOut"]["W"]) + params["xOut"]["b"]

    def apply(self, params, x, *, training=False, rng=None, state=None):
        mean, _ = self._encode(params, x)
        return mean, state

    @staticmethod
    def _gaussian_log_px(x, out):
        """Per-example log-likelihood of ``x`` under the decoder's Gaussian
        (``out`` holds the means, then the log standard deviations)."""
        xm, xls = torch.chunk(out, 2, dim=-1)
        xs = torch.exp(xls)
        return -0.5 * torch.sum(((x - xm) / xs) ** 2 + 2 * xls + _LOG_2PI, dim=-1)

    def pretrain_loss(self, params, x, rng):
        """Negative ELBO (ref: VariationalAutoencoder.computeGradientAndScore)."""
        mean, log_std = self._encode(params, x)
        std = torch.exp(log_std)
        loss = 0.0
        rng = rng if rng is not None else _prng.prng_key(0)
        for s in range(max(self.numSamples, 1)):
            eps = _rnd().normal(_prng.fold_in(rng, s), mean.shape, mean.dtype, mean.device)
            out = self._decode(params, mean + std * eps)
            if self.reconstructionDistribution == "GAUSSIAN":
                recon = -self._gaussian_log_px(x, out)
            else:
                recon = torch.sum(torch.clamp_min(out, 0) - out * x
                                  + torch.log1p(torch.exp(-torch.abs(out))), dim=-1)
            loss = loss + torch.mean(recon)
        loss = loss / max(self.numSamples, 1)
        kl = -0.5 * torch.sum(1 + 2 * log_std - mean ** 2 - torch.exp(2 * log_std), dim=-1)
        return loss + torch.mean(kl)

    def reconstructionProbability(self, params, x, num_samples=5):
        """Monte-Carlo estimate of log p(x) (ref: VAE.reconstructionLogProbability)."""
        mean, log_std = self._encode(params, x)
        std = torch.exp(log_std)
        total = 0.0
        for s in range(num_samples):
            eps = _rnd().normal(_prng.fold_in(_prng.prng_key(7), s), mean.shape,
                                mean.dtype, mean.device)
            out = self._decode(params, mean + std * eps)
            if self.reconstructionDistribution == "GAUSSIAN":
                lp = self._gaussian_log_px(x, out)
            else:
                lp = torch.sum(x * F.logsigmoid(out) + (1 - x) * F.logsigmoid(-out), dim=-1)
            total = total + lp
        return total / num_samples


# ------------------------------------------------------- special output layers


@dataclass
class CenterLossOutputLayer(BaseOutputLayer):
    """Softmax + center loss (ref: conf.layers.CenterLossOutputLayer).
    Centers are parameters minimized by the center-loss term itself (the
    reference's SGD on the center objective; gradientCheck=true for them)."""
    alpha: float = 0.05
    lambda_: float = 2e-4

    def init_params(self, key, dtype=torch.float32, device=None):
        p = super().init_params(key, dtype, device)
        p["centers"] = torch.zeros((self.nOut, self.nIn), dtype=dtype, device=p["W"].device)
        return p

    def apply(self, params, x, *, training=False, rng=None, state=None):
        out, _ = super().apply(params, x, training=training, rng=rng, state=state)
        # capture features for the center term (read by compute_loss_ext)
        return out, {"features": x}

    def compute_loss_ext(self, params, labels, output, features, mask=None):
        base = _losses.get(self.lossFunction)(labels, output, mask)
        y = torch.argmax(labels, dim=-1)
        centers = params["centers"][y]
        center = 0.5 * torch.mean(torch.sum((features - centers) ** 2, dim=-1))
        return base + self.lambda_ * center


@dataclass
class OCNNOutputLayer(BaseOutputLayer):
    """One-class neural network output (ref: conf.ocnn.OCNNOutputLayer —
    anomaly scoring with the one-class SVM-style objective of Chalapathy et
    al.; hiddenSize V, output w·g(Vx), loss hinge around r)."""
    hiddenSize: int = 10
    nu: float = 0.04
    initialRValue: float = 0.1

    def __post_init__(self):
        self.nOut = 1
        if self.activation is None:
            self.activation = "IDENTITY"

    def init_params(self, key, dtype=torch.float32, device=None):
        dev = _dev(device)
        k1, k2 = _split(key)
        wi = self.weightInit or "XAVIER"
        return {"V": _winit.init(wi, k1, (self.nIn, self.hiddenSize),
                                 self.nIn, self.hiddenSize, dtype, dev),
                "W": _winit.init(wi, k2, (self.hiddenSize, 1), self.hiddenSize, 1, dtype, dev),
                "r": torch.tensor(self.initialRValue, dtype=dtype, device=dev)}

    def apply(self, params, x, *, training=False, rng=None, state=None):
        h = torch.sigmoid(torch.matmul(x, params["V"]))
        return torch.matmul(h, params["W"]) - params["r"], state

    def compute_loss(self, labels, output, mask=None):
        # one-class hinge only (no access to r here); prefer loss_with_params
        return torch.mean(torch.clamp_min(-output, 0.0)) / self.nu

    def loss_with_params(self, params, labels, output, mask=None):
        """Full one-class objective (Chalapathy et al.): labels unused;
        (1/nu)·mean(max(0, r − score)) − r, with output = score − r."""
        return torch.mean(torch.clamp_min(-output, 0.0)) / self.nu - params["r"]


@dataclass
class Yolo2OutputLayer(Layer):
    """YOLOv2 detection output + loss (ref: conf.layers.objdetect.
    Yolo2OutputLayer + nn.layers.objdetect.Yolo2OutputLayer). Input NCHW
    (B, A*(5+C), H, W); labels (B, 4+C, H, W) grid format as the reference's
    ObjectDetectionRecordReader emits. Anchors are in grid units."""
    boundingBoxes: Tuple = ()          # ((w,h), ...) anchor priors
    lambdaCoord: float = 5.0
    lambdaNoObj: float = 0.5

    def regularizable(self):
        return ()

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def apply(self, params, x, *, training=False, rng=None, state=None):
        return x, state

    def _split_predictions(self, x):
        A = len(self.boundingBoxes)
        B, _, H, W = x.shape
        C = x.shape[1] // A - 5
        x = x.reshape(B, A, 5 + C, H, W)
        # sigmoid xy offsets within cell, exp wh scaled by anchors, sigmoid conf
        xy = torch.sigmoid(x[:, :, 0:2])
        anchors = torch.tensor(self.boundingBoxes, dtype=x.dtype, device=x.device)  # (A,2)
        wh = torch.exp(x[:, :, 2:4]) * anchors[None, :, :, None, None]
        conf = torch.sigmoid(x[:, :, 4])
        cls = torch.softmax(x[:, :, 5:], dim=2)
        return xy, wh, conf, cls

    def compute_loss(self, labels, output, mask=None):
        """Grid-matched YOLOv2 loss. labels (B, 4+C, H, W): tx,ty,tw,th in
        grid units + one-hot class; cells without an object have all-zero
        class vector."""
        xy, wh, conf, cls = self._split_predictions(output)
        lab_xy = labels[:, 0:2]                      # (B,2,H,W) cell offsets
        lab_wh = labels[:, 2:4]
        lab_cls = labels[:, 4:]                      # (B,C,H,W) one-hot
        obj = (torch.sum(lab_cls, dim=1, keepdim=True) > 0)[:, 0]  # (B,H,W)
        # responsibility: anchor with best IOU against the label box
        inter = torch.minimum(wh[:, :, 0], lab_wh[:, None, 0]) * \
            torch.minimum(wh[:, :, 1], lab_wh[:, None, 1])
        union = wh[:, :, 0] * wh[:, :, 1] + \
            lab_wh[:, None, 0] * lab_wh[:, None, 1] - inter
        iou = inter / torch.clamp_min(union, 1e-6)   # (B,A,H,W)
        A = iou.shape[1]
        resp = F.one_hot(torch.argmax(iou, dim=1), A).movedim(-1, 1).to(iou.dtype)
        resp = resp * obj[:, None].to(iou.dtype)
        coord = torch.sum(resp[:, :, None] * (
            (xy - lab_xy[:, None]) ** 2 +
            (torch.sqrt(wh) - torch.sqrt(torch.clamp_min(lab_wh[:, None], 1e-8))) ** 2))
        conf_obj = torch.sum(resp * (conf - iou) ** 2)
        conf_noobj = torch.sum((1 - resp) * conf ** 2)
        cls_loss = torch.sum(resp[:, :, None] * (cls - lab_cls[:, None]) ** 2)
        B = output.shape[0]
        return (self.lambdaCoord * coord + conf_obj
                + self.lambdaNoObj * conf_noobj + cls_loss) / B

    def getPredictedObjects(self, output, threshold=0.5):
        """Decode detections (ref: YoloUtils.getPredictedObjects): returns a
        list per batch item of (x1, y1, x2, y2, conf, class) in grid units."""
        import numpy as np
        if not isinstance(output, torch.Tensor):
            output = torch.as_tensor(np.asarray(output))
        with torch.no_grad():
            xy, wh, conf, cls = self._split_predictions(output)
        xy, wh, conf, cls = (t.detach().float().cpu().numpy() for t in (xy, wh, conf, cls))
        B, A, H, W = conf.shape
        gy, gx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        results = []
        for b in range(B):
            dets = []
            for a in range(A):
                score = conf[b, a] * cls[b, a].max(axis=0)
                for (i, j) in zip(*np.nonzero(score > threshold)):
                    cx = gx[i, j] + xy[b, a, 0, i, j]
                    cy = gy[i, j] + xy[b, a, 1, i, j]
                    w_, h_ = wh[b, a, 0, i, j], wh[b, a, 1, i, j]
                    dets.append((cx - w_ / 2, cy - h_ / 2, cx + w_ / 2, cy + h_ / 2,
                                 float(conf[b, a, i, j]),
                                 int(cls[b, a, :, i, j].argmax())))
            results.append(dets)
        return results


# ------------------------------------------------------------ recurrent extras


@dataclass
class GravesBidirectionalLSTM(BaseRecurrentLayer):
    """Bidirectional peephole LSTM as ONE layer (ref: conf.layers.
    GravesBidirectionalLSTM — forward and backward passes each produce nOut
    and are combined additively, so output size stays nOut). A loop over T
    in each direction, as GravesLSTM."""
    forgetGateBiasInit: float = 1.0

    def _half(self) -> GravesLSTM:
        return GravesLSTM(nIn=self.nIn, nOut=self.nOut, activation=self.activation,
                          weightInit=self.weightInit,
                          forgetGateBiasInit=self.forgetGateBiasInit,
                          rnnDataFormat="NWC")

    def init_params(self, key, dtype=torch.float32, device=None):
        k1, k2 = _split(key)
        half = self._half()
        return {"fwd": half.init_params(k1, dtype, device),
                "bwd": half.init_params(k2, dtype, device)}

    def regularizable(self):
        return ()

    def apply(self, params, x, *, training=False, rng=None, state=None, mask=None):
        half = self._half()
        x = self._to_nwc(x)
        rs = half.init_rnn_state(x.shape[0], x.dtype, x.device)
        yf, _ = half.apply_rnn(params["fwd"], x, rs, mask=mask)
        xr = torch.flip(x, dims=(1,))
        mr = torch.flip(mask, dims=(1,)) if mask is not None else None
        yb, _ = half.apply_rnn(params["bwd"], xr, rs, mask=mr)
        return self._from_nwc(yf + torch.flip(yb, dims=(1,))), state


@dataclass
class LearnedSelfAttentionLayer(BaseRecurrentLayer):
    """Attention with LEARNED queries (ref: conf.layers.LearnedSelfAttentionLayer):
    nQueries fixed learned query vectors attend over the sequence, output
    (B, nQueries, nOut). The reference's plain dot_product_attention."""
    nHeads: int = 1
    nQueries: int = 1

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.nOut, self.nQueries)

    def init_params(self, key, dtype=torch.float32, device=None):
        dev = _dev(device)
        ks = _split(key, 5)
        wi = self.weightInit or "XAVIER"
        D, O = self.nIn, self.nOut
        return {"Q": _winit.init(wi, ks[0], (self.nQueries, O), O, O, dtype, dev),
                "Wk": _winit.init(wi, ks[1], (D, O), D, O, dtype, dev),
                "Wv": _winit.init(wi, ks[2], (D, O), D, O, dtype, dev),
                "Wo": _winit.init(wi, ks[3], (O, O), O, O, dtype, dev)}

    def regularizable(self):
        return ("Wk", "Wv", "Wo")

    def apply(self, params, x, *, training=False, rng=None, state=None, mask=None):
        B = x.shape[0]
        q = params["Q"][None].expand((B,) + tuple(params["Q"].shape))
        k = torch.matmul(x, params["Wk"])
        v = torch.matmul(x, params["Wv"])
        m = mask[:, None, :] if mask is not None else None
        out = _nnops.dot_product_attention(q, k, v, mask=m)
        return torch.matmul(out, params["Wo"]), state


@dataclass
class RecurrentAttentionLayer(BaseRecurrentLayer):
    """Recurrent cell whose input each step is attention over the full
    sequence conditioned on the previous hidden state (ref:
    conf.layers.RecurrentAttentionLayer, SameDiff-backed; there a scan over
    T, here a loop)."""
    nHeads: int = 1

    def init_params(self, key, dtype=torch.float32, device=None):
        dev = _dev(device)
        ks = _split(key, 5)
        wi = self.weightInit or "XAVIER"
        D, O = self.nIn, self.nOut
        return {"Wq": _winit.init(wi, ks[0], (O, O), O, O, dtype, dev),
                "Wk": _winit.init(wi, ks[1], (D, O), D, O, dtype, dev),
                "Wv": _winit.init(wi, ks[2], (D, O), D, O, dtype, dev),
                "W": _winit.init(wi, ks[3], (D, O), D, O, dtype, dev),
                "RW": _winit.init(wi, ks[4], (O, O), O, O, dtype, dev),
                "b": torch.zeros((O,), dtype=dtype, device=dev)}

    def regularizable(self):
        return ("Wq", "Wk", "Wv", "W", "RW")

    def apply(self, params, x, *, training=False, rng=None, state=None, mask=None):
        x = self._to_nwc(x)
        B, T, _ = x.shape
        keys = torch.matmul(x, params["Wk"])          # (B,T,O)
        vals = torch.matmul(x, params["Wv"])
        xw = torch.matmul(x, params["W"])
        act = _act.get(self.activation or "TANH")
        scale = 1.0 / math.sqrt(params["Wq"].shape[1])
        mbias = None
        if mask is not None:
            mbias = torch.where(mask > 0, 0.0, -1e9).to(x.dtype)  # (B,T)
        h = torch.zeros((B, self.nOut), dtype=x.dtype, device=x.device)
        ys = []
        for t in range(T):
            q = torch.matmul(h, params["Wq"])         # (B,O)
            s = torch.einsum("bo,bto->bt", q, keys) * scale
            if mbias is not None:
                s = s + mbias
            a = torch.softmax(s, dim=-1)
            ctx = torch.einsum("bt,bto->bo", a, vals)
            h = act(xw[:, t] + torch.matmul(h, params["RW"]) + ctx + params["b"])
            ys.append(h)
        return self._from_nwc(torch.stack(ys, dim=1)), state


# ------------------------------------------------------------------- capsules


def _squash(s, axis=-1):
    n2 = torch.sum(s * s, dim=axis, keepdim=True)
    return (n2 / (1.0 + n2)) * s / torch.sqrt(n2 + 1e-9)


@dataclass
class PrimaryCapsules(Layer):
    """Conv caps primary layer (ref: conf.layers.PrimaryCapsules): conv2d ->
    reshape to (B, num_caps, capsuleDimensions) -> squash."""
    capsules: int = 0               # derived if 0
    capsuleDimensions: int = 8
    channels: int = 32
    kernelSize: Tuple[int, int] = (9, 9)
    stride: Tuple[int, int] = (2, 2)
    _nIn: int = 0
    _hw: Tuple[int, int] = (0, 0)

    def set_n_in(self, input_type: InputType):
        self._nIn = input_type.channels
        k, s = _pair(self.kernelSize), _pair(self.stride)
        h = (input_type.height - k[0]) // s[0] + 1
        w = (input_type.width - k[1]) // s[1] + 1
        self._hw = (h, w)
        if not self.capsules:
            self.capsules = self.channels * h * w

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.capsuleDimensions, self.capsules)

    def init_params(self, key, dtype=torch.float32, device=None):
        dev = _dev(device)
        k = _pair(self.kernelSize)
        cout = self.channels * self.capsuleDimensions
        fan_in = self._nIn * k[0] * k[1]
        return {"W": _winit.init(self.weightInit or "XAVIER", key,
                                 (cout, self._nIn, k[0], k[1]), fan_in, cout, dtype, dev),
                "b": torch.zeros((cout,), dtype=dtype, device=dev)}

    def apply(self, params, x, *, training=False, rng=None, state=None):
        z = _nnops.conv2d(x, params["W"], params["b"], strides=_pair(self.stride),
                          padding="VALID")
        z = z.reshape(z.shape[0], -1, self.capsuleDimensions)
        return _squash(z), state


@dataclass
class CapsuleLayer(Layer):
    """Dynamic-routing capsule layer (ref: conf.layers.CapsuleLayer).
    Input (B, inputCaps, inputDims) -> (B, capsules, capsuleDimensions);
    ``routings`` iterations of routing by agreement."""
    capsules: int = 10
    capsuleDimensions: int = 16
    routings: int = 3
    inputCapsules: int = 0
    inputCapsuleDimensions: int = 0

    def set_n_in(self, input_type: InputType):
        if not self.inputCapsules:
            self.inputCapsules = input_type.timeSeriesLength
            self.inputCapsuleDimensions = input_type.size

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.capsuleDimensions, self.capsules)

    def init_params(self, key, dtype=torch.float32, device=None):
        shape = (self.inputCapsules, self.capsules,
                 self.inputCapsuleDimensions, self.capsuleDimensions)
        return {"W": _rnd().normal(key, shape, dtype, _dev(device)) * 0.01}

    def regularizable(self):
        return ()

    def apply(self, params, x, *, training=False, rng=None, state=None):
        # prediction vectors u_hat (B, inCaps, outCaps, outDim)
        u_hat = torch.einsum("bid,iodk->biok", x, params["W"])
        b = torch.zeros(u_hat.shape[:3], dtype=x.dtype, device=x.device)
        for _ in range(self.routings):
            c = torch.softmax(b, dim=2)
            s = torch.einsum("bio,biok->bok", c, u_hat)
            v = _squash(s)
            b = b + torch.einsum("biok,bok->bio", u_hat, v)
        return v, state


@dataclass
class CapsuleStrengthLayer(Layer):
    """Capsule norm per class (ref: conf.layers.CapsuleStrengthLayer)."""

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feedForward(input_type.timeSeriesLength)

    def apply(self, params, x, *, training=False, rng=None, state=None):
        return torch.sqrt(torch.sum(x * x, dim=-1) + 1e-9), state


LAYER_TYPES = {c.__name__: c for c in [
    DenseLayer, EmbeddingLayer, EmbeddingSequenceLayer, ConvolutionLayer, Convolution1DLayer,
    Deconvolution2D, DepthwiseConvolution2D, SeparableConvolution2D, SubsamplingLayer,
    Subsampling1DLayer, BatchNormalization, LocalResponseNormalization, DropoutLayer,
    ActivationLayer, Upsampling2D, ZeroPaddingLayer, Cropping2D, GlobalPoolingLayer,
    LSTM, GravesLSTM, SimpleRnn, GRU, Bidirectional, LastTimeStep,
    OutputLayer, RnnOutputLayer, LossLayer, SelfAttentionLayer,
    PReLULayer, ElementWiseMultiplicationLayer, MaskZeroLayer, SpaceToDepthLayer,
    Upsampling1D, Upsampling3D, Cropping1D, Cropping3D, ZeroPadding1DLayer,
    ZeroPadding3DLayer, Convolution3D, Subsampling3DLayer, LocallyConnected1D,
    LocallyConnected2D, AutoEncoder, VariationalAutoencoder, CenterLossOutputLayer,
    OCNNOutputLayer, Yolo2OutputLayer, GravesBidirectionalLSTM,
    LearnedSelfAttentionLayer, RecurrentAttentionLayer,
    PrimaryCapsules, CapsuleLayer, CapsuleStrengthLayer, RepeatVector,
    ConvLSTM2D, ReshapeLayer, PermuteLayer,
]}
