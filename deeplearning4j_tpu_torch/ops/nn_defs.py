"""NN / CNN / RNN / loss / image op definitions over torch (counterpart:
``deeplearning4j_tpu/ops/nn_defs.py``).

Covers the reference's declarable custom-op inventory for neural nets
(libnd4j include/ops/declarable/generic: conv2d, lstmLayer, batchnorm,
softmax, attention, image_resize, ...). Each entry computes what the
reference's entry of the same key computes. All are plain PyTorch — the
reference computes them as jnp/lax code that XLA fuses — except the two
attention ops, which route to the port's hand-written attention kernels
where the reference routes to its Pallas kernels
(:func:`scaled_dot_product_attention_fused`,
:func:`multi_head_attention`).

Layout convention: CNN ops default to NCHW with OIHW kernels (the
reference's default); NHWC/HWIO is available via ``data_format``. Padding
``"SAME"`` is XLA's, which can put one more row or column after than
before; torch's ``padding="same"`` takes no stride, so every conv and pool
pads explicitly.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ndarray import dtypes as _dt
from deeplearning4j_tpu_torch.ndarray.array import take as _take
from deeplearning4j_tpu_torch.ops.registry import op


def _rnd():
    """``ndarray/random.py``, imported when first drawn from (it imports
    ``models``, which imports this package)."""
    from deeplearning4j_tpu_torch.ndarray import random

    return random

# -------------------------------------------------------------- activations
# (ref: org.nd4j.linalg.activations.impl.* — ~25 classes)

_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946


def _elu(x, alpha=1.0):
    """``jax.nn.elu``: x above 0, alpha * expm1(x) at or below."""
    safe = torch.where(x > 0, torch.zeros_like(x), x)
    return torch.where(x > 0, x, alpha * torch.expm1(safe))


def _celu(x, alpha=1.0):
    return torch.clamp_min(x, 0.0) + alpha * torch.expm1(
        torch.clamp_max(x, 0.0) / alpha)


def _gelu(x, approximate=True):
    """``jax.nn.gelu``: the tanh form by default (torch's default is the
    exact erf form)."""
    if approximate:
        return F.gelu(x, approximate="tanh")
    return x * (torch.erf(x / math.sqrt(2)) + 1) / 2


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0) (no threshold, unlike
    torch's)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def _gumbel_softmax(key, logits, temperature=1.0, axis=-1):
    """Softmax of (logits + Gumbel noise) / temperature; the noise is
    ``jax.random.gumbel``'s default float (``dtypes.float_``)."""
    g = _rnd().gumbel(key, logits.shape, _dt.float_(), logits.device)
    return torch.softmax((logits + g) / temperature, dim=axis)


for _name, _fn in {
    "relu": torch.relu,
    "relu6": _relu6,
    "leakyRelu": lambda x, alpha=0.01: torch.where(x >= 0, x, alpha * x),
    "elu": _elu,
    "selu": lambda x: _SELU_SCALE * _elu(x, _SELU_ALPHA),
    "celu": _celu,
    "gelu": _gelu,
    "sigmoid": torch.sigmoid,
    "hardSigmoid": lambda x: _relu6(x + 3.0) / 6.0,
    "hardTanh": lambda x: torch.clamp(x, -1.0, 1.0),
    "softmax": lambda x, axis=-1: torch.softmax(x, dim=axis),
    "logSoftmax": lambda x, axis=-1: torch.log_softmax(x, dim=axis),
    "softplus": _softplus,
    "softsign": lambda x: x / (torch.abs(x) + 1),
    "swish": F.silu,
    "mish": lambda x: x * torch.tanh(_softplus(x)),
    "prelu": lambda x, alpha: torch.where(x >= 0, x, alpha * x),
    "thresholdRelu": lambda x, theta=1.0: torch.where(x > theta, x, 0.0),
    "rationalTanh": lambda x: 1.7159 * torch.tanh(2.0 * x / 3.0),
    "rectifiedTanh": lambda x: torch.clamp_min(torch.tanh(x), 0.0),
    "gumbelSoftmax": _gumbel_softmax,
}.items():
    op(_name, "nn")(_fn)


@op("linear", "nn")
def linear(x, w, b=None):
    """Dense affine: x @ w (+ b). w: (in, out)."""
    y = torch.matmul(x, w)
    return y + b if b is not None else y


@op("layerNorm", "nn")
def layer_norm(x, gain=None, bias=None, axis=-1, eps=1e-5):
    mean = torch.mean(x, dim=axis, keepdim=True)
    var = torch.var(x, dim=axis, keepdim=True, correction=0)
    y = (x - mean) * torch.rsqrt(var + eps)
    if gain is not None:
        y = y * gain
    if bias is not None:
        y = y + bias
    return y


@op("batchNorm", "nn")
def batch_norm(x, mean, var, gamma=None, beta=None, eps=1e-5, axis=1):
    """Inference-mode batch norm over channel ``axis`` (ref: batchnorm op)."""
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    y = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + eps)
    if gamma is not None:
        y = y * gamma.reshape(shape)
    if beta is not None:
        y = y + beta.reshape(shape)
    return y


@op("lrn", "nn")
def local_response_normalization(x, depth_radius=5, bias=1.0, alpha=1.0,
                                 beta=0.5):
    """LRN over channel dim of NCHW input (ref: LocalResponseNormalization)."""
    sq = x * x
    padded = F.pad(sq, (0, 0, 0, 0, depth_radius, depth_radius))
    windows = sum(padded[:, i:i + x.shape[1]]
                  for i in range(2 * depth_radius + 1))
    return x / torch.pow(bias + alpha * windows, beta)


@op("dotProductAttention", "nn")
def dot_product_attention(q, k, v, mask=None, scaled=True):
    """(ref: dot_product_attention / multi_head_dot_product_attention custom op)
    q,k,v: (..., seq, head_dim); mask: broadcastable to (..., q_seq, k_seq)."""
    d = q.shape[-1]
    scores = torch.einsum("...qd,...kd->...qk", q, k)
    if scaled:
        scores = scores / torch.sqrt(torch.tensor(d, dtype=scores.dtype,
                                                  device=scores.device))
    if mask is not None:
        scores = torch.where(mask.bool(), scores,
                             torch.finfo(scores.dtype).min)
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("...qk,...kd->...qd", weights, v)


def active_global_mesh():
    """Always None. The reference turns the kernels' auto route off inside
    a JAX ``with mesh:`` context, where a monolithic kernel over sharded
    operands would force all-gathers; the port's mesh is explicit
    (``parallel/mesh.py``, passed as ``mesh=``) and has no ambient
    context, so nothing here can be inside one. Kept so that both
    packages' routing reads the same."""
    return None


@op("scaledDotProductAttentionFused", "nn")
def scaled_dot_product_attention_fused(q, k, v, mask=None, scale=None,
                                       causal=False, use_kernel=None):
    """Kernel-backed scaled-dot-product attention on split-head
    (B, H, T, D) layouts — the target op of the SameDiff attention-fusion
    rewrite. ``use_kernel``: None = auto, True forces a kernel (the
    kernels' plain versions for CPU tensors), False pins the einsum.
    First-order autograd when a kernel is taken (see
    ``ops.attention_kernels.higher_order_attention``); the einsum path
    differentiates to any order.

    Auto takes a kernel only for CUDA tensors, by the reference's gate:
    the whole-head packed kernel (rows 1-2, ``mha_attention``) at
    768 <= T <= 1024, the streamed kernels (rows 3-5,
    ``flash_attention``) past T = 1024, and the einsum below. The gate
    was measured on a TPU; the H100's own times of both routes at T = 512
    and 1024 are in PERF.md. On the card the kernels take float32 and
    bfloat16 only: other dtypes take the einsum (auto) or raise
    ``ValueError`` (``use_kernel=True``).

    ``mask`` is ADDITIVE, broadcast onto the (B, H, T, T) scores after
    scaling (0 for visible, a large negative number for padding). A
    masked call always takes the einsum path — the kernels support only
    causal/none masking."""
    from deeplearning4j_tpu_torch.ops.attention_kernels import (
        flash_attention, flash_envelope_ok, kernel_dtypes_ok, mha_attention,
        packed_kernel_shape_ok)
    B, H, T, D = q.shape
    same = mask is None and k.shape == q.shape and v.shape == q.shape \
        and (not q.is_cuda or kernel_dtypes_ok(q, k, v))
    whole_ok = same and packed_kernel_shape_ok(T)
    stream_ok = same and T > 1024 and flash_envelope_ok(T)
    if use_kernel and not (whole_ok or stream_ok):
        raise ValueError(
            f"scaledDotProductAttentionFused: use_kernel=True but shape "
            f"{tuple(q.shape)} (mask={'set' if mask is not None else 'None'}, "
            f"dtype {q.dtype}) fits neither the whole-head (unmasked, "
            f"T % 8 == 0, T <= 1024, matching q/k/v, float32 or bfloat16 "
            f"on the card) nor the streamed kernel envelope; "
            f"use_kernel=None/False for the einsum path")
    auto = use_kernel is None and q.is_cuda and active_global_mesh() is None
    take_whole = whole_ok and (use_kernel or (auto and T >= 768))
    take_stream = stream_ok and (use_kernel or auto)
    if take_whole:
        return mha_attention(q, k, v, causal, scale)
    if take_stream:
        return flash_attention(q, k, v, causal, None, None, scale)
    sc = scale if scale is not None else 1.0 / (D ** 0.5)
    # matmul (not einsum) so leading dims BROADCAST exactly like the
    # original imported matmul chain
    s = torch.matmul(q, k.transpose(-1, -2)) * sc
    if mask is not None:
        s = s + mask.to(s.dtype)
    if causal:
        cm = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        s = torch.where(cm, s, torch.finfo(s.dtype).min)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v)


@op("multiHeadDotProductAttention", "nn")
def multi_head_attention(x_q, x_kv, wq, wk, wv, wo, num_heads, mask=None,
                         use_kernel=None):
    """Fused MHA: x_q (B,Tq,D), x_kv (B,Tk,D); wq/wk/wv: (D,O); wo: (O,O).
    Head dims derive from the PROJECTION width O, not the input width D.

    ``use_kernel``: route the unmasked square (Tq == Tk) case through the
    packed attention kernels (rows 1-2, ``mha_attention_packed``, fp32
    probabilities): the (B, T, O) projections feed the kernel directly,
    so the (B, H, T, hd) head transposes never materialize. None (default)
    = auto: the kernel for CUDA tensors, the einsum elsewhere; True forces
    it (the plain versions for CPU tensors); False forces the einsum path.
    Masked / cross-length attention always uses the einsum path, and so
    do CUDA tensors of a dtype the kernels do not take (float32 and
    bfloat16 only)."""
    from deeplearning4j_tpu_torch.ops.attention_kernels import (
        kernel_dtypes_ok, mha_attention_packed, packed_kernel_shape_ok)
    B, Tq, _ = x_q.shape
    Tk = x_kv.shape[1]
    O = wq.shape[-1]
    hd = O // num_heads
    eligible = (mask is None and Tq == Tk and packed_kernel_shape_ok(Tq)
                and O % num_heads == 0
                and (not x_q.is_cuda or kernel_dtypes_ok(x_q, x_kv)))
    auto = use_kernel is None and x_q.is_cuda \
        and active_global_mesh() is None
    if eligible and (use_kernel or auto):
        qp = torch.matmul(x_q, wq)
        kp = torch.matmul(x_kv, wk)
        vp = torch.matmul(x_kv, wv)
        out = mha_attention_packed(qp, kp, vp, num_heads, False, None,
                                   torch.float32)
        return torch.matmul(out, wo)

    def split(x, w, T):
        return torch.matmul(x, w).reshape(B, T, num_heads, hd).permute(
            0, 2, 1, 3)

    q, k, v = split(x_q, wq, Tq), split(x_kv, wk, Tk), split(x_kv, wv, Tk)
    m = mask[:, None, None, :] if (mask is not None and mask.dim() == 2) \
        else mask
    out = dot_product_attention(q, k, v, mask=m)
    out = out.permute(0, 2, 1, 3).reshape(B, Tq, O)
    return torch.matmul(out, wo)


@op("embeddingLookup", "nn")
def embedding_lookup(table, ids):
    return _take(table, ids, 0)


# --------------------------------------------------------------------- CNN


def _channels_first(data_format: str) -> bool:
    return data_format in ("NCW", "NCHW", "NCDHW")


def _to_ncx(x, w, data_format, spatial):
    """x and w in torch's layout (N, C, *S) / (O, I, *K) from
    ``data_format``'s: NC*/OI* as they are, N*C/*IO permuted."""
    if _channels_first(data_format):
        return x, w
    return (x.movedim(-1, 1),
            w.permute(spatial + 1, spatial, *range(spatial)))


def _from_ncx(y, data_format):
    return y if _channels_first(data_format) else y.movedim(1, -1)


def _same_pads(sizes, kernel, strides, dilation):
    """XLA's 'SAME' padding of each spatial dim: (before, after), the
    larger half after."""
    pads = []
    for n, k, s, d in zip(sizes, kernel, strides, dilation):
        out = -(-n // s)
        total = max((out - 1) * s + (k - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _pads(padding, sizes, kernel, strides, dilation):
    """'SAME' | 'VALID' | an int | per-dim ints or (before, after)."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return [(0, 0)] * len(kernel)
        return _same_pads(sizes, kernel, strides, dilation)
    if isinstance(padding, int):
        padding = [padding] * len(kernel)
    return [(p, p) if isinstance(p, int) else tuple(p) for p in padding]


def _pad_spatial(x, pads, value=0.0):
    """Pad the trailing spatial dims of an (N, C, *S) tensor."""
    flat = [int(v) for pair in reversed(pads) for v in pair]
    if not any(flat):
        return x
    return F.pad(x, flat, value=value)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _conv(x, w, b, strides, padding, dilation, data_format, groups,
          spatial):
    x, w = _to_ncx(x, w, data_format, spatial)
    strides, dilation = tuple(strides), tuple(dilation)
    pads = _pads(padding, x.shape[2:], w.shape[2:], strides, dilation)
    out = _CONV[spatial](_pad_spatial(x, pads), w, None, strides, 0,
                         dilation, groups)
    if b is not None:
        out = out + b.reshape((1, -1) + (1,) * spatial)
    return _from_ncx(out, data_format)


@op("conv2d", "cnn")
def conv2d(x, w, b=None, strides=(1, 1), padding="SAME", dilation=(1, 1),
           data_format="NCHW", groups=1):
    """2D convolution (ref: libnd4j generic/nn/convo/conv2d.cpp).
    x: NCHW, w: OIHW (out_ch, in_ch/groups, kh, kw) by default."""
    return _conv(x, w, b, strides, padding, dilation, data_format, groups, 2)


@op("conv1d", "cnn")
def conv1d(x, w, b=None, stride=1, padding="SAME", dilation=1,
           data_format="NCW"):
    return _conv(x, w, b, (stride,), padding, (dilation,), data_format, 1, 1)


@op("conv3d", "cnn")
def conv3d(x, w, b=None, strides=(1, 1, 1), padding="SAME",
           dilation=(1, 1, 1), data_format="NCDHW"):
    return _conv(x, w, b, strides, padding, dilation, data_format, 1, 3)


def _conv_transpose_pads(k, s, padding):
    """``lax.conv_transpose``'s padding of the stride-dilated input."""
    if padding == "SAME":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else int(np.ceil(pad_len / 2))
    else:
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    return pad_a, pad_len - pad_a


@op("deconv2d", "cnn")
def deconv2d(x, w, b=None, strides=(1, 1), padding="SAME",
             data_format="NCHW"):
    """Transposed conv (ref: deconv2d.cpp), ``lax.conv_transpose`` with
    ``transpose_kernel=True``: w is (in_ch, out_ch, kh, kw) in NCHW
    (HWIO's slots hold (kh, kw, out_ch, in_ch) in NHWC); the input is
    dilated by the strides, padded, and correlated with the flipped
    kernel."""
    nchw = data_format == "NCHW"
    if not nchw:
        x, w = x.movedim(-1, 1), w.permute(3, 2, 0, 1)
    kernel = torch.flip(w, dims=(2, 3)).transpose(0, 1)
    kh, kw = kernel.shape[2:]
    strides = tuple(strides)
    if isinstance(padding, str):
        pads = [_conv_transpose_pads(k, s, padding.upper())
                for k, s in zip((kh, kw), strides)]
    else:
        pads = _pads(padding, None, (kh, kw), strides, (1, 1))
    n, c, h, wd = x.shape
    sh, sw = strides
    dil = x.new_zeros((n, c, (h - 1) * sh + 1, (wd - 1) * sw + 1))
    dil[:, :, ::sh, ::sw] = x
    out = F.conv2d(_pad_spatial_signed(dil, pads), kernel)
    if b is not None:
        out = out + b.reshape(1, -1, 1, 1)
    return out if nchw else out.movedim(1, -1)


def _pad_spatial_signed(x, pads):
    """Pad, or crop where a pad is negative (lax's padding allows
    both)."""
    crop = [(max(-a, 0), max(-b, 0)) for a, b in pads]
    x = _pad_spatial(x, [(max(a, 0), max(b, 0)) for a, b in pads])
    for i, (a, b) in enumerate(crop):
        d = 2 + i
        x = x.narrow(d, a, x.shape[d] - a - b)
    return x


@op("depthwiseConv2d", "cnn")
def depthwise_conv2d(x, w, b=None, strides=(1, 1), padding="SAME",
                     dilation=(1, 1), data_format="NCHW"):
    """w: (ch_mult*in_ch, 1, kh, kw) grouped conv with groups=in_ch."""
    in_ch = x.shape[1] if data_format == "NCHW" else x.shape[-1]
    return _conv(x, w, b, strides, padding, dilation, data_format, in_ch, 2)


@op("separableConv2d", "cnn")
def separable_conv2d(x, depth_w, point_w, b=None, strides=(1, 1),
                     padding="SAME", data_format="NCHW"):
    y = depthwise_conv2d(x, depth_w, None, strides, padding, (1, 1),
                         data_format)
    return conv2d(y, point_w, b, (1, 1), "VALID", (1, 1), data_format)


def _windows(x, kernel, strides):
    """(N, C, *S) -> (N, C, *out, *kernel): every window, by unfold."""
    spatial = len(kernel)
    for i, (k, s) in enumerate(zip(kernel, strides)):
        x = x.unfold(2 + i, k, s)
    return x, tuple(range(-spatial, 0))


def _pool(x, kind, kernel, strides, padding, data_format="NCHW"):
    """``lax.reduce_window`` pooling: max pads with -inf (the integer
    minimum for integers); avg divides by the count of real elements
    (count_include_pad=False, the dl4j default)."""
    kernel, strides = tuple(kernel), tuple(strides)
    cf = data_format.startswith("NC")
    if not cf:
        x = x.movedim(-1, 1)
    pads = _pads(padding, x.shape[2:], kernel, strides,
                 (1,) * len(kernel))
    if kind == "max":
        low = -math.inf if x.is_floating_point() \
            else torch.iinfo(x.dtype).min
        win, dims = _windows(_pad_spatial(x, pads, low), kernel, strides)
        out = torch.amax(win, dim=dims)
    else:
        win, dims = _windows(_pad_spatial(x, pads), kernel, strides)
        out = torch.sum(win, dim=dims)
        if kind == "avg":
            ones = torch.ones_like(x[:1, :1])
            cwin, _ = _windows(_pad_spatial(ones, pads), kernel, strides)
            out = out / torch.sum(cwin, dim=dims)
    return out if cf else out.movedim(1, -1)


@op("maxPool2d", "cnn")
def max_pool2d(x, kernel=(2, 2), strides=None, padding="VALID",
               data_format="NCHW"):
    return _pool(x, "max", kernel, strides or kernel, padding, data_format)


@op("avgPool2d", "cnn")
def avg_pool2d(x, kernel=(2, 2), strides=None, padding="VALID",
               data_format="NCHW"):
    return _pool(x, "avg", kernel, strides or kernel, padding, data_format)


@op("maxPool1d", "cnn")
def max_pool1d(x, kernel=2, strides=None, padding="VALID", data_format="NCW"):
    return _pool(x, "max", (kernel,), (strides or kernel,), padding,
                 data_format)


@op("avgPool1d", "cnn")
def avg_pool1d(x, kernel=2, strides=None, padding="VALID", data_format="NCW"):
    return _pool(x, "avg", (kernel,), (strides or kernel,), padding,
                 data_format)


@op("maxPool3d", "cnn")
def max_pool3d(x, kernel=(2, 2, 2), strides=None, padding="VALID",
               data_format="NCDHW"):
    return _pool(x, "max", kernel, strides or kernel, padding, data_format)


@op("avgPool3d", "cnn")
def avg_pool3d(x, kernel=(2, 2, 2), strides=None, padding="VALID",
               data_format="NCDHW"):
    return _pool(x, "avg", kernel, strides or kernel, padding, data_format)


def _global_axes(x, data_format):
    return tuple(range(2, x.dim())) if data_format.startswith("NC") \
        else tuple(range(1, x.dim() - 1))


@op("globalAvgPool", "cnn")
def global_avg_pool(x, data_format="NCHW", keepdims=False):
    return torch.mean(x, dim=_global_axes(x, data_format), keepdim=keepdims)


@op("globalMaxPool", "cnn")
def global_max_pool(x, data_format="NCHW", keepdims=False):
    return torch.amax(x, dim=_global_axes(x, data_format), keepdim=keepdims)


@op("upsampling2d", "cnn")
def upsampling2d(x, scale=(2, 2), data_format="NCHW"):
    h = 2 if data_format == "NCHW" else 1
    return torch.repeat_interleave(
        torch.repeat_interleave(x, scale[0], dim=h), scale[1], dim=h + 1)


@op("spaceToDepth", "cnn")
def space_to_depth(x, block_size, data_format="NCHW"):
    b = block_size
    if data_format == "NCHW":
        N, C, H, W = x.shape
        x = x.reshape(N, C, H // b, b, W // b, b)
        return x.permute(0, 3, 5, 1, 2, 4).reshape(N, C * b * b, H // b,
                                                   W // b)
    N, H, W, C = x.shape
    x = x.reshape(N, H // b, b, W // b, b, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(N, H // b, W // b, C * b * b)


@op("depthToSpace", "cnn")
def depth_to_space(x, block_size, data_format="NCHW"):
    b = block_size
    if data_format == "NCHW":
        N, C, H, W = x.shape
        x = x.reshape(N, b, b, C // (b * b), H, W)
        return x.permute(0, 3, 4, 1, 5, 2).reshape(N, C // (b * b), H * b,
                                                   W * b)
    N, H, W, C = x.shape
    x = x.reshape(N, H, W, b, b, C // (b * b))
    return x.permute(0, 1, 3, 2, 4, 5).reshape(N, H * b, W * b, C // (b * b))


@op("zeroPadding2d", "cnn")
def zero_padding2d(x, padding, data_format="NCHW"):
    (pt, pb), (pl, pr) = padding
    if data_format == "NCHW":
        return F.pad(x, (pl, pr, pt, pb))
    return F.pad(x, (0, 0, pl, pr, pt, pb))


@op("cropping2d", "cnn")
def cropping2d(x, cropping, data_format="NCHW"):
    (ct, cb), (cl, cr) = cropping
    H = x.shape[2] if data_format == "NCHW" else x.shape[1]
    W = x.shape[3] if data_format == "NCHW" else x.shape[2]
    if data_format == "NCHW":
        return x[:, :, ct:H - cb, cl:W - cr]
    return x[:, ct:H - cb, cl:W - cr, :]


@op("im2col", "cnn")
def im2col(x, kernel, strides=(1, 1), padding="VALID"):
    """Patch extraction (ref: libnd4j im2col helper): NCHW in,
    (N, C*kh*kw, oh, ow) out, features ordered (c, kh, kw) as
    ``lax.conv_general_dilated_patches``."""
    kernel, strides = tuple(kernel), tuple(strides)
    pads = _pads(padding, x.shape[2:], kernel, strides, (1, 1))
    xp = _pad_spatial(x, pads)
    oh = (xp.shape[2] - kernel[0]) // strides[0] + 1
    ow = (xp.shape[3] - kernel[1]) // strides[1] + 1
    cols = F.unfold(xp, kernel, stride=strides)
    return cols.reshape(x.shape[0], -1, oh, ow)


# --------------------------------------------------------------------- RNN


@op("lstmCell", "rnn")
def lstm_cell(x, h_prev, c_prev, w_ih, w_hh, b):
    """One LSTM step. x:(B,I), h/c:(B,H), w_ih:(I,4H), w_hh:(H,4H), b:(4H,).
    Gate order: [input, forget, cell(g), output] (ref: lstmLayer gate layout)."""
    z = torch.matmul(x, w_ih) + torch.matmul(h_prev, w_hh) + b
    i, f, g, o = torch.chunk(z, 4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    g = torch.tanh(g)
    c = f * c_prev + i * g
    h = o * torch.tanh(c)
    return h, c


@op("lstmLayer", "rnn")
def lstm_layer(x, h0, c0, w_ih, w_hh, b, time_major=False, reverse=False,
               mask=None):
    """Full-sequence LSTM, one step a time position. x: (B,T,I) [or
    (T,B,I) if time_major]. Returns (outputs (B,T,H), (hT, cT)); a masked
    step (mask <= 0) carries h and c through."""
    if not time_major:
        x = x.transpose(0, 1)  # -> (T,B,I)
        if mask is not None:
            mask = mask.transpose(0, 1)  # (T,B)
    if reverse:
        x = torch.flip(x, dims=(0,))
        if mask is not None:
            mask = torch.flip(mask, dims=(0,))
    h, c = h0, c0
    ys = []
    for t in range(x.shape[0]):
        h2, c2 = lstm_cell(x[t], h, c, w_ih, w_hh, b)
        if mask is not None:
            mt = mask[t][:, None] > 0
            h2 = torch.where(mt, h2, h)
            c2 = torch.where(mt, c2, c)
        h, c = h2, c2
        ys.append(h)
    ys = torch.stack(ys)
    if reverse:
        ys = torch.flip(ys, dims=(0,))
    if not time_major:
        ys = ys.transpose(0, 1)
    return ys, (h, c)


@op("gruCell", "rnn")
def gru_cell(x, h_prev, w_ih, w_hh, b_ih, b_hh):
    """One GRU step. w_ih:(I,3H), w_hh:(H,3H). Gate order: [reset, update, new]."""
    gi = torch.matmul(x, w_ih) + b_ih
    gh = torch.matmul(h_prev, w_hh) + b_hh
    ir, iz, inew = torch.chunk(gi, 3, dim=-1)
    hr, hz, hnew = torch.chunk(gh, 3, dim=-1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    n = torch.tanh(inew + r * hnew)
    return (1.0 - z) * n + z * h_prev


def _scan(step, h0, x, time_major):
    if not time_major:
        x = x.transpose(0, 1)
    h, ys = h0, []
    for t in range(x.shape[0]):
        h = step(h, x[t])
        ys.append(h)
    ys = torch.stack(ys)
    return (ys if time_major else ys.transpose(0, 1)), h


@op("gru", "rnn")
def gru_layer(x, h0, w_ih, w_hh, b_ih, b_hh, time_major=False):
    return _scan(lambda h, xt: gru_cell(xt, h, w_ih, w_hh, b_ih, b_hh),
                 h0, x, time_major)


@op("simpleRnn", "rnn")
def simple_rnn(x, h0, w_ih, w_hh, b, activation=torch.tanh,
               time_major=False):
    return _scan(lambda h, xt: activation(
        torch.matmul(xt, w_ih) + torch.matmul(h, w_hh) + b), h0, x,
        time_major)


# -------------------------------------------------------------------- loss
# (ref: org.nd4j.linalg.lossfunctions.impl.* — ~20 classes). All take
# (labels, predictions) and reduce to scalar mean unless average=False.


def _weighted_mean(per_example, weights, average=True):
    if weights is not None:
        per_example = per_example * weights
    return torch.mean(per_example) if average else torch.sum(per_example)


@op("mse", "loss")
def loss_mse(labels, preds, weights=None, average=True):
    return _weighted_mean(torch.mean((preds - labels) ** 2, dim=-1), weights,
                          average)


@op("mae", "loss")
def loss_mae(labels, preds, weights=None, average=True):
    return _weighted_mean(torch.mean(torch.abs(preds - labels), dim=-1),
                          weights, average)


@op("mape", "loss")
def loss_mape(labels, preds, weights=None, average=True):
    return _weighted_mean(
        torch.mean(torch.abs((labels - preds) / torch.clamp_min(
            torch.abs(labels), 1e-8)), dim=-1) * 100.0,
        weights, average)


@op("msle", "loss")
def loss_msle(labels, preds, weights=None, average=True):
    return _weighted_mean(
        torch.mean((torch.log1p(torch.clamp_min(preds, 0))
                    - torch.log1p(torch.clamp_min(labels, 0))) ** 2, dim=-1),
        weights, average)


@op("mcxent", "loss")
def loss_mcxent(labels, preds_logprob_or_prob, weights=None, average=True,
                from_logits=False, label_smoothing=0.0):
    """Multi-class cross-entropy against one-hot labels (ref: LossMCXENT)."""
    if label_smoothing > 0:
        k = labels.shape[-1]
        labels = labels * (1.0 - label_smoothing) + label_smoothing / k
    if from_logits:
        logp = torch.log_softmax(preds_logprob_or_prob, dim=-1)
    else:
        logp = torch.log(torch.clamp(preds_logprob_or_prob, 1e-10, 1.0))
    return _weighted_mean(-torch.sum(labels * logp, dim=-1), weights, average)


def _nll(labels, logits):
    logp = torch.log_softmax(logits, dim=-1)
    idx = labels[..., None].to(torch.int64)
    return -torch.take_along_dim(logp, idx, dim=-1)[..., 0]


@op("sparseMcxent", "loss")
def loss_sparse_mcxent(labels, logits, weights=None, average=True):
    """Integer-label cross-entropy from logits (ref:
    sparse_softmax_cross_entropy)."""
    return _weighted_mean(_nll(labels, logits), weights, average)


@op("binaryXent", "loss")
def loss_binary_xent(labels, preds, weights=None, average=True,
                     from_logits=False):
    if from_logits:
        per = torch.clamp_min(preds, 0) - preds * labels \
            + torch.log1p(torch.exp(-torch.abs(preds)))
    else:
        p = torch.clamp(preds, 1e-7, 1.0 - 1e-7)
        per = -(labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p))
    return _weighted_mean(torch.mean(per, dim=-1), weights, average)


@op("hinge", "loss")
def loss_hinge(labels, preds, weights=None, average=True):
    return _weighted_mean(torch.mean(torch.clamp_min(1.0 - labels * preds,
                                                     0.0), dim=-1),
                          weights, average)


@op("squaredHinge", "loss")
def loss_squared_hinge(labels, preds, weights=None, average=True):
    return _weighted_mean(torch.mean(torch.clamp_min(
        1.0 - labels * preds, 0.0) ** 2, dim=-1), weights, average)


@op("huber", "loss")
def loss_huber(labels, preds, delta=1.0, weights=None, average=True):
    d = torch.abs(preds - labels)
    per = torch.where(d <= delta, 0.5 * d * d, delta * (d - 0.5 * delta))
    return _weighted_mean(torch.mean(per, dim=-1), weights, average)


@op("logCosh", "loss")
def loss_logcosh(labels, preds, weights=None, average=True):
    d = preds - labels
    per = d + _softplus(-2.0 * d) - math.log(2.0)
    return _weighted_mean(torch.mean(per, dim=-1), weights, average)


@op("poisson", "loss")
def loss_poisson(labels, preds, weights=None, average=True):
    return _weighted_mean(torch.mean(
        preds - labels * torch.log(torch.clamp_min(preds, 1e-8)), dim=-1),
        weights, average)


@op("kld", "loss")
def loss_kld(labels, preds, weights=None, average=True):
    p = torch.clamp(labels, 1e-10, 1.0)
    q = torch.clamp(preds, 1e-10, 1.0)
    return _weighted_mean(torch.sum(p * torch.log(p / q), dim=-1), weights,
                          average)


@op("cosineProximity", "loss")
def loss_cosine_proximity(labels, preds, weights=None, average=True):
    num = torch.sum(labels * preds, dim=-1)
    den = torch.linalg.vector_norm(labels, dim=-1) \
        * torch.linalg.vector_norm(preds, dim=-1)
    return _weighted_mean(-num / torch.clamp_min(den, 1e-12), weights,
                          average)


@op("l1", "loss")
def loss_l1(labels, preds, weights=None, average=True):
    return _weighted_mean(torch.sum(torch.abs(preds - labels), dim=-1),
                          weights, average)


@op("l2", "loss")
def loss_l2(labels, preds, weights=None, average=True):
    return _weighted_mean(torch.sum((preds - labels) ** 2, dim=-1), weights,
                          average)


@op("sparseMcxentWithMask", "loss")
def loss_sparse_mcxent_masked(labels, logits, mask, average=True):
    """Masked integer-label xent — the BERT MLM loss shape."""
    nll = _nll(labels, logits) * mask
    denom = torch.clamp_min(torch.sum(mask), 1.0)
    return torch.sum(nll) / denom if average else torch.sum(nll)


# -------------------------------------------------------------------- image
# (ref: libnd4j generic/parity_ops image ops + helpers/image_resize)


def _tf_resize_matrix(n_in, n_out, method, align_corners, half_pixel,
                      nearest_mode="floor", cubic_a=-0.5,
                      exclude_outside=False, roi=None,
                      pytorch_half_pixel=False):
    """1-D interpolation matrix (n_out, n_in) with TF/ONNX coordinate
    rules, float32 numpy (the reference's, which builds it in numpy too).

    half_pixel (TF2 default): src = (i+0.5)*in/out - 0.5.
    align_corners (TF1): src = i*(in-1)/(out-1). Neither (TF1 legacy
    default): src = i*in/out. ``nearest_mode`` (non-align-corners nearest
    only): 'floor' (TF legacy) or 'round_prefer_floor' (ONNX default).
    ``method='cubic'`` uses the ONNX/Keys kernel with coefficient
    ``cubic_a``; ``exclude_outside`` zeroes taps outside the image and
    renormalizes. ``roi=(start, end)`` (normalized) switches to ONNX
    tf_crop_and_resize coordinates; returns (matrix, valid) then, where
    ~valid rows must take the extrapolation value.
    """
    i = np.arange(n_out, dtype=np.float64)
    if roi is not None:
        start, end = roi
        if n_out > 1:
            src = start * (n_in - 1) + i * (end - start) * (n_in - 1) \
                / (n_out - 1)
        else:
            src = np.full(1, 0.5 * (start + end) * (n_in - 1))
        valid = (src >= 0.0) & (src <= n_in - 1)
    elif align_corners:
        scale = (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
        src = i * scale
        valid = None
    elif half_pixel:
        if pytorch_half_pixel and n_out == 1:
            src = np.zeros(1)
        else:
            src = (i + 0.5) * (n_in / n_out) - 0.5
        valid = None
    else:
        src = i * (n_in / n_out)
        valid = None
    m = np.zeros((n_out, n_in), np.float32)
    if method == "nearest":
        if align_corners:
            idx = np.floor(src + 0.5).astype(int)
        elif nearest_mode == "round_prefer_floor":
            idx = np.ceil(src - 0.5).astype(int)
        else:  # floor
            idx = np.floor(src).astype(int)
        idx = np.clip(idx, 0, n_in - 1)
        m[np.arange(n_out), idx] = 1.0
    elif method == "cubic":
        lo = np.floor(src).astype(int)
        a = float(cubic_a)

        def kern(t):
            at = np.abs(t)
            return np.where(
                at <= 1.0, (a + 2) * at ** 3 - (a + 3) * at ** 2 + 1.0,
                np.where(at < 2.0,
                         a * at ** 3 - 5 * a * at ** 2 + 8 * a * at - 4 * a,
                         0.0))

        rows = np.arange(n_out)
        for k in (-1, 0, 1, 2):
            j = lo + k
            w = kern(src - j)
            inside = (j >= 0) & (j < n_in)
            if exclude_outside:
                w = np.where(inside, w, 0.0)
            np.add.at(m, (rows, np.clip(j, 0, n_in - 1)), w)
        if exclude_outside:
            s = m.sum(axis=1, keepdims=True)
            m = m / np.where(s == 0.0, 1.0, s)
    else:  # bilinear
        src = np.clip(src, 0.0, n_in - 1)
        lo = np.floor(src).astype(int)
        hi = np.minimum(lo + 1, n_in - 1)
        frac = (src - lo).astype(np.float32)
        m[np.arange(n_out), lo] += 1.0 - frac
        m[np.arange(n_out), hi] += frac
    m = m.astype(np.float32)
    if roi is not None:
        return m, np.asarray(valid)
    return m


def _lanczos(radius):
    def kernel(x):
        with np.errstate(divide="ignore", invalid="ignore"):
            y = radius * np.sin(np.pi * x) * np.sin(np.pi * x / radius)
            out = np.where(x > 1e-3, y / np.where(x != 0, np.pi ** 2 * x ** 2,
                                                  1), 1.0)
        return np.where(x > radius, 0.0, out)
    return kernel


def _keys_cubic(x):
    """Keys' cubic kernel, a = -0.5."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


_RESIZE_KERNELS = {"bilinear": lambda x: np.maximum(0.0, 1.0 - x),
                   "cubic": _keys_cubic, "lanczos3": _lanczos(3.0),
                   "lanczos5": _lanczos(5.0)}


def _jax_resize_weights(n_in, n_out, method):
    """``jax.image.resize``'s (n_out, n_in) weights along one dim (half-
    pixel centers, antialiased when downsampling): its triangle, Keys
    cubic or Lanczos kernel, normalized per output, or nearest's floor of
    the scaled center in float32."""
    if method == "nearest":
        off = np.floor((np.arange(n_out, dtype=np.float32) + 0.5)
                       * np.float32(n_in) / np.float32(n_out))
        m = np.zeros((n_out, n_in))
        m[np.arange(n_out), np.minimum(off.astype(int), n_in - 1)] = 1.0
        return m
    scale = n_out / n_in
    inv = 1.0 / scale
    kscale = max(inv, 1.0)
    sample = (np.arange(n_out) + 0.5) * inv - 0.5
    if method not in _RESIZE_KERNELS:
        raise ValueError(f"Unknown resize method {method!r}")
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / kscale
    w = _RESIZE_KERNELS[method](x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    w = np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], w,
                 0.0)
    return w.T


def _tf_resize(x, size, method, data_format, align_corners, half_pixel,
               nearest_mode="floor", cubic_a=-0.5, exclude_outside=False,
               roi=None, extrapolation_value=0.0, pytorch_half_pixel=False):
    if data_format == "NCHW":
        H, W = x.shape[2], x.shape[3]
    else:
        H, W = x.shape[1], x.shape[2]
    fast_ok = (roi is None and half_pixel and not align_corners
               and not (method == "cubic"
                        and (cubic_a != -0.5 or exclude_outside))
               and not (pytorch_half_pixel and min(size) == 1))
    valid_h = valid_w = None
    if fast_ok:
        # jax.image.resize's sampling; a dim whose size stays is skipped
        wh = np.eye(H) if size[0] == H else \
            _jax_resize_weights(H, size[0], method)
        ww = np.eye(W) if size[1] == W else \
            _jax_resize_weights(W, size[1], method)
    else:
        roi_h = roi_w = None
        if roi is not None:
            (roi_h, roi_w) = roi
        wh = _tf_resize_matrix(H, size[0], method, align_corners, half_pixel,
                               nearest_mode, cubic_a, exclude_outside, roi_h,
                               pytorch_half_pixel)
        ww = _tf_resize_matrix(W, size[1], method, align_corners, half_pixel,
                               nearest_mode, cubic_a, exclude_outside, roi_w,
                               pytorch_half_pixel)
        if roi is not None:
            wh, valid_h = wh
            ww, valid_w = ww
    wh = torch.as_tensor(wh, device=x.device).to(x.dtype)
    ww = torch.as_tensor(ww, device=x.device).to(x.dtype)
    if data_format == "NCHW":
        out = torch.einsum("oh,nchw,pw->ncop", wh, x, ww)
    else:
        out = torch.einsum("oh,nhwc,pw->nopc", wh, x, ww)
    if roi is not None:
        # ONNX tf_crop_and_resize: coordinates outside the image take the
        # extrapolation value
        mask = torch.as_tensor(valid_h[:, None] & valid_w[None, :],
                               device=x.device)
        mask = mask[None, None] if data_format == "NCHW" \
            else mask[None, :, :, None]
        out = torch.where(mask, out, torch.tensor(
            extrapolation_value, dtype=x.dtype, device=x.device))
    return out


@op("resizeBilinear", "image")
def resize_bilinear(x, size, data_format="NCHW", align_corners=False,
                    half_pixel_centers=True, roi=None,
                    extrapolation_value=0.0, pytorch_half_pixel=False):
    """TF-semantics bilinear resize incl. the TF1 align_corners /
    legacy-coordinate modes (ref: helpers/image_resize). ``roi`` =
    ((start_h, end_h), (start_w, end_w)) normalized switches to ONNX
    tf_crop_and_resize coordinates with ``extrapolation_value`` outside."""
    return _tf_resize(x, size, "bilinear", data_format, align_corners,
                      half_pixel_centers, roi=roi,
                      extrapolation_value=extrapolation_value,
                      pytorch_half_pixel=pytorch_half_pixel)


@op("resizeNearest", "image")
def resize_nearest(x, size, data_format="NCHW", align_corners=False,
                   half_pixel_centers=True, nearest_mode="floor", roi=None,
                   extrapolation_value=0.0, pytorch_half_pixel=False):
    return _tf_resize(x, size, "nearest", data_format, align_corners,
                      half_pixel_centers, nearest_mode, roi=roi,
                      extrapolation_value=extrapolation_value,
                      pytorch_half_pixel=pytorch_half_pixel)


@op("cropAndResize", "image")
def crop_and_resize(x, boxes, box_indices, crop_size):
    """x: NHWC; boxes: (n,4) normalized [y1,x1,y2,x2]. Each crop samples
    its grid bilinearly with edge clamping (``map_coordinates`` order 1,
    mode 'nearest'), coordinates and weights in the default float."""
    n_img, H, W, C = x.shape
    f = _dt.float_()
    lin_h = torch.linspace(0.0, 1.0, crop_size[0], dtype=f, device=x.device)
    lin_w = torch.linspace(0.0, 1.0, crop_size[1], dtype=f, device=x.device)
    b = boxes.to(f)
    ys = b[:, 0:1] * (H - 1) + lin_h[None] * (b[:, 2:3] - b[:, 0:1]) * (H - 1)
    xs = b[:, 1:2] * (W - 1) + lin_w[None] * (b[:, 3:4] - b[:, 1:2]) * (W - 1)
    img = x[box_indices.to(torch.int64)].to(f)   # (n, H, W, C)

    def corners(c, size):
        lo = torch.floor(c)
        w = c - lo
        lo = lo.to(torch.int64)
        return (lo.clamp(0, size - 1), (lo + 1).clamp(0, size - 1), w)

    y0, y1, wy = corners(ys, H)
    x0, x1, wx = corners(xs, W)
    n = torch.arange(img.shape[0], device=x.device)[:, None, None]

    def at(yi, xi):
        return img[n, yi[:, :, None], xi[:, None, :]]   # (n, ch, cw, C)

    wy, wx = wy[:, :, None, None], wx[:, None, :, None]
    out = (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1) * (1 - wy) * wx
           + at(y1, x0) * wy * (1 - wx) + at(y1, x1) * wy * wx)
    return out.to(x.dtype)


@op("adjustContrast", "image")
def adjust_contrast(x, factor):
    mean = torch.mean(x, dim=(-3, -2), keepdim=True)
    return (x - mean) * factor + mean


@op("rgbToGrayscale", "image")
def rgb_to_grayscale(x):
    """NHWC RGB -> NHW1."""
    w = torch.tensor([0.2989, 0.587, 0.114], dtype=x.dtype, device=x.device)
    return torch.sum(x * w, dim=-1, keepdim=True)


@op("nonMaxSuppression", "image")
def non_max_suppression(boxes, scores, max_output, iou_threshold=0.5,
                        score_threshold=-math.inf):
    """Greedy NMS with static output size (padded with -1), int32 (ref:
    non_max_suppression.cpp returns a dynamic count)."""
    n = boxes.shape[0]
    sel = torch.full((max_output,), -1, dtype=torch.int32,
                     device=boxes.device)
    active = scores.clone()
    a_all = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    ar = torch.arange(n, device=boxes.device)
    for i in range(max_output):
        best = torch.argmax(active)
        valid = active[best] > score_threshold
        sel[i] = torch.where(valid, best.to(torch.int32),
                             torch.tensor(-1, dtype=torch.int32,
                                          device=boxes.device))
        bb = boxes[best]
        y1 = torch.maximum(bb[0], boxes[:, 0])
        x1 = torch.maximum(bb[1], boxes[:, 1])
        y2 = torch.minimum(bb[2], boxes[:, 2])
        x2 = torch.minimum(bb[3], boxes[:, 3])
        inter = torch.clamp_min(y2 - y1, 0.0) * torch.clamp_min(x2 - x1, 0.0)
        a1 = (bb[2] - bb[0]) * (bb[3] - bb[1])
        iou = inter / torch.clamp_min(a1 + a_all - inter, 1e-9)
        suppress = (iou > iou_threshold) | (ar == best)
        active = torch.where(suppress | ~valid,
                             torch.tensor(-math.inf, dtype=active.dtype,
                                          device=active.device), active)
    return sel
