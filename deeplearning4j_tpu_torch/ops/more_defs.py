"""Op-surface widening, round 3 (counterpart:
``deeplearning4j_tpu/ops/more_defs.py``): SRU recurrences, roll / unique /
listdiff / searchsorted, percentile and median reductions, the
reverse-broadcast arithmetic pair, threshold compression as registry
ops, morphological dilation, max-pool with argmax, random crop and the
unified image resize.

The reference's ``lax.scan`` recurrences are loops over time here. The
keys whose output shape depends on the data (``shape.unique``,
``uniqueWithCounts``, ``listDiff``) are eager-only, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ndarray import dtypes as _dt
from deeplearning4j_tpu_torch.ops.registry import op

# ---------------------------------------------------------------- rnn: SRU
# Simple Recurrent Unit (ref: libnd4j sru/sruCell/sru_bi; Lei et al.
# 2018): the (3H x H) input projection is one matmul outside the loop, the
# recurrence elementwise.


@op("sruCell", "rnn")
def sru_cell(x_proj, c_prev, w_f, b_f, w_r, b_r):
    """One step. x_proj: (B, 3H) precomputed x@W; returns (h, c)."""
    xt, f_in, r_in = torch.chunk(x_proj, 3, dim=-1)
    f = torch.sigmoid(f_in * w_f + b_f)
    r = torch.sigmoid(r_in * w_r + b_r)
    c = f * c_prev + (1.0 - f) * xt
    h = r * torch.tanh(c) + (1.0 - r) * xt
    return h, c


@op("sru", "rnn")
def sru(x, w, w_f, b_f, w_r, b_r, c0=None, reverse=False):
    """Full-sequence SRU. x: (B, T, H); w: (H, 3H); returns (h (B,T,H), cT)."""
    B, T, H = x.shape
    proj = x @ w
    c = x.new_zeros((B, H)) if c0 is None else c0
    hs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        hs[t], c = sru_cell(proj[:, t], c, w_f, b_f, w_r, b_r)
    return torch.stack(hs, dim=1), c


@op("sruBi", "rnn")
def sru_bi(x, w_fwd, w_bwd, params_fwd, params_bwd):
    """Bidirectional SRU (ref: sru_bi): concat of fwd and reversed-bwd runs.
    params_*: tuple (w_f, b_f, w_r, b_r)."""
    h_f, _ = sru(x, w_fwd, *params_fwd)
    h_b, _ = sru(x, w_bwd, *params_bwd, reverse=True)
    return torch.cat([h_f, h_b], dim=-1)


# ------------------------------------------------------- parity: roll/unique


@op("roll", "shape")
def roll(x, shift, axis=None):
    if axis is None:
        return torch.roll(x.reshape(-1), shift).reshape(x.shape)
    return torch.roll(x, shift, dims=axis)


@op("unique", "shape")
def unique(x):
    """Sorted unique values. EAGER-ONLY (data-dependent output shape)."""
    return torch.unique(x.reshape(-1), sorted=True)


@op("uniqueWithCounts", "shape")
def unique_with_counts(x):
    """(values, counts). EAGER-ONLY."""
    vals, counts = torch.unique(x.reshape(-1), sorted=True,
                                return_counts=True)
    return vals, counts


@op("listDiff", "shape")
def list_diff(x, y):
    """Values (and their indices in x) present in x but not y (ref:
    listdiff / tf.setdiff1d). EAGER-ONLY."""
    x = x.reshape(-1)
    mask = ~torch.isin(x, y.reshape(-1))
    idx = torch.nonzero(mask)[:, 0]
    return x[idx], idx


@op("searchsorted", "shape")
def searchsorted(sorted_seq, values, side="left"):
    """int32 insertion points, as ``jnp.searchsorted``."""
    values = torch.as_tensor(values, device=sorted_seq.device)
    return torch.searchsorted(sorted_seq, values.to(sorted_seq.dtype),
                              right=side == "right").to(torch.int32)


# ------------------------------------------------------------- reductions


def _quantile(x, q, axis, keepdims):
    """``jnp.quantile``'s linear interpolation (torch.median would take
    the lower of two middles)."""
    if not x.is_floating_point():
        x = x.to(_dt.float_())
    qt = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    if axis is None:
        out = torch.quantile(x.reshape(-1), qt)
        return out.reshape((1,) * x.dim()) if keepdims else out
    if isinstance(axis, (tuple, list)):
        axes = sorted(a % x.dim() for a in axis)
        rest = [d for d in range(x.dim()) if d not in axes]
        flat = x.permute(*rest, *axes).reshape(
            [x.shape[d] for d in rest] + [-1])
        out = torch.quantile(flat, qt, dim=-1)
        if keepdims:
            for a in axes:
                out = out.unsqueeze(a)
        return out
    return torch.quantile(x, qt, dim=axis, keepdim=keepdims)


op("percentile", "reduce")(
    lambda x, q, axis=None, keepdims=False: _quantile(x, q / 100.0, axis,
                                                      keepdims))
op("median", "reduce")(
    lambda x, axis=None, keepdims=False: _quantile(x, 0.5, axis, keepdims))


# ------------------------------------------ math: reverse-broadcast & misc
# nd4j exposes reverse subtraction/division as ops of their own because
# its in-place op model cannot flip operands (INDArray.rsub/rdiv).


def _mod(x, y):
    from deeplearning4j_tpu_torch.ops.math_defs import _remainder

    return _remainder(x, y)


class _Xlogy(torch.autograd.Function):
    """``jax.scipy.special.xlogy``: 0 where x is 0, else x log y; its
    derivative is JAX's (log y in x everywhere, x / y in y), where
    torch's is 0 in x at x = 0."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        out = x * torch.log(y)
        return torch.where(x == 0, torch.zeros((), dtype=out.dtype,
                                               device=out.device), out)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        gx = (g * torch.log(y)).sum_to_size(x.shape) \
            if ctx.needs_input_grad[0] else None
        gy = (g * x / y).sum_to_size(y.shape) \
            if ctx.needs_input_grad[1] else None
        return gx, gy


def _xlogy(x, y):
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(x, dtype=y.dtype, device=y.device)
    if not isinstance(y, torch.Tensor):
        y = torch.tensor(y, dtype=x.dtype, device=x.device)
    dtype = torch.result_type(x, y)
    if not dtype.is_floating_point:
        dtype = _dt.float_()
    return _Xlogy.apply(x.to(dtype), y.to(dtype))


for _name, _fn in {
    "rsub": lambda x, y: y - x,
    "rdiv": lambda x, y: y / x,
    "mod": _mod,
    "hypot": torch.hypot,
    "xlogy": _xlogy,
    "erfinv": torch.erfinv,
    "sinc": torch.sinc,
}.items():
    op(_name, "math")(_fn)


@op("isMax", "math")
def is_max(x, axis=None):
    """Boolean mask of the max position(s) (ref: transforms/ismax)."""
    if axis is None:
        return x == torch.amax(x)
    return x == torch.amax(x, dim=axis, keepdim=True)


# ------------------------------------------------------- compression ops
# Registry ops over the gradient-sharing primitives (ref: libnd4j
# generic/compression/threshold.cpp encode/decode custom ops).


@op("thresholdEncode", "math")
def threshold_encode_op(grad, threshold):
    from deeplearning4j_tpu_torch.parallel.gradient_sharing import (
        threshold_encode)
    return threshold_encode(grad, threshold)


@op("thresholdDecode", "math")
def threshold_decode_op(encoded):
    from deeplearning4j_tpu_torch.parallel.gradient_sharing import (
        threshold_decode)
    return threshold_decode(encoded)


# ----------------------------------------------------------------- cnn/nn


def _patches(x, kernel, strides, padding, rates=(1, 1), value=0.0):
    """``lax.conv_general_dilated_patches`` of NCHW ``x``: (B, C, kH*kW,
    OH, OW), 'SAME' or 'VALID' padding with ``value``."""
    from deeplearning4j_tpu_torch.ops.nn_defs import _pad_spatial, _pads

    pads = _pads(padding, x.shape[2:], tuple(kernel), tuple(strides),
                 tuple(rates))
    xp = _pad_spatial(x, pads, value)
    kH, kW = kernel
    eff = [(k - 1) * r + 1 for k, r in zip(kernel, rates)]
    OH = (xp.shape[2] - eff[0]) // strides[0] + 1
    OW = (xp.shape[3] - eff[1]) // strides[1] + 1
    cols = F.unfold(xp, (kH, kW), dilation=tuple(rates), stride=tuple(strides))
    return cols.reshape(x.shape[0], x.shape[1], kH * kW, OH, OW)


@op("dilation2d", "cnn")
def dilation2d(x, kernel, strides=(1, 1), rates=(1, 1), padding="SAME"):
    """Grayscale morphological dilation (ref: nn/dilation2d; NCHW in/out,
    kernel (C, kH, kW)): the max of patch + kernel, the patches padded
    with zeros as the reference's patch extraction pads them."""
    C, kH, kW = kernel.shape
    p = _patches(x, (kH, kW), strides, padding, rates)
    return torch.amax(p + kernel.reshape(1, C, kH * kW, 1, 1), dim=2)


@op("maxPoolWithArgmax", "cnn")
def max_pool_with_argmax(x, kernel=(2, 2), strides=None, padding="VALID"):
    """(pooled, flat argmax indices) (ref: nn/max_pool_with_argmax; NCHW).
    Indices are flattened per image (C*H*W space), as TF's, int32."""
    kH, kW = kernel
    strides = strides or kernel
    sH, sW = strides
    B, C, H, W = x.shape
    if padding == "SAME":
        OH, OW = -(-H // sH), -(-W // sW)
        pad_h = max((OH - 1) * sH + kH - H, 0)
        pad_w = max((OW - 1) * sW + kW - W, 0)
        pt, pl = pad_h // 2, pad_w // 2
        # the dtype's finite min: a padding cell never wins the argmax
        lowest = torch.finfo(x.dtype).min if x.is_floating_point() \
            else torch.iinfo(x.dtype).min
        x = F.pad(x, (pl, pad_w - pl, pt, pad_h - pt), value=lowest)
    elif padding == "VALID":
        pt = pl = 0
    else:
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    p = _patches(x, kernel, strides, "VALID")
    OH, OW = p.shape[-2:]
    k = torch.argmax(p, dim=2)
    pooled = torch.take_along_dim(p, k[:, :, None], dim=2)[:, :, 0]
    k = k.to(torch.int32)
    oh = torch.arange(OH, dtype=torch.int32, device=x.device)[:, None]
    ow = torch.arange(OW, dtype=torch.int32, device=x.device)[None, :]
    row = oh * sH + torch.div(k, kW, rounding_mode="floor") - pt
    col = ow * sW + torch.remainder(k, kW) - pl
    c_off = (torch.arange(C, dtype=torch.int32, device=x.device)
             * H * W)[None, :, None, None]
    return pooled, (c_off + row * W + col).to(torch.int32)


# ------------------------------------------------------------------ image


@op("randomCrop", "image")
def random_crop(key, x, size):
    """Random spatial crop (ref: image/random_crop; NCHW or HWC — crops the
    trailing len(size) dims), the offsets ``jax.random.randint``'s."""
    from deeplearning4j_tpu_torch.ndarray import random as rnd

    n = len(size)
    start_max = torch.tensor(x.shape[-n:], dtype=torch.int64) \
        - torch.tensor(list(size), dtype=torch.int64)
    starts = rnd.randint(key, (n,), 0, start_max + 1, _dt.int_(),
                         device=x.device)
    for d, (b, s) in enumerate(zip(starts.tolist(), size)):
        dim = x.dim() - n + d
        b = min(max(int(b), 0), x.shape[dim] - int(s))
        x = x.narrow(dim, b, int(s))
    return x


@op("imageResize", "image")
def image_resize(x, size, method="bilinear"):
    """Unified resize dispatcher (ref: image/image_resize with its method
    enum; NCHW). Methods: nearest | bilinear | bicubic | lanczos3 | area
    (``jax.image.resize``'s kernels; area averages integer downscales,
    else bilinear, as the reference)."""
    from deeplearning4j_tpu_torch.ops.extra_defs import _jax_resize

    H, W = size
    if method == "area":
        sh, sw = x.shape[-2] // H, x.shape[-1] // W
        if sh >= 1 and sw >= 1 and x.shape[-2] == H * sh \
                and x.shape[-1] == W * sw:
            return x.reshape(*x.shape[:-2], H, sh, W, sw).mean(dim=(-3, -1))
        method = "bilinear"
    method = {"nearest": "nearest", "bilinear": "bilinear",
              "bicubic": "cubic", "lanczos3": "lanczos3"}[method]
    return _jax_resize(x, (-2, -1), size, method)
