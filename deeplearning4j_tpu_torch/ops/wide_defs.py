"""The last widening of the op surface toward the reference's declarable-op
inventory (counterpart: ``deeplearning4j_tpu/ops/wide_defs.py``):

- the ``updaters`` namespace — each optimizer's update rule as a pure op
  ``(grad, *state, hyperparams) -> (update, *new_state)``, the state
  laid out as the reference's ``train/updaters.py`` lays it out;
- boolean checks, parity-op stragglers, t-SNE helpers, bitmap
  compression, recurrent variants (TF block LSTM, dynamic/static RNNs,
  the ONNX LSTM/GRU/RNN layouts), image stragglers (overlap NMS, boxes,
  gamma, YIQ), deconv3d and p-norm pooling, the loss stragglers (CTC
  with the reference's alpha recursion, greedy CTC decoding), lognormal
  and multinomial draws, and the last libnd4j stragglers (bitcast,
  hashCode, fake quantization, compareAndBitpack, knn distance).

The reference's ``lax.scan`` loops are Python loops here. The keys whose
output shape depends on the data (``shape.intersection``,
``shape.whereNonzero``) and the host checks (``math.checkNumerics``,
``math.assertOp``) are eager-only, as in the reference.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ndarray import dtypes as _dt
from deeplearning4j_tpu_torch.ops.registry import op
from deeplearning4j_tpu_torch.train.updaters import rtrue_div, true_div

# ------------------------------------------------------------- updaters
# Hyperparameter names follow the reference's config classes
# (org.nd4j.linalg.learning.config.*). A step count ``t`` may be a Python
# int or an integer array; its powers are taken in the default float.


def _bias(beta, t):
    """beta ** t: a Python number for a Python t, else a 0-d tensor of the
    default float."""
    if isinstance(t, torch.Tensor):
        return beta ** t.to(_dt.float_())
    return beta ** t


def _div(a, b):
    """a / b rounded once, as the reference divides: on CUDA torch
    multiplies a tensor by the reciprocal of a Python number (and
    ``number / tensor`` is a reciprocal times the number everywhere)."""
    if isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        return true_div(a, b)
    if isinstance(b, torch.Tensor) and not isinstance(a, torch.Tensor):
        return rtrue_div(a, b)
    return a / b


def _sqrt(x):
    """The correctly rounded square root on either device, as the
    reference (XLA's) takes it. torch's float32 ``sqrt`` on the CPU is not
    correctly rounded (its AVX-512 path: one ulp off numpy's for ~0.7% of
    inputs), so the root is taken in float64 and rounded back once:
    exact, since float64 carries more than twice float32's precision plus
    two bits."""
    if x.dtype != torch.float64:
        return torch.sqrt(x.double()).to(x.dtype)
    return torch.sqrt(x)


def _up(x, *scalars):
    """``x`` in its promotion with the tensor scalars among ``scalars``:
    the reference's compiled step takes a power of an integer array
    ``t`` as a float of the default width that widens what it scales
    (a Python ``t`` widens nothing)."""
    for s in scalars:
        if isinstance(s, torch.Tensor):
            x = x.to(torch.promote_types(x.dtype, s.dtype))
    return x


@op("sgdUpdater", "updaters")
def sgd_updater(grad, lr=0.1):
    return grad * lr


@op("nesterovsUpdater", "updaters")
def nesterovs_updater(grad, v, lr=0.1, momentum=0.9):
    v_new = momentum * v - lr * grad
    update = -(momentum * v_new - lr * grad)
    return update, v_new


@op("adaGradUpdater", "updaters")
def adagrad_updater(grad, h, lr=0.1, eps=1e-6):
    h_new = h + grad * grad
    return lr * grad / (_sqrt(h_new) + eps), h_new


@op("rmsPropUpdater", "updaters")
def rmsprop_updater(grad, g2, lr=0.1, decay=0.95, eps=1e-8):
    g2_new = decay * g2 + (1.0 - decay) * grad * grad
    return lr * grad / (_sqrt(g2_new) + eps), g2_new


@op("adaDeltaUpdater", "updaters")
def adadelta_updater(grad, msg, msdx, rho=0.95, eps=1e-6):
    msg_new = rho * msg + (1.0 - rho) * grad * grad
    dx = _sqrt(msdx + eps) / _sqrt(msg_new + eps) * grad
    msdx_new = rho * msdx + (1.0 - rho) * dx * dx
    return dx, msg_new, msdx_new


@op("adamUpdater", "updaters")
def adam_updater(grad, m, v, t, lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8):
    t = t + 1
    m_new = beta1 * m + (1.0 - beta1) * grad
    v_new = beta2 * v + (1.0 - beta2) * grad * grad
    b1, b2 = _bias(beta1, t), _bias(beta2, t)
    mhat = _div(_up(m_new, b1), 1.0 - b1)
    vhat = _div(_up(v_new, b2), 1.0 - b2)
    return lr * mhat / (_sqrt(vhat) + eps), m_new, v_new, t


@op("adaMaxUpdater", "updaters")
def adamax_updater(grad, m, u, t, lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8):
    t = t + 1
    m_new = beta1 * m + (1.0 - beta1) * grad
    u_new = torch.maximum(beta2 * u, torch.abs(grad))
    b1 = _bias(beta1, t)
    return _div(lr, 1.0 - b1) * _up(m_new, b1) / (u_new + eps), m_new, u_new, t


@op("nadamUpdater", "updaters")
def nadam_updater(grad, m, v, t, lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8):
    t = t + 1
    m_new = beta1 * m + (1.0 - beta1) * grad
    v_new = beta2 * v + (1.0 - beta2) * grad * grad
    b1, b2 = _bias(beta1, t), _bias(beta2, t)
    bc1 = 1.0 - b1
    mhat = _div(_up(m_new, b1), bc1)
    vhat = _div(_up(v_new, b2), 1.0 - b2)
    m_bar = beta1 * mhat + _div(1.0 - beta1, bc1) * grad
    return lr * m_bar / (_sqrt(vhat) + eps), m_new, v_new, t


@op("amsGradUpdater", "updaters")
def amsgrad_updater(grad, m, v, vhat_max, t, lr=1e-3, beta1=0.9, beta2=0.999,
                    eps=1e-8):
    t = t + 1
    m_new = beta1 * m + (1.0 - beta1) * grad
    v_new = beta2 * v + (1.0 - beta2) * grad * grad
    vhat_new = torch.maximum(vhat_max, v_new)
    # Reddi et al. / DL4J form: alpha_t = lr*sqrt(1-b2^t)/(1-b1^t) folds the
    # bias corrections of both moments into the step size
    b1, b2 = _bias(beta1, t), _bias(beta2, t)
    alpha_t = _div(lr * (_sqrt(1.0 - b2) if isinstance(b2, torch.Tensor)
                         else math.sqrt(1.0 - b2)), 1.0 - b1)
    return alpha_t * _up(m_new, b1) / (_sqrt(vhat_new) + eps), m_new, \
        v_new, vhat_new, t


@op("adaBeliefUpdater", "updaters")
def adabelief_updater(grad, m, s, t, lr=1e-3, beta1=0.9, beta2=0.999,
                      eps=1e-8):
    t = t + 1
    m_new = beta1 * m + (1.0 - beta1) * grad
    diff = grad - m_new
    s_new = beta2 * s + (1.0 - beta2) * diff * diff + eps
    b1, b2 = _bias(beta1, t), _bias(beta2, t)
    mhat = _div(_up(m_new, b1), 1.0 - b1)
    shat = _div(_up(s_new, b2), 1.0 - b2)
    return lr * mhat / (_sqrt(shat) + eps), m_new, s_new, t


# -------------------------------------------------------- boolean checks


def _is_numeric(x):
    if isinstance(x, torch.Tensor):
        return x.dtype != torch.bool
    return np.issubdtype(np.asarray(x).dtype, np.number)


for _name, _fn in {
    "isNonDecreasing": lambda x: torch.all(x.reshape(-1)[1:]
                                           >= x.reshape(-1)[:-1]),
    "isStrictlyIncreasing": lambda x: torch.all(x.reshape(-1)[1:]
                                                > x.reshape(-1)[:-1]),
    "isNumericTensor": _is_numeric,
}.items():
    op(_name, "math")(_fn)


# -------------------------------------------------- parity-op stragglers


def _divide_no_nan(x, y):
    zero = torch.zeros((), dtype=torch.result_type(x, y), device=y.device)
    return torch.where(y == 0, zero, x / torch.where(y == 0, 1, y))


def _truncate_div(x, y):
    dtype = torch.result_type(x, y)
    q = torch.true_divide(x, y)
    return torch.trunc(q).to(dtype) if not dtype.is_floating_point \
        else torch.trunc(q)


def _cum_extremum(x, axis, fn):
    return fn(x, dim=axis % x.dim()).values


def _assign(x, y):
    y = torch.as_tensor(y, device=x.device) if not isinstance(
        y, torch.Tensor) else y
    return torch.broadcast_to(y.to(x.dtype), x.shape)


for _name, _fn in {
    "stopGradient": lambda x: x.detach(),
    "assign": _assign,
    "axpy": lambda x, y, alpha=1.0: alpha * x + y,
    "divideNoNan": _divide_no_nan,
    "realDiv": torch.true_divide,
    "truncateDiv": _truncate_div,
    "cummax": lambda x, axis=-1: _cum_extremum(x, axis, torch.cummax),
    "cummin": lambda x, axis=-1: _cum_extremum(x, axis, torch.cummin),
    "trigamma": lambda x: torch.special.polygamma(1, x),
    "nextafter": torch.nextafter,
}.items():
    op(_name, "math")(_fn)


@op("checkNumerics", "math")
def check_numerics(x, message="checkNumerics"):
    """Eager-only guard (the reference's op aborts on NaN/Inf)."""
    if not bool(torch.isfinite(x).all()):
        raise FloatingPointError(f"{message}: tensor contains NaN or Inf")
    return x


@op("biasAdd", "nn")
def bias_add(x, bias, data_format="NWC"):
    if data_format in ("NWC", "NHWC", "channels_last"):
        return x + bias
    shape = [1] * x.dim()
    shape[1] = -1
    return x + bias.reshape(shape)


@op("mirrorPad", "shape")
def mirror_pad(x, paddings, mode="REFLECT"):
    from deeplearning4j_tpu_torch.ops.math_defs import _pad

    mode = {"REFLECT": "reflect", "SYMMETRIC": "symmetric"}.get(
        str(mode).upper(), mode)
    return _pad(x, [tuple(p) for p in paddings], mode=mode)


@op("matrixSetDiag", "linalg")
def matrix_set_diag(x, diagonal):
    n = min(x.shape[-2], x.shape[-1])
    ar = torch.arange(n, device=x.device)
    out = x.clone()
    out[..., ar, ar] = diagonal.to(x.dtype)
    return out


@op("spaceToBatchNd", "cnn")
def space_to_batch_nd(x, block_shape, paddings):
    nb = len(block_shape)
    pads = [(0, 0)] + [tuple(p) for p in paddings]
    pads += [(0, 0)] * (x.dim() - len(pads))
    x = F.pad(x, [int(v) for pair in reversed(pads) for v in pair])
    n = x.shape[0]
    spatial = x.shape[1:1 + nb]
    rest = list(x.shape[1 + nb:])
    new_shape = [n]
    for dim, blk in zip(spatial, block_shape):
        new_shape += [dim // blk, blk]
    x = x.reshape(new_shape + rest)
    perm = [2 * i + 2 for i in range(nb)] + [0] \
        + [2 * i + 1 for i in range(nb)] + list(range(1 + 2 * nb, x.dim()))
    x = x.permute(*perm)
    blk_prod = int(np.prod([int(b) for b in block_shape]))
    out_shape = [n * blk_prod] + [dim // blk for dim, blk in
                                  zip(spatial, block_shape)] + rest
    return x.reshape(out_shape)


@op("batchToSpaceNd", "cnn")
def batch_to_space_nd(x, block_shape, crops):
    nb = len(block_shape)
    blk_prod = int(np.prod([int(b) for b in block_shape]))
    n = x.shape[0] // blk_prod
    spatial = list(x.shape[1:1 + nb])
    rest = list(x.shape[1 + nb:])
    x = x.reshape(list(block_shape) + [n] + spatial + rest)
    perm = [nb]
    for i in range(nb):
        perm += [nb + 1 + i, i]
    perm += list(range(2 * nb + 1, x.dim()))
    x = x.permute(*perm)
    x = x.reshape([n] + [s * b for s, b in zip(spatial, block_shape)] + rest)
    slices = [slice(None)]
    for (lo, hi), dim in zip([tuple(c) for c in crops], x.shape[1:1 + nb]):
        slices.append(slice(lo, dim - hi))
    return x[tuple(slices)]


@op("nthElement", "math")
def nth_element(x, n, reverse=False):
    s = torch.sort(x, dim=-1).values
    if reverse:
        s = torch.flip(s, dims=(-1,))
    return s[..., n]


op("broadcastShape", "shape")(
    lambda a, b: torch.broadcast_shapes(tuple(a), tuple(b)))
op("select", "shape")(lambda cond, x, y: torch.where(cond.bool(), x, y))


@op("sparseToDense", "shape")
def sparse_to_dense(indices, output_shape, values, default_value=0):
    if indices.dim() == 1:
        indices = indices[:, None]
    out = torch.full(tuple(int(s) for s in output_shape), default_value,
                     dtype=values.dtype, device=values.device)
    return out.index_put(tuple(indices.to(torch.int64).unbind(1)), values)


@op("sufficientStatistics", "math")
def sufficient_statistics(x, axes, shift=None):
    axes = tuple(axes)
    count = 1.0
    for a in axes:
        count *= x.shape[a]
    if shift is not None:
        x = x - shift
    return (torch.tensor(count, dtype=x.dtype, device=x.device),
            torch.sum(x, dim=axes), torch.sum(x * x, dim=axes))


@op("histogram", "math")
def histogram(x, bins=10):
    x = x.reshape(-1)
    lo, hi = torch.amin(x), torch.amax(x)
    width = torch.where(hi > lo, hi - lo, 1.0)
    idx = torch.clamp(((x - lo) / width * bins).to(torch.int32), 0, bins - 1)
    return torch.zeros(bins, dtype=torch.int32, device=x.device).index_add(
        0, idx.to(torch.int64),
        torch.ones(idx.numel(), dtype=torch.int32, device=x.device))


@op("splitV", "shape")
def split_v(x, size_splits, axis=0):
    return list(torch.split(x, [int(s) for s in size_splits], dim=axis))


@op("intersection", "shape")
def intersection(a, b):
    """Sorted unique values in both. EAGER-ONLY (data-dependent shape)."""
    ua = torch.unique(a.reshape(-1))
    return ua[torch.isin(ua, b.reshape(-1))]


# ----------------------------------------------------------------- t-SNE
# libnd4j generic/tsne: gradient-adaptation gains, symmetrized affinities
# and per-edge forces (their dense forms).


@op("tsneGains", "math")
def tsne_gains(gains, gradient, step, min_gain=0.01):
    same_sign = torch.sign(gradient) == torch.sign(step)
    new = torch.where(same_sign, gains * 0.8, gains + 0.2)
    return torch.clamp_min(new, min_gain)


@op("tsneSymmetrized", "math")
def tsne_symmetrized(p):
    s = p + p.T
    return s / torch.clamp_min(torch.sum(s), 1e-12)


@op("tsneEdgeForces", "math")
def tsne_edge_forces(y, p):
    """Dense attractive-force field: sum_j p_ij q'_ij (y_i - y_j)."""
    diff = y[:, None, :] - y[None, :, :]
    d2 = torch.sum(diff ** 2, dim=-1)
    w = p * (1.0 / (1.0 + d2))
    return torch.sum(w[..., None] * diff, dim=1)


@op("tsneCellContains", "math")
def tsne_cell_contains(corner, width, point):
    return torch.all((point >= corner) & (point <= corner + width), dim=-1)


# --------------------------------------------------- bitmap compression
# libnd4j generic/compression/bitmap.cpp: each element becomes {0,
# +threshold, -threshold}; dense tensors in and out.


@op("encodeBitmap", "math")
def encode_bitmap(x, threshold):
    code = torch.where(x >= threshold, 1,
                       torch.where(x <= -threshold, -1, 0)).to(torch.int8)
    return code, x - code.to(x.dtype) * threshold


@op("decodeBitmap", "math")
def decode_bitmap(code, threshold, dtype=torch.float32):
    return code.to(_dt.resolve(dtype)) * threshold


# ---------------------------------------------------- recurrent variants


@op("lstmBlockCell", "rnn")
def lstm_block_cell(x, c_prev, h_prev, w, b, forget_bias=1.0):
    """TF-style fused cell: w:(I+H, 4H), gate order [i, c, f, o]."""
    z = torch.matmul(torch.cat([x, h_prev], dim=-1), w) + b
    i, j, f, o = torch.chunk(z, 4, dim=-1)
    c = torch.sigmoid(f + forget_bias) * c_prev \
        + torch.sigmoid(i) * torch.tanh(j)
    return torch.sigmoid(o) * torch.tanh(c), c


@op("lstmBlock", "rnn")
def lstm_block(x, c0, h0, w, b, forget_bias=1.0, time_major=True):
    if not time_major:
        x = x.transpose(0, 1)
    c, h, hs = c0, h0, []
    for t in range(x.shape[0]):
        h, c = lstm_block_cell(x[t], c, h, w, b, forget_bias)
        hs.append(h)
    hs = torch.stack(hs)
    if not time_major:
        hs = hs.transpose(0, 1)
    return hs, c, h


@op("dynamicRnn", "rnn")
def dynamic_rnn(x, h0, w_ih, w_hh, b, seq_lengths=None, time_major=False):
    """Simple-RNN (tanh) over a sequence with optional per-example
    lengths: the state holds the last valid step, outputs past a length
    are zero (TF's dynamic_rnn)."""
    if not time_major:
        x = x.transpose(0, 1)
    h, hs = h0, []
    for t in range(x.shape[0]):
        h_new = torch.tanh(torch.matmul(x[t], w_ih) + torch.matmul(h, w_hh)
                           + b)
        if seq_lengths is not None:
            mask = (t < torch.as_tensor(seq_lengths, device=x.device))[:, None]
            h_new = torch.where(mask, h_new, h)
            hs.append(torch.where(mask, h_new, torch.zeros_like(h_new)))
        else:
            hs.append(h_new)
        h = h_new
    hs = torch.stack(hs)
    if not time_major:
        hs = hs.transpose(0, 1)
    return hs, h


@op("staticRnn", "rnn")
def static_rnn(x, h0, w_ih, w_hh, b, time_major=False):
    return dynamic_rnn(x, h0, w_ih, w_hh, b, seq_lengths=None,
                       time_major=time_major)


@op("dynamicBidirectionalRnn", "rnn")
def dynamic_bidirectional_rnn(x, h0_fwd, h0_bwd, w_ih_f, w_hh_f, b_f,
                              w_ih_b, w_hh_b, b_b, seq_lengths=None,
                              time_major=False):
    hs_f, hf = dynamic_rnn(x, h0_fwd, w_ih_f, w_hh_f, b_f, seq_lengths,
                           time_major)
    axis = 0 if time_major else 1
    if seq_lengths is None:
        def rev(a):
            return torch.flip(a, dims=(axis,))
    else:
        # ragged batches: reverse each example within its own length
        lens = torch.as_tensor(seq_lengths, device=x.device).to(torch.int64)
        T = x.shape[axis]
        idx = torch.arange(T, device=x.device)
        rev_bt = torch.where(idx[None, :] < lens[:, None],
                             lens[:, None] - 1 - idx[None, :], idx[None, :])
        gather = rev_bt.T[:, :, None] if time_major else rev_bt[:, :, None]

        def rev(a):
            return torch.take_along_dim(a, gather, dim=axis)
    hs_b, hb = dynamic_rnn(rev(x), h0_bwd, w_ih_b, w_hh_b, b_b, seq_lengths,
                           time_major)
    return torch.cat([hs_f, rev(hs_b)], dim=-1), hf, hb


# ------------------------------------------------------ image stragglers


@op("nonMaxSuppressionOverlaps", "image")
def non_max_suppression_overlaps(overlaps, scores, max_out,
                                 overlap_threshold=0.5,
                                 score_threshold=float("-inf")):
    """NMS given a precomputed pairwise overlap matrix (N,N); int32
    indices, padded with -1."""
    n = overlaps.shape[0]
    dev = overlaps.device
    order = torch.argsort(-scores, stable=True)
    ar = torch.arange(n, device=dev)
    selected = torch.full((max_out,), -1, dtype=torch.int32, device=dev)
    suppressed = torch.zeros(n, dtype=torch.bool, device=dev)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(min(int(n), int(max_out))):
        avail = torch.where(suppressed[order], math.inf,
                            ar.to(torch.float32))
        pick = order[torch.argmin(avail)]
        valid = (~suppressed[pick]) & (count < max_out) \
            & (scores[pick] > score_threshold)
        slot = torch.clamp_max(count, max_out - 1).to(torch.int64)
        selected = selected.index_put(
            (slot[None],), torch.where(valid, pick.to(torch.int32),
                                       selected[slot])[None])
        newly = overlaps[pick] > overlap_threshold
        suppressed = torch.where(valid, suppressed | newly | (ar == pick),
                                 suppressed)
        count = count + valid.to(torch.int32)
    return selected


@op("drawBoundingBoxes", "image")
def draw_bounding_boxes(images, boxes, colors=None):
    """images (B,H,W,C) float, boxes (B,K,4) normalized
    [ymin,xmin,ymax,xmax]: each box's border in its colour."""
    b, h, w, c = images.shape
    colors = torch.ones((1, c), dtype=images.dtype, device=images.device) \
        if colors is None else colors.to(images.dtype)
    ys = torch.arange(h, device=images.device)[:, None]
    xs = torch.arange(w, device=images.device)[None, :]
    out = []
    for i in range(b):
        im = images[i]
        cols = torch.broadcast_to(colors, (boxes.shape[1], c))
        for k in range(boxes.shape[1]):
            box = boxes[i, k]
            y0, x0, y1, x1 = (torch.round(box[j] * (n - 1)).to(torch.int32)
                              for j, n in ((0, h), (1, w), (2, h), (3, w)))
            inside = (ys >= y0) & (ys <= y1) & (xs >= x0) & (xs <= x1)
            border = inside & ((ys == y0) | (ys == y1) | (xs == x0)
                               | (xs == x1))
            im = torch.where(border[..., None], cols[k], im)
        out.append(im)
    return torch.stack(out)


op("adjustGamma", "image")(
    lambda img, gamma=1.0, gain=1.0: gain * torch.pow(img, gamma))


# -------------------------------------------------------- cnn stragglers


@op("deconv3d", "cnn")
def deconv3d(x, w, strides=(1, 1, 1), padding="VALID"):
    """x (N,C,D,H,W); w (kD,kH,kW,Cout,Cin): ``lax.conv_transpose``
    without the kernel transpose — the input dilated by the strides,
    padded, correlated with w as it is."""
    from deeplearning4j_tpu_torch.ops.nn_defs import (
        _conv_transpose_pads, _pads, _pad_spatial_signed)

    kernel = w.permute(3, 4, 0, 1, 2)
    ks = kernel.shape[2:]
    strides = tuple(strides)
    if isinstance(padding, str):
        pads = [_conv_transpose_pads(k, s, padding.upper())
                for k, s in zip(ks, strides)]
    else:
        pads = _pads(padding, None, ks, strides, (1, 1, 1))
    n, c = x.shape[:2]
    dil = x.new_zeros((n, c) + tuple((d - 1) * s + 1 for d, s in
                                     zip(x.shape[2:], strides)))
    dil[:, :, ::strides[0], ::strides[1], ::strides[2]] = x
    return F.conv3d(_pad_spatial_signed(dil, pads), kernel)


@op("pnormPool2d", "cnn")
def pnorm_pool2d(x, window=(2, 2), strides=None, padding="VALID", p=2.0):
    """p-norm pooling (N,C,H,W) — the reference's pnormpool2d."""
    from deeplearning4j_tpu_torch.ops.nn_defs import _pool

    strides = tuple(strides) if strides is not None else tuple(window)
    summed = _pool(torch.pow(torch.abs(x), p), "sum", tuple(window), strides,
                   padding)
    return torch.pow(summed, 1.0 / p)


# ------------------------------------------------------- loss stragglers


@op("weightedCrossEntropyWithLogits", "loss")
def weighted_cross_entropy_with_logits(targets, logits, pos_weight=1.0):
    log_w = 1.0 + (pos_weight - 1.0) * targets
    return (1.0 - targets) * logits + log_w * (
        torch.log1p(torch.exp(-torch.abs(logits)))
        + torch.clamp_min(-logits, 0.0))


@op("meanPairwiseSquaredError", "loss")
def mean_pairwise_squared_error(labels, predictions, weights=1.0):
    d = predictions - labels
    d = d.reshape(d.shape[0], -1)
    n = d.shape[1]
    sum_d = torch.sum(d, dim=1)
    sum_d2 = torch.sum(d * d, dim=1)
    per_ex = 2.0 * (n * sum_d2 - sum_d * sum_d) / max(n * (n - 1), 1)
    return torch.mean(per_ex * weights)


def _lse(a, b):
    m = torch.maximum(a, b)
    fin = torch.isfinite(m)
    m_safe = torch.where(fin, m, 0.0)
    return torch.where(fin, m + torch.log(torch.exp(a - m_safe)
                                          + torch.exp(b - m_safe)), m)


@op("ctcLoss", "loss")
def ctc_loss(log_probs, targets, input_lengths, target_lengths, blank=0):
    """CTC negative log-likelihood by the reference's alpha recursion.
    log_probs (B,T,V) log-softmaxed, targets (B,S) padded with any value
    beyond target_lengths."""
    B, T, V = log_probs.shape
    S = targets.shape[1]
    L = 2 * S + 1
    dev = log_probs.device
    neg = torch.tensor(-1e30, dtype=log_probs.dtype, device=dev)
    ext = torch.full((B, L), blank, dtype=targets.dtype, device=dev)
    ext[:, 1::2] = targets
    ext64 = ext.to(torch.int64)
    labels_logp = torch.take_along_dim(log_probs, ext64[:, None, :], dim=2)
    can_skip = torch.cat(
        [torch.zeros((B, 2), dtype=torch.bool, device=dev),
         (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])], dim=1)
    alpha = neg.expand(B, L).clone()
    alpha[:, 0] = labels_logp[:, 0, 0]
    alpha[:, 1] = labels_logp[:, 0, 1] if S > 0 else neg
    in_len = torch.as_tensor(input_lengths, device=dev)
    for t in range(1, T):
        prev1 = torch.cat([neg.expand(B, 1), alpha[:, :-1]], dim=1)
        prev2 = torch.cat([neg.expand(B, 2), alpha[:, :-2]], dim=1)
        prev2 = torch.where(can_skip, prev2, neg)
        merged = _lse(_lse(alpha, prev1), prev2) + labels_logp[:, t, :]
        alpha = torch.where((t < in_len)[:, None], merged, alpha)
    tl = torch.as_tensor(target_lengths, device=dev).to(torch.int64)
    last = 2 * tl
    ll_blank = torch.take_along_dim(alpha, last[:, None], dim=1)[:, 0]
    ll_label = torch.take_along_dim(
        alpha, torch.clamp_min(last - 1, 0)[:, None], dim=1)[:, 0]
    ll_label = torch.where(tl > 0, ll_label, neg)
    return -_lse(ll_blank, ll_label)


# --------------------------------------------------------- random extras


@op("lognormal", "random")
def lognormal(key, shape, mean=0.0, std=1.0, dtype=torch.float32):
    from deeplearning4j_tpu_torch.ndarray import random as rnd

    return torch.exp(rnd.normal(key, tuple(shape), dtype) * std + mean)


@op("multinomial", "random")
def multinomial(key, logits, num_samples):
    """Per-row categorical draws: (B,V) logits -> (B, num_samples)
    indices, one key a row (``split(key, B)``)."""
    from deeplearning4j_tpu_torch.models.random import as_key, split
    from deeplearning4j_tpu_torch.ops.extra_defs import categorical

    keys = split(as_key(key, logits.device), logits.shape[0])
    return torch.stack([categorical(keys[i], logits[i], (num_samples,))
                        for i in range(logits.shape[0])])


# ----------------------------------------------- import-path conveniences
# (ref: TF ops hit by frozen-graph corpora that had no registry slot)

op("einsum", "linalg")(lambda *xs, equation: torch.einsum(equation, *xs))
op("l2Loss", "loss")(lambda x: 0.5 * torch.sum(torch.square(x)))


# ------------------------------------------------ ONNX-layout recurrent ops
# (ref: samediff-import-onnx maps ONNX LSTM/GRU/RNN onto lstmLayer-class
# ops; the ONNX layouts and gate orders are op variants of their own)


def _onnx_dirs(direction):
    if direction == "bidirectional":
        return [(0, False), (1, True)]
    return [(0, direction == "reverse")]


def _onnx_mask(x, sequence_lens):
    if sequence_lens is None:
        return None
    T = x.shape[0]
    lens = torch.as_tensor(sequence_lens, device=x.device)
    return (torch.arange(T, device=x.device)[:, None] < lens[None, :]
            ).to(x.dtype)


@op("lstmOnnx", "rnn")
def lstm_onnx(x, w, r, b=None, sequence_lens=None, initial_h=None,
              initial_c=None, direction="forward"):
    """ONNX LSTM: x (T,B,I); w (D,4H,I) gates IOFC; r (D,4H,H); b (D,8H)
    = Wb|Rb; outputs (Y (T,D,B,H), Y_h (D,B,H), Y_c (D,B,H))."""
    from deeplearning4j_tpu_torch.ops.nn_defs import lstm_layer

    T, B, _ = x.shape
    four_h = w.shape[1]
    H = four_h // 4
    mask = _onnx_mask(x, sequence_lens)
    ar = torch.arange(H, device=x.device)
    perm = torch.cat([ar, 2 * H + ar, 3 * H + ar, H + ar])   # i, f, g, o
    ys_all, h_all, c_all = [], [], []
    for d, reverse in _onnx_dirs(direction):
        wi = w[d].T[:, perm]
        ri = r[d].T[:, perm]
        bias = (b[d, :four_h] + b[d, four_h:])[perm] if b is not None \
            else x.new_zeros(four_h)
        h0 = initial_h[d] if initial_h is not None else x.new_zeros((B, H))
        c0 = initial_c[d] if initial_c is not None else x.new_zeros((B, H))
        ys, (hT, cT) = lstm_layer(x, h0, c0, wi, ri, bias, time_major=True,
                                  reverse=reverse, mask=mask)
        ys_all.append(ys)
        h_all.append(hT)
        c_all.append(cT)
    return (torch.stack(ys_all, dim=1), torch.stack(h_all),
            torch.stack(c_all))


def _onnx_run(x, mask, h0, step, reverse):
    xs = torch.flip(x, dims=(0,)) if reverse else x
    ms = None if mask is None else (torch.flip(mask, dims=(0,)) if reverse
                                    else mask)
    h, ys = h0, []
    for t in range(xs.shape[0]):
        h_new = step(h, xs[t])
        if ms is not None:
            h_new = torch.where(ms[t][:, None] > 0, h_new, h)
        h = h_new
        ys.append(h)
    ys = torch.stack(ys)
    return (torch.flip(ys, dims=(0,)) if reverse else ys), h


@op("gruOnnx", "rnn")
def gru_onnx(x, w, r, b=None, sequence_lens=None, initial_h=None,
             direction="forward", linear_before_reset=0):
    """ONNX GRU: x (T,B,I); w (D,3H,I) gates ZRH; r (D,3H,H); b (D,6H)
    = Wb|Rb. Both linear_before_reset semantics."""
    T, B, _ = x.shape
    three_h = w.shape[1]
    H = three_h // 3
    mask = _onnx_mask(x, sequence_lens)
    outs = []
    for d, reverse in _onnx_dirs(direction):
        wi, ri = w[d].T, r[d].T
        wb = b[d, :three_h] if b is not None else x.new_zeros(three_h)
        rb = b[d, three_h:] if b is not None else x.new_zeros(three_h)
        h0 = initial_h[d] if initial_h is not None else x.new_zeros((B, H))

        def step(h, xt, wi=wi, ri=ri, wb=wb, rb=rb):
            gx = torch.matmul(xt, wi) + wb
            gh = torch.matmul(h, ri) + rb
            z = torch.sigmoid(gx[:, :H] + gh[:, :H])
            rr = torch.sigmoid(gx[:, H:2 * H] + gh[:, H:2 * H])
            if linear_before_reset:
                n = torch.tanh(gx[:, 2 * H:] + rr * gh[:, 2 * H:])
            else:
                n = torch.tanh(gx[:, 2 * H:]
                               + torch.matmul(rr * h, ri[:, 2 * H:])
                               + rb[2 * H:])
            return (1.0 - z) * n + z * h

        outs.append(_onnx_run(x, mask, h0, step, reverse))
    return (torch.stack([y for y, _ in outs], dim=1),
            torch.stack([h for _, h in outs]))


@op("rnnOnnx", "rnn")
def rnn_onnx(x, w, r, b=None, sequence_lens=None, initial_h=None,
             direction="forward", activation="Tanh"):
    """ONNX vanilla RNN: x (T,B,I); w (D,H,I); r (D,H,H); b (D,2H)."""
    T, B, _ = x.shape
    H = w.shape[1]
    act = {"Tanh": torch.tanh, "Relu": torch.relu,
           "Sigmoid": torch.sigmoid}[activation]
    mask = _onnx_mask(x, sequence_lens)
    outs = []
    for d, reverse in _onnx_dirs(direction):
        wi, ri = w[d].T, r[d].T
        bias = (b[d, :H] + b[d, H:]) if b is not None else x.new_zeros(H)
        h0 = initial_h[d] if initial_h is not None else x.new_zeros((B, H))

        def step(h, xt, wi=wi, ri=ri, bias=bias):
            return act(torch.matmul(xt, wi) + torch.matmul(h, ri) + bias)

        outs.append(_onnx_run(x, mask, h0, step, reverse))
    return (torch.stack([y for y, _ in outs], dim=1),
            torch.stack([h for _, h in outs]))


# ---------------------------------------------- element-indexing stragglers

op("gatherElements", "shape")(
    lambda x, indices, axis=0: torch.take_along_dim(
        x, indices.to(torch.int64), dim=axis))


@op("scatterElements", "shape")
def scatter_elements(x, indices, updates, axis=0, reduction="none"):
    idx = indices.to(torch.int64)
    updates = updates.to(x.dtype)
    if reduction == "none":
        return x.scatter(axis, idx, updates)
    if reduction == "add":
        return x.scatter_add(axis, idx, updates)
    how = {"mul": "prod", "max": "amax", "min": "amin"}[reduction]
    return x.scatter_reduce(axis, idx, updates, how, include_self=True)


@op("eyeLike", "shape")
def eye_like(x, k=0, dtype=None):
    r = torch.arange(x.shape[0], device=x.device)[:, None]
    c = torch.arange(x.shape[1], device=x.device)[None, :]
    return (c - r == k).to(x.dtype if dtype is None else _dt.resolve(dtype))


@op("shrink", "nn")
def shrink(x, bias=0.0, lambd=0.5):
    return torch.where(x > lambd, x - bias,
                       torch.where(x < -lambd, x + bias, 0.0))


@op("meanVarianceNormalization", "nn")
def mean_variance_normalization(x, axes=(0, 2, 3), eps=1e-9):
    mu = torch.mean(x, dim=tuple(axes), keepdim=True)
    var = torch.var(x, dim=tuple(axes), keepdim=True, correction=0)
    return (x - mu) / torch.sqrt(var + eps)


# ----------------------------------------------- last libnd4j stragglers


@op("bitcast", "math")
def bitcast(x, dtype):
    """``lax.bitcast_convert_type``: the same bits in ``dtype``; a
    narrower dtype adds a trailing dim, a wider one takes the last dim."""
    dtype = _dt.resolve(dtype)
    src = x.element_size()
    dst = torch.empty((), dtype=dtype).element_size()
    x = x.contiguous()
    if src == dst:
        return x.view(dtype)
    if dst < src:
        return x.view(dtype).reshape(tuple(x.shape) + (src // dst,))
    return x.view(dtype).reshape(tuple(x.shape[:-1]))


@op("assertOp", "math")
def assert_op(condition, message="assertOp failed"):
    """Eager-only (the reference's Assert aborts execution)."""
    cond = torch.as_tensor(condition)
    if not bool(cond.all()):
        raise AssertionError(message)
    return torch.tensor(True, device=cond.device)


@op("whereNonzero", "shape")
def where_nonzero(x):
    """Indices of nonzero elements, (N, ndim) int — TF's 1-input Where.
    Eager-only: the output shape depends on the data."""
    return torch.nonzero(x)


@op("fakeQuantWithMinMaxVars", "math")
def fake_quant_with_min_max_vars(x, min_val, max_val, num_bits=8,
                                 narrow_range=False):
    """TF-style fake quantization (ref: fake_quant_with_min_max_vars.cpp),
    the nudged range in float32."""
    qmin = 1.0 if narrow_range else 0.0
    qmax = 2.0 ** num_bits - 1.0
    min_val = torch.as_tensor(min_val, device=x.device).to(torch.float32)
    max_val = torch.as_tensor(max_val, device=x.device).to(torch.float32)
    if bool((max_val <= min_val).any()):
        # TF's kernel requires min < max: fail loudly, not with NaNs
        raise ValueError("fakeQuantWithMinMaxVars requires min_val < max_val")
    scale = (max_val - min_val) / (qmax - qmin)
    zero_point = qmin - min_val / scale
    nudged_zp = torch.clamp(torch.round(zero_point), qmin, qmax)
    nudged_min = (qmin - nudged_zp) * scale
    nudged_max = (qmax - nudged_zp) * scale
    clamped = torch.minimum(torch.maximum(x, nudged_min), nudged_max)
    return torch.round((clamped - nudged_min) / scale) * scale + nudged_min


@op("fakeQuantWithMinMaxVarsPerChannel", "math")
def fake_quant_per_channel(x, min_vals, max_vals, num_bits=8,
                           narrow_range=False):
    min_vals = torch.as_tensor(min_vals, device=x.device)
    max_vals = torch.as_tensor(max_vals, device=x.device)
    return torch.stack([fake_quant_with_min_max_vars(
        x[..., c], min_vals[c], max_vals[c], num_bits, narrow_range)
        for c in range(x.shape[-1])], dim=-1)


@op("knnMindistance", "math")
def knn_mindistance(point, lowest, highest):
    """Min distance from a point to an axis-aligned box (ref: helpers/knn)."""
    clamped = torch.minimum(torch.maximum(point, lowest), highest)
    return torch.sqrt(torch.sum((point - clamped) ** 2, dim=-1))


_M32 = 0xFFFFFFFF


def _mulmod32(a, b):
    """a * b mod 2^32 for int64 tensors of 32-bit values, without
    overflowing int64."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * (b & 0xFFFF)) << 16
    return (lo + hi) & _M32


@op("hashCode", "math")
def hash_code(x):
    """Order-sensitive 32-bit hash over the tensor's raw bytes with the
    Java-style ``h = 31*h + e`` recurrence (ref: hashcode.cpp hashes the
    buffer in the array's own dtype: float32 and float64 views of the same
    values hash differently). h = sum_i e_i 31^(n-1-i) mod 2^32, computed
    on the tensor's device in int64."""
    b = x.contiguous().reshape(-1).view(torch.uint8).to(torch.int64)
    n = b.numel()
    if n == 0:
        return torch.zeros((), dtype=torch.int64, device=x.device)
    k = torch.arange(n - 1, -1, -1, dtype=torch.int64, device=x.device)
    pw = torch.ones_like(k)
    base = torch.full_like(k, 31)
    while bool((k > 0).any()):
        pw = torch.where((k & 1) == 1, _mulmod32(pw, base), pw)
        base = _mulmod32(base, base)
        k = k >> 1
    return torch.sum(_mulmod32(b, pw)) & _M32


_YIQ = np.array([[0.299, 0.587, 0.114],
                 [0.5959, -0.2746, -0.3213],
                 [0.2115, -0.5227, 0.3112]], np.float32)
_YIQ_INV = np.linalg.inv(_YIQ)


def _yiq(x, m):
    return torch.einsum("...c,dc->...d", x.to(torch.float32),
                        torch.as_tensor(m, device=x.device))


op("rgbToYiq", "image")(lambda x: _yiq(x, _YIQ))
op("yiqToRgb", "image")(lambda x: _yiq(x, _YIQ_INV))


@op("compareAndBitpack", "math")
def compare_and_bitpack(x, threshold):
    """Pack (x > threshold) into uint8 bytes, 8 along the last axis, MSB
    first (ref: compare_and_bitpack.cpp)."""
    bits = (x > threshold).to(torch.int64)
    bits = bits.reshape(tuple(x.shape[:-1]) + (x.shape[-1] // 8, 8))
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int64,
                           device=x.device)
    return torch.sum(bits * weights, dim=-1).to(torch.uint8)


@op("matchConditionTransform", "math")
def match_condition_transform(x, value, condition="eq", eps=1e-5):
    """Boolean mask of elements matching the condition (ref:
    match_condition_transform.cpp)."""
    ops_map = {
        "eq": lambda: torch.abs(x - value) <= eps,
        "neq": lambda: torch.abs(x - value) > eps,
        "lt": lambda: x < value, "lte": lambda: x <= value,
        "gt": lambda: x > value, "gte": lambda: x >= value,
    }
    return ops_map[condition]()


@op("ctcGreedyDecoder", "loss")
def ctc_greedy_decoder(log_probs, sequence_lengths, blank=0,
                       merge_repeated=True):
    """Greedy (best-path) CTC decode: argmax per frame, collapse repeats,
    drop blanks (ref: ctc_beam.cpp's greedy path). Returns (B, T) ids
    padded with -1 and (B,) lengths."""
    B, T, V = log_probs.shape
    raw = torch.argmax(log_probs, dim=-1).tolist()
    lengths = torch.as_tensor(sequence_lengths).tolist()
    seq = [[-1] * T for _ in range(B)]
    lens = [0] * B
    for b in range(B):
        prev, k = -1, 0
        for t in range(int(lengths[b])):
            s = raw[b][t]
            if s != blank and not (merge_repeated and s == prev):
                seq[b][k] = s
                k += 1
            prev = s
        lens[b] = k
    dev = log_probs.device
    return (torch.tensor(seq, dtype=torch.int64, device=dev),
            torch.tensor(lens, dtype=torch.int64, device=dev))


@op("logPoissonLoss", "loss")
def log_poisson_loss(targets, log_input, compute_full_loss=False):
    """(ref: log_poisson_loss.cpp): exp(log_input) - targets*log_input
    (+ Stirling when full)."""
    loss = torch.exp(log_input) - targets * log_input
    if compute_full_loss:
        stirling = (targets * torch.log(torch.clamp_min(targets, 1e-12))
                    - targets + 0.5 * torch.log(
                        2 * math.pi * torch.clamp_min(targets, 1.0)))
        loss = loss + torch.where(targets > 1.0, stirling, 0.0)
    return loss
