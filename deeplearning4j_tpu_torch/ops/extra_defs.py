"""Op families beyond the initial surface: segment/scatter/partition ops,
sequence ops, top-k, image colour/geometry, extended special functions,
bitwise rotation and linalg extensions (counterpart:
``deeplearning4j_tpu/ops/extra_defs.py``).

Each key computes what the reference's key computes, in the reference's
dtypes (``dtypes``' 64-bit switch as its ``jax_enable_x64``). Four of the
keys are registered twice in the reference, here and in ``math_defs.py``,
and the reference imports this file after that one, so this file's
definitions win: ``shape.dynamicPartition``, ``shape.sequenceMask``,
``math.clipByNorm`` and ``math.step``; ``math_defs.py`` leaves them to this
file.

Where the reference's op is a JAX library function, the port keeps its
algorithm: ``betainc`` is XLA's continued fraction (torch has none);
``zeta``'s derivative is JAX's series expansion and ``igamma``'s
derivative in ``a`` a series (torch has neither); the resizes use
``jax.image.resize``'s weights (``nn_defs``); ``random.poisson`` and
``random.binomial`` are JAX's loops with its key schedule over the port's
threefry (``ndarray/random.py``).

Eager-only keys (outputs whose shape depends on the data, as in the
reference): ``shape.dynamicPartition``, ``shape.dynamicStitch`` and
``math.bincount`` without ``minlength``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ndarray import dtypes as _dt
from deeplearning4j_tpu_torch.ndarray.array import (
    default_array_device as _default_device)
from deeplearning4j_tpu_torch.ndarray.array import reduce as _reduce
from deeplearning4j_tpu_torch.ndarray.array import top_k as _top_k
from deeplearning4j_tpu_torch.ops.math_defs import (
    _segment_sum as segment_sum, segment_mean)
from deeplearning4j_tpu_torch.ops.registry import op


def _rnd():
    """``ndarray/random.py``, imported when first drawn from (it imports
    ``models``, which imports this package)."""
    from deeplearning4j_tpu_torch.ndarray import random

    return random


def _float_of(v):
    """The float dtype of a value that sets a computation's dtype: a
    tensor's or a numpy value's own, canonical (ints: the default float),
    a Python number's the default float (JAX's weak types)."""
    if isinstance(v, (np.ndarray, np.generic)):
        v = torch.as_tensor(np.asarray(v))
    if isinstance(v, torch.Tensor):
        return _dt.canonical(v.dtype) if v.is_floating_point() \
            else _dt.float_()
    return _dt.float_()


# ------------------------------------------------------------------ segment


def _segment_reduce(data, ids, num, how):
    """``jax.ops.segment_prod``/``max``/``min``: ids outside [0, num)
    are dropped; an empty segment holds the reduction's identity."""
    ids = ids.to(torch.int64)
    ok = (ids >= 0) & (ids < num)
    data, ids = data[ok], ids[ok]
    shape = (num,) + tuple(data.shape[1:])
    if how == "prod":
        return data.new_ones(shape).index_reduce(0, ids, data, "prod")
    if data.is_floating_point():
        fill = -math.inf if how == "amax" else math.inf
    else:
        info = torch.iinfo(data.dtype)
        fill = info.min if how == "amax" else info.max
    return data.new_full(shape, fill).index_reduce(0, ids, data, how)


def segment_prod(data, ids, num):
    return _segment_reduce(data, ids, num, "prod")


def segment_max(data, ids, num):
    return _segment_reduce(data, ids, num, "amax")


def segment_min(data, ids, num):
    return _segment_reduce(data, ids, num, "amin")


def unsorted_segment_sqrt_n(data, ids, num):
    sums = segment_sum(data, ids, num)
    counts = segment_sum(torch.ones_like(data), ids, num)
    return sums / torch.sqrt(torch.clamp_min(counts, 1))


for _pre in ("segment", "unsortedSegment"):
    for _name, _fn in (("Sum", segment_sum), ("Prod", segment_prod),
                       ("Max", segment_max), ("Min", segment_min),
                       ("Mean", segment_mean)):
        op(_pre + _name, "math")(_fn)
op("unsortedSegmentSqrtN", "math")(unsorted_segment_sqrt_n)


# ------------------------------------------------------- partition / stitch


@op("dynamicPartition", "shape")
def dynamic_partition(x, partitions, num_partitions):
    """EAGER-ONLY (dynamic output shapes): list of num_partitions arrays."""
    return [x[partitions == i] for i in range(num_partitions)]


@op("dynamicStitch", "shape")
def dynamic_stitch(indices, data):
    """indices: list of int arrays; data: list of equally-ranked arrays.
    Later occurrences of an index win, as in the reference. EAGER-ONLY
    (the output's length is the largest index + 1)."""
    idx = torch.cat([i.reshape(-1) for i in indices]).to(torch.int64)
    flat = torch.cat([d.reshape((i.numel(),) + tuple(d.shape[i.dim():]))
                      for i, d in zip(indices, data)])
    n = int(idx.max()) + 1
    order = torch.arange(idx.numel(), device=idx.device)
    last = torch.full((n,), -1, dtype=torch.int64, device=idx.device)
    last = last.scatter_reduce(0, idx, order, "amax")
    got = flat[last.clamp_min(0)]
    keep = (last >= 0).reshape((n,) + (1,) * (flat.dim() - 1))
    return torch.where(keep, got, torch.zeros((), dtype=flat.dtype,
                                              device=flat.device))


# ------------------------------------------------------------------ scatter


def _wrap(idx, n):
    """Negative indices count from the end (JAX's normalize)."""
    idx = idx.to(torch.int64)
    return torch.where(idx < 0, idx + n, idx)


@op("scatterMul", "shape")
def scatter_mul(ref, idx, upd):
    return ref.index_reduce(0, _wrap(idx, ref.shape[0]).reshape(-1),
                            upd.reshape((-1,) + tuple(ref.shape[1:])),
                            "prod")


@op("scatterDiv", "shape")
def scatter_div(ref, idx, upd):
    den = torch.ones_like(ref).index_reduce(
        0, _wrap(idx, ref.shape[0]).reshape(-1),
        upd.reshape((-1,) + tuple(ref.shape[1:])).to(ref.dtype), "prod")
    return ref / den


def _nd_index(indices):
    return tuple(indices.to(torch.int64).unbind(-1))


@op("scatterNd", "shape")
def scatter_nd(indices, updates, shape):
    out = updates.new_zeros(tuple(int(s) for s in shape))
    return out.index_put(_nd_index(indices), updates, accumulate=True)


@op("scatterNdAdd", "shape")
def scatter_nd_add(ref, indices, updates):
    return ref.index_put(_nd_index(indices), updates.to(ref.dtype),
                         accumulate=True)


@op("scatterNdUpdate", "shape")
def scatter_nd_update(ref, indices, updates):
    return ref.index_put(_nd_index(indices), updates.to(ref.dtype))


# ------------------------------------------------------------------- top-k


@op("topK", "math")
def top_k(x, k, sorted=True):
    """(values, indices) along the last axis (ref: top_k.cpp)."""
    return _top_k(x, k)


@op("inTopK", "math")
def in_top_k(predictions, targets, k):
    """(B, C) predictions, (B,) int targets -> (B,) bool."""
    target_scores = torch.take_along_dim(
        predictions, targets.to(torch.int64)[:, None], dim=-1)
    higher = torch.sum((predictions > target_scores).to(torch.int32), dim=-1)
    return higher < k


@op("kthValue", "math")
def kth_value(x, k):
    """k-th SMALLEST along the last axis (1-based, as the reference)."""
    return torch.sort(x, dim=-1).values[..., k - 1]


# ----------------------------------------------------------- sequence ops


@op("sequenceMask", "shape")
def sequence_mask(lengths, maxlen, dtype=torch.bool):
    lengths = torch.as_tensor(lengths)
    ar = torch.arange(maxlen, device=lengths.device)
    return (ar < lengths[..., None]).to(_dt.resolve(dtype))


@op("reverseSequence", "shape")
def reverse_sequence(x, seq_lengths, seq_axis=1, batch_axis=0):
    """Reverse the first seq_lengths[b] elements of each batch row."""
    x = torch.movedim(x, (batch_axis, seq_axis), (0, 1))
    T = x.shape[1]
    ar = torch.arange(T, device=x.device)
    lens = torch.as_tensor(seq_lengths, device=x.device).to(torch.int64)
    lens = lens[:, None]
    idx = torch.where(ar[None, :] < lens, lens - 1 - ar[None, :], ar[None, :])
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(
        (x.shape[0], T) + tuple(x.shape[2:]))
    out = torch.take_along_dim(x, idx, dim=1)
    return torch.movedim(out, (0, 1), (batch_axis, seq_axis))


@op("invertPermutation", "shape")
def invert_permutation(p):
    ar = torch.arange(p.shape[0], dtype=p.dtype, device=p.device)
    return torch.zeros_like(p).index_put((p.to(torch.int64),), ar)


@op("confusionMatrix", "math")
def confusion_matrix(labels, predictions, num_classes, weights=None):
    w = torch.ones(labels.shape, dtype=torch.float32, device=labels.device) \
        if weights is None else weights
    out = w.new_zeros((num_classes, num_classes))
    return out.index_put((labels.to(torch.int64), predictions.to(torch.int64)),
                         w, accumulate=True)


@op("bincount", "math")
def bincount(x, weights=None, minlength=0):
    """``jnp.bincount``: negative values count in bin 0, values past the
    length are dropped. EAGER-ONLY without ``minlength`` (the length is
    the largest value + 1)."""
    length = minlength if minlength > 0 else int(torch.max(x)) + 1
    w = torch.ones(x.shape, dtype=_dt.int_(), device=x.device) \
        if weights is None else weights
    idx = torch.clamp_min(x.to(torch.int64), 0).reshape(-1)
    w = torch.broadcast_to(w, x.shape).reshape(-1)
    keep = idx < length
    return w.new_zeros((length,)).index_add(0, idx[keep], w[keep])


@op("histogramFixedWidth", "math")
def histogram_fixed_width(x, value_range, nbins):
    lo, hi = value_range
    scaled = (x - lo) / (hi - lo) * nbins
    idx = torch.clamp(scaled.to(torch.int32), 0, nbins - 1)
    return torch.zeros(nbins, dtype=torch.int32, device=x.device).index_add(
        0, idx.reshape(-1).to(torch.int64),
        torch.ones(idx.numel(), dtype=torch.int32, device=x.device))


# ----------------------------------------------------------- merge / clip


op("mergeAdd", "math")(lambda arrays: sum(arrays[1:], arrays[0]))
op("mergeAvg", "math")(
    lambda arrays: sum(arrays[1:], arrays[0]) / len(arrays))


@op("mergeMax", "math")
def merge_max(arrays):
    out = arrays[0]
    for a in arrays[1:]:
        out = torch.maximum(out, a)
    return out


@op("clipByNorm", "math")
def clip_by_norm(x, clip_norm, axes=None):
    n = torch.sqrt(_reduce("sum", x * x, axes, keepdims=axes is not None))
    return x * torch.clamp_max(clip_norm / torch.clamp_min(n, 1e-12), 1.0)


@op("clipByGlobalNorm", "math")
def clip_by_global_norm(arrays, clip_norm):
    g = torch.sqrt(sum(torch.sum(a * a) for a in arrays))
    scale = torch.clamp_max(clip_norm / torch.clamp_min(g, 1e-12), 1.0)
    return [a * scale for a in arrays], g


@op("clipByAvgNorm", "math")
def clip_by_avg_norm(x, clip_norm):
    n = torch.sqrt(torch.mean(x * x))
    return x * torch.clamp_max(clip_norm / torch.clamp_min(n, 1e-12), 1.0)


# ------------------------------------------------------------ moments etc.


@op("moments", "math")
def moments(x, axes=None, keepdims=False):
    mean = _reduce("mean", x, axes, keepdims=True)
    var = _reduce("mean", (x - mean) ** 2, axes, keepdims=keepdims)
    if not keepdims:
        mean = mean.squeeze() if axes is None else mean.squeeze(
            tuple(axes) if isinstance(axes, (tuple, list)) else axes)
    return mean, var


@op("normalizeMoments", "math")
def normalize_moments(counts, mean_ss, variance_ss, shift=None):
    div = torch.clamp_min(counts, 1.0)
    shift = 0.0 if shift is None else shift
    mean = mean_ss / div + shift
    variance = variance_ss / div - (mean - shift) ** 2
    return mean, variance


@op("standardize", "math")
def standardize(x, axis=-1):
    mean = torch.mean(x, dim=axis, keepdim=True)
    std = torch.std(x, dim=axis, keepdim=True, correction=0)
    return (x - mean) / torch.clamp_min(std, 1e-12)


# ------------------------------------------------------- special functions

# (2k)! / B_2k, B the Bernoulli numbers (JAX's zeta series)
_BERNOULLI_COEFS = np.array([
    12, -720, 30240, -1209600, 47900160, -1307674368000 / 691,
    74724249600, -10670622842880000 / 3617,
    5109094217170944000 / 43867, -802857662698291200000 / 174611,
    14101100039391805440000 / 77683,
    -1693824136731743669452800000 / 236364091,
    186134520519971831808000000 / 657931,
    -37893265687455865519472640000000 / 3392780147,
    759790291646040068357842010112000000 / 1723168255201,
    -134196726836183700385281186201600000000 / 7709321041217,
])


def _promote(*xs):
    """JAX's ``promote_args_inexact``: tensors to their common float
    dtype (Python numbers weak), numbers to tensors of it."""
    ts = [x for x in xs if isinstance(x, torch.Tensor)]
    dtype = ts[0].dtype if ts else _dt.float_()
    for t in ts[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    if ts and all(not isinstance(x, torch.Tensor) or not x.is_floating_point()
                  for x in xs):
        dtype = _dt.float_()
    dev = ts[0].device if ts else None
    return [x.to(dtype) if isinstance(x, torch.Tensor)
            else torch.tensor(x, dtype=dtype, device=dev) for x in xs]


def _zeta_series(s, a):
    """JAX's ``_zeta_series_expansion`` (Johansson 2015, formula (5)),
    whose derivative is the reference's derivative of ``zeta``."""
    dtype = a.dtype
    N = M = 8 if dtype == torch.float32 else 16
    s_, a_ = s[..., None], a[..., None]
    k = torch.arange(N, dtype=dtype, device=a.device)
    S = torch.sum((a_ + k) ** -s_, -1)
    I = (a + N) ** (1 - s) / (s - 1)
    T0 = (a + N) ** -s
    m = torch.arange(2 * M, dtype=dtype, device=a.device)
    T1 = torch.cumprod((s_ + m) / (a_ + N), -1)[..., ::2]
    T1 = torch.clamp_max(T1, torch.finfo(dtype).max)
    T1 = T1 / torch.as_tensor(_BERNOULLI_COEFS[:T1.shape[-1]], dtype=dtype,
                              device=a.device)
    return S + I + T0 * (0.5 + T1.sum(-1))


def zeta(x, q):
    """Hurwitz zeta: torch's value, JAX's derivative (the series')."""
    x, q = _promote(x, q)
    x, q = torch.broadcast_tensors(x, q)
    value = torch.special.zeta(x.detach(), q.detach())
    if not (x.requires_grad or q.requires_grad):
        return value
    series = _zeta_series(x, q)
    return value + (series - series.detach())


class _Betainc(torch.autograd.Function):
    """The regularized incomplete beta; the reference differentiates
    ``x`` only and raises for ``a`` and ``b``."""

    @staticmethod
    def forward(ctx, a, b, x):
        ctx.save_for_backward(a, b, x)
        return _betainc_value(a, b, x)

    @staticmethod
    def backward(ctx, g):
        a, b, x = ctx.saved_tensors
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            raise ValueError(
                "Betainc gradient with respect to a and b not supported.")
        lbeta = torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)
        dx = torch.exp((a - 1) * torch.log(x) + (b - 1) * torch.log1p(-x)
                       - lbeta)
        return None, None, g * dx


def _betainc_value(a, b, x):
    """XLA's ``RegularizedIncompleteBeta``: Lentz's continued fraction
    with the symmetry swap, in float64, cast back."""
    dtype = x.dtype
    a, b, x = (t.to(torch.float64) for t in (a, b, x))
    swap = x > (a + 1) / (a + b + 2)
    a_, b_ = torch.where(swap, b, a), torch.where(swap, a, b)
    x_ = torch.where(swap, 1 - x, x)
    tiny = 1e-30
    c = torch.ones_like(x_)
    d = 1 - (a_ + b_) * x_ / (a_ + 1)
    d = torch.where(d.abs() < tiny, torch.full_like(d, tiny), d)
    d = 1 / d
    f = d.clone()

    def lentz(num, c, d, f):
        d = 1 + num * d
        d = torch.where(d.abs() < tiny, torch.full_like(d, tiny), d)
        c = 1 + num / c
        c = torch.where(c.abs() < tiny, torch.full_like(c, tiny), c)
        d = 1 / d
        return c, d, f * c * d

    for m in range(1, 300):
        c, d, f = lentz(m * (b_ - m) * x_ / ((a_ + 2 * m - 1)
                                             * (a_ + 2 * m)), c, d, f)
        c, d, f = lentz(-(a_ + m) * (a_ + b_ + m) * x_
                        / ((a_ + 2 * m) * (a_ + 2 * m + 1)), c, d, f)
        if bool((torch.abs(c * d - 1) < 1e-15).all()):
            break
    lbeta = torch.lgamma(a_) + torch.lgamma(b_) - torch.lgamma(a_ + b_)
    front = torch.exp(a_ * torch.log(x_) + b_ * torch.log1p(-x_) - lbeta) / a_
    out = front * f
    out = torch.where(swap, 1 - out, out)
    out = torch.where(x <= 0, torch.zeros_like(out), out)
    out = torch.where(x >= 1, torch.ones_like(out), out)
    bad = (a <= 0) | (b <= 0) | (x < 0) | (x > 1) | torch.isnan(x)
    return torch.where(bad, torch.full_like(out, math.nan), out).to(dtype)


def betainc(a, b, x):
    a, b, x = torch.broadcast_tensors(*_promote(a, b, x))
    return _Betainc.apply(a, b, x)


def _igamma_grad_a(a, x):
    """d/da of the regularized lower incomplete gamma P(a, x), by its
    series e^-x sum_n x^(a+n) / G(a+n+1) (log x - psi(a+n+1)), in
    float64 (torch has no derivative in ``a``)."""
    a64, x64 = a.to(torch.float64), x.to(torch.float64)
    xm = float(x64.max()) if x64.numel() else 0.0
    n = torch.arange(int(xm + 10 * math.sqrt(max(xm, 1.0)) + 40),
                     dtype=torch.float64, device=a.device)
    an = a64[..., None] + n
    lx = torch.log(x64)[..., None]
    t = torch.exp(an * lx - x64[..., None] - torch.lgamma(an + 1))
    d = torch.sum(t * (lx - torch.special.digamma(an + 1)), -1)
    return torch.where(x64 > 0, d, torch.zeros_like(d)).to(a.dtype)


class _Igamma(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, x, upper):
        ctx.save_for_backward(a, x)
        ctx.upper = upper
        return (torch.special.gammaincc if upper
                else torch.special.gammainc)(a, x)

    @staticmethod
    def backward(ctx, g):
        a, x = ctx.saved_tensors
        sign = -1.0 if ctx.upper else 1.0
        ga = gx = None
        if ctx.needs_input_grad[0]:
            ga = g * sign * _igamma_grad_a(a, x)
        if ctx.needs_input_grad[1]:
            gx = g * sign * torch.exp(-x + (a - 1) * torch.log(x)
                                      - torch.lgamma(a))
        return ga, gx, None


def igamma(a, x):
    a, x = torch.broadcast_tensors(*_promote(a, x))
    return _Igamma.apply(a, x, False)


def igammac(a, x):
    a, x = torch.broadcast_tensors(*_promote(a, x))
    return _Igamma.apply(a, x, True)


def _logit(x):
    x = _promote(x)[0] if not isinstance(x, torch.Tensor) \
        or not x.is_floating_point() else x
    return torch.log(x / (1 - x))


for _name, _fn in {
    "digamma": lambda x: torch.special.digamma(_promote(x)[0]),
    "lgamma": lambda x: torch.lgamma(_promote(x)[0]),
    "zeta": zeta,
    "polygamma": lambda n, x: torch.special.polygamma(int(n), _promote(x)[0]),
    "betainc": betainc,
    "igamma": igamma,
    "igammac": igammac,
    "rint": torch.round,
    "trunc": torch.trunc,
    "step": lambda x: (x > 0).to(x.dtype),
    "cross": lambda a, b: torch.linalg.cross(a, b, dim=-1),
    "logit": _logit,
}.items():
    op(_name, "math")(_fn)
op("dot", "reduce")(lambda a, b: torch.sum(a * b))


# --------------------------------------------------------- abs-reductions


def _argmin_abs(x, axis=None):
    if axis is None:
        return torch.argmin(torch.abs(x).reshape(-1))
    return torch.argmin(torch.abs(x), dim=axis)


@op("entropy", "reduce")
def entropy(x, axis=None):
    return -_reduce("sum", x * torch.log(torch.clamp_min(x, 1e-12)), axis)


@op("logEntropy", "reduce")
def log_entropy(x, axis=None):
    return torch.log(entropy(x, axis=axis))


@op("cosineDistance", "reduce")
def cosine_distance(a, b, axis=None):
    num = _reduce("sum", a * b, axis)
    den = torch.sqrt(_reduce("sum", a * a, axis) * _reduce("sum", b * b, axis))
    return 1.0 - num / torch.clamp_min(den, 1e-12)


@op("jaccardDistance", "reduce")
def jaccard_distance(a, b, axis=None):
    num = _reduce("sum", torch.minimum(a, b), axis)
    den = _reduce("sum", torch.maximum(a, b), axis)
    return 1.0 - num / torch.clamp_min(den, 1e-12)


@op("firstIndex", "reduce")
def first_index(x, condition, axis=None):
    """First index where condition(x) holds; -1 if none (ref: FirstIndex)."""
    m = condition(x).to(torch.uint8)
    if axis is None:
        m = m.reshape(-1)
        axis = 0
    idx = torch.argmax(m, dim=axis)
    found = torch.any(m.bool(), dim=axis)
    return torch.where(found, idx, -1)


@op("lastIndex", "reduce")
def last_index(x, condition, axis=None):
    m = condition(x).to(torch.uint8)
    if axis is None:
        m = m.reshape(-1)
        axis = 0
    rev = torch.flip(m, dims=(axis,))
    idx = m.shape[axis] - 1 - torch.argmax(rev, dim=axis)
    return torch.where(torch.any(m.bool(), dim=axis), idx, -1)


for _name, _fn in {
    "amax": lambda x, axis=None: _reduce("max", torch.abs(x), axis),
    "amin": lambda x, axis=None: _reduce("min", torch.abs(x), axis),
    "amean": lambda x, axis=None: _reduce("mean", torch.abs(x), axis),
    "asum": lambda x, axis=None: _reduce("sum", torch.abs(x), axis),
    "iamin": _argmin_abs,
    "zeroFraction": lambda x: torch.mean((x == 0).to(torch.float32)),
}.items():
    op(_name, "reduce")(_fn)


# ----------------------------------------------------------------- creation
# no array comes in: the result lands on the default device of arrays


def _eye(n, m=None, dtype=torch.float32):
    return torch.eye(n, n if m is None else m, dtype=_dt.resolve(dtype),
                     device=_default_device())


def _linspace(start, stop, num):
    """``jnp.linspace`` (endpoint included): start * (1 - step) + stop *
    step with step = i / (num - 1), in the default float."""
    f = _dt.float_()
    dev = _default_device()
    start = torch.as_tensor(start, dtype=f, device=dev)
    stop = torch.as_tensor(stop, dtype=f, device=dev)
    if num == 1:
        return start.reshape(1)
    if num == 0:
        return torch.empty(0, dtype=f, device=dev)
    div = num - 1
    step = torch.arange(div, dtype=f, device=dev) / div
    out = start * (1 - step) + stop * step
    return torch.cat([out, stop.reshape(1)])


def _arange(start, stop=None, step=1):
    """``jnp.arange`` of Python numbers: numpy's values, in the canonical
    dtype."""
    vals = np.arange(start, stop, step) if stop is not None \
        else np.arange(start)
    return _dt.canonical_tensor(torch.as_tensor(vals)).to(_default_device())


def _fill(shape, value, dtype=None):
    t = torch.as_tensor(np.full(tuple(shape), value,
                                dtype=None if dtype is None
                                else np.dtype(dtype)))
    return _dt.canonical_tensor(t).to(_default_device())


def _tri(n, m=None, k=0):
    m = n if m is None else m
    dev = _default_device()
    r = torch.arange(n, device=dev)[:, None]
    c = torch.arange(m, device=dev)[None, :]
    return (c <= r + k).to(torch.float32)


for _name, _fn in {
    "eye": _eye,
    "linspace": _linspace,
    "arange": _arange,
    "fill": _fill,
    "meshgrid": lambda *xs, indexing="xy": list(torch.meshgrid(
        *xs, indexing=indexing)),
    "tri": _tri,
    "triu": lambda x, k=0: torch.triu(x, k),
    "tril": lambda x, k=0: torch.tril(x, k),
}.items():
    op(_name, "shape")(_fn)


# ------------------------------------------------------------------ bitwise


def _bits_of(x):
    return 8 if x.dtype == torch.bool else torch.iinfo(x.dtype).bits


def _rotate(x, shift, left):
    """A cyclic shift of each element's bits, as the reference's unsigned
    view: computed in int64 on the low ``bits`` bits and cast back."""
    _dt.refuse_uint64("bitwise.cyclicShift", x)
    bits = _bits_of(x)
    mask = (1 << bits) - 1
    u = x.to(torch.int64) & mask
    s = torch.as_tensor(shift, device=x.device).to(torch.int64) % bits
    a, b = (s, bits - s) if left else (bits - s, s)
    # a shift by the full width gives 0 (XLA's unsigned shift rule)
    hi = torch.where(a >= bits, 0, (u << a.clamp_max(63)) & mask)
    lo = torch.where(b >= bits, 0, u >> b.clamp_max(63))
    r = (hi | lo) & mask
    if x.dtype.is_signed:
        r = torch.where(r >= (1 << (bits - 1)), r - (1 << bits), r)
    return r.to(x.dtype)


op("cyclicShiftLeft", "bitwise")(lambda x, shift: _rotate(x, shift, True))
op("cyclicShiftRight", "bitwise")(lambda x, shift: _rotate(x, shift, False))


@op("toggleBits", "bitwise")
def toggle_bits(x):
    if x.dtype in _dt.WIDENED:
        mask = (1 << _bits_of(x)) - 1
        return ((~x.to(torch.int64)) & mask).to(x.dtype)
    _dt.refuse_uint64("bitwise.toggleBits", x)
    return torch.bitwise_not(x)


@op("bitCount", "bitwise")
def bit_count(x):
    """``lax.population_count``: the set bits of each element, in its
    dtype."""
    from deeplearning4j_tpu_torch.ops.math_defs import _popcount

    _dt.refuse_uint64("bitwise.bitCount", x)
    if x.dtype == torch.bool:
        return x
    return _popcount(x, _bits_of(x)).to(x.dtype)


# ------------------------------------------------------------------- linalg


def _norm(x, ord=None, axis=None, keepdims=False):
    """``jnp.linalg.norm``: the 2-norm of the flattened array by default;
    a vector norm over an int axis, a matrix norm over two axes."""
    if axis is None and ord is None:
        out = torch.sqrt(torch.sum(x * x))
        return out.reshape((1,) * x.dim()) if keepdims else out
    if axis is None:
        axis = tuple(range(x.dim()))
    if isinstance(axis, int) or len(axis) == 1:
        return torch.linalg.vector_norm(x, 2 if ord is None else ord,
                                        dim=axis, keepdim=keepdims)
    return torch.linalg.matrix_norm(x, "fro" if ord is None else ord,
                                    dim=tuple(axis), keepdim=keepdims)


def _expm(x):
    """``jax.scipy.linalg.expm``: torch's matrix exponential (a Taylor /
    scaling-and-squaring scheme; JAX's is Pade)."""
    return torch.linalg.matrix_exp(x)


def _lu(x):
    """(p, l, u) with x = p @ l @ u, as ``jax.scipy.linalg.lu``."""
    p, lo, up = torch.linalg.lu(x)
    return p, lo, up


def _triangular_solve(a, b, lower=True):
    vec = b.dim() == a.dim() - 1
    out = torch.linalg.solve_triangular(a, b.unsqueeze(-1) if vec else b,
                                        upper=not lower)
    return out.squeeze(-1) if vec else out


def _matrix_power(x, n):
    return torch.linalg.matrix_power(x, n)


for _name, _fn in {
    "pinv": lambda x: torch.linalg.pinv(x),
    "slogdet": lambda x: tuple(torch.linalg.slogdet(x)),
    "logdet": lambda x: torch.linalg.slogdet(x)[1],
    "expm": _expm,
    "kron": torch.kron,
    "lu": _lu,
    "norm": _norm,
    "matrixPower": _matrix_power,
    "triangularSolve": _triangular_solve,
    "matrixDiagPart": lambda x: torch.diagonal(x, 0, -2, -1),
}.items():
    op(_name, "linalg")(_fn)


# -------------------------------------------------------------------- image
# Layout: NHWC float, channels-last (as the image namespace).


@op("resizeBicubic", "image")
def resize_bicubic(x, size, data_format="NCHW", align_corners=False,
                   half_pixel_centers=True, cubic_coeff_a=-0.5,
                   exclude_outside=False, roi=None, extrapolation_value=0.0,
                   pytorch_half_pixel=False):
    """Cubic-convolution resize. Defaults (a=-0.5, half-pixel) are
    ``jax.image.resize``'s Keys kernel; ONNX's a=-0.75, exclude_outside,
    align_corners, asymmetric and tf_crop_and_resize coordinates take the
    separable-matrix path of ``nn_defs._tf_resize``."""
    from deeplearning4j_tpu_torch.ops.nn_defs import _tf_resize

    return _tf_resize(x, size, "cubic", data_format, align_corners,
                      half_pixel_centers, cubic_a=cubic_coeff_a,
                      exclude_outside=exclude_outside, roi=roi,
                      extrapolation_value=extrapolation_value,
                      pytorch_half_pixel=pytorch_half_pixel)


def _jax_resize(x, dims, sizes, method):
    """``jax.image.resize`` of ``x`` along ``dims`` to ``sizes`` (a dim
    whose size stays is skipped, as there)."""
    from deeplearning4j_tpu_torch.ops.nn_defs import _jax_resize_weights

    for d, n in zip(dims, sizes):
        d = d % x.dim()
        if x.shape[d] == n:
            continue
        w = torch.as_tensor(_jax_resize_weights(x.shape[d], n, method),
                            device=x.device).to(x.dtype)
        x = torch.movedim(torch.tensordot(x, w, dims=([d], [1])), -1, d)
    return x


@op("resizeArea", "image")
def resize_area(x, size, data_format="NCHW"):
    """Area resize = average pooling when downscaling by integer factors;
    otherwise linear (``jax.image.resize``), as the reference."""
    if data_format != "NCHW":
        x = torch.movedim(x, -1, 1)
    N, C, H, W = x.shape
    if H % size[0] == 0 and W % size[1] == 0:
        fh, fw = H // size[0], W // size[1]
        out = x.reshape(N, C, size[0], fh, size[1], fw).mean(dim=(3, 5))
    else:
        out = _jax_resize(x, (2, 3), size, "bilinear")
    return out if data_format == "NCHW" else torch.movedim(out, 1, -1)


@op("rgbToHsv", "image")
def rgb_to_hsv(x):
    """NHWC RGB in [0,1] -> HSV (ref: rgb_to_hsv.cpp)."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = torch.amax(x, dim=-1)
    mn = torch.amin(x, dim=-1)
    diff = mx - mn
    one = torch.ones((), dtype=x.dtype, device=x.device)
    safe = torch.where(diff == 0, one, diff)
    h = torch.where(
        mx == r, torch.remainder((g - b) / safe, 6.0),
        torch.where(mx == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0)) / 6.0
    h = torch.where(diff == 0, 0.0, h)
    s = torch.where(mx == 0, 0.0, diff / torch.where(mx == 0, one, mx))
    return torch.stack([h, s, mx], dim=-1)


@op("hsvToRgb", "image")
def hsv_to_rgb(x):
    h, s, v = x[..., 0] * 6.0, x[..., 1], x[..., 2]
    i = torch.floor(h)
    f = h - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = torch.remainder(i.to(torch.int32), 6).to(torch.int64)[None]

    def choose(*cs):
        return torch.take_along_dim(torch.stack(cs), i, dim=0)[0]

    return torch.stack([choose(v, q, p, p, t, v), choose(t, v, v, q, p, p),
                        choose(p, p, t, v, v, q)], dim=-1)


@op("adjustHue", "image")
def adjust_hue(x, delta):
    hsv = rgb_to_hsv(x)
    h = torch.remainder(hsv[..., 0] + delta, 1.0)
    return hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))


@op("adjustSaturation", "image")
def adjust_saturation(x, factor):
    hsv = rgb_to_hsv(x)
    s = torch.clamp(hsv[..., 1] * factor, 0.0, 1.0)
    return hsv_to_rgb(torch.stack([hsv[..., 0], s, hsv[..., 2]], dim=-1))


_YUV = np.array([[0.299, 0.587, 0.114],
                 [-0.14714119, -0.28886916, 0.43601035],
                 [0.61497538, -0.51496512, -0.10001026]])
_YUV_INV = np.linalg.inv(_YUV)


def _colour(x, m):
    return torch.einsum("...c,kc->...k", x,
                        torch.as_tensor(m, device=x.device).to(x.dtype))


op("rgbToYuv", "image")(lambda x: _colour(x, _YUV))
op("yuvToRgb", "image")(lambda x: _colour(x, _YUV_INV))
op("flipLeftRight", "image")(lambda x: torch.flip(x, dims=(-2,)))
op("flipUpDown", "image")(lambda x: torch.flip(x, dims=(-3,)))
op("rot90", "image")(lambda x, k=1: torch.rot90(x, k, dims=(x.dim() - 3,
                                                             x.dim() - 2)))


@op("extractImagePatches", "image")
def extract_image_patches(x, ksize, stride, data_format="NHWC"):
    """(B, H', W', kh*kw*C) patches (ref: extract_image_patches.cpp)."""
    if data_format == "NHWC":
        x = torch.movedim(x, -1, 1)
    B, C, H, W = x.shape
    kh, kw = ksize
    Ho = (H - kh) // stride[0] + 1
    Wo = (W - kw) // stride[1] + 1
    p = F.unfold(x, tuple(ksize), stride=tuple(stride))
    p = p.reshape(B, C, kh, kw, Ho, Wo)
    p = p.permute(0, 4, 5, 2, 3, 1)  # B, Ho, Wo, kh, kw, C
    return p.reshape(B, Ho, Wo, kh * kw * C)


# ---------------------------------------------------------------- cnn extras


@op("cropping1d", "cnn")
def cropping1d(x, crop):
    """(B, T, C); crop=(lo, hi)."""
    return x[:, crop[0]:x.shape[1] - crop[1]]


@op("cropping3d", "cnn")
def cropping3d(x, crop):
    """NCDHW; crop=((d0,d1),(h0,h1),(w0,w1))."""
    (d0, d1), (h0, h1), (w0, w1) = crop
    return x[:, :, d0:x.shape[2] - d1, h0:x.shape[3] - h1, w0:x.shape[4] - w1]


@op("zeroPadding1d", "cnn")
def zero_padding1d(x, pad):
    return F.pad(x, (0, 0, pad[0], pad[1]))


@op("zeroPadding3d", "cnn")
def zero_padding3d(x, pad):
    (d0, d1), (h0, h1), (w0, w1) = pad
    return F.pad(x, (w0, w1, h0, h1, d0, d1))


@op("upsampling1d", "cnn")
def upsampling1d(x, size):
    """(B, T, C) -> repeat time axis."""
    return torch.repeat_interleave(x, size, dim=1)


@op("upsampling3d", "cnn")
def upsampling3d(x, size):
    """NCDHW."""
    x = torch.repeat_interleave(x, size[0], dim=2)
    x = torch.repeat_interleave(x, size[1], dim=3)
    return torch.repeat_interleave(x, size[2], dim=4)


@op("spaceToBatch", "cnn")
def space_to_batch(x, block, pads):
    """NHWC (ref: space_to_batch.cpp)."""
    x = F.pad(x, (0, 0, pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
    B, H, W, C = x.shape
    x = x.reshape(B, H // block, block, W // block, block, C)
    x = torch.movedim(x, (2, 4), (0, 1))
    return x.reshape(B * block * block, H // block, W // block, C)


@op("batchToSpace", "cnn")
def batch_to_space(x, block, crops):
    BB, H, W, C = x.shape
    B = BB // (block * block)
    x = x.reshape(block, block, B, H, W, C)
    x = torch.movedim(x, (0, 1), (2, 4))
    x = x.reshape(B, H * block, W * block, C)
    (c00, c01), (c10, c11) = crops
    return x[:, c00:x.shape[1] - c01, c10:x.shape[2] - c11]


@op("col2im", "cnn")
def col2im(cols, out_hw, ksize, stride):
    """Inverse of im2col: (B, C*kh*kw, Ho, Wo) -> (B, C, H, W) with
    overlap-add (this registry's im2col layout)."""
    B, CKK = cols.shape[:2]
    kh, kw = ksize
    C = CKK // (kh * kw)
    H, W = out_hw
    Ho = (H - kh) // stride[0] + 1
    Wo = (W - kw) // stride[1] + 1
    cols = cols.reshape(B, C, kh, kw, Ho, Wo)
    out = cols.new_zeros((B, C, H, W))
    for i in range(kh):
        for j in range(kw):
            view = (slice(None), slice(None),
                    slice(i, i + Ho * stride[0], stride[0]),
                    slice(j, j + Wo * stride[1], stride[1]))
            out = out.index_put(
                (torch.arange(B, device=cols.device)[:, None, None, None],
                 torch.arange(C, device=cols.device)[None, :, None, None],
                 torch.arange(H, device=cols.device)[view[2]][:, None],
                 torch.arange(W, device=cols.device)[view[3]][None, :]),
                cols[:, :, i, j], accumulate=True)
    return out


# ---------------------------------------------------------------- nn extras


def _log_sigmoid(x):
    """``jax.nn.log_sigmoid``: -softplus(-x)."""
    return -torch.logaddexp(-x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def _hard_swish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def _glu(x, axis=-1):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


for _name, _fn in {
    "logSigmoid": _log_sigmoid,
    "hardSwish": _hard_swish,
    "glu": _glu,
    "crelu": lambda x: torch.cat([torch.relu(x), torch.relu(-x)], dim=-1),
}.items():
    op(_name, "nn")(_fn)


@op("layerNormNoBias", "nn")
def layer_norm_no_bias(x, gain, axis=-1, eps=1e-5):
    mean = torch.mean(x, dim=axis, keepdim=True)
    var = torch.var(x, dim=axis, keepdim=True, correction=0)
    return (x - mean) / torch.sqrt(var + eps) * gain


@op("instanceNorm", "nn")
def instance_norm(x, scale, bias, eps=1e-5):
    """Per-sample per-channel normalization over spatial dims; NC+spatial
    layout (ref: instance_norm / ONNX InstanceNormalization)."""
    axes = tuple(range(2, x.dim()))
    mean = torch.mean(x, dim=axes, keepdim=True)
    var = torch.var(x, dim=axes, keepdim=True, correction=0)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return ((x - mean) / torch.sqrt(var + eps)) * scale.reshape(shape) \
        + bias.reshape(shape)


# ------------------------------------------------------------------- random
# ``jax.random``'s draws from the same keys (ndarray/random.py); the
# default dtypes are the reference's (``float``/``int``: 64-bit under the
# switch).


def _laplace(key, shape):
    f = _dt.float_()
    eps = torch.finfo(f).eps / 2          # numpy's epsneg of a binary float
    u = _rnd().uniform(key, shape, f, -1.0 + eps, 1.0)
    return torch.sign(u) * torch.log1p(-torch.abs(u))


def _rademacher(key, shape):
    b = _rnd().bernoulli(key, 0.5, shape).to(_dt.int_())
    return 2 * b - 1


def categorical(key, logits, shape=None, axis=-1):
    """``jax.random.categorical`` (with replacement): the argmax of Gumbel
    noise plus the logits."""
    rnd = _rnd()
    axis = axis % logits.dim()
    batch = tuple(s for d, s in enumerate(logits.shape) if d != axis)
    shape = batch if shape is None else tuple(int(s) for s in shape)
    prefix = shape[:len(shape) - len(batch)]
    lshape = list(shape[len(shape) - len(batch):])
    lshape.insert(axis, logits.shape[axis])
    noise = rnd.gumbel(key, prefix + tuple(lshape), logits.dtype,
                       logits.device)
    lg = logits.reshape((1,) * len(prefix) + tuple(logits.shape))
    return torch.argmax(noise + lg, dim=axis - logits.dim())


def poisson(key, lam, shape=None):
    """``jax.random.poisson``: Knuth's product below lam 10, the
    transformed rejection above, each a loop over the whole array that
    splits the key every round, as JAX's; int (64-bit under the
    switch)."""
    rnd = _rnd()
    from deeplearning4j_tpu_torch.models.random import as_key, split

    key = as_key(key)
    dev = key.device
    lam = torch.as_tensor(lam, device=dev)
    shape = tuple(lam.shape) if shape is None else tuple(int(s) for s in shape)
    lam = torch.broadcast_to(lam, shape).to(torch.float32)
    out_dtype = _dt.int_()
    use_knuth = torch.isnan(lam) | (lam < 10)
    lam_knuth = torch.where(use_knuth, lam, 0.0)
    lam_rej = torch.where(use_knuth, 1e5, lam)
    # Knuth
    k = torch.zeros(shape, dtype=out_dtype, device=dev)
    log_prod = torch.zeros(shape, dtype=torch.float32, device=dev)
    rng = key
    while bool((log_prod > -lam_knuth).any()):
        rng, sub = split(rng, 2)
        k = torch.where(log_prod > -lam_knuth, k + 1, k)
        log_prod = log_prod + torch.log(rnd.uniform(sub, shape,
                                                    torch.float32))
    knuth = (k - 1).to(out_dtype)
    # transformed rejection (Hormann)
    log_lam = torch.log(lam_rej)
    b = 0.931 + 2.53 * torch.sqrt(lam_rej)
    a = -0.059 + 0.02483 * b
    inv_alpha = 1.1239 + 1.1328 / (b - 3.4)
    v_r = 0.9277 - 3.6224 / (b - 2)
    k_out = torch.full(shape, -1.0, dtype=torch.float32, device=dev)
    accepted = torch.zeros(shape, dtype=torch.bool, device=dev)
    rkey = key
    while not bool(accepted.all()):
        ks = split(rkey, 3)
        rkey, s0, s1 = ks[0], ks[1], ks[2]
        u = rnd.uniform(s0, shape, torch.float32) - 0.5
        v = rnd.uniform(s1, shape, torch.float32)
        us = 0.5 - torch.abs(u)
        kk = torch.floor((2 * a / us + b) * u + lam_rej + 0.43)
        s = torch.log(v * inv_alpha / (a / (us * us) + b))
        t = -lam_rej + kk * log_lam - torch.lgamma(kk + 1)
        accept1 = (us >= 0.07) & (v <= v_r)
        reject = (kk < 0) | ((us < 0.013) & (v > us))
        accept = accept1 | (~reject & (s <= t))
        k_out = torch.where(accept, kk, k_out)
        accepted = accepted | accept
    rej = k_out.to(out_dtype)
    res = torch.where(use_knuth, knuth, rej)
    return torch.where(lam == 0, torch.zeros_like(res), res)


_STIRLING_TAIL = [0.0810614667953272, 0.0413406959554092,
                  0.0276779256849983, 0.02079067210376509,
                  0.0166446911898211, 0.0138761288230707,
                  0.0118967099458917, 0.0104112652619720,
                  0.00925546218271273, 0.00833056343336287]


def _stirling_tail(k):
    vals = torch.tensor(_STIRLING_TAIL, dtype=k.dtype, device=k.device)
    use = k <= 9
    kc = torch.clamp(k, 0.0, 9.0)
    kp1sq = (kc + 1) * (kc + 1)
    approx = (1.0 / 12 - (1.0 / 360 - 1.0 / 1260 / kp1sq) / kp1sq) / (kc + 1)
    return torch.where(use, vals[torch.floor(kc).to(torch.int64)], approx)


def binomial(key, n, p, shape=None):
    """``jax.random.binomial``: geometric inversion where n q <= 10, BTRS
    rejection above, each JAX's loop and key schedule, computed in p's
    float dtype (a Python p: the default float); the samples in the
    default float."""
    rnd = _rnd()
    from deeplearning4j_tpu_torch.models.random import as_key, split

    key = as_key(key)
    dev = key.device
    dtype = _float_of(p)
    prob = torch.as_tensor(p, device=dev).to(dtype)
    count = torch.as_tensor(n, device=dev).to(dtype)
    if shape is None:
        shape = torch.broadcast_shapes(count.shape, prob.shape)
    shape = tuple(int(s) for s in shape)
    count = torch.broadcast_to(count, shape)
    prob = torch.broadcast_to(prob, shape)
    p_lt_half = prob < 0.5
    q = torch.where(p_lt_half, prob, 1.0 - prob)
    count_nan_or_neg = torch.isnan(count) | (count < 0.0)
    count_inf = torch.isinf(count)
    q_is_nan = torch.isnan(q)
    q_l_0 = q < 0.0
    q = torch.where(q_is_nan | q_l_0, torch.full_like(q, 0.01), q)
    use_inv = count_nan_or_neg | (count * q <= 10.0)
    count = torch.floor(count)
    count_inv = torch.where(use_inv, count, 0.0)
    count_btrs = torch.where(use_inv, 1e4, count)
    q_btrs = torch.where(use_inv, 0.5, q)
    # inversion: count geometric waits until they pass count
    log1mq = torch.log1p(-q)
    num_geom = torch.zeros(shape, dtype=dtype, device=dev)
    geom_sum = torch.zeros(shape, dtype=dtype, device=dev)
    k1 = key
    while bool((geom_sum <= count_inv).any()):
        ks = split(k1, 2)
        sub, k1 = ks[0], ks[1]
        num_geom = torch.where(geom_sum <= count_inv, num_geom + 1, num_geom)
        u = rnd.uniform(sub, shape, dtype)
        geom_sum = geom_sum + torch.ceil(torch.log(u) / log1mq)
    inv = num_geom - 1
    # BTRS
    cnt, pr = count_btrs, q_btrs
    stddev = torch.sqrt(cnt * pr * (1 - pr))
    b = 1.15 + 2.53 * stddev
    a = -0.0873 + 0.0248 * b + 0.01 * pr
    c = cnt * pr + 0.5
    v_r = 0.92 - 4.2 / b
    r = pr / (1 - pr)
    alpha = (2.83 + 5.1 / b) * stddev
    m = torch.floor((cnt + 1) * pr)
    k_out = torch.full(shape, -1.0, dtype=dtype, device=dev)
    accepted = torch.zeros(shape, dtype=torch.bool, device=dev)
    k2 = key
    while not bool(accepted.all()):
        ks = split(k2, 3)
        k2, s0, s1 = ks[0], ks[1], ks[2]
        u = rnd.uniform(s0, shape, dtype)
        v = rnd.uniform(s1, shape, dtype)
        u = u - 0.5
        us = 0.5 - torch.abs(u)
        accept1 = (us >= 0.07) & (v <= v_r)
        kk = torch.floor((2 * a / us + b) * u + c)
        reject = (kk < 0) | (kk > cnt)
        v = torch.log(v * alpha / (a / (us * us) + b))
        ub = ((m + 0.5) * torch.log((m + 1) / (r * (cnt - m + 1)))
              + (cnt + 1) * torch.log((cnt - m + 1) / (cnt - kk + 1))
              + (kk + 0.5) * torch.log(r * (cnt - kk + 1) / (kk + 1))
              + _stirling_tail(m) + _stirling_tail(cnt - m)
              - _stirling_tail(kk) - _stirling_tail(cnt - kk))
        accept = accept1 | (~reject & (v <= ub))
        k_out = torch.where(accept, kk, k_out)
        accepted = accepted | accept
    out = _dt.float_()
    samples = torch.where(use_inv, inv, k_out).to(out)
    invalid = q_l_0 | q_is_nan | count_nan_or_neg
    samples = torch.where(invalid, torch.full_like(samples, math.nan),
                          samples)
    samples = torch.where(count_inf & ~invalid,
                          torch.full_like(samples, math.inf), samples)
    return torch.where(p_lt_half | count_nan_or_neg | q_is_nan | count_inf,
                       samples, count.to(out) - samples)


for _name, _fn in {
    "gumbel": lambda key, shape: _rnd().gumbel(key, shape, _dt.float_()),
    "laplace": _laplace,
    "poisson": poisson,
    "binomial": binomial,
    "rademacher": _rademacher,
    "categorical": lambda key, logits, shape=None: categorical(key, logits,
                                                               shape),
}.items():
    op(_name, "random")(_fn)
