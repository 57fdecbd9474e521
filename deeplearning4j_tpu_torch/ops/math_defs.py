"""Math / reduce / shape / bitwise / linalg / random op definitions over
torch (counterpart: ``deeplearning4j_tpu/ops/math_defs.py``).

Covers the reference's legacy transform/pairwise/reduce/broadcast op
families (libnd4j include/loops + org.nd4j.linalg.api.ops.impl.{transforms,
reduce,shape,broadcast,random}) as registry entries over plain PyTorch:
the reference computes them as jnp code that XLA fuses, and such fusions
are not kernels to port.

Each entry computes what the reference's entry of the same key computes,
in the dtypes the reference gives in the same mode (``dtypes``: integer
sums in int64 with the 64-bit switch on, int32 off; numpy's rules for
integer floor division and remainder; round half to even).
``UINT16``/``UINT32`` inputs compute in int64 and come back in their
dtype; ``UINT64`` raises ``TypeError`` (``dtypes``). The
random entries draw ``jax.random``'s numbers from the same keys
(``ndarray/random.py``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from deeplearning4j_tpu_torch.ndarray import dtypes as _dt
from deeplearning4j_tpu_torch.ndarray.array import reduce as _reduce
from deeplearning4j_tpu_torch.ndarray.array import take as _take
from deeplearning4j_tpu_torch.ops.registry import op


def _rnd():
    """``ndarray/random.py``, imported when first drawn from (it imports
    ``models``, which imports this package)."""
    from deeplearning4j_tpu_torch.ndarray import random

    return random


def _pair(a, b):
    """(a, b) as tensors for a binary op that needs two: a Python scalar
    takes the dtype of the weak promotion with the other operand."""
    if not isinstance(a, torch.Tensor):
        a = torch.tensor(a, dtype=torch.result_type(b, a), device=b.device)
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(b, dtype=torch.result_type(a, b), device=a.device)
    return a, b


def _unsigned(name, fn, out="same"):
    """``fn`` on ``UINT16``/``UINT32`` tensors computed in int64, and
    ``UINT64`` refused. An integer result of unsigned inputs is cast back
    to the widest of them (``out="same"``), or to ``uint64`` for a sum or
    product (``out="sum"``, the reference's integer promotion); with
    ``out=None`` it stays as ``fn`` gives it (counts, indices)."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        ts = [a for a in list(args) + list(kwargs.values())
              if isinstance(a, torch.Tensor)]
        _dt.refuse_uint64(name, *ts)
        uns = [t.dtype for t in ts
               if t.dtype in (torch.uint8,) + _dt.WIDENED]
        if not uns:
            return fn(*args, **kwargs)

        def widen(a):
            if isinstance(a, torch.Tensor) and a.dtype in _dt.WIDENED:
                return a.to(torch.int64)
            return a

        res = fn(*map(widen, args), **{k: widen(v) for k, v in kwargs.items()})
        if out is None or not isinstance(res, torch.Tensor) \
                or res.dtype not in (torch.int64, torch.uint8):
            return res
        if out == "sum":
            return res.to(torch.uint64)
        target = max(uns, key=lambda d: torch.iinfo(d).bits)
        return (res.to(torch.int64) & ((1 << torch.iinfo(target).bits) - 1)
                ).to(target)
    return run


def _reg(name, ns, fn, out="same"):
    op(name, ns)(_unsigned(f"{ns}.{name}", fn, out))


# ----------------------------------------------------------------- transforms


def _cube(x):
    return x * x * x


for _name, _fn in {
    "abs": torch.abs, "ceil": torch.ceil, "floor": torch.floor,
    "round": torch.round, "exp": torch.exp, "expm1": torch.expm1,
    "log": torch.log, "log1p": torch.log1p, "log2": torch.log2,
    "log10": torch.log10, "sqrt": torch.sqrt, "square": torch.square,
    "cube": _cube, "reciprocal": torch.reciprocal, "neg": torch.neg,
    "sign": torch.sign, "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "asinh": torch.asinh, "acosh": torch.acosh, "atanh": torch.atanh,
    "erf": torch.erf, "erfc": torch.erfc, "rsqrt": torch.rsqrt,
    "isnan": torch.isnan, "isinf": torch.isinf, "isfinite": torch.isfinite,
}.items():
    _reg(_name, "math", _fn)


def _floor_div(a, b):
    """``jnp.floor_divide``: integers round toward -inf (numpy's rule);
    floats as CPython's float divmod, the quotient rounded."""
    a, b = _pair(a, b)
    if not (a.is_floating_point() or b.is_floating_point()):
        return torch.div(a, b, rounding_mode="floor")
    mod = torch.fmod(a, b)
    div = (a - mod) / b
    ind = (mod != 0) & (torch.sign(b) != torch.sign(mod))
    return torch.round(torch.where(ind, div - 1, div))


def _remainder(a, b):
    """``jnp.remainder``: the sign of the divisor; an integer divisor of
    0 gives 0."""
    a, b = _pair(a, b)
    if not (a.is_floating_point() or b.is_floating_point()):
        b = torch.where(b == 0, torch.ones_like(b), b)
    trunc = torch.fmod(a, b)
    plus = ((trunc < 0) != (b < 0)) & (trunc != 0)
    return torch.where(plus, trunc + b, trunc)


def _fmod(a, b):
    """``jnp.fmod``: C's remainder; an integer divisor of 0 gives 0."""
    a, b = _pair(a, b)
    if not (a.is_floating_point() or b.is_floating_point()):
        b = torch.where(b == 0, torch.ones_like(b), b)
    return torch.fmod(a, b)


def _maximum(a, b):
    return torch.maximum(*_pair(a, b))


def _minimum(a, b):
    return torch.minimum(*_pair(a, b))


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, _pair(x, lo)[1]), _pair(x, hi)[1])


_reg("identity", "math", lambda x: x)
_reg("pow", "math", lambda a, b: torch.pow(a, b))
_reg("atan2", "math", lambda a, b: torch.atan2(*_pair(a, b)))
_reg("add", "math", torch.add)
_reg("sub", "math", torch.sub)
_reg("mul", "math", torch.mul)
_reg("div", "math", torch.true_divide)
_reg("floorDiv", "math", _floor_div)
_reg("floorMod", "math", _remainder)
_reg("fmod", "math", _fmod)
_reg("max", "math", _maximum)
_reg("min", "math", _minimum)
_reg("clipByValue", "math", _clip)

_reg("squaredDifference", "math", lambda a, b: torch.square(a - b))
_reg("zerosLike", "math", torch.zeros_like)
_reg("onesLike", "math", torch.ones_like)

# comparisons (ref: SDMath eq/neq/lt/lte/gt/gte + impl.transforms.comparison)
_reg("eq", "math", torch.eq)
_reg("neq", "math", torch.ne)
_reg("lt", "math", torch.lt)
_reg("lte", "math", torch.le)
_reg("gt", "math", torch.gt)
_reg("gte", "math", torch.ge)

# ``math.clipByNorm`` and ``math.step`` are registered by extra_defs (the
# reference's later registrations win there)

_reg("logicalAnd", "math", torch.logical_and)
_reg("logicalOr", "math", torch.logical_or)
_reg("logicalNot", "math", torch.logical_not)
_reg("logicalXor", "math", torch.logical_xor)


# bitwise namespace (ref: SDBitwise)


def _popcount(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Set bits of each element's low ``bits`` bits, in int64."""
    x = x.to(torch.int64)
    halves = [x & 0xFFFFFFFF] if bits <= 32 else \
        [x & 0xFFFFFFFF, (x >> 32) & 0xFFFFFFFF]
    total = 0
    for v in halves:
        if bits < 32:
            v = v & ((1 << bits) - 1)
        v = v - ((v >> 1) & 0x55555555)
        v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
        v = (v + (v >> 4)) & 0x0F0F0F0F
        total = total + (((v * 0x01010101) & 0xFFFFFFFF) >> 24)
    return total


def _hamming_bits(a, b):
    """Total set bits of a ^ b: int64, uint64 for unsigned inputs (the
    reference's sum of ``population_count``)."""
    a, b = _pair(a, b)
    bits = 8 if a.dtype == torch.bool else torch.iinfo(a.dtype).bits
    unsigned = a.dtype in (torch.uint8,) + _dt.WIDENED
    x = torch.bitwise_xor(a.to(torch.int64) if a.dtype in _dt.WIDENED else a,
                          b.to(torch.int64) if b.dtype in _dt.WIDENED else b)
    out = _popcount(x, bits).sum()
    return out.to(torch.uint64) if unsigned else out


_reg("and_", "bitwise", torch.bitwise_and)
_reg("or_", "bitwise", torch.bitwise_or)
_reg("xor", "bitwise", torch.bitwise_xor)
_reg("leftShift", "bitwise", torch.bitwise_left_shift)
_reg("rightShift", "bitwise", torch.bitwise_right_shift)
op("bitsHammingDistance", "bitwise")(_hamming_bits)

# ------------------------------------------------------------------- reduce


def _axis(dims):
    if dims is None or dims == () or dims == []:
        return None
    if isinstance(dims, (tuple, list)):
        return tuple(dims)
    return dims


def _float_ints(x):
    """Integer inputs of a variance in the default float."""
    return x if x.is_floating_point() else x.to(_dt.float_())


def _reduce_ns(name, fn, out):
    def _r(x, dims=None, keepdims=False, _fn=fn):
        return _fn(x, _axis(dims), keepdims)
    _reg(name, "reduce", _r, out)


def _sum(x, axis=None, keepdims=False):
    return _reduce("sum", x, axis, keepdims)


def _logsumexp(x, axis=None, keepdims=False):
    dims = tuple(range(x.dim())) if axis is None else axis
    return torch.logsumexp(x, dim=dims, keepdim=keepdims)


for _name, _fn, _out in (
    ("sum", _sum, "sum"),
    ("mean", lambda x, a, k: _reduce("mean", x, a, k), None),
    ("max", lambda x, a, k: _reduce("max", x, a, k), "same"),
    ("min", lambda x, a, k: _reduce("min", x, a, k), "same"),
    ("prod", lambda x, a, k: _reduce("prod", x, a, k), "sum"),
    ("any", lambda x, a, k: _reduce("any", x, a, k), None),
    ("all", lambda x, a, k: _reduce("all", x, a, k), None),
    ("countNonZero", lambda x, a, k: _sum((x != 0).to(torch.int32), a, k),
     None),
    ("countZero", lambda x, a, k: _sum((x == 0).to(torch.int32), a, k),
     None),
    ("norm1", lambda x, a, k: _sum(torch.abs(x), a, k), "sum"),
    ("norm2", lambda x, a, k: torch.sqrt(_sum(x * x, a, k)), None),
    ("normMax", lambda x, a, k: _reduce("max", torch.abs(x), a, k), "same"),
    ("squaredNorm", lambda x, a, k: _sum(x * x, a, k), "sum"),
    ("logSumExp", _logsumexp, None),
):
    _reduce_ns(_name, _fn, _out)


def std(x, dims=None, keepdims=False, biasCorrected=True):
    return torch.std(_float_ints(x), dim=_axis(dims),
                     correction=1 if biasCorrected else 0, keepdim=keepdims)


def variance(x, dims=None, keepdims=False, biasCorrected=True):
    return torch.var(_float_ints(x), dim=_axis(dims),
                     correction=1 if biasCorrected else 0, keepdim=keepdims)


def _arg(fn, x, axis, keepdims):
    if axis is None:
        out = fn(x.reshape(-1))
        return out.reshape((1,) * x.dim()) if keepdims else out
    return fn(x, dim=axis, keepdim=keepdims)


def argmax(x, dims=None, keepdims=False):
    if isinstance(dims, (tuple, list)):
        dims = dims[0] if dims else None
    return _arg(torch.argmax, x, dims, keepdims)


def argmin(x, dims=None, keepdims=False):
    return _arg(torch.argmin, x, dims, keepdims)


def iamax(x, dims=None):
    return _arg(torch.argmax, torch.abs(x), dims, False)


def cosine_similarity(a, b, dims=None):
    ax = _axis(dims)
    num = _sum(a * b, ax)
    den = torch.sqrt(_sum(a * a, ax)) * torch.sqrt(_sum(b * b, ax))
    return num / torch.clamp_min(den, 1e-12)


def euclidean_distance(a, b, dims=None):
    d = a - b
    return torch.sqrt(_sum(d * d, _axis(dims)))


def manhattan_distance(a, b, dims=None):
    return _sum(torch.abs(a - b), _axis(dims))


def hamming_distance(a, b, dims=None):
    return _sum((a != b).to(torch.float32), _axis(dims))


def shannon_entropy(x, dims=None):
    return -_sum(x * torch.log2(torch.clamp_min(x, 1e-30)), _axis(dims))


def match_condition(x, predicate, dims=None):
    """Count of elements matching a python predicate built from torch
    comparisons."""
    return _sum(predicate(x).to(_dt.int_()), _axis(dims))


for _name, _fn in (("std", std), ("variance", variance), ("argmax", argmax),
                   ("argmin", argmin), ("iamax", iamax),
                   ("cosineSimilarity", cosine_similarity),
                   ("euclideanDistance", euclidean_distance),
                   ("manhattanDistance", manhattan_distance),
                   ("hammingDistance", hamming_distance),
                   ("shannonEntropy", shannon_entropy),
                   ("matchCondition", match_condition)):
    _reg(_name, "reduce", _fn, None)

# -------------------------------------------------------------------- shape


def _expand_dims(x, axis):
    axes = axis if isinstance(axis, (tuple, list)) else (axis,)
    out_ndim = x.dim() + len(axes)
    for a in sorted(a % out_ndim for a in axes):
        x = x.unsqueeze(a)
    return x


def _squeeze(x, axis=None):
    if axis is None:
        return x.squeeze()
    return x.squeeze(tuple(axis) if isinstance(axis, (tuple, list))
                     else axis)


def _flip(x, dims):
    return torch.flip(x, dims=tuple(dims) if isinstance(dims, (list, tuple))
                      else (dims,))


def _dynamic_slice(x, begin, size):
    """``lax.dynamic_slice``: starts clamped so the slice fits."""
    for d, (b, s) in enumerate(zip(begin, size)):
        b = min(max(int(b), 0), x.shape[d] - int(s))
        x = x.narrow(d, b, int(s))
    return x


def _strided_slice(x, slices):
    """``x[tuple(slices)]`` with numpy's negative steps (torch's basic
    slicing takes none): those dims are sliced whole, then gathered."""
    slices = list(slices) if isinstance(slices, (list, tuple)) else [slices]
    basic, gathers, out_dim = [], [], 0
    for s in slices:
        if isinstance(s, slice) and s.step is not None and s.step < 0:
            n = x.shape[len([b for b in basic if b is not None])]
            gathers.append((out_dim, list(range(*s.indices(n)))))
            basic.append(slice(None))
            out_dim += 1
        else:
            basic.append(s)
            out_dim += 0 if isinstance(s, int) else 1
    out = x[tuple(basic)]
    for d, idx in gathers:
        out = torch.index_select(out, d, torch.as_tensor(
            idx, dtype=torch.int64, device=x.device))
    return out


def reshape_ref(x, ref, dims):
    """Reshape where some target dims come from ``ref``'s shape: entries
    are ints, or "dim:i" meaning ref.shape[i]."""
    shape = tuple(
        ref.shape[int(d[4:])] if isinstance(d, str) and d.startswith("dim:")
        else int(d) for d in dims)
    return torch.reshape(x, shape)


def _cum(fn, x, axis):
    if axis is None:
        return fn(x.reshape(-1), dim=0)
    return fn(x, dim=axis)


def _pad_index(n, before, after, mode, device):
    """Source index of each padded position along one dim for numpy's
    non-constant pad modes."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return i % n
    if mode == "reflect":
        period = max(2 * (n - 1), 1)
        j = i % period
        return torch.where(j >= n, period - j, j)
    if mode == "symmetric":
        period = 2 * n
        j = i % period
        return torch.where(j >= n, period - 1 - j, j)
    raise ValueError(f"pad mode {mode!r} is not supported")


def _pad(x, paddings, mode="constant", value=0.0):
    """``jnp.pad`` for 'constant', 'edge', 'wrap', 'reflect' and
    'symmetric'."""
    pw = np.broadcast_to(np.asarray(paddings, dtype=np.int64),
                         (x.dim(), 2))
    if mode == "constant":
        flat = [int(v) for pair in pw[::-1] for v in pair]
        return torch.nn.functional.pad(x, flat, value=value)
    for d, (b, a) in enumerate(pw):
        if b or a:
            x = torch.index_select(x, d, _pad_index(x.shape[d], int(b),
                                                    int(a), mode, x.device))
    return x


def _one_hot(indices, depth, axis=-1, on=1.0, off=0.0):
    """``jax.nn.one_hot`` (in the default float) scaled to (on, off)."""
    hot = indices.unsqueeze(-1) == torch.arange(depth, device=indices.device)
    out = hot.to(_dt.float_()).movedim(-1, axis)
    return out * (on - off) + off


def _segment_sum(data, segment_ids, num_segments):
    """``jax.ops.segment_sum``: ids outside [0, num_segments) are
    dropped."""
    ids = segment_ids.to(torch.int64)
    ok = (ids >= 0) & (ids < num_segments)
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add(0, ids[ok], data[ok])


def segment_mean(data, segment_ids, num_segments):
    s = _segment_sum(data, segment_ids, num_segments)
    c = _segment_sum(torch.ones_like(data), segment_ids, num_segments)
    return s / torch.clamp_min(c, 1)


def _transpose(x, axes=None):
    return x.permute(*(reversed(range(x.dim())) if axes is None else axes))


for _name, _fn in {
    "reshape": lambda x, shape: torch.reshape(x, tuple(shape)),
    "transpose": _transpose,
    "permute": lambda x, axes: x.permute(*axes),
    "expandDims": _expand_dims,
    "squeeze": _squeeze,
    "flatten": lambda x: x.reshape(-1),
    "concat": lambda arrays, axis=0: torch.cat(list(arrays), dim=axis),
    "stack": lambda arrays, axis=0: torch.stack(list(arrays), dim=axis),
    # variadic forms for graph-mode construction (one SDVariable per input)
    "concatN": lambda *arrays, axis=0: torch.cat(arrays, dim=axis),
    "stackN": lambda *arrays, axis=0: torch.stack(arrays, dim=axis),
    "unstack": lambda x, axis=0: list(torch.unbind(x, dim=axis)),
    "tile": lambda x, reps: torch.tile(x, tuple(reps)),
    "repeat": lambda x, repeats, axis=None: torch.repeat_interleave(
        x, repeats, dim=axis),
    "reverse": _flip,
    "shapeOf": lambda x: torch.tensor(tuple(x.shape), dtype=_dt.int_(),
                                      device=x.device),
    "sizeAt": lambda x, dim: x.shape[dim],
    "rank": lambda x: x.dim(),
    "broadcastTo": lambda x, shape: torch.broadcast_to(x, tuple(shape)),
    "gather": lambda x, indices, axis=0: _take(x, indices, axis),
    "gatherNd": lambda x, indices: x[tuple(indices.to(torch.int64)
                                           .unbind(-1))],
    "scatterUpdate": lambda x, indices, updates: x.index_put(
        (indices,), updates),
    "scatterAdd": lambda x, indices, updates: x.index_put(
        (indices,), updates, accumulate=True),
    "scatterSub": lambda x, indices, updates: x.index_put(
        (indices,), -updates, accumulate=True),
    "scatterMax": lambda x, indices, updates: x.index_reduce(
        0, indices, updates, "amax"),
    "scatterMin": lambda x, indices, updates: x.index_reduce(
        0, indices, updates, "amin"),
    "slice": _dynamic_slice,
    "stridedSlice": _strided_slice,
    "splitN": lambda x, num, axis=0: tuple(torch.tensor_split(x, num,
                                                              dim=axis)),
    "reshapeRef": reshape_ref,
    "where": lambda cond, x, y: torch.where(cond.bool(), x, y),
    "cumsum": lambda x, axis=None: _cum(torch.cumsum, x, axis),
    "cumprod": lambda x, axis=None: _cum(torch.cumprod, x, axis),
    "pad": _pad,
    "diag": torch.diag,
    "diagPart": lambda x: torch.diagonal(x, 0, 0, 1),
    "oneHot": _one_hot,
    "castTo": lambda x, dtype: x.to(_dt.resolve(dtype)),
    "segmentSum": _segment_sum,
    "segmentMean": segment_mean,
}.items():
    op(_name, "shape")(_fn)

# ``shape.dynamicPartition`` and ``shape.sequenceMask`` are registered by
# extra_defs (the reference's later registrations win there)

# ------------------------------------------------------------------- linalg


def _t(x):
    return x.permute(*reversed(range(x.dim())))


def gemm(a, b, alpha=1.0, beta=0.0, transposeA=False, transposeB=False,
         c=None):
    A = _t(a) if transposeA else a
    B = _t(b) if transposeB else b
    out = alpha * torch.matmul(A, B)
    if c is not None:
        out = out + beta * c
    return out


def _tensordot(a, b, axes):
    if isinstance(axes, (list, tuple)):
        axes = tuple(list(ax) if isinstance(ax, (list, tuple)) else [ax]
                     for ax in axes)
    return torch.tensordot(a, b, dims=axes)


def _lstsq(a, b):
    vec = b.dim() == 1
    sol = torch.linalg.lstsq(a, b.unsqueeze(-1) if vec else b).solution
    return sol.squeeze(-1) if vec else sol


def _eigh(x):
    """``jnp.linalg.eigh``: the symmetrized input's eigenvalues
    (ascending) and eigenvectors."""
    out = torch.linalg.eigh((x + x.mT.conj()) / 2)
    return out.eigenvalues, out.eigenvectors


def _band_part(x, lower, upper):
    r = torch.arange(x.shape[-2], device=x.device)[:, None]
    c = torch.arange(x.shape[-1], device=x.device)[None, :]
    keep = ((r - c <= (lower if lower >= 0 else x.shape[-2]))
            & (c - r <= (upper if upper >= 0 else x.shape[-1])))
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


for _name, _fn in {
    "matmul": torch.matmul,
    "mmul": torch.matmul,
    "gemm": gemm,
    "tensorMmul": _tensordot,
    "cholesky": torch.linalg.cholesky,
    "svd": lambda x: tuple(torch.linalg.svd(x, full_matrices=True)),
    "qr": lambda x: tuple(torch.linalg.qr(x)),
    "inverse": torch.linalg.inv,
    "det": torch.linalg.det,
    "solve": torch.linalg.solve,
    "lstsq": _lstsq,
    "eig": _eigh,
    "trace": lambda x: torch.diagonal(x, 0, 0, 1).sum(-1),
    "matrixDiag": torch.diag,
    "matrixBandPart": _band_part,
}.items():
    op(_name, "linalg")(_fn)

# ------------------------------------------------------------------- random
# Key-explicit (functional) random ops: ``jax.random``'s draws from the
# same key (ndarray/random.py).


def _dropout(key, x, rate):
    keep = _rnd().bernoulli(key, 1.0 - rate, x.shape, x.device)
    return torch.where(keep, x / (1.0 - rate), 0.0)


for _name, _fn in {
    "uniform": lambda key, shape, minval=0.0, maxval=1.0,
    dtype=torch.float32: _rnd().uniform(key, shape, dtype, minval, maxval),
    "normal": lambda key, shape, mean=0.0, std=1.0, dtype=torch.float32:
        _rnd().normal(key, shape, dtype) * std + mean,
    "bernoulli": lambda key, shape, p=0.5, dtype=torch.float32:
        _rnd().bernoulli(key, p, shape).to(_dt.resolve(dtype)),
    "exponential": lambda key, shape, lam=1.0, dtype=torch.float32:
        _rnd().exponential(key, shape, dtype) / lam,
    "gamma": lambda key, shape, alpha, dtype=torch.float32:
        _rnd().gamma(key, alpha, shape, dtype),
    "shuffle": lambda key, x, axis=0: _rnd().permutation(key, x, axis),
    "dropout": _dropout,
    "truncatedNormal": lambda key, shape, mean=0.0, std=1.0,
    dtype=torch.float32: _rnd().truncated_normal(key, -2.0, 2.0, shape,
                                               dtype) * std + mean,
}.items():
    op(_name, "random")(_fn)
