"""Seeded input recipes for every op of the port's registry, shared by the
CPU parity test (``tests/test_torch_ops.py``, against the JAX package)
and the on-card check (``chip_smoke.py``'s ops phase, CUDA against the
CPU). Imports neither ``jax`` nor the JAX package.

A recipe maps a numpy ``Generator`` to the op's arguments: numpy arrays
(dtypes pinned), Python values, lists of arrays, callables and dtypes
(numpy dtypes, which both packages take). ``CASES[key]`` is a
:class:`Case`: its variants (the first is also differentiated), the
positions of the arguments to differentiate (float arrays, by default),
and any looser tolerance with why.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

# forward: |port - ref| <= RTOL |ref| + ATOL elementwise (fp32); gradients
# within GRAD_REL of the largest |grad|; integer and bool results exact
RTOL, ATOL, GRAD_REL = 1e-5, 1e-6, 1e-4


@dataclass
class Case:
    variants: List[Callable]          # rng -> (args, kwargs)
    grad: Optional[Tuple[int, ...]] = None   # None: every float array arg
    tol: Optional[Tuple[float, float]] = None   # (rtol, atol) override
    why: str = ""                     # the reason for a looser tolerance
    compare: str = "close"            # or "svd", "qr", "eig", "moments"


def f32(r, *shape, lo=None, hi=None):
    if lo is not None:
        return r.uniform(lo, hi, shape).astype(np.float32)
    return r.standard_normal(shape).astype(np.float32)


def away(r, *shape, gap=0.1):
    """Normal floats at least ``gap`` from 0 (kinks of abs, relu, sign)."""
    x = f32(r, *shape)
    return np.where(np.abs(x) < gap, np.sign(x + 1e-3) * gap + x, x
                    ).astype(np.float32)


def ints(r, lo, hi, *shape, dtype=np.int32):
    return r.integers(lo, hi, shape).astype(dtype)


KEY = np.array([0, 42], np.uint32)   # jax.random.PRNGKey(42)


def v(fn):
    """A variant: ``fn(r)`` returns the positional args, or (args, kw)."""
    def make(r):
        out = fn(r)
        if isinstance(out, tuple) and len(out) == 2 and isinstance(out[1],
                                                                   dict):
            return list(out[0]), out[1]
        return list(out), {}
    return make


def case(*variants, **kw):
    return Case([v(f) for f in variants], **kw)


CASES: Dict[str, Case] = {}

# ------------------------------------------------------------ math.*


def _unary(name, *gens, **kw):
    CASES[f"math.{name}"] = case(*gens, **kw)


for _n in ("exp", "expm1", "sin", "cos", "sinh", "cosh", "tanh", "asinh",
           "atan", "erf", "erfc", "square", "cube", "neg", "identity"):
    _unary(_n, lambda r: [f32(r, 3, 4)])
for _n in ("log", "log1p", "log2", "log10", "sqrt", "rsqrt"):
    _unary(_n, lambda r: [f32(r, 3, 4, lo=0.3, hi=3.0)])
for _n in ("asin", "acos", "atanh"):
    _unary(_n, lambda r: [f32(r, 3, 4, lo=-0.9, hi=0.9)])
_unary("acosh", lambda r: [f32(r, 3, 4, lo=1.2, hi=4.0)])
_unary("tan", lambda r: [f32(r, 3, 4, lo=-1.2, hi=1.2)])
_unary("reciprocal", lambda r: [away(r, 3, 4, gap=0.3)])
_unary("abs", lambda r: [away(r, 3, 4)], lambda r: [ints(r, -9, 9, 7)])
_unary("sign", lambda r: [away(r, 3, 4)],
       lambda r: [np.array([-2, 0, 3], np.int32)])
# exact halves: round is half to even in both
_HALVES = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 0.3, 1.7, -2.2],
                   np.float32)
for _n in ("round", "ceil", "floor"):
    _unary(_n, lambda r: [_HALVES + np.float32(0.0)])
_SPECIAL = np.array([0.0, 1.0, np.nan, np.inf, -np.inf, -2.0], np.float32)
for _n in ("isnan", "isinf", "isfinite"):
    _unary(_n, lambda r: [_SPECIAL.copy()], grad=())


def _binary(name, *variants, **kw):
    CASES[f"math.{name}"] = case(*variants, **kw)


for _n in ("add", "sub", "mul", "squaredDifference"):
    _binary(_n, lambda r: [f32(r, 3, 4), f32(r, 4)],
            lambda r: [ints(r, -50, 50, 3, 4), ints(r, -50, 50, 3, 4)],
            lambda r: [ints(r, 0, 4_000_000_000, 5, dtype=np.uint32),
                       ints(r, 0, 4_000_000_000, 5, dtype=np.uint32)])
_binary("div", lambda r: [f32(r, 3, 4), away(r, 3, 4, gap=0.5)])
_binary("pow", lambda r: [f32(r, 3, 4, lo=0.5, hi=2.0), f32(r, 3, 4)])
_binary("atan2", lambda r: [away(r, 3, 4), away(r, 3, 4)])
for _n in ("floorDiv", "floorMod", "fmod"):
    _binary(_n,
            lambda r: [f32(r, 3, 4, lo=-7, hi=7), away(r, 3, 4, gap=0.5)],
            lambda r: [ints(r, -20, 20, 12), np.array(
                [3, -3, 4, -4, 7, -7, 2, -2, 5, -5, 1, -1], np.int32)],
            lambda r: [ints(r, 0, 4_000_000_000, 5, dtype=np.uint32),
                       ints(r, 1, 100_000, 5, dtype=np.uint32)],
            grad=(0,))
for _n in ("max", "min"):
    _binary(_n, lambda r: [f32(r, 3, 4), f32(r, 3, 4)],
            lambda r: [ints(r, 0, 4_000_000_000, 6, dtype=np.uint32),
                       ints(r, 0, 4_000_000_000, 6, dtype=np.uint32)],
            lambda r: [ints(r, -9, 9, 6), 2])
CASES["math.clipByValue"] = case(lambda r: [f32(r, 3, 4), -0.7, 0.8])
for _n in ("zerosLike", "onesLike"):
    _unary(_n, lambda r: [f32(r, 3, 4)], lambda r: [ints(r, 0, 9, 5)])
for _n in ("eq", "neq", "lt", "lte", "gt", "gte"):
    _binary(_n, lambda r: [ints(r, 0, 3, 3, 4), ints(r, 0, 3, 4)],
            lambda r: [f32(r, 5), 0.0], grad=())
CASES["math.clipByNorm"] = case(
    lambda r: ([f32(r, 3, 4), 1.5], {}),
    lambda r: ([f32(r, 3, 4), 1.0], {"axes": 1}),
    lambda r: ([f32(r, 3, 4) * 0.1, 5.0], {}))
CASES["math.step"] = case(lambda r: [away(r, 3, 4)], grad=())
for _n in ("logicalAnd", "logicalOr", "logicalXor"):
    _binary(_n, lambda r: [r.random(6) > 0.5, r.random(6) > 0.5],
            lambda r: [ints(r, 0, 2, 6), ints(r, 0, 2, 6)], grad=())
_unary("logicalNot", lambda r: [r.random(6) > 0.5], grad=())

# ------------------------------------------------------------ bitwise.*
_INT_KINDS = ((np.int8, -128, 128), (np.uint8, 0, 256), (np.int32, -2**31,
              2**31), (np.uint16, 0, 2**16), (np.uint32, 0, 2**32))


def _int_variants(shift=False):
    out = []
    for dt, lo, hi in _INT_KINDS:
        bits = np.iinfo(dt).bits
        if shift:
            out.append(lambda r, dt=dt, lo=lo, hi=hi, bits=bits: [
                ints(r, lo, hi, 8, dtype=dt), ints(r, 0, bits, 8, dtype=dt)])
        else:
            out.append(lambda r, dt=dt, lo=lo, hi=hi: [
                ints(r, lo, hi, 8, dtype=dt), ints(r, lo, hi, 8, dtype=dt)])
    return out


for _n in ("and_", "or_", "xor", "bitsHammingDistance"):
    CASES[f"bitwise.{_n}"] = case(*_int_variants(), grad=())
for _n in ("leftShift", "rightShift"):
    CASES[f"bitwise.{_n}"] = case(*_int_variants(shift=True), grad=())

# ------------------------------------------------------------ reduce.*
for _n in ("sum", "mean", "max", "min", "prod", "norm1", "norm2",
           "normMax", "squaredNorm", "logSumExp"):
    CASES[f"reduce.{_n}"] = case(
        lambda r: ([f32(r, 3, 4, lo=0.5, hi=1.5)], {}),
        lambda r: ([f32(r, 2, 3, 4, lo=0.5, hi=1.5)], {"dims": [0, 2]}),
        lambda r: ([f32(r, 2, 3, 4, lo=0.5, hi=1.5)],
                   {"dims": 1, "keepdims": True}))
for _n in ("sum", "max", "min", "prod"):
    CASES[f"reduce.{_n}"].variants += [
        v(lambda r: ([ints(r, -5, 5, 3, 4)], {"dims": 1})),
        v(lambda r: ([ints(r, 0, 2**32, 3, 4, dtype=np.uint32)], {})),
        v(lambda r: ([ints(r, 0, 256, 3, 4, dtype=np.uint8)], {})),
    ]
for _n in ("any", "all"):
    CASES[f"reduce.{_n}"] = case(
        lambda r: ([r.random((3, 4)) > 0.3], {}),
        lambda r: ([r.random((3, 4)) > 0.3], {"dims": 1}), grad=())
for _n in ("countNonZero", "countZero"):
    CASES[f"reduce.{_n}"] = case(
        lambda r: ([ints(r, 0, 3, 3, 4)], {}),
        lambda r: ([ints(r, 0, 3, 3, 4).astype(np.float32)], {"dims": 0}),
        grad=())
for _n in ("std", "variance"):
    CASES[f"reduce.{_n}"] = case(
        lambda r: ([f32(r, 3, 4)], {}),
        lambda r: ([f32(r, 3, 4)], {"dims": 1, "biasCorrected": False}),
        lambda r: ([f32(r, 2, 3, 4)], {"dims": [0, 2], "keepdims": True}))
for _n in ("argmax", "argmin"):
    CASES[f"reduce.{_n}"] = case(
        lambda r: ([f32(r, 3, 4)], {}),
        lambda r: ([f32(r, 3, 4)], {"dims": 1}),
        lambda r: ([f32(r, 3, 4)], {"dims": 0, "keepdims": True}), grad=())
CASES["reduce.iamax"] = case(lambda r: ([away(r, 3, 4)], {}),
                             lambda r: ([away(r, 3, 4)], {"dims": 1}),
                             grad=())
for _n in ("cosineSimilarity", "euclideanDistance", "manhattanDistance"):
    CASES[f"reduce.{_n}"] = case(
        lambda r: ([f32(r, 3, 4), f32(r, 3, 4)], {}),
        lambda r: ([f32(r, 3, 4), f32(r, 3, 4)], {"dims": 1}))
CASES["reduce.hammingDistance"] = case(
    lambda r: ([ints(r, 0, 2, 3, 4), ints(r, 0, 2, 3, 4)], {"dims": 1}),
    grad=())
CASES["reduce.shannonEntropy"] = case(
    lambda r: ([f32(r, 3, 4, lo=0.05, hi=1.0)], {}),
    lambda r: ([f32(r, 3, 4, lo=0.05, hi=1.0)], {"dims": 1}))
CASES["reduce.matchCondition"] = case(
    lambda r: ([f32(r, 3, 4), lambda x: x > 0.2], {}),
    lambda r: ([f32(r, 3, 4), lambda x: x < 0.0], {"dims": 1}), grad=())

# ------------------------------------------------------------ shape.*
S = CASES
S["shape.reshape"] = case(lambda r: [f32(r, 3, 4), (2, 6)])
S["shape.transpose"] = case(lambda r: [f32(r, 2, 3, 4)],
                            lambda r: [f32(r, 2, 3, 4), (1, 0, 2)])
S["shape.permute"] = case(lambda r: [f32(r, 2, 3, 4), (2, 0, 1)])
S["shape.expandDims"] = case(lambda r: [f32(r, 3, 4), 1],
                             lambda r: [f32(r, 3, 4), -1],
                             lambda r: [f32(r, 3, 4), (0, 3)])
S["shape.squeeze"] = case(lambda r: [f32(r, 3, 1, 4, 1)],
                          lambda r: [f32(r, 3, 1, 4, 1), 1])
S["shape.flatten"] = case(lambda r: [f32(r, 2, 3, 4)])
S["shape.concat"] = case(lambda r: ([[f32(r, 2, 3), f32(r, 4, 3)]], {}),
                         lambda r: ([[f32(r, 2, 3), f32(r, 2, 1)]],
                                    {"axis": 1}))
S["shape.stack"] = case(lambda r: ([[f32(r, 2, 3), f32(r, 2, 3)]],
                                   {"axis": 1}))
S["shape.concatN"] = case(lambda r: ([f32(r, 2, 3), f32(r, 2, 2)],
                                     {"axis": 1}))
S["shape.stackN"] = case(lambda r: ([f32(r, 2, 3), f32(r, 2, 3)],
                                    {"axis": 0}))
S["shape.unstack"] = case(lambda r: ([f32(r, 3, 4)], {"axis": 1}))
S["shape.tile"] = case(lambda r: [f32(r, 2, 3), (2, 1)],
                       lambda r: [f32(r, 3), (2, 2)])
S["shape.repeat"] = case(lambda r: [f32(r, 2, 3), 2],
                         lambda r: ([f32(r, 2, 3), 3], {"axis": 1}))
S["shape.reverse"] = case(lambda r: [f32(r, 2, 3, 4), [0, 2]],
                          lambda r: [f32(r, 2, 3), 1])
S["shape.shapeOf"] = case(lambda r: [f32(r, 2, 3, 4)], grad=())
S["shape.sizeAt"] = case(lambda r: [f32(r, 2, 3, 4), 1], grad=())
S["shape.rank"] = case(lambda r: [f32(r, 2, 3, 4)], grad=())
S["shape.broadcastTo"] = case(lambda r: [f32(r, 1, 3), (4, 3)])
S["shape.gather"] = case(
    lambda r: [f32(r, 5, 3), np.array([4, 0, 2, 2], np.int32)],
    lambda r: ([f32(r, 3, 5), np.array([[1, 4], [0, -1]], np.int32)],
               {"axis": 1}))
S["shape.gatherNd"] = case(
    lambda r: [f32(r, 3, 4), np.array([[0, 1], [2, 3], [1, 0]], np.int32)])
S["shape.scatterUpdate"] = case(
    lambda r: [f32(r, 5, 3), np.array([4, 0], np.int32), f32(r, 2, 3)])
for _n in ("scatterAdd", "scatterSub"):
    S[f"shape.{_n}"] = case(
        lambda r: [f32(r, 5, 3), np.array([4, 0, 4], np.int32),
                   f32(r, 3, 3)])
for _n in ("scatterMax", "scatterMin"):
    S[f"shape.{_n}"] = case(
        lambda r: [f32(r, 5, 3), np.array([4, 0, 1], np.int32),
                   f32(r, 3, 3)])
S["shape.slice"] = case(lambda r: [f32(r, 4, 5), (1, 2), (2, 3)],
                        lambda r: [f32(r, 4, 5), (3, 4), (2, 2)])
S["shape.stridedSlice"] = case(
    lambda r: [f32(r, 4, 5), [slice(1, 3), slice(None, None, 2)]],
    lambda r: [f32(r, 4, 5), [1, slice(None, None, -1)]],
    lambda r: [f32(r, 4, 5, 3), [slice(None, None, -2), None,
                                 slice(1, 4), 0]])
S["shape.splitN"] = case(lambda r: ([f32(r, 4, 6), 3], {"axis": 1}))
S["shape.reshapeRef"] = case(lambda r: [f32(r, 2, 6), f32(r, 3, 5),
                                        ["dim:0", 4]], grad=(0,))
S["shape.where"] = case(lambda r: [r.random((3, 4)) > 0.5, f32(r, 3, 4),
                                   f32(r, 3, 4)])
for _n in ("cumsum", "cumprod"):
    S[f"shape.{_n}"] = case(lambda r: [f32(r, 3, 4, lo=0.5, hi=1.5)],
                            lambda r: ([f32(r, 3, 4, lo=0.5, hi=1.5)],
                                       {"axis": 1}))
S["shape.pad"] = case(
    lambda r: [f32(r, 3, 4), ((1, 2), (0, 1))],
    lambda r: ([f32(r, 3, 4), ((1, 0), (2, 2))], {"value": 2.5}),
    lambda r: ([f32(r, 3, 4), ((2, 1), (3, 2))], {"mode": "reflect"}),
    lambda r: ([f32(r, 3, 4), ((2, 1), (3, 2))], {"mode": "edge"}),
    lambda r: ([f32(r, 3, 4), ((2, 1), (3, 2))], {"mode": "symmetric"}),
    lambda r: ([f32(r, 3, 4), ((2, 1), (3, 2))], {"mode": "wrap"}))
S["shape.diag"] = case(lambda r: [f32(r, 4)], lambda r: [f32(r, 3, 3)])
S["shape.diagPart"] = case(lambda r: [f32(r, 3, 4)])
S["shape.oneHot"] = case(
    lambda r: [np.array([0, 2, 1, 3], np.int32), 4],
    lambda r: ([np.array([[0, 2], [1, 5]], np.int32), 4],
               {"axis": 0, "on": 5.0, "off": -1.0}), grad=())
S["shape.castTo"] = case(lambda r: [f32(r, 3, 4), np.float64],
                         lambda r: [f32(r, 3, 4) * 4, np.int32], grad=(0,))
S["shape.dynamicPartition"] = case(
    lambda r: [f32(r, 5, 3), np.array([0, 2, 1, 0, 2], np.int32), 3],
    grad=())
for _n in ("segmentSum", "segmentMean"):
    S[f"shape.{_n}"] = case(
        lambda r: [f32(r, 5, 3), np.array([0, 0, 2, 1, 2], np.int32), 4])
S["shape.sequenceMask"] = case(
    lambda r: [np.array([1, 3, 0], np.int32), 4],
    lambda r: ([np.array([2, 4], np.int32), 5], {"dtype": np.float32}),
    grad=())

# ------------------------------------------------------------ linalg.*


def spd(r, n):
    a = f32(r, n, n)
    return (a @ a.T + n * np.eye(n, dtype=np.float32)).astype(np.float32)


L = CASES
for _n in ("matmul", "mmul"):
    L[f"linalg.{_n}"] = case(lambda r: [f32(r, 3, 4), f32(r, 4, 5)],
                             lambda r: [f32(r, 2, 3, 4), f32(r, 4, 2)])
L["linalg.gemm"] = case(
    lambda r: ([f32(r, 3, 4), f32(r, 4, 5)], {}),
    lambda r: ([f32(r, 4, 3), f32(r, 5, 4)],
               {"alpha": 2.0, "beta": 0.5, "transposeA": True,
                "transposeB": True, "c": f32(r, 3, 5)}))
L["linalg.tensorMmul"] = case(
    lambda r: [f32(r, 2, 3, 4), f32(r, 4, 3, 5), [[1, 2], [1, 0]]],
    lambda r: [f32(r, 3, 4), f32(r, 4, 2), 1])
L["linalg.cholesky"] = case(lambda r: [spd(r, 4)])
L["linalg.svd"] = case(lambda r: [f32(r, 4, 3)], compare="svd", grad=())
L["linalg.qr"] = case(lambda r: [f32(r, 4, 3)], compare="qr")
L["linalg.inverse"] = case(lambda r: [spd(r, 4)])
L["linalg.det"] = case(lambda r: [spd(r, 3) * np.float32(0.5)])
L["linalg.solve"] = case(lambda r: [spd(r, 4), f32(r, 4, 2)])
L["linalg.lstsq"] = case(lambda r: [f32(r, 6, 3), f32(r, 6, 2)])
L["linalg.eig"] = case(lambda r: [spd(r, 4)], compare="eig")
L["linalg.trace"] = case(lambda r: [f32(r, 3, 4)])
L["linalg.matrixDiag"] = case(lambda r: [f32(r, 4)])
L["linalg.matrixBandPart"] = case(lambda r: [f32(r, 4, 5), 1, 2],
                                  lambda r: [f32(r, 4, 5), -1, 0])

# ------------------------------------------------------------ random.*
R = CASES
R["random.uniform"] = case(
    lambda r: ([KEY, (3, 5)], {}),
    lambda r: ([KEY, (40,)], {"minval": 0.3, "maxval": 0.7}),
    lambda r: ([KEY, (4, 3)], {"dtype": np.float64}), grad=())
R["random.bernoulli"] = case(
    lambda r: ([KEY, (64,)], {}),
    lambda r: ([KEY, (8, 8)], {"p": np.float32(0.2), "dtype": np.int32}),
    grad=())
R["random.shuffle"] = case(lambda r: [KEY, f32(r, 6, 3)],
                           lambda r: ([KEY, f32(r, 3, 7)], {"axis": 1}),
                           lambda r: [KEY, np.arange(40, dtype=np.int32)],
                           grad=(1,))
R["random.dropout"] = case(lambda r: [KEY, f32(r, 6, 5), 0.25], grad=(1,))
# erfinv / log1p differ between XLA and torch in the last bits: a few
# float32 ulps of values of magnitude ~1-4
_ULPS = (4e-6, 4e-6)
_ULPS_WHY = "erfinv/log1p: a few float32 ulps between XLA and torch"
R["random.normal"] = case(
    lambda r: ([KEY, (4, 50)], {}),
    lambda r: ([KEY, (30,)], {"mean": 1.5, "std": 2.0}),
    grad=(), tol=_ULPS, why=_ULPS_WHY)
R["random.exponential"] = case(
    lambda r: ([KEY, (4, 50)], {}), lambda r: ([KEY, (30,)], {"lam": 2.0}),
    grad=(), tol=_ULPS, why=_ULPS_WHY)
R["random.truncatedNormal"] = case(
    lambda r: ([KEY, (4, 50)], {}),
    lambda r: ([KEY, (30,)], {"mean": -1.0, "std": 0.5}),
    grad=(), tol=_ULPS, why=_ULPS_WHY)
R["random.gamma"] = case(
    lambda r: ([KEY, (200,), 2.5], {}),
    lambda r: ([KEY, (200,), 0.4], {}),
    lambda r: ([KEY, (8, 25), 9.0], {}),
    grad=(), tol=(2e-5, 1e-5), compare="moments",
    why="Marsaglia-Tsang over erfinv/log: a few ulps a sample; an ulp can "
        "flip an acceptance and draw a different sample, so at most 1% of "
        "samples may differ more, and the moments are held")

# ------------------------------------------------------------ nn.*
N = CASES
for _n in ("relu", "relu6", "leakyRelu", "elu", "selu", "celu", "gelu",
           "sigmoid", "softplus", "softsign", "swish", "mish",
           "rationalTanh", "rectifiedTanh", "hardTanh"):
    N[f"nn.{_n}"] = case(lambda r: [away(r, 3, 4) * 2])
N["nn.relu6"].variants.append(v(lambda r: [f32(r, 4, lo=6.2, hi=8.0)]))
N["nn.leakyRelu"].variants.append(v(lambda r: [away(r, 5), 0.2]))
N["nn.gelu"].variants.append(v(lambda r: ([away(r, 5)],
                                          {"approximate": False})))
N["nn.hardSigmoid"] = case(lambda r: [f32(r, 3, 4, lo=-2.5, hi=2.5)],
                           lambda r: [np.array([-4.0, 3.5], np.float32)])
for _n in ("softmax", "logSoftmax"):
    N[f"nn.{_n}"] = case(lambda r: [f32(r, 3, 4)],
                         lambda r: ([f32(r, 3, 4)], {"axis": 0}))
N["nn.prelu"] = case(lambda r: [away(r, 3, 4), f32(r, 4, lo=0.1, hi=0.3)])
N["nn.thresholdRelu"] = case(lambda r: [away(r, 3, 4) * 2],
                             lambda r: [away(r, 3, 4), 0.5])
N["nn.gumbelSoftmax"] = case(
    lambda r: [KEY, f32(r, 3, 4)],
    lambda r: ([KEY, f32(r, 3, 4)], {"temperature": 0.5, "axis": 0}),
    grad=(1,))
N["nn.linear"] = case(lambda r: [f32(r, 3, 4), f32(r, 4, 5), f32(r, 5)],
                      lambda r: [f32(r, 2, 3, 4), f32(r, 4, 5)])
N["nn.layerNorm"] = case(lambda r: [f32(r, 3, 8), f32(r, 8), f32(r, 8)],
                         lambda r: ([f32(r, 3, 8)], {"axis": 0}))
N["nn.batchNorm"] = case(
    lambda r: [f32(r, 2, 3, 4, 4), f32(r, 3), f32(r, 3, lo=0.5, hi=2.0),
               f32(r, 3), f32(r, 3)],
    lambda r: ([f32(r, 2, 4, 3), f32(r, 3), f32(r, 3, lo=0.5, hi=2.0)],
               {"axis": -1}))
N["nn.lrn"] = case(lambda r: [f32(r, 2, 6, 3, 3)],
                   lambda r: ([f32(r, 2, 6, 3, 3)],
                              {"depth_radius": 2, "bias": 2.0,
                               "alpha": 0.1, "beta": 0.75}))
N["nn.dotProductAttention"] = case(
    lambda r: [f32(r, 2, 3, 8, 4), f32(r, 2, 3, 8, 4), f32(r, 2, 3, 8, 4)],
    lambda r: ([f32(r, 2, 8, 4), f32(r, 2, 6, 4), f32(r, 2, 6, 4)],
               {"mask": r.random((2, 8, 6)) > 0.3, "scaled": False}))
N["nn.scaledDotProductAttentionFused"] = case(
    lambda r: [f32(r, 2, 3, 16, 8), f32(r, 2, 3, 16, 8), f32(r, 2, 3, 16, 8)],
    lambda r: ([f32(r, 1, 2, 24, 8), f32(r, 1, 2, 24, 8),
                f32(r, 1, 2, 24, 8)], {"causal": True, "scale": 0.2}),
    lambda r: ([f32(r, 1, 2, 16, 8), f32(r, 1, 2, 16, 8),
                f32(r, 1, 2, 16, 8)],
               {"mask": np.where(r.random((1, 1, 16, 16)) > 0.3, 0.0,
                                 -1e9).astype(np.float32)}),
    lambda r: ([f32(r, 2, 2, 32, 8), f32(r, 2, 2, 32, 8),
                f32(r, 2, 2, 32, 8)], {"use_kernel": True}),
    lambda r: ([f32(r, 1, 2, 64, 16), f32(r, 1, 2, 64, 16),
                f32(r, 1, 2, 64, 16)], {"use_kernel": True, "causal": True}))


def _mha(r, tq=16, tk=16):
    return [f32(r, 2, tq, 12), f32(r, 2, tk, 12)] + \
        [f32(r, 12, 12) * np.float32(0.3) for _ in range(4)] + [3]


N["nn.multiHeadDotProductAttention"] = case(
    lambda r: _mha(r),
    lambda r: (_mha(r), {"use_kernel": True}),
    lambda r: (_mha(r, 16, 8), {}),
    lambda r: (_mha(r), {"mask": (r.random((2, 16)) > 0.2).astype(
        np.float32)}),
    grad=(0, 1, 2, 3, 4, 5))
N["nn.embeddingLookup"] = case(
    lambda r: [f32(r, 10, 4), np.array([[1, 9], [0, 1]], np.int32)])

# ------------------------------------------------------------ cnn.*
CN = CASES
CN["cnn.conv2d"] = case(
    lambda r: [f32(r, 2, 3, 7, 7), f32(r, 4, 3, 3, 3), f32(r, 4)],
    lambda r: ([f32(r, 2, 3, 8, 7), f32(r, 4, 3, 3, 2)],
               {"strides": (2, 2)}),
    lambda r: ([f32(r, 2, 7, 6, 3), f32(r, 3, 3, 3, 4), f32(r, 4)],
               {"data_format": "NHWC", "strides": (2, 1)}),
    lambda r: ([f32(r, 1, 4, 6, 6), f32(r, 6, 2, 3, 3)],
               {"padding": ((1, 0), (2, 1)), "dilation": (1, 2),
                "groups": 2}),
    lambda r: ([f32(r, 1, 3, 6, 6), f32(r, 2, 3, 3, 3)],
               {"padding": "VALID"}))
CN["cnn.conv1d"] = case(
    lambda r: [f32(r, 2, 3, 9), f32(r, 4, 3, 3), f32(r, 4)],
    lambda r: ([f32(r, 2, 9, 3), f32(r, 3, 3, 4)],
               {"stride": 2, "data_format": "NWC"}),
    lambda r: ([f32(r, 2, 3, 9), f32(r, 4, 3, 2)],
               {"padding": 1, "dilation": 2}))
CN["cnn.conv3d"] = case(
    lambda r: [f32(r, 1, 2, 5, 5, 4), f32(r, 3, 2, 3, 3, 2), f32(r, 3)],
    lambda r: ([f32(r, 1, 5, 4, 5, 2), f32(r, 3, 2, 2, 2, 3)],
               {"data_format": "NDHWC", "strides": (2, 1, 2)}))
CN["cnn.deconv2d"] = case(
    lambda r: [f32(r, 2, 3, 4, 5), f32(r, 3, 4, 3, 3), f32(r, 4)],
    lambda r: ([f32(r, 1, 3, 4, 4), f32(r, 3, 2, 3, 2)],
               {"strides": (2, 2)}),
    lambda r: ([f32(r, 1, 3, 4, 4), f32(r, 3, 2, 2, 3)],
               {"strides": (2, 1), "padding": "VALID"}),
    lambda r: ([f32(r, 1, 4, 5, 3), f32(r, 3, 3, 2, 3)],
               {"strides": (2, 2), "data_format": "NHWC"}),
    lambda r: ([f32(r, 1, 3, 4, 4), f32(r, 3, 2, 3, 3)],
               {"strides": (2, 2), "padding": 1}))
CN["cnn.depthwiseConv2d"] = case(
    lambda r: [f32(r, 2, 3, 6, 6), f32(r, 6, 1, 3, 3), f32(r, 6)],
    lambda r: ([f32(r, 1, 6, 5, 3), f32(r, 3, 3, 1, 6)],
               {"data_format": "NHWC", "strides": (2, 2)}))
CN["cnn.separableConv2d"] = case(
    lambda r: [f32(r, 2, 3, 6, 6), f32(r, 6, 1, 3, 3), f32(r, 4, 6, 1, 1),
               f32(r, 4)])


def _pool_cases(spatial, cf_fmt, cl_fmt):
    shp = {1: (9,), 2: (7, 6), 3: (5, 4, 5)}[spatial]
    k2 = {1: 3, 2: (3, 2), 3: (2, 2, 3)}[spatial]
    s2 = {1: 2, 2: (2, 2), 3: (2, 1, 2)}[spatial]
    return [
        lambda r: [f32(r, 2, 3, *shp)],
        lambda r: ([f32(r, 2, 3, *shp), k2, s2, "SAME"], {}),
        lambda r: ([f32(r, 2, *shp, 3)],
                   {"kernel": k2, "strides": s2, "padding": "SAME",
                    "data_format": cl_fmt}),
        lambda r: ([f32(r, 1, 2, *shp), k2, s2, 1], {}),
    ]


for _sp, _cf, _cl in ((1, "NCW", "NWC"), (2, "NCHW", "NHWC"),
                      (3, "NCDHW", "NDHWC")):
    for _kind in ("max", "avg"):
        CN[f"cnn.{_kind}Pool{_sp}d"] = case(*_pool_cases(_sp, _cf, _cl))
# int64: the reference pads int32 with a weak int64 minimum, which its
# reduce_window refuses in 64-bit mode
CN["cnn.maxPool2d"].variants.append(v(lambda r: (
    [ints(r, -50, 50, 1, 2, 5, 5, dtype=np.int64), (2, 2), (2, 2), "SAME"],
    {})))
for _n in ("globalAvgPool", "globalMaxPool"):
    CN[f"cnn.{_n}"] = case(lambda r: [f32(r, 2, 3, 4, 5)],
                           lambda r: ([f32(r, 2, 4, 5, 3)],
                                      {"data_format": "NHWC",
                                       "keepdims": True}))
CN["cnn.upsampling2d"] = case(lambda r: [f32(r, 1, 2, 3, 3)],
                              lambda r: ([f32(r, 1, 3, 2, 2), (3, 2)],
                                         {"data_format": "NHWC"}))
CN["cnn.spaceToDepth"] = case(lambda r: [f32(r, 1, 2, 4, 6), 2],
                              lambda r: ([f32(r, 1, 4, 6, 3), 2],
                                         {"data_format": "NHWC"}))
CN["cnn.depthToSpace"] = case(lambda r: [f32(r, 1, 8, 2, 3), 2],
                              lambda r: ([f32(r, 1, 2, 3, 8), 2],
                                         {"data_format": "NHWC"}))
CN["cnn.zeroPadding2d"] = case(lambda r: [f32(r, 1, 2, 3, 3),
                                          ((1, 2), (0, 1))],
                               lambda r: ([f32(r, 1, 3, 3, 2),
                                           ((1, 0), (2, 1))],
                                          {"data_format": "NHWC"}))
CN["cnn.cropping2d"] = case(lambda r: [f32(r, 1, 2, 6, 5), ((1, 2), (0, 1))],
                            lambda r: ([f32(r, 1, 6, 5, 2), ((1, 0), (2, 1))],
                                       {"data_format": "NHWC"}))
CN["cnn.im2col"] = case(lambda r: [f32(r, 2, 3, 6, 5), (3, 2)],
                        lambda r: [f32(r, 1, 2, 6, 6), (2, 3), (2, 2)],
                        lambda r: [f32(r, 1, 2, 5, 5), (3, 3), (2, 2),
                                   "SAME"])

# ------------------------------------------------------------ rnn.*


def _lstm_w(r, i, h):
    return [f32(r, i, 4 * h) * 0.5, f32(r, h, 4 * h) * 0.5, f32(r, 4 * h)]


RN = CASES
RN["rnn.lstmCell"] = case(lambda r: [f32(r, 2, 3), f32(r, 2, 5), f32(r, 2, 5)]
                          + _lstm_w(r, 3, 5))
RN["rnn.lstmLayer"] = case(
    lambda r: [f32(r, 2, 4, 3), f32(r, 2, 5), f32(r, 2, 5)] + _lstm_w(r, 3, 5),
    lambda r: ([f32(r, 4, 2, 3), f32(r, 2, 5), f32(r, 2, 5)]
               + _lstm_w(r, 3, 5), {"time_major": True, "reverse": True}),
    lambda r: ([f32(r, 2, 4, 3), f32(r, 2, 5), f32(r, 2, 5)]
               + _lstm_w(r, 3, 5),
               {"mask": np.array([[1, 1, 0, 1], [1, 0, 0, 0]], np.float32)}),
    lambda r: ([f32(r, 2, 4, 3), f32(r, 2, 5), f32(r, 2, 5)]
               + _lstm_w(r, 3, 5),
               {"reverse": True,
                "mask": np.array([[1, 1, 1, 0], [0, 1, 1, 1]], np.float32)}))


def _gru_w(r, i, h):
    return [f32(r, i, 3 * h) * 0.5, f32(r, h, 3 * h) * 0.5, f32(r, 3 * h),
            f32(r, 3 * h)]


RN["rnn.gruCell"] = case(lambda r: [f32(r, 2, 3), f32(r, 2, 5)]
                         + _gru_w(r, 3, 5))
RN["rnn.gru"] = case(
    lambda r: [f32(r, 2, 4, 3), f32(r, 2, 5)] + _gru_w(r, 3, 5),
    lambda r: ([f32(r, 4, 2, 3), f32(r, 2, 5)] + _gru_w(r, 3, 5),
               {"time_major": True}))
RN["rnn.simpleRnn"] = case(
    lambda r: [f32(r, 2, 4, 3), f32(r, 2, 5), f32(r, 3, 5) * 0.5,
               f32(r, 5, 5) * 0.5, f32(r, 5)],
    lambda r: ([f32(r, 4, 2, 3), f32(r, 2, 5), f32(r, 3, 5) * 0.5,
                f32(r, 5, 5) * 0.5, f32(r, 5)], {"time_major": True}))

# ------------------------------------------------------------ loss.*
LS = CASES


def _lp(r):
    return [f32(r, 4, 5), f32(r, 4, 5)]


def _probs(r, *shape):
    p = f32(r, *shape, lo=0.1, hi=1.0)
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


for _n in ("mse", "mae", "l1", "l2", "hinge", "squaredHinge", "logCosh"):
    LS[f"loss.{_n}"] = case(
        lambda r: _lp(r),
        lambda r: (_lp(r), {"weights": f32(r, 4, lo=0.5, hi=1.5),
                            "average": False}))
LS["loss.huber"] = case(lambda r: _lp(r),
                        lambda r: (_lp(r), {"delta": 0.5,
                                            "weights": f32(r, 4, lo=0.5,
                                                           hi=1.5)}))
LS["loss.mape"] = case(lambda r: [away(r, 4, 5, gap=0.3), f32(r, 4, 5)])
LS["loss.msle"] = case(lambda r: [f32(r, 4, 5, lo=0.1, hi=3),
                                  f32(r, 4, 5, lo=0.1, hi=3)])
LS["loss.poisson"] = case(lambda r: [f32(r, 4, 5, lo=0, hi=3),
                                     f32(r, 4, 5, lo=0.1, hi=3)])
LS["loss.kld"] = case(lambda r: [_probs(r, 4, 5), _probs(r, 4, 5)])
LS["loss.cosineProximity"] = case(lambda r: _lp(r))
LS["loss.mcxent"] = case(
    lambda r: [np.eye(5, dtype=np.float32)[[0, 3, 1, 4]], _probs(r, 4, 5)],
    lambda r: ([np.eye(5, dtype=np.float32)[[0, 3, 1, 4]], f32(r, 4, 5)],
               {"from_logits": True, "label_smoothing": 0.1}), grad=(1,))
LS["loss.sparseMcxent"] = case(
    lambda r: [np.array([0, 3, 1, 4], np.int32), f32(r, 4, 5)],
    lambda r: ([np.array([[0, 3], [1, 4]], np.int32), f32(r, 2, 2, 5)],
               {"weights": f32(r, 2, 2, lo=0.5, hi=1.5), "average": False}))
LS["loss.binaryXent"] = case(
    lambda r: [(r.random((4, 5)) > 0.5).astype(np.float32),
               f32(r, 4, 5, lo=0.05, hi=0.95)],
    lambda r: ([(r.random((4, 5)) > 0.5).astype(np.float32), f32(r, 4, 5)],
               {"from_logits": True}), grad=(1,))
LS["loss.sparseMcxentWithMask"] = case(
    lambda r: [np.array([[0, 3, 2], [1, 4, 4]], np.int32), f32(r, 2, 3, 5),
               np.array([[1, 0, 1], [1, 1, 0]], np.float32)],
    lambda r: ([np.array([[0, 3, 2]], np.int32), f32(r, 1, 3, 5),
                np.array([[1, 0, 1]], np.float32)], {"average": False}),
    grad=(1,))

# ------------------------------------------------------------ image.*
IM = CASES
IM["image.resizeBilinear"] = case(
    lambda r: [f32(r, 1, 2, 4, 5), (6, 7)],
    lambda r: [f32(r, 1, 2, 8, 9), (3, 5)],
    lambda r: ([f32(r, 1, 4, 5, 2), (7, 3)], {"data_format": "NHWC"}),
    lambda r: ([f32(r, 1, 2, 4, 5), (6, 7)], {"align_corners": True}),
    lambda r: ([f32(r, 1, 2, 4, 5), (6, 7)], {"half_pixel_centers": False}),
    lambda r: ([f32(r, 1, 2, 4, 5), (6, 7)],
               {"roi": ((0.1, 1.2), (-0.2, 0.8)),
                "extrapolation_value": 3.0}))
IM["image.resizeNearest"] = case(
    lambda r: [f32(r, 1, 2, 4, 5), (6, 7)],
    lambda r: [f32(r, 1, 2, 8, 9), (3, 5)],
    lambda r: ([f32(r, 1, 4, 5, 2), (7, 3)], {"data_format": "NHWC"}),
    lambda r: ([f32(r, 1, 2, 4, 5), (6, 7)], {"align_corners": True}),
    lambda r: ([f32(r, 1, 2, 4, 5), (6, 7)],
               {"half_pixel_centers": False,
                "nearest_mode": "round_prefer_floor"}))
IM["image.cropAndResize"] = case(
    lambda r: [f32(r, 2, 6, 7, 3),
               np.array([[0.1, 0.2, 0.8, 0.9], [0.0, 0.0, 1.0, 1.0],
                         [0.5, 0.1, 0.2, 0.7]], np.float32),
               np.array([1, 0, 1], np.int32), (4, 5)], grad=(0,))
IM["image.adjustContrast"] = case(lambda r: [f32(r, 2, 4, 5, 3), 1.7])
IM["image.rgbToGrayscale"] = case(lambda r: [f32(r, 2, 4, 5, 3)])
IM["image.nonMaxSuppression"] = case(
    lambda r: [np.array([[0, 0, 1, 1], [0, 0.1, 1, 1.1], [0, -0.1, 1, 0.9],
                         [0, 10, 1, 11], [0, 10.1, 1, 11.1],
                         [0, 100, 1, 101]], np.float32),
               np.array([0.9, 0.75, 0.6, 0.95, 0.5, 0.3], np.float32), 4],
    lambda r: ([np.array([[0, 0, 1, 1], [0, 0.1, 1, 1.1], [0, 10, 1, 11]],
                         np.float32),
                np.array([0.9, 0.8, 0.2], np.float32), 3],
               {"iou_threshold": 0.4, "score_threshold": 0.5}), grad=())

# ================================================ the second half of the
# registry: the reference's extra_defs.py, more_defs.py and wide_defs.py

# ------------------------------------------------------ extra: segments
_IDS = np.array([0, 0, 2, 1, 2, 3], np.int32)          # every segment
_IDS_GAP = np.array([3, 0, 3, 1, 0, 3], np.int32)      # segment 2 empty
for _pre in ("segment", "unsortedSegment"):
    for _n in ("Sum", "Prod", "Max", "Min", "Mean"):
        CASES[f"math.{_pre}{_n}"] = case(
            lambda r: [f32(r, 6, 3), _IDS, 4],
            lambda r: [f32(r, 6, 3), _IDS_GAP, 4],
            lambda r: [ints(r, -9, 9, 6), _IDS_GAP, 5],
            # the reference's product is a scatter_mul, which jax.grad
            # differentiates only over unique indices
            grad=() if _n == "Prod" else None)
CASES["math.unsortedSegmentSqrtN"] = case(
    lambda r: [f32(r, 6, 3), _IDS, 4], lambda r: [f32(r, 6, 3), _IDS_GAP, 5])

# ------------------------------------------------ extra: shape / scatter
S["shape.dynamicStitch"] = case(
    lambda r: [[np.array([0, 3], np.int32), np.array([[1, 2], [3, 5]],
                                                      np.int32)],
               [f32(r, 2, 3), f32(r, 2, 2, 3)]], grad=())
for _n in ("scatterMul", "scatterDiv"):
    S[f"shape.{_n}"] = case(
        lambda r: [f32(r, 5, 3), np.array([4, 0, 4], np.int32),
                   f32(r, 3, 3, lo=0.5, hi=2.0)],
        lambda r: [f32(r, 5), np.array([1, -1], np.int32),
                   f32(r, 2, lo=0.5, hi=2.0)], grad=(0,))
S["shape.scatterNd"] = case(
    lambda r: [np.array([[0, 1], [2, 2], [0, 1]], np.int32), f32(r, 3),
               (3, 4)],
    lambda r: [np.array([[1], [0]], np.int32), f32(r, 2, 4), (3, 4)])
S["shape.scatterNdAdd"] = case(
    lambda r: [f32(r, 3, 4), np.array([[0, 1], [2, 2], [0, 1]], np.int32),
               f32(r, 3)])
S["shape.scatterNdUpdate"] = case(
    lambda r: [f32(r, 3, 4), np.array([[0, 1], [2, 2]], np.int32),
               f32(r, 2)],
    lambda r: [f32(r, 3, 4), np.array([[2], [0]], np.int32), f32(r, 2, 4)])
S["shape.reverseSequence"] = case(
    lambda r: [f32(r, 3, 5, 2), np.array([2, 5, 0], np.int32)],
    lambda r: ([f32(r, 4, 3), np.array([1, 3, 4], np.int32)],
               {"seq_axis": 0, "batch_axis": 1}))
S["shape.invertPermutation"] = case(
    lambda r: [np.array([3, 0, 4, 1, 2], np.int32)], grad=())
S["shape.eye"] = case(lambda r: [3], lambda r: ([3, 4], {}),
                      lambda r: ([2], {"dtype": np.int32}))
S["shape.linspace"] = case(lambda r: [0.0, 1.0, 7], lambda r: [-2, 3.5, 4],
                           lambda r: [1.0, 2.0, 1])
S["shape.arange"] = case(lambda r: [5], lambda r: [1, 9, 3],
                         lambda r: [0.5, 3.0, 0.5])
S["shape.fill"] = case(lambda r: [(2, 3), 1.5], lambda r: [(4,), 7],
                       lambda r: [(2, 2), 3, np.float32])
S["shape.meshgrid"] = case(
    lambda r: [f32(r, 3), f32(r, 4)],
    lambda r: ([f32(r, 3), f32(r, 2)], {"indexing": "ij"}))
S["shape.tri"] = case(lambda r: [3], lambda r: [3, 4, 1],
                      lambda r: [4, 3, -1])
for _n in ("triu", "tril"):
    S[f"shape.{_n}"] = case(lambda r: [f32(r, 4, 5)],
                            lambda r: [f32(r, 2, 4, 4), 1],
                            lambda r: [f32(r, 4, 3), -1])

# -------------------------------------------------- extra: top-k and co
CASES["math.topK"] = case(lambda r: [f32(r, 3, 6), 2],
                          lambda r: [f32(r, 7), 4])
CASES["math.inTopK"] = case(
    lambda r: [f32(r, 4, 6), np.array([0, 5, 2, 3], np.int32), 2], grad=())
CASES["math.kthValue"] = case(lambda r: [f32(r, 3, 6), 2],
                              lambda r: [f32(r, 5), 5])
CASES["math.confusionMatrix"] = case(
    lambda r: [np.array([0, 2, 1, 2, 0], np.int32),
               np.array([0, 1, 1, 2, 2], np.int32), 3],
    lambda r: ([np.array([0, 2, 1, 2, 0], np.int32),
                np.array([0, 1, 1, 2, 2], np.int32), 4],
               {"weights": f32(r, 5, lo=0.5, hi=2.0)}))
CASES["math.bincount"] = case(
    lambda r: [np.array([0, 3, 1, 3, 3, 5], np.int32)],
    lambda r: ([np.array([0, 3, -1, 3, 7], np.int32)],
               {"weights": f32(r, 5), "minlength": 6}), grad=())
CASES["math.histogramFixedWidth"] = case(
    lambda r: [f32(r, 20) * 3, (-2.0, 2.0), 5],
    lambda r: [f32(r, 4, 5, lo=0.0, hi=1.0), (0.0, 1.0), 4], grad=())
for _n in ("mergeAdd", "mergeAvg", "mergeMax"):
    CASES[f"math.{_n}"] = case(lambda r: [[f32(r, 3, 4), f32(r, 3, 4),
                                           f32(r, 3, 4)]])
CASES["math.clipByGlobalNorm"] = case(
    lambda r: [[f32(r, 3, 4), f32(r, 5)], 1.5],
    lambda r: [[f32(r, 3, 4) * 0.05, f32(r, 5) * 0.05], 5.0])
CASES["math.clipByAvgNorm"] = case(lambda r: [f32(r, 3, 4), 0.5],
                                   lambda r: [f32(r, 3, 4) * 0.1, 5.0])
CASES["math.moments"] = case(
    lambda r: ([f32(r, 3, 4)], {}),
    lambda r: ([f32(r, 2, 3, 4)], {"axes": (0, 2)}),
    lambda r: ([f32(r, 2, 3, 4)], {"axes": 1, "keepdims": True}))
CASES["math.normalizeMoments"] = case(
    lambda r: [f32(r, 3, lo=1.0, hi=5.0), f32(r, 3), f32(r, 3, lo=4, hi=9)],
    lambda r: [f32(r, 3, lo=1.0, hi=5.0), f32(r, 3), f32(r, 3, lo=4, hi=9),
               f32(r, 3)])
CASES["math.standardize"] = case(lambda r: [f32(r, 3, 5)],
                                 lambda r: [f32(r, 3, 5), 0])

# ------------------------------------------------ extra: special functions
CASES["math.digamma"] = case(lambda r: [f32(r, 3, 4, lo=0.3, hi=6.0)])
CASES["math.lgamma"] = case(lambda r: [f32(r, 3, 4, lo=0.3, hi=6.0)])
CASES["math.zeta"] = case(
    lambda r: [f32(r, 3, 4, lo=1.5, hi=5.0), f32(r, 3, 4, lo=0.5, hi=3.0)])
CASES["math.polygamma"] = case(lambda r: [1, f32(r, 3, 4, lo=0.5, hi=5.0)],
                               lambda r: [2, f32(r, 6, lo=0.5, hi=5.0)])
CASES["math.betainc"] = case(
    lambda r: [f32(r, 3, 4, lo=0.5, hi=4.0), f32(r, 3, 4, lo=0.5, hi=4.0),
               f32(r, 3, 4, lo=0.05, hi=0.95)], grad=(2,))
for _n in ("igamma", "igammac"):
    CASES[f"math.{_n}"] = case(
        lambda r: [f32(r, 3, 4, lo=0.5, hi=4.0),
                   f32(r, 3, 4, lo=0.2, hi=5.0)])
for _n in ("rint", "trunc"):
    CASES[f"math.{_n}"] = case(lambda r: [_HALVES + np.float32(0.0)],
                               lambda r: [f32(r, 3, 4) * 3])
CASES["math.cross"] = case(lambda r: [f32(r, 4, 3), f32(r, 4, 3)])
CASES["math.logit"] = case(lambda r: [f32(r, 3, 4, lo=0.05, hi=0.95)])
CASES["reduce.dot"] = case(lambda r: [f32(r, 3, 4), f32(r, 3, 4)])

# -------------------------------------------------- extra: abs-reductions
for _n in ("amax", "amin", "amean", "asum"):
    CASES[f"reduce.{_n}"] = case(lambda r: [away(r, 3, 4)],
                                 lambda r: [away(r, 3, 4), 1],
                                 lambda r: [away(r, 2, 3, 4), (0, 2)])
CASES["reduce.iamin"] = case(lambda r: [away(r, 3, 4)],
                             lambda r: [away(r, 3, 4), 0], grad=())
CASES["reduce.zeroFraction"] = case(
    lambda r: [np.where(r.random((3, 4)) > 0.5, f32(r, 3, 4), 0
                        ).astype(np.float32)], grad=())
for _n in ("entropy", "logEntropy"):
    CASES[f"reduce.{_n}"] = case(lambda r: [_probs(r, 3, 4)],
                                 lambda r: [_probs(r, 3, 4), 1])
for _n in ("cosineDistance", "jaccardDistance"):
    CASES[f"reduce.{_n}"] = case(
        lambda r: [f32(r, 3, 4, lo=0.1, hi=2.0), f32(r, 3, 4, lo=0.1, hi=2.0)],
        lambda r: [f32(r, 3, 4, lo=0.1, hi=2.0), f32(r, 3, 4, lo=0.1, hi=2.0),
                   1])
for _n in ("firstIndex", "lastIndex"):
    CASES[f"reduce.{_n}"] = case(
        lambda r: [f32(r, 3, 5), lambda x: x > 0.5],
        lambda r: [f32(r, 3, 5), lambda x: x > 0.5, 1],
        lambda r: [f32(r, 3, 5), lambda x: x > 9.0, 0], grad=())

# ------------------------------------------------- extra: bitwise
for _n in ("cyclicShiftLeft", "cyclicShiftRight"):
    CASES[f"bitwise.{_n}"] = case(
        *[(lambda r, dt=dt, lo=lo, hi=hi: [ints(r, lo, hi, 8, dtype=dt),
                                           int(r.integers(0, 40))])
          for dt, lo, hi in _INT_KINDS],
        lambda r: [ints(r, -2**31, 2**31, 6), 0],
        lambda r: [ints(r, 0, 256, 6, dtype=np.uint8), -3], grad=())
for _n in ("toggleBits", "bitCount"):
    CASES[f"bitwise.{_n}"] = case(
        *[(lambda r, dt=dt, lo=lo, hi=hi: [ints(r, lo, hi, 8, dtype=dt)])
          for dt, lo, hi in _INT_KINDS], grad=())

# --------------------------------------------------- extra: linalg
L["linalg.pinv"] = case(lambda r: [f32(r, 4, 3)], lambda r: [f32(r, 3, 5)])
L["linalg.slogdet"] = case(lambda r: [f32(r, 4, 4)],
                           lambda r: [spd(r, 3)])
L["linalg.logdet"] = case(lambda r: [spd(r, 4)])
# JAX's Pade against torch's own scaling and squaring: within the
# default tolerance (1.7e-6 relative at most here)
L["linalg.expm"] = case(lambda r: [f32(r, 4, 4) * 0.5],
                        lambda r: [f32(r, 3, 3) * 2.0])
L["linalg.kron"] = case(lambda r: [f32(r, 2, 3), f32(r, 3, 2)])
L["linalg.lu"] = case(lambda r: [f32(r, 4, 4)], lambda r: [f32(r, 5, 5)])
L["linalg.norm"] = case(
    lambda r: ([f32(r, 3, 4)], {}),
    lambda r: ([f32(r, 3, 4)], {"axis": 1}),
    lambda r: ([f32(r, 3, 4)], {"ord": 1, "axis": 0}),
    lambda r: ([f32(r, 2, 3, 4)], {"axis": (1, 2)}))
L["linalg.matrixPower"] = case(lambda r: [f32(r, 3, 3), 3],
                               lambda r: [spd(r, 3) * np.float32(0.1), -2])
L["linalg.triangularSolve"] = case(
    lambda r: [np.tril(spd(r, 4)).astype(np.float32), f32(r, 4, 2)],
    lambda r: ([np.triu(spd(r, 4)).astype(np.float32), f32(r, 4, 3)],
               {"lower": False}), grad=(1,))
L["linalg.matrixDiagPart"] = case(lambda r: [f32(r, 3, 4)],
                                  lambda r: [f32(r, 2, 3, 3)])

# ---------------------------------------------------- extra: image
IM["image.resizeBicubic"] = case(
    lambda r: [f32(r, 1, 2, 4, 5), (6, 7)],
    lambda r: [f32(r, 1, 2, 8, 9), (3, 5)],
    lambda r: ([f32(r, 1, 4, 5, 2), (7, 3)], {"data_format": "NHWC"}),
    lambda r: ([f32(r, 1, 2, 4, 5), (6, 7)], {"cubic_coeff_a": -0.75}),
    lambda r: ([f32(r, 1, 2, 4, 5), (6, 7)],
               {"cubic_coeff_a": -0.75, "exclude_outside": True}),
    lambda r: ([f32(r, 1, 2, 4, 5), (6, 7)], {"align_corners": True}))
IM["image.resizeArea"] = case(
    lambda r: [f32(r, 1, 2, 8, 6), (4, 3)],
    lambda r: [f32(r, 1, 2, 5, 6), (3, 4)],
    lambda r: ([f32(r, 1, 6, 4, 2), (3, 2)], {"data_format": "NHWC"}))


def _rgb(r, *shape):
    return f32(r, *shape, 3, lo=0.02, hi=0.98)


for _n in ("rgbToHsv", "rgbToYuv", "yuvToRgb", "flipLeftRight",
           "flipUpDown"):
    IM[f"image.{_n}"] = case(lambda r: [_rgb(r, 2, 4, 5)])
IM["image.hsvToRgb"] = case(
    lambda r: [np.stack([f32(r, 2, 4, 5, lo=0.01, hi=0.99),
                         f32(r, 2, 4, 5, lo=0.05, hi=0.95),
                         f32(r, 2, 4, 5, lo=0.05, hi=0.95)], -1)])
IM["image.adjustHue"] = case(lambda r: [_rgb(r, 2, 4, 5), 0.2],
                             lambda r: [_rgb(r, 2, 4, 5), -0.35])
IM["image.adjustSaturation"] = case(lambda r: [_rgb(r, 2, 4, 5), 0.5],
                                    lambda r: [_rgb(r, 2, 4, 5), 1.7])
IM["image.rot90"] = case(lambda r: [f32(r, 2, 4, 5, 3)],
                         lambda r: [f32(r, 2, 4, 5, 3), 2],
                         lambda r: [f32(r, 4, 5, 3), -1])
IM["image.extractImagePatches"] = case(
    lambda r: [f32(r, 2, 6, 5, 3), (2, 3), (2, 1)],
    lambda r: ([f32(r, 1, 3, 6, 6), (3, 3), (3, 2)],
               {"data_format": "NCHW"}))

# ------------------------------------------------------ extra: cnn
CN["cnn.cropping1d"] = case(lambda r: [f32(r, 2, 7, 3), (1, 2)])
CN["cnn.cropping3d"] = case(
    lambda r: [f32(r, 1, 2, 5, 6, 4), ((1, 0), (2, 1), (0, 1))])
CN["cnn.zeroPadding1d"] = case(lambda r: [f32(r, 2, 4, 3), (1, 2)])
CN["cnn.zeroPadding3d"] = case(
    lambda r: [f32(r, 1, 2, 3, 2, 2), ((1, 0), (2, 1), (0, 1))])
CN["cnn.upsampling1d"] = case(lambda r: [f32(r, 2, 3, 4), 2])
CN["cnn.upsampling3d"] = case(lambda r: [f32(r, 1, 2, 2, 3, 2), (2, 1, 3)])
CN["cnn.spaceToBatch"] = case(
    lambda r: [f32(r, 2, 4, 6, 3), 2, ((0, 0), (0, 0))],
    lambda r: [f32(r, 1, 3, 5, 2), 2, ((1, 0), (0, 1))])
CN["cnn.batchToSpace"] = case(
    lambda r: [f32(r, 8, 2, 3, 3), 2, ((0, 0), (0, 0))],
    lambda r: [f32(r, 4, 2, 3, 2), 2, ((1, 0), (0, 1))])
CN["cnn.col2im"] = case(
    lambda r: [f32(r, 2, 12, 3, 4), (4, 5), (2, 2), (1, 1)],
    lambda r: [f32(r, 1, 18, 2, 2), (6, 6), (3, 3), (2, 2)])

# ------------------------------------------------------- extra: nn
for _n in ("logSigmoid", "crelu"):
    N[f"nn.{_n}"] = case(lambda r: [away(r, 3, 4) * 2])
N["nn.hardSwish"] = case(lambda r: [f32(r, 3, 4, lo=-2.8, hi=2.8)],
                         lambda r: [np.array([-5.0, 4.0, 0.5], np.float32)])
N["nn.glu"] = case(lambda r: [f32(r, 3, 4)],
                   lambda r: ([f32(r, 4, 3)], {"axis": 0}))
N["nn.layerNormNoBias"] = case(lambda r: [f32(r, 3, 8), f32(r, 8)],
                               lambda r: ([f32(r, 3, 8), f32(r, 3, 1)],
                                          {"axis": 0}))
N["nn.instanceNorm"] = case(
    lambda r: [f32(r, 2, 3, 4, 5), f32(r, 3), f32(r, 3)],
    lambda r: [f32(r, 2, 3, 6), f32(r, 3), f32(r, 3)])

# ----------------------------------------------------- extra: random
R["random.gumbel"] = case(lambda r: [KEY, (4, 50)], lambda r: [KEY, (30,)],
                          grad=(), tol=_ULPS, why=_ULPS_WHY)
R["random.laplace"] = case(lambda r: [KEY, (4, 50)], lambda r: [KEY, (30,)],
                           grad=(), tol=_ULPS, why=_ULPS_WHY)
R["random.rademacher"] = case(lambda r: [KEY, (64,)],
                              lambda r: [KEY, (8, 8)], grad=())
R["random.categorical"] = case(
    lambda r: [KEY, f32(r, 6, 5)],
    lambda r: ([KEY, f32(r, 4)], {"shape": (200,)}),
    lambda r: ([KEY, f32(r, 3, 5)], {"shape": (7, 3)}), grad=())
# JAX's loops and key schedule: every sample equal to the reference's on
# the CPU (Knuth and the transformed rejection, inversion and BTRS)
R["random.poisson"] = case(
    lambda r: [KEY, 3.5, (400,)],
    lambda r: [KEY, 25.0, (400,)],
    lambda r: [KEY, f32(r, 20, lo=0.0, hi=30.0), (10, 20)], grad=())
R["random.binomial"] = case(
    lambda r: [KEY, 12.0, 0.3, (400,)],
    lambda r: [KEY, 200.0, 0.35, (400,)],
    lambda r: [KEY, 60.0, np.float32(0.8), (400,)],
    lambda r: [KEY, f32(r, 20, lo=1.0, hi=90.0),
               f32(r, 20, lo=0.05, hi=0.95), (5, 20)], grad=())
# the draws that loop until a sample is accepted: on the card against the
# CPU, a few ulps of log/lgamma between the devices can flip an
# acceptance and draw another sample, so there (chip_smoke.py's ops (d))
# they take gamma's rule: at most 1% of samples differ, the mean and
# variance held
REJECTION_DRAWS = {"random.gamma", "random.poisson", "random.binomial"}

# ======================================================= more_defs


def _sru_p(r, h):
    return [f32(r, h), f32(r, h), f32(r, h), f32(r, h)]


RN["rnn.sruCell"] = case(lambda r: [f32(r, 2, 12), f32(r, 2, 4)]
                         + _sru_p(r, 4))
RN["rnn.sru"] = case(
    lambda r: [f32(r, 2, 5, 4), f32(r, 4, 12) * 0.5] + _sru_p(r, 4),
    lambda r: ([f32(r, 2, 5, 4), f32(r, 4, 12) * 0.5] + _sru_p(r, 4),
               {"c0": f32(r, 2, 4), "reverse": True}))
RN["rnn.sruBi"] = case(
    lambda r: [f32(r, 2, 5, 4), f32(r, 4, 12) * 0.5, f32(r, 4, 12) * 0.5,
               tuple(_sru_p(r, 4)), tuple(_sru_p(r, 4))])
S["shape.roll"] = case(lambda r: [f32(r, 3, 4), 2],
                       lambda r: [f32(r, 3, 4), -1, 1],
                       lambda r: [f32(r, 3, 4), (1, 2), (0, 1)])
S["shape.unique"] = case(lambda r: [ints(r, 0, 5, 3, 4)],
                         lambda r: [np.array([2.5, -1.0, 2.5, 0.0],
                                             np.float32)], grad=())
S["shape.uniqueWithCounts"] = case(lambda r: [ints(r, 0, 5, 3, 4)], grad=())
S["shape.listDiff"] = case(
    lambda r: [np.array([1, 2, 3, 4, 2, 6], np.int32),
               np.array([2, 6, 9], np.int32)], grad=())
S["shape.searchsorted"] = case(
    lambda r: [np.sort(f32(r, 8)), f32(r, 5)],
    lambda r: ([np.array([1, 2, 2, 3], np.int32),
                np.array([2, 0, 5], np.int32)], {"side": "right"}), grad=())
CASES["reduce.percentile"] = case(
    lambda r: [f32(r, 3, 5), 30.0],
    lambda r: ([f32(r, 3, 5), 75.0], {"axis": 1}),
    lambda r: ([f32(r, 2, 3, 4), 50.0], {"axis": (0, 2), "keepdims": True}))
CASES["reduce.median"] = case(
    lambda r: [f32(r, 3, 4)], lambda r: ([f32(r, 3, 4)], {"axis": 0}),
    lambda r: ([f32(r, 3, 5)], {"axis": 1, "keepdims": True}))
for _n in ("rsub", "rdiv"):
    CASES[f"math.{_n}"] = case(lambda r: [away(r, 3, 4, gap=0.5),
                                          f32(r, 3, 4)],
                               lambda r: [away(r, 3, 4, gap=0.5), 2.0])
CASES["math.mod"] = case(
    lambda r: [f32(r, 3, 4, lo=-7, hi=7), away(r, 3, 4, gap=0.5)],
    lambda r: [ints(r, -20, 20, 8), np.array([3, -3, 4, -4, 7, -7, 2, -2],
                                             np.int32)], grad=(0,))
CASES["math.hypot"] = case(lambda r: [away(r, 3, 4), away(r, 3, 4)])
CASES["math.xlogy"] = case(
    lambda r: [np.where(r.random((3, 4)) > 0.3, f32(r, 3, 4), 0
                        ).astype(np.float32), f32(r, 3, 4, lo=0.2, hi=3.0)])
CASES["math.erfinv"] = case(lambda r: [f32(r, 3, 4, lo=-0.9, hi=0.9)])
CASES["math.sinc"] = case(lambda r: [away(r, 3, 4, gap=0.2) * 2])
CASES["math.isMax"] = case(lambda r: [f32(r, 3, 4)],
                           lambda r: [f32(r, 3, 4), 1], grad=())
CASES["math.thresholdEncode"] = case(
    lambda r: [f32(r, 4, 5) * 0.01, 0.004],
    lambda r: [f32(r, 4, 5) * 0.01, np.float32(0.01)])
CASES["math.thresholdDecode"] = case(lambda r: [f32(r, 4, 5)])
CN["cnn.dilation2d"] = case(
    lambda r: [f32(r, 2, 3, 6, 5), f32(r, 3, 2, 3)],
    lambda r: ([f32(r, 1, 2, 7, 7), f32(r, 2, 3, 2)],
               {"strides": (2, 1), "rates": (1, 2), "padding": "VALID"}),
    lambda r: ([f32(r, 1, 2, 6, 6), f32(r, 2, 2, 2)],
               {"strides": (2, 2), "rates": (2, 1)}))
CN["cnn.maxPoolWithArgmax"] = case(
    lambda r: [f32(r, 2, 3, 6, 5)],
    lambda r: ([f32(r, 1, 2, 7, 5), (3, 2), (2, 2), "SAME"], {}),
    lambda r: ([f32(r, 1, 2, 6, 6)], {"kernel": (3, 3),
                                      "strides": (1, 2)}))
IM["image.randomCrop"] = case(lambda r: [KEY, f32(r, 2, 3, 8, 9), (4, 5)],
                              lambda r: [KEY, f32(r, 7, 6, 3), (3, 2, 3)])
IM["image.imageResize"] = case(
    lambda r: [f32(r, 1, 2, 4, 5), (6, 7)],
    lambda r: [f32(r, 2, 8, 9), (3, 5), "bicubic"],
    lambda r: [f32(r, 1, 2, 4, 5), (7, 3), "nearest"],
    lambda r: [f32(r, 2, 6, 6), (4, 9), "lanczos3"],
    lambda r: [f32(r, 1, 2, 8, 6), (4, 3), "area"],
    lambda r: [f32(r, 1, 2, 5, 6), (3, 4), "area"])

# ======================================================= wide_defs

# ------------------------------------------------------- updaters
U = CASES


def _g(r, *shape):
    return f32(r, *shape) * 0.1


def _pos(r, *shape):
    return f32(r, *shape, lo=0.01, hi=0.5)


_T = np.array(3, np.int32)
U["updaters.sgdUpdater"] = case(lambda r: [_g(r, 3, 4)],
                                lambda r: [_g(r, 5), 0.01])
U["updaters.nesterovsUpdater"] = case(
    lambda r: [_g(r, 3, 4), _g(r, 3, 4)],
    lambda r: ([_g(r, 5), _g(r, 5)], {"lr": 0.02, "momentum": 0.5}))
U["updaters.adaGradUpdater"] = case(lambda r: [_g(r, 3, 4), _pos(r, 3, 4)])
U["updaters.rmsPropUpdater"] = case(
    lambda r: [_g(r, 3, 4), _pos(r, 3, 4)],
    lambda r: ([_g(r, 5), _pos(r, 5)], {"decay": 0.9}))
U["updaters.adaDeltaUpdater"] = case(
    lambda r: [_g(r, 3, 4), _pos(r, 3, 4), _pos(r, 3, 4)])
for _n in ("adamUpdater", "adaMaxUpdater", "nadamUpdater",
           "adaBeliefUpdater"):
    U[f"updaters.{_n}"] = case(
        lambda r: [_g(r, 3, 4), _g(r, 3, 4), _pos(r, 3, 4), _T],
        lambda r: ([_g(r, 5), _g(r, 5), _pos(r, 5), 0],
                   {"lr": 0.01, "beta1": 0.8}))
U["updaters.amsGradUpdater"] = case(
    lambda r: [_g(r, 3, 4), _g(r, 3, 4), _pos(r, 3, 4), _pos(r, 3, 4), _T],
    lambda r: ([_g(r, 5), _g(r, 5), _pos(r, 5), _pos(r, 5), 7],
               {"beta2": 0.99}))

# --------------------------------------------- wide: checks and math
CASES["math.isNonDecreasing"] = case(
    lambda r: [np.sort(f32(r, 6))], lambda r: [np.array([1, 2, 2, 3])],
    lambda r: [f32(r, 6)], grad=())
CASES["math.isStrictlyIncreasing"] = case(
    lambda r: [np.sort(f32(r, 6))], lambda r: [np.array([1, 2, 2, 3])],
    grad=())
CASES["math.isNumericTensor"] = case(
    lambda r: [f32(r, 3)], lambda r: [np.array([True, False])], grad=())
CASES["math.stopGradient"] = case(lambda r: [f32(r, 3, 4)])
CASES["math.assign"] = case(lambda r: [f32(r, 3, 4), f32(r, 4)],
                            lambda r: [ints(r, 0, 9, 3, 2), 2.7])
CASES["math.axpy"] = case(lambda r: [f32(r, 3, 4), f32(r, 3, 4)],
                          lambda r: ([f32(r, 3, 4), f32(r, 4)],
                                     {"alpha": -0.5}))
CASES["math.divideNoNan"] = case(
    lambda r: [f32(r, 6), np.array([0, 1.5, -2, 0, 0.5, 3], np.float32)])
CASES["math.realDiv"] = case(lambda r: [f32(r, 3, 4),
                                        away(r, 3, 4, gap=0.5)])
CASES["math.truncateDiv"] = case(
    lambda r: [f32(r, 3, 4) * 5, away(r, 3, 4, gap=0.5)],
    lambda r: [ints(r, -20, 20, 8), np.array([3, -3, 4, -4, 7, -7, 2, -2],
                                             np.int32)], grad=(0,))
for _n in ("cummax", "cummin"):
    CASES[f"math.{_n}"] = case(lambda r: [f32(r, 3, 5)],
                               lambda r: [f32(r, 3, 5), 0],
                               lambda r: [ints(r, -9, 9, 7)])
CASES["math.trigamma"] = case(lambda r: [f32(r, 3, 4, lo=0.3, hi=5.0)])
CASES["math.nextafter"] = case(lambda r: [f32(r, 3, 4), f32(r, 3, 4)],
                               grad=())
CASES["math.checkNumerics"] = case(lambda r: [f32(r, 3, 4)], grad=())
CASES["math.nthElement"] = case(lambda r: [f32(r, 3, 6), 2],
                                lambda r: [f32(r, 3, 6), 0, True])
CASES["math.sufficientStatistics"] = case(
    lambda r: [f32(r, 3, 4), (0,)],
    lambda r: [f32(r, 2, 3, 4), (0, 2), f32(r, 3, 1)])
CASES["math.histogram"] = case(lambda r: [f32(r, 30)],
                               lambda r: [f32(r, 4, 5), 4], grad=())
CASES["math.tsneGains"] = case(
    lambda r: [f32(r, 5, 2, lo=0.5, hi=2.0), away(r, 5, 2), away(r, 5, 2)],
    lambda r: [f32(r, 5, 2, lo=0.001, hi=0.3), away(r, 5, 2),
               away(r, 5, 2), 0.1])
CASES["math.tsneSymmetrized"] = case(
    lambda r: [f32(r, 5, 5, lo=0.0, hi=1.0)])
CASES["math.tsneEdgeForces"] = case(
    lambda r: [f32(r, 6, 2), f32(r, 6, 6, lo=0.0, hi=0.2)])
CASES["math.tsneCellContains"] = case(
    lambda r: [np.zeros(2, np.float32), np.ones(2, np.float32),
               f32(r, 6, 2, lo=-0.5, hi=1.5)], grad=())
CASES["math.encodeBitmap"] = case(lambda r: [f32(r, 4, 5), 0.5],
                                  lambda r: [f32(r, 7) * 0.01, 0.004])
CASES["math.decodeBitmap"] = case(
    lambda r: [ints(r, -1, 2, 4, 5, dtype=np.int8), 0.25],
    lambda r: ([ints(r, -1, 2, 6, dtype=np.int8), 0.5],
               {"dtype": np.float64}))
CASES["math.bitcast"] = case(
    lambda r: [f32(r, 3, 4), np.int32],
    lambda r: [f32(r, 2, 3), np.uint8],
    lambda r: [ints(r, 0, 256, 3, 4, dtype=np.uint8), np.int32],
    lambda r: [ints(r, -2**31, 2**31, 5), np.uint32], grad=())
CASES["math.assertOp"] = case(lambda r: [np.array([True, True])],
                              lambda r: [np.array(1, np.int32), "fails"],
                              grad=())
CASES["math.fakeQuantWithMinMaxVars"] = case(
    lambda r: [f32(r, 3, 4) * 2, -1.5, 1.2],
    lambda r: ([f32(r, 3, 4) * 2, -0.3, 2.9],
               {"num_bits": 4, "narrow_range": True}))
CASES["math.fakeQuantWithMinMaxVarsPerChannel"] = case(
    lambda r: [f32(r, 4, 3) * 2, np.array([-1.0, -0.5, -2.0], np.float32),
               np.array([1.0, 2.5, 0.3], np.float32)], grad=(0,))
CASES["math.knnMindistance"] = case(
    lambda r: [f32(r, 5, 3) * 2, -np.ones(3, np.float32),
               np.array([1.0, 0.5, 2.0], np.float32)], grad=(0,))
CASES["math.hashCode"] = case(
    lambda r: [f32(r, 3, 4)], lambda r: [ints(r, -9, 9, 7)],
    lambda r: [np.arange(300, dtype=np.uint8)],
    lambda r: [np.array([True, False, True])], grad=())
CASES["math.compareAndBitpack"] = case(
    lambda r: [f32(r, 3, 16), 0.2], lambda r: [f32(r, 8), -0.5], grad=())
CASES["math.matchConditionTransform"] = case(
    *[(lambda r, c=c: [np.round(f32(r, 3, 4), 1), 0.3, c])
      for c in ("eq", "neq", "lt", "lte", "gt", "gte")], grad=())

# ---------------------------------------------- wide: nn, shape, linalg
N["nn.biasAdd"] = case(lambda r: [f32(r, 2, 5, 3), f32(r, 3)],
                       lambda r: [f32(r, 2, 3, 4, 4), f32(r, 3), "NCHW"])
N["nn.shrink"] = case(lambda r: [away(r, 3, 4) * 2],
                      lambda r: ([away(r, 3, 4) * 2],
                                 {"bias": 0.3, "lambd": 0.8}))
N["nn.meanVarianceNormalization"] = case(
    lambda r: [f32(r, 2, 3, 4, 4)],
    lambda r: ([f32(r, 2, 3, 5)], {"axes": (2,)}))
S["shape.mirrorPad"] = case(
    lambda r: [f32(r, 4, 5), ((1, 2), (2, 1))],
    lambda r: [f32(r, 4, 5), ((1, 2), (2, 1)), "SYMMETRIC"])
S["shape.broadcastShape"] = case(lambda r: [(2, 1, 4), (3, 1)], grad=())
S["shape.select"] = case(lambda r: [r.random((3, 4)) > 0.5, f32(r, 3, 4),
                                    f32(r, 3, 4)])
S["shape.sparseToDense"] = case(
    lambda r: [np.array([[0, 1], [2, 3]], np.int32), (3, 4), f32(r, 2)],
    lambda r: [np.array([4, 1], np.int32), (6,), f32(r, 2), -1.0])
S["shape.splitV"] = case(lambda r: [f32(r, 6, 3), [1, 3, 2]],
                         lambda r: [f32(r, 2, 5), [4, 1], 1])
S["shape.intersection"] = case(
    lambda r: [np.array([3, 1, 2, 2, 7], np.int32),
               np.array([2, 3, 5, 7], np.int32)], grad=())
S["shape.gatherElements"] = case(
    lambda r: [f32(r, 3, 4), ints(r, 0, 3, 2, 4)],
    lambda r: [f32(r, 3, 4), ints(r, 0, 4, 3, 2), 1])
S["shape.scatterElements"] = case(
    lambda r: [f32(r, 3, 4), np.array([[1, 0, 2, 1]], np.int32),
               f32(r, 1, 4)],
    *[(lambda r, red=red: ([f32(r, 3, 4),
                            np.array([[1, 0], [2, 2], [0, 0]], np.int32),
                            f32(r, 3, 2)], {"axis": 1, "reduction": red}))
      for red in ("add", "mul", "max", "min")])
S["shape.eyeLike"] = case(lambda r: [f32(r, 3, 4)],
                          lambda r: ([f32(r, 4, 3)], {"k": 1}),
                          lambda r: ([f32(r, 3, 3)], {"k": -1,
                                                      "dtype": np.int32}),
                          grad=())
S["shape.whereNonzero"] = case(lambda r: [ints(r, 0, 3, 3, 4)],
                               lambda r: [r.random(6) > 0.5], grad=())
L["linalg.matrixSetDiag"] = case(lambda r: [f32(r, 3, 4), f32(r, 3)],
                                 lambda r: [f32(r, 2, 4, 3), f32(r, 2, 3)])
L["linalg.einsum"] = case(
    lambda r: ([f32(r, 3, 4), f32(r, 4, 5)], {"equation": "ij,jk->ik"}),
    lambda r: ([f32(r, 2, 3, 4)], {"equation": "bij->bji"}),
    lambda r: ([f32(r, 2, 3), f32(r, 2, 3), f32(r, 3)],
               {"equation": "bi,bi,i->b"}))

# ------------------------------------------------------ wide: cnn
CN["cnn.spaceToBatchNd"] = case(
    lambda r: [f32(r, 2, 4, 6, 3), (2, 3), ((0, 0), (0, 0))],
    lambda r: [f32(r, 1, 3, 5, 2), (2, 2), ((1, 0), (0, 1))],
    lambda r: [f32(r, 2, 5, 2), (3,), ((1, 0),)])
CN["cnn.batchToSpaceNd"] = case(
    lambda r: [f32(r, 12, 2, 2, 3), (2, 3), ((0, 0), (0, 0))],
    lambda r: [f32(r, 4, 2, 3, 2), (2, 2), ((1, 0), (0, 1))])
CN["cnn.deconv3d"] = case(
    lambda r: [f32(r, 1, 2, 3, 3, 2), f32(r, 2, 2, 2, 3, 2)],
    lambda r: ([f32(r, 1, 2, 2, 3, 2), f32(r, 2, 3, 2, 2, 2)],
               {"strides": (2, 1, 2)}),
    lambda r: ([f32(r, 1, 2, 3, 2, 2), f32(r, 3, 2, 2, 2, 2)],
               {"strides": (1, 2, 2), "padding": "SAME"}))
# no gradient: jax.grad cannot linearize the reference's generic
# reduce_window (an add with an init value)
CN["cnn.pnormPool2d"] = case(
    lambda r: [f32(r, 2, 3, 6, 5)],
    lambda r: ([f32(r, 1, 2, 7, 5)], {"window": (3, 2), "strides": (2, 2),
                                      "padding": "SAME", "p": 3.0}),
    grad=())

# ------------------------------------------------------ wide: rnn


def _rnn_w(r, i, h):
    return [f32(r, i, h) * 0.5, f32(r, h, h) * 0.5, f32(r, h)]


RN["rnn.lstmBlockCell"] = case(
    lambda r: [f32(r, 2, 3), f32(r, 2, 4), f32(r, 2, 4), f32(r, 7, 16) * 0.5,
               f32(r, 16)],
    lambda r: ([f32(r, 2, 3), f32(r, 2, 4), f32(r, 2, 4),
                f32(r, 7, 16) * 0.5, f32(r, 16)], {"forget_bias": 0.0}))
RN["rnn.lstmBlock"] = case(
    lambda r: [f32(r, 5, 2, 3), f32(r, 2, 4), f32(r, 2, 4),
               f32(r, 7, 16) * 0.5, f32(r, 16)],
    lambda r: ([f32(r, 2, 5, 3), f32(r, 2, 4), f32(r, 2, 4),
                f32(r, 7, 16) * 0.5, f32(r, 16)], {"time_major": False}))
RN["rnn.dynamicRnn"] = case(
    lambda r: [f32(r, 3, 5, 2), f32(r, 3, 4)] + _rnn_w(r, 2, 4),
    lambda r: ([f32(r, 3, 5, 2), f32(r, 3, 4)] + _rnn_w(r, 2, 4),
               {"seq_lengths": np.array([5, 2, 0], np.int32)}),
    lambda r: ([f32(r, 5, 3, 2), f32(r, 3, 4)] + _rnn_w(r, 2, 4),
               {"time_major": True}))
RN["rnn.staticRnn"] = case(
    lambda r: [f32(r, 3, 5, 2), f32(r, 3, 4)] + _rnn_w(r, 2, 4))
RN["rnn.dynamicBidirectionalRnn"] = case(
    lambda r: [f32(r, 3, 5, 2), f32(r, 3, 4), f32(r, 3, 4)]
    + _rnn_w(r, 2, 4) + _rnn_w(r, 2, 4),
    lambda r: ([f32(r, 3, 5, 2), f32(r, 3, 4), f32(r, 3, 4)]
               + _rnn_w(r, 2, 4) + _rnn_w(r, 2, 4),
               {"seq_lengths": np.array([5, 3, 1], np.int32)}),
    lambda r: ([f32(r, 5, 3, 2), f32(r, 3, 4), f32(r, 3, 4)]
               + _rnn_w(r, 2, 4) + _rnn_w(r, 2, 4),
               {"seq_lengths": np.array([2, 5, 4], np.int32),
                "time_major": True}))


def _onnx(r, gates, d=1, i=3, h=4):
    return [f32(r, 5, 2, i), f32(r, d, gates * h, i) * 0.5,
            f32(r, d, gates * h, h) * 0.5]


_LENS = np.array([5, 3], np.int32)
RN["rnn.lstmOnnx"] = case(
    lambda r: _onnx(r, 4),
    lambda r: (_onnx(r, 4, 2) + [f32(r, 2, 32)],
               {"direction": "bidirectional", "sequence_lens": _LENS,
                "initial_h": f32(r, 2, 2, 4), "initial_c": f32(r, 2, 2, 4)}),
    lambda r: (_onnx(r, 4) + [f32(r, 1, 32)], {"direction": "reverse"}))
RN["rnn.gruOnnx"] = case(
    lambda r: _onnx(r, 3),
    lambda r: (_onnx(r, 3, 2) + [f32(r, 2, 24)],
               {"direction": "bidirectional", "sequence_lens": _LENS,
                "initial_h": f32(r, 2, 2, 4)}),
    lambda r: (_onnx(r, 3) + [f32(r, 1, 24)],
               {"direction": "reverse", "linear_before_reset": 1}))
RN["rnn.rnnOnnx"] = case(
    lambda r: _onnx(r, 1),
    lambda r: (_onnx(r, 1, 2) + [f32(r, 2, 8)],
               {"direction": "bidirectional", "sequence_lens": _LENS,
                "activation": "Relu"}),
    lambda r: (_onnx(r, 1) + [f32(r, 1, 8)],
               {"direction": "reverse", "activation": "Sigmoid"}))

# ---------------------------------------------------- wide: image
_OVERLAPS = np.array([[1.0, 0.7, 0.1, 0.0, 0.6],
                      [0.7, 1.0, 0.2, 0.1, 0.3],
                      [0.1, 0.2, 1.0, 0.8, 0.0],
                      [0.0, 0.1, 0.8, 1.0, 0.4],
                      [0.6, 0.3, 0.0, 0.4, 1.0]], np.float32)
IM["image.nonMaxSuppressionOverlaps"] = case(
    lambda r: [_OVERLAPS, np.array([0.9, 0.8, 0.7, 0.95, 0.5], np.float32),
               3],
    lambda r: ([_OVERLAPS, np.array([0.9, 0.8, 0.7, 0.95, 0.5], np.float32),
                5], {"overlap_threshold": 0.35, "score_threshold": 0.6}),
    grad=())
IM["image.drawBoundingBoxes"] = case(
    lambda r: [f32(r, 2, 6, 7, 3),
               np.array([[[0.1, 0.2, 0.8, 0.9], [0.0, 0.0, 0.5, 0.5]],
                         [[0.3, 0.1, 0.6, 1.0], [0.2, 0.4, 0.2, 0.9]]],
                        np.float32)],
    lambda r: [f32(r, 1, 5, 5, 2),
               np.array([[[0.0, 0.0, 1.0, 1.0]]], np.float32),
               np.array([[0.5, -1.0]], np.float32)], grad=(0,))
IM["image.adjustGamma"] = case(
    lambda r: [f32(r, 2, 3, 3, lo=0.1, hi=1.0)],
    lambda r: ([f32(r, 2, 3, 3, lo=0.1, hi=1.0)], {"gamma": 2.2,
                                                   "gain": 0.8}))
IM["image.rgbToYiq"] = case(lambda r: [_rgb(r, 2, 4, 5)])
IM["image.yiqToRgb"] = case(lambda r: [f32(r, 2, 4, 5, 3) * 0.3])

# ----------------------------------------------------- wide: loss


def _log_softmax(x):
    x = x - x.max(-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


LS["loss.weightedCrossEntropyWithLogits"] = case(
    lambda r: [(r.random((4, 5)) > 0.5).astype(np.float32), f32(r, 4, 5)],
    lambda r: [(r.random((4, 5)) > 0.5).astype(np.float32), f32(r, 4, 5),
               2.5], grad=(1,))
LS["loss.meanPairwiseSquaredError"] = case(
    lambda r: [f32(r, 3, 4), f32(r, 3, 4)],
    lambda r: [f32(r, 3, 2, 2), f32(r, 3, 2, 2), f32(r, 3, lo=0.5, hi=1.5)])
LS["loss.ctcLoss"] = case(
    lambda r: [_log_softmax(f32(r, 2, 8, 5)),
               np.array([[1, 2, 2], [3, 1, 0]], np.int32),
               np.array([8, 6], np.int32), np.array([3, 2], np.int32)],
    lambda r: [_log_softmax(f32(r, 3, 6, 4)),
               np.array([[1, 1], [2, 3], [0, 0]], np.int32),
               np.array([6, 5, 4], np.int32), np.array([2, 2, 0], np.int32)])
LS["loss.l2Loss"] = case(lambda r: [f32(r, 3, 4)])
LS["loss.ctcGreedyDecoder"] = case(
    lambda r: [_log_softmax(f32(r, 3, 7, 4)), np.array([7, 4, 0], np.int32)],
    lambda r: ([_log_softmax(f32(r, 2, 6, 3)), np.array([6, 6], np.int32)],
               {"blank": 2, "merge_repeated": False}), grad=())
LS["loss.logPoissonLoss"] = case(
    lambda r: [f32(r, 3, 4, lo=0.0, hi=4.0), f32(r, 3, 4)],
    lambda r: [f32(r, 3, 4, lo=0.0, hi=4.0), f32(r, 3, 4), True])

# ---------------------------------------------------- wide: random
R["random.lognormal"] = case(
    lambda r: [KEY, (4, 50)],
    lambda r: ([KEY, (30,)], {"mean": 0.5, "std": 0.7}),
    grad=(), tol=_ULPS, why=_ULPS_WHY)
R["random.multinomial"] = case(lambda r: [KEY, f32(r, 3, 5), 40],
                               grad=())


def to_torch(x, device):
    """numpy arrays (and lists/tuples of them) -> torch tensors on
    ``device``; numpy dtypes and everything else as they are."""
    import torch

    if isinstance(x, np.ndarray):
        return torch.as_tensor(x).to(device)
    if isinstance(x, list):
        return [to_torch(e, device) for e in x]
    if isinstance(x, tuple) and any(isinstance(e, np.ndarray) for e in x):
        return tuple(to_torch(e, device) for e in x)
    if isinstance(x, dict):
        return {k: to_torch(e, device) for k, e in x.items()}
    return x


def flat_outputs(out):
    """An op's output as a flat list of leaves (tensors, arrays or Python
    values), through tuples, lists and namedtuples."""
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in flat_outputs(o)]
    return [out]
