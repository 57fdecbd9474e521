"""NDArray — the tensor facade (ref: org.nd4j.linalg.api.ndarray.INDArray/
BaseNDArray) over a ``torch.Tensor`` (counterpart:
``deeplearning4j_tpu/ndarray/array.py``).

A thin, zero-copy wrapper that keeps the reference's op *names and
semantics* at the API boundary, with a functional compute path: every op
makes a new tensor.

In-place ``i``-variants (``addi``, ``muli`` …) rebind the wrapper to the
new value — observationally in-place for the common "handle held in one
place" pattern the reference's training loops use. True aliasing of
*views* is not reproduced; ``dup()`` remains a semantic copy, and ``put``
and ``__setitem__`` write into a copy that the handle then holds.

The reference registers NDArray as a jax pytree so it flows through
``jax.grad``; here autograd runs on the underlying tensor (:attr:`torch`,
the counterpart of ``.jax``): a tensor that requires grad keeps doing so
through the facade's ops (``requires_grad``, ``requires_grad_()``,
``grad``).

Device: an NDArray made from a tensor stays on its device; one made from
numpy data, a list or a Python number lands on the default device
(``nd.setDefaultDevice``; ``"cuda"`` unless set), and creation without a
card raises unless the CPU was asked for.

Dtypes follow the reference's default mode: no array holds a 64-bit
type, so numpy and Python data, and the results of ops, in float64 or
int64 come out float32 or int32 (``dtypes.canonical``). With
``nd.enableX64()`` (JAX's ``jax_enable_x64``) they stay 64-bit, as the
reference's tests run it.
"""
from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.ndarray import dtypes as _dt


def default_array_device() -> torch.device:
    """The device of new arrays: this thread's ``dtypes.device_scope``'s,
    else ``nd.setDefaultDevice``'s, else ``"cuda"``, which raises without
    a card."""
    from deeplearning4j_tpu_torch import default_device

    return default_device(_dt.array_device())


def as_tensor(x, device=None, dtype=None) -> torch.Tensor:
    """A tensor for ``x``: an NDArray's or a tensor as it is (moved where
    ``device`` or ``dtype`` is given), other data through numpy onto
    ``device`` or the default device."""
    if isinstance(x, NDArray):
        x = x._t
    if isinstance(x, torch.Tensor):
        return x if device is None and dtype is None else x.to(
            device=device, dtype=dtype)
    dev = default_array_device() if device is None else torch.device(device)
    t = _dt.canonical_tensor(torch.as_tensor(np.asarray(x))).to(dev)
    return t if dtype is None else t.to(dtype)


def _operand(x, like: torch.Tensor):
    """``x`` for an op beside ``like``: NDArrays and numpy arrays become
    tensors on ``like``'s device; Python scalars stay (weakly typed, as in
    both frameworks)."""
    if isinstance(x, NDArray):
        return x._t
    if isinstance(x, (np.ndarray, np.generic, list, tuple)):
        return _dt.canonical_tensor(torch.as_tensor(np.asarray(x))).to(
            like.device)
    return x


def _index(idx, like: torch.Tensor):
    """A numpy-style index for a tensor: arrays (numpy, NDArray, lists)
    become index tensors on ``like``'s device."""
    if isinstance(idx, tuple):
        return tuple(_index(i, like) for i in idx)
    if isinstance(idx, NDArray):
        return idx._t
    if isinstance(idx, (np.ndarray, list)):
        return torch.as_tensor(np.asarray(idx), device=like.device)
    return idx


def _dims(axis, ndim):
    """None / int / sequence -> a tuple of dims (all for None)."""
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (tuple, list)):
        return tuple(int(a) for a in axis)
    return (int(axis),)


def reduce(name: str, t: torch.Tensor, axis=None, keepdims=False):
    """``jnp.<name>(t, axis=axis, keepdims=keepdims)`` for sum, mean, max,
    min, prod, any and all (``axis`` None, an int or a sequence). Integer
    sums and products widen to int64, which an array then holds as
    ``dtypes.canonical`` says; the mean of integers is in the default
    float (``dtypes.float_``)."""
    if name == "mean" and not (t.is_floating_point() or t.is_complex()):
        t = t.to(_dt.float_())
    if name == "prod":
        if axis is None:
            out = torch.prod(t)
            return out.reshape((1,) * t.dim()) if keepdims else out
        out = t
        for d in sorted({d % t.dim() for d in _dims(axis, t.dim())},
                        reverse=True):
            out = torch.prod(out, dim=d, keepdim=keepdims)
        return out
    dims = None if axis is None else _dims(axis, t.dim())
    if name in ("max", "min"):
        fn = torch.amax if name == "max" else torch.amin
        return fn(t, dim=() if dims is None else dims, keepdim=keepdims)
    fn = {"sum": torch.sum, "mean": torch.mean, "any": torch.any,
          "all": torch.all}[name]
    return fn(t, dim=dims, keepdim=keepdims)


def take(a: torch.Tensor, indices: torch.Tensor, axis: int = 0):
    """``jnp.take(a, indices, axis)``: the slices of ``a`` along ``axis``
    at ``indices`` (any shape; negative indices count from the end)."""
    axis = axis % a.dim()
    n = a.shape[axis]
    idx = torch.as_tensor(indices, device=a.device).to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``numpy.dot``: the last axis of ``a`` against the second-to-last of
    ``b`` (its only one for a vector)."""
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    return torch.tensordot(a, b, dims=([a.dim() - 1], [max(b.dim() - 2, 0)]))


def top_k(a: torch.Tensor, k: int):
    """``lax.top_k`` along the last axis: the k largest, ties to the lower
    index, with int32 indices."""
    vals, idx = torch.sort(a, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


class NDArray:
    """N-dimensional array over a torch.Tensor value."""

    __slots__ = ("_t",)

    def __init__(self, value):
        self._t = _dt.canonical_tensor(as_tensor(value))

    # ------------------------------------------------------------------ basics
    @property
    def torch(self) -> torch.Tensor:
        """The underlying torch.Tensor (escape hatch; the reference's
        ``.jax``)."""
        return self._t

    @property
    def shape(self):
        return tuple(self._t.shape)

    @property
    def dtype(self):
        return self._t.dtype

    @property
    def device(self) -> torch.device:
        return self._t.device

    @property
    def requires_grad(self) -> bool:
        return self._t.requires_grad

    def requires_grad_(self, flag: bool = True) -> "NDArray":
        self._t.requires_grad_(flag)
        return self

    @property
    def grad(self):
        g = self._t.grad
        return None if g is None else NDArray(g)

    def dataType(self) -> str:
        return _dt.name_of(self._t.dtype)

    def rank(self) -> int:
        return self._t.dim()

    @property
    def ndim(self) -> int:
        return self._t.dim()

    def length(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def size(self) -> int:
        return self.length()

    def isScalar(self) -> bool:
        return self._t.dim() == 0

    def isVector(self) -> bool:
        return self._t.dim() == 1

    def isMatrix(self) -> bool:
        return self._t.dim() == 2

    def rows(self) -> int:
        return self.shape[0]

    def columns(self) -> int:
        return self.shape[1]

    def dup(self, order: str = "c") -> "NDArray":
        """Semantic copy (ref: INDArray.dup / dup(char)). The copy's VALUES
        are identical either way — in the reference, order only changes the
        underlying buffer layout, which this facade does not expose. The
        observable face of ordering is flattening: ravel/reshape take an
        ``order`` argument."""
        return NDArray(self._t.clone())

    def ordering(self) -> str:
        """(ref: INDArray.ordering) — the facade is always c-order
        observable; 'f' semantics surface via the order arguments on
        ravel/reshape where flattening order leaks into serialization."""
        return "c"

    def castTo(self, dtype) -> "NDArray":
        return NDArray(self._t.to(_dt.resolve(dtype)))

    astype = castTo

    def toNumpy(self) -> np.ndarray:
        """The values as a numpy array on the host (bfloat16, which numpy
        lacks, as float32)."""
        t = self._t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.toNumpy()
        return a.astype(dtype) if dtype is not None else a

    def item(self):
        return self._t.item()

    def __float__(self) -> float:
        return float(self._t)

    def __int__(self) -> int:
        return int(self._t)

    def __bool__(self) -> bool:
        return bool(self._t)

    def getDouble(self, *indices) -> float:
        return float(self._t[tuple(indices)] if indices else self._t)

    def getInt(self, *indices) -> int:
        return int(self._t[tuple(indices)] if indices else self._t)

    # --------------------------------------------------------- binary arithmetic
    def _binary(self, other, fn) -> "NDArray":
        return NDArray(fn(self._t, _operand(other, self._t)))

    def _ibinary(self, other, fn) -> "NDArray":
        self._t = _dt.canonical_tensor(fn(self._t, _operand(other, self._t)))
        return self

    def add(self, other):
        return self._binary(other, torch.add)

    def sub(self, other):
        return self._binary(other, torch.sub)

    def mul(self, other):
        return self._binary(other, torch.mul)

    def div(self, other):
        return self._binary(other, torch.true_divide)

    def rsub(self, other):
        return self._binary(other, lambda a, b: b - a)

    def rdiv(self, other):
        return self._binary(other, lambda a, b: b / a)

    def fmod(self, other):
        return self._binary(other, torch.fmod)

    def pow(self, other):
        return self._binary(other, torch.pow)

    def addi(self, other):
        return self._ibinary(other, torch.add)

    def subi(self, other):
        return self._ibinary(other, torch.sub)

    def muli(self, other):
        return self._ibinary(other, torch.mul)

    def divi(self, other):
        return self._ibinary(other, torch.true_divide)

    def rsubi(self, other):
        return self._ibinary(other, lambda a, b: b - a)

    def rdivi(self, other):
        return self._ibinary(other, lambda a, b: b / a)

    def neg(self):
        return NDArray(-self._t)

    def negi(self):
        self._t = -self._t
        return self

    def assign(self, other):
        """Overwrite contents (ref: INDArray.assign) — rebinds to a
        broadcast copy."""
        src = torch.as_tensor(_operand(other, self._t), device=self._t.device)
        self._t = src.to(self._t.dtype).expand(self.shape).clone()
        return self

    # dunders
    __add__ = add
    __radd__ = add
    __sub__ = sub
    __rsub__ = rsub
    __mul__ = mul
    __rmul__ = mul
    __truediv__ = div
    __rtruediv__ = rdiv
    __pow__ = pow
    __neg__ = neg
    __mod__ = fmod

    def __matmul__(self, other):
        return self.mmul(other)

    # ----------------------------------------------------------------- linalg
    def mmul(self, other) -> "NDArray":
        return NDArray(torch.matmul(self._t, _operand(other, self._t)))

    def transpose(self, *axes) -> "NDArray":
        if not axes:
            return NDArray(self._t.permute(*reversed(range(self.ndim))))
        return NDArray(self._t.permute(*axes))

    def permute(self, *axes) -> "NDArray":
        return NDArray(self._t.permute(*axes))

    def transposei(self):
        self._t = self._t.permute(*reversed(range(self.ndim)))
        return self

    # ------------------------------------------------------------------ shape
    def reshape(self, *shape, order: str = "c") -> "NDArray":
        """(ref: INDArray.reshape(char order, ...)): 'f' enumerates/refills
        elements column-major — the reference's f-order reshape semantics,
        reproduced functionally (transpose-compose)."""
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        if order.lower() == "f":
            flat = self.ravel(order="f")._t
            r = flat.reshape(tuple(reversed(shape)))
            return NDArray(r.permute(*reversed(range(r.dim()))))
        return NDArray(self._t.reshape(shape))

    def ravel(self, order: str = "c") -> "NDArray":
        """(ref: INDArray.ravel(char)): 'f' flattens column-major — the
        order that leaks into the reference's flat-params serialization."""
        if order.lower() == "f":
            return NDArray(self._t.permute(
                *reversed(range(self.ndim))).reshape(-1))
        return NDArray(self._t.reshape(-1))

    flatten = ravel

    def broadcast(self, *shape) -> "NDArray":
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return NDArray(torch.broadcast_to(self._t, shape))

    def repeat(self, repeats, axis=None) -> "NDArray":
        return NDArray(torch.repeat_interleave(self._t, repeats, dim=axis))

    def squeeze(self, axis=None) -> "NDArray":
        if axis is None:
            return NDArray(self._t.squeeze())
        return NDArray(self._t.squeeze(axis))

    def expandDims(self, axis) -> "NDArray":
        return NDArray(self._t.unsqueeze(axis))

    def swapAxes(self, a, b) -> "NDArray":
        return NDArray(self._t.transpose(a, b))

    # ------------------------------------------------------------- reductions
    @staticmethod
    def _axis(dims):
        return None if not dims else (dims if len(dims) > 1 else dims[0])

    def _reduce(self, name, dims, keepdims=False):
        return NDArray(reduce(name, self._t, self._axis(dims), keepdims))

    def sum(self, *dims, keepdims=False):
        return self._reduce("sum", dims, keepdims)

    def mean(self, *dims, keepdims=False):
        return self._reduce("mean", dims, keepdims)

    def max(self, *dims, keepdims=False):
        return self._reduce("max", dims, keepdims)

    def min(self, *dims, keepdims=False):
        return self._reduce("min", dims, keepdims)

    def prod(self, *dims, keepdims=False):
        return self._reduce("prod", dims, keepdims)

    def std(self, *dims, keepdims=False, biasCorrected=True):
        return NDArray(torch.std(self._t, dim=dims or None,
                                 correction=1 if biasCorrected else 0,
                                 keepdim=keepdims))

    def var(self, *dims, keepdims=False, biasCorrected=True):
        return NDArray(torch.var(self._t, dim=dims or None,
                                 correction=1 if biasCorrected else 0,
                                 keepdim=keepdims))

    def norm1(self, *dims, keepdims=False):
        return NDArray(reduce("sum", self._t.abs(), self._axis(dims),
                              keepdims))

    def norm2(self, *dims, keepdims=False):
        return NDArray(torch.sqrt(reduce("sum", self._t * self._t,
                                         self._axis(dims), keepdims)))

    def normmax(self, *dims, keepdims=False):
        return NDArray(reduce("max", self._t.abs(), self._axis(dims),
                              keepdims))

    def argMax(self, *dims):
        return NDArray(torch.argmax(self._t, dim=dims[0] if dims else None))

    def argMin(self, *dims):
        return NDArray(torch.argmin(self._t, dim=dims[0] if dims else None))

    def cumsum(self, axis=None):
        t = self._t.reshape(-1) if axis is None else self._t
        return NDArray(torch.cumsum(t, dim=0 if axis is None else axis))

    def cumprod(self, axis=None):
        t = self._t.reshape(-1) if axis is None else self._t
        return NDArray(torch.cumprod(t, dim=0 if axis is None else axis))

    def sumNumber(self) -> float:
        return float(torch.sum(self._t))

    def meanNumber(self) -> float:
        return float(torch.mean(self._t))

    def maxNumber(self) -> float:
        return float(torch.max(self._t))

    def minNumber(self) -> float:
        return float(torch.min(self._t))

    def norm2Number(self) -> float:
        return float(torch.sqrt(torch.sum(self._t * self._t)))

    def entropy(self, *dims):
        p = self._t
        return NDArray(-reduce("sum", p * torch.log(p), self._axis(dims)))

    # ------------------------------------------------------------ comparisons
    def gt(self, other):
        return self._binary(other, torch.gt)

    def lt(self, other):
        return self._binary(other, torch.lt)

    def gte(self, other):
        return self._binary(other, torch.ge)

    def lte(self, other):
        return self._binary(other, torch.le)

    def eq(self, other):
        return self._binary(other, torch.eq)

    def neq(self, other):
        return self._binary(other, torch.ne)

    __gt__ = gt
    __lt__ = lt
    __ge__ = gte
    __le__ = lte

    def __eq__(self, other):  # INDArray.eq semantics: elementwise
        if isinstance(other, (NDArray, torch.Tensor, np.ndarray, int, float,
                              bool)):
            return self.eq(other)
        return NotImplemented

    def __ne__(self, other):
        if isinstance(other, (NDArray, torch.Tensor, np.ndarray, int, float,
                              bool)):
            return self.neq(other)
        return NotImplemented

    def __hash__(self):
        return id(self)

    def equalsWithEps(self, other, eps=1e-5) -> bool:
        o = torch.as_tensor(_operand(other, self._t), device=self._t.device)
        if tuple(o.shape) != self.shape:
            return False
        return bool(torch.all(torch.abs(self._t - o) <= eps))

    def equals(self, other) -> bool:
        return self.equalsWithEps(other, 1e-5)

    # --------------------------------------------------------------- indexing
    def __getitem__(self, idx):
        return NDArray(self._t[_index(idx, self._t)])

    def _set(self, idx, value):
        t = self._t.clone()
        t[_index(idx, t)] = _operand(value, t)
        self._t = t

    def __setitem__(self, idx, value):
        self._set(idx, value)

    def get(self, *indices):
        """View selection (ref: INDArray.get(INDArrayIndex...)): accepts
        NDArrayIndex.point/all/interval/newAxis/indices objects as well as
        raw ints and slices; fewer indices than rank leaves trailing
        dimensions as all()."""
        from deeplearning4j_tpu_torch.ndarray.indexing import lower_indices
        return NDArray(self._t[_index(lower_indices(indices), self._t)])

    def getRow(self, i):
        return NDArray(self._t[i])

    def getColumn(self, i):
        return NDArray(self._t[:, i])

    def getRows(self, *rows):
        return NDArray(self._t[torch.as_tensor(rows, device=self._t.device)])

    def getColumns(self, *cols):
        return NDArray(self._t[:, torch.as_tensor(cols,
                                                  device=self._t.device)])

    def putScalar(self, indices, value):
        if not isinstance(indices, (tuple, list)):
            indices = (indices,)
        self._set(tuple(indices), value)
        return self

    def put(self, indices, value):
        """Assign into a view selection (ref: INDArray.put(INDArrayIndex...,
        INDArray)): value broadcasts into the selected region; the update is
        observable through THIS handle (a copy written and rebound)."""
        from deeplearning4j_tpu_torch.ndarray.indexing import lower_indices
        if not isinstance(indices, (tuple, list)):
            indices = (indices,)
        self._set(lower_indices(indices), value)
        return self

    def putRow(self, i, row):
        self._set(i, row)
        return self

    def putColumn(self, i, col):
        self._set((slice(None), i), col)
        return self

    def slice(self, i, axis=0):
        return NDArray(torch.select(self._t, axis, i))

    def tensorAlongDimension(self, index, *dims):
        """TAD access (ref: BaseNDArray.tensorAlongDimension) — returns the
        index-th sub-tensor spanning ``dims``."""
        dims = sorted(d % self.ndim for d in dims)
        other = [d for d in range(self.ndim) if d not in dims]
        moved = self._t.permute(*(other + dims))
        lead = int(np.prod([self.shape[d] for d in other])) if other else 1
        tad_shape = tuple(self.shape[d] for d in dims)
        return NDArray(moved.reshape((lead,) + tad_shape)[index])

    # ------------------------------------------------------------------ misc
    def __len__(self):
        return self.shape[0] if self.shape else 0

    def __iter__(self):
        return (NDArray(self._t[i]) for i in range(len(self)))

    def __repr__(self):
        return (f"NDArray(shape={self.shape}, dtype={_dt.name_of(self.dtype)}"
                f", device={self._t.device})\n{self._t}")

    def shapeInfoToString(self) -> str:
        return (f"rank={self.ndim}, shape={list(self.shape)}, "
                f"dtype={self.dataType()}")
