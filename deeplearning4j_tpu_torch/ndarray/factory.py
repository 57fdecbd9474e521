"""The static factory — nd4j's ``Nd4j`` class equivalent (ref:
org.nd4j.linalg.factory.Nd4j) over torch (counterpart:
``deeplearning4j_tpu/ndarray/factory.py``).

Array creation, global dtype and device control, linalg entry points.
Creation takes ``device=``; without it an array lands on the process-wide
default device (:meth:`nd.setDefaultDevice`), ``"cuda"`` unless set, so
creation without a card raises unless the CPU was asked for. Ops follow
their inputs' device.
"""
from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.ndarray import dtypes as _dt
from deeplearning4j_tpu_torch.ndarray import random as _random
from deeplearning4j_tpu_torch.ndarray.array import (
    NDArray, as_tensor, default_array_device, dot, take, top_k)


def _dtype(dtype):
    return _dt.resolve(dtype) if dtype is not None else _dt.defaults.floating


def _shape(args):
    if len(args) == 1 and isinstance(args[0], (tuple, list)):
        return tuple(args[0])
    return tuple(args)


def _dev(device):
    return default_array_device() if device is None else torch.device(device)


def _t(a, device=None):
    return as_tensor(a, device=device)


class nd:
    """Namespace of static factory/exec methods (Nd4j analog)."""

    DataType = _dt

    # ------------------------------------------------------------- creation
    @staticmethod
    def create(data=None, shape=None, dtype=None, device=None) -> NDArray:
        if data is None:
            return nd.zeros(*shape, dtype=dtype, device=device)
        arr = as_tensor(data, device=None if device is None and isinstance(
            data, (NDArray, torch.Tensor)) else _dev(device),
            dtype=_dt.resolve(dtype))
        if shape is not None:
            arr = arr.reshape(tuple(shape))
        return NDArray(arr)

    @staticmethod
    def zeros(*shape, dtype=None, device=None) -> NDArray:
        return NDArray(torch.zeros(_shape(shape), dtype=_dtype(dtype),
                                   device=_dev(device)))

    @staticmethod
    def ones(*shape, dtype=None, device=None) -> NDArray:
        return NDArray(torch.ones(_shape(shape), dtype=_dtype(dtype),
                                  device=_dev(device)))

    @staticmethod
    def zerosLike(a) -> NDArray:
        return NDArray(torch.zeros_like(_t(a)))

    @staticmethod
    def onesLike(a) -> NDArray:
        return NDArray(torch.ones_like(_t(a)))

    @staticmethod
    def valueArrayOf(shape, value, dtype=None, device=None) -> NDArray:
        return NDArray(torch.full(tuple(shape), value, dtype=_dtype(dtype),
                                  device=_dev(device)))

    @staticmethod
    def scalar(value, dtype=None, device=None) -> NDArray:
        return NDArray(as_tensor(value, _dev(device), _dt.resolve(dtype)))

    @staticmethod
    def eye(n, dtype=None, device=None) -> NDArray:
        return NDArray(torch.eye(n, dtype=_dtype(dtype), device=_dev(device)))

    @staticmethod
    def arange(*args, dtype=None, device=None) -> NDArray:
        return NDArray(as_tensor(np.arange(*args), _dev(device),
                                 _dt.resolve(dtype)))

    @staticmethod
    def linspace(start, stop, num, dtype=None, device=None) -> NDArray:
        return NDArray(torch.linspace(start, stop, num, dtype=torch.float64,
                                      device=_dev(device)).to(_dtype(dtype)))

    # ---------------------------------------------------------------- random
    @staticmethod
    def getRandom() -> _random.Random:
        return _random.getRandom()

    @staticmethod
    def rand(*shape, dtype=None, device=None) -> NDArray:
        return NDArray(_random.getRandom().uniform(
            _shape(shape), dtype=_dtype(dtype), device=_dev(device)))

    @staticmethod
    def randn(*shape, dtype=None, device=None) -> NDArray:
        return NDArray(_random.getRandom().normal(
            _shape(shape), dtype=_dtype(dtype), device=_dev(device)))

    @staticmethod
    def randomBernoulli(p, *shape, device=None) -> NDArray:
        return NDArray(_random.getRandom().bernoulli(
            _shape(shape), p, device=_dev(device)).to(_dt.defaults.floating))

    # ------------------------------------------------------------ stack/split
    @staticmethod
    def concat(axis, *arrays) -> NDArray:
        return NDArray(torch.cat([_t(a) for a in arrays], dim=axis))

    @staticmethod
    def stack(axis, *arrays) -> NDArray:
        return NDArray(torch.stack([_t(a) for a in arrays], dim=axis))

    @staticmethod
    def vstack(*arrays) -> NDArray:
        return NDArray(torch.vstack([_t(a) for a in arrays]))

    @staticmethod
    def hstack(*arrays) -> NDArray:
        return NDArray(torch.hstack([_t(a) for a in arrays]))

    @staticmethod
    def split(a, n, axis=0):
        return [NDArray(x) for x in torch.tensor_split(_t(a), n, dim=axis)]

    @staticmethod
    def tile(a, *reps) -> NDArray:
        return NDArray(torch.tile(_t(a), _shape(reps)))

    @staticmethod
    def where(cond, x=None, y=None):
        c = _t(cond)
        if x is None:
            return [NDArray(i) for i in torch.nonzero(c, as_tuple=True)]
        return NDArray(torch.where(c, as_tensor(x, c.device),
                                   as_tensor(y, c.device)))

    # ----------------------------------------------------------------- linalg
    @staticmethod
    def gemm(a, b, transposeA=False, transposeB=False, alpha=1.0, beta=0.0,
             c=None) -> NDArray:
        A = _t(a).T if transposeA else _t(a)
        B = _t(b).T if transposeB else _t(b)
        out = alpha * torch.matmul(A, B)
        if c is not None and beta != 0.0:
            out = out + beta * _t(c)
        return NDArray(out)

    @staticmethod
    def matmul(a, b) -> NDArray:
        return NDArray(torch.matmul(_t(a), _t(b)))

    @staticmethod
    def dot(a, b) -> NDArray:
        return NDArray(dot(_t(a), _t(b)))

    @staticmethod
    def tensorMmul(a, b, axes) -> NDArray:
        return NDArray(torch.tensordot(_t(a), _t(b), dims=axes))

    @staticmethod
    def kron(a, b) -> NDArray:
        return NDArray(torch.kron(_t(a), _t(b)))

    @staticmethod
    def diag(a) -> NDArray:
        return NDArray(torch.diag(_t(a)))

    # -------------------------------------------------------------- gather etc
    @staticmethod
    def gather(a, indices, axis=0) -> NDArray:
        a = _t(a)
        return NDArray(take(a, _t(indices, a.device), axis))

    @staticmethod
    def scatterUpdate(a, indices, updates) -> NDArray:
        out = _t(a).clone()
        out[_t(indices, out.device)] = _t(updates, out.device).to(out.dtype)
        return NDArray(out)

    @staticmethod
    def scatterAdd(a, indices, updates) -> NDArray:
        a = _t(a)
        return NDArray(a.index_put((_t(indices, a.device),),
                                   _t(updates, a.device).to(a.dtype),
                                   accumulate=True))

    @staticmethod
    def oneHot(indices, depth, dtype=None) -> NDArray:
        idx = _t(indices)
        hot = idx.unsqueeze(-1) == torch.arange(depth, device=idx.device)
        return NDArray(hot.to(_dtype(dtype)))

    @staticmethod
    def sort(a, axis=-1, descending=False) -> NDArray:
        out = torch.sort(_t(a), dim=axis, stable=True).values
        return NDArray(torch.flip(out, dims=(axis,)) if descending else out)

    @staticmethod
    def argsort(a, axis=-1) -> NDArray:
        return NDArray(torch.argsort(_t(a), dim=axis, stable=True))

    @staticmethod
    def topK(a, k, axis=-1):
        vals, idx = top_k(torch.movedim(_t(a), axis, -1), k)
        return (NDArray(torch.movedim(vals, -1, axis)),
                NDArray(torch.movedim(idx, -1, axis)))

    # --------------------------------------------------------------- defaults
    @staticmethod
    def setDefaultDataTypes(floating=None, integral=None):
        _dt.defaults.set(floating, integral)

    @staticmethod
    def defaultFloatingPointType():
        return _dt.defaults.floating

    @staticmethod
    def enableX64(flag: bool = True):
        """The 64-bit switch (JAX's ``jax_enable_x64``), off unless set:
        off, arrays and op results hold no 64-bit type. Works as a
        context manager too, restoring the previous setting on exit."""
        return _dt.enable_x64(flag)

    @staticmethod
    def setDefaultDevice(device=None):
        """The device of arrays created without ``device=``; None restores
        ``"cuda"`` (which raises at creation without a card)."""
        _dt.defaults.device = None if device is None else torch.device(device)

    # -------------------------------------------------------------- env info
    @staticmethod
    def getBackend() -> str:
        """``"gpu"`` when arrays are made on the card, ``"cpu"`` when on
        the host — what JAX calls the two."""
        dev = _dt.defaults.device
        if dev is None:
            return "gpu" if torch.cuda.is_available() else "cpu"
        return "gpu" if dev.type == "cuda" else "cpu"

    @staticmethod
    def getAffinityManager():
        """Device listing (ref: Nd4j.getAffinityManager): the cards, or the
        host when there is none."""
        if torch.cuda.is_available():
            return [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        return [torch.device("cpu")]
