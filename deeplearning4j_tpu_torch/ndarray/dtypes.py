"""Data type system (ref: org.nd4j.linalg.api.buffer.DataType) over torch
dtypes (counterpart: ``deeplearning4j_tpu/ndarray/dtypes.py``).

Maps the reference's DataType enum onto torch dtypes. ``UINT16``,
``UINT32`` and ``UINT64`` exist in torch, but few of its kernels take
them: the ops of the registry compute on ``UINT16``/``UINT32`` in int64,
which holds every value, and cast back, so the answer is exact; an op
that cannot be exact that way (``UINT64`` arithmetic) raises a
``TypeError`` naming the dtype (:func:`refuse_uint64`).

The defaults (:data:`defaults`) also hold the process-wide default device
of array creation (``nd.setDefaultDevice``): ``None`` means ``"cuda"``,
resolved through :func:`deeplearning4j_tpu_torch.default_device` when an
array is made, so creation without a card raises unless the CPU was asked
for. :func:`device_scope` overrides it for one thread's block (a SameDiff
graph runs its ops so), leaving other threads and the process-wide
setting untouched; :func:`array_device` reads the two.

They hold the 64-bit switch too (``nd.enableX64``), the counterpart of
JAX's ``jax_enable_x64``, off unless set, as there. Off, no array holds a
64-bit type: data and results in ``float64``/``int64``/``uint64``/
``complex128`` become ``float32``/``int32``/``uint32``/``complex64``
(:func:`canonical`), and the default float and integer of an op
(:func:`float_`, :func:`int_`) are 32-bit. On, they stay 64-bit.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

import numpy as np
import torch

# dl4j DataType name -> torch dtype
_DTYPES = {
    "DOUBLE": torch.float64,
    "FLOAT": torch.float32,
    "HALF": torch.float16,
    "BFLOAT16": torch.bfloat16,
    "LONG": torch.int64,
    "INT": torch.int32,
    "SHORT": torch.int16,
    "BYTE": torch.int8,
    "UBYTE": torch.uint8,
    "UINT16": torch.uint16,
    "UINT32": torch.uint32,
    "UINT64": torch.uint64,
    "BOOL": torch.bool,
}

_CANONICAL = {v: k for k, v in _DTYPES.items()}
# numpy dtype name -> torch dtype ('bfloat16' is ml_dtypes' numpy name)
_BY_NUMPY_NAME = {str(v).replace("torch.", ""): v for v in _DTYPES.values()}
_BY_NUMPY_NAME["bool"] = torch.bool

FLOATING = {"DOUBLE", "FLOAT", "HALF", "BFLOAT16"}
INTEGRAL = {"LONG", "INT", "SHORT", "BYTE", "UBYTE", "UINT16", "UINT32", "UINT64"}
# the unsigned dtypes most torch kernels do not take
WIDENED = (torch.uint16, torch.uint32)


def resolve(dtype):
    """Accept a dl4j-style name ('FLOAT'), a torch or numpy dtype, a numpy
    name ('float32') or a python type (``float`` is float64, as numpy)."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        key = dtype.upper()
        if key in _DTYPES:
            return _DTYPES[key]
        name = dtype
    else:
        name = np.dtype(dtype).name
    if name not in _BY_NUMPY_NAME:
        raise TypeError(f"no torch dtype for {dtype!r}")
    return _BY_NUMPY_NAME[name]


def name_of(dtype) -> str:
    """The dl4j DataType name for a dtype ('FLOAT', 'INT', ...)."""
    dtype = resolve(dtype)
    return _CANONICAL.get(dtype, str(dtype).replace("torch.", "").upper())


def is_floating(dtype) -> bool:
    return resolve(dtype).is_floating_point


def is_integral(dtype) -> bool:
    dtype = resolve(dtype)
    return not (dtype.is_floating_point or dtype.is_complex
                or dtype == torch.bool)


def refuse_uint64(name: str, *tensors):
    """Raise ``TypeError`` when an op that cannot compute ``UINT64``
    exactly is given it."""
    if any(isinstance(t, torch.Tensor) and t.dtype == torch.uint64
           for t in tensors):
        raise TypeError(f"{name}: UINT64 (torch.uint64) is not supported: "
                        "torch has no arithmetic on it and no wider integer "
                        "type holds every value")


_TO_32 = {torch.float64: torch.float32, torch.int64: torch.int32,
          torch.uint64: torch.uint32, torch.complex128: torch.complex64}


class _Defaults:
    """Global default dtypes (ref: Nd4j.setDefaultDataTypes), the default
    device of array creation and the 64-bit switch."""

    def __init__(self):
        self.floating = torch.float32
        self.integral = torch.int32
        self.device = None
        self.x64 = False

    def set(self, floating=None, integral=None):
        if floating is not None:
            self.floating = resolve(floating)
        if integral is not None:
            self.integral = resolve(integral)


defaults = _Defaults()

_local = threading.local()


def array_device():
    """The device of arrays created without ``device=``: this thread's
    innermost :func:`device_scope`, else ``defaults.device`` (None stands
    for ``"cuda"``)."""
    dev = getattr(_local, "device", None)
    return dev if dev is not None else defaults.device


@contextmanager
def device_scope(device):
    """Make ``device`` this thread's array device for the block. Other
    threads, and ``defaults.device``, are not touched."""
    prev = getattr(_local, "device", None)
    _local.device = device
    try:
        yield
    finally:
        _local.device = prev


def canonical(dtype: torch.dtype) -> torch.dtype:
    """``dtype`` as an array holds it: its 32-bit counterpart unless the
    64-bit switch is on (JAX's ``canonicalize_dtype``)."""
    return dtype if defaults.x64 else _TO_32.get(dtype, dtype)


def canonical_tensor(t: torch.Tensor) -> torch.Tensor:
    """``t`` cast to :func:`canonical` of its dtype (itself when it is
    already)."""
    want = canonical(t.dtype)
    return t if want == t.dtype else t.to(want)


def float_() -> torch.dtype:
    """The default float of an op: float64 with the 64-bit switch on,
    else float32."""
    return torch.float64 if defaults.x64 else torch.float32


def int_() -> torch.dtype:
    """The default integer of an op: int64 with the 64-bit switch on,
    else int32."""
    return torch.int64 if defaults.x64 else torch.int32


class enable_x64:
    """Set the 64-bit switch; as a context manager, restore the previous
    setting on exit (as ``torch.set_grad_enabled``)."""

    def __init__(self, flag: bool = True):
        self.prev = defaults.x64
        defaults.x64 = bool(flag)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        defaults.x64 = self.prev
        return False
