"""Op-spec registry — the single source of truth for the op surface
(counterpart: ``deeplearning4j_tpu/ops/registry.py``).

Each op is registered once with its torch-level implementation (tensors
in, tensors out), under the same ``namespace.name`` key as in the
reference, and the **eager** namespaces (``ops.math.tanh(x)`` on NDArray —
the analog of org.nd4j.linalg.factory.ops.NDMath etc.) are generated from
it.

Gradients come from autograd over the impl (every impl is differentiable
torch code), where the reference's come from ``jax.grad``.

A registered op's tensor outputs hold canonical dtypes
(``dtypes.canonical``): with the 64-bit switch off, as by default, no
result is 64-bit, as no array is in the reference's default mode.

The registry doubles as the **coverage ledger** (ref:
org.nd4j.autodiff.validation.OpValidation): tests mark ops validated and
``coverage_report()`` lists unvalidated ops.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.ndarray import dtypes as _dt
from deeplearning4j_tpu_torch.ndarray.array import NDArray, as_tensor


@dataclass
class OpSpec:
    name: str
    namespace: str
    fn: Callable  # torch-level implementation (tensors in/out)
    doc: str = ""
    validated: bool = False  # flipped by the op-validation test harness


REGISTRY: Dict[str, OpSpec] = {}


def _canonical(out):
    """``out`` with every tensor in it (through tuples, lists and
    namedtuples) cast to its canonical dtype."""
    if isinstance(out, tuple) and hasattr(out, "_fields"):  # namedtuple
        return type(out)(*(_canonical(o) for o in out))
    if isinstance(out, (tuple, list)):
        return type(out)(_canonical(o) for o in out)
    if isinstance(out, torch.Tensor):
        return _dt.canonical_tensor(out)
    return out


def op(name: str, namespace: str, doc: str = ""):
    """Register a torch-level function as a framework op; the registry
    holds it with canonical outputs."""

    def deco(fn):
        @functools.wraps(fn)
        def canonical_fn(*args, **kwargs):
            out = fn(*args, **kwargs)
            return out if _dt.defaults.x64 else _canonical(out)

        key = f"{namespace}.{name}"
        REGISTRY[key] = OpSpec(name=name, namespace=namespace,
                               fn=canonical_fn, doc=doc or fn.__doc__ or "")
        return fn

    return deco


def get(name: str, namespace: Optional[str] = None) -> OpSpec:
    if namespace is not None:
        return REGISTRY[f"{namespace}.{name}"]
    matches = [s for k, s in REGISTRY.items() if s.name == name]
    if not matches:
        raise KeyError(f"unknown op: {name}")
    return matches[0]


def mark_validated(name: str, namespace: Optional[str] = None):
    get(name, namespace).validated = True


def coverage_report():
    """(validated, unvalidated) op key lists — the op-parity ledger."""
    done = sorted(k for k, s in REGISTRY.items() if s.validated)
    todo = sorted(k for k, s in REGISTRY.items() if not s.validated)
    return done, todo


def _device_of(args, kwargs):
    """The device of the first tensor among the arguments (one level into
    lists), else None."""
    for a in list(args) + list(kwargs.values()):
        for x in (a if isinstance(a, (list, tuple)) else (a,)):
            if isinstance(x, NDArray):
                return x.device
            if isinstance(x, torch.Tensor):
                return x.device
    return None


def _unwrap(x, device):
    """NDArray -> its tensor; a numpy array -> a tensor on ``device``
    (the inputs' device, else the default device); lists and tuples of
    arrays element by element; anything else as it is."""
    if isinstance(x, NDArray):
        return x.torch
    if isinstance(x, np.ndarray):
        return as_tensor(x, device)
    if isinstance(x, list) and any(isinstance(e, (NDArray, np.ndarray))
                                   for e in x):
        return [_unwrap(e, device) for e in x]
    if isinstance(x, tuple) and any(isinstance(e, (NDArray, np.ndarray))
                                    for e in x):
        return tuple(_unwrap(e, device) for e in x)
    return x


def wrap_out(out):
    """Tensors -> NDArray, through tuples, lists and namedtuples; Python
    scalars (and anything else) as they are."""
    if isinstance(out, tuple) and hasattr(out, "_fields"):  # namedtuple
        return type(out)(*(wrap_out(o) for o in out))
    if isinstance(out, (tuple, list)):
        return type(out)(wrap_out(o) for o in out)
    if isinstance(out, torch.Tensor):
        return NDArray(out)
    return out


class EagerNamespace:
    """Eager op surface over NDArray, generated from the registry
    (ref: org.nd4j.linalg.factory.ops.ND* generated classes)."""

    def __init__(self, namespace: str):
        self._namespace = namespace

    def __getattr__(self, name: str):
        spec = REGISTRY.get(f"{self._namespace}.{name}")
        if spec is None:
            raise AttributeError(f"no op {self._namespace}.{name}")

        @functools.wraps(spec.fn)
        def call(*args, **kwargs):
            dev = _device_of(args, kwargs)
            args = [_unwrap(a, dev) for a in args]
            kwargs = {k: _unwrap(v, dev) for k, v in kwargs.items()}
            return wrap_out(spec.fn(*args, **kwargs))

        # cache on the instance so repeated lookups are cheap
        setattr(self, name, call)
        return call

    def __dir__(self):
        prefix = self._namespace + "."
        return [k[len(prefix):] for k in REGISTRY if k.startswith(prefix)]
