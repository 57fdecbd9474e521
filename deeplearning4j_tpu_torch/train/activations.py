"""Activation functions (counterpart: ``deeplearning4j_tpu/train/
activations.py``; ref: org.nd4j.linalg.activations.Activation enum +
impl.Activation* classes).

Each dl4j name resolves to a torch function with ``jax.nn``'s definition
(the tanh GELU, ``logaddexp`` softplus, leaky slope 0.01), so a layer
computes what the reference's layer computes.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops.nn_defs import (
    _SELU_ALPHA, _SELU_SCALE, _elu, _gelu, _relu6, _softplus)

# dl4j Activation enum name -> torch fn
_ACTIVATIONS: dict[str, Callable] = {
    "IDENTITY": lambda x: x,
    "RELU": torch.relu,
    "RELU6": _relu6,
    "LEAKYRELU": lambda x: torch.where(x >= 0, x, 0.01 * x),
    "ELU": _elu,
    "SELU": lambda x: _SELU_SCALE * _elu(x, _SELU_ALPHA),
    "GELU": lambda x: _gelu(x, approximate=True),
    "SIGMOID": torch.sigmoid,
    "HARDSIGMOID": lambda x: _relu6(x + 3.0) / 6.0,
    "TANH": torch.tanh,
    "HARDTANH": lambda x: torch.clamp(x, -1.0, 1.0),
    "RATIONALTANH": lambda x: 1.7159 * torch.tanh(2.0 * x / 3.0),
    "RECTIFIEDTANH": lambda x: torch.clamp_min(torch.tanh(x), 0.0),
    "SOFTMAX": lambda x: torch.softmax(x, dim=-1),
    "LOGSOFTMAX": lambda x: torch.log_softmax(x, dim=-1),
    "SOFTPLUS": _softplus,
    "SOFTSIGN": lambda x: x / (torch.abs(x) + 1),
    "SWISH": F.silu,
    "MISH": lambda x: x * torch.tanh(_softplus(x)),
    "CUBE": lambda x: x * x * x,
    "THRESHOLDEDRELU": lambda x: torch.where(x > 1.0, x, 0.0),
}


def get(name) -> Callable:
    """Resolve an activation by dl4j name (case-insensitive) or pass through a callable."""
    if callable(name):
        return name
    fn = _ACTIVATIONS.get(str(name).upper())
    if fn is None:
        raise ValueError(f"unknown activation: {name}. Known: {sorted(_ACTIVATIONS)}")
    return fn


def names():
    return sorted(_ACTIVATIONS)
