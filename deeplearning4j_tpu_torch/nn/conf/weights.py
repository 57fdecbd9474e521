"""Weight initialization (counterpart: ``deeplearning4j_tpu/nn/conf/
weights.py``; ref: org.deeplearning4j.nn.weights.WeightInit enum +
WeightInitUtil; dl4j's XAVIER is gaussian sqrt(2/(fanIn+fanOut))).

All initializers are pure functions of an explicit threefry key, drawn
with the port's ``uniform``/``normal`` (``ndarray/random.py``), so the
same key gives the reference's weights: uniform draws bit for bit, normal
draws within ``erfinv``'s last bits.
"""
from __future__ import annotations

import math

import torch

from deeplearning4j_tpu_torch.ndarray import random as _rnd
from deeplearning4j_tpu_torch.train.updaters import true_div as _div


def init(name: str, key, shape, fan_in: int, fan_out: int, dtype=torch.float32,
         device=None):
    """Initialize a weight tensor per the dl4j WeightInit scheme ``name``
    on ``device`` (the key's device when None)."""
    name = str(name).upper()
    dev = device if device is not None else torch.as_tensor(key).device
    shape = tuple(int(s) for s in shape)
    if name == "ZERO":
        return torch.zeros(shape, dtype=dtype, device=dev)
    if name == "ONES":
        return torch.ones(shape, dtype=dtype, device=dev)
    if name == "XAVIER":  # dl4j: gaussian, std = sqrt(2/(fanIn+fanOut))
        std = math.sqrt(2.0 / (fan_in + fan_out))
        return _rnd.normal(key, shape, dtype, dev) * std
    if name == "XAVIER_UNIFORM":
        a = math.sqrt(6.0 / (fan_in + fan_out))
        return _rnd.uniform(key, shape, dtype, -a, a, dev)
    if name == "XAVIER_FAN_IN":
        return _div(_rnd.normal(key, shape, dtype, dev), math.sqrt(fan_in))
    if name in ("RELU", "HE_NORMAL"):  # He: std = sqrt(2/fanIn)
        return _rnd.normal(key, shape, dtype, dev) * math.sqrt(2.0 / fan_in)
    if name in ("RELU_UNIFORM", "HE_UNIFORM"):
        a = math.sqrt(6.0 / fan_in)
        return _rnd.uniform(key, shape, dtype, -a, a, dev)
    if name == "LECUN_NORMAL":
        return _div(_rnd.normal(key, shape, dtype, dev), math.sqrt(fan_in))
    if name == "LECUN_UNIFORM":
        a = math.sqrt(3.0 / fan_in)
        return _rnd.uniform(key, shape, dtype, -a, a, dev)
    if name == "UNIFORM":  # dl4j legacy: U(-a, a), a = 1/sqrt(fanIn)
        a = 1.0 / math.sqrt(fan_in)
        return _rnd.uniform(key, shape, dtype, -a, a, dev)
    if name == "NORMAL":  # dl4j: N(0, 1/sqrt(fanIn))
        return _div(_rnd.normal(key, shape, dtype, dev), math.sqrt(fan_in))
    if name == "SIGMOID_UNIFORM":
        a = 4.0 * math.sqrt(6.0 / (fan_in + fan_out))
        return _rnd.uniform(key, shape, dtype, -a, a, dev)
    if name == "IDENTITY":
        assert len(shape) == 2 and shape[0] == shape[1]
        return torch.eye(shape[0], dtype=dtype, device=dev)
    raise ValueError(f"unknown WeightInit: {name}")


NAMES = ("ZERO", "ONES", "XAVIER", "XAVIER_UNIFORM", "XAVIER_FAN_IN", "RELU",
         "HE_NORMAL", "RELU_UNIFORM", "HE_UNIFORM", "LECUN_NORMAL",
         "LECUN_UNIFORM", "UNIFORM", "NORMAL", "SIGMOID_UNIFORM", "IDENTITY")
