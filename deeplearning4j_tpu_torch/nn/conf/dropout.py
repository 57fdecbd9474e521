"""Dropout variants (counterpart: ``deeplearning4j_tpu/nn/conf/dropout.py``;
ref: org.deeplearning4j.nn.conf.dropout — IDropout SPI with Dropout,
GaussianDropout, GaussianNoise, AlphaDropout, SpatialDropout).

The reference applies these to a layer's INPUT during training via the
conf-level ``dropOut`` setting; ``Layer.dropOut`` accepts either a float
(retain probability, plain inverted dropout — dl4j semantics) or one of
these objects. All are pure functions of (key, x): the masks and noise are
the reference's ``jax.random.bernoulli``/``normal`` draws on the port's
threefry (``ndarray/random.py``), made on x's device — bit for bit the
reference's masks for the same key. Under a data-parallel step each rank
draws at the global batch's shape and keeps its rows (``nn/data_shard.py``).
"""
from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ndarray import random as _rnd
from deeplearning4j_tpu_torch.nn.data_shard import rows as _rows
from deeplearning4j_tpu_torch.train.updaters import true_div as _div


def _keep(rng, p: float, shape, x: torch.Tensor) -> torch.Tensor:
    return _rows(lambda s: _rnd.bernoulli(rng, p, s, device=x.device), shape)


def _normal(rng, x: torch.Tensor) -> torch.Tensor:
    return _rows(lambda s: _rnd.normal(rng, s, torch.float32, x.device), x.shape)


class IDropout:
    """(ref: org.deeplearning4j.nn.conf.dropout.IDropout)."""

    def apply(self, rng, x):
        raise NotImplementedError

    def to_dict(self) -> dict:
        out = {"@dropout": type(self).__name__}
        out.update({k: v for k, v in self.__dict__.items()})
        return out

    @staticmethod
    def from_dict(d: dict) -> "IDropout":
        d = dict(d)
        cls = DROPOUT_TYPES[d.pop("@dropout")]
        return cls(**d)

    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__


class Dropout(IDropout):
    """Plain inverted dropout; ``p`` is the RETAIN probability (dl4j
    semantics, matching the float form of ``dropOut``)."""

    def __init__(self, p: float = 0.5):
        self.p = float(p)

    def apply(self, rng, x):
        if self.p >= 1.0:
            return x
        mask = _keep(rng, self.p, x.shape, x)
        return torch.where(mask, _div(x, self.p), 0.0)


class GaussianDropout(IDropout):
    """Multiplicative gaussian noise N(1, sqrt(rate/(1-rate)))
    (ref: GaussianDropout; Srivastava et al. §10)."""

    def __init__(self, rate: float = 0.1):
        self.rate = float(rate)

    def apply(self, rng, x):
        if self.rate <= 0.0:
            return x
        std = (self.rate / (1.0 - self.rate)) ** 0.5
        noise = 1.0 + std * _normal(rng, x)
        return x * noise.to(x.dtype)


class GaussianNoise(IDropout):
    """Additive gaussian noise N(0, stddev) (ref: GaussianNoise)."""

    def __init__(self, stddev: float = 0.1):
        self.stddev = float(stddev)

    def apply(self, rng, x):
        n = self.stddev * _normal(rng, x)
        return x + n.to(x.dtype)


class AlphaDropout(IDropout):
    """SELU-preserving dropout (ref: AlphaDropout; Klambauer et al.): dropped
    units are set to alpha' and an affine correction keeps self-normalizing
    mean/variance. ``p`` is the RETAIN probability."""

    _ALPHA = 1.6732632423543772
    _LAMBDA = 1.0507009873554805

    def __init__(self, p: float = 0.95):
        self.p = float(p)

    def apply(self, rng, x):
        if self.p >= 1.0:
            return x
        p = self.p
        alpha_p = -self._LAMBDA * self._ALPHA
        a = (p + alpha_p ** 2 * p * (1 - p)) ** -0.5
        b = -a * (1 - p) * alpha_p
        mask = _keep(rng, p, x.shape, x)
        return (a * torch.where(mask, x, alpha_p) + b).to(x.dtype)


class SpatialDropout(IDropout):
    """Channel-wise dropout (ref: SpatialDropout; Tompson et al.): drops whole
    feature maps. Conv inputs here are NCHW/NCDHW so rank-4/5 masks axis 1.
    For rank-3 sequences the channel axis depends on ``rnnDataFormat``: the
    framework default is NWC (B, T, F) → mask the LAST axis (dropping feature
    channels, matching dl4j-on-NCW and Keras SpatialDropout1D behavior, not
    whole timesteps); set ``rnnDataFormat="NCW"`` for (B, F, T) layouts →
    mask axis 1. Last axis for 2D (B, F). ``p`` is the RETAIN probability."""

    def __init__(self, p: float = 0.5, rnnDataFormat: str = "NWC"):
        self.p = float(p)
        self.rnnDataFormat = str(rnnDataFormat).upper()
        if self.rnnDataFormat not in ("NWC", "NCW"):
            raise ValueError(f"rnnDataFormat must be NWC or NCW, "
                             f"got {rnnDataFormat}")

    def apply(self, rng, x):
        if self.p >= 1.0:
            return x
        if x.dim() == 3:
            if self.rnnDataFormat == "NWC":
                shape = (x.shape[0], 1, x.shape[2])
            else:
                shape = (x.shape[0], x.shape[1], 1)
        elif x.dim() >= 4:
            shape = (x.shape[0], x.shape[1]) + (1,) * (x.dim() - 2)
        else:
            shape = tuple(x.shape)
        mask = _keep(rng, self.p, shape, x)
        return torch.where(mask, _div(x, self.p), 0.0)


DROPOUT_TYPES = {c.__name__: c for c in
                 (Dropout, GaussianDropout, GaussianNoise, AlphaDropout,
                  SpatialDropout)}


def apply_dropout(drop, rng, x):
    """Dispatch helper: float = retain prob (legacy path), IDropout = SPI."""
    if drop is None or rng is None:
        return x
    if isinstance(drop, IDropout):
        return drop.apply(rng, x)
    keep = float(drop)
    if keep >= 1.0:
        return x
    mask = _keep(rng, keep, x.shape, x)
    return torch.where(mask, _div(x, keep), 0.0)
