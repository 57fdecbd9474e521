"""Gradient compression: threshold encoding with residual carry
(counterpart: ``deeplearning4j_tpu/parallel/gradient_sharing.py``; ref:
o.d.optimize.solvers.accumulation.EncodedGradientsAccumulator, the
encoding.ThresholdAlgorithm implementations and libnd4j
generic/compression/threshold.cpp).

The reference's 1-bit-style compressed data parallelism sends the
entries with |residual| >= threshold and keeps the rest as a local
residual. The reference offers it as an optional optax hook; the port has
no optax, so each transform here is a :class:`GradientTransformation`
(``train/updaters.py``), an ``(init, update)`` pair over trees (dicts,
lists and tuples) of tensors, with ``update(grads, state, params=None)
-> (updates, state)`` and the reference's state fields:

- :func:`threshold_encode` / :func:`threshold_decode` — the op pair,
  dense (the quantized tensor; decode is the identity);
- :class:`AdaptiveThresholdAlgorithm` — the threshold moves toward a
  target share of entries sent;
- :func:`gradient_compression` — residual += grad; sent =
  encode(residual); residual -= sent, in lockstep (the reference's
  staleness is not reproduced, there as here);
- :func:`int8_compression` — symmetric int8 quantization with a scale a
  tensor.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from deeplearning4j_tpu_torch.ndarray import dtypes as _dt
from deeplearning4j_tpu_torch.train.updaters import (  # noqa: F401
    GradientTransformation, tree_leaves, tree_map)
from deeplearning4j_tpu_torch.train.updaters import true_div as _div


def threshold_encode(grad: torch.Tensor, threshold) -> torch.Tensor:
    """Quantize to {-t, 0, +t} (ref: encodeThreshold): the dense
    quantized tensor, which carries what the sparse wire format does."""
    return torch.where(torch.abs(grad) >= threshold,
                       torch.sign(grad) * threshold, 0.0)


def threshold_decode(encoded: torch.Tensor) -> torch.Tensor:
    """(ref: decodeThreshold, a scatter-add of the sparse updates): the
    identity on the dense carrier."""
    return encoded


class ThresholdState(NamedTuple):
    residual: Any
    threshold: torch.Tensor


class AdaptiveThresholdAlgorithm:
    """(ref: encoding.threshold.AdaptiveThresholdAlgorithm): the threshold
    grows by ``decay`` while more than ``target_sparsity`` of the entries
    are sent, else shrinks by it, within [min_t, max_t]."""

    def __init__(self, initial: float = 1e-3, min_t: float = 1e-5,
                 max_t: float = 1.0, target_sparsity: float = 1e-3,
                 decay: float = 1.05):
        self.initial = initial
        self.min_t = min_t
        self.max_t = max_t
        self.target = target_sparsity
        self.decay = decay

    def update(self, threshold, sent_fraction):
        t = torch.where(sent_fraction > self.target, threshold * self.decay,
                        _div(threshold, self.decay))
        return torch.clamp(t, self.min_t, self.max_t)


def gradient_compression(
        algorithm: Optional[AdaptiveThresholdAlgorithm] = None,
        initial_threshold: float = 1e-3) -> GradientTransformation:
    """EncodedGradientsAccumulator.storeUpdate's semantics: the residual
    accumulates, the threshold quantizes it, the threshold adapts.
    Apply before an updater."""
    algo = algorithm or AdaptiveThresholdAlgorithm(initial=initial_threshold)

    def init(params):
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else None
        return ThresholdState(
            residual=tree_map(torch.zeros_like, params),
            threshold=torch.tensor(algo.initial, dtype=torch.float32,
                                   device=dev))

    def update(grads, state, params=None):
        acc = tree_map(lambda r, g: r + g, state.residual, grads)
        sent = tree_map(lambda a: threshold_encode(a, state.threshold), acc)
        residual = tree_map(lambda a, s: a - s, acc, sent)
        leaves = tree_leaves(sent)
        total = sum(x.numel() for x in leaves)
        nonzero = sum(torch.count_nonzero(x) for x in leaves)
        frac = _div(torch.as_tensor(nonzero).to(_dt.float_()), max(total, 1))
        new_t = algo.update(state.threshold, frac)
        return sent, ThresholdState(residual=residual, threshold=new_t)

    return GradientTransformation(init, update)


def int8_compression() -> GradientTransformation:
    """Symmetric int8 quantization with one scale a tensor (dense, for
    collectives; the reference has no counterpart of its own)."""

    def init(params):
        return ()

    def update(grads, state, params=None):
        def q(g):
            scale = _div(torch.clamp_min(torch.amax(torch.abs(g)), 1e-12),
                         127.0)
            return torch.round(g / scale).to(torch.int8).to(g.dtype) * scale

        return tree_map(q, grads), state

    return GradientTransformation(init, update)
