"""Loss functions (counterpart: ``deeplearning4j_tpu/train/losses.py``;
ref: org.nd4j.linalg.lossfunctions.LossFunctions.LossFunction enum +
impl.Loss* classes).

Each loss resolves to a torch ``(labels, preds, mask) -> scalar`` with the
reference's per-example form, so masking composes the same way and
autograd gives the reference's gradients. MCXENT takes probabilities
(the output layer's softmax) and clips them, as the reference does; it
is not the fused cross-entropy kernel's logits form.
"""
from __future__ import annotations

from typing import Callable

import torch

from deeplearning4j_tpu_torch.ops import registry as _reg


def _masked(per_example, mask):
    if mask is None:
        return torch.mean(per_example)
    m = mask
    while m.dim() < per_example.dim():
        m = m[..., None]
    m = torch.broadcast_to(m, per_example.shape)
    return torch.sum(per_example * m) / torch.clamp_min(torch.sum(m), 1.0)


# Explicit per-example forms so masking composes correctly.
def _mcxent(labels, preds, mask=None):
    logp = torch.log(torch.clamp(preds, 1e-10, 1.0))
    return _masked(-torch.sum(labels * logp, dim=-1), mask)


def _mse(labels, preds, mask=None):
    return _masked(torch.mean((preds - labels) ** 2, dim=-1), mask)


def _mae(labels, preds, mask=None):
    return _masked(torch.mean(torch.abs(preds - labels), dim=-1), mask)


def _binary_xent(labels, preds, mask=None):
    p = torch.clamp(preds, 1e-7, 1.0 - 1e-7)
    per = -(labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p))
    return _masked(torch.mean(per, dim=-1), mask)


def _hinge(labels, preds, mask=None):
    return _masked(torch.mean(torch.clamp_min(1.0 - labels * preds, 0.0),
                              dim=-1), mask)


def _squared_hinge(labels, preds, mask=None):
    return _masked(torch.mean(torch.clamp_min(1.0 - labels * preds, 0.0) ** 2,
                              dim=-1), mask)


def _kld(labels, preds, mask=None):
    p = torch.clamp(labels, 1e-10, 1.0)
    q = torch.clamp(preds, 1e-10, 1.0)
    return _masked(torch.sum(p * torch.log(p / q), dim=-1), mask)


def _poisson(labels, preds, mask=None):
    return _masked(torch.mean(
        preds - labels * torch.log(torch.clamp_min(preds, 1e-8)), dim=-1), mask)


def _cosine(labels, preds, mask=None):
    num = torch.sum(labels * preds, dim=-1)
    den = torch.linalg.norm(labels, dim=-1) * torch.linalg.norm(preds, dim=-1)
    return _masked(-num / torch.clamp_min(den, 1e-12), mask)


def _l1(labels, preds, mask=None):
    return _masked(torch.sum(torch.abs(preds - labels), dim=-1), mask)


def _l2(labels, preds, mask=None):
    return _masked(torch.sum((preds - labels) ** 2, dim=-1), mask)


def _mape(labels, preds, mask=None):
    return _masked(torch.mean(
        torch.abs((labels - preds) / torch.clamp_min(torch.abs(labels), 1e-8)),
        dim=-1) * 100.0, mask)


def _msle(labels, preds, mask=None):
    return _masked(torch.mean(
        (torch.log1p(torch.clamp_min(preds, 0))
         - torch.log1p(torch.clamp_min(labels, 0))) ** 2, dim=-1), mask)


def _nll(labels, preds, mask=None):  # dl4j NEGATIVELOGLIKELIHOOD == MCXENT on softmax outputs
    return _mcxent(labels, preds, mask)


def _sparse_mcxent(labels, logits, mask=None):
    """The registry's ``loss.sparseMcxent`` (integer labels, logits); the
    mask is not applied, as in the reference."""
    return _reg.get("sparseMcxent", "loss").fn(labels, logits)


_LOSSES: dict[str, Callable] = {
    "MCXENT": _mcxent,
    "NEGATIVELOGLIKELIHOOD": _nll,
    "MSE": _mse,
    "SQUARED_LOSS": _mse,
    "MEAN_ABSOLUTE_ERROR": _mae,
    "L1": _l1,
    "L2": _l2,
    "XENT": _binary_xent,
    "HINGE": _hinge,
    "SQUARED_HINGE": _squared_hinge,
    "KL_DIVERGENCE": _kld,
    "RECONSTRUCTION_CROSSENTROPY": _binary_xent,
    "POISSON": _poisson,
    "COSINE_PROXIMITY": _cosine,
    "MEAN_ABSOLUTE_PERCENTAGE_ERROR": _mape,
    "MEAN_SQUARED_LOGARITHMIC_ERROR": _msle,
    "SPARSE_MCXENT": _sparse_mcxent,
}


def get(name) -> Callable:
    """Resolve by dl4j LossFunction enum name or pass through a callable
    (labels, preds, mask=None) -> scalar."""
    if callable(name):
        return name
    key = str(name).upper()
    fn = _LOSSES.get(_ALIASES.get(key, key))
    if fn is None:
        raise ValueError(f"unknown loss: {name}. Known: {sorted(_LOSSES)}")
    return fn


_ALIASES = {"KLD": "KL_DIVERGENCE", "MAE": "MEAN_ABSOLUTE_ERROR",
            "MAPE": "MEAN_ABSOLUTE_PERCENTAGE_ERROR",
            "MSLE": "MEAN_SQUARED_LOGARITHMIC_ERROR"}


def names():
    return sorted(_LOSSES)
