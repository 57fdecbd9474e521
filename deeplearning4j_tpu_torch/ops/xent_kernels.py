"""Fused softmax cross-entropy, written by hand in CUDA C++ for sm_90a
(``ops/csrc/xent.cu``), beside its plain PyTorch version — the
counterpart of ``softmax_cross_entropy``, ``_xent_forward`` and
``_xent_bwd_rule`` in ``deeplearning4j_tpu/ops/pallas_kernels.py``.

- :func:`softmax_cross_entropy` — per-row cross-entropy of (N, V) logits
  against (N,) integer targets, a first-order ``torch.autograd.Function``
  whose forward is :func:`softmax_cross_entropy_forward` and whose
  backward is :func:`softmax_cross_entropy_backward`; no (N, V) softmax
  reaches device memory in the forward.

As in the JAX package: loss and lse are fp32 whatever the logits' dtype;
the target logit is a masked sum, so a target outside [0, V) adds 0 and
its row's loss is the lse (and its gradient has no onehot); the gradient
comes out in the logits' dtype. ``block_n`` tiles the TPU kernel's grid;
here it only validates (N must divide by ``min(block_n, N)``), so a call
valid for one package is valid for the other.

A wrapper takes the plain version only for tensors on the CPU; a CUDA
tensor launches the kernel or raises. Launch counts:
``softmax_cross_entropy.launches`` (the forward kernel) and
``softmax_cross_entropy_backward.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from deeplearning4j_tpu_torch.ops._launch import (
    first_order_only, launch, route, stream_ptr)

_CODES = {torch.float32: 0, torch.bfloat16: 1}

_FIRST_ORDER_MSG = (
    "double backward through softmax_cross_entropy is unsupported — its "
    "backward is the first-order kernel, like the JAX package's custom VJP")


def _check(logits, targets, block_n: int) -> None:
    if logits.dim() != 2 or not logits.dtype.is_floating_point:
        raise ValueError(f"logits must be (N, V) floating point, got "
                         f"{tuple(logits.shape)} {logits.dtype}")
    n = logits.shape[0]
    if targets.shape != (n,) or targets.dtype.is_floating_point \
            or targets.dtype == torch.bool:
        raise ValueError(f"targets must be ({n},) integers, got "
                         f"{tuple(targets.shape)} {targets.dtype}")
    bn = min(block_n, n)
    if bn <= 0 or n % bn:
        raise ValueError(f"softmax_cross_entropy: N={n} is not a multiple of "
                         f"block_n={bn}")


def _check_kernel_operands(name: str, logits, *tensors) -> None:
    if logits.dtype not in _CODES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16 logits, "
                        f"got {logits.dtype}")
    if not all(t.is_contiguous() for t in (logits, *tensors)):
        raise ValueError(f"{name} needs contiguous operands")


def _kernel_targets(targets, v: int) -> torch.Tensor:
    """Contiguous int32 targets for the kernels, every target outside
    [0, V) as -1 (an int64 target beyond int32 would otherwise wrap into
    range)."""
    t = targets.long()
    return torch.where((t >= 0) & (t < v), t, -1).to(torch.int32) \
        .contiguous()


def _target_logit(x, targets):
    """x[row, t] where 0 <= t < V, else 0: the reference's masked sum
    (exactly one term, or none, is nonzero)."""
    v = x.shape[1]
    t = targets.long()
    ok = (t >= 0) & (t < v)
    picked = x.gather(1, t.clamp(0, v - 1)[:, None])[:, 0]
    return torch.where(ok, picked, torch.zeros_like(picked))


def xent_forward_reference(logits, targets) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Plain version of the forward kernel: exactly the arithmetic of
    ``_xent_fwd_kernel`` — logits in fp32, ``lse = log(sum(exp(x - m))) +
    m`` with m the row max, ``loss = lse - x[t]`` (0 for a target outside
    [0, V)). Returns ``(loss, lse)``, both (N,) fp32."""
    x = logits.float()
    m = x.amax(-1, keepdim=True)
    lse = torch.log(torch.exp(x - m).sum(-1)) + m[:, 0]
    return lse - _target_logit(x, targets), lse


def xent_backward_reference(logits, targets, lse, g) -> torch.Tensor:
    """Plain version of the backward kernel: exactly the arithmetic of
    ``_xent_bwd_kernel`` — ``(exp(x - lse) - onehot(t)) * g`` in fp32, cast
    to the logits' dtype; a target outside [0, V) has no onehot."""
    n, v = logits.shape
    grad = (logits.float() - lse[:, None]).exp_()
    t = targets.long()
    ok = (t >= 0) & (t < v)
    grad[torch.arange(n, device=grad.device)[ok], t[ok]] -= 1.0
    return grad.mul_(g.float()[:, None]).to(logits.dtype)


def softmax_cross_entropy_forward(logits, targets, block_n: int = 8
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused forward ``(loss, lse)`` — the counterpart of
    ``_xent_forward``: logits (N, V), targets (N,) integers; loss and lse
    (N,) fp32. CPU tensors take :func:`xent_forward_reference`; on the
    card the logits must be float32 or bfloat16 and contiguous."""
    _check(logits, targets, block_n)
    if route(logits, targets) == "cpu":
        return xent_forward_reference(logits, targets)
    _check_kernel_operands("xent_fwd", logits)
    n, v = logits.shape
    t = _kernel_targets(targets, v)
    loss = torch.empty(n, dtype=torch.float32, device=logits.device)
    lse = torch.empty(n, dtype=torch.float32, device=logits.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    launch("xent", "xent_fwd", [p, p, p, p, i, i, i, p],
           logits.data_ptr(), t.data_ptr(), loss.data_ptr(), lse.data_ptr(),
           n, v, _CODES[logits.dtype], stream_ptr(logits.device))
    softmax_cross_entropy.launches += 1
    return loss, lse


def softmax_cross_entropy_backward(logits, targets, lse, g) -> torch.Tensor:
    """The fused backward — the counterpart of ``_xent_bwd_rule``: the
    gradient (N, V) in the logits' dtype of ``sum(loss * g)``, from the
    forward's lse (N,) fp32 and the loss's cotangent g (N,), cast to fp32
    first. CPU tensors take :func:`xent_backward_reference`."""
    _check(logits, targets, 1)
    n, v = logits.shape
    if lse.shape != (n,) or lse.dtype != torch.float32 or g.shape != (n,):
        raise ValueError(f"lse must be ({n},) float32 and g ({n},), got "
                         f"{tuple(lse.shape)} {lse.dtype}, {tuple(g.shape)}")
    # the cotangent of a plain sum arrives expanded (stride 0)
    g = g.float().contiguous()
    if route(logits, targets, lse, g) == "cpu":
        return xent_backward_reference(logits, targets, lse, g)
    _check_kernel_operands("xent_bwd", logits, lse, g)
    t = _kernel_targets(targets, v)
    grad = torch.empty_like(logits)
    p, i = ctypes.c_void_p, ctypes.c_int
    launch("xent", "xent_bwd", [p, p, p, p, p, i, i, i, p],
           logits.data_ptr(), t.data_ptr(), lse.data_ptr(), g.data_ptr(),
           grad.data_ptr(), n, v, _CODES[logits.dtype],
           stream_ptr(logits.device))
    softmax_cross_entropy_backward.launches += 1
    return grad


softmax_cross_entropy_backward.launches = 0


class _SoftmaxCrossEntropy(torch.autograd.Function):
    """Forward: the forward kernel, saving logits, targets and lse.
    Backward: the backward kernel. First-order only."""

    @staticmethod
    def forward(ctx, logits, targets, block_n):
        loss, lse = softmax_cross_entropy_forward(logits, targets, block_n)
        ctx.save_for_backward(logits, targets, lse)
        return loss

    @staticmethod
    @first_order_only(_FIRST_ORDER_MSG)
    def backward(ctx, g):
        logits, targets, lse = ctx.saved_tensors
        return (softmax_cross_entropy_backward(logits, targets, lse, g),
                None, None)


def softmax_cross_entropy(logits, targets, block_n: int = 8) -> torch.Tensor:
    """Per-row cross-entropy (N,) fp32 of (N, V) logits against (N,)
    integer targets, fused: no (N, V) softmax reaches device memory in
    the forward, and the backward writes the gradient in one pass from the
    saved lse. First-order autograd only."""
    return _SoftmaxCrossEntropy.apply(logits, targets, block_n)


softmax_cross_entropy.launches = 0
