"""The data-parallel shard of the training step now running (used by
``parallel/data_parallel.py``'s ``ParallelWrapper``).

The reference trains data-parallel as ONE program over the global batch,
sharded across devices: its BatchNormalization normalises with the global
batch's moments, its dropout masks are drawn at the global shape, and its
gradient is the global mean. Here every rank is a process holding one
block of the global batch, so inside :func:`shard` the layers ask this
module for what crosses the blocks:

- :func:`all_mean` — the mean over the ranks of a per-rank value (equal
  blocks, so the mean of per-block means is the global mean), with the
  gradient summed back over the ranks (a synchronised batch norm);
- :func:`rows` — a random draw made at the global batch's shape, of which
  this rank keeps its rows (the reference's masks for the global batch);
- :func:`sync_loss_and_grads` — the loss and the gradients averaged over
  the ranks before the update.

Outside a shard (plain ``fit``) each is the identity.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist


class _Shard:
    def __init__(self, group, world: int, rank: int):
        self.group, self.world, self.rank = group, world, rank


_CURRENT: Optional[_Shard] = None


@contextlib.contextmanager
def shard(group, world: int, rank: int):
    """Run the enclosed training step as rank ``rank`` of ``world`` over
    the process group ``group``."""
    global _CURRENT
    prev, _CURRENT = _CURRENT, _Shard(group, int(world), int(rank))
    try:
        yield
    finally:
        _CURRENT = prev


class _AllSum(torch.autograd.Function):
    """All-reduce sum forward; the gradient all-reduced too (every rank
    uses the sum in its own part of the global loss)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the ranks of the current shard (``t``
    itself outside one)."""
    s = _CURRENT
    if s is None:
        return t
    return _AllSum.apply(t, s.group) / s.world


def rows(draw, shape):
    """``draw(shape)``; inside a shard, ``draw`` at the global batch's
    shape (dim 0 times the world size) and this rank's rows of it."""
    s = _CURRENT
    shape = tuple(shape)
    if s is None or not shape:
        return draw(shape)
    b = shape[0]
    return draw((b * s.world,) + shape[1:])[s.rank * b:(s.rank + 1) * b]


def sync_loss_and_grads(loss: torch.Tensor, grads):
    """(loss, grads) averaged over the ranks of the current shard, the
    gradient leaves in one flat buffer a dtype."""
    s = _CURRENT
    if s is None:
        return loss, grads
    from deeplearning4j_tpu_torch.train.updaters import tree_leaves, tree_unflatten
    leaves = tree_leaves(grads)
    out = list(leaves)
    for dtype in {l.dtype for l in leaves}:
        idx = [i for i, l in enumerate(leaves) if l.dtype == dtype]
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=s.group)
        flat = flat / s.world
        pos = 0
        for i in idx:
            n = leaves[i].numel()
            out[i] = flat[pos:pos + n].reshape(leaves[i].shape)
            pos += n
    loss = loss.clone()
    dist.all_reduce(loss, group=s.group)
    return loss / s.world, tree_unflatten(grads, out)
