"""Device mesh over ``torch.distributed`` — the counterpart of
``deeplearning4j_tpu/parallel/mesh.py``.

The JAX package's mesh is a grid of devices driven by one controller,
with the compiler inserting the collectives. Here every device is a
process (a rank of the default process group) and every rank runs the
same program on its own shards: the mesh is a grid of ranks with one
process group per axis, built on ``torch.distributed.device_mesh``.
Axis vocabulary, as in the JAX package:

- ``data``    — data parallelism (batch sharding; gradients summed)
- ``model``   — tensor parallelism (Megatron weight sharding)
- ``context`` — sequence parallelism (ring / Ulysses attention)
- ``pipe``    — reserved for pipeline stages

A placement (:class:`NamedSharding`, a mesh and a :class:`PartitionSpec`)
says which block of a global tensor a rank holds: dim ``i`` is split over
the axis ``spec[i]`` names, or whole where it is None. Every rank passes
the same global tensor and keeps its block (``shard``); ``gather``
rebuilds the global tensor from the blocks.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
CONTEXT_AXIS = "context"
PIPE_AXIS = "pipe"


class PartitionSpec(tuple):
    """``P('data', None)``: the mesh axis each dim is split over, or None
    (the dim is whole on every rank); dims past the spec are whole."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return "P" + tuple.__repr__(self)


P = PartitionSpec


class Mesh:
    """A grid of ranks with named axes. ``shape`` maps axis name -> size
    (in order) and ``axis_names`` lists the names, as the JAX package's
    mesh does; ``devices`` is the grid of global ranks. With a process
    group initialized, ``device_mesh`` is the
    ``torch.distributed.device_mesh.DeviceMesh`` that owns one process
    group per axis; without one (one process) it is None and every axis
    has size 1, so no collective is ever needed. ``rank`` places a
    mesh without a process group at another device of its grid: a
    virtual rank of a one-process loop over the grid (its shards and
    coordinates are that rank's; it has no groups)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 device_mesh=None, rank: Optional[int] = None):
        self.devices = devices
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              devices.shape))
        self.device_mesh = device_mesh
        if rank is not None and device_mesh is not None:
            raise ValueError("a mesh with process groups is this process's "
                             "rank's; rank= places a mesh without them")
        me = dist.get_rank() if device_mesh is not None \
            else (0 if rank is None else int(rank))
        where = np.argwhere(devices == me)
        self._coord = tuple(int(c) for c in where[0]) if len(where) else None

    def contains_rank(self) -> bool:
        """True when this process's rank is a device of the mesh (a mesh
        cut to fewer devices than the world leaves the rest out)."""
        return self._coord is not None

    def _require(self):
        if self._coord is None:
            raise ValueError(
                f"rank {dist.get_rank()} is not a device of the mesh "
                f"{self.shape} (devices {self.devices.ravel().tolist()})")

    def axis_size(self, axis: str) -> int:
        """The size of ``axis``, 1 where the mesh has no such axis."""
        return self.shape.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (0 where it is absent)."""
        if axis not in self.shape:
            return 0
        self._require()
        return self._coord[self.axis_names.index(axis)]

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``; None
        where the axis is absent or there is no process group (the mesh
        of one process), so callers skip the collective."""
        if axis not in self.shape or self.device_mesh is None:
            return None
        self._require()
        return self.device_mesh.get_group(axis)

    def __repr__(self):
        return f"Mesh({self.shape})"


def _device_type() -> str:
    """The device type of the default process group's collectives:
    ``"cuda"`` under NCCL, else ``"cpu"`` (gloo)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: Optional[dict] = None,
              devices: Optional[Sequence[int]] = None) -> Mesh:
    """Create a Mesh. ``shape`` maps axis name -> size, e.g.
    ``{'data': 4, 'model': 2}``; axes multiply to ``len(devices)``.
    ``devices`` are global ranks, default every rank of the process group
    (one rank, 0, without one). Default shape: all devices on 'data'. A
    product below the device count takes the first devices (the rest
    are outside the mesh); one above it raises ``ValueError``."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    devices = list(range(world) if devices is None else devices)
    if not shape:
        shape = {DATA_AXIS: len(devices)}
    names = tuple(shape.keys())
    sizes = tuple(int(s) for s in shape.values())
    n = int(np.prod(sizes))
    if n < len(devices):
        devices = devices[:n]
    if n != len(devices):
        raise ValueError(
            f"mesh shape {shape} needs {n} devices, have {len(devices)}")
    arr = np.asarray(devices, dtype=np.int64).reshape(sizes)
    if not dist.is_initialized():
        return Mesh(arr, names)
    from torch.distributed.device_mesh import DeviceMesh

    dm = DeviceMesh(_device_type(), torch.as_tensor(arr),
                    mesh_dim_names=names)
    return Mesh(arr, names, dm)


class NamedSharding:
    """A placement: ``spec`` over ``mesh``. Axes the mesh lacks count as
    None (use :func:`tree_shardings` to normalise a spec tree)."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def _split_dims(self):
        """(dim, axis, axis size) of every dim split over a mesh axis."""
        return [(d, a, self.mesh.shape[a]) for d, a in enumerate(self.spec)
                if a is not None and a in self.mesh.shape]

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global tensor ``x`` (a contiguous
        copy where any dim is split, else ``x`` itself)."""
        out = x
        for d, axis, n in self._split_dims():
            if x.shape[d] % n:
                raise ValueError(
                    f"dim {d} of size {x.shape[d]} does not split over "
                    f"{axis}={n} ({self.spec})")
            size = x.shape[d] // n
            out = out.narrow(d, self.mesh.axis_index(axis) * size, size)
        return out if out is x else out.contiguous()

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global tensor from every rank's block ``x`` (``all_gather``
        over each split dim's axis; no autograd)."""
        for d, axis, _ in self._split_dims()[::-1]:
            group = self.mesh.group(axis)
            if group is None:
                continue
            parts = [torch.empty_like(x) for _ in
                     range(dist.get_world_size(group))]
            dist.all_gather(parts, x.contiguous(), group=group)
            x = torch.cat(parts, dim=d)
        return x

    def __repr__(self):
        return f"NamedSharding({self.mesh.shape}, {self.spec!r})"


# ------------------------------------- collectives for per-rank training
#
# The Megatron pair: ``reduce_sum`` ends a region whose ranks each hold a
# partial sum of a value every rank then uses whole (all-reduce forward,
# the gradient passed as it is), ``copy_to`` starts a region whose ranks
# each use a whole value for their part of a sum (identity forward, the
# gradient all-reduced). ``gather_last`` concatenates blocks that every
# rank then uses whole. A None group is one rank: nothing to do.


def _live(groups):
    return [g for g in groups if g is not None]


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *groups):
        x = x.clone()
        for g in groups:
            dist.all_reduce(x, group=g)
        return x

    @staticmethod
    def backward(ctx, g):
        return (g,) + (None,) * (len(ctx.needs_input_grad) - 1)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = [torch.empty_like(x) for _ in
                 range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        size = g.shape[-1] // n
        return g.narrow(-1, dist.get_rank(ctx.group) * size,
                        size).contiguous(), None


def reduce_sum(x: torch.Tensor, groups) -> torch.Tensor:
    """``x`` summed over every rank of each group (all-reduce); the
    gradient goes back unchanged."""
    groups = _live(groups)
    return _ReduceSum.apply(x, *groups) if groups else x


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is; its gradient summed over the group's ranks."""
    return x if group is None else _CopyTo.apply(x, group)


def gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """The group's blocks of the last dim concatenated in rank order; the
    gradient of this rank's block is its slice."""
    return x if group is None else _GatherLast.apply(x, group)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def batch_sharding(mesh: Mesh, axis: str = DATA_AXIS,
                   rank: int = 2) -> NamedSharding:
    """Shard dim 0 (batch) over ``axis``, the rest whole."""
    return NamedSharding(mesh, P(axis, *([None] * (rank - 1))))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree,
                                                          PartitionSpec):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def shard_batch(mesh: Mesh, tree, axis: str = DATA_AXIS):
    """Each tensor of the tree cut to this rank's block of dim 0 over
    ``axis`` (every rank passes the same global tree)."""
    return _tree_map(lambda x: NamedSharding(
        mesh, P(axis, *([None] * (x.dim() - 1)))).shard(x), tree)


def replicate(mesh: Mesh, tree):
    """Every rank holds every tensor whole: the tree as it is."""
    return tree


def tree_shardings(mesh: Mesh, pspec_tree):
    """A tree of PartitionSpecs as the matching tree of NamedShardings.
    Axes named in a spec but absent from the mesh (a pure-DP mesh with no
    'model') degrade to None: that dim is whole."""

    def fix(spec):
        return NamedSharding(mesh, P(*(a if (a is None or a in mesh.shape)
                                       else None for a in spec)))

    return _tree_map(fix, pspec_tree)
