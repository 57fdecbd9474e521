"""Data-parallel training and inference (counterpart:
``deeplearning4j_tpu/parallel/data_parallel.py``; ref:
deeplearning4j-parallel-wrapper ParallelWrapper / ParallelInference).

The reference jits one step over the global batch sharded across the
devices of a ``data`` mesh axis: exact lockstep data parallelism, the
reference's averagingFrequency=1. Here every device is a process (a rank
of the port's :mod:`.mesh`, one process a rank over ``torch.distributed``):
every rank passes the same global batch, keeps its block, and runs the
network's own step inside a data shard (``nn/data_shard.py``), so that it
computes what the reference's one program computes:

- a partial last batch is padded by cycling its rows, as the reference
  pads it, so the blocks are equal;
- BatchNormalization normalises with the global batch's moments (the
  per-block moments all-reduced, their gradient summed back);
- dropout masks are drawn at the global shape, each rank keeping its rows;
- the loss and the gradient are the global means (the blocks' means
  all-reduced) before the update, so every rank applies the same update.

Multi-process: every rank sets up the default process group
(``multihost.initialize``) and builds the wrapper over the same model.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet, ListDataSetIterator, MultiDataSet
from deeplearning4j_tpu_torch.ndarray.array import NDArray
from deeplearning4j_tpu_torch.nn import data_shard
from deeplearning4j_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, batch_sharding, make_mesh


def _data_mesh(mesh: Optional[Mesh], workers: Optional[int]) -> Mesh:
    if mesh is not None:
        return mesh
    import torch.distributed as dist
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if workers is None else min(int(workers), world)
    return make_mesh({DATA_AXIS: n}, list(range(n)))


class ParallelWrapper:
    """Data-parallel trainer for a MultiLayerNetwork or a ComputationGraph
    (ref: ParallelWrapper.Builder surface: workers(n) = the data axis'
    size; averaging and gradient sharing are both the exact per-step mean)."""

    def __init__(self, model, mesh: Optional[Mesh] = None, workers: Optional[int] = None):
        self.model = model
        self.mesh = _data_mesh(mesh, workers)
        self._n = self.mesh.shape[DATA_AXIS]

    class Builder:
        """Fluent parity shim (ref: ParallelWrapper.Builder)."""

        def __init__(self, model):
            self._model = model
            self._workers = None

        def workers(self, n: int):
            self._workers = n
            return self

        def averagingFrequency(self, n: int):
            return self  # subsumed: exact sync every step

        def prefetchBuffer(self, n: int):
            return self

        def trainingMode(self, mode: str):
            return self  # AVERAGING and SHARED_GRADIENTS both -> the exact mean

        def build(self) -> "ParallelWrapper":
            return ParallelWrapper(self._model, workers=self._workers)

    # ------------------------------------------------------------------ fit
    def _block(self, arr):
        """This rank's block of the global batch ``arr`` (cyclic-padded to
        a multiple of the data axis' size); None stays None."""
        if arr is None:
            return None
        arr = np.asarray(arr)
        n, b = self._n, arr.shape[0]
        if b % n:  # pad the final partial batch by cycling rows
            arr = arr[np.resize(np.arange(b), b + n - (b % n))]
        size = arr.shape[0] // n
        r = self.mesh.axis_index(DATA_AXIS)
        return arr[r * size:(r + 1) * size]

    def _rank_batch(self, ds):
        if isinstance(ds, MultiDataSet):
            return MultiDataSet([self._block(f) for f in ds.features],
                                [self._block(y) for y in ds.labels],
                                [self._block(m) for m in ds.features_masks],
                                [self._block(m) for m in ds.labels_masks])
        return DataSet(self._block(ds.features), self._block(ds.labels),
                       self._block(ds.features_mask), self._block(ds.labels_mask))

    def fit(self, data, epochs: int = 1):
        """Lockstep data-parallel fit (ref: ParallelWrapper.fit)."""
        if isinstance(data, (DataSet, MultiDataSet)):
            data = ListDataSetIterator([data])
        m = self.model
        if not self.mesh.contains_rank():
            return m
        group = self.mesh.group(DATA_AXIS)
        for _ in range(epochs):
            for ds in data:
                block = self._rank_batch(ds)
                if group is None:  # one process: the plain step
                    m._fit_one(block)
                    continue
                with data_shard.shard(group, self._n, self.mesh.axis_index(DATA_AXIS)):
                    m._fit_one(block)
            for lst in m.listeners:
                if hasattr(lst, "onEpochEnd"):
                    lst.onEpochEnd(m)
            m._epoch += 1
        return m

    def shutdown(self):
        pass  # no worker threads to stop — parity no-op


class ParallelInference:
    """Data-parallel batch inference (ref: deeplearning4j-parallel-wrapper
    ParallelInference): a batch is padded up to the reference's ladder of
    n·2^k rows (n the data axis' size), each rank runs its block, the
    blocks are gathered and the padding cut off."""

    def __init__(self, model, mesh: Optional[Mesh] = None, workers: Optional[int] = None,
                 batchLimit: int = 0):
        self.model = model
        self.mesh = _data_mesh(mesh, workers)
        self._n = self.mesh.shape[DATA_AXIS]
        self.batchLimit = batchLimit

    class Builder:
        def __init__(self, model):
            self._model = model
            self._workers = None
            self._batch_limit = 0
            self._mode = "INPLACE"

        def workers(self, n: int):
            self._workers = n
            return self

        def batchLimit(self, n: int):
            self._batch_limit = n
            return self

        def inferenceMode(self, mode: str):
            self._mode = mode  # INPLACE/SEQUENTIAL = direct; BATCHED -> .engine()
            return self

        def build(self) -> "ParallelInference":
            return ParallelInference(self._model, workers=self._workers,
                                     batchLimit=self._batch_limit)

    def _bucket(self, b: int) -> int:
        """Smallest n * 2^k >= b — the reference's compiled-signature ladder."""
        s = self._n
        while s < b:
            s *= 2
        return s

    def output(self, x) -> NDArray:
        m = self.model
        xt = x.torch if isinstance(x, NDArray) else torch.as_tensor(np.asarray(x))
        b = xt.shape[0]
        padded = self._bucket(b)
        if padded != b:
            xt = torch.cat([xt, xt.new_zeros((padded - b,) + tuple(xt.shape[1:]))])
        sharding = batch_sharding(self.mesh, rank=xt.dim())
        out = m.output(sharding.shard(xt)).torch
        out = batch_sharding(self.mesh, rank=out.dim()).gather(out.contiguous())
        return NDArray(out[:b])

    def engine(self, **engine_kwargs):
        """The reference's BATCHED inference mode: an
        :class:`~deeplearning4j_tpu_torch.serving.InferenceEngine`
        coalescing concurrent callers over this wrapper's model and mesh.
        Each bucket batch goes through :meth:`output` on every rank of the
        mesh (its rows split over 'data', the outputs gathered), as the
        reference's engine shards its batch over the mesh."""
        from deeplearning4j_tpu_torch.serving import InferenceEngine
        from deeplearning4j_tpu_torch.serving.registry import ModelAdapter

        wrapper = self

        class _Adapter(ModelAdapter):
            kind = "ParallelInference"

            def infer(self, x) -> np.ndarray:
                return wrapper.output(x).toNumpy()

        if self.batchLimit and "max_batch_size" not in engine_kwargs:
            engine_kwargs["max_batch_size"] = self.batchLimit
        return InferenceEngine(_Adapter(self.model), mesh=self.mesh,
                               **engine_kwargs)
