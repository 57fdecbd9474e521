"""DataSet containers + iterator SPI (counterpart:
``deeplearning4j_tpu/data/dataset.py``; ref: org.nd4j.linalg.dataset.DataSet
/ MultiDataSet / api.iterator.DataSetIterator).

Batches carry numpy arrays (tensors and NDArrays given to a DataSet come
to the host); iterators are plain python iterables with the reference's
SPI surface (next/hasNext/reset/batch()). A network moves each batch to
its own device when it takes it (``MultiLayerNetwork.fit``/``output``).
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch


def _np(x):
    """Host numpy of an array, a tensor (on any device) or NDArray."""
    from deeplearning4j_tpu_torch.ndarray.array import NDArray
    if isinstance(x, NDArray):
        return x.toNumpy()
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(x)


class DataSet:
    """features + labels (+ masks) (ref: org.nd4j.linalg.dataset.DataSet)."""

    def __init__(self, features=None, labels=None, features_mask=None, labels_mask=None):
        self.features = _np(features) if features is not None else None
        self.labels = _np(labels) if labels is not None else None
        self.features_mask = _np(features_mask) if features_mask is not None else None
        self.labels_mask = _np(labels_mask) if labels_mask is not None else None

    def getFeatures(self):
        return self.features

    def getLabels(self):
        return self.labels

    def numExamples(self) -> int:
        return 0 if self.features is None else self.features.shape[0]

    def splitTestAndTrain(self, fraction_or_count):
        n = self.numExamples()
        n_train = int(n * fraction_or_count) if isinstance(fraction_or_count, float) else fraction_or_count
        tr = DataSet(self.features[:n_train], self.labels[:n_train],
                     None if self.features_mask is None else self.features_mask[:n_train],
                     None if self.labels_mask is None else self.labels_mask[:n_train])
        te = DataSet(self.features[n_train:], self.labels[n_train:],
                     None if self.features_mask is None else self.features_mask[n_train:],
                     None if self.labels_mask is None else self.labels_mask[n_train:])
        return tr, te

    def shuffle(self, seed: Optional[int] = None):
        rng = np.random.default_rng(seed)
        perm = rng.permutation(self.numExamples())
        self.features = self.features[perm]
        self.labels = self.labels[perm]
        if self.features_mask is not None:
            self.features_mask = self.features_mask[perm]
        if self.labels_mask is not None:
            self.labels_mask = self.labels_mask[perm]

    def batchBy(self, batch_size: int) -> List["DataSet"]:
        n = self.numExamples()
        return [DataSet(self.features[i:i + batch_size], self.labels[i:i + batch_size],
                        None if self.features_mask is None else self.features_mask[i:i + batch_size],
                        None if self.labels_mask is None else self.labels_mask[i:i + batch_size])
                for i in range(0, n, batch_size)]

    def toMultiDataSet(self) -> "MultiDataSet":
        """Single-input/-output view (ref: DataSet.toMultiDataSet)."""
        return MultiDataSet([self.features], [self.labels],
                            [self.features_mask], [self.labels_mask])

    @staticmethod
    def merge(datasets: Sequence["DataSet"]) -> "DataSet":
        return DataSet(
            np.concatenate([d.features for d in datasets]),
            np.concatenate([d.labels for d in datasets]),
        )


class MultiDataSet:
    """Multiple feature/label arrays (ref: org.nd4j.linalg.dataset.MultiDataSet)."""

    def __init__(self, features: Sequence, labels: Sequence,
                 features_masks: Optional[Sequence] = None,
                 labels_masks: Optional[Sequence] = None):
        self.features = [_np(f) for f in features]
        self.labels = [_np(l) for l in labels]
        self.features_masks = [None if m is None else _np(m) for m in (features_masks or [None] * len(self.features))]
        self.labels_masks = [None if m is None else _np(m) for m in (labels_masks or [None] * len(self.labels))]

    def numExamples(self) -> int:
        return self.features[0].shape[0]


class DataSetIterator:
    """Iterator SPI (ref: org.nd4j.linalg.dataset.api.iterator.DataSetIterator).
    Subclasses implement next()/reset()/hasNext(); python iteration supported."""

    def next(self) -> DataSet:
        raise NotImplementedError

    def hasNext(self) -> bool:
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError

    def batch(self) -> int:
        raise NotImplementedError

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        while self.hasNext():
            yield self.next()


class ListDataSetIterator(DataSetIterator):
    """Iterate a list of pre-batched DataSets (ref: same name in nd4j)."""

    def __init__(self, datasets: Sequence[DataSet], batch_size: Optional[int] = None):
        if batch_size is not None and len(datasets) == 1:
            datasets = datasets[0].batchBy(batch_size)
        self._data = list(datasets)
        self._pos = 0
        self._batch = batch_size or (self._data[0].numExamples() if self._data else 0)

    def next(self) -> DataSet:
        d = self._data[self._pos]
        self._pos += 1
        return d

    def hasNext(self) -> bool:
        return self._pos < len(self._data)

    def reset(self):
        self._pos = 0

    def batch(self) -> int:
        return self._batch


class ArrayDataSetIterator(DataSetIterator):
    """Batch over in-memory arrays with optional shuffling each epoch."""

    def __init__(self, features, labels, batch_size: int, shuffle: bool = False, seed: int = 0):
        self.features = _np(features)
        self.labels = _np(labels)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self._order = np.arange(self.features.shape[0])
        self._pos = 0

    def next(self) -> DataSet:
        idx = self._order[self._pos:self._pos + self.batch_size]
        self._pos += self.batch_size
        return DataSet(self.features[idx], self.labels[idx])

    def hasNext(self) -> bool:
        return self._pos + self.batch_size <= self.features.shape[0]

    def reset(self):
        self._pos = 0
        if self.shuffle:
            self._rng.shuffle(self._order)

    def batch(self) -> int:
        return self.batch_size
