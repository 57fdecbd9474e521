"""Dataset normalizers (ref: nd4j org.nd4j.linalg.dataset.api.preprocessor.* —
NormalizerStandardize, NormalizerMinMaxScaler, ImagePreProcessingScaler; fit on
an iterator, then attached as preProcessor or applied via transform;
counterpart: ``deeplearning4j_tpu/data/normalizers.py``). Pure numpy."""
from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet


class DataNormalization:
    """SPI (ref: org.nd4j.linalg.dataset.api.preprocessor.DataNormalization)."""

    def fit(self, iterator):
        raise NotImplementedError

    def transform(self, dataset: DataSet):
        raise NotImplementedError

    def preProcess(self, dataset: DataSet):
        self.transform(dataset)

    def revert(self, dataset: DataSet):
        raise NotImplementedError


def _iter_datasets(it):
    if isinstance(it, DataSet):
        yield it
        return
    if hasattr(it, "reset"):
        it.reset()
    for ds in it:
        yield ds


def _feature_rows(ds: DataSet) -> np.ndarray:
    """Flatten a DataSet's features to (n_samples, n_features) for statistics:
    2D (B,F) as-is; 3D NWC (B,T,F) -> (B*T, F) with padded (masked-out)
    timesteps dropped; 4D images (B,C,H,W) -> (B, C*H*W)."""
    x = np.asarray(ds.features, dtype=np.float64)
    if x.ndim == 2:
        return x
    if x.ndim == 3:
        rows = x.reshape(-1, x.shape[-1])
        if ds.features_mask is not None:
            rows = rows[np.asarray(ds.features_mask).reshape(-1) > 0]
        return rows
    return x.reshape(x.shape[0], -1)


class NormalizerStandardize(DataNormalization):
    """Per-feature z-score (ref: NormalizerStandardize). Sequences are NWC
    (B,T,F): statistics are per-feature over all unmasked timesteps."""

    def __init__(self):
        self.mean: Optional[np.ndarray] = None
        self.std: Optional[np.ndarray] = None

    def fit(self, iterator):
        count, s1, s2 = 0, None, None
        for ds in _iter_datasets(iterator):
            x2 = _feature_rows(ds)
            count += x2.shape[0]
            s1 = x2.sum(0) if s1 is None else s1 + x2.sum(0)
            s2 = (x2 ** 2).sum(0) if s2 is None else s2 + (x2 ** 2).sum(0)
        self.mean = s1 / count
        var = s2 / count - self.mean ** 2
        self.std = np.sqrt(np.maximum(var, 1e-12))
        return self

    def _bshape(self, x):
        if x.ndim == 2:
            return self.mean, self.std
        if x.ndim == 3:  # NWC: features on the last axis
            return self.mean.reshape(1, 1, -1), self.std.reshape(1, 1, -1)
        return (self.mean.reshape((1,) + x.shape[1:]),
                self.std.reshape((1,) + x.shape[1:]))

    def transform(self, ds: DataSet):
        m, s = self._bshape(ds.features)
        ds.features = ((ds.features - m) / s).astype(np.float32)

    def revert(self, ds: DataSet):
        m, s = self._bshape(ds.features)
        ds.features = (ds.features * s + m).astype(np.float32)

    def save(self, path: str):
        np.savez(path, mean=self.mean, std=self.std)

    @staticmethod
    def load(path: str) -> "NormalizerStandardize":
        d = np.load(path)
        n = NormalizerStandardize()
        n.mean, n.std = d["mean"], d["std"]
        return n


class NormalizerMinMaxScaler(DataNormalization):
    """Scale features into [minRange, maxRange] (ref: NormalizerMinMaxScaler)."""

    def __init__(self, minRange: float = 0.0, maxRange: float = 1.0):
        self.minRange = minRange
        self.maxRange = maxRange
        self.dataMin: Optional[np.ndarray] = None
        self.dataMax: Optional[np.ndarray] = None

    def fit(self, iterator):
        lo, hi = None, None
        for ds in _iter_datasets(iterator):
            x2 = _feature_rows(ds)
            lo = x2.min(0) if lo is None else np.minimum(lo, x2.min(0))
            hi = x2.max(0) if hi is None else np.maximum(hi, x2.max(0))
        self.dataMin, self.dataMax = lo, hi
        return self

    def _bshape(self, x):
        if x.ndim == 2:
            return self.dataMin, self.dataMax
        if x.ndim == 3:
            return self.dataMin.reshape(1, 1, -1), self.dataMax.reshape(1, 1, -1)
        return (self.dataMin.reshape((1,) + x.shape[1:]),
                self.dataMax.reshape((1,) + x.shape[1:]))

    def transform(self, ds: DataSet):
        lo, hi = self._bshape(ds.features)
        rng = np.maximum(hi - lo, 1e-12)
        z = (ds.features - lo) / rng * (self.maxRange - self.minRange) + self.minRange
        ds.features = z.astype(np.float32)

    def revert(self, ds: DataSet):
        lo, hi = self._bshape(ds.features)
        rng = np.maximum(hi - lo, 1e-12)
        z = (ds.features - self.minRange) / (self.maxRange - self.minRange) * rng + lo
        ds.features = z.astype(np.float32)


class ImagePreProcessingScaler(DataNormalization):
    """Pixel [0,255] -> [a,b] (ref: ImagePreProcessingScaler)."""

    def __init__(self, a: float = 0.0, b: float = 1.0, maxPixelVal: float = 255.0):
        self.a = a
        self.b = b
        self.maxPixelVal = maxPixelVal

    def fit(self, iterator):
        return self  # stateless

    def transform(self, ds: DataSet):
        ds.features = (ds.features / self.maxPixelVal * (self.b - self.a)
                       + self.a).astype(np.float32)

    def revert(self, ds: DataSet):
        ds.features = ((ds.features - self.a) / (self.b - self.a)
                       * self.maxPixelVal).astype(np.float32)


class VGG16ImagePreProcessor(DataNormalization):
    """Subtract ImageNet channel means, NCHW (ref: VGG16ImagePreProcessor)."""

    MEANS = np.array([123.68, 116.779, 103.939], dtype=np.float32)

    def fit(self, iterator):
        return self

    def transform(self, ds: DataSet):
        ds.features = ds.features - self.MEANS.reshape(1, 3, 1, 1)

    def revert(self, ds: DataSet):
        ds.features = ds.features + self.MEANS.reshape(1, 3, 1, 1)
