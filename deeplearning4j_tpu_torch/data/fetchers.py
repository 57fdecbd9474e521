"""Dataset iterators (ref: deeplearning4j-core org.deeplearning4j.datasets —
MnistDataSetIterator, IrisDataSetIterator, Cifar10DataSetIterator, ...;
counterpart: ``deeplearning4j_tpu/data/fetchers.py``, whose draws these
equal).

The reference downloads from hosted mirrors with checksums. This package
never downloads, so each fetcher (a) looks for a local cache in the standard
location (``$DL4J_TPU_CACHE``, else ~/.deeplearning4j_tpu/<name>), and (b)
otherwise falls back to a
**deterministic synthetic surrogate** with the same shapes/dtypes/class
structure (prototype-per-class + noise — linearly separable enough that the
reference architectures train to high accuracy, which is what the e2e tests
assert). The synthetic fallback is clearly flagged via ``.synthetic``.
"""
from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import ArrayDataSetIterator

CACHE_DIR = Path(os.environ.get("DL4J_TPU_CACHE", str(Path.home() / ".deeplearning4j_tpu")))


def _idx_images(path: Path) -> np.ndarray:
    with gzip.open(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(n, rows, cols)


def _idx_labels(path: Path) -> np.ndarray:
    with gzip.open(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        return np.frombuffer(f.read(), dtype=np.uint8)


def _synthetic_images(n: int, num_classes: int, shape, seed: int, noise=0.15,
                      proto_seed: int = 777):
    """Prototype-per-class + gaussian noise, values in [0,1]. Prototypes are
    drawn from ``proto_seed`` only, so train/test splits (different ``seed``)
    sample the SAME class distributions — train/test generalization is real."""
    protos = np.random.default_rng(proto_seed).uniform(
        0.0, 1.0, size=(num_classes,) + shape).astype(np.float32)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=n)
    imgs = protos[labels] + rng.normal(0.0, noise, size=(n,) + shape).astype(np.float32)
    return np.clip(imgs, 0.0, 1.0), labels


def _one_hot(labels: np.ndarray, k: int) -> np.ndarray:
    out = np.zeros((labels.shape[0], k), dtype=np.float32)
    out[np.arange(labels.shape[0]), labels] = 1.0
    return out


class MnistDataSetIterator(ArrayDataSetIterator):
    """(ref: org.deeplearning4j.datasets.iterator.impl.MnistDataSetIterator).
    Emits flattened (B, 784) features in [0,1] + one-hot (B, 10) labels —
    reshape to NCHW happens via conf.setInputType(convolutionalFlat-style)."""

    NUM_CLASSES = 10

    def __init__(self, batch_size: int, train: bool = True, seed: int = 123,
                 num_examples: Optional[int] = None, binarize: bool = False,
                 shuffle: bool = True):
        split = "train" if train else "t10k"
        img_f = CACHE_DIR / "mnist" / f"{split}-images-idx3-ubyte.gz"
        lab_f = CACHE_DIR / "mnist" / f"{split}-labels-idx1-ubyte.gz"
        if img_f.exists() and lab_f.exists():
            imgs = _idx_images(img_f).astype(np.float32) / 255.0
            labels = _idx_labels(lab_f)
            self.synthetic = False
        else:
            n = num_examples or (4096 if train else 1024)
            imgs, labels = _synthetic_images(n, 10, (28, 28), seed=seed + (0 if train else 1))
            self.synthetic = True
        if num_examples:
            imgs, labels = imgs[:num_examples], labels[:num_examples]
        if binarize:
            imgs = (imgs > 0.5).astype(np.float32)
        feats = imgs.reshape(imgs.shape[0], 784)
        super().__init__(feats, _one_hot(labels, 10), batch_size, shuffle=shuffle, seed=seed)


class EmnistDataSetIterator(MnistDataSetIterator):
    """(ref: EmnistDataSetIterator) — synthetic surrogate shares MNIST shapes
    with 47 balanced classes."""

    NUM_CLASSES = 47

    def __init__(self, batch_size: int, train: bool = True, seed: int = 123,
                 num_examples: Optional[int] = None):
        n = num_examples or (4096 if train else 1024)
        imgs, labels = _synthetic_images(n, 47, (28, 28), seed=seed + (0 if train else 1))
        self.synthetic = True
        ArrayDataSetIterator.__init__(self, imgs.reshape(n, 784), _one_hot(labels, 47),
                                      batch_size, shuffle=True, seed=seed)


class IrisDataSetIterator(ArrayDataSetIterator):
    """(ref: org.deeplearning4j.datasets.iterator.impl.IrisDataSetIterator).
    The iris table is small enough to embed generatively: 3 gaussian clusters
    with the classic per-class means/stds (synthetic but statistically faithful)."""

    def __init__(self, batch_size: int = 150, num_examples: int = 150, seed: int = 42):
        rng = np.random.default_rng(seed)
        means = np.array([[5.0, 3.4, 1.5, 0.25], [5.9, 2.8, 4.3, 1.3], [6.6, 3.0, 5.6, 2.0]])
        stds = np.array([[0.35, 0.38, 0.17, 0.10], [0.52, 0.31, 0.47, 0.20], [0.64, 0.32, 0.55, 0.27]])
        per = num_examples // 3
        feats, labels = [], []
        for c in range(3):
            feats.append(rng.normal(means[c], stds[c], size=(per, 4)))
            labels.append(np.full(per, c))
        feats = np.concatenate(feats).astype(np.float32)
        labels = np.concatenate(labels)
        perm = rng.permutation(len(feats))
        self.synthetic = True
        super().__init__(feats[perm], _one_hot(labels[perm], 3), batch_size, shuffle=True, seed=seed)


class Cifar10DataSetIterator(ArrayDataSetIterator):
    """(ref: Cifar10DataSetIterator). NCHW (B,3,32,32) features."""

    NUM_CLASSES = 10

    def __init__(self, batch_size: int, train: bool = True, seed: int = 123,
                 num_examples: Optional[int] = None):
        n = num_examples or (2048 if train else 512)
        imgs, labels = _synthetic_images(n, 10, (3, 32, 32), seed=seed + (0 if train else 1))
        self.synthetic = True
        super().__init__(imgs, _one_hot(labels, 10), batch_size, shuffle=True, seed=seed)


class TinyImageNetDataSetIterator(ArrayDataSetIterator):
    """(ref: TinyImageNetDataSetIterator). NCHW (B,3,64,64), 200 classes."""

    def __init__(self, batch_size: int, train: bool = True, seed: int = 123,
                 num_examples: Optional[int] = None, num_classes: int = 200):
        n = num_examples or 1024
        imgs, labels = _synthetic_images(n, num_classes, (3, 64, 64), seed=seed)
        self.synthetic = True
        super().__init__(imgs, _one_hot(labels, num_classes), batch_size, shuffle=True, seed=seed)


class LFWDataSetIterator(ArrayDataSetIterator):
    """(ref: LFWDataSetIterator — Labeled Faces in the Wild). NCHW
    (B,3,64,64); synthetic surrogate (zero-egress env, see module
    docstring), ``num_classes`` identities."""

    def __init__(self, batch_size: int, train: bool = True, seed: int = 123,
                 num_examples: Optional[int] = None, num_classes: int = 40):
        n = num_examples or (1024 if train else 256)
        imgs, labels = _synthetic_images(n, num_classes, (3, 64, 64),
                                         seed=seed + (0 if train else 1))
        self.synthetic = True
        super().__init__(imgs, _one_hot(labels, num_classes), batch_size,
                         shuffle=True, seed=seed)


class SvhnDataSetIterator(ArrayDataSetIterator):
    """(ref: SvhnDataSetIterator — Street View House Numbers). NCHW
    (B,3,32,32), 10 digit classes; synthetic surrogate."""

    NUM_CLASSES = 10

    def __init__(self, batch_size: int, train: bool = True, seed: int = 123,
                 num_examples: Optional[int] = None):
        n = num_examples or (2048 if train else 512)
        imgs, labels = _synthetic_images(n, 10, (3, 32, 32),
                                         seed=seed + (0 if train else 1))
        self.synthetic = True
        super().__init__(imgs, _one_hot(labels, 10), batch_size,
                         shuffle=True, seed=seed)
