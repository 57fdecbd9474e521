"""Datasets, iterators, normalizers and fetchers (counterpart:
``deeplearning4j_tpu/data``; ref: org.nd4j.linalg.dataset +
deeplearning4j-core datasets). Pure numpy: a network moves a batch to its
device when it takes it."""
from deeplearning4j_tpu_torch.data.dataset import (  # noqa: F401
    ArrayDataSetIterator, DataSet, DataSetIterator, ListDataSetIterator, MultiDataSet,
)
from deeplearning4j_tpu_torch.data.fetchers import (  # noqa: F401
    Cifar10DataSetIterator, EmnistDataSetIterator, IrisDataSetIterator, MnistDataSetIterator,
    TinyImageNetDataSetIterator,
)
