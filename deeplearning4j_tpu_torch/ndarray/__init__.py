"""Tensor core: NDArray facade + factory + dtypes + RNG (nd4j-api
equivalent) over torch (counterpart: ``deeplearning4j_tpu/ndarray``)."""
from deeplearning4j_tpu_torch.ndarray.array import NDArray
from deeplearning4j_tpu_torch.ndarray.indexing import INDArrayIndex, NDArrayIndex
from deeplearning4j_tpu_torch.ndarray.factory import nd
from deeplearning4j_tpu_torch.ndarray import dtypes
from deeplearning4j_tpu_torch.ndarray.random import Random, getRandom

__all__ = ["NDArray", "nd", "dtypes", "Random", "getRandom",
           "INDArrayIndex", "NDArrayIndex"]
