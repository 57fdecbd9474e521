"""Distributed training over ``torch.distributed``: the device mesh,
multi-process runtime and sequence parallelism — counterpart of
``deeplearning4j_tpu/parallel``, ``ParallelWrapper`` and
``ParallelInference`` (imported on first use: they import ``nn``, which
imports ``models``, which imports this package), and gradient sharing."""
from deeplearning4j_tpu_torch.parallel.mesh import (  # noqa: F401
    CONTEXT_AXIS, DATA_AXIS, MODEL_AXIS, PIPE_AXIS, make_mesh, replicate,
    shard_batch,
)
from deeplearning4j_tpu_torch.parallel.sequence_parallel import (  # noqa: F401
    reference_attention, ring_attention, ring_flash_attention,
    ring_self_attention, ulysses_attention, zigzag_indices,
    zigzag_ring_flash_attention, zigzag_ring_self_attention,
)
from deeplearning4j_tpu_torch.parallel.gradient_sharing import (  # noqa: F401
    AdaptiveThresholdAlgorithm, GradientTransformation, ThresholdState,
    gradient_compression, int8_compression, threshold_decode,
    threshold_encode,
)
from deeplearning4j_tpu_torch.parallel import multihost  # noqa: F401


def __getattr__(name):
    if name in ("ParallelWrapper", "ParallelInference"):
        from deeplearning4j_tpu_torch.parallel import data_parallel
        return getattr(data_parallel, name)
    raise AttributeError(name)
