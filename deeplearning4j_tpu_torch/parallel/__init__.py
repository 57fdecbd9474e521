"""Distributed training over ``torch.distributed``: the device mesh,
multi-process runtime and sequence parallelism — counterpart of
``deeplearning4j_tpu/parallel`` (``ParallelWrapper``, ``ParallelInference``
and gradient sharing are not ported yet)."""
from deeplearning4j_tpu_torch.parallel.mesh import (  # noqa: F401
    CONTEXT_AXIS, DATA_AXIS, MODEL_AXIS, PIPE_AXIS, make_mesh, replicate,
    shard_batch,
)
from deeplearning4j_tpu_torch.parallel.sequence_parallel import (  # noqa: F401
    reference_attention, ring_attention, ring_flash_attention,
    ring_self_attention, ulysses_attention, zigzag_indices,
    zigzag_ring_flash_attention, zigzag_ring_self_attention,
)
from deeplearning4j_tpu_torch.parallel import multihost  # noqa: F401
