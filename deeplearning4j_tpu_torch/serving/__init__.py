"""Serving runtime of the port: the continuous-batching generation engine
over the paged KV cache, with its admission control, paging and metrics
(counterpart: ``deeplearning4j_tpu/serving``)."""
from deeplearning4j_tpu_torch.serving.admission import (  # noqa: F401
    AdmissionController, DeadlineExceededError, KVBlocksExhaustedError,
    QueueFullError, RejectedError, Request,
)
from deeplearning4j_tpu_torch.serving.engine import bucket_ladder  # noqa: F401
from deeplearning4j_tpu_torch.serving.generation import (  # noqa: F401
    GenerationEngine, GenerationHandle, prefill_buckets,
)
from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics  # noqa: F401
from deeplearning4j_tpu_torch.serving.paging import (  # noqa: F401
    BlockAllocator, blocks_for_tokens, kv_bytes_per_token,
)
