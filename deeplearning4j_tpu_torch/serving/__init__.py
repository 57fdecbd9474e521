"""Serving runtime of the port: the continuous-batching generation engine
over the paged or contiguous KV cache, with speculative decoding, its
admission control, paging and metrics (counterpart:
``deeplearning4j_tpu/serving``)."""
from deeplearning4j_tpu_torch.serving.admission import (  # noqa: F401
    AdmissionController, DeadlineExceededError, HostDrainingError,
    KVBlocksExhaustedError, PreemptedError, QueueFullError, RejectedError,
    Request,
)
from deeplearning4j_tpu_torch.serving.engine import bucket_ladder  # noqa: F401
from deeplearning4j_tpu_torch.serving.generation import (  # noqa: F401
    GenerationEngine, GenerationHandle, SpecConfig, prefill_buckets,
)
from deeplearning4j_tpu_torch.serving.metrics import (  # noqa: F401
    REJECTION_REASONS, ServingMetrics,
)
from deeplearning4j_tpu_torch.serving.paging import (  # noqa: F401
    BlockAllocator, BlockSwapStore, PrefixCache, RadixPrefixIndex,
    SharedPrefix, SwapEntry, blocks_for_tokens, kv_bytes_per_token,
)
from deeplearning4j_tpu_torch.serving.qos import (  # noqa: F401
    PRIORITIES, SpecAcceptanceGovernor,
)
from deeplearning4j_tpu_torch.serving.resilience import (  # noqa: F401
    CircuitBreaker,
)
