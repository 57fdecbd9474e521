"""Serving runtime of the port: the continuous-batching generation engine
over the paged or contiguous KV cache, with speculative decoding, its
admission control and multi-tenant QoS, the resilience layer (retries,
breaker, watchdog, fault injection), request tracing, the resource
ledger, paging and metrics (counterpart: ``deeplearning4j_tpu/serving``)."""
from deeplearning4j_tpu_torch.serving.admission import (  # noqa: F401
    DEFAULT_TENANT, AdmissionController, DeadlineExceededError,
    HostDrainingError, KVBlocksExhaustedError, PreemptedError,
    QueueFullError, QuotaExceededError, RejectedError, Request,
    SloShedError,
)
from deeplearning4j_tpu_torch.serving.engine import bucket_ladder  # noqa: F401
from deeplearning4j_tpu_torch.serving.faults import (  # noqa: F401
    FaultInjectedError, FaultPlan, inject,
)
from deeplearning4j_tpu_torch.serving.generation import (  # noqa: F401
    GenerationEngine, GenerationHandle, SpecConfig, prefill_buckets,
)
from deeplearning4j_tpu_torch.serving.ledger import (  # noqa: F401
    LeakWatch, LedgerSnapshot, ResourceLedger, check_shutdown,
    tracked_engines,
)
from deeplearning4j_tpu_torch.serving.metrics import (  # noqa: F401
    REJECTION_REASONS, ServingMetrics, SlidingWindowStats,
)
from deeplearning4j_tpu_torch.serving.paging import (  # noqa: F401
    BlockAllocator, BlockSwapStore, PrefixCache, RadixPrefixIndex,
    SharedPrefix, SwapEntry, blocks_for_tokens, kv_bytes_per_token,
)
from deeplearning4j_tpu_torch.serving.qos import (  # noqa: F401
    PRIORITIES, QosPolicy, SloBurnGovernor, SpecAcceptanceGovernor,
    TenantPolicy, TenantQueues, TokenBucket,
)
from deeplearning4j_tpu_torch.serving.resilience import (  # noqa: F401
    CircuitBreaker, CircuitOpenError, PoisonedResultError,
    ResilientEngineMixin, RetryBudget, RetryBudgetExhaustedError,
    RetryPolicy, Watchdog, WatchdogTimeoutError,
)
from deeplearning4j_tpu_torch.serving.tracing import (  # noqa: F401
    FlightRecorder, RequestTrace, Tracer, all_tracers, default_tracer,
    flight_recorder, terminal_reason,
)
