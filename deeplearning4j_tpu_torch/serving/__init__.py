"""Serving runtime of the port (counterpart: ``deeplearning4j_tpu/serving``):
the batching inference engine and the versioned model registry; the
continuous-batching generation engine over the paged or contiguous KV
cache, with speculative decoding; admission control and multi-tenant QoS;
the resilience layer (retries, breaker, watchdog, fault injection);
request tracing, the resource ledger, paging and metrics; and the fleet
tier — the cluster directory and hedging front door, disaggregated
prefill/decode with KV page migration, the HTTP RPC data plane, the load
generator and the time-series cost models."""
from deeplearning4j_tpu_torch.serving.admission import (  # noqa: F401
    DEFAULT_TENANT, AdmissionController, ClusterCapacityError,
    DeadlineExceededError, HostDrainingError, HostUnavailableError,
    KVBlocksExhaustedError, PreemptedError, QueueFullError,
    QuotaExceededError, RejectedError, Request, RpcError, SloShedError,
)
from deeplearning4j_tpu_torch.serving.cluster import (  # noqa: F401
    ClusterDirectory, ClusterFrontDoor, ClusterStatsAggregator,
    ElasticityLoop, ElasticityPlanner, ElasticityPolicy, HeartbeatPump,
    HedgePolicy, HostHandle, HostStatus, LoopbackHost, LoopbackTransport,
    all_directories, all_elasticity_loops, drain_host, http_snapshot_source,
)
from deeplearning4j_tpu_torch.serving.disagg import (  # noqa: F401
    DisaggPolicy, FleetPrefixIndex,
)
from deeplearning4j_tpu_torch.serving.engine import (  # noqa: F401
    InferenceEngine, bucket_ladder,
)
from deeplearning4j_tpu_torch.serving.faults import (  # noqa: F401
    FaultInjectedError, FaultPlan, inject,
)
from deeplearning4j_tpu_torch.serving.generation import (  # noqa: F401
    GenerationEngine, GenerationHandle, SpecConfig, client_stream_handle,
    prefill_buckets,
)
from deeplearning4j_tpu_torch.serving.ledger import (  # noqa: F401
    LeakWatch, LedgerSnapshot, ResourceLedger, check_shutdown,
    tracked_engines, tracked_rpc_servers,
)
from deeplearning4j_tpu_torch.serving.loadgen import (  # noqa: F401
    ArrivalProcess, LoadGenerator, LoadReport, TraceRequest, TraceSpec,
    engine_submitter, front_door_submitter,
)
from deeplearning4j_tpu_torch.serving.metrics import (  # noqa: F401
    REJECTION_REASONS, Counter, Gauge, Histogram, ReasonCounter,
    ServingMetrics, SlidingWindowStats,
)
from deeplearning4j_tpu_torch.serving.paging import (  # noqa: F401
    BlockAllocator, BlockSwapStore, PrefixCache, RadixPrefixIndex,
    SharedPrefix, SwapEntry, blocks_for_tokens, kv_bytes_per_token,
)
from deeplearning4j_tpu_torch.serving.qos import (  # noqa: F401
    PRIORITIES, QosPolicy, SloBurnGovernor, SpecAcceptanceGovernor,
    TenantPolicy, TenantQueues, TokenBucket,
)
from deeplearning4j_tpu_torch.serving.registry import (  # noqa: F401
    CausalLMAdapter, Deployment, ModelAdapter, ModelRegistry, as_adapter,
)
from deeplearning4j_tpu_torch.serving.resilience import (  # noqa: F401
    CircuitBreaker, CircuitOpenError, PoisonedResultError,
    ResilientEngineMixin, RetryBudget, RetryBudgetExhaustedError,
    RetryPolicy, Watchdog, WatchdogTimeoutError,
)
from deeplearning4j_tpu_torch.serving.rpc import (  # noqa: F401
    HostRpcServer, KvMigrateRequest, KvMigrateResponse, RemoteHost,
    RemoteStream, RpcRequest, RpcResponse, RpcStreamChunk,
    rejected_from_wire,
)
from deeplearning4j_tpu_torch.serving.timeseries import (  # noqa: F401
    TimeSeriesStore, cheapest_cell, config_key, fit_cost_models,
)
from deeplearning4j_tpu_torch.serving.tracing import (  # noqa: F401
    FlightRecorder, RequestTrace, Tracer, all_tracers, default_tracer,
    flight_recorder, terminal_reason,
)
