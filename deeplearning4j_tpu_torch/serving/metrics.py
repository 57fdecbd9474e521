"""Serving metrics: thread-safe counters, gauges and fixed-bucket
histograms, and the generation engine's metric set (counterpart:
``deeplearning4j_tpu/serving/metrics.py``, the fields the generation
engine writes)."""
from __future__ import annotations

import threading
from typing import Dict, Sequence

#: Every machine-readable reason a request can be refused or shed with
#: (``RejectedError.reason``, the keys of ``rejections_by_reason``), each
#: listed once.
REJECTION_REASONS = (
    "queue_full", "deadline", "shutdown", "model_error", "client_error",
    "kv_blocks_exhausted", "host_draining",
    # a preemption victim whose resume became impossible
    # (admission.PreemptedError)
    "preempted",
)


class Counter:
    """Monotone non-negative counter."""

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0):
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._v


class Gauge:
    """Point-in-time value."""

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0
        self._lock = threading.Lock()

    def set(self, v: float):
        with self._lock:
            self._v = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._v


class Histogram:
    """Fixed-boundary histogram with running sum/count (boundaries are
    upper-inclusive)."""

    DEFAULT_MS = (0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000, 2500)

    def __init__(self, name: str, boundaries: Sequence[float] = DEFAULT_MS):
        self.name = name
        self.boundaries = tuple(boundaries)
        self._counts = [0] * (len(self.boundaries) + 1)
        self._sum = 0.0
        self._n = 0
        self._lock = threading.Lock()

    def observe(self, v: float):
        with self._lock:
            i = 0
            while i < len(self.boundaries) and v > self.boundaries[i]:
                i += 1
            self._counts[i] += 1
            self._sum += v
            self._n += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    @property
    def mean(self) -> float:
        with self._lock:
            return self._sum / self._n if self._n else 0.0

    def quantile(self, q: float) -> float:
        """Upper boundary of the bucket holding the q-quantile (coarse but
        monotone)."""
        with self._lock:
            if not self._n:
                return 0.0
            target = q * self._n
            seen = 0
            for i, c in enumerate(self._counts):
                seen += c
                if seen >= target:
                    return (self.boundaries[i] if i < len(self.boundaries)
                            else float("inf"))
            return float("inf")


class ReasonCounter:
    """Labeled monotone counter (reason -> count)."""

    def __init__(self, name: str):
        self.name = name
        self._d: Dict[str, float] = {}
        self._lock = threading.Lock()

    def inc(self, reason: str, n: float = 1.0):
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        with self._lock:
            self._d[reason] = self._d.get(reason, 0.0) + n

    def get(self, reason: str) -> float:
        with self._lock:
            return self._d.get(reason, 0.0)


class ServingMetrics:
    """The generation engine's metric set."""

    def __init__(self):
        self.requests_total = Counter("requests_total")
        self.rejected_total = Counter("rejected_total")
        self.failed_total = Counter("failed_total")
        self.rejections_by_reason = ReasonCounter("rejections_by_reason")
        self.queue_depth = Gauge("queue_depth")
        self.latency_ms = Histogram("latency_ms")            # submit->finish
        self.queue_wait_ms = Histogram("queue_wait_ms")
        self.prefills_total = Counter("prefills_total")
        self.decode_steps_total = Counter("decode_steps_total")
        self.generated_tokens_total = Counter("generated_tokens_total")
        self.generations_completed = Counter("generations_completed")
        self.decode_wall_ms = Counter("decode_wall_ms")   # summed step time
        self.slot_occupancy = Gauge("slot_occupancy")     # live/total slots
        self.ttft_ms = Histogram("ttft_ms")               # submit->token 0
        self.prefill_ms = Histogram("prefill_ms")
        self.decode_step_ms = Histogram("decode_step_ms")
        # ---- paged KV cache (block pool + shared-prefix reuse) -----------
        self.prefix_prefills_total = Counter("prefix_prefills_total")
        self.prefix_hits_total = Counter("prefix_hits_total")
        self.kv_cow_copies_total = Counter("kv_cow_copies_total")
        self.kv_blocks_total = Gauge("kv_blocks_total")      # pool capacity
        self.kv_blocks_in_use = Gauge("kv_blocks_in_use")
        self.kv_blocks_pinned = Gauge("kv_blocks_pinned")    # prefix pins
        self.kv_block_occupancy = Gauge("kv_block_occupancy")  # in use/total
        # blocks reserved by resident streams but holding no written token
        # yet: the worst-case generation tail allocate="reserve" holds
        # idle and allocate="on_demand" recovers
        self.kv_reservation_slack = Gauge("kv_reservation_slack")
        # ---- automatic prefix cache (paging.PrefixCache) ------------------
        self.prefix_cache_hits_total = Counter("prefix_cache_hits_total")
        self.prefix_cache_inserts_total = Counter(
            "prefix_cache_inserts_total")
        self.prefix_cache_evictions_total = Counter(
            "prefix_cache_evictions_total")
        self.prefix_cache_blocks = Gauge("prefix_cache_blocks")
        # ---- preemption, and KV swap to host (paging.BlockSwapStore) ------
        self.preemptions_total = Counter("preemptions_total")
        # blocks and bytes copied device->host at swap-out and
        # host->device at swap-in; the gauge is the store's occupancy
        self.kv_swapped_blocks = Counter("kv_swapped_blocks")
        self.kv_swap_bytes_out = Counter("kv_swap_bytes_out")
        self.kv_swap_bytes_in = Counter("kv_swap_bytes_in")
        self.kv_swapped_blocks_held = Gauge("kv_swapped_blocks_held")
        # ---- speculative decoding (draft + k-token verify) ---------------
        # proposed counts draft tokens the verify step scored, accepted the
        # prefix the target kept; the gauge is accepted / proposed over the
        # engine's life. fallbacks are turns that degraded to plain decode
        # (draft breaker open, a draft fault): a failing draft never sheds
        # a stream, so this counter is where it shows.
        self.spec_tokens_proposed = Counter("spec_tokens_proposed")
        self.spec_tokens_accepted = Counter("spec_tokens_accepted")
        self.spec_fallbacks_total = Counter("spec_fallbacks_total")
        self.spec_acceptance_rate = Gauge("spec_acceptance_rate")
        self._spec_lock = threading.Lock()
        self._spec_proposed: Dict[str, int] = {}
        self._spec_accepted: Dict[str, int] = {}

    #: distinct tenant labels the per-tenant spec counts keep; the rest
    #: fold into :data:`OVERFLOW_TENANT`
    MAX_TRACKED_TENANTS = 1024
    OVERFLOW_TENANT = "(other)"

    def record_spec_outcome(self, tenant: str, proposed: int, accepted: int):
        """One verify turn's outcome for one stream: the draft proposed
        ``proposed`` tokens and the target accepted a prefix of
        ``accepted``. Feeds the counters, the acceptance-rate gauge and the
        tenant's own counts for :meth:`spec_snapshot`."""
        if proposed <= 0:
            return
        self.spec_tokens_proposed.inc(proposed)
        self.spec_tokens_accepted.inc(accepted)
        p = self.spec_tokens_proposed.value
        self.spec_acceptance_rate.set(
            self.spec_tokens_accepted.value / p if p else 0.0)
        with self._spec_lock:
            t = tenant
            if t not in self._spec_proposed and \
                    len(self._spec_proposed) >= self.MAX_TRACKED_TENANTS:
                t = self.OVERFLOW_TENANT
            self._spec_proposed[t] = self._spec_proposed.get(t, 0) + proposed
            self._spec_accepted[t] = self._spec_accepted.get(t, 0) + accepted

    def spec_snapshot(self) -> dict:
        """The speculative roll-up: the acceptance rate, the fallbacks and
        each tenant's proposed, accepted and rate."""
        with self._spec_lock:
            tenants = {
                t: {"proposed": p,
                    "accepted": self._spec_accepted.get(t, 0),
                    "acceptance_rate": self._spec_accepted.get(t, 0) / p
                    if p else 0.0}
                for t, p in self._spec_proposed.items()}
        return {"acceptance_rate": self.spec_acceptance_rate.value,
                "fallbacks_total": self.spec_fallbacks_total.value,
                "tenants": tenants}

    def snapshot(self) -> dict:
        """Every counter and gauge by name, plus the ``"spec"`` roll-up of
        :meth:`spec_snapshot` and ``decode_tokens_per_sec``."""
        out = {name: m.value for name, m in vars(self).items()
               if isinstance(m, (Counter, Gauge))}
        out["decode_tokens_per_sec"] = self.decode_tokens_per_sec()
        out["spec"] = self.spec_snapshot()
        return out

    def record_rejection(self, reason: str):
        """Attribute one shed/rejection to its cause."""
        self.rejected_total.inc()
        self.rejections_by_reason.inc(reason)

    def decode_tokens_per_sec(self) -> float:
        """Steady-state decode throughput: tokens sampled by decode steps
        over summed decode wall time (prefill and queueing excluded)."""
        wall_s = self.decode_wall_ms.value / 1e3
        return (self.generated_tokens_total.value - self.prefills_total.value
                ) / wall_s if wall_s > 0 else 0.0
