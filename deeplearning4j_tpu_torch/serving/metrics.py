"""Serving metrics: thread-safe counters, gauges and fixed-bucket
histograms, and the generation engine's metric set (counterpart:
``deeplearning4j_tpu/serving/metrics.py``, the fields the generation
engine writes)."""
from __future__ import annotations

import threading
from typing import Dict, Sequence


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
        self.kv_blocks_total = Gauge("kv_blocks_total")      # pool capacity
        self.kv_blocks_in_use = Gauge("kv_blocks_in_use")

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
