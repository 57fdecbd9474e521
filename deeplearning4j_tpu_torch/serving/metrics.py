"""Serving metrics: thread-safe counters, gauges and fixed-bucket
histograms, the rolling SLO windows, and the generation engine's metric
set (counterpart: ``deeplearning4j_tpu/serving/metrics.py``; the same
counter names and ``snapshot()`` keys).

``ServingMetrics.snapshot()`` is one JSON-safe dict: every counter, the
gauges, the histograms, the per-tenant QoS roll-up (``qos``), the rolling
SLO windows (``slo``) and the speculative roll-up (``spec``). The page
migration counters (``kv_migrations_total``, ``kv_migrate_bytes_out``,
``kv_migrate_bytes_in``, ``kv_migrate_fallbacks_total``,
``prefix_route_hits_total``) are written by the engines' page export and
import and by serving/disagg.py's placement. ``publish`` (the reference's
StatsStorage hook) waits for the UI tier.
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional, Sequence

# safe at module level: qos imports only admission/tracing, never metrics;
# ledger is stdlib-only (the /proc RSS and thread readers live there so
# the ledger and these gauges read the SAME numbers)
from deeplearning4j_tpu_torch.serving.ledger import (
    process_rss_bytes as _read_rss, process_thread_counts as _read_threads,
)
from deeplearning4j_tpu_torch.serving.qos import PRIORITIES

#: Every machine-readable reason a request can be refused or shed with
#: (``RejectedError.reason``, the keys of ``rejections_by_reason``), each
#: listed once.
REJECTION_REASONS = (
    "queue_full", "deadline", "shutdown", "model_error", "client_error",
    "kv_blocks_exhausted", "host_draining",
    # a preemption victim whose resume became impossible
    # (admission.PreemptedError)
    "preempted",
    # the resilience layer (serving/resilience.py): the engine breaker is
    # open, the watchdog restarted the scheduler, the output screen caught
    # a poisoned result, the retry budget refused a retry
    "circuit_open", "watchdog", "poisoned", "retry_budget_exhausted",
    # multi-tenant QoS (serving/qos.py): a tenant's quota or backlog
    # bound, and the SLO-burn governor shedding batch-class traffic
    "quota_exceeded", "slo_shed",
    # the fleet tier (serving/cluster.py, serving/rpc.py): the whole fleet
    # out of admission headroom, no usable host, and a peer's wire payload
    # that could not be interpreted
    "cluster_capacity", "host_unavailable", "rpc_error",
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
    """Point-in-time value (queue depth, in-flight rows)."""

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0
        self._lock = threading.Lock()

    def set(self, v: float):
        with self._lock:
            self._v = float(v)

    def add(self, d: float):
        with self._lock:
            self._v += d

    @property
    def value(self) -> float:
        with self._lock:
            return self._v


class Histogram:
    """Fixed-boundary histogram with running sum/count (Prometheus-style
    cumulative-le semantics on export; boundaries are upper-inclusive)."""

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
        monotone — good enough for dashboards; exact values need traces)."""
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

    def to_dict(self) -> dict:
        with self._lock:
            return {"boundaries": list(self.boundaries),
                    "counts": list(self._counts),
                    "sum": self._sum, "count": self._n}


class ReasonCounter:
    """Labeled monotone counter (reason -> count): the shedding causes
    roll-up. A flat dict rather than N pre-declared counters because the
    reason set is open (queue_full, deadline, shutdown, circuit_open,
    watchdog, ...)."""

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

    def to_dict(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._d)


class SlidingWindowStats:
    """Rolling-window latency/error tracker — the SLO view.

    The lifetime :class:`Histogram` answers "how has this engine ever
    behaved"; an SLO answers "is it healthy NOW". This keeps the last
    ``window_s`` seconds of per-request terminal outcomes (bounded by
    ``max_samples`` — fixed memory under a request storm) and computes
    exact p50/p95/p99 over the in-window success latencies plus an error
    rate bucketed by the same reason strings
    ``rejections_by_reason`` uses (see serving/tracing.py
    ``TERMINAL_REASONS`` — one taxonomy, no drift)."""

    def __init__(self, window_s: float = 60.0, max_samples: int = 4096,
                 clock: Callable[[], float] = time.monotonic):
        if window_s <= 0:
            raise ValueError("window_s must be positive")
        if max_samples <= 0:
            raise ValueError("max_samples must be positive")
        self.window_s = float(window_s)
        self.max_samples = max_samples
        self._clock = clock
        self._buf: deque = deque()   # (t, reason, latency_ms-or-None)
        self._lock = threading.Lock()

    def record(self, reason: str = "ok",
               latency_ms: Optional[float] = None):
        now = self._clock()
        with self._lock:
            self._buf.append((now, reason, latency_ms))
            self._evict(now)

    def _evict(self, now: float):
        cut = now - self.window_s
        buf = self._buf
        while buf and (buf[0][0] < cut or len(buf) > self.max_samples):
            buf.popleft()

    def stats(self) -> dict:
        with self._lock:
            self._evict(self._clock())
            rows = list(self._buf)
        lats = sorted(l for _, r, l in rows if r == "ok" and l is not None)
        errors_by_reason: Dict[str, int] = {}
        for _, r, _ in rows:
            if r != "ok":
                errors_by_reason[r] = errors_by_reason.get(r, 0) + 1
        total = len(rows)
        n_err = sum(errors_by_reason.values())

        def pct(q: float) -> float:
            if not lats:
                return 0.0
            return lats[min(len(lats) - 1,
                            max(0, int(math.ceil(q * len(lats))) - 1))]

        return {"window_s": self.window_s, "total": total,
                "ok": total - n_err, "errors": n_err,
                "error_rate": n_err / total if total else 0.0,
                "errors_by_reason": errors_by_reason,
                "p50_ms": round(pct(0.50), 3),
                "p95_ms": round(pct(0.95), 3),
                "p99_ms": round(pct(0.99), 3)}


class ServingMetrics:
    """The engine's full metric set. All members are monotone counters or
    derived ratios except the two gauges — tests assert monotonicity over
    the counter set via :meth:`counters`. ``slo_windows_s`` configures the
    rolling SLO windows (:class:`SlidingWindowStats`) every per-request
    terminal outcome feeds via :meth:`record_outcome`."""

    def __init__(self, slo_windows_s: Sequence[float] = (10.0, 60.0)):
        self.requests_total = Counter("requests_total")
        self.rows_total = Counter("rows_total")
        self.batches_total = Counter("batches_total")
        self.padded_rows_total = Counter("padded_rows_total")
        self.rejected_total = Counter("rejected_total")
        self.rejected_queue_full = Counter("rejected_queue_full")
        self.rejected_deadline = Counter("rejected_deadline")
        self.failed_total = Counter("failed_total")
        self.bucket_hits = Counter("bucket_hits")            # warm executable
        self.bucket_compiles = Counter("bucket_compiles")    # first sight
        self.queue_depth = Gauge("queue_depth")              # rows waiting
        self.inflight_rows = Gauge("inflight_rows")
        self.latency_ms = Histogram("latency_ms")            # submit->result
        self.dispatch_ms = Histogram("dispatch_ms")          # device time
        self.queue_wait_ms = Histogram("queue_wait_ms")
        self.requests_per_batch = Histogram(
            "requests_per_batch", boundaries=(1, 2, 4, 8, 16, 32, 64))
        self.fill_ratio = Histogram(                          # rows / bucket
            "fill_ratio", boundaries=(0.125, 0.25, 0.5, 0.75, 0.875, 1.0))
        # ---- generation (continuous-batching decode) signals -------------
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
        self.kv_block_occupancy = Gauge("kv_block_occupancy")  # in-use/total
        # internal fragmentation: share of in-use block capacity holding no
        # token (the partially-filled tail blocks) — the paged design's
        # bounded waste, vs the contiguous cache's (max_len - len)/max_len
        self.kv_fragmentation = Gauge("kv_fragmentation")
        # reservation slack: blocks RESERVED by resident streams but not
        # yet holding any written token — the worst-case-generation tail
        # allocate="reserve" pays up front and allocate="on_demand"
        # recovers (at most ~1 block/stream stays slack there). Split
        # from kv_fragmentation on purpose: fragmentation is tail waste
        # WITHIN touched blocks, slack is whole untouched blocks
        self.kv_reservation_slack = Gauge("kv_reservation_slack")
        # ---- automatic prefix cache (paging.PrefixCache) ------------------
        self.prefix_cache_hits_total = Counter("prefix_cache_hits_total")
        self.prefix_cache_inserts_total = Counter(
            "prefix_cache_inserts_total")
        self.prefix_cache_evictions_total = Counter(
            "prefix_cache_evictions_total")
        self.prefix_cache_blocks = Gauge("prefix_cache_blocks")
        # ---- preemption (allocate="on_demand" recompute-on-resume) --------
        self.preemptions_total = Counter("preemptions_total")
        # ---- stream resume + KV swap-to-host ------------------------------
        # streams seated from a resume point instead of replayed from
        # token 0: engine-side, a submit carrying resume_tokens (the
        # wire-resume path) or a swap-in re-seat; front-door-side, a
        # re-dispatch the remote host honored at the delivery watermark
        self.stream_resumes_total = Counter("stream_resumes_total")
        # cumulative blocks/bytes copied device->host on preemption
        # swap-out and host->device on swap-in re-seating; the gauge is
        # the store's CURRENT occupancy (bounded by the engine's
        # swap_capacity_blocks)
        self.kv_swapped_blocks = Counter("kv_swapped_blocks")
        self.kv_swap_bytes_out = Counter("kv_swap_bytes_out")
        self.kv_swap_bytes_in = Counter("kv_swap_bytes_in")
        self.kv_swapped_blocks_held = Gauge("kv_swapped_blocks_held")
        # ---- disaggregated prefill/decode (serving/disagg.py) ------------
        # kv_migrations_total counts streams whose KV pages moved from a
        # prefill-class host to a decode-class host; bytes_out is stamped
        # on the exporting engine, bytes_in on the importing one (the two
        # only match fleet-wide when every export lands). fallbacks are
        # migrations that degraded to recompute-on-decode-host — the
        # DEGRADE contract means they NEVER surface as sheds, so this
        # counter is the only place a lost migration is visible.
        # prefix_route_hits counts front-door placements steered by the
        # fleet-wide radix prefix index (cache-aware routing).
        self.kv_migrations_total = Counter("kv_migrations_total")
        self.kv_migrate_bytes_out = Counter("kv_migrate_bytes_out")
        self.kv_migrate_bytes_in = Counter("kv_migrate_bytes_in")
        self.kv_migrate_fallbacks_total = Counter(
            "kv_migrate_fallbacks_total")
        self.prefix_route_hits_total = Counter("prefix_route_hits_total")
        # dtype-aware HBM accounting (paging.kv_bytes_per_token is the one
        # formula): int8 pools report their true 1-byte-values +
        # fp32-scale footprint, so "how much HBM does the cache hold" and
        # "how many bytes is a resident stream" read correctly whichever
        # kv_dtype the engine stores
        self.kv_block_bytes = Gauge("kv_block_bytes")        # bytes/block
        self.kv_pool_hbm_bytes = Gauge("kv_pool_hbm_bytes")  # whole pool
        self.kv_hbm_bytes_in_use = Gauge("kv_hbm_bytes_in_use")
        # ---- process self-observation (the zero-leak ledger) -------------
        # the flat-memory / no-orphan ledger checks read the SAME
        # numbers operators see: current RSS and thread count refresh at
        # snapshot() time from the ledger's /proc readers; open_ops is
        # the reference's RPC server's count (unresolved ops
        # only — TTL-retained resolved ops are contract, not leak)
        self.process_rss_bytes = Gauge("process_rss_bytes")
        self.live_threads = Gauge("live_threads")
        self.open_ops = Gauge("open_ops")
        # ---- resilience signals (retry / breaker / watchdog / fallback) --
        self.retries_total = Counter("retries_total")
        self.rejected_circuit_open = Counter("rejected_circuit_open")
        self.breaker_opened_total = Counter("breaker_opened_total")
        self.breaker_half_open_total = Counter("breaker_half_open_total")
        self.breaker_closed_total = Counter("breaker_closed_total")
        self.watchdog_restarts = Counter("watchdog_restarts")
        self.fallback_serves = Counter("fallback_serves")
        self.faults_injected_total = Counter("faults_injected_total")
        self.rejections_by_reason = ReasonCounter("rejections_by_reason")
        # ---- multi-tenant QoS signals (serving/qos.py) --------------------
        # per-tenant served/shed roll-ups (label = tenant id; "shed" here
        # is ANY non-ok terminal — rejections, failures, cancels) plus a
        # per-tenant reason breakdown, fed by record_tenant_outcome at
        # every per-request terminal. queue_wait_by_class splits the
        # queue-wait histogram by priority class, so "is interactive
        # overtaking batch" is a direct read.
        self.tenant_served = ReasonCounter("tenant_served")
        self.tenant_shed = ReasonCounter("tenant_shed")
        self._tenant_reasons: Dict[str, ReasonCounter] = {}
        self._tenant_seen: set = set()
        self._tenant_lock = threading.Lock()
        self.queue_wait_by_class: Dict[str, Histogram] = {
            p: Histogram(f"queue_wait_ms[{p}]") for p in PRIORITIES}
        self.quota_rejections_total = Counter("quota_rejections_total")
        self.slo_sheds_total = Counter("slo_sheds_total")
        self.retry_budget_exhausted_total = Counter(
            "retry_budget_exhausted_total")
        self.slo_burn_active = Gauge("slo_burn_active")   # 0/1 governor
        # ---- speculative decoding signals (draft + k-token verify) -------
        # proposed counts draft tokens the verify step scored, accepted
        # the prefix the target model kept — accepted/proposed IS the
        # fleet acceptance rate, and spec_acceptance_rate publishes it as
        # a gauge so snapshot() exposes it directly. fallbacks are
        # scheduler turns that degraded to plain decode (draft breaker
        # open, draft fault, or governor demotion) — the DEGRADE contract
        # means a dead draft NEVER sheds a stream, so this counter is the
        # only place a lost draft is visible. Per-tenant acceptance rides
        # the same bounded-cardinality label scheme as the tenant
        # served/shed counters.
        self.spec_tokens_proposed = Counter("spec_tokens_proposed")
        self.spec_tokens_accepted = Counter("spec_tokens_accepted")
        self.spec_fallbacks_total = Counter("spec_fallbacks_total")
        self.spec_acceptance_rate = Gauge("spec_acceptance_rate")
        self._spec_proposed: Dict[str, int] = {}
        self._spec_accepted: Dict[str, int] = {}
        # ---- observability signals (tracing / poison screen / SLO) -------
        self.poisoned_results_total = Counter("poisoned_results_total")
        self.slo_windows: Dict[str, SlidingWindowStats] = {
            f"{w:g}s": SlidingWindowStats(window_s=w)
            for w in slo_windows_s}
        self._per_bucket: Dict[int, Dict[str, int]] = {}
        self._lock = threading.Lock()
        self._t0 = time.time()

    # ------------------------------------------------------------ recording
    def record_bucket(self, bucket: int, rows: int, first_time: bool):
        with self._lock:
            d = self._per_bucket.setdefault(
                bucket, {"batches": 0, "rows": 0, "compiles": 0, "hits": 0})
            d["batches"] += 1
            d["rows"] += rows
            d["compiles" if first_time else "hits"] += 1
        (self.bucket_compiles if first_time else self.bucket_hits).inc()

    def record_rejection(self, reason: str):
        """Attribute one shed/rejection to its cause — rides beside the
        existing per-cause counters so ``snapshot()`` answers "WHY is this
        engine shedding" without diffing counter pairs."""
        self.rejections_by_reason.inc(reason)

    def record_outcome(self, reason: str, latency_ms: Optional[float] = None):
        """One request reached a terminal state: feed every rolling SLO
        window. ``reason`` is the shared terminal taxonomy ("ok" or the
        exact string this cause also counts under in
        ``rejections_by_reason`` — see serving/tracing.terminal_reason),
        ``latency_ms`` the submit->terminal wall time when known."""
        for w in self.slo_windows.values():
            w.record(reason, latency_ms)

    #: Distinct tenant labels tracked per ServingMetrics before new ones
    #: fold into the shared overflow bucket — tenant ids are arbitrary
    #: caller strings, so without a cap a client stamping per-request ids
    #: would grow three counters and every snapshot() payload forever
    #: (the same cardinality hazard qos.TenantQueues prunes against).
    MAX_TRACKED_TENANTS = 1024
    OVERFLOW_TENANT = "(other)"

    def _tenant_label(self, tenant: str) -> str:
        """Caller holds ``_tenant_lock``. Known tenants keep their label;
        a novel tenant past the cap folds into ``OVERFLOW_TENANT``."""
        if tenant in self._tenant_seen:
            return tenant
        if len(self._tenant_seen) >= self.MAX_TRACKED_TENANTS:
            return self.OVERFLOW_TENANT
        self._tenant_seen.add(tenant)
        return tenant

    def record_tenant_outcome(self, tenant: str, reason: str):
        """Attribute one per-request terminal to its tenant: 'ok' counts
        as served, anything else as shed (with the reason recorded in the
        tenant's own breakdown, same taxonomy as ``rejections_by_reason``
        / the SLO error buckets). Fed by the engines'
        ``_finish_request(..., tenant=)`` at every terminal. Bounded
        cardinality: at most :data:`MAX_TRACKED_TENANTS` distinct labels,
        the rest aggregated under :data:`OVERFLOW_TENANT`."""
        with self._tenant_lock:
            tenant = self._tenant_label(tenant)
            if reason != "ok":
                rc = self._tenant_reasons.get(tenant)
                if rc is None:
                    rc = self._tenant_reasons[tenant] = ReasonCounter(
                        f"tenant_rejections[{tenant}]")
        if reason == "ok":
            self.tenant_served.inc(tenant)
            return
        self.tenant_shed.inc(tenant)
        rc.inc(reason)

    def record_spec_outcome(self, tenant: str, proposed: int, accepted: int):
        """One speculative verify turn's outcome for one stream: the draft
        proposed ``proposed`` tokens and the target accepted ``accepted``
        of them (a prefix — rejection sampling). Feeds the fleet counters,
        refreshes the acceptance-rate gauge, and accumulates the tenant's
        own rate for :meth:`spec_snapshot` (bounded cardinality, same
        scheme as :meth:`record_tenant_outcome`)."""
        if proposed <= 0:
            return
        self.spec_tokens_proposed.inc(proposed)
        self.spec_tokens_accepted.inc(accepted)
        p = self.spec_tokens_proposed.value
        self.spec_acceptance_rate.set(
            self.spec_tokens_accepted.value / p if p else 0.0)
        with self._tenant_lock:
            t = self._tenant_label(tenant)
            self._spec_proposed[t] = self._spec_proposed.get(t, 0) + proposed
            self._spec_accepted[t] = self._spec_accepted.get(t, 0) + accepted

    def spec_snapshot(self) -> dict:
        """Speculative-decoding roll-up — rides ``snapshot()`` under the
        ``"spec"`` key: fleet acceptance
        rate plus the per-tenant acceptance-rate gauge."""
        with self._tenant_lock:
            tenants = {
                t: {"proposed": p,
                    "accepted": self._spec_accepted.get(t, 0),
                    "acceptance_rate": self._spec_accepted.get(t, 0) / p
                    if p else 0.0}
                for t, p in self._spec_proposed.items()}
        return {
            "acceptance_rate": self.spec_acceptance_rate.value,
            "fallbacks_total": self.spec_fallbacks_total.value,
            "tenants": tenants,
        }

    def observe_queue_wait_class(self, priority: str, wait_ms: float):
        h = self.queue_wait_by_class.get(priority)
        if h is not None:
            h.observe(wait_ms)

    def qos_snapshot(self) -> dict:
        """Per-tenant QoS roll-up (``snapshot()["qos"]``): served/shed and
        reason breakdown per tenant, queue-wait histograms by priority
        class, and the admission-governor counters (quota, SLO sheds,
        retry-budget exhaustions, whether the burn governor is currently
        shedding)."""
        served = self.tenant_served.to_dict()
        shed = self.tenant_shed.to_dict()
        with self._tenant_lock:
            reasons = {t: rc.to_dict()
                       for t, rc in self._tenant_reasons.items()}
        tenants = {t: {"served": served.get(t, 0.0),
                       "shed": shed.get(t, 0.0),
                       "rejections_by_reason": reasons.get(t, {})}
                   for t in set(served) | set(shed) | set(reasons)}
        return {
            "tenants": tenants,
            "queue_wait_by_class": {p: h.to_dict()
                                    for p, h in
                                    self.queue_wait_by_class.items()},
            "quota_rejections_total": self.quota_rejections_total.value,
            "slo_sheds_total": self.slo_sheds_total.value,
            "retry_budget_exhausted_total":
                self.retry_budget_exhausted_total.value,
            "slo_burn_active": self.slo_burn_active.value,
        }

    def slo_snapshot(self) -> Dict[str, dict]:
        """Rolling-window SLO roll-up: per window, exact p50/p95/p99 over
        in-window successes plus the reason-bucketed error rate — the
        ``snapshot()["slo"]``."""
        return {k: w.stats() for k, w in self.slo_windows.items()}

    def record_breaker_transition(self, old: str, new: str):
        """CircuitBreaker listener hook: counts entries into each state so
        the CLOSED→OPEN→HALF_OPEN→CLOSED cycle is observable as monotone
        counters."""
        if new == "OPEN":
            self.breaker_opened_total.inc()
        elif new == "HALF_OPEN":
            self.breaker_half_open_total.inc()
        elif new == "CLOSED":
            self.breaker_closed_total.inc()

    # ------------------------------------------------------------- reading
    def counters(self) -> Dict[str, float]:
        return {c.name: c.value for c in (
            self.requests_total, self.rows_total, self.batches_total,
            self.padded_rows_total, self.rejected_total,
            self.rejected_queue_full, self.rejected_deadline,
            self.failed_total, self.bucket_hits, self.bucket_compiles,
            self.prefills_total, self.decode_steps_total,
            self.generated_tokens_total, self.generations_completed,
            self.decode_wall_ms, self.retries_total,
            self.rejected_circuit_open, self.breaker_opened_total,
            self.breaker_half_open_total, self.breaker_closed_total,
            self.watchdog_restarts, self.fallback_serves,
            self.faults_injected_total, self.poisoned_results_total,
            self.prefix_prefills_total, self.prefix_hits_total,
            self.kv_cow_copies_total, self.quota_rejections_total,
            self.slo_sheds_total, self.retry_budget_exhausted_total,
            self.preemptions_total, self.prefix_cache_hits_total,
            self.prefix_cache_inserts_total,
            self.prefix_cache_evictions_total,
            self.stream_resumes_total, self.kv_swapped_blocks,
            self.kv_swap_bytes_out, self.kv_swap_bytes_in,
            self.kv_migrations_total, self.kv_migrate_bytes_out,
            self.kv_migrate_bytes_in, self.kv_migrate_fallbacks_total,
            self.prefix_route_hits_total, self.spec_tokens_proposed,
            self.spec_tokens_accepted, self.spec_fallbacks_total)}

    def decode_tokens_per_sec(self) -> float:
        """Steady-state decode throughput: tokens sampled by decode_step
        over summed decode wall time (prefill and queueing excluded — this
        is the iteration-level scheduler's sustained rate)."""
        wall_s = self.decode_wall_ms.value / 1e3
        return (self.generated_tokens_total.value - self.prefills_total.value
                ) / wall_s if wall_s > 0 else 0.0

    def bucket_cache_hit_rate(self) -> float:
        h, c = self.bucket_hits.value, self.bucket_compiles.value
        return h / (h + c) if (h + c) else 0.0

    def mean_requests_per_batch(self) -> float:
        b = self.batches_total.value
        return self.requests_total.value / b if b else 0.0

    def qps(self) -> float:
        dt = time.time() - self._t0
        return self.requests_total.value / dt if dt > 0 else 0.0

    def timeseries_sample(self) -> dict:
        """One compact per-heartbeat time-series sample (the core of
        serving/timeseries.py's SAMPLE_FIELDS): throughput, occupancy,
        pressure and self-observation gauges — a small flat dict, not
        :meth:`snapshot`, because a heartbeat ships one per beat. Reads
        existing counters and gauges only."""
        rss = _read_rss()
        if rss is not None:
            self.process_rss_bytes.set(rss)
        return {
            "t": time.time(),
            "tokens_per_sec": self.decode_tokens_per_sec(),
            "generated_tokens_total": self.generated_tokens_total.value,
            "slot_occupancy": self.slot_occupancy.value,
            "kv_block_occupancy": self.kv_block_occupancy.value,
            "preemptions_total": self.preemptions_total.value,
            "spec_acceptance_rate": self.spec_acceptance_rate.value,
            "queue_depth": self.queue_depth.value,
            "queue_by_class": {p: h.count for p, h in
                               self.queue_wait_by_class.items()},
            "rss_bytes": self.process_rss_bytes.value,
        }

    def snapshot(self) -> dict:
        with self._lock:
            per_bucket = {str(k): dict(v) for k, v in self._per_bucket.items()}
        # live process self-observation: refreshed at read time so every
        # consumer (the snapshot, the ledger) sees current
        # RSS/threads without a background sampler thread to leak
        rss = _read_rss()
        if rss is not None:
            self.process_rss_bytes.set(rss)
        self.live_threads.set(_read_threads()[0])
        return {
            "timestamp": time.time(),
            **self.counters(),
            "queue_depth": self.queue_depth.value,
            "inflight_rows": self.inflight_rows.value,
            "qps": self.qps(),
            "bucket_cache_hit_rate": self.bucket_cache_hit_rate(),
            "mean_requests_per_batch": self.mean_requests_per_batch(),
            "slot_occupancy": self.slot_occupancy.value,
            "decode_tokens_per_sec": self.decode_tokens_per_sec(),
            "kv_blocks_total": self.kv_blocks_total.value,
            "kv_blocks_in_use": self.kv_blocks_in_use.value,
            "kv_blocks_pinned": self.kv_blocks_pinned.value,
            "kv_block_occupancy": self.kv_block_occupancy.value,
            "kv_fragmentation": self.kv_fragmentation.value,
            "kv_reservation_slack": self.kv_reservation_slack.value,
            "kv_swapped_blocks_held": self.kv_swapped_blocks_held.value,
            "prefix_cache_blocks": self.prefix_cache_blocks.value,
            "kv_block_bytes": self.kv_block_bytes.value,
            "kv_pool_hbm_bytes": self.kv_pool_hbm_bytes.value,
            "kv_hbm_bytes_in_use": self.kv_hbm_bytes_in_use.value,
            "process_rss_bytes": self.process_rss_bytes.value,
            "live_threads": self.live_threads.value,
            "open_ops": self.open_ops.value,
            "rejections_by_reason": self.rejections_by_reason.to_dict(),
            "slo": self.slo_snapshot(),
            "qos": self.qos_snapshot(),
            "spec_acceptance_rate": self.spec_acceptance_rate.value,
            "spec": self.spec_snapshot(),
            "ttft_ms": self.ttft_ms.to_dict(),
            "prefill_ms": self.prefill_ms.to_dict(),
            "decode_step_ms": self.decode_step_ms.to_dict(),
            "latency_ms": self.latency_ms.to_dict(),
            "dispatch_ms": self.dispatch_ms.to_dict(),
            "queue_wait_ms": self.queue_wait_ms.to_dict(),
            "requests_per_batch": self.requests_per_batch.to_dict(),
            "fill_ratio": self.fill_ratio.to_dict(),
            "per_bucket": per_bucket,
        }
